"""K3's forms side by side on the main path's launch: each form of
``csrc/smem.cu``'s ``seed_strategy_kernel`` (round 3, a group of lanes a
read from a read queue) alone on the first chunk of ``chip_smoke.py``'s
phase 5c (16,384 reads of the 64 Mbp realistic genome, int32 ranks), in
interleaved passes.

A form is the package's source with named edits, so that each size of
the group can be timed against the others in one process on one card:

* ``thread``: one read a thread (a group of 1): every lane loads both
  occ rows of its step and counts them alone (``fm::bwt_extend``);
* ``g4``: a group of 4 lanes a read, 8 reads a warp, each lane four BWT
  words of one row (one 16-byte load; ``fm.cuh:bwt_extend_group``);
* ``g8``: a group of 8, 4 reads a warp, two words a lane (8 bytes);
* ``g16``: a group of 16, 2 reads a warp, one word a lane;
* ``g32``: the whole warp on a read (``smem.cuh:bwt_extend_warp``, K2's
  forward step, as it is).

``SHIPPED`` is the form the package builds (no edits).  Each form is
built with the package's nvcc flags into ``build/k3_forms/<form>``, its
result (every read's hits, count, steps, chain and longest scan) is
held equal to the package's wrapper before it is timed, and each keeps
the minimum over ``--passes`` passes of the marginal time per launch in
a chain of ``--reps`` (``exp_kernel_floor.interleaved_min``), in both
orders; then again what the timed launches left is held equal.

Run it on a card, from the root of a checkout (it builds phase 5's
index, about 2.5 min):

    python -m tpubwa_torch.scripts.exp_k3_forms [--passes 4] [--reps 20]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import _build, smem, smem_fused
from .exp_kernel_floor import interleaved_min

SOURCES = ("smem.cu", "smem.cuh", "fm.cuh")
SHIPPED = "g8"
_GROUP = "constexpr int kGroup = 8;"


def _group(g: int):
    return [("smem.cu", _GROUP, f"constexpr int kGroup = {g};")]


FORMS = {
    "thread": _group(1),
    "g4": _group(4),
    "g8": [],
    "g16": _group(16),
    "g32": _group(32),
}


def build(form: str):
    """(the ctypes handle of ``form``'s build, its ptxas register
    lines): its edits applied to a copy of the sources; each edit must
    apply exactly once."""
    return _build.build_edited("smem", FORMS[form], _build.BUILD.parent
                               / "k3_forms" / form, smem_fused._SIGNATURES)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_k3_forms needs a CUDA card")
    import chip_smoke as c  # the root of the checkout is on sys.path
    main_path = c.phase_main_path(torch, np)
    opt, didx, qd, ld = c.phase_megaq(torch, np, main_path)["chunk"]
    stats = {}
    want = smem._seed_strategy_scan(didx, qd, ld, opt.min_seed_len,
                                    opt.max_mem_intv, stats=stats)
    want = (*want, stats["steps"], stats["chain"], stats["longest"])

    def check(form, fn, when):
        if not all(torch.equal(a, b) for a, b in zip(fn.buffers[1:], want)):
            raise AssertionError(f"{form} != the wrapper's hits, counts, "
                                 f"steps, chain and longest scan ({when})")

    fns, regs, shapes = {}, {}, {}
    for form in FORMS:
        lib, regs[form] = build(form)
        fns[form] = c.k3_alone(torch, opt, didx, qd, ld, lib=lib)
        fns[form]()
        torch.cuda.synchronize()
        check(form, fns[form], "first launch")
        _, shapes[form] = smem.k3_shape(lib, False, len(ld), ld.device.index)
    dev = torch.device("cuda")
    ms = interleaved_min(fns, args.reps, args.passes, dev)
    back = interleaved_min(dict(reversed(list(fns.items()))), args.reps,
                           args.passes, dev)
    for form, fn in fns.items():
        check(form, fn, "timed launches")
    ch = stats["chain"].cpu().numpy()
    print("[k3 forms] " + json.dumps({
        "reads": len(ld), "shipped": SHIPPED,
        "ms": {k: round(v, 4) for k, v in ms.items()},
        "ms_reversed": {k: round(v, 4) for k, v in back.items()},
        "registers": regs, "launch": shapes,
        "chain_mean": round(float(ch.mean()), 3), "chain_max": int(ch.max()),
        "longest_scan": int(stats["longest"].max()),
        "gpu": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
