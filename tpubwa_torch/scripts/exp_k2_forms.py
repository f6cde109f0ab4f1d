"""K2's forms side by side on the main path's launch: each form of
``csrc/smem.cu``'s ``collect12_kernel`` (rounds 1+2, a warp a read)
alone on the first chunk of ``chip_smoke.py``'s phase 5c (16,384 reads
of the 64 Mbp realistic genome, int32 ranks), in interleaved passes.

A form is the package's source with named edits, so that each step of
the design can be timed against the others in one process on one card:

* ``current``: the sources as they are;
* ``l2-by-ldg``: ``fm.cuh`` reads L2 through ``__ldg`` at every step,
  not from the registers ``fm::with_l2`` fills;
* ``forward-per-lane``: that, and the forward phase's extension made by
  every lane alone (``fm::bwt_extend``, both rows counted from
  registers), not by the warp together (``bwt_extend_warp``).

Each form is built with the package's nvcc flags into
``build/k2_forms/<form>``, its result (every read's row count, steps
and chain) is held equal to the package's wrapper before it is timed,
and each keeps the minimum over ``--passes`` passes of the marginal
time per launch in a chain of ``--reps`` (``exp_kernel_floor.
interleaved_min``), in both orders.

Run it on a card, from the root of a checkout:

    python -m tpubwa_torch.scripts.exp_k2_forms [--passes 4] [--reps 10]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess

import numpy as np
import torch

from ..device import _build, smem_fused
from .exp_kernel_floor import interleaved_min

SOURCES = ("smem.cu", "smem.cuh", "fm.cuh")
L2_BY_LDG = [
    ("fm.cuh", "cnt[c] = k < 0 ? (Idx)0 : f.l2[c + 1] - f.l2[c];",
     "cnt[c] = k < 0 ? (Idx)0 : __ldg(f.L2 + c + 1) - __ldg(f.L2 + c);"),
    ("fm.cuh", "const Idx npiv = f.l2[c] + 1 + tk[c];",
     "const Idx npiv = __ldg(f.L2 + c) + 1 + tk[c];")]
FORMS = {
    "current": [],
    "l2-by-ldg": L2_BY_LDG,
    "forward-per-lane": L2_BY_LDG + [
        ("smem.cuh", "const Intv<Idx> ok = extend_warp<Idx, false>(f, ik, "
         "3 - c);", "const Intv<Idx> ok = extend<Idx, false>(f, ik, 3 - c);")],
}


def build(form: str):
    """The ctypes handle of ``form``'s build (its edits applied to a copy
    of the sources; each edit must apply exactly once)."""
    d = _build.BUILD.parent / "k2_forms" / form
    d.mkdir(parents=True, exist_ok=True)
    for name in SOURCES:
        shutil.copy(_build.CSRC / name, d / name)
    for name, old, new in FORMS[form]:
        text = (d / name).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{form}: {old!r} is not in {name} once")
        (d / name).write_text(text.replace(old, new))
    so = d / "smem.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(d / "smem.cu")], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {form}:\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn, (restype, argtypes) in smem_fused._SIGNATURES.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    regs = [line.strip() for line in res.stderr.splitlines()
            if "registers" in line]
    return lib, regs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_k2_forms needs a CUDA card")
    import chip_smoke as c  # the root of the checkout is on sys.path
    main_path = c.phase_main_path(torch, np)
    opt, didx, qd, ld = c.phase_megaq(torch, np, main_path)["chunk"]
    stats = {}
    _, rids = smem_fused.rounds12_megaq(opt, didx, qd, ld, stats=stats)
    counts = torch.bincount(rids, minlength=len(ld)).int()
    fns, regs = {}, {}
    for form in FORMS:
        lib, regs[form] = build(form)
        fns[form] = c.k2_alone(torch, opt, didx, qd, ld, lib=lib)
        fns[form]()
        torch.cuda.synchronize()
        *_, got, steps, chain = fns[form].buffers
        if not (torch.equal(got, counts) and torch.equal(steps, stats["steps"])
                and torch.equal(chain, stats["chain"])):
            raise AssertionError(f"{form} != the wrapper's counts, steps "
                                 "and chain")
    dev = torch.device("cuda")
    ms = interleaved_min(fns, args.reps, args.passes, dev)
    back = interleaved_min(dict(reversed(list(fns.items()))), args.reps,
                           args.passes, dev)
    ch = stats["chain"].cpu().numpy()
    print("[k2 forms] " + json.dumps({
        "reads": len(ld), "ms": {k: round(v, 4) for k, v in ms.items()},
        "ms_reversed": {k: round(v, 4) for k, v in back.items()},
        "registers": regs, "chain_mean": round(float(ch.mean()), 3),
        "gpu": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
