"""K-sa's forms side by side on a stock-bwa index's SA walk: each form of
``csrc/occ.cu``'s ``sa_lookup_kernel`` (the rank-sampled walk, a lane a
rank from a rank queue) alone on the ranks of the first K-sa launch of
``chip_smoke.py``'s phase 5b (the 64 Mbp realistic genome as stock bwa
files, int32 ranks), in interleaved passes, warm and after a write that
flushes L2.

A form is the package's source with named edits, so that each step of
the design can be timed against the others in one process on one card:

* ``current``: the sources as they are;
* ``no-queue``: a thread a rank and no refill: the grid holds a thread
  for every rank, and a lane whose walk ends takes no other;
* ``inv-psi-by-word``: the LF step of the first form, ``fm.cuh``'s
  ``inv_psi`` loading x's word first and then, by the base it holds,
  the words below it one by one, its count and L2;
* ``no-queue+by-word``: both, which is the first form's shape (one rank
  a thread, two dependent trips a step).

Each form is built with the package's nvcc flags into
``build/ksa_forms/<form>``, its positions are held equal to the
package's wrapper before it is timed, and each keeps the minimum over
``--passes`` passes of the marginal time per launch in a chain of
``--reps`` (``exp_kernel_floor.interleaved_min``), in both orders; then
the least time of one launch after a 64 MB write (``chip_smoke.cold_ms``).

Run it on a card, from the root of a checkout (it builds phase 5's
index, about 2.5 min):

    python -m tpubwa_torch.scripts.exp_ksa_forms [--passes 4] [--reps 20]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import _build, occ
from .exp_kernel_floor import interleaved_min

SOURCES = ("occ.cu", "fm.cuh")
NO_QUEUE = [
    ("occ.cu", "    s->blocks = std::min<int64_t>(blocks, blocks_for(n));",
     "    s->blocks = blocks_for(n);"),
    ("occ.cu", "            idle = __ballot_sync(kFull, i < 0);\n        }",
     "            idle = __ballot_sync(kFull, i < 0);\n"
     "            drained = true;\n        }")]
BY_WORD = [
    ("fm.cuh", "    const Idx x = lf_x(f, k);\n"
     "    return lf_row(f, load_row(f, x), k, x);",
     "    if (k == f.primary) return 0;\n"
     "    const Idx x = lf_x(f, k);\n"
     "    const uint32_t* row = occ_row(f, x);\n"
     "    const int within = (int)(x & 127), wi = within >> 4;\n"
     "    const uint32_t w = __ldg(row + 4 + wi);\n"
     "    const int c = (int)(w >> ((15 - (within & 15)) << 1)) & 3;\n"
     "    uint32_t n = __popc(match(w, c) & low_cover((within & 15) + 1));\n"
     "    for (int i = 0; i < wi; ++i) n += __popc(match(__ldg(row + 4 + i),"
     " c));\n"
     "    return __ldg(f.L2 + c) + (Idx)__ldg(row + c) + (Idx)n;")]
FORMS = {
    "current": [],
    "no-queue": NO_QUEUE,
    "inv-psi-by-word": BY_WORD,
    "no-queue+by-word": NO_QUEUE + BY_WORD,
}


def build(form: str):
    """(the ctypes handle of ``form``'s build, its ptxas register
    lines): its edits applied to a copy of the sources; each edit must
    apply exactly once."""
    return _build.build_edited("occ", FORMS[form], _build.BUILD.parent
                               / "ksa_forms" / form, occ._SIGNATURES)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_ksa_forms needs a CUDA card")
    import chip_smoke as c  # the root of the checkout is on sys.path
    main_path = c.phase_main_path(torch, np)
    *_, (didx, ranks) = c.phase_stock_bwa(torch, np, main_path)
    want = occ.sa_lookup(didx, ranks)
    fns, regs = {}, {}
    for form in FORMS:
        lib, regs[form] = build(form)
        fns[form] = c.ksa_alone(torch, didx, ranks, lib=lib)
        fns[form]()
        torch.cuda.synchronize()
        if not torch.equal(fns[form].buffers[1], want):
            raise AssertionError(f"{form} != the wrapper's positions")
    dev = torch.device("cuda")
    ms = interleaved_min(fns, args.reps, args.passes, dev)
    back = interleaved_min(dict(reversed(list(fns.items()))), args.reps,
                           args.passes, dev)
    cold = {form: c.cold_ms(torch, fn) for form, fn in fns.items()}
    for form, fn in fns.items():  # what the timed launches left
        if not torch.equal(fn.buffers[1], want):
            raise AssertionError(f"{form}'s timed launches != the wrapper")
    print("[ksa forms] " + json.dumps({
        "ranks": len(ranks), "ms": {k: round(v, 4) for k, v in ms.items()},
        "ms_reversed": {k: round(v, 4) for k, v in back.items()},
        "cold_ms": {k: round(v, 4) for k, v in cold.items()},
        "registers": regs, "gpu": torch.cuda.get_device_name(0)}),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
