"""The floor experiment (tpubwa's scripts/exp_kernel_floor.py) on
PyTorch and CUDA: K1 less one piece at a time, timed on the script's
perfect-match jobs.

The JAX script times seven builds of K1's Pallas kernel
(``extend_batch_pallas(..., trees, ablate)``): the five ``trees``
row-reduction layouts, which compute K1 exactly (``full/*``), and K1
with the F gap scan (``-scan``) or the h_open reduction (``-hopen``)
ablated, which are wrong on purpose.  Here each row launches the
matching instantiation of ``csrc/extend.cu``'s kernel template: the
reduction layouts are TPU devices with no counterpart on the card, so
the five ``full/*`` rows all launch K1's own instantiation, one binary,
and their spread is the timing noise of one kernel on this card.

Timing follows the JAX script (:77-94): every variant is built first,
then ``--passes`` interleaved passes time each in turn, and each
variant keeps its minimum.  A pass times one variant as the marginal
time per launch in a chain, (t(reps launches) - t(1 launch)) /
(reps - 1), through ``exp_kernel_real.time_launch`` (CUDA events on a
card).  Beside each time the row prints the band cells that the plain
version counts on the same jobs: an ablation that kills jobs early
(``-pk``, ``-trim``, ``-trees``) runs fewer of them.  Each kernel's
result is held equal to its plain version's before it is timed.

The JAX script chains its reps through ``params`` lane 6
(``pj.at[:, 6].set(out[:, 127])``, :60): that only orders the launches
on the TPU, and lane 127 of the output is always 0.  The kernel reads
params lanes 0-4 only, so nothing is chained here.

Run it on a card:

    python -m tpubwa_torch.scripts.exp_kernel_floor --device cuda \\
        [--jobs 512,131072] [--passes 4] [--reps 16]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device.extend_kernel import (_extend_cuda, _extend_floor_cuda,
                                    ablate_mask, extend_batch,
                                    extend_batch_plain)
from .exp_int16_kernel import QL, TL, SCORING, ZDROP, script_jobs
from .exp_kernel_real import time_launch

# (label, trees, ablate): the JAX script's rows (:118-126)
SPECS = (
    ("full/split", "split", ()),
    ("full/stacked", "stacked", ()),
    ("full/mxu-hopen", "mxu", ()),
    ("full/scanred", "scanred", ()),
    ("full/mxuscan", "mxuscan", ()),
    ("-scan", "split", ("scan",)),
    ("-hopen", "split", ("hopen",)),
)
FULL = tuple(label for label, _, ablate in SPECS if not ablate)
# the JAX script's caveat (:110-117)
CAVEAT = ("-pk/-trim/-trees replace reduction results with lane-0 junk, "
          "which corrupts zdrop/band state and truncates the row loop: "
          "their absolute times are NOT valid marginals.  Only -scan and "
          "-hopen keep the loop length on the perfect-match corpus.  The "
          "exact variants (full/*) are the trustworthy comparisons.")


def floor_jobs(n):
    """The script's jobs (make_variant, :41-50) at n jobs: windows of one
    random template from seed 0, each query the first QL bases of its
    target (a perfect match), params (QL, TL, h0 60, w 100, end_bonus
    5)."""
    return script_jobs(np.random.default_rng(0), n)


def make_variant(q, t, p, trees, ablate, device):
    """The launch of one variant, alone: on a card the kernel's C entry
    without the wrapper's input checks (K1's entry for no ablation, the
    floor entry otherwise); on the CPU its plain version."""
    mask = ablate_mask(ablate, trees)
    if device.type != "cuda":
        return lambda: extend_batch_plain(q, t, p, *SCORING, ZDROP,
                                          ablate=ablate, trees=trees)
    if mask:
        return lambda: _extend_floor_cuda(q, t, p, *SCORING, ZDROP, mask)
    return lambda: _extend_cuda(q, t, p, *SCORING, ZDROP)


def time_variants(specs, jobs, reps, passes, device, log):
    """Check every variant against its plain version (which counts its
    band cells), then time them in ``passes`` interleaved passes;
    returns {label: (min ms per launch, band cells)}."""
    q, t, p = jobs
    plain, cells, timers = {}, {}, []
    for label, trees, ablate in specs:
        got = extend_batch(q, t, p, *SCORING, ZDROP, ablate=ablate,
                           trees=trees)          # checks the inputs once
        if ablate not in plain:
            stats = {}
            plain[ablate] = extend_batch_plain(q, t, p, *SCORING, ZDROP,
                                               stats=stats, ablate=ablate)
            cells[ablate] = stats.get("cells", 0)
        if not torch.equal(got, plain[ablate]):
            bad = int((got != plain[ablate]).any(1).sum())
            raise AssertionError(f"{label}: kernel != plain on {bad} jobs")
        timers.append((label, ablate, make_variant(q, t, p, trees, ablate,
                                                   device)))
    best = {}
    for _ in range(passes):
        for label, _, fn in timers:
            ms = time_launch(fn, 1, reps, 1, device)
            best[label] = min(ms, best.get(label, ms))
    n = len(q)
    for label, ablate, _ in timers:
        ms = best[label]
        log(f"[floor] N={n} {label:16s}: {ms:8.4f} ms/launch "
            f"({n * QL * TL / (ms * 1e-3) / 1e9:7.2f} GCUPS-equiv)  "
            f"band cells {cells[ablate]}")
    return {label: (best[label], cells[ablate])
            for label, ablate, _ in timers}


def main(argv=None) -> dict:
    """Time the JAX script's seven rows at each ``--jobs`` size and print
    the scan and hopen marginals and each layout's ratio to
    ``full/split``.  Raises if a kernel differs from its plain version;
    returns the numbers it printed."""
    ap = argparse.ArgumentParser(
        prog="python -m tpubwa_torch.scripts.exp_kernel_floor",
        description="K1 less one piece: the floor experiment")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the CUDA kernels, timed with CUDA events; "
                         "cpu: their plain PyTorch versions")
    ap.add_argument("--jobs", default="512",
                    help="comma-separated job counts (512: the script's "
                         "one TPU chunk)")
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--reps", type=int, default=16)
    args = ap.parse_args(argv)
    if args.reps < 2:
        ap.error("--reps must be at least 2")
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: torch sees no CUDA device")
        what = (f"{torch.cuda.get_device_name(dev)}: the CUDA kernels, "
                "CUDA events")
    else:
        what = "cpu: the plain PyTorch versions, host clock"

    def log(m):
        print(m, flush=True)

    log(f"[floor] device {what}; GCUPS-equiv = N*QL*TL / t counts the full "
        f"{QL}x{TL} rectangle of each job, not band cells")
    log(f"[floor] {', '.join(FULL)} launch ONE binary (K1's instantiation): "
        "their spread is the timing noise of one kernel")
    log(f"[floor] caveat: {CAVEAT}")
    timing = []
    for n in (int(s) for s in args.jobs.split(",")):
        jobs = tuple(torch.from_numpy(x).to(dev) for x in floor_jobs(n))
        best = time_variants(SPECS, jobs, args.reps, args.passes, dev, log)
        ms = {label: v[0] for label, v in best.items()}
        t_full = ms["full/split"]
        spread = max(ms[x] for x in FULL) / min(ms[x] for x in FULL)
        log(f"[floor] N={n} scan marginal "
            f"{t_full - ms['-scan']:+.4f} ms; hopen-tree marginal "
            f"{t_full - ms['-hopen']:+.4f} ms")
        for label in FULL[1:]:
            log(f"[floor] N={n} {label}: {t_full:.4f} -> {ms[label]:.4f} "
                f"ms ({t_full / ms[label]:.2f}x)")
        log(f"[floor] N={n} full/* spread (one binary): {spread:.3f}x")
        timing.append({"N": n, "ms": ms,
                       "cells": {label: v[1] for label, v in best.items()},
                       "full_spread": spread})
    return {"device": what, "timing": timing}


if __name__ == "__main__":
    main()
