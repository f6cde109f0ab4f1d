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


# the (W, tmax) tile shapes of width_for's three buckets
STRIP_SHAPES = ((128, 256), (256, 512), (512, 512))


def strip_edge_jobs(W, tmax):
    """{set: (q [n, W], t [n, tmax], params [n, 5])}: jobs for the edges
    of a kernel that walks the live band in strips of 32 columns, at one
    tile shape; ``make_jobs`` draws indels of at most 3 and rarely
    builds these.  Scoring is ``SCORING``.  ``band_trace`` shows what
    each set is for:

    * ``ins_run``: 33-70 bases inserted into the query under w 100 and
      200, so the F gap is the winning term in cells 33 and more columns
      from where it opened, across strip edges;
    * ``del_run``: 33-70 bases deleted from it, a tail that makes the
      crossing pay: tle - qle is the run;
    * ``tie32``, ``tie64``: the row max is reached in two columns 32 or
      64 apart (a query of period 32 or 64 whose first copy carries N
      codes worth the gap open 6 + d); the later column must win, so
      qle - tle is d (where tlen > d + 7: the tie then sets the score);
    * ``residues``: perfect matches under narrow and wide bands, whose
      beg, end and end - beg take every residue mod 32;
    * ``closed``: short queries under small w on long targets, whose
      band closes (beg >= end) while the job lives;
    * ``qlen_edges``: qlen 1 and W - 1, the latter under bands of up to
      2 w + 1 = 401 columns."""
    rng = np.random.default_rng(W)
    qmax = W - 1

    def pack(jobs):
        q = np.full((len(jobs), W), 4, np.int32)
        t = np.full((len(jobs), tmax), 4, np.int32)
        p = np.zeros((len(jobs), 5), np.int32)
        for k, (qs, ts, h0, w) in enumerate(jobs):
            qs, ts = qs[:qmax], ts[:tmax]
            q[k, :len(qs)] = qs
            t[k, :len(ts)] = ts
            p[k] = (len(qs), len(ts), h0, w, 5)
        return q, t, p

    def seq(n):
        return rng.integers(0, 4, n).astype(np.int32)

    sets = {}
    runs = [(run, w) for run in (33, 47, 64, 70) for w in (100, 200)]
    jobs = []
    for run, w in runs:
        pre, suf = seq(24), seq(qmax - 24 - run)
        jobs.append((np.concatenate([pre, seq(run), suf]),
                     np.concatenate([pre, suf, seq(8)]), 120, w))
    sets["ins_run"] = pack(jobs)
    jobs = []
    for run, w in runs:
        pre, suf = seq(20), seq(min(qmax - 20, tmax - 20 - run))
        jobs.append((np.concatenate([pre, suf]),
                     np.concatenate([pre, seq(run), suf]), 80, w))
    sets["del_run"] = pack(jobs)
    for d in (32, 64):
        # an N in place of a match costs 2 (-1 against +a): 6 + d in all
        # the tie outscores row 0 from row 7 + d on, where the tile has
        # the columns for it
        jobs = []
        for tl in ((d + 12, d + 24) if 2 * d + 24 < W else (50, 62)):
            ts = np.tile(seq(d), 4)[:d + tl]
            qs = ts.copy()
            qs[1:1 + (6 + d) // 2] = 4
            jobs.append((qs, ts[:tl], 100, 100))
        sets[f"tie{d}"] = pack(jobs)
    base = seq(tmax)
    sets["residues"] = pack([(base[:qmax], base[:qmax + 20], 60, w)
                             for w in (3, 15, 16, 17, 40)])
    sets["closed"] = pack([(base[:ql], base[:ql + w + 10], 150, w)
                           for ql in (1, 5, 31, 32, 33) for w in (1, 5)])
    snp = base.copy()
    snp[::37] = (snp[::37] + 1) % 4
    sets["qlen_edges"] = pack(
        [(base[:1], base[:tl], 30, 100) for tl in (1, 2, 70)]
        + [(base[1:2], base[:5], 30, 100)]
        + [(snp[:qmax], base, h0, w)
           for h0, w in ((40, 100), (250, 100), (250, 200))])
    return sets


def band_trace(q, t, p, a, b, o_del, e_del, o_ins, e_ins, zdrop):
    """One job (rows of q, t, params) through upstream's row loop, a row
    at a time, as the scalar code runs it.  Returns ``(out, facts)``:
    ``out`` the job's six results, ``facts`` what its band did:
    ``beg``, ``end`` (per open row), ``closed`` (the band closed while
    the job lived), ``f_run`` (the most columns between a cell where the
    F gap beat M and E and the column where that gap opened) and
    ``tie_gaps`` (distances between columns that share a row's max)."""
    qlen, tlen, h0, w, end_bonus = (int(x) for x in p[:5])
    q, t = np.asarray(q, np.int64), np.asarray(t, np.int64)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    best, max_i, max_j, max_ie, gscore, max_off = h0, -1, -1, -1, -1, 0
    facts = {"beg": [], "end": [], "closed": False, "f_run": 0,
             "tie_gaps": set()}
    eh_h = np.zeros(qlen + 2, np.int64)
    eh_e = np.zeros(qlen + 2, np.int64)
    eh_h[0] = h0
    cols = np.arange(1, qlen + 1)
    eh_h[1:qlen + 1] = np.maximum(h0 - oe_ins - (cols - 1) * e_ins, 0)
    w = min(w, max((qlen * a + end_bonus - o_ins) // e_ins + 1, 1),
            max((qlen * a + end_bonus - o_del) // e_del + 1, 1))
    beg, end = 0, qlen
    for i in range(min(tlen, len(t)) if tlen > 0 else 0):
        beg = max(beg, i - w)
        end = min(end, i + w + 1, qlen)
        h1 = max(h0 - (o_del + e_del * (i + 1)), 0) if beg == 0 else 0
        if beg >= end:
            facts["closed"] = True
            if end == qlen and h1 >= gscore:
                max_ie, gscore = i, h1
            break
        facts["beg"].append(beg)
        facts["end"].append(end)
        j = np.arange(beg, end)
        qc = q[beg:end]
        sc = np.where((t[i] > 3) | (qc > 3), -1, np.where(t[i] == qc, a, -b))
        hd, e = eh_h[beg:end], eh_e[beg:end]
        M = np.where(hd != 0, hd + sc, 0)
        v = np.maximum(M - oe_ins, 0) + j * e_ins
        pm = np.maximum.accumulate(v)
        opened = np.maximum.accumulate(np.where(v == pm, j, -1))
        F = np.zeros(end - beg, np.int64)
        F[1:] = pm[:-1] - (j[1:] - 1) * e_ins
        H = np.maximum(np.maximum(M, e), F)
        wins = np.nonzero(F[1:] > np.maximum(M, e)[1:])[0] + 1
        if len(wins):
            facts["f_run"] = max(facts["f_run"],
                                 int((j[wins] - opened[wins - 1]).max()))
        mrow = int(H.max())
        at = j[H == mrow]
        mj = int(at[-1])
        if mrow > 0:
            facts["tie_gaps"].update(int(x) for x in at[-1] - at[:-1])
        eh_e[beg:end] = np.maximum(e - e_del, np.maximum(M - oe_del, 0))
        eh_h[beg + 1:end + 1] = H
        eh_h[beg] = h1
        eh_e[end] = 0
        if end == qlen and H[-1] >= gscore:
            max_ie, gscore = i, int(H[-1])
        if mrow == 0:
            break
        if mrow > best:
            best, max_i, max_j = mrow, i, mj
            max_off = max(max_off, abs(mj - i))
        elif zdrop > 0:
            di, dj = i - max_i, mj - max_j
            dd = (di - dj) * e_del if di > dj else (dj - di) * e_ins
            if best - mrow - dd > zdrop:
                break
        nz = np.nonzero((eh_h[beg:end + 1] != 0) | (eh_e[beg:end + 1] != 0))[0]
        inner = nz[nz < end - beg]
        beg_n = beg + int(inner[0]) if len(inner) else end
        last = beg + int(nz[-1]) if len(nz) else beg_n - 1
        beg, end = beg_n, min(last + 2, qlen)
    return [best, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off], facts


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
