"""The kernel-breakdown experiment (tpubwa's
scripts/exp_kernel_breakdown.py) on PyTorch and CUDA: a reduced K1 in
nine timing variants, each removing one piece of the per-row work.

``VARIANTS`` are the JAX script's names, in its ``main``'s order
(:219-221).  Every variant is wrong on purpose except ``baseline``; the
script times them to attribute K1's per-row cost.  Two versions of each,
equal by test:

* ``extend_bd_plain``: PyTorch ops on [N, NL] int32 rows, mirroring the
  JAX body (:54-186) lane for lane: the NEG sentinel, ``torch.cummax``
  for the F scan's prefix max, ``torch.roll`` for the lane roll, and the
  row loop with its exit test made every ``step`` rows.
* the hand-written CUDA kernel in ``csrc/extend_bd.cu``, reached
  through ``extend_bd`` for CUDA tensors.

The JAX kernel's jobs are coupled across the launch: its loop runs until
every job is dead (or to ``tile_tmax``), and the band trim and
``best = max(best, m)`` are not gated on the job being active, so a job
that is dead or past its tlen goes on changing ``best``, ``beg`` and
``end`` while other jobs keep the loop running.  The kernel finds the
launch's stop row on the device (see the source's note).

Timing follows the floor experiment: the variants are checked against
their plain versions, then ``--passes`` interleaved passes time each as
the marginal ms per launch in a chain, (t(reps) - t(1)) / (reps - 1)
(``exp_kernel_real.time_launch``, CUDA events on a card), and each keeps
its minimum.  The JAX script chains its reps through params lane 6
(``pj.at[:, 6].set(out[:, 127])``, :229) to order them on the TPU; no
variant reads lane 6 and out lane 127 is always 0, so nothing is chained
here.  Unlike the JAX ``main`` (:251-253), a variant that fails raises.

Run it on a card:

    python -m tpubwa_torch.scripts.exp_kernel_breakdown --device cuda \\
        [--jobs 512,131072] [--passes 4] [--reps 8]
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from ..device import _build
from ..device.extend_kernel import _check
from .exp_int16_kernel import QL, TL, TMAX, script_jobs
from .exp_kernel_real import time_launch

I32 = torch.int32
NEG = -(1 << 29)             # the JAX kernel's sentinel (:33)
NL = 128                     # the script's query lanes (:209)
OUT_LANES = 128              # the JAX kernel's output row (:184)
# the JAX kernel's fixed scoring (:52): a, b, o_del, e_del, o_ins, e_ins
# (its zdrop is declared and never used)
SCORING = (1, 4, 6, 1, 6, 1)
VARIANTS = ("baseline", "no-transpose", "t8-slice", "tdot", "no-scan",
            "no-roll", "no-reduce", "no-trim", "unroll2")
# |h0| and |w| up to this keep every int32 expression of both versions,
# the kernel's E + row store included, from wrapping
PARAM_LIMIT = 1 << 28


def _features(variant):
    """(read, step, ncap, scan, roll, reduce, trim) of a variant, as
    ``build_kernel`` reads its name: the target read (:83-108; tdot's
    one-hot product reads column i, the table's read, as i < tile_tmax
    <= tmax), the rows per exit test (:160-172), whether the row cap is
    the job count (``tdot`` hands the kernel t un-transposed, so
    ``tile_tmax`` reads its first dimension, :72, :194), and the four
    pieces the ``no-*`` variants remove."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    read = {"no-transpose": "const", "t8-slice": "t8"}.get(variant, "table")
    step = {"unroll2": 2, "t8-slice": 8}.get(variant, 1)
    return (read, step, variant == "tdot", variant != "no-scan",
            variant != "no-roll", variant != "no-reduce",
            variant != "no-trim")


def check_bd(q, t, params, variant):
    """Raise ValueError unless the call lies in the domain where the JAX
    variant is defined and both versions compute it exactly:

    * ``extend_batch``'s shapes and types, and 0 <= qlen < NL (the lane
      roll then brings 0 into lane 0);
    * tlen <= t.shape[1]: the row cap is the tile's rows;
    * t.shape[1] >= 8 for ``t8-slice``, which slices 8 rows (:168);
    * target codes in 0-4 for ``tdot``: the TPU's bf16 one-hot product
      (:93) is exact only on small integers;
    * |h0| and |w| <= 2^28 (``PARAM_LIMIT``), so nothing wraps."""
    _features(variant)
    _check(q, t, params)
    n, tmax = t.shape
    if variant == "t8-slice" and tmax < 8:
        raise ValueError(f"t8-slice needs a target tile of 8 rows or more, "
                         f"got {tmax}")
    if n == 0:
        return
    tlen, h0, w = (params[:, k].long() for k in (1, 2, 3))
    bad = ((tlen > tmax) | (h0.abs() > PARAM_LIMIT)
           | (w.abs() > PARAM_LIMIT))
    if bool(bad.any()):
        first = bad.nonzero()[:3, 0].tolist()
        raise ValueError(
            f"K1-bd domain: each job needs tlen <= {tmax} (the target "
            f"tile) and |h0|, |w| <= {PARAM_LIMIT}; first jobs past it: "
            f"{first}")
    if variant == "tdot" and bool(((t < 0) | (t > 4)).any()):
        raise ValueError("tdot needs target codes in 0-4 (the TPU's bf16 "
                         "one-hot product)")


def extend_bd_plain(q, t, params, variant="baseline", stats=None):
    """q int32 [N, NL]; t int32 [N, tmax]; params int32 [N, >=5] lanes
    (qlen, tlen, h0, w).  Returns int32 [N, 128], lanes 0-3 = (best,
    beg, end, dead), as ``build_kernel(variant, tmax)`` computes them
    (:54-186), lane for lane, with the launch's coupling.  A ``stats``
    dict gets ``cells``, the band cells of every row the launch runs,
    of every job, split into ``live_cells`` (the job active) and
    ``frozen_cells``; and ``frozen_above_live_end``, the frozen cells
    on columns above the end_i of the job's last live row (the initial
    row's qlen if it had none), where the JAX kernel's rolled H left h 0
    and only E decayed."""
    read, step, ncap, scan, roll, reduce, trim = _features(variant)
    check_bd(q, t, params, variant)
    a, b, o_del, e_del, o_ins, e_ins = SCORING
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    dev = q.device
    N, nl = q.shape
    tmax = t.shape[1]
    out = torch.zeros((N, OUT_LANES), dtype=I32, device=dev)
    if N == 0:
        return out
    lane = torch.arange(nl, dtype=I32, device=dev)[None, :]
    qlen, tlen, h0, ww = (params[:, k:k + 1] for k in range(4))
    qpad = torch.where(lane < qlen, q, 4)
    ramp = torch.clamp_min(h0 - oe_ins - (lane - 1) * e_ins, 0)
    eh_h = torch.where(lane == 0, h0.expand(N, nl), ramp)
    eh_e = torch.zeros((N, nl), dtype=I32, device=dev)
    beg = torch.zeros((N, 1), dtype=I32, device=dev)
    end = qlen.clone()
    best = h0.clone()
    dead = torch.zeros((N, 1), dtype=torch.bool, device=dev)
    tile_tmax = min(int(tlen.max()), N if ncap else tmax)
    ones = torch.ones((N, 1), dtype=I32, device=dev)
    live_end = qlen.clone()

    def target(i):
        if read == "const":
            return ones
        if read == "t8":
            col = min(max(i - i % 8, 0), tmax - 8) + i % 8
        else:
            col = min(max(i, 0), tmax - 1)
        return t[:, col:col + 1]

    i = 0
    while i < tile_tmax and not bool(dead.all()):
        for _ in range(step):
            act = ~dead & (i < tlen)
            beg_i = torch.maximum(beg, i - ww)
            end_i = torch.minimum(torch.minimum(end, i + ww + 1), qlen)
            tb = target(i)
            isn = (tb > 3) | (qpad > 3)
            prof = torch.where(isn, -1, torch.where(tb == qpad, a, -b))
            in_band = (lane >= beg_i) & (lane < end_i)
            if stats is not None:
                cells = torch.clamp_min(end_i - beg_i, 0)
                above = in_band & ~act & (lane > live_end)
                for key, x in (("live_cells", cells[act]),
                               ("frozen_cells", cells[~act]),
                               ("frozen_above_live_end", above)):
                    stats[key] = stats.get(key, 0) + int(x.sum())
                stats["cells"] = stats["live_cells"] + stats["frozen_cells"]
                live_end = torch.where(act, end_i, live_end)
            M = torch.where(eh_h != 0, eh_h + prof, 0)
            M = torch.where(in_band, M, NEG)
            E = torch.where(in_band, eh_e, NEG)
            he = torch.maximum(M, E)
            if scan:
                t_ins = torch.where(in_band, torch.clamp_min(M - oe_ins, 0),
                                    NEG)
                pm = torch.cummax(t_ins + lane * e_ins, dim=1).values
                F = torch.where(lane >= 1, torch.roll(pm, 1, dims=1)
                                - (lane - 1) * e_ins, NEG)
            else:
                F = he - 1
            H = torch.maximum(he, F)
            H = torch.where(in_band, torch.clamp_min(H, 0), 0)
            if reduce:
                m = torch.where(in_band, H, NEG).amax(dim=1, keepdim=True)
            else:
                m = H[:, 0:1]
            Enew = torch.maximum(eh_e - e_del, torch.clamp_min(M - oe_del, 0))
            Hroll = torch.roll(H, 1, dims=1) if roll else H
            eh_h = torch.where(act, Hroll, eh_h)
            eh_e = torch.where(act, Enew, eh_e)
            if trim:
                # ungated, on the updated rows (:142-153)
                nz = in_band & ((eh_h != 0) | (eh_e != 0))
                first_nz = torch.where(nz, lane, nl + 2).amin(dim=1,
                                                              keepdim=True)
                beg = torch.minimum(first_nz, end_i)
                last_nz = torch.where(nz, lane, NEG).amax(dim=1, keepdim=True)
                end = torch.minimum(last_nz + 2, qlen)
            best = torch.maximum(best, m)
            dead = dead | (act & (m == 0))
            i += 1
    out[:, :4] = torch.cat([best, beg, end, dead.to(I32)], dim=1)
    return out


_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # (variant, q, t, params, out, frozen, aux, n, NL, tmax, pstride,
    #  ostride, device, stream) -> cudaError_t
    "tpubwa_extend_bd": (_CI, [_CI] + [_VP] * 6 + [_CI] * 6 + [_VP]),
}
AUX_LAUNCH, AUX_PER_JOB = 3, 5     # csrc/extend_bd.cu's aux layout


def _extend_bd_cuda(q, t, params, variant):
    """The C entry on CUDA tensors: the live pass, then the frozen pass
    on the row each job hands over (``frozen``, [N, NL] (h, e) pairs,
    job-major) and ``aux`` (the launch's three counters, then each
    job's state between the passes)."""
    lib = _build.load("extend_bd", _SIGNATURES)
    N, nl = q.shape
    q = q.contiguous()
    t = t.contiguous()
    params = params.contiguous()
    out = torch.zeros((N, OUT_LANES), dtype=I32, device=q.device)
    if N == 0:
        return out
    frozen = torch.empty((N, nl, 2), dtype=I32, device=q.device)
    aux = torch.empty(AUX_LAUNCH + AUX_PER_JOB * N, dtype=I32,
                      device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.tpubwa_extend_bd(
        VARIANTS.index(variant), q.data_ptr(), t.data_ptr(),
        params.data_ptr(), out.data_ptr(), frozen.data_ptr(),
        aux.data_ptr(), N, nl, t.shape[1], params.shape[1], OUT_LANES,
        q.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"extend_bd kernel ({variant}) launch failed: "
                           f"cudaError {rc}")
    extend_bd.launches += 1
    return out


def extend_bd(q, t, params, variant="baseline"):
    """K1-bd, ``build_kernel(variant, tmax)``'s contract (int32 [N, 128],
    lanes 0-3), inside ``check_bd``'s domain (ValueError past it).

    CPU tensors run ``extend_bd_plain``; CUDA tensors launch the
    hand-written kernel (``extend_bd.launches`` counts launches)."""
    check_bd(q, t, params, variant)
    if q.device.type == "cpu":
        return extend_bd_plain(q, t, params, variant)
    if q.device.type != "cuda":
        raise ValueError(f"no extend_bd kernel for device {q.device}")
    return _extend_bd_cuda(q, t, params, variant)


extend_bd.launches = 0


def bd_jobs(n, seed=0):
    """The script's jobs (:206-215) at n jobs: windows of one random
    template from ``seed``, each query the first QL bases of its target
    (a perfect match), params (QL, TL, h0 60, w 100, end_bonus 5).  No
    job dies, so the launch runs to row TL."""
    return script_jobs(np.random.default_rng(seed), n)


def dying_jobs(rng, n, tmax=TMAX):
    """n jobs that each die, alone, at a row of their own: a random
    query (qlen 20-127) whose first 0-59 bases open its random target
    (tlen = tmax), h0 1-39, w 5, 20 or 100.  A candidate that does not
    die alone (its band empties first: m is then NEG, and it never dies)
    is drawn again.  In one launch, every job but the last to die runs
    rows past its death, whose ungated trim and best move its result."""
    q = np.full((n, NL), 4, np.int32)
    t = np.zeros((n, tmax), np.int32)
    p = np.zeros((n, OUT_LANES), np.int32)
    k = 0
    while k < n:
        ql = int(rng.integers(20, NL))
        pre = int(rng.integers(0, min(ql, 60)))
        q[k, :ql] = rng.integers(0, 4, ql)
        q[k, ql:] = 4
        t[k] = rng.integers(0, 4, tmax)
        t[k, :pre] = q[k, :pre]
        p[k, :5] = (ql, tmax, int(rng.integers(1, 40)),
                    int(rng.choice([5, 20, 100])), 5)
        alone = extend_bd_plain(*(torch.from_numpy(x[k:k + 1])
                                  for x in (q, t, p)))
        k += int(alone[0, 3])
    return q, t, p


def clip_jobs(rng, n, tmax=252):
    """n jobs on a target tile of ``tmax`` rows (not a multiple of 8)
    that tell ``t8-slice``'s clipped strip (:167) and ``unroll2``'s
    extra row from ``baseline``.  Job 0, a perfect-match prefix with
    tlen tmax - 1 (odd), ends the baseline's launch at row tmax - 1.
    Each other job matches its target for its tlen (40-119) rows, so its
    last live row holds best on the diagonal; frozen after that, a row
    whose target base matches the next query base raises best by 1
    (ungated).  Its target holds that base only at row tmax - 1, and w
    puts that lane out of the band from row tmax on: ``baseline`` never
    reads it, ``unroll2`` does (it tests its exit every second row), and
    ``t8-slice`` reads row tmax - 1 from column tmax - 5 (the clip)."""
    q = rng.integers(0, 4, (n, NL)).astype(np.int32)
    q[:, NL - 1] = 4
    t = rng.integers(0, 4, (n, tmax)).astype(np.int32)
    p = np.zeros((n, OUT_LANES), np.int32)
    for k in range(n):
        tl = tmax - 1 if k == 0 else int(rng.integers(40, 120))
        t[k, :min(tl, NL - 1)] = q[k, :min(tl, NL - 1)]
        w = 250
        if k:
            c = q[k, tl]
            t[k, tl:] = (c + rng.integers(1, 4, tmax - tl)) % 4
            t[k, tmax - 1] = c
            w = tmax - 1 - tl
        p[k, :5] = (NL - 1, tl, int(rng.integers(20, 60)), w, 5)
    return q, t, p


def frozen_edge_jobs(rng, n, tmax=TMAX):
    """n + 1 jobs whose frozen trim reads columns above the end_i of
    their last live row.  Each of the first n is a perfect match (qlen
    60-100) under a narrow band (w 2-6) that goes past its tlen T (20-40)
    still open: lane end_i of its last live row holds the rolled
    H(T - 1, end_i - 1) > 0, so the frozen trim moves end to end_i + 2
    and the next frozen row reads column end_i + 1, which the JAX kernel
    holds at h 0.  h0 (50-90) puts the initial row's ramp, nonzero up to
    column h0 - 7, above end_i too: a kernel that kept its row lazily
    and read it there would see that stale h.  The last job, a perfect
    match with tlen T_max + 6 (T_max the largest T), ends the launch six
    rows later, while those frozen bands are still open."""
    q = np.full((n + 1, NL), 4, np.int32)
    t = np.full((n + 1, tmax), 4, np.int32)
    p = np.zeros((n + 1, OUT_LANES), np.int32)
    for k in range(n + 1):
        ql = int(rng.integers(60, 101))
        t[k] = rng.integers(0, 4, tmax)
        q[k, :ql] = t[k, :ql]
        p[k, :5] = (ql, int(rng.integers(20, 41)), int(rng.integers(50, 91)),
                    int(rng.integers(2, 7)), 5)
    p[n, 1] = p[:n, 1].max() + 6
    p[n, 3] = 100
    return q, t, p


def time_bd(jobs, reps, passes, device, log):
    """Check every variant against its plain version (which counts its
    band cells), then time them in ``passes`` interleaved passes; logs
    the script's lines and returns {variant: (min ms per launch,
    cells)}."""
    q, t, p = jobs
    n = len(q)
    cells, timers = {}, []
    for v in VARIANTS:
        got = extend_bd(q, t, p, v)              # checks the inputs once
        stats = {}
        want = extend_bd_plain(q, t, p, v, stats=stats)
        if not torch.equal(got, want):
            bad = int((got != want).any(1).sum())
            raise AssertionError(f"{v}: kernel != plain on {bad} jobs")
        cells[v] = stats.get("cells", 0)
        if device.type == "cuda":
            timers.append((v, lambda v=v: _extend_bd_cuda(q, t, p, v)))
        else:
            timers.append((v, lambda v=v: extend_bd_plain(q, t, p, v)))
    best = {}
    for _ in range(passes):
        for v, fn in timers:
            ms = time_launch(fn, 1, reps, 1, device)
            best[v] = min(ms, best.get(v, ms))
    base = best["baseline"]
    for v in VARIANTS:
        ms = best[v]
        note = "" if v == "baseline" else \
            f"  delta vs base: {base - ms:+.4f} ms"
        log(f"[kern] N={n} {v:13s}: {ms:8.4f} ms/launch "
            f"({n * QL * TL / (ms * 1e-3) / 1e9:7.2f} GCUPS-equiv){note}  "
            f"band cells {cells[v]}")
    return {v: (best[v], cells[v]) for v in VARIANTS}


def main(argv=None) -> dict:
    """Time the JAX script's nine variants at each ``--jobs`` size on
    the script's jobs.  Raises if a kernel differs from its plain
    version, or if a variant fails; returns the numbers it printed."""
    ap = argparse.ArgumentParser(
        prog="python -m tpubwa_torch.scripts.exp_kernel_breakdown",
        description="K1-bd: where the extension kernel's per-row time goes")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the CUDA kernel, timed with CUDA events; "
                         "cpu: its plain PyTorch version")
    ap.add_argument("--jobs", default="512",
                    help="comma-separated job counts (512: the script's)")
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args(argv)
    if args.reps < 2:
        ap.error("--reps must be at least 2")
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: torch sees no CUDA device")
        what = (f"{torch.cuda.get_device_name(dev)}: the CUDA kernel, "
                "CUDA events")
    else:
        what = "cpu: the plain PyTorch version, host clock"

    def log(m):
        print(m, flush=True)

    log(f"[kern] device {what}; GCUPS-equiv = N*QL*TL / t counts the full "
        f"{QL}x{TL} rectangle of each job, not band cells")
    timing = []
    for n in (int(s) for s in args.jobs.split(",")):
        jobs = tuple(torch.from_numpy(x).to(dev) for x in bd_jobs(n))
        res = time_bd(jobs, args.reps, args.passes, dev, log)
        timing.append({"N": n, "ms": {v: r[0] for v, r in res.items()},
                       "cells": {v: r[1] for v, r in res.items()}})
    return {"device": what, "timing": timing}


if __name__ == "__main__":
    main()
