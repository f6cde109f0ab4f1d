"""The int16 extension experiment (tpubwa's scripts/exp_int16_kernel.py)
on PyTorch and CUDA: K1, the batched banded-SW extension, with int16 DP
rows, timed against K1 in int32 on the script's jobs, and the script's
equality fuzz between the two.

Two versions of the int16 extension, bit-identical by test:

* ``extend_batch16_plain``: PyTorch ops on int16 [N, W] rows, mirroring
  scripts/exp_int16_kernel.py:_extend_kernel16 lane for lane (the int16
  sentinel NEG16, the F scan as ``torch.cummax`` on int16, the row max,
  its argmax and ``h_open`` in int32), the way
  ``device/extend_kernel.extend_batch_plain`` mirrors K1.
* the hand-written CUDA kernel in ``csrc/extend16.cu``, reached through
  ``extend_batch16`` for CUDA tensors: K1's warp per job over the live
  band with two columns a lane, packed as the 16-bit halves of 32-bit
  registers and computed with Hopper's 16x2 max-plus (DPX)
  instructions, the row and a query profile in shared memory, no global
  scratch.  It is bounded by instruction issue, as K1 is, and packing
  covers a row's band in strips of 64 columns, where K1 takes 32.

Both are held to the int16 domain of the JAX kernel (``check_int16``):
past it the JAX kernel's int16 arithmetic wraps, so nothing is defined
to compare against.  The main path (``mem``) does not use this kernel.

Run it on a card:

    python -m tpubwa_torch.scripts.exp_int16_kernel --device cuda \\
        [--jobs 512,1024,16384,131072]
"""

from __future__ import annotations

import argparse
import ctypes
import time

import numpy as np
import torch

from ..device import _build
from ..device.extend_kernel import _check, _extend_cuda, extend_batch

I16 = torch.int16
I32 = torch.int32
NEG16 = -(1 << 13)           # the JAX kernel's int16 sentinel (:25)
I16_MAX = (1 << 15) - 1

# the JAX script's jobs and scoring (:202, :217): a, b, o_del, e_del,
# o_ins, e_ins; zdrop 100
QL, TL, TMAX = 100, 200, 256
SCORING = (1, 4, 6, 1, 6, 1)
ZDROP = 100
REPS = 20                    # timed calls per size, after one warm-up
# the kernels alone: minimum of PASSES interleaved passes, each the
# marginal time per launch in a chain of CHAIN launches
PASSES, CHAIN = 4, 16
FUZZ_TRIALS, FUZZ_JOBS = 30, 64


def check_int16(q, t, params, a, b, o_del, e_del, o_ins, e_ins):
    """Raise ValueError unless the call lies in the int16 domain of
    scripts/exp_int16_kernel.py:_extend_kernel16, where none of its
    int16 expressions wraps.  With W the lanes of q:

    * penalties: a, b, o_del, e_del, o_ins, e_ins >= 0, and
      max(b, 8192) + max(o_del + e_del, o_ins + e_ins) <= 32768.  The
      lowest M is -b (:99), the sentinel is NEG16 = -8192 (:25, :100),
      and a gap open is taken from either (M - oe_ins :103,
      M - oe_del :117).
    * per job: 0 <= h0 and h0 + a * (qlen + 1) + W * e_ins <= 32767.
      h0 + a * qlen bounds every H and E cell, M = eh_h + score adds up
      to a (:99), and the F scan adds lane * e_ins on lanes up to W - 1
      and e_ins more at lane 0 (:105, :107).
    * codes: q and t lie in int16 (the kernel casts them, :64, :94).

    The CUDA kernel, with int registers and int16 stores, is exact over
    a wider range; all three versions are held to this one.  As with
    ``_check``'s qlen rule, a call past the bound raises: nothing routes
    it to int32 instead."""
    pens = {"a": a, "b": b, "o_del": o_del, "e_del": e_del,
            "o_ins": o_ins, "e_ins": e_ins}
    neg = [k for k, v in pens.items() if v < 0]
    if neg:
        raise ValueError(f"int16 domain: penalties {neg} must be >= 0")
    oe = max(o_del + e_del, o_ins + e_ins)
    if max(b, -NEG16) + oe > 1 << 15:
        raise ValueError(f"int16 domain: max(b, {-NEG16}) + {oe} (largest "
                         "gap open + extension) exceeds 32768")
    n, W = q.shape
    if n == 0:
        return
    qlen = params[:, 0].long()
    h0 = params[:, 2].long()
    hi = h0 + a * (qlen + 1) + W * e_ins
    ok = ((h0 >= 0) & (hi <= I16_MAX)).all()
    for x in (q, t):
        if x.numel():
            lo, up = torch.aminmax(x)
            ok &= (lo >= -(1 << 15)) & (up <= I16_MAX)
    if not bool(ok):
        bad = ((h0 < 0) | (hi > I16_MAX)).nonzero()[:3, 0].tolist()
        raise ValueError(
            "int16 domain: each job needs 0 <= h0 and h0 + a*(qlen + 1) "
            f"+ W*e_ins <= {I16_MAX} (W = {W}), and q, t in int16; "
            f"first jobs past it: {bad}, largest h0 + a*(qlen+1) + "
            f"W*e_ins = {int(hi.max())}")


def extend_batch16_plain(q, t, params, a, b, o_del, e_del, o_ins, e_ins,
                         zdrop, stats=None):
    """``extend_batch``'s contract (q int32 [N, W], t int32 [N, tmax],
    params int32 [N, >=5] lanes (qlen, tlen, h0, w, end_bonus); returns
    int32 [N, 6] (score, qle, tle, gtle, gscore, max_off)), computed on
    int16 DP rows as _extend_kernel16 computes it (:48-178): eh_h, eh_e,
    the score profile and the F scan in int16, the masks, the row max,
    its argmax, h_open and the per-job scalars in int32.  Inside the
    int16 domain (``check_int16``) it equals K1.  A ``stats`` dict gets
    ``cells``, the band cells of the active rows, ``rows``, the rows
    whose band is open, and ``strips32`` / ``strips64``, the strips of 32
    columns from beg and of 64 from beg & ~1 that cover [beg, end] on
    those rows (what K1's and K1-i16's strip loops run)."""
    _check(q, t, params)
    check_int16(q, t, params, a, b, o_del, e_del, o_ins, e_ins)
    dev = q.device
    N, NL = q.shape
    tmax = t.shape[1]
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins

    def c16(v):
        return torch.tensor(v, dtype=I16, device=dev)
    neg16, zero16 = c16(NEG16), c16(0)
    lane = torch.arange(NL, dtype=I32, device=dev)[None, :]   # i32 masks
    lane16 = lane.to(I16)
    qlen = params[:, 0:1]
    tlen = params[:, 1:2]
    h0 = params[:, 2:3]
    w_in = params[:, 3:4]
    ebon = params[:, 4:5]

    qpad16 = torch.where(lane < qlen, q, 4).to(I16)
    max_ins = torch.clamp_min(torch.div(qlen * a + ebon - o_ins, e_ins,
                                        rounding_mode="floor") + 1, 1)
    max_del = torch.clamp_min(torch.div(qlen * a + ebon - o_del, e_del,
                                        rounding_mode="floor") + 1, 1)
    ww = torch.minimum(torch.minimum(w_in, max_ins), max_del)

    ramp = torch.clamp_min(h0 - oe_ins - (lane - 1) * e_ins, 0)
    eh_h = torch.where(lane == 0, h0.expand(N, NL), ramp)
    eh_h = torch.where(lane <= qlen, eh_h, 0).to(I16)
    eh_e = torch.zeros((N, NL), dtype=I16, device=dev)

    zero1 = torch.zeros((N, 1), dtype=I32, device=dev)
    beg = zero1.clone()
    end = qlen.clone()
    best = h0.clone()
    max_i = zero1 - 1
    max_j = zero1 - 1
    max_ie = zero1 - 1
    gscore = zero1 - 1
    max_off = zero1.clone()
    # empty jobs (tlen <= 0) are never active: marking them dead only
    # lets the row loop stop early
    dead = tlen <= 0
    rows = min(int(tlen.max()) if N else 0, tmax)
    for i in range(rows):
        if bool(dead.all()):
            break
        act = ~dead & (i < tlen)
        beg_i = torch.maximum(beg, i - ww)
        end_i = torch.minimum(torch.minimum(end, i + ww + 1), qlen)
        closed = beg_i >= end_i
        if stats is not None:
            # band cells: what a kernel's inner loop visits on this row,
            # and the strips a warp-per-job kernel takes for [beg, end]
            open_ = act & ~closed
            for key, x in (
                    ("cells", end_i - beg_i), ("rows", 1),
                    ("strips32", (end_i - beg_i) // 32 + 1),
                    ("strips64", (end_i - (beg_i & ~1)) // 64 + 1)):
                stats[key] = stats.get(key, 0) + int(
                    torch.where(open_, x, 0).sum())
        h1_first = torch.where(
            beg_i == 0, torch.clamp_min(h0 - (o_del + e_del * (i + 1)), 0),
            0)
        tb16 = t[:, i:i + 1].to(I16)
        isn = (tb16 > 3) | (qpad16 > 3)
        prof = torch.where(isn, c16(-1), torch.where(tb16 == qpad16,
                                                     c16(a), c16(-b)))
        in_band = (lane >= beg_i) & (lane < end_i)
        M = torch.where(eh_h != 0, eh_h + prof, zero16)
        M = torch.where(in_band, M, neg16)
        E = torch.where(in_band, eh_e, neg16)
        he = torch.maximum(M, E)
        t_ins = torch.where(in_band, torch.clamp_min(M - oe_ins, 0), neg16)
        pm = torch.cummax(t_ins + lane16 * e_ins, dim=1).values
        pm1 = torch.roll(pm, 1, dims=1)
        F = torch.where(lane >= 1, pm1 - (lane16 - 1) * e_ins, neg16)
        F = torch.where(lane == beg_i, zero16, F)
        H = torch.maximum(he, F)
        H = torch.where(in_band, torch.clamp_min(H, 0), zero16)
        # row max in i32, and its LAST argmax (upstream `mj = m > h1 ?
        # mj : j`)
        m = torch.clamp_min(torch.where(in_band, H, neg16).to(I32).amax(
            dim=1, keepdim=True), 0)
        mj = torch.where(in_band & (H == m.to(I16)), lane, -1).amax(
            dim=1, keepdim=True)
        t_del = torch.clamp_min(M - oe_del, 0)
        Enew = torch.maximum(eh_e - e_del, t_del)
        upd = act & ~closed
        Hroll = torch.roll(H, 1, dims=1)
        wm_h = (lane > beg_i) & (lane <= end_i)
        h1_first16 = h1_first.to(I16)
        eh_h = torch.where(upd & wm_h, Hroll, eh_h)
        eh_h = torch.where(upd & (lane == beg_i), h1_first16, eh_h)
        eh_e = torch.where(upd & in_band, Enew, eh_e)
        eh_e = torch.where(upd & (lane == end_i), zero16, eh_e)
        cl = act & closed
        eh_h = torch.where(cl & (lane == end_i), h1_first16, eh_h)
        eh_e = torch.where(cl & (lane == end_i), zero16, eh_e)
        h_open = torch.where(lane == end_i - 1, H, zero16).sum(
            dim=1, keepdim=True, dtype=I32)
        h_last = torch.where(closed, h1_first, h_open)
        at_qend = act & (end_i == qlen) & (h_last >= gscore)
        max_ie = torch.where(at_qend, i, max_ie)
        gscore = torch.where(at_qend, h_last, gscore)
        dead = dead | (act & (closed | (m == 0)))
        alive = act & ~closed & (m != 0)
        better = alive & (m > best)
        off = torch.abs(mj - i)
        max_off = torch.where(better, torch.maximum(max_off, off), max_off)
        max_i_n = torch.where(better, i, max_i)
        max_j_n = torch.where(better, mj, max_j)
        if zdrop > 0:
            di = i - max_i
            dj = mj - max_j
            dd = torch.where(di > dj, (di - dj) * e_del, (dj - di) * e_ins)
            zd = (best - m - dd) > zdrop
            dead = dead | (alive & ~better & zd)
        best = torch.where(better, m, best)
        max_i, max_j = max_i_n, max_j_n
        # adaptive band trim to the first/last nonzero lanes
        nz = (eh_h != 0) | (eh_e != 0)
        first_nz = torch.where(in_band & nz, lane, NL + 2).amin(
            dim=1, keepdim=True)
        beg_n = torch.minimum(first_nz, end_i)
        in_s2 = (lane >= beg_n) & (lane <= end_i)
        last_nz = torch.where(in_s2 & nz, lane, -(1 << 29)).amax(
            dim=1, keepdim=True)
        j_dn = torch.where(last_nz == -(1 << 29), beg_n - 1, last_nz)
        end_n = torch.minimum(j_dn + 2, qlen)
        beg = torch.where(alive, beg_n, beg)
        end = torch.where(alive, end_n, end)
    return torch.cat([best, max_j + 1, max_i + 1, max_ie + 1, gscore,
                      max_off], dim=1)


_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # (q, t, params, out, n, W, tmax, pstride, a, b, o_del, e_del,
    #  o_ins, e_ins, zdrop, device, stream) -> cudaError_t
    "tpubwa_extend_batch16": (_CI, [_VP] * 4 + [_CI] * 12 + [_VP]),
}


def _extend16_cuda(q, t, params, a, b, o_del, e_del, o_ins, e_ins, zdrop):
    lib = _build.load("extend16", _SIGNATURES)
    N, W = q.shape
    q = q.contiguous()
    t = t.contiguous()
    params = params.contiguous()
    out = torch.empty((N, 6), dtype=I32, device=q.device)
    if N == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.tpubwa_extend_batch16(
        q.data_ptr(), t.data_ptr(), params.data_ptr(), out.data_ptr(), N, W,
        t.shape[1], params.shape[1], a, b, o_del, e_del, o_ins, e_ins,
        zdrop, q.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"extend16 kernel launch failed: cudaError {rc}")
    extend_batch16.launches += 1
    return out


def extend_batch16(q, t, params, a, b, o_del, e_del, o_ins, e_ins, zdrop):
    """K1 with int16 DP rows, ``extend_batch``'s contract, inside the
    int16 domain of ``check_int16`` (ValueError past it).

    CPU tensors run ``extend_batch16_plain``; CUDA tensors launch the
    hand-written kernel (``extend_batch16.launches`` counts launches)."""
    _check(q, t, params)
    check_int16(q, t, params, a, b, o_del, e_del, o_ins, e_ins)
    if q.device.type == "cpu":
        return extend_batch16_plain(q, t, params, a, b, o_del, e_del,
                                    o_ins, e_ins, zdrop)
    if q.device.type != "cuda":
        raise ValueError(f"no extend16 kernel for device {q.device}")
    return _extend16_cuda(q, t, params, a, b, o_del, e_del, o_ins, e_ins,
                          zdrop)


extend_batch16.launches = 0


def script_jobs(rng, n):
    """The JAX script's timing jobs (:205-212): windows of one random
    template at offsets 0..n-1, each query the first QL bases of its
    target; params (QL, TL, h0 60, w 100, end_bonus 5)."""
    tpl = rng.integers(0, 4, TL + n).astype(np.int32)
    win = np.lib.stride_tricks.sliding_window_view(tpl, TL)[:n]
    q = np.full((n, 128), 4, np.int32)
    t = np.full((n, TMAX), 4, np.int32)
    p = np.zeros((n, 128), np.int32)
    q[:, :QL] = win[:, :QL]
    t[:, :TL] = win
    p[:, :5] = (QL, TL, 60, 100, 5)
    return q, t, p


def fuzz_jobs(rng, n=FUZZ_JOBS):
    """One trial of the JAX script's equality fuzz (:234-247): random
    banded jobs, query and target from one base sequence with 8% of the
    target mutated."""
    q = np.full((n, 128), 4, np.int32)
    t = np.full((n, 256), 4, np.int32)
    p = np.zeros((n, 128), np.int32)
    for i in range(n):
        ql = int(rng.integers(5, 120))
        tl = int(rng.integers(5, 250))
        base = rng.integers(0, 4, max(ql, tl) + 10)
        q[i, :ql] = base[:ql]
        t[i, :tl] = base[:tl]
        mut = rng.random(tl) < 0.08
        t[i, :tl][mut] = rng.integers(0, 4, int(mut.sum()))
        p[i, :5] = (ql, tl, int(rng.integers(1, 100)),
                    int(rng.integers(5, 100)), 5)
    return q, t, p


def time_ms(fn, reps, device):
    """Mean ms per call of ``fn`` over ``reps`` calls after one warm-up:
    CUDA events on a card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / reps


def main(argv=None) -> dict:
    """Time K1 in int32 (``extend_batch``) against int16
    (``extend_batch16``) on the script's jobs at each ``--jobs`` size,
    through the wrappers as the JAX script times them (the mean of REPS
    calls), then run the equality fuzz between the two.  On a card both
    kernels are also timed alone, without the wrappers' input checks
    (each reads a flag back to the host), in PASSES interleaved passes
    (``exp_kernel_floor.interleaved_min``: single timing windows read
    one binary up to 1.3x apart).  Raises on any difference; returns the
    numbers it printed."""
    from .exp_kernel_floor import interleaved_min
    ap = argparse.ArgumentParser(
        prog="python -m tpubwa_torch.scripts.exp_int16_kernel",
        description="int16 against int32 banded-SW extension (K1)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the CUDA kernels, timed with CUDA events; "
                         "cpu: their plain PyTorch versions")
    ap.add_argument("--jobs", default="512,1024",
                    help="comma-separated job counts to time")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: torch sees no CUDA device")
        what = (f"{torch.cuda.get_device_name(dev)}: the CUDA kernels, "
                "CUDA events")
    else:
        what = "cpu: the plain PyTorch versions, host clock"
    print(f"device {what}; GCUPS = N*QL*TL / t counts the full "
          f"{QL}x{TL} rectangle of each job, not band cells", flush=True)
    rng = np.random.default_rng(0)
    timing = []
    for n in (int(s) for s in args.jobs.split(",")):
        q, t, p = (torch.from_numpy(x).to(dev) for x in script_jobs(rng, n))
        row = {"N": n}
        outs = {}
        for name, fn in (("i32", extend_batch), ("i16", extend_batch16)):
            def call(fn=fn):
                return fn(q, t, p, *SCORING, ZDROP)
            outs[name] = call()
            ms = time_ms(call, REPS, dev)
            gcups = n * QL * TL / (ms * 1e-3) / 1e9
            print(f"N={n} {name}: {ms:.4f} ms = {gcups:.2f} GCUPS  "
                  f"first-row {outs[name][0].tolist()}", flush=True)
            row[f"{name}_ms"] = ms
            row[f"{name}_gcups"] = gcups
        if dev.type == "cuda":
            # the inputs were checked by the calls above
            alone = interleaved_min(
                {name: lambda bare=bare: bare(q, t, p, *SCORING, ZDROP)
                 for name, bare in (("i32", _extend_cuda),
                                    ("i16", _extend16_cuda))},
                CHAIN, PASSES, dev)
            for name, ms in alone.items():
                print(f"N={n} {name} kernel alone: {ms:.4f} ms = "
                      f"{n * QL * TL / (ms * 1e-3) / 1e9:.2f} GCUPS",
                      flush=True)
                row[f"{name}_kernel_ms"] = ms
        if not torch.equal(outs["i32"], outs["i16"]):
            bad = int((outs["i32"] != outs["i16"]).any(1).sum())
            raise AssertionError(f"N={n}: i16 != i32 on {bad} jobs")
        timing.append(row)
    bad = 0
    for _ in range(FUZZ_TRIALS):
        q, t, p = (torch.from_numpy(x).to(dev) for x in fuzz_jobs(rng))
        a32 = extend_batch(q, t, p, *SCORING, ZDROP)
        a16 = extend_batch16(q, t, p, *SCORING, ZDROP)
        bad += int((a32 != a16).any(1).sum())
    n_fuzz = FUZZ_TRIALS * FUZZ_JOBS
    print(f"equality fuzz: {bad} mismatching jobs / {n_fuzz}", flush=True)
    if bad:
        raise AssertionError(f"equality fuzz: i16 != i32 on {bad} of "
                             f"{n_fuzz} jobs")
    return {"device": what, "timing": timing, "fuzz_jobs": n_fuzz,
            "fuzz_mismatches": bad}


if __name__ == "__main__":
    main()
