"""The real-kernel attribution experiment (tpubwa's
scripts/exp_kernel_real.py) on PyTorch and CUDA: K1's body with one
feature stripped per variant, timed against K1 itself on the script's
jobs, with an equality fuzz of the exact variants against K1.

``VARIANTS`` are the JAX script's names: the four it times (``full`` and
the TPU reduction layouts ``rollred-fused``, ``-u2``, ``-u4``, which are
exact) and the seven ``no-*`` variants its ``build_kernel`` accepts
(timing only: each strips one feature, so its result differs from K1's
on purpose).  Two versions of each, equal by test:

* ``extend_real_plain``: PyTorch ops on [N, NL] int32 rows, mirroring
  the JAX body lane for lane (the NEG sentinel, ``torch.cummax`` for
  the F scan's prefix max, the packed argmax of the fused variants, the
  rollred trim range), the way ``extend_batch_plain`` mirrors K1.
* the hand-written CUDA kernel: K1's own template in ``csrc/extend.cu``
  (a warp per job over the live band, the row in shared memory), one
  instantiation per stripped feature and K1's itself for the exact
  variants, behind the C entry ``tpubwa_extend_real``, reached through
  ``extend_real`` for CUDA tensors.

Both hold every call to the domain of ``check_real``, where the JAX
variants are defined job by job.  The main path (``mem``) does not use
these kernels.

Timing follows the JAX script: the marginal time per launch in a chain,
(t(K2 launches) - t(K1 launches)) / (K2 - K1), the minimum over
``--trials``.  On the TPU the difference cancelled the host link's
jitter; here CUDA events bracket the launches on the device, so it
cancels only the fixed cost of one timed window (the event records and
the first launch's queueing) and changes the reading little.  It is
kept so that the printed quantity stays the script's.

Run it on a card:

    python -m tpubwa_torch.scripts.exp_kernel_real --device cuda \\
        [--jobs 512,16384,131072] [--k1 4] [--k2 36] [--trials 5] \\
        [--fuzz 30]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..device import _build
from ..device.extend_kernel import (_SIGNATURES, _check, _extend_cuda,
                                    extend_batch, extend_batch_plain)
from .exp_int16_kernel import QL, TL, TMAX, fuzz_jobs, script_jobs

I32 = torch.int32
NEG = -(1 << 29)             # the JAX kernel's sentinel (:32)
NL = 128                     # the script's query lanes (:281)
OUT_LANES = 128              # the JAX kernel's output row (:255)
# the JAX kernel's fixed scoring (:59): a, b, o_del, e_del, o_ins, e_ins;
# zdrop 100
SCORING = (1, 4, 6, 1, 6, 1)
ZDROP = 100
TIMED = ("full", "rollred-fused", "rollred-fused-u2", "rollred-fused-u4")
STRIPPED = ("scan", "mj", "wbmask", "gscore", "offtrack", "zdrop", "trim")
VARIANTS = TIMED + tuple("no-" + f for f in STRIPPED)
FUZZ_JOBS = 64


def _features(variant):
    """(has, rollred, fused, unroll) of a variant, as build_kernel reads
    its name (:60-67)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    has = {f: variant != "no-" + f for f in STRIPPED}
    unroll = (4 if variant.endswith("-u4")
              else 2 if variant.endswith("-u2") else 1)
    return (has, variant.startswith("rollred"),
            variant.startswith("rollred-fused"), unroll)


def check_real(q, t, params):
    """Raise ValueError unless the call lies in the domain where every
    JAX variant is defined job by job (and the variants that are exact
    agree with each other):

    * ``extend_batch``'s shapes and types, and 0 <= qlen < NL;
    * tlen <= t.shape[1]: past it the JAX kernel clips the row it reads
      (:127), and the unrolled variants run rows past ``tile_tmax``
      (:111, :241-248);
    * NL a power of two: the fused variants pack the row max and its
      lane as H * NL + lane and read the lane back with a mask (:153-159);
    * h0 + a * qlen <= (2^31 - NL) / NL: every H is at most
      h0 + a * qlen, so the packed H * NL + lane stays in int32.  For a
      power of two NL this is the limit of K1's own packed (H << sh) | j
      (``extend_kernel._check`` with ``a``), which the CUDA kernel, K1's
      template, shares."""
    _check(q, t, params)
    n, nl = q.shape
    if nl & (nl - 1):
        raise ValueError(f"NL = {nl} query lanes: NL must be a power of "
                         "two (the fused variants' packed argmax)")
    if n == 0:
        return
    hmax = ((1 << 31) - nl) // nl
    qlen, tlen, h0 = (params[:, k].long() for k in range(3))
    bad = (tlen > t.shape[1]) | (h0 + SCORING[0] * qlen > hmax)
    if bool(bad.any()):
        first = bad.nonzero()[:3, 0].tolist()
        raise ValueError(
            f"K1-real domain: each job needs tlen <= {t.shape[1]} (the "
            f"target tile) and h0 + a*qlen <= {hmax}; first jobs past it: "
            f"{first}")


def extend_real_plain(q, t, params, variant="full", stats=None):
    """q int32 [N, NL]; t int32 [N, tmax]; params int32 [N, >=5] lanes
    (qlen, tlen, h0, w, end_bonus).  Returns int32 [N, 128], lanes 0-5 =
    (best, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off), as
    ``build_kernel(variant)`` computes them (:87-256), lane for lane.
    A ``stats`` dict gets ``cells``, the band cells of the active rows."""
    has, rollred, fused, _ = _features(variant)
    check_real(q, t, params)
    a, b, o_del, e_del, o_ins, e_ins = SCORING
    dev = q.device
    N, nl = q.shape
    tmax = t.shape[1]
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    lane = torch.arange(nl, dtype=I32, device=dev)[None, :]
    qlen = params[:, 0:1]
    tlen = params[:, 1:2]
    h0 = params[:, 2:3]
    w_in = params[:, 3:4]
    ebon = params[:, 4:5]
    qpad = torch.where(lane < qlen, q, 4)
    max_ins = torch.clamp_min(torch.div(qlen * a + ebon - o_ins, e_ins,
                                        rounding_mode="floor") + 1, 1)
    max_del = torch.clamp_min(torch.div(qlen * a + ebon - o_del, e_del,
                                        rounding_mode="floor") + 1, 1)
    ww = torch.minimum(torch.minimum(w_in, max_ins), max_del)
    ramp = torch.clamp_min(h0 - oe_ins - (lane - 1) * e_ins, 0)
    eh_h = torch.where(lane == 0, h0.expand(N, nl), ramp)
    eh_h = torch.where(lane <= qlen, eh_h, 0)
    eh_e = torch.zeros((N, nl), dtype=I32, device=dev)
    zero1 = torch.zeros((N, 1), dtype=I32, device=dev)
    beg = zero1.clone()
    end = qlen.clone()
    best = h0.clone()
    max_i = zero1 - 1
    max_j = zero1 - 1
    max_ie = zero1 - 1
    gscore = zero1 - 1
    max_off = zero1.clone()
    # jobs with tlen <= 0 are never active: marking them dead only lets
    # the row loop stop early, as rows past a job's tlen are no-ops
    dead = tlen <= 0
    sh_nl = nl.bit_length() - 1
    rows = min(int(tlen.max()) if N else 0, tmax)
    for i in range(rows):
        if bool(dead.all()):
            break
        act = ~dead & (i < tlen)
        beg_i = torch.maximum(beg, i - ww)
        end_i = torch.minimum(torch.minimum(end, i + ww + 1), qlen)
        closed = beg_i >= end_i
        if stats is not None:
            # band cells: what a kernel's inner loop visits on this row
            stats["cells"] = stats.get("cells", 0) + int(torch.where(
                act & ~closed, end_i - beg_i, 0).sum())
        h1_first = torch.where(
            beg_i == 0, torch.clamp_min(h0 - (o_del + e_del * (i + 1)), 0),
            0)
        tb = t[:, i:i + 1]
        isn = (tb > 3) | (qpad > 3)
        prof = torch.where(isn, -1, torch.where(tb == qpad, a, -b))
        in_band = (lane >= beg_i) & (lane < end_i)
        M = torch.where(eh_h != 0, eh_h + prof, 0)
        M = torch.where(in_band, M, NEG)
        E = torch.where(in_band, eh_e, NEG)
        he = torch.maximum(M, E)
        if has["scan"]:
            t_ins = torch.where(in_band, torch.clamp_min(M - oe_ins, 0), NEG)
            pm = torch.cummax(t_ins + lane * e_ins, dim=1).values
            F = torch.where(lane >= 1, torch.roll(pm, 1, dims=1)
                            - (lane - 1) * e_ins, NEG)
            F = torch.where(lane == beg_i, 0, F)
        else:
            F = he - 1
        H = torch.maximum(he, F)
        H = torch.where(in_band, torch.clamp_min(H, 0), 0)
        if fused:
            # the row max and its last-wins argmax in one packed max
            Pm = torch.where(in_band, H * nl + lane, NEG).amax(
                dim=1, keepdim=True)
            m = torch.clamp_min(Pm >> sh_nl, 0)
            mj = Pm & (nl - 1)
        else:
            m = torch.clamp_min(torch.where(in_band, H, NEG).amax(
                dim=1, keepdim=True), 0)
            if has["mj"]:
                mj = torch.where(in_band & (H == m), lane, -1).amax(
                    dim=1, keepdim=True)
            else:
                mj = m * 0
        t_del = torch.clamp_min(M - oe_del, 0)
        Enew = torch.maximum(eh_e - e_del, t_del)
        upd = act & ~closed
        Hroll = torch.roll(H, 1, dims=1)
        if has["wbmask"]:
            wm_h = (lane > beg_i) & (lane <= end_i)
            eh_h = torch.where(upd & wm_h, Hroll, eh_h)
            eh_h = torch.where(upd & (lane == beg_i), h1_first, eh_h)
            eh_e = torch.where(upd & in_band, Enew, eh_e)
            eh_e = torch.where(upd & (lane == end_i), 0, eh_e)
            cl = act & closed
            eh_h = torch.where(cl & (lane == end_i), h1_first, eh_h)
            eh_e = torch.where(cl & (lane == end_i), 0, eh_e)
        else:
            eh_h = torch.where(upd, Hroll, eh_h)
            eh_e = torch.where(upd, Enew, eh_e)
        if has["gscore"]:
            # one lane is nonzero and H >= 0: the max is that lane's H
            h_open = torch.where(lane == end_i - 1, H, 0).amax(
                dim=1, keepdim=True)
            h_last = torch.where(closed, h1_first, h_open)
            at_qend = act & (end_i == qlen) & (h_last >= gscore)
            max_ie = torch.where(at_qend, i, max_ie)
            gscore = torch.where(at_qend, h_last, gscore)
        dead = dead | (act & (closed | (m == 0)))
        alive = act & ~closed & (m != 0)
        better = alive & (m > best)
        if has["offtrack"]:
            max_off = torch.where(better, torch.maximum(
                max_off, torch.abs(mj - i)), max_off)
        max_i_n = torch.where(better, i, max_i)
        max_j_n = torch.where(better, mj, max_j)
        if has["zdrop"]:
            di = i - max_i
            dj = mj - max_j
            dd = torch.where(di > dj, (di - dj) * e_del, (dj - di) * e_ins)
            zd = (best - m - dd) > ZDROP
            dead = dead | (alive & ~better & zd)
        best = torch.where(better, m, best)
        max_i, max_j = max_i_n, max_j_n
        if has["trim"]:
            nz = (eh_h != 0) | (eh_e != 0)
            first_nz = torch.where(in_band & nz, lane, nl + 2).amin(
                dim=1, keepdim=True)
            beg_n = torch.minimum(first_nz, end_i)
            if rollred:
                in_s2 = in_band | (lane == end_i)
            else:
                in_s2 = (lane >= beg_n) & (lane <= end_i)
            last_nz = torch.where(in_s2 & nz, lane, NEG).amax(
                dim=1, keepdim=True)
            j_dn = torch.where(last_nz == NEG, beg_n - 1, last_nz)
            end_n = torch.minimum(j_dn + 2, qlen)
            beg = torch.where(alive, beg_n, beg)
            end = torch.where(alive, end_n, end)
    out = torch.zeros((N, OUT_LANES), dtype=I32, device=dev)
    out[:, :6] = torch.cat([best, max_j + 1, max_i + 1, max_ie + 1, gscore,
                            max_off], dim=1)
    return out


def launch_scoring(variant):
    """(a, b, o_del, e_del, o_ins, e_ins, zdrop) that ``variant``'s
    launch of csrc/extend.cu takes: the script's scoring, and its z-drop
    but for no-zdrop, which is K1 at zdrop 0."""
    return (*SCORING, 0 if variant == "no-zdrop" else ZDROP)


def _extend_real_cuda(q, t, params, variant):
    """One launch of ``variant``'s instantiation of csrc/extend.cu's
    kernel, without the wrapper's input checks.  The kernel keeps a
    job's row in shared memory and needs no scratch; it writes lanes
    0-5 of each job's 128-lane output row, which starts zeroed."""
    lib = _build.load("extend", _SIGNATURES)
    N, nl = q.shape
    q = q.contiguous()
    t = t.contiguous()
    params = params.contiguous()
    out = torch.zeros((N, OUT_LANES), dtype=I32, device=q.device)
    if N == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.tpubwa_extend_real(
        VARIANTS.index(variant), q.data_ptr(), t.data_ptr(),
        params.data_ptr(), out.data_ptr(), N, nl, t.shape[1],
        params.shape[1], OUT_LANES, *launch_scoring(variant), q.device.index,
        stream)
    if rc != 0:
        raise RuntimeError(f"extend_real kernel ({variant}) launch failed: "
                           f"cudaError {rc}")
    extend_real.launches += 1
    return out


def extend_real(q, t, params, variant="full"):
    """K1-real, ``build_kernel(variant)``'s contract (int32 [N, 128],
    lanes 0-5), inside ``check_real``'s domain (ValueError past it).

    CPU tensors run ``extend_real_plain``; CUDA tensors launch the
    hand-written kernel (``extend_real.launches`` counts launches)."""
    _features(variant)
    check_real(q, t, params)
    if q.device.type == "cpu":
        return extend_real_plain(q, t, params, variant)
    if q.device.type != "cuda":
        raise ValueError(f"no extend_real kernel for device {q.device}")
    return _extend_real_cuda(q, t, params, variant)


extend_real.launches = 0


def _k1(q, t, p):
    return extend_batch(q, t, p, *SCORING, ZDROP)


def time_launch(fn, k1, k2, trials, device):
    """The JAX script's per-launch time (:291-310): the minimum over
    ``trials`` of (t(k2 calls) - t(k1 calls)) / (k2 - k1) ms, after one
    warm-up of each; CUDA events on a card, the host clock on the
    CPU."""
    def window(k):
        if device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(k):
                fn()
            return (time.perf_counter() - t0) * 1e3
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            fn()
        stop.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(stop)
    window(k1)
    window(k2)
    return min((window(k2) - window(k1)) / (k2 - k1) for _ in range(trials))


def adversarial_jobs(rng, n=FUZZ_JOBS):
    """n jobs at the script's shapes (q [n, 128], t [n, 256]): half the
    int16 script's fuzz jobs (query and target from one sequence, 8% of
    the target mutated), half homologous with an indel of 1-6 bases, N
    codes on either side, and empty targets or queries."""
    q, t, p = fuzz_jobs(rng, n)
    for i in range(n // 2, n):
        ql = int(rng.integers(1, NL))
        tl = int(rng.integers(1, TMAX + 1))
        base = rng.integers(0, 4, TMAX + 8)
        cut = int(rng.integers(0, ql))
        gap = int(rng.integers(1, 7))
        if rng.random() < 0.5:       # a deletion from the query
            src = np.concatenate([base[:cut], base[cut + gap:]])
        else:                        # an insertion into it
            src = np.concatenate([base[:cut], rng.integers(0, 4, gap),
                                  base[cut:]])
        q[i] = 4
        t[i] = 4
        q[i, :ql] = src[:ql]
        t[i, :tl] = base[:tl]
        q[i, :ql][rng.random(ql) < 0.01] = 4
        t[i, :tl][rng.random(tl) < 0.01] = 4
        p[i, :5] = (ql, tl, int(rng.integers(1, 100)),
                    int(rng.choice([3, 10, 25, 100])),
                    int(rng.choice([0, 5])))
    p[rng.random(n) < 0.05, 1] = 0
    p[rng.random(n) < 0.03, 0] = 0
    return q, t, p


def zdrop_jobs(rng, n):
    """n jobs that only z-drop stops early, so no-zdrop differs from
    full on them: a strong prefix (h0 150-300, 40-70 matching bases),
    then a random query tail against a random target tail, in a narrow
    band: the score falls by more than the z-drop of 100 before the band
    reaches the query's end."""
    q = np.full((n, NL), 4, np.int32)
    t = np.full((n, TMAX), 4, np.int32)
    p = np.zeros((n, 128), np.int32)
    for i in range(n):
        pre = int(rng.integers(40, 71))
        q[i, :127] = rng.integers(0, 4, 127)
        t[i, :200] = rng.integers(0, 4, 200)
        t[i, :pre] = q[i, :pre]
        p[i, :5] = (127, 200, int(rng.integers(150, 301)),
                    int(rng.choice([5, 10, 20])), 5)
    return q, t, p


def wbmask_jobs(rng, n):
    """n jobs that tell no-wbmask from full: the query starts 2-6 bases
    into the target (a mismatch at the first cell), with h0 large enough
    that the h1_first column, which only the band write-back keeps,
    carries the best path; and (odd jobs) a band that the trim narrows
    before w lets it widen again."""
    q = np.full((n, NL), 4, np.int32)
    t = np.full((n, TMAX), 4, np.int32)
    p = np.zeros((n, 128), np.int32)
    for i in range(n):
        ql = int(rng.integers(60, 120))
        k = int(rng.integers(2, 7))
        q[i, :ql] = rng.integers(0, 4, ql)
        t[i, :k] = (q[i, 0] + 1 + rng.integers(0, 3, k)) % 4
        t[i, k:k + ql] = q[i, :ql]
        tl = min(k + ql + int(rng.integers(0, 40)), TMAX)
        if i % 2:
            # a stretch of mismatches mid-query: the trim narrows the
            # band, and the match after it widens it again
            mid = int(rng.integers(20, ql - 20))
            t[i, k + mid:k + mid + 8] = (q[i, mid:mid + 8] + 2) % 4
        p[i, :5] = (ql, tl, int(rng.integers(30, 61)),
                    int(rng.choice([10, 100])), 5)
    return q, t, p


def experiment_jobs(sizes, seed=0):
    """The jobs ``main`` times: (n, script_jobs(rng, n)) for each size in
    order, from one generator seeded ``seed``."""
    rng = np.random.default_rng(seed)
    return [(n, script_jobs(rng, n)) for n in sizes]


def main(argv=None) -> dict:
    """Time K1 (``extend_batch``, the "real" kernel) and the four exact
    variants on the script's jobs at each ``--jobs`` size and check each
    variant's result against K1's, then run the equality fuzz of the
    four against K1 on adversarial jobs.  On a card each is timed as
    the kernel launch alone (the inputs are checked once, by the first
    call); on the CPU, the plain versions.  Raises on any difference;
    returns the numbers it printed."""
    ap = argparse.ArgumentParser(
        prog="python -m tpubwa_torch.scripts.exp_kernel_real",
        description="K1 with one feature stripped per variant")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the CUDA kernels, timed with CUDA events; "
                         "cpu: their plain PyTorch versions")
    ap.add_argument("--jobs", default="512",
                    help="comma-separated job counts to time")
    ap.add_argument("--k1", type=int, default=4)
    ap.add_argument("--k2", type=int, default=36)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--fuzz", type=int, default=30,
                    help="trials of 64 adversarial jobs (0: none)")
    args = ap.parse_args(argv)
    if args.k2 <= args.k1:
        ap.error("--k2 must exceed --k1")
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: torch sees no CUDA device")
        what = (f"{torch.cuda.get_device_name(dev)}: the CUDA kernels, "
                "CUDA events")
        k1_fn, real_fn = _extend_cuda, _extend_real_cuda
    else:
        what = "cpu: the plain PyTorch versions, host clock"
        k1_fn, real_fn = extend_batch_plain, extend_real_plain
    print(f"device {what}; GCUPS-equiv = N*QL*TL / t counts the full "
          f"{QL}x{TL} rectangle of each job, not band cells", flush=True)
    timing = []
    for n, jobs in experiment_jobs([int(s) for s in args.jobs.split(",")]):
        q, t, p = (torch.from_numpy(x).to(dev) for x in jobs)
        ref = _k1(q, t, p)                   # checks the inputs once
        row = {"N": n}

        def report(name, ms, note=""):
            gc = n * QL * TL / (ms * 1e-3) / 1e9
            print(f"[kern] N={n} {name:16s}: {ms:8.4f} ms/launch "
                  f"({gc:7.2f} GCUPS-equiv){note}", flush=True)
            row[f"{name}_ms"] = ms
        report("real-import", time_launch(
            lambda: k1_fn(q, t, p, *SCORING, ZDROP), args.k1, args.k2,
            args.trials, dev))
        for variant in TIMED:
            out = extend_real(q, t, p, variant)
            if not torch.equal(out[:, :6], ref):
                bad = int((out[:, :6] != ref).any(1).sum())
                raise AssertionError(f"N={n} {variant}: differs from K1 on "
                                     f"{bad} jobs")
            ms = time_launch(lambda v=variant: real_fn(q, t, p, v), args.k1,
                             args.k2, args.trials, dev)
            note = "  out == real"
            if variant != "full":
                note += f"  saves {row['full_ms'] - ms:+.4f} ms"
            report(variant, ms, note)
        timing.append(row)
    bad = 0
    rng = np.random.default_rng(1)
    for _ in range(args.fuzz):
        q, t, p = (torch.from_numpy(x).to(dev)
                   for x in adversarial_jobs(rng))
        ref = _k1(q, t, p)
        for variant in TIMED:
            bad += int((extend_real(q, t, p, variant)[:, :6] != ref)
                       .any(1).sum())
    n_fuzz = args.fuzz * FUZZ_JOBS
    print(f"equality fuzz: {bad} mismatching (variant, job) pairs of "
          f"{len(TIMED)} x {n_fuzz}", flush=True)
    if bad:
        raise AssertionError(f"equality fuzz: {bad} (variant, job) pairs "
                             "differ from K1")
    return {"device": what, "timing": timing, "fuzz_jobs": n_fuzz,
            "fuzz_mismatches": bad}


if __name__ == "__main__":
    main()
