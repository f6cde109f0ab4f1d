"""Batched banded-SW seed extension (bwa ksw.c:ksw_extend2), the
counterpart of tpubwa/device/extend_pallas.py.

Two versions of one function, bit-identical by test:

* ``extend_batch_plain``: PyTorch ops, vectorized over jobs, one loop
  step per target row.  The DP rows are [N, W] int32 tensors (one query
  cell per lane), so the F-gap running max is ``torch.cummax`` along
  the lanes (the TPU kernel's log-shift scan).
* the hand-written CUDA kernel in ``csrc/extend.cu`` (one thread per
  job), reached through ``extend_batch`` for CUDA tensors.

``extend_batch`` routes by the tensors' device: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises.  Nothing
falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

LANES = 512          # widest DP row -> qlen <= LANES - 1 (510 bp reads)
CHUNK = 512          # jobs per kernel launch in the JAX package
NEG = -(1 << 29)
I32 = torch.int32


def chunk_for(width: int) -> int:
    """Jobs per launch in the JAX package's chunking (kept for callers
    that size batches the same way)."""
    return CHUNK if width <= 256 else CHUNK // 2


def width_for(max_qlen: int) -> int:
    """DP lane-width bucket: the smallest of 128/256/512 above
    ``max_qlen``."""
    for w in (128, 256, LANES):
        if max_qlen < w:
            return w
    return LANES


def _mat_ab(mat):
    """Extract (a, b) from a bwa_fill_scmat-structured matrix; None if
    the matrix doesn't have that structure."""
    mat = np.asarray(mat)
    a = int(mat[0, 0])
    b = -int(mat[0, 1])
    ok = True
    for i in range(4):
        for j in range(4):
            ok &= int(mat[i, j]) == (a if i == j else -b)
    ok &= np.all(mat[4, :] == -1) and np.all(mat[:, 4] == -1)
    return (a, b) if ok else None


def _check(q, t, params):
    if q.dim() != 2 or t.dim() != 2 or params.dim() != 2:
        raise ValueError("q, t and params must be 2-D")
    n = q.shape[0]
    if t.shape[0] != n or params.shape[0] != n or params.shape[1] < 5:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"t {tuple(t.shape)}, params "
                         f"{tuple(params.shape)}")
    for name, x in (("q", q), ("t", t), ("params", params)):
        if x.dtype != I32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    # the kernel indexes the query tile and its W + 2 scratch columns by
    # qlen: one out-of-range job would write past them
    qlen = params[:, 0]
    if n and not bool(((qlen >= 0) & (qlen < q.shape[1])).all()):
        raise ValueError(f"qlen must lie in [0, {q.shape[1] - 1}], the "
                         "query tile's lanes")


def extend_batch_plain(q, t, params, a, b, o_del, e_del, o_ins, e_ins,
                       zdrop):
    """q int32 [N, W]; t int32 [N, tmax]; params int32 [N, >=5] with
    lanes (qlen, tlen, h0, w, end_bonus), h0 > 0.  Returns int32
    [N, 6]: (score, qle, tle, gtle, gscore, max_off).

    The row step mirrors extend_pallas.py:_extend_kernel lane for lane:
    the shifted eh arrays of upstream (eh_h[j] = H(i-1, j-1)), band
    masks as lane predicates, per-job scalars as [N, 1] columns."""
    _check(q, t, params)
    dev = q.device
    N, NL = q.shape
    tmax = t.shape[1]
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    lane = torch.arange(NL, dtype=I32, device=dev)[None, :]
    qlen = params[:, 0:1]
    tlen = params[:, 1:2]
    h0 = params[:, 2:3]
    w_in = params[:, 3:4]
    ebon = params[:, 4:5]

    qpad = torch.where(lane < qlen, q, 4)
    # band cap w = min(w, max_ins, max_del) (mat max = a)
    max_ins = torch.clamp_min(torch.div(qlen * a + ebon - o_ins, e_ins,
                                        rounding_mode="floor") + 1, 1)
    max_del = torch.clamp_min(torch.div(qlen * a + ebon - o_del, e_del,
                                        rounding_mode="floor") + 1, 1)
    ww = torch.minimum(torch.minimum(w_in, max_ins), max_del)

    # first row: eh_h[0] = h0, eh_h[j] = max(h0 - oe_ins - (j-1) e_ins, 0)
    ramp = torch.clamp_min(h0 - oe_ins - (lane - 1) * e_ins, 0)
    eh_h = torch.where(lane == 0, h0.expand(N, NL), ramp)
    eh_h = torch.where(lane <= qlen, eh_h, 0)
    eh_e = torch.zeros((N, NL), dtype=I32, device=dev)

    zero1 = torch.zeros((N, 1), dtype=I32, device=dev)
    beg = zero1.clone()
    end = qlen.clone()
    best = h0.clone()
    max_i = zero1 - 1
    max_j = zero1 - 1
    max_ie = zero1 - 1
    gscore = zero1 - 1
    max_off = zero1.clone()
    # empty jobs (tlen <= 0) are dead from the start: act gates every
    # write-back, so this only lets the row loop stop early
    dead = tlen <= 0
    sh_nl = NL.bit_length() - 1
    rows = min(int(tlen.max()) if N else 0, tmax)
    for i in range(rows):
        if bool(dead.all()):
            break
        act = ~dead & (i < tlen)
        beg_i = torch.maximum(beg, i - ww)
        end_i = torch.minimum(torch.minimum(end, i + ww + 1), qlen)
        closed = beg_i >= end_i
        h1_first = torch.where(
            beg_i == 0, torch.clamp_min(h0 - (o_del + e_del * (i + 1)), 0),
            0)
        tb = t[:, i:i + 1]
        # score: match a, mismatch -b, N on either side -1
        isn = (tb > 3) | (qpad > 3)
        prof = torch.where(isn, -1, (tb == qpad).to(I32) * (a + b) - b)
        in_band = (lane >= beg_i) & (lane < end_i)
        M = torch.where(eh_h != 0, eh_h + prof, 0)
        M = torch.where(in_band, M, NEG)
        E = torch.where(in_band, eh_e, NEG)
        he = torch.maximum(M, E)
        # F(j) = max_{u < j} (t_ins[u] - (j-1-u) e_ins): a running max
        # of t_ins[u] + u e_ins, read one lane to the right
        t_ins = torch.where(in_band, torch.clamp_min(M - oe_ins, 0),
                            NEG)
        pm = torch.cummax(t_ins + lane * e_ins, dim=1).values
        pm1 = torch.roll(pm, 1, dims=1)
        F = torch.where(lane >= 1, pm1 - (lane - 1) * e_ins, NEG)
        F = torch.where(lane == beg_i, 0, F)
        H = torch.maximum(he, F)
        H = torch.where(in_band, torch.clamp_min(H, 0), 0)
        t_del = torch.clamp_min(M - oe_del, 0)
        Enew = torch.maximum(eh_e - e_del, t_del)
        # write-backs: H shifts one lane right into eh_h
        upd = act & ~closed
        Hroll = torch.roll(H, 1, dims=1)
        wm_h = (lane > beg_i) & (lane <= end_i)
        eh_h = torch.where(upd & wm_h, Hroll, eh_h)
        eh_h = torch.where(upd & (lane == beg_i), h1_first, eh_h)
        eh_e = torch.where(upd & in_band, Enew, eh_e)
        eh_e = torch.where(upd & (lane == end_i), 0, eh_e)
        cl = act & closed
        eh_h = torch.where(cl & (lane == end_i), h1_first, eh_h)
        eh_e = torch.where(cl & (lane == end_i), 0, eh_e)
        # row max and its LAST argmax in one packed max over H*NL+lane
        # (upstream's `mj = m > h1 ? mj : j`); H < 2^22 keeps it in i32
        pk = torch.where(in_band, H * NL + lane, NEG).amax(
            dim=1, keepdim=True)
        h_open = torch.where(lane == end_i - 1, H, 0).amax(
            dim=1, keepdim=True)
        nz = (eh_h != 0) | (eh_e != 0)
        first_nz = torch.where(in_band & nz, lane, NL + 2).amin(
            dim=1, keepdim=True)
        last_nz = torch.where((in_band | (lane == end_i)) & nz, lane,
                              NEG).amax(dim=1, keepdim=True)
        m = torch.clamp_min(pk >> sh_nl, 0)
        mj = pk & (NL - 1)
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
            # asymmetric z-drop: the longer gap side pays its extension
            di = i - max_i
            dj = mj - max_j
            dd = torch.where(di > dj, (di - dj) * e_del, (dj - di) * e_ins)
            zd = (best - m - dd) > zdrop
            dead = dead | (alive & ~better & zd)
        best = torch.where(better, m, best)
        max_i, max_j = max_i_n, max_j_n
        # adaptive band trim to the first/last nonzero lanes
        beg_n = torch.minimum(first_nz, end_i)
        j_dn = torch.where(last_nz == NEG, beg_n - 1, last_nz)
        end_n = torch.minimum(j_dn + 2, qlen)
        beg = torch.where(alive, beg_n, beg)
        end = torch.where(alive, end_n, end)
    return torch.cat([best, max_j + 1, max_i + 1, max_ie + 1, gscore,
                      max_off], dim=1)


_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # (q, t, params, out, eh, n, W, tmax, pstride, a, b, o_del, e_del,
    #  o_ins, e_ins, zdrop, device, stream) -> cudaError_t
    "tpubwa_extend_batch": (_CI, [_VP] * 5 + [_CI] * 12 + [_VP]),
}


def _extend_cuda(q, t, params, a, b, o_del, e_del, o_ins, e_ins, zdrop):
    lib = _build.load("extend", _SIGNATURES)
    N, W = q.shape
    q = q.contiguous()
    t = t.contiguous()
    params = params.contiguous()
    out = torch.empty((N, 6), dtype=I32, device=q.device)
    if N == 0:
        return out
    # eh scratch, job-minor ([W+2, N] of (h, e) pairs): a warp's jobs at
    # the same query column read neighbouring addresses
    eh = torch.empty((W + 2, N, 2), dtype=I32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.tpubwa_extend_batch(
        q.data_ptr(), t.data_ptr(), params.data_ptr(), out.data_ptr(),
        eh.data_ptr(), N, W, t.shape[1], params.shape[1], a, b, o_del,
        e_del, o_ins, e_ins, zdrop, q.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"extend kernel launch failed: cudaError {rc}")
    extend_batch.launches += 1
    return out


def extend_batch(q, t, params, a, b, o_del, e_del, o_ins, e_ins, zdrop):
    """The extend_batch_pallas contract (extend_pallas.py:341-376):
    q int32 [N, W]; t int32 [N, tmax]; params int32 [N, >=5] lanes
    (qlen, tlen, h0, w, end_bonus), h0 > 0, qlen < W.  Returns int32
    [N, 6] (score, qle, tle, gtle, gscore, max_off).

    CPU tensors run ``extend_batch_plain``; CUDA tensors launch the
    hand-written kernel (``extend_batch.launches`` counts launches)."""
    _check(q, t, params)
    if q.device.type == "cpu":
        return extend_batch_plain(q, t, params, a, b, o_del, e_del, o_ins,
                                  e_ins, zdrop)
    if q.device.type != "cuda":
        raise ValueError(f"no extend kernel for device {q.device}")
    return _extend_cuda(q, t, params, a, b, o_del, e_del, o_ins, e_ins,
                        zdrop)


extend_batch.launches = 0
