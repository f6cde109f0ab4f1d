"""Batched banded-SW seed extension (bwa ksw.c:ksw_extend2), the
counterpart of tpubwa/device/extend_pallas.py.

Two versions of one function, bit-identical by test:

* ``extend_batch_plain``: PyTorch ops, vectorized over jobs, one loop
  step per target row.  The DP rows are [N, W] int32 tensors (one query
  cell per lane), so the F-gap running max is ``torch.cummax`` along
  the lanes (the TPU kernel's log-shift scan).
* the hand-written CUDA kernel in ``csrc/extend.cu`` (a warp per job,
  its lanes along the live band in strips of 32 columns, the row in
  shared memory), reached through ``extend_batch`` for CUDA tensors.

``extend_batch`` routes by the tensors' device: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises.  Nothing
falls back from one to the other.

Both also take the JAX kernel's timing-only arguments (K1-floor,
driven by ``tpubwa_torch/scripts/exp_kernel_floor.py``): ``ablate``, a
subset of ``ABLATE``, which makes the result wrong on purpose, and
``trees``, one of ``TREES``, the TPU's row-reduction layouts, which all
compute the same result.
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
# extend_pallas.py:_extend_kernel's `ablate` names (:224-233,
# :271-286) as the bits of csrc/extend.cu's ablation mask ("trees"
# ablates pk, hopen and trim), and its `trees` layouts (:105-159)
ABLATE_BITS = {"scan": 1, "pk": 2, "hopen": 4, "trim": 8, "trees": 14}
ABLATE = tuple(ABLATE_BITS)
TREES = ("split", "stacked", "mxu", "scanred", "mxuscan")


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


def _check(q, t, params, a=None):
    """Raise unless the call lies in the domain of both versions.  With
    ``a``, the match score, also unless the packed row max fits: no H
    exceeds h0 + a * qlen (the experiments' kernels pass none and state
    their own domains)."""
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
    if not n:
        return
    # the kernel indexes the query tile and the W + 2 columns of its row
    # by qlen: one out-of-range job would write past them
    W = q.shape[1]
    qlen = params[:, 0]
    ok = lanes = (qlen >= 0) & (qlen < W)
    if a is not None:
        # the row max is packed as (H << sh) | column, 2^sh >= W, in
        # int32: a larger H would give a wrong argmax, silently
        hmax = (1 << 31 - max(W - 1, 1).bit_length()) - 1
        # (no overflow where lanes holds)
        ok = lanes & (params[:, 2] <= hmax - a * qlen)
    if bool(ok.all()):
        return
    if not bool(lanes.all()):
        raise ValueError(f"qlen must lie in [0, {W - 1}], the query "
                         "tile's lanes")
    raise ValueError(f"h0 + a * qlen must not exceed {hmax} at W {W} "
                     "(the packed row max and its column)")


def ablate_mask(ablate=(), trees=None) -> int:
    """csrc/extend.cu's ablation mask for ``ablate`` (0: K1).  Raises
    ValueError on a name outside ``ABLATE`` or a ``trees`` outside
    ``TREES`` (the JAX kernel ignores unknown names)."""
    bad = [x for x in ablate if x not in ABLATE]
    if bad:
        raise ValueError(f"unknown ablate {bad}; names of {ABLATE}")
    if trees is not None and trees not in TREES:
        raise ValueError(f"unknown trees {trees!r}; one of {TREES}")
    mask = 0
    for x in ablate:
        mask |= ABLATE_BITS[x]
    return mask


def extend_batch_plain(q, t, params, a, b, o_del, e_del, o_ins, e_ins,
                       zdrop, stats=None, ablate=(), trees=None):
    """q int32 [N, W]; t int32 [N, tmax]; params int32 [N, >=5] with
    lanes (qlen, tlen, h0, w, end_bonus), h0 > 0.  Returns int32
    [N, 6]: (score, qle, tle, gtle, gscore, max_off).

    The row step mirrors extend_pallas.py:_extend_kernel lane for lane:
    the shifted eh arrays of upstream (eh_h[j] = H(i-1, j-1)), band
    masks as lane predicates, per-job scalars as [N, 1] columns.  A
    ``stats`` dict gets ``cells``, the band cells of the active rows.
    ``ablate`` and ``trees`` as in ``ablate_mask``: an ablated reduction
    reads lane 0 of its input, as the JAX kernel's does."""
    mask = ablate_mask(ablate, trees)
    _check(q, t, params, a)
    dev = q.device

    def red(x, op, bit):
        # one of the row step's full-row reductions, or its lane 0
        return x[:, 0:1] if mask & bit else op(x, dim=1, keepdim=True)

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
        if stats is not None:
            # band cells: what a kernel's inner loop visits on this row
            stats["cells"] = stats.get("cells", 0) + int(torch.where(
                act & ~closed, end_i - beg_i, 0).sum())
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
        if mask & ABLATE_BITS["scan"]:
            F = torch.full((N, NL), NEG, dtype=I32, device=dev)
        else:
            # F(j) = max_{u < j} (t_ins[u] - (j-1-u) e_ins): a running
            # max of t_ins[u] + u e_ins, read one lane to the right
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
        pk = red(torch.where(in_band, H * NL + lane, NEG), torch.amax,
                 ABLATE_BITS["pk"])
        h_open = red(torch.where(lane == end_i - 1, H, 0), torch.amax,
                     ABLATE_BITS["hopen"])
        nz = (eh_h != 0) | (eh_e != 0)
        first_nz = red(torch.where(in_band & nz, lane, NL + 2), torch.amin,
                       ABLATE_BITS["trim"])
        last_nz = red(torch.where((in_band | (lane == end_i)) & nz, lane,
                                  NEG), torch.amax, ABLATE_BITS["trim"])
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
    # (q, t, params, out, n, W, tmax, pstride, a, b, o_del, e_del,
    #  o_ins, e_ins, zdrop, device, stream) -> cudaError_t
    "tpubwa_extend_batch": (_CI, [_VP] * 4 + [_CI] * 12 + [_VP]),
    # the same, then ablate_mask
    "tpubwa_extend_floor": (_CI, [_VP] * 4 + [_CI] * 12 + [_VP, _CI]),
    # (W, ablate_mask, device, info int[3]) -> cudaError_t
    "tpubwa_extend_occupancy": (_CI, [_CI] * 3 + [ctypes.POINTER(_CI)]),
}


def occupancy(W, mask=0, device=0):
    """What one SM of CUDA device ``device`` holds of the kernel's
    instantiation ``mask`` at tile width ``W``, as the CUDA runtime
    counts it: {"warps_per_sm", "warps_per_block", "block_smem_bytes"}.
    Builds the kernel; raises RuntimeError where a block does not fit."""
    lib = _build.load("extend", _SIGNATURES)
    info = (_CI * 3)()
    rc = lib.tpubwa_extend_occupancy(W, mask, device, info)
    if rc != 0:
        raise RuntimeError(f"no occupancy for W {W}, mask {mask}: "
                           f"cudaError {rc}")
    return {"warps_per_sm": info[0], "warps_per_block": info[1],
            "block_smem_bytes": info[2]}


def _launch(entry, q, t, params, a, b, o_del, e_del, o_ins, e_ins, zdrop,
            *mask):
    """(out, launched): one call of the C entry ``entry`` of
    csrc/extend.cu; nothing is launched for N == 0.  The kernel keeps a
    job's row in shared memory and needs no scratch; a W whose block
    would not fit the card's shared memory is refused there, and
    raises here."""
    lib = _build.load("extend", _SIGNATURES)
    N, W = q.shape
    q = q.contiguous()
    t = t.contiguous()
    params = params.contiguous()
    out = torch.empty((N, 6), dtype=I32, device=q.device)
    if N == 0:
        return out, False
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = getattr(lib, entry)(
        q.data_ptr(), t.data_ptr(), params.data_ptr(), out.data_ptr(), N,
        W, t.shape[1], params.shape[1], a, b, o_del, e_del, o_ins, e_ins,
        zdrop, q.device.index, stream, *mask)
    if rc != 0:
        raise RuntimeError(f"extend kernel launch failed ({entry}"
                           f"{tuple(mask)}, W {W}): cudaError {rc}")
    return out, True


def _extend_cuda(q, t, params, a, b, o_del, e_del, o_ins, e_ins, zdrop):
    out, launched = _launch("tpubwa_extend_batch", q, t, params, a, b,
                            o_del, e_del, o_ins, e_ins, zdrop)
    extend_batch.launches += launched
    return out


def _extend_floor_cuda(q, t, params, a, b, o_del, e_del, o_ins, e_ins,
                       zdrop, mask):
    """K1-floor's entry with ablation mask ``mask`` (0 is K1's
    instantiation, through the floor entry)."""
    out, launched = _launch("tpubwa_extend_floor", q, t, params, a, b,
                            o_del, e_del, o_ins, e_ins, zdrop, mask)
    extend_batch.floor_launches += launched
    return out


def extend_batch(q, t, params, a, b, o_del, e_del, o_ins, e_ins, zdrop,
                 ablate=(), trees=None):
    """The extend_batch_pallas contract (extend_pallas.py:341-376):
    q int32 [N, W]; t int32 [N, tmax]; params int32 [N, >=5] lanes
    (qlen, tlen, h0, w, end_bonus), h0 > 0, qlen < W.  Returns int32
    [N, 6] (score, qle, tle, gtle, gscore, max_off).  Codes are 0-3 for
    bases and 4 (any larger value) for N; h0 + a * qlen stays below
    2^31 / W (the packed row max), or the call raises.  ``ablate`` and
    ``trees`` as in ``ablate_mask`` (timing only: never on the main
    path).

    CPU tensors run ``extend_batch_plain``; CUDA tensors launch the
    hand-written kernel: K1 with no ablation (``extend_batch.launches``
    counts its launches), else its K1-floor instantiation
    (``extend_batch.floor_launches``)."""
    mask = ablate_mask(ablate, trees)
    _check(q, t, params, a)
    if q.device.type == "cpu":
        return extend_batch_plain(q, t, params, a, b, o_del, e_del, o_ins,
                                  e_ins, zdrop, ablate=ablate, trees=trees)
    if q.device.type != "cuda":
        raise ValueError(f"no extend kernel for device {q.device}")
    if mask:
        return _extend_floor_cuda(q, t, params, a, b, o_del, e_del, o_ins,
                                  e_ins, zdrop, mask)
    return _extend_cuda(q, t, params, a, b, o_del, e_del, o_ins, e_ins,
                        zdrop)


extend_batch.launches = 0
extend_batch.floor_launches = 0
