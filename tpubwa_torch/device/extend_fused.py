"""Fused per-seed extension: left + right sides, each with the
band-doubling retry, over descriptor rows whose query and reference
tiles are gathered on the device (bwamem.c:mem_chain2aln's per-seed
body).  The counterpart of tpubwa/device/extend_fused.py.

Per seed (``_fused_passes``):

    trial0 left  -> retry? (max_off >= 3/4 w and score changed)
    trial1 left  (masked to the retrying jobs)
    sc0 = selected left score (or h0 when there is no left part)
    trial0 right (h0 = sc0) -> retry?
    trial1 right (masked)

and one int32 [16] row per job:
    0..5   selected left  (score, qle, tle, gtle, gscore, max_off)
    6..11  selected right (score, qle, tle, gtle, gscore, max_off)
    12 aw0 (final left band)   13 aw1 (final right band)
    14 sc0 (score after left)  15 final score

Every extension goes through ``extend_kernel.extend_batch`` (the CUDA
kernel on a CUDA device, the plain version on the CPU); callers that
compare the two pass ``extend=extend_batch_plain``.  Sequence-tile jobs
take any 5 x 5 scoring matrix: K1 for a bwa_fill_scmat one, K1-mat (the
same four launches) for any other, where tpubwa runs its host scalar
loops (tpubwa/device/extend_fused.py:462-466).  The descriptor route
takes only bwa_fill_scmat matrices, as tpubwa sends no other down it.
With a ``dp``
(``dist.sharding.DataParallel``), a wave's sorted jobs are split into
contiguous parts, one a replica, each run on its replica's device and
the rows put back in order (tpubwa's ``extend_seed_desc_sharded``).
"""

from __future__ import annotations

import numpy as np
import torch

from .extend_kernel import _mat_ab, extend_batch, width_for

I32 = torch.int32

# result-row columns after the two 6-int side tuples
AW0, AW1, SC0, SCORE = 12, 13, 14, 15


def _retry(res, qlen, w, prev):
    """Upstream band loop: retry iff score != prev AND
    max_off >= (w>>1)+(w>>2) (and the side exists at all)."""
    return ((qlen > 0) & (res[:, 0] != prev)
            & (res[:, 5] >= (w >> 1) + (w >> 2)))


def _fused_passes(qL, tL, qR, tR, qlenL, tlenL, qlenR, tlenR, h0, w0,
                  pen5, pen3, a, b, o_del, e_del, o_ins, e_ins, zdrop,
                  extend=extend_batch, mat=None):
    """Tiles int32 [N, W] / [N, tmax]; per-job columns int32 [N].
    Returns int32 [N, 16] (layout above): four extend launches, each
    scoring (a, b), or ``mat`` (5 x 5) where it is given."""
    def pack(qlen, tlen, hh, ww, eb):
        # the kernel assumes h0 > 0
        return torch.stack([qlen, tlen, torch.clamp_min(hh, 1), ww, eb],
                           dim=1).to(I32).contiguous()

    def run(q, t, p):
        if mat is None:
            return extend(q, t, p, a, b, o_del, e_del, o_ins, e_ins, zdrop)
        return extend(q, t, p, a, b, o_del, e_del, o_ins, e_ins, zdrop,
                      mat=mat)

    # left, trial 0 (prev = -1: a score never equals it)
    rL0 = run(qL, tL, pack(qlenL, tlenL, h0, w0, pen5))
    retL = _retry(rL0, qlenL, w0, -1)
    # left, trial 1: non-retrying jobs masked to empty (dead at once);
    # the selection below never reads their rows
    m = retL.to(I32)
    rL1 = run(qL, tL, pack(qlenL * m, tlenL * m, h0, w0 * 2, pen5))
    rL = torch.where(retL[:, None], rL1, rL0)
    aw0 = torch.where(retL, w0 * 2, w0)
    sc0 = torch.where(qlenL > 0, rL[:, 0], h0)
    # right, trial 0 (h0 = sc0, prev = sc0)
    rR0 = run(qR, tR, pack(qlenR, tlenR, sc0, w0, pen3))
    retR = _retry(rR0, qlenR, w0, sc0)
    m = retR.to(I32)
    rR1 = run(qR, tR, pack(qlenR * m, tlenR * m, sc0, w0 * 2, pen3))
    rR = torch.where(retR[:, None], rR1, rR0)
    aw1 = torch.where(retR, w0 * 2, w0)
    score = torch.where(qlenR > 0, rR[:, 0], sc0)
    return torch.cat([rL[:, :6], rR[:, :6], aw0[:, None], aw1[:, None],
                      sc0[:, None], score[:, None]], dim=1)


def _ref_codes(didx, pos):
    """Reference codes at doubled coordinates, from the resident pac
    (bns get_seq fold: pos >= l_pac reads the reverse-complement
    image).  Caller masks out-of-window lanes."""
    lp = didx.l_pac
    pos = torch.clamp(pos, 0, 2 * lp - 1)
    rev = pos >= lp
    p = torch.where(rev, 2 * lp - 1 - pos, pos)
    w = didx.pac_words[p >> 4]
    # words are int32 bit patterns: mask after the (arithmetic) shift
    c = (w >> ((15 - (p & 15)) << 1)) & 3
    return torch.where(rev, 3 - c, c).to(I32)


def _unpack16(words):
    """[N, K] int32 pac words -> [N, 16K] int32 codes in ascending
    position order (position p&15 == 0 holds the word's high bits)."""
    sh = 2 * (15 - torch.arange(16, dtype=I32, device=words.device))
    c = (words[:, :, None] >> sh) & 3
    return c.reshape(words.shape[0], -1)


def _fine16(strip, a, Wd):
    """strip [N, S] (S >= Wd + 15), a [N] in 0..15 ->
    out[n, j] = strip[n, a[n] + j]."""
    idx = a.to(torch.int64)[:, None] + torch.arange(
        Wd, dtype=torch.int64, device=strip.device)[None, :]
    return torch.gather(strip, 1, idx)


def _ref_window(didx, p0, step_desc, tlen, tmax):
    """Reference tile [N, tmax]: codes at doubled positions p0, p0+d,
    p0+2d, ... (d = -1 when step_desc else +1), masked to 4 beyond
    tlen.  The window never crosses the fwd/rev boundary
    (host/regions.py clips rmax around l_pac), so its folded image is
    one contiguous pac range: gather (tmax+30)//16 words per job,
    unpack, and shift by the sub-word offset."""
    lp = didx.l_pac
    dev = p0.device
    p0 = torch.clamp(p0, 0, 2 * lp - 1)
    rev = p0 >= lp
    q0 = torch.where(rev, 2 * lp - 1 - p0, p0)
    # folded direction: the rev fold mirrors the step
    asc = rev if step_desc else ~rev
    # 16K >= tmax + 15 covers every sub-word shift 0..15
    K = (tmax + 30) // 16
    wq = q0 >> 4
    wb = torch.where(asc, wq, wq - (K - 1))
    nw = didx.pac_words.shape[0]
    widx = torch.clamp(wb[:, None] + torch.arange(K, device=dev)[None, :],
                       0, nw - 1)
    strip = _unpack16(didx.pac_words[widx])        # [N, 16K] ascending
    strip = torch.where(asc[:, None], strip, strip.flip(1))
    aa = q0 & 15
    tile = _fine16(strip, torch.where(asc, aa, 15 - aa), tmax)
    tile = torch.where(rev[:, None], 3 - tile, tile)
    jT = torch.arange(tmax, device=dev)[None, :]
    return torch.where(jT < tlen[:, None], tile, 4).to(I32)


def _query_window(qrow, off, step_desc, qlen, W):
    """Query tile [N, W] from per-job read rows [N, L]: codes at row
    offsets off, off+d, ... (d = -1 when step_desc), masked to 4
    beyond qlen and outside the row."""
    N, L = qrow.shape
    j = torch.arange(W, device=qrow.device)[None, :]
    idx = off.to(torch.int64)[:, None] + (-j if step_desc else j)
    inside = (idx >= 0) & (idx < L)
    tile = torch.gather(qrow, 1, torch.clamp(idx, 0, L - 1)).to(I32)
    return torch.where(inside & (j < qlen[:, None]), tile, 4)


def _extend_seed_desc_impl(didx, qreads, desc, a, b, o_del, e_del,
                           o_ins, e_ins, zdrop, W, tmax,
                           extend=extend_batch):
    """desc [N, 11] (read_row, qbeg, slen, l_query, rbeg, rmax0, rmax1,
    w, h0, pen5, pen3) on the device of ``qreads`` (uint8 [B, L]).
    Returns int32 [N, 16]."""
    read = desc[:, 0].to(torch.int64)
    qbeg = desc[:, 1].to(I32)
    slen = desc[:, 2].to(I32)
    lq = desc[:, 3].to(I32)
    rbeg, rmax0, rmax1 = desc[:, 4], desc[:, 5], desc[:, 6]
    w0 = desc[:, 7].to(I32)
    h0 = desc[:, 8].to(I32)
    pen5 = desc[:, 9].to(I32)
    pen3 = desc[:, 10].to(I32)
    qe = qbeg + slen
    qlenL = qbeg
    qlenR = lq - qe
    tlenL = torch.where(qlenL > 0, (rbeg - rmax0).to(I32), 0)
    tlenR = torch.where(qlenR > 0, (rmax1 - rbeg).to(I32) - slen, 0)
    L = qreads.shape[1]
    qrow = qreads[read]                            # [N, L] row gather
    qL = _query_window(qrow, torch.clamp(qbeg - 1, 0, L - 1), True,
                       qlenL, W)
    qR = _query_window(qrow, torch.clamp(qe, 0, L - 1), False, qlenR, W)
    tL = _ref_window(didx, rbeg - 1, True, tlenL, tmax)
    tR = _ref_window(didx, rbeg + slen, False, tlenR, tmax)
    return _fused_passes(qL, tL, qR, tR, qlenL, tlenL, qlenR, tlenR, h0,
                         w0, pen5, pen3, a, b, o_del, e_del, o_ins, e_ins,
                         zdrop, extend=extend)


def extend_seed_desc_np(didx, qd, jobs, mat, o_del, e_del, o_ins, e_ins,
                        zdrop, tmax, extend=extend_batch,
                        dp=None) -> np.ndarray:
    """The ``extend_fn`` seam of host/native_emit.py:plan_batch_native.

    didx: DeviceIndex; qd: uint8 [B, L] chunk reads on the device;
    jobs: descriptor rows [n, 11] (or tuples ('D', read, qbeg, slen,
    lq, rbeg, rmax0, rmax1, w, h0, pen5, pen3)).  Returns np.int32
    [n, 16].  Jobs run sorted by total target length (stable), which
    keeps each warp's jobs alike on the GPU.  With a ``dp``, ``didx``
    and ``qd`` are lists, one a replica, and the sorted jobs are split
    over the replicas (the tile widths W and tmax are the wave's)."""
    ab = _mat_ab(mat)
    if ab is None:
        raise ValueError("descriptor extension needs a "
                         "bwa_fill_scmat-structured scoring matrix")
    n = len(jobs)
    idt = (didx if dp is None else didx[0]).np_idt
    if isinstance(jobs, np.ndarray):
        da = np.ascontiguousarray(jobs, idt).reshape(-1, 11)
    else:
        da = np.zeros((n, 11), idt)
        for i, j in enumerate(jobs):
            da[i] = j[1:]
    if n == 0:
        return np.zeros((0, 16), np.int32)
    tlL = np.where(da[:, 1] > 0, da[:, 4] - da[:, 5], 0)
    tlR = np.where(da[:, 3] - da[:, 1] - da[:, 2] > 0,
                   da[:, 6] - da[:, 4] - da[:, 2], 0)
    order = np.argsort(-(tlL.astype(np.int64) + tlR), kind="stable")
    qmax = int(max(da[:, 1].max(), (da[:, 3] - da[:, 1] - da[:, 2]).max()))
    W = width_for(qmax)
    if qmax >= W:
        raise ValueError(f"a {qmax} bp extension side exceeds the kernel's "
                         f"{W - 1} bp lanes (oversize reads take the scalar "
                         "path)")
    tm = 128
    while tm < max(int(tlL.max()), int(tlR.max())):
        tm <<= 1
    tm = min(tm, tmax)
    rows = np.ascontiguousarray(da[order])

    def run(i, lo, hi):
        di, qi = (didx, qd) if dp is None else (didx[i], qd[i])
        desc = torch.from_numpy(rows[lo:hi]).to(qi.device)
        return _extend_seed_desc_impl(di, qi, desc, ab[0], ab[1], o_del,
                                      e_del, o_ins, e_ins, zdrop, W, tm,
                                      extend=extend).cpu().numpy()

    out = np.zeros((n, 16), np.int32)
    out[order] = run(0, 0, n) if dp is None else dp.map_rows(run, n, "jobs")
    return out


def extend_seed_batch_np(jobs, mat, o_del, e_del, o_ins, e_ins, zdrop,
                         tmax, device, extend=extend_batch,
                         dp=None) -> np.ndarray:
    """Sequence-tile jobs (qlenL, qL, tlenL, tL, qlenR, qR, tlenR, tR,
    w, h0, pen5, pen3) -> np.int32 [n, 16] (layout above).

    The jobs run sorted by total target length (stable); their four
    tiles and meta columns are packed on the host, uploaded once to
    ``device`` and run through ``_fused_passes`` (four extend launches:
    K1 for a bwa_fill_scmat ``mat``, K1-mat for any other), and the rows
    come back in job order.  A longest side past the kernel's lanes
    raises (the caller routes such jobs to the scalar loops).  With a
    ``dp`` the sorted jobs are split over its replicas, each part's
    tiles uploaded to its replica's device (``device`` is not read)."""
    ab = _mat_ab(mat)
    a, b, table = (None, None, mat) if ab is None else (*ab, None)
    n = len(jobs)
    if n == 0:
        return np.zeros((0, 16), np.int32)
    meta = np.array([(j[0], j[2], j[4], j[6], j[9], j[8], j[10], j[11])
                     for j in jobs], np.int32).reshape(n, 8)
    order = np.argsort(-(meta[:, 1].astype(np.int64) + meta[:, 3]),
                       kind="stable")
    qmax = int(max(meta[:, 0].max(), meta[:, 2].max()))
    W = width_for(qmax)
    if qmax >= W:
        raise ValueError(f"a {qmax} bp extension side exceeds the kernel's "
                         f"{W - 1} bp lanes")
    tm = 128
    while tm < max(int(meta[:, 1].max()), int(meta[:, 3].max())):
        tm <<= 1
    tm = min(tm, tmax)
    # one int8 buffer [n, W | tm | W | tm]: qL, tL, qR, tR, padded with 4
    tiles = np.full((n, 2 * (W + tm)), 4, np.int8)
    offs = (0, W, W + tm, 2 * W + tm)
    for slot, i in enumerate(order):
        j = jobs[i]
        for col, (length, seq) in zip(offs, ((j[0], j[1]), (j[2], j[3]),
                                             (j[4], j[5]), (j[6], j[7]))):
            tiles[slot, col:col + length] = seq[:length]
    meta = np.ascontiguousarray(meta[order])

    def run(i, lo, hi):
        dev = device if dp is None else dp.devices[i]
        td = torch.from_numpy(tiles[lo:hi]).to(dev).to(I32)
        md = torch.from_numpy(meta[lo:hi]).to(dev)
        qL, tL, qR, tR = (td[:, c:c + w].contiguous() for c, w in
                          zip(offs, (W, tm, W, tm)))
        return _fused_passes(qL, tL, qR, tR, *md.unbind(1), a, b, o_del,
                             e_del, o_ins, e_ins, zdrop, extend=extend,
                             mat=table).cpu().numpy()

    out = np.zeros((n, 16), np.int32)
    out[order] = run(0, 0, n) if dp is None else dp.map_rows(run, n, "jobs")
    return out


def scalar_fused(job, mat, o_del, e_del, o_ins, e_ins, zdrop,
                 max_band_try=2):
    """Scalar oracle: the upstream trial loops with ref.ksw.ksw_extend.
    job = (qlenL, qL, tlenL, tL, qlenR, qR, tlenR, tR, w, h0, pen5,
    pen3).  Returns np.int64 [16]."""
    from ..ref.ksw import ksw_extend
    (qlenL, qL, tlenL, tL, qlenR, qR, tlenR, tR, w0, h0,
     pen5, pen3) = job
    out = np.zeros(16, np.int64)
    score = -1
    aw0 = aw1 = w0
    if qlenL > 0:
        for trial in range(max_band_try):
            prev = score
            aw0 = w0 << trial
            r = ksw_extend(qlenL, qL, tlenL, tL, mat, o_del, e_del,
                           o_ins, e_ins, aw0, pen5, zdrop, h0)
            score = r.score
            out[:6] = (r.score, r.qle, r.tle, r.gtle, r.gscore, r.max_off)
            if score == prev or r.max_off < (aw0 >> 1) + (aw0 >> 2):
                break
    sc0 = score if qlenL > 0 else h0
    score = sc0
    if qlenR > 0:
        for trial in range(max_band_try):
            prev = score
            aw1 = w0 << trial
            r = ksw_extend(qlenR, qR, tlenR, tR, mat, o_del, e_del,
                           o_ins, e_ins, aw1, pen3, zdrop, sc0)
            score = r.score
            out[6:12] = (r.score, r.qle, r.tle, r.gtle, r.gscore,
                         r.max_off)
            if score == prev or r.max_off < (aw1 >> 1) + (aw1 >> 2):
                break
    out[AW0], out[AW1], out[SC0], out[SCORE] = aw0, aw1, sc0, score
    return out
