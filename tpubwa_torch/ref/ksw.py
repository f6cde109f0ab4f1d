"""Banded affine-gap Smith-Waterman kernels — scalar reference.

Semantics mirror upstream bwa's ksw.c exactly (SURVEY.md §2 rows 10-12):

* ``ksw_extend``  — seed extension (ksw.c:ksw_extend2:~280-380): banded
  DP seeded by h0, asymmetric ins/del gaps, adaptive band trimming,
  Z-drop early exit, and the exact tie-breaking of the scalar loop
  (row max -> LAST argmax in a row; global best -> FIRST row achieving
  a strictly greater score; gscore -> LAST row on ties).
* ``ksw_global``  — banded global alignment + CIGAR traceback
  (ksw.c:ksw_global2:~420-500).
* ``ksw_align``   — local SW with start coordinates and suboptimal
  score (ksw.c:ksw_align2 / ksw_u8/ksw_i16) used for mate rescue.

Rows are vectorized with NumPy (the F-scan is a prefix max), so the
oracle is fast enough to run whole test genomes; decisions are
bit-faithful to the scalar loop.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

MINUS_INF = -0x40000000

_NATIVE = None


def _native():
    """Native ksw.cpp kernels (semantics pinned to the NumPy code in
    this module by tests/test_ksw_native.py); TPUBWA_NO_NATIVE=1 forces
    the NumPy path."""
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE or None
    if os.environ.get("TPUBWA_NO_NATIVE"):
        _NATIVE = False
        return None
    try:
        from ..native import load_ksw
        _NATIVE = load_ksw()
    except Exception:  # pragma: no cover - toolchain missing
        _NATIVE = False
    return _NATIVE or None


def _u8(x, n):
    a = np.ascontiguousarray(np.asarray(x)[:n], dtype=np.uint8)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _mat32(mat):
    a = np.ascontiguousarray(np.asarray(mat), dtype=np.int32)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


@dataclass
class KswExt:
    score: int
    qle: int       # query length of the local best extension
    tle: int       # target length of the local best extension
    gtle: int      # target length of the best to-query-end extension
    gscore: int    # best score reaching the end of the query
    max_off: int   # max band excursion (for band-doubling retries)


def ksw_extend(qlen: int, query: np.ndarray, tlen: int, target: np.ndarray,
               mat: np.ndarray, o_del: int, e_del: int, o_ins: int,
               e_ins: int, w: int, end_bonus: int, zdrop: int,
               h0: int) -> KswExt:
    assert h0 > 0
    lib = _native()
    if lib is not None:
        qa, qp_ = _u8(query, qlen)
        ta, tp_ = _u8(target, tlen)
        ma, mp_ = _mat32(mat)
        out = np.zeros(6, np.int32)
        lib.tpubwa_ksw_extend(
            qlen, qp_, tlen, tp_, ma.shape[0], mp_, o_del, e_del,
            o_ins, e_ins, w, end_bonus, zdrop, h0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return KswExt(score=int(out[0]), qle=int(out[1]),
                      tle=int(out[2]), gtle=int(out[3]),
                      gscore=int(out[4]), max_off=int(out[5]))
    query = np.asarray(query, dtype=np.int64)[:qlen]
    target = np.asarray(target, dtype=np.int64)[:tlen]
    mat = np.asarray(mat, dtype=np.int64)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins

    # query profile: qp[c, j] = mat[c, query[j]]
    qp = mat[:, query]  # (m, qlen)

    # eh arrays, shifted exactly like upstream: eh_h[j] = H(i-1, j-1),
    # eh_e[j] = E(i, j); length qlen+1
    eh_h = np.zeros(qlen + 1, dtype=np.int64)
    eh_e = np.zeros(qlen + 1, dtype=np.int64)
    eh_h[0] = h0
    if qlen >= 1:
        eh_h[1] = h0 - oe_ins if h0 > oe_ins else 0
        j = 2
        while j <= qlen and eh_h[j - 1] > e_ins:
            eh_h[j] = eh_h[j - 1] - e_ins
            j += 1

    # cap the band by the max insertions/deletions that can keep score>0
    mmax = max(0, int(mat.max()))
    max_ins = int((qlen * mmax + end_bonus - o_ins) / e_ins + 1.0)
    max_ins = max(max_ins, 1)
    w = min(w, max_ins)
    max_del = int((qlen * mmax + end_bonus - o_del) / e_del + 1.0)
    max_del = max(max_del, 1)
    w = min(w, max_del)

    best = h0
    max_i = max_j = -1
    max_ie = -1
    gscore = -1
    max_off = 0
    beg, end = 0, qlen

    for i in range(tlen):
        beg = max(beg, i - w)
        end = min(end, i + w + 1, qlen)
        # first column H(i, beg-1)
        if beg == 0:
            h1 = h0 - (o_del + e_del * (i + 1))
            if h1 < 0:
                h1 = 0
        else:
            h1 = 0
        if beg >= end:
            # band closed: the inner loop body never runs; upstream still
            # writes eh[end] and takes the gscore/m==0 path, then breaks
            eh_h[end] = h1
            eh_e[end] = 0
            if end == qlen and h1 >= gscore:
                max_ie, gscore = i, h1
            break
        q = qp[target[i]]
        js = np.arange(beg, end)
        Hdiag = eh_h[beg:end]                       # H(i-1, j-1)
        M = np.where(Hdiag != 0, Hdiag + q[beg:end], 0)
        E = eh_e[beg:end]
        he = np.maximum(M, E)
        # F scan: F(i,beg)=0; F(i,j) = max(F(i,j-1)-e_ins, t[j-1]),
        # t[j] = max(M[j]-oe_ins, 0) BUT computed from the pre-F h...
        # upstream computes t from M only, so the scan closes in M.
        t_ins = np.maximum(M - oe_ins, 0)
        n = end - beg
        F = np.empty(n, dtype=np.int64)
        F[0] = 0
        if n > 1:
            # F[k] = max_{u<=k-1} (t_ins[u] - (k-1-u)*e_ins)
            #      = prefmax(t_ins[u] + u*e_ins)[k-1] - (k-1)*e_ins
            steps = np.arange(n - 1, dtype=np.int64)
            F[1:] = np.maximum.accumulate(t_ins[:-1] + steps * e_ins) \
                - steps * e_ins
        H = np.maximum(he, F)
        # row max m and LAST argmax mj (upstream: mj updates when h >= m)
        m = int(H.max()) if n else 0
        mj = int(end - 1 - np.argmax(H[::-1] == m)) if n else -1
        # E for next row
        t_del = np.maximum(M - oe_del, 0)
        Enew = np.maximum(E - e_del, t_del)
        # write back shifted: eh_h[j] (j in (beg, end]) = H(i, j-1)
        eh_h[beg] = h1
        eh_h[beg + 1:end + 1] = H
        eh_e[beg:end] = Enew
        eh_e[end] = 0
        h_last = int(H[-1])  # H(i, end-1) == h1 at loop exit upstream
        if end == qlen:
            if h_last >= gscore:
                max_ie = i
                gscore = h_last
        if m == 0:
            break
        if m > best:
            best, max_i, max_j = m, i, mj
            max_off = max(max_off, abs(mj - i))
        elif zdrop > 0:
            if i - max_i > mj - max_j:
                if best - m - ((i - max_i) - (mj - max_j)) * e_del > zdrop:
                    break
            else:
                if best - m - ((mj - max_j) - (i - max_i)) * e_ins > zdrop:
                    break
        # adaptive band trimming on the shifted arrays
        nz = np.flatnonzero((eh_h[beg:end] != 0) | (eh_e[beg:end] != 0))
        if len(nz) == 0:
            beg = end
        else:
            beg = beg + int(nz[0])
        j = end
        while j >= beg and eh_h[j] == 0 and eh_e[j] == 0:
            j -= 1
        end = min(j + 2, qlen)

    return KswExt(score=best, qle=max_j + 1, tle=max_i + 1,
                  gtle=max_ie + 1, gscore=gscore, max_off=max_off)


# ---------------------------------------------------------------------------

def _push_cigar(cig: List[Tuple[int, int]], op: int, length: int) -> None:
    if cig and cig[-1][0] == op:
        cig[-1] = (op, cig[-1][1] + length)
    else:
        cig.append((op, length))


CIGAR_OPS = "MIDSH"


def cigar_to_str(cigar: List[Tuple[int, int]]) -> str:
    return "".join(f"{l}{CIGAR_OPS[op]}" for op, l in cigar)


def ksw_global(qlen: int, query: np.ndarray, tlen: int, target: np.ndarray,
               mat: np.ndarray, o_del: int, e_del: int, o_ins: int,
               e_ins: int, w: int, want_cigar: bool = True
               ) -> Tuple[int, List[Tuple[int, int]]]:
    """Banded global alignment; returns (score, cigar [(op,len)...]),
    op 0=M 1=I(query) 2=D(target).  ksw.c:ksw_global2 semantics."""
    lib = _native()
    if lib is not None:
        qa, qp_ = _u8(query, qlen)
        ta, tp_ = _u8(target, tlen)
        ma, mp_ = _mat32(mat)
        score = np.zeros(1, np.int32)
        ncig = np.zeros(1, np.int32)
        cap = qlen + tlen + 2
        cig = np.zeros(cap * 2, np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        rc = lib.tpubwa_ksw_global(
            qlen, qp_, tlen, tp_, ma.shape[0], mp_, o_del, e_del,
            o_ins, e_ins, w, 1 if want_cigar else 0,
            score.ctypes.data_as(i32p), cig.ctypes.data_as(i32p),
            cap, ncig.ctypes.data_as(i32p))
        if rc == 0:
            n = int(ncig[0])
            return int(score[0]), [(int(cig[2 * i]), int(cig[2 * i + 1]))
                                   for i in range(n)]
    query = np.asarray(query, dtype=np.int64)[:qlen]
    target = np.asarray(target, dtype=np.int64)[:tlen]
    mat = np.asarray(mat, dtype=np.int64)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    if qlen == 0 or tlen == 0:
        cig: List[Tuple[int, int]] = []
        score = 0
        if tlen:
            _push_cigar(cig, 2, tlen)
            score = -(o_del + e_del * tlen)
        if qlen:
            _push_cigar(cig, 1, qlen)
            score = -(o_ins + e_ins * qlen)
        return score, cig

    n_col = min(qlen, 2 * w + 1)
    z = np.zeros((tlen, n_col), dtype=np.uint8) if want_cigar else None
    qp = mat[:, query]

    eh_h = np.full(qlen + 1, MINUS_INF, dtype=np.int64)
    eh_e = np.full(qlen + 1, MINUS_INF, dtype=np.int64)
    eh_h[0] = 0
    for j in range(1, min(qlen, w) + 1):
        eh_h[j] = -(o_ins + e_ins * j)

    for i in range(tlen):
        f = MINUS_INF
        beg = max(i - w, 0)
        end = min(i + w + 1, qlen)
        h1 = -(o_del + e_del * (i + 1)) if beg == 0 else MINUS_INF
        q = qp[target[i]]
        # sequential inner loop (kept scalar: F depends on H here because
        # global tracks directions; tlen*band is tiny — ~1-2 calls/read)
        for j in range(beg, end):
            m = eh_h[j]
            e = eh_e[j]
            eh_h[j] = h1
            m += q[j]
            d = 0 if m >= e else 1
            h = m if m >= e else e
            d = d if h >= f else 2
            h = h if h >= f else f
            h1 = h
            t = m - oe_del
            e -= e_del
            if e > t:
                d |= 1 << 2
            else:
                e = t
            eh_e[j] = e
            t = m - oe_ins
            f -= e_ins
            if f > t:
                d |= 2 << 4
            else:
                f = t
            if want_cigar:
                z[i, j - beg] = d
        eh_h[end] = h1
        eh_e[end] = MINUS_INF
    score = int(eh_h[qlen])

    cig = []
    if want_cigar:
        which = 0
        i = tlen - 1
        k = min(i + w + 1, qlen) - 1
        while i >= 0 and k >= 0:
            d = int(z[i, k - max(i - w, 0)])
            which = (d >> (which << 1)) & 3
            if which == 0:
                _push_cigar(cig, 0, 1)
                i -= 1
                k -= 1
            elif which == 1:
                _push_cigar(cig, 2, 1)
                i -= 1
            else:
                _push_cigar(cig, 1, 1)
                k -= 1
        if i >= 0:
            _push_cigar(cig, 2, i + 1)
        if k >= 0:
            _push_cigar(cig, 1, k + 1)
        cig.reverse()
    return score, cig


# ---------------------------------------------------------------------------

@dataclass
class KswAln:
    score: int
    te: int       # target end (inclusive)
    qe: int       # query end (inclusive)
    score2: int   # suboptimal score (target end > qlen away), -1 if none
    te2: int
    tb: int       # target begin (set by start search), -1 if not computed
    qb: int


def _local_forward(qlen, query, tlen, target, mat, o_del, e_del, o_ins,
                   e_ins, minsc):
    """Local SW forward pass. Returns (score, te, qe, col_max[tlen])."""
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    qp = mat[:, query]
    H = np.zeros(qlen, dtype=np.int64)   # H(i-1, :)
    E = np.zeros(qlen, dtype=np.int64)   # E(i, :)
    best, te, qe = 0, -1, -1
    col_max = np.zeros(tlen, dtype=np.int64)
    for i in range(tlen):
        q = qp[target[i]]
        Hdiag = np.concatenate([[0], H[:-1]])
        M = Hdiag + q
        he = np.maximum(np.maximum(M, E), 0)
        # F(i,j) = max(F(i,j-1), H(i,j-1) - o_ins) - e_ins with H = max(he,F);
        # a cascaded F term (from F via H) never exceeds the he-sourced term
        # because oe_ins >= e_ins, so the scan closes over he exactly:
        # F(i,j) = max_{k<j} (he[k] - oe_ins - (j-1-k)*e_ins)
        if qlen > 1:
            steps = np.arange(qlen - 1, dtype=np.int64)
            pref = np.maximum.accumulate(he[:-1] + steps * e_ins)
            F = np.empty(qlen, dtype=np.int64)
            F[0] = 0
            F[1:] = pref - steps * e_ins - oe_ins
        else:
            F = np.zeros(qlen, dtype=np.int64)
        Hrow = np.maximum(he, F)
        E = np.maximum(E - e_del, Hrow - oe_del)
        E = np.maximum(E, 0)
        H = Hrow
        cm = int(Hrow.max()) if qlen else 0
        col_max[i] = cm
        if cm > best:
            best = cm
            te = i
            qe = int(np.argmax(Hrow))  # first j attaining the column max
    return best, te, qe, col_max


def ksw_align(qlen: int, query: np.ndarray, tlen: int, target: np.ndarray,
              mat: np.ndarray, o_del: int, e_del: int, o_ins: int,
              e_ins: int, minsc: int = 0, want_start: bool = True) -> KswAln:
    """Local SW used for mate rescue (ksw.c:ksw_align2 semantics:
    KSW_XSTART start-coordinate search via reversed-sequence rerun,
    KSW_XSUBO suboptimal score outside +-qlen of te)."""
    lib = _native()
    if lib is not None:
        qa, qp_ = _u8(query, qlen)
        ta, tp_ = _u8(target, tlen)
        ma, mp_ = _mat32(mat)
        out = np.zeros(7, np.int32)
        lib.tpubwa_ksw_align(
            qlen, qp_, tlen, tp_, ma.shape[0], mp_, o_del, e_del,
            o_ins, e_ins, minsc, 1 if want_start else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return KswAln(score=int(out[0]), te=int(out[1]), qe=int(out[2]),
                      score2=int(out[3]), te2=int(out[4]),
                      tb=int(out[5]), qb=int(out[6]))
    query = np.asarray(query, dtype=np.int64)[:qlen]
    target = np.asarray(target, dtype=np.int64)[:tlen]
    mat = np.asarray(mat, dtype=np.int64)
    score, te, qe, col_max = _local_forward(
        qlen, query, tlen, target, mat, o_del, e_del, o_ins, e_ins, minsc)
    score2, te2 = -1, -1
    if te >= 0:
        lo, hi = te - qlen, te + qlen
        for e in range(tlen):
            if (e < lo or e > hi) and col_max[e] >= max(minsc, 1) \
                    and col_max[e] > score2:
                score2, te2 = int(col_max[e]), e
    r = KswAln(score=score, te=te, qe=qe, score2=score2, te2=te2,
               tb=-1, qb=-1)
    if not want_start or score <= 0 or (minsc and score < minsc):
        return r
    # start search: align reversed prefixes, ends map to starts
    rq = query[:qe + 1][::-1].copy()
    rt = target[:te + 1][::-1].copy()
    s2, rte, rqe, _ = _local_forward(
        qe + 1, rq, te + 1, rt, mat, o_del, e_del, o_ins, e_ins, minsc)
    r.tb = te - rte
    r.qb = qe - rqe
    return r
