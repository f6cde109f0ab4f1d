"""Suffix-array construction (index build time, offline).

The BWT text is forward + reverse-complement reference (length n=2*l_pac)
with an implicit sentinel smaller than every base, exactly as upstream
bwa builds it (bwtindex.c:bwt_pac2bwt via is.c SAIS / rope BCR).

Construction here is a fully-vectorized NumPy prefix-doubling
(Manber-Myers) — O(n log n) lexsorts — adequate for bacterial-scale
references and all tests.  A C SA-IS extension (../native) replaces
it for human-scale genomes; both produce the identical (unique) suffix
array, so the choice never affects output records.
"""

from __future__ import annotations

import numpy as np


def suffix_array(codes: np.ndarray) -> np.ndarray:
    """Suffix array of codes (values 0..3) + implicit terminal sentinel.

    Returns int64[n+1]; sa[0] == n (the sentinel-only suffix).
    """
    try:
        from ..native import sais_int  # C fast path, if built
        return sais_int(codes)
    except Exception:
        pass
    return _suffix_array_doubling(codes)


def _suffix_array_doubling(codes: np.ndarray) -> np.ndarray:
    n = len(codes) + 1
    # sentinel = 0, bases 1..4
    rank = np.zeros(n, dtype=np.int64)
    rank[:-1] = codes.astype(np.int64) + 1
    k = 1
    order = np.argsort(rank, kind="stable")
    r1 = rank[order]
    changed = np.r_[False, r1[1:] != r1[:-1]]
    new = np.cumsum(changed)
    rank[order] = new
    while int(new[-1]) != n - 1:
        key2 = np.zeros(n, dtype=np.int64)
        key2[: n - k] = rank[k:] + 1  # +1 so "past end" (0) sorts first
        order = np.lexsort((key2, rank))
        r1 = rank[order]
        r2 = key2[order]
        changed = np.r_[False, (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])]
        new = np.cumsum(changed)
        rank[order] = new
        k <<= 1
    return order


def bwt_from_sa(codes: np.ndarray, sa: np.ndarray):
    """(stored_bwt, primary): BWT of codes+$ with the $ removed.

    primary = the conceptual row whose BWT char is $ (i.e. SA rank of
    the full string).  Matches bwa's bwt_t.primary semantics.
    """
    n = len(codes)
    # slab-wise: whole-array temporaries here are 8n bytes (50 GB at
    # human scale) and double the peak right after SA construction
    assert sa[0] == n  # sentinel row first
    stored = np.empty(n, np.uint8)
    primary = -1
    out = 0
    CH = 1 << 27
    for s0 in range(0, len(sa), CH):
        blk = sa[s0:s0 + CH]
        if primary < 0:
            z = np.flatnonzero(blk == 0)
            if len(z):
                primary = s0 + int(z[0])
        vals = codes[blk[blk != 0] - 1]
        stored[out:out + len(vals)] = vals
        out += len(vals)
    return stored, primary
