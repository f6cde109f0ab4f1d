"""SMEM seeding — scalar reference (bwt.c:bwt_smem1a/~400, bwt_extend/~240,
bwt_seed_strategy1/~490; bwamem.c:mem_collect_intv/~200; SURVEY.md §2 row 5).

Bidirectional FM-index search over the forward+revcomp BWT.  An interval
is (x0, x1, size): x0 = SA-interval start for the pattern, x1 = interval
start for its reverse complement, size = #occurrences; (qb, qe) is the
query span.  mem_collect_intv runs the exact 3-round protocol:

  round 1: all SMEMs, keep len >= min_seed_len
  round 2: re-seed long low-occ SMEMs (len >= min_seed_len*split_factor,
           occ <= split_width) from their midpoint with min_intv=occ+1
  round 3: if max_mem_intv > 0, forward-only seeds of len >= min_seed_len
           whose interval first drops below max_mem_intv (LAST-like)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..index.fmindex import FMIndex
from ..opts import MemOpt


@dataclass
class BwtIntv:
    x0: int   # SA interval start (pattern)
    x1: int   # SA interval start (reverse-complement pattern)
    size: int  # interval size = #occurrences
    qb: int = 0   # query begin (info>>32)
    qe: int = 0   # query end   ((uint32)info)

    def x(self, idx: int) -> int:
        return (self.x0, self.x1, self.size)[idx]


def set_intv(fmi: FMIndex, c: int) -> BwtIntv:
    """bwt.h:bwt_set_intv — single-base initial interval."""
    return BwtIntv(x0=int(fmi.L2[c]) + 1,
                   x1=int(fmi.L2[3 - c]) + 1,
                   size=int(fmi.L2[c + 1] - fmi.L2[c]))


def bwt_extend(fmi: FMIndex, ik: BwtIntv, is_back: bool) -> List[BwtIntv]:
    """Extend interval by one base in either direction; returns ok[4]
    indexed by the base in the EXTENSION direction (bwt.c:~240)."""
    if is_back:
        piv, oth = ik.x0, ik.x1
    else:
        piv, oth = ik.x1, ik.x0
    tk = [fmi.occ(piv - 1, c) for c in range(4)]
    tl = [fmi.occ(piv - 1 + ik.size, c) for c in range(4)]
    ok = [BwtIntv(0, 0, 0) for _ in range(4)]
    for c in range(4):
        new_piv = int(fmi.L2[c]) + 1 + tk[c]
        sz = tl[c] - tk[c]
        if is_back:
            ok[c].x0 = new_piv
        else:
            ok[c].x1 = new_piv
        ok[c].size = sz
    # the non-pivot side advances cumulatively in 3..0 base order; the
    # sentinel row inside the pivot interval shifts it by one
    sent = 1 if (piv <= fmi.primary and piv + ik.size - 1 >= fmi.primary) else 0
    acc = oth + sent
    for c in (3, 2, 1, 0):
        if is_back:
            ok[c].x1 = acc
        else:
            ok[c].x0 = acc
        acc += ok[c].size
    return ok


def smem1a(fmi: FMIndex, q: np.ndarray, x: int, min_intv: int,
           max_intv: int, mem_out: List[BwtIntv]) -> int:
    """bwt.c:bwt_smem1a — SMEMs covering query position x.
    Appends to mem_out (cleared first); returns the next x."""
    length = len(q)
    mem_out.clear()
    if q[x] > 3:
        return x + 1
    if min_intv < 1:
        min_intv = 1
    ik = set_intv(fmi, int(q[x]))
    ik.qe = x + 1

    if max_intv and ik.size <= max_intv:
        mem_out.append(ik)
        return x + 1  # (upstream returns ret computed below; here i==x+1)

    curr: List[BwtIntv] = []
    i = x + 1
    while i < length:
        if ik.size < max_intv:
            curr.append(ik)
            break
        elif q[i] < 4:
            c = 3 - int(q[i])  # complement: forward ext via revcomp side
            ok = bwt_extend(fmi, ik, is_back=False)
            if ok[c].size != ik.size:
                curr.append(ik)
                if ok[c].size < min_intv:
                    break
            ik = ok[c]
            ik.qe = i + 1
        else:
            curr.append(ik)
            break
        i += 1
    if i == length:
        curr.append(ik)
    curr.reverse()  # longest matches (smallest intervals) first
    ret = curr[0].qe

    prev = curr
    i = x - 1
    while i >= -1:
        c = -1 if i < 0 or q[i] > 3 else int(q[i])
        curr = []
        for p in prev:
            ok: Optional[List[BwtIntv]] = None
            if c >= 0 and ik.size >= max_intv:
                ok = bwt_extend(fmi, p, is_back=True)
            if c < 0 or ik.size < max_intv or ok[c].size < min_intv:
                if len(curr) == 0:  # shorter matches are contained
                    if len(mem_out) == 0 or i + 1 < mem_out[-1].qb:
                        m = BwtIntv(p.x0, p.x1, p.size, qb=i + 1, qe=p.qe)
                        mem_out.append(m)
            elif len(curr) == 0 or ok[c].size != curr[-1].size:
                nk = BwtIntv(ok[c].x0, ok[c].x1, ok[c].size,
                             qb=p.qb, qe=p.qe)
                curr.append(nk)
        if len(curr) == 0:
            break
        prev = curr
        i -= 1
    mem_out.reverse()  # sorted by query start
    return ret


def seed_strategy1(fmi: FMIndex, q: np.ndarray, x: int, min_len: int,
                   max_intv: int) -> Tuple[int, Optional[BwtIntv]]:
    """bwt.c:bwt_seed_strategy1 — forward-only 3rd-round seeding."""
    length = len(q)
    if q[x] > 3:
        return x + 1, None
    ik = set_intv(fmi, int(q[x]))
    for i in range(x + 1, length):
        if q[i] < 4:
            c = 3 - int(q[i])
            ok = bwt_extend(fmi, ik, is_back=False)
            if ok[c].size < max_intv and i - x >= min_len:
                m = BwtIntv(ok[c].x0, ok[c].x1, ok[c].size, qb=x, qe=i + 1)
                return i + 1, m
            ik = ok[c]
        else:
            return i + 1, None
    return length, None


def collect_intv(opt: MemOpt, fmi: FMIndex, q: np.ndarray) -> List[BwtIntv]:
    """bwamem.c:mem_collect_intv — the 3-round seeding protocol."""
    length = len(q)
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    mems: List[BwtIntv] = []
    tmp: List[BwtIntv] = []
    # round 1: all SMEMs of length >= min_seed_len
    x = 0
    while x < length:
        if q[x] < 4:
            x = smem1a(fmi, q, x, 1, 0, tmp)
            for p in tmp:
                if p.qe - p.qb >= opt.min_seed_len:
                    mems.append(BwtIntv(p.x0, p.x1, p.size, p.qb, p.qe))
        else:
            x += 1
    # round 2: re-seed inside long low-occurrence SMEMs
    old_n = len(mems)
    for k in range(old_n):
        p = mems[k]
        if p.qe - p.qb < split_len or p.size > opt.split_width:
            continue
        smem1a(fmi, q, (p.qb + p.qe) >> 1, p.size + 1, 0, tmp)
        for s in tmp:
            if s.qe - s.qb >= opt.min_seed_len:
                mems.append(BwtIntv(s.x0, s.x1, s.size, s.qb, s.qe))
    # round 3: LAST-like forward-only seeding
    if opt.max_mem_intv > 0:
        x = 0
        while x < length:
            if q[x] < 4:
                x, m = seed_strategy1(fmi, q, x, opt.min_seed_len,
                                      opt.max_mem_intv)
                if m is not None and m.size > 0:
                    mems.append(m)
            else:
                x += 1
    # sort by info = qb<<32 | qe (ks_introsort(mem_intv))
    mems.sort(key=lambda p: (p.qb, p.qe))
    return mems


def sa_positions(fmi: FMIndex, intv: BwtIntv, max_occ: int
                 ) -> List[Tuple[int, int]]:
    """SA lookups for an interval with bwa's occurrence subsampling
    (bwamem.c:mem_chain head, ~330): returns [(rbeg, rank_used)...]."""
    step = intv.size // max_occ if intv.size > max_occ else 1
    out = []
    k = 0
    count = 0
    while k < intv.size and count < max_occ:
        rank = intv.x0 + k
        out.append((fmi.sa(rank), rank))
        k += step
        count += 1
    return out
