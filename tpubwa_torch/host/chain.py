"""Seed chaining and chain filtering (bwamem.c:mem_chain/~330,
test_and_merge/~280, mem_chain_weight/~440, mem_chain_flt/~470,
mem_flt_chained_seeds/~640; SURVEY.md §2 rows 7-8).

The B-tree of upstream is replaced by a bisect-sorted list keyed by the
chain anchor position (first seed rbeg) — same lower-bound merge rule,
same traversal order.
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..index.build import BntSeq
from ..index.fmindex import FMIndex
from ..opts import MemOpt
from ..ref.ksw import ksw_align
from ..ref.smem import BwtIntv, collect_intv

MEM_SHORT_EXT = 50
MEM_SHORT_LEN = 200
MEM_SEEDSW_COEF = 0.05
MEM_MINSC_COEF = 5.5
MEM_HSP_COEF = 1.1


@dataclass
class Seed:
    rbeg: int
    qbeg: int
    len: int
    score: int


@dataclass
class Chain:
    rid: int
    pos: int                      # anchor: rbeg of the first seed (B-tree key)
    seeds: List[Seed]
    is_alt: int = 0
    w: int = 0                    # chain weight
    kept: int = 0
    first: int = -1
    frac_rep: float = 0.0

    @property
    def qbeg(self) -> int:
        return self.seeds[0].qbeg

    @property
    def qend(self) -> int:
        s = self.seeds[-1]
        return s.qbeg + s.len


def _test_and_merge(opt: MemOpt, l_pac: int, c: Chain, p: Seed,
                    seed_rid: int) -> bool:
    """Try merging seed p into chain c; True = consumed (merged or
    contained), False = request a new chain."""
    last = c.seeds[-1]
    first = c.seeds[0]
    qend = last.qbeg + last.len
    rend = last.rbeg + last.len
    if seed_rid != c.rid:
        return False
    if (p.qbeg >= first.qbeg and p.qbeg + p.len <= qend
            and p.rbeg >= first.rbeg and p.rbeg + p.len <= rend):
        return True  # contained seed; do nothing
    if (last.rbeg < l_pac or first.rbeg < l_pac) and p.rbeg >= l_pac:
        return False  # different strands
    x = p.qbeg - last.qbeg  # always non-negative (seeds sorted)
    y = p.rbeg - last.rbeg
    if (y >= 0 and x - y <= opt.w and y - x <= opt.w
            and x - last.len < opt.max_chain_gap
            and y - last.len < opt.max_chain_gap):
        c.seeds.append(p)
        return True
    return False


SeedingFn = Callable[[MemOpt, FMIndex, np.ndarray], List[BwtIntv]]
SAFn = Callable[[FMIndex, BwtIntv, int], List[Tuple[int, int]]]


def _scalar_sa(fmi: FMIndex, intv: BwtIntv, max_occ: int):
    from ..ref.smem import sa_positions
    return sa_positions(fmi, intv, max_occ)


def mem_chain(opt: MemOpt, fmi: FMIndex, q: np.ndarray,
              intvs: Optional[List[BwtIntv]] = None,
              sa_fn: SAFn = _scalar_sa,
              positions: Optional[List[np.ndarray]] = None) -> List[Chain]:
    """Collect SMEMs -> SA positions -> chains. ``intvs`` (+ optional
    precomputed, already-subsampled ``positions`` per interval) let the
    device pipeline inject batched seeding/SA-lookup results."""
    length = len(q)
    if length < opt.min_seed_len:
        return []
    l_pac = fmi.bnt.l_pac
    if intvs is None:
        # native C++ seeding (bit-identical, ~1000x the Python
        # scalar); the Python reference stays as the fallback oracle
        from .native_smem import collect_intv_native
        rows = collect_intv_native(opt, fmi, q)
        if rows is not None:
            intvs = rows
        else:
            intvs = collect_intv(opt, fmi, q)
    if isinstance(intvs, np.ndarray):
        # device pipeline fast path: raw [n, 5] rows, no dataclasses
        intvs = [BwtIntv(int(r[0]), int(r[1]), int(r[2]), int(r[3]),
                         int(r[4])) for r in intvs]

    # frac_rep: fraction of the query covered by over-repetitive SMEMs
    l_rep = 0
    b = e = 0
    for p in intvs:
        if p.size <= opt.max_occ:
            continue
        if p.qb > e:
            l_rep += e - b
            b, e = p.qb, p.qe
        else:
            e = max(e, p.qe)
    l_rep += e - b

    chains: List[Chain] = []
    keys: List[int] = []  # sorted chain anchor positions
    for pi, p in enumerate(intvs):
        slen = p.qe - p.qb
        if positions is not None:
            occ_list = [(int(r), 0) for r in positions[pi]]
        else:
            occ_list = sa_fn(fmi, p, opt.max_occ)
        for rbeg, _rank in occ_list:
            s = Seed(rbeg=rbeg, qbeg=p.qb, len=slen, score=slen)
            rid = fmi.bnt.intv2rid(s.rbeg, s.rbeg + s.len)
            if rid < 0:
                continue  # bridges sequences or the fwd-rev boundary
            to_add = True
            if chains:
                # lower bound: chain with largest anchor <= s.rbeg
                idx = bisect.bisect_right(keys, rbeg) - 1
                if idx >= 0 and _test_and_merge(opt, l_pac, chains[idx],
                                                s, rid):
                    to_add = False
            if to_add:
                c = Chain(rid=rid, pos=rbeg, seeds=[s],
                          is_alt=int(bool(fmi.bnt.anns[rid].is_alt)))
                idx = bisect.bisect_right(keys, rbeg)
                keys.insert(idx, rbeg)
                chains.insert(idx, c)
    for c in chains:
        c.frac_rep = l_rep / length
    return chains


def chain_weight(c: Chain) -> int:
    """min(query coverage, ref coverage) over sorted seeds."""
    w = 0
    end = 0
    for s in c.seeds:
        if s.qbeg >= end:
            w += s.len
        elif s.qbeg + s.len > end:
            w += s.qbeg + s.len - end
        end = max(end, s.qbeg + s.len)
    tmp = w
    w = 0
    end = 0
    for s in c.seeds:
        if s.rbeg >= end:
            w += s.len
        elif s.rbeg + s.len > end:
            w += s.rbeg + s.len - end
        end = max(end, s.rbeg + s.len)
    w = min(w, tmp)
    return min(w, (1 << 30) - 1)


def chain_flt(opt: MemOpt, chains: List[Chain]) -> List[Chain]:
    """mem_chain_flt: keep high-weight chains, drop shadowed ones."""
    if not chains:
        return []
    a = []
    for c in chains:
        c.first = -1
        c.kept = 0
        c.w = chain_weight(c)
        if c.w >= opt.min_chain_weight:
            a.append(c)
    if not a:
        return []
    # weight-descending (upstream introsort is unstable; we pin a stable
    # total order by (weight desc, anchor pos) for determinism)
    a.sort(key=lambda c: (-c.w, c.pos, c.qbeg))
    a[0].kept = 3
    kept_idx = [0]
    for i in range(1, len(a)):
        large_ovlp = False
        broke = False
        for j in kept_idx:
            b_max = max(a[j].qbeg, a[i].qbeg)
            e_min = min(a[j].qend, a[i].qend)
            if e_min > b_max and (not a[j].is_alt or a[i].is_alt):
                li = a[i].qend - a[i].qbeg
                lj = a[j].qend - a[j].qbeg
                min_l = min(li, lj)
                if (e_min - b_max >= min_l * opt.mask_level
                        and min_l < opt.max_chain_gap):
                    large_ovlp = True
                    if a[j].first < 0:
                        a[j].first = i
                    if (a[i].w < a[j].w * opt.drop_ratio
                            and a[j].w - a[i].w >= opt.min_seed_len * 2):
                        broke = True
                        break
        if not broke:
            kept_idx.append(i)
            a[i].kept = 2 if large_ovlp else 3
    for j in kept_idx:
        if a[j].first >= 0:
            a[a[j].first].kept = 1
    # cap the number of kept==1/2 chains at max_chain_extend
    k = 0
    cut = len(a)
    for i in range(len(a)):
        if a[i].kept == 0 or a[i].kept == 3:
            continue
        k += 1
        if k >= opt.max_chain_extend:
            cut = i  # upstream zeroes from the capping chain inclusive
            break
    for i in range(cut, len(a)):
        if a[i].kept < 3:
            a[i].kept = 0
    return [c for c in a if c.kept != 0]


def mem_seed_sw(opt: MemOpt, bnt: BntSeq, l_query: int, query: np.ndarray,
                s: Seed, mat: np.ndarray) -> int:
    """SW score of the extended-seed window; -1 = "good enough, skip"."""
    l_pac = bnt.l_pac
    if s.len >= MEM_SHORT_LEN:
        return -1
    qb, qe = s.qbeg, s.qbeg + s.len
    rb, re = s.rbeg, s.rbeg + s.len
    mid = (rb + re) >> 1
    qb = max(qb - MEM_SHORT_EXT, 0)
    qe = min(qe + MEM_SHORT_EXT, l_query)
    rb = max(rb - MEM_SHORT_EXT, 0)
    re = min(re + MEM_SHORT_EXT, l_pac << 1)
    if rb < l_pac < re:
        if mid < l_pac:
            re = l_pac
        else:
            rb = l_pac
    if qe - qb >= MEM_SHORT_LEN or re - rb >= MEM_SHORT_LEN:
        return -1
    rseq, rid, rb, re = bnt.fetch_seq(rb, mid, re)
    x = ksw_align(qe - qb, query[qb:qe], re - rb, rseq, mat,
                  opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    return x.score


def flt_chained_seeds(opt: MemOpt, bnt: BntSeq, l_query: int,
                      query: np.ndarray, chains: List[Chain],
                      mat: np.ndarray) -> None:
    """mem_flt_chained_seeds: drop seeds whose local SW is weak.
    A no-op for short reads (min_l > 0.05*l_query)."""
    min_l = (MEM_HSP_COEF * opt.min_chain_weight if opt.min_chain_weight
             else MEM_MINSC_COEF * math.log(l_query))
    if min_l > MEM_SEEDSW_COEF * l_query:
        return
    min_hsp_score = int(opt.a * min_l + 0.499)
    for c in chains:
        kept = []
        for s in c.seeds:
            score = mem_seed_sw(opt, bnt, l_query, query, s, mat)
            if score < 0 or score >= min_hsp_score:
                s.score = s.len * opt.a if score < 0 else score
                kept.append(s)
        c.seeds = kept
