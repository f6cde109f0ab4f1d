"""Paired-end logic (bwamem_pair.c: mem_pestat/~60, mem_matesw/~150,
mem_pair/~240, mem_sam_pe/~340; SURVEY.md §2 row 18)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..index.fmindex import FMIndex
from ..io.fastq import Read
from ..opts import MEM_F_ALL, MEM_F_NO_RESCUE, MEM_F_NOPAIRING, MemOpt
from ..ref.ksw import ksw_align
from .regions import AlnReg, approx_mapq, hash_64, mark_primary
from .sam import MemAln, aln2sam, gen_alt, reg2aln, reg2sam

MIN_RATIO = 0.8
MIN_DIR_CNT = 10
MIN_DIR_RATIO = 0.05
OUTLIER_BOUND = 2.0
MAPPING_BOUND = 3.0
MAX_STDDEV = 4.0


@dataclass
class PEStat:
    low: int = 0
    high: int = 0
    failed: int = 1
    avg: float = 0.0
    std: float = 0.0


def infer_dir(l_pac: int, b1: int, b2: int) -> Tuple[int, int]:
    """mem_infer_dir: orientation code (FF/FR/RF/RR) + distance."""
    r1, r2 = b1 >= l_pac, b2 >= l_pac
    p2 = b2 if r1 == r2 else (l_pac << 1) - 1 - b2
    dist = p2 - b1 if p2 > b1 else b1 - p2
    return ((0 if r1 == r2 else 1) ^ (0 if p2 > b1 else 3)), dist


def _cal_sub(opt: MemOpt, regs: List[AlnReg]) -> int:
    j = 1
    while j < len(regs):
        b_max = max(regs[j].qb, regs[0].qb)
        e_min = min(regs[j].qe, regs[0].qe)
        if e_min > b_max:
            min_l = min(regs[j].qe - regs[j].qb, regs[0].qe - regs[0].qb)
            if e_min - b_max >= min_l * opt.mask_level:
                break
        j += 1
    return regs[j].score if j < len(regs) else opt.min_seed_len * opt.a


def _cal_sub_rows(opt: MemOpt, iv) -> int:
    """_cal_sub over flat int64 [n, 18] rows (native_emit._REG_FIELDS
    order: qb=2, qe=3, score=5) — no AlnReg construction."""
    n = len(iv)
    qb0, qe0 = int(iv[0, 2]), int(iv[0, 3])
    j = 1
    while j < n:
        b_max = max(int(iv[j, 2]), qb0)
        e_min = min(int(iv[j, 3]), qe0)
        if e_min > b_max:
            min_l = min(int(iv[j, 3]) - int(iv[j, 2]), qe0 - qb0)
            if e_min - b_max >= min_l * opt.mask_level:
                break
        j += 1
    return int(iv[j, 5]) if j < n else opt.min_seed_len * opt.a


def _pestat_isize_flat(opt: MemOpt, l_pac: int, flat) -> list:
    """Insert-size collection over a FlatRegs chunk (same semantics
    as the object loop below; rb=0, rid=4, score=5)."""
    isize = [[], [], [], []]
    n = len(flat)
    for i in range(n >> 1):
        iv0, _ = flat.rows(i << 1)
        iv1, _ = flat.rows(i << 1 | 1)
        if not len(iv0) or not len(iv1):
            continue
        if _cal_sub_rows(opt, iv0) > MIN_RATIO * int(iv0[0, 5]):
            continue
        if _cal_sub_rows(opt, iv1) > MIN_RATIO * int(iv1[0, 5]):
            continue
        if iv0[0, 4] != iv1[0, 4]:
            continue
        d, dist = infer_dir(l_pac, int(iv0[0, 0]), int(iv1[0, 0]))
        if dist and dist <= opt.max_ins:
            isize[d].append(dist)
    return isize


def pestat(opt: MemOpt, l_pac: int,
           all_regs: Sequence[List[AlnReg]]) -> List[PEStat]:
    """mem_pestat: batch-global insert-size inference per orientation."""
    from .native_emit import FlatRegs
    if isinstance(all_regs, FlatRegs):
        isize = _pestat_isize_flat(opt, l_pac, all_regs)
        n = 0
    else:
        isize = [[], [], [], []]
        n = len(all_regs)
    for i in range(n >> 1):
        r0 = all_regs[i << 1]
        r1 = all_regs[i << 1 | 1]
        if not r0 or not r1:
            continue
        if _cal_sub(opt, r0) > MIN_RATIO * r0[0].score:
            continue
        if _cal_sub(opt, r1) > MIN_RATIO * r1[0].score:
            continue
        if r0[0].rid != r1[0].rid:
            continue
        d, dist = infer_dir(l_pac, r0[0].rb, r1[0].rb)
        if dist and dist <= opt.max_ins:
            isize[d].append(dist)
    pes = [PEStat() for _ in range(4)]
    for d in range(4):
        q = sorted(isize[d])
        r = pes[d]
        if len(q) < MIN_DIR_CNT:
            r.failed = 1
            continue
        r.failed = 0
        p25 = q[int(0.25 * len(q) + 0.499)]
        p50 = q[int(0.50 * len(q) + 0.499)]
        p75 = q[int(0.75 * len(q) + 0.499)]
        r.low = max(int(p25 - OUTLIER_BOUND * (p75 - p25) + 0.499), 1)
        r.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + 0.499)
        sel = [x for x in q if r.low <= x <= r.high]
        r.avg = sum(sel) / len(sel)
        r.std = math.sqrt(sum((x - r.avg) ** 2 for x in sel) / len(sel))
        r.low = int(p25 - MAPPING_BOUND * (p75 - p25) + 0.499)
        r.high = int(p75 + MAPPING_BOUND * (p75 - p25) + 0.499)
        if r.low > r.avg - MAX_STDDEV * r.std:
            r.low = int(r.avg - MAX_STDDEV * r.std + 0.499)
        if r.high < r.avg + MAX_STDDEV * r.std:
            r.high = int(r.avg + MAX_STDDEV * r.std + 0.499)
        r.low = max(r.low, 1)
    mx = max(len(x) for x in isize)
    for d in range(4):
        if pes[d].failed == 0 and len(isize[d]) < mx * MIN_DIR_RATIO:
            pes[d].failed = 1
    return pes


def matesw(opt: MemOpt, fmi: FMIndex, pes: List[PEStat], a: AlnReg,
           mate: Read, ma: List[AlnReg], mat: np.ndarray) -> int:
    """mem_matesw: SW the mate inside the predicted window."""
    bnt = fmi.bnt
    l_pac = bnt.l_pac
    l_ms = mate.l_seq
    ms = mate.seq
    skip = [1 if pes[r].failed else 0 for r in range(4)]
    for m in ma:
        r, dist = infer_dir(l_pac, a.rb, m.rb)
        if not pes[r].failed and pes[r].low <= dist <= pes[r].high:
            skip[r] = 1
    if sum(skip) == 4:
        return 0  # consistent pair exists already
    n = 0
    for r in range(4):
        if skip[r]:
            continue
        is_rev = (r >> 1) != (r & 1)
        is_larger = not (r >> 1)
        if is_rev:
            seq = np.where(ms < 4, 3 - ms, 4)[::-1].astype(np.uint8)
        else:
            seq = ms
        if not is_rev:
            rb = a.rb + pes[r].low if is_larger else a.rb - pes[r].high
            re = (a.rb + pes[r].high if is_larger
                  else a.rb - pes[r].low) + l_ms
        else:
            rb = (a.rb + pes[r].low if is_larger
                  else a.rb - pes[r].high) - l_ms
            re = a.rb + pes[r].high if is_larger else a.rb - pes[r].low
        rb = max(rb, 0)
        re = min(re, l_pac << 1)
        rid = -1
        if rb < re:
            ref, rid, rb, re = bnt.fetch_seq(rb, (rb + re) >> 1, re)
        if rid >= 0 and re - rb >= opt.min_seed_len:
            aln = ksw_align(l_ms, seq, re - rb, ref, mat, opt.o_del,
                            opt.e_del, opt.o_ins, opt.e_ins,
                            minsc=opt.min_seed_len * opt.a)
            if aln.score >= opt.min_seed_len and aln.qb >= 0:
                b = AlnReg(rid=a.rid, is_alt=a.is_alt)
                b.qb = l_ms - (aln.qe + 1) if is_rev else aln.qb
                b.qe = l_ms - aln.qb if is_rev else aln.qe + 1
                b.rb = ((l_pac << 1) - (rb + aln.te + 1) if is_rev
                        else rb + aln.tb)
                b.re = ((l_pac << 1) - (rb + aln.tb) if is_rev
                        else rb + aln.te + 1)
                b.score = aln.score
                b.truesc = aln.score
                b.csub = aln.score2
                b.secondary = -1
                b.seedcov = min(b.re - b.rb, b.qe - b.qb) >> 1
                # insert keeping ma sorted by score descending
                ins = 0
                while ins < len(ma) and ma[ins].score >= b.score:
                    ins += 1
                ma.insert(ins, b)
            n += 1
        if n:
            break
    return n


def raw_mapq(diff: int, a: int) -> int:
    return min(int(6.02 * diff / a + 0.499), 60)


def mem_pair(opt: MemOpt, fmi: FMIndex, pes: List[PEStat],
             all_regs: Tuple[List[AlnReg], List[AlnReg]], pair_id: int,
             n_pri: List[int]):
    """Select the best proper pair.  Returns (o, sub, n_sub, z[2])."""
    l_pac = fmi.bnt.l_pac
    v = []  # (x = rid<<32|fwdpos, y = score<<32|i<<2|strand<<1|readno)
    for r in range(2):
        for i in range(n_pri[r]):
            e = all_regs[r][i]
            fx = e.rb if e.rb < l_pac else (l_pac << 1) - 1 - e.rb
            x = (e.rid << 32) | (fx - fmi.bnt.anns[e.rid].offset)
            y = (e.score << 32) | (i << 2) | ((e.rb >= l_pac) << 1) | r
            v.append((x, y))
    v.sort()
    y_last = [-1, -1, -1, -1]
    u = []
    for i in range(len(v)):
        for rr in range(2):
            dire = (rr << 1) | ((v[i][1] >> 1) & 1)
            if pes[dire].failed:
                continue
            which = (rr << 1) | ((v[i][1] & 1) ^ 1)
            if y_last[which] < 0:
                continue
            for k in range(y_last[which], -1, -1):
                if (v[k][1] & 3) != which:
                    continue
                dist = v[i][0] - v[k][0]
                if dist > pes[dire].high:
                    break
                if dist < pes[dire].low:
                    continue
                # C computes ns = (dist-avg)/std with IEEE semantics:
                # std==0 gives NaN/inf, erfc underflow gives log(0) =
                # -inf; either way the (int) cast + clamp lands on 0.
                # Python raises on both, so branch explicitly.
                p = 0.0
                if pes[dire].std > 0:
                    ns = (dist - pes[dire].avg) / pes[dire].std
                    p = 2.0 * math.erfc(abs(ns) * (2 ** -0.5))
                if p > 0:
                    q = int((v[i][1] >> 32) + (v[k][1] >> 32)
                            + 0.721 * math.log(p) * opt.a + 0.499)
                    q = max(q, 0)
                else:
                    q = 0
                y = (k << 32) | i
                x = (q << 32) | (hash_64((y ^ (pair_id << 8))
                                         & 0xFFFFFFFFFFFFFFFF)
                                 & 0xFFFFFFFF)
                u.append((x, y))
        y_last[v[i][1] & 3] = i
    z = [-1, -1]
    if not u:
        return 0, 0, 0, z
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    u.sort()
    bi = u[-1][1] >> 32
    bk = u[-1][1] & 0xFFFFFFFF
    z[v[bk][1] & 1] = ((v[bk][1] & 0xFFFFFFFF) >> 2)
    z[v[bi][1] & 1] = ((v[bi][1] & 0xFFFFFFFF) >> 2)
    o = u[-1][0] >> 32
    sub = (u[-2][0] >> 32) if len(u) > 1 else 0
    n_sub = 0
    for i in range(len(u) - 2, -1, -1):
        if sub - (u[i][0] >> 32) <= tmp:
            n_sub += 1
    return o, sub, n_sub, z


def sam_pe(opt: MemOpt, fmi: FMIndex, pes: List[PEStat], pair_id: int,
           reads: Tuple[Read, Read],
           regs2: Tuple[List[AlnReg], List[AlnReg]], mat: np.ndarray,
           rg_id: str = "") -> List[str]:
    """mem_sam_pe: emit SAM for one read pair (2+ lines)."""
    bnt = fmi.bnt
    a = [regs2[0], regs2[1]]
    s = reads
    n = 0
    if not (opt.flag & MEM_F_NO_RESCUE):
        for i in range(2):
            b = [r for r in a[i]
                 if a[i] and r.score >= a[i][0].score - opt.pen_unpaired]
            for j, reg in enumerate(b):
                if j >= opt.max_matesw:
                    break
                n += matesw(opt, fmi, pes, reg, s[1 - i], a[1 - i], mat)
    n_pri = [mark_primary(opt, a[0], (pair_id << 1) | 0),
             mark_primary(opt, a[1], (pair_id << 1) | 1)]
    extra_flag = 1
    if not (opt.flag & MEM_F_NOPAIRING) and n_pri[0] and n_pri[1]:
        o, subo, n_sub, z = mem_pair(opt, fmi, pes, (a[0], a[1]),
                                     pair_id, n_pri)
        if o > 0:
            # multiple strong primary hits on either end -> no pairing
            is_multi = []
            for i in range(2):
                multi = any(a[i][j].secondary < 0 and a[i][j].score >= opt.T
                            for j in range(1, n_pri[i]))
                is_multi.append(multi)
            if not (is_multi[0] or is_multi[1]):
                q_se = [approx_mapq(opt, a[0][0]),
                        approx_mapq(opt, a[1][0])]
                score_un = a[0][0].score + a[1][0].score - opt.pen_unpaired
                subo = max(subo, score_un)
                q_pe = raw_mapq(o - subo, opt.a)
                if n_sub > 0:
                    q_pe -= int(4.343 * math.log(n_sub + 1) + 0.499)
                q_pe = min(max(q_pe, 0), 60)
                q_pe = int(q_pe * (1.0 - 0.5 * (a[0][0].frac_rep
                                                + a[1][0].frac_rep)) + 0.499)
                if o > score_un:  # paired alignment preferred
                    c = [a[0][z[0]], a[1][z[1]]]
                    for i in range(2):
                        if c[i].secondary >= 0:
                            c[i].sub = a[i][c[i].secondary].score
                            c[i].secondary = -2
                        q_se[i] = approx_mapq(opt, c[i])
                    for i in range(2):
                        q_se[i] = max(q_se[i], min(q_pe, q_se[i] + 40))
                        q_se[i] = min(q_se[i],
                                      raw_mapq(c[i].score - c[i].csub,
                                               opt.a))
                    extra_flag |= 2
                else:
                    z = [0, 0]
                    q_se = [approx_mapq(opt, a[0][0]),
                            approx_mapq(opt, a[1][0])]
                XA = [None, None]
                if not (opt.flag & MEM_F_ALL):
                    XA = [gen_alt(opt, bnt, a[i], s[i].l_seq, s[i].seq, mat)
                          for i in range(2)]
                h = []
                aa = [[], []]
                for i in range(2):
                    hi = reg2aln(opt, bnt, s[i].l_seq, s[i].seq,
                                 a[i][z[i]], mat)
                    hi.mapq = q_se[i]
                    hi.flag |= (0x40 << i) | extra_flag
                    hi.XA = XA[i][z[i]] if XA[i] else None
                    h.append(hi)
                    aa[i].append(hi)
                    if n_pri[i] < len(a[i]):  # ALT hits
                        p = a[i][n_pri[i]]
                        if p.score >= opt.T and p.secondary < 0 \
                                and p.is_alt:
                            gi = reg2aln(opt, bnt, s[i].l_seq, s[i].seq,
                                         p, mat)
                            gi.flag |= 0x800 | (0x40 << i) | extra_flag
                            gi.XA = XA[i][n_pri[i]] if XA[i] else None
                            aa[i].append(gi)
                lines = []
                for i in range(len(aa[0])):
                    lines.append(aln2sam(opt, bnt, s[0].name, s[0].seq,
                                         s[0].qual, len(aa[0]), aa[0], i,
                                         h[1], rg_id, s[0].comment))
                for i in range(len(aa[1])):
                    lines.append(aln2sam(opt, bnt, s[1].name, s[1].seq,
                                         s[1].qual, len(aa[1]), aa[1], i,
                                         h[0], rg_id, s[1].comment))
                return lines
    # no_pairing path
    h = []
    for i in range(2):
        which = -1
        if a[i]:
            if a[i][0].score >= opt.T:
                which = 0
            elif n_pri[i] < len(a[i]) and a[i][n_pri[i]].score >= opt.T:
                which = n_pri[i]
        h.append(reg2aln(opt, bnt, s[i].l_seq, s[i].seq,
                         a[i][which] if which >= 0 else None, mat))
    if not (opt.flag & MEM_F_NOPAIRING) and h[0].rid == h[1].rid >= 0 \
            and a[0] and a[1]:
        d, dist = infer_dir(bnt.l_pac, a[0][0].rb, a[1][0].rb)
        if not pes[d].failed and pes[d].low <= dist <= pes[d].high:
            extra_flag |= 2
    lines = reg2sam(opt, bnt, s[0].name, s[0].seq, s[0].qual, s[0].l_seq,
                    a[0], 0x41 | extra_flag, h[1], mat, rg_id,
                    s[0].comment)
    lines += reg2sam(opt, bnt, s[1].name, s[1].seq, s[1].qual, s[1].l_seq,
                     a[1], 0x81 | extra_flag, h[0], mat, rg_id,
                     s[1].comment)
    return lines
