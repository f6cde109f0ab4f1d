"""Region -> SAM record generation (bwamem.c:mem_reg2aln/~1230,
mem_aln2sam/~1320, mem_reg2sam/~1460; bwa.c:bwa_gen_cigar2/~120;
bwamem_extra.c:mem_gen_alt; SURVEY.md §2 row 13)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..index.build import BntSeq, CODE2BASE
from ..opts import (MEM_F_ALL, MEM_F_KEEP_SUPP_MAPQ, MEM_F_NO_MULTI,
                    MEM_F_REF_HDR, MEM_F_SOFTCLIP, MemOpt)
from ..ref.ksw import ksw_global
from .regions import AlnReg, approx_mapq

_FWD = "ACGTN"
_REV = "TGCAN"
# bytes-translate tables: code ndarray -> base string in one C pass
_FWD_TBL = bytes.maketrans(bytes(range(5)), b"ACGTN")
_REV_TBL = bytes.maketrans(bytes(range(5)), b"TGCAN")


def codes_to_str(seq, rev: bool = False) -> str:
    b = np.ascontiguousarray(seq[::-1] if rev else seq,
                             dtype=np.uint8).tobytes()
    return b.translate(_REV_TBL if rev else _FWD_TBL).decode()


@dataclass
class MemAln:
    """mem_aln_t: one SAM-record-ready alignment."""
    pos: int = -1
    rid: int = -1
    flag: int = 0
    is_rev: int = 0
    is_alt: int = 0
    mapq: int = 0
    NM: int = -1
    cigar: List[Tuple[int, int]] = field(default_factory=list)
    MD: str = ""
    score: int = -1
    sub: int = -1
    alt_sc: int = 0
    XA: Optional[str] = None


def infer_bw(l1: int, l2: int, score: int, a: int, q: int, r: int) -> int:
    """bwamem.c:infer_bw — band needed to achieve `score`."""
    if l1 == l2 and l1 * a - score < (q + r - a) << 1:
        return 0
    w = int((min(l1, l2) * a - score - q) / r + 2.0)
    return max(w, abs(l1 - l2))


def gen_cigar(opt: MemOpt, bnt: BntSeq, query: np.ndarray, rb: int,
              re: int, w: int, mat: np.ndarray):
    """bwa.c:bwa_gen_cigar2 — global alignment of query vs ref[rb:re)
    (doubled coords), leftmost-indel on the forward genome, with MD/NM.
    Returns (score, cigar, NM, MD)."""
    l_pac = bnt.l_pac
    l_query = len(query)
    if l_query <= 0 or rb >= re or (rb < l_pac and re > l_pac):
        return 0, [], -1, ""
    rseq = bnt.get_seq(rb, re)
    rlen = len(rseq)
    q = query
    if rb >= l_pac:  # reverse both for leftmost indels in genome coords
        q = query[::-1].copy()
        rseq = rseq[::-1].copy()
    if l_query == re - rb and w == 0:
        cigar = [(0, l_query)]
        score = int(mat[rseq[:l_query], q[:l_query]].sum())
    else:
        max_ins = int((((l_query + 1) >> 1) * int(mat[0, 0]) - opt.o_ins)
                      / opt.e_ins + 1.0)
        max_del = int((((l_query + 1) >> 1) * int(mat[0, 0]) - opt.o_del)
                      / opt.e_del + 1.0)
        max_gap = max(max_ins, max_del, 1)
        ww = (max_gap + abs(rlen - l_query) + 1) >> 1
        ww = min(ww, w)
        min_w = abs(rlen - l_query) + 3
        ww = max(ww, min_w)
        score, cigar = ksw_global(l_query, q, rlen, rseq, mat, opt.o_del,
                                  opt.e_del, opt.o_ins, opt.e_ins, ww)
    # NM / MD over the (possibly reversed) sequences
    int2base = _FWD if rb < l_pac else _REV
    md = []
    x = y = u = 0
    n_mm = n_gap = 0
    for k, (op, ln) in enumerate(cigar):
        if op == 0:
            mism = np.flatnonzero(q[x:x + ln] != rseq[y:y + ln])
            n_mm += len(mism)
            prev = -1
            for i in mism:
                md.append(str(u + int(i) - prev - 1))
                md.append(int2base[rseq[y + int(i)]])
                prev = int(i)
                u = 0
            u = u + ln - prev - 1 if len(mism) else u + ln
            x += ln
            y += ln
        elif op == 2:
            if 0 < k < len(cigar) - 1:
                md.append(str(u))
                md.append("^" + "".join(int2base[rseq[y + i]]
                                        for i in range(ln)))
                u = 0
                n_gap += ln
            y += ln
        elif op == 1:
            x += ln
            n_gap += ln
    md.append(str(u))
    return score, cigar, n_mm + n_gap, "".join(md)


def reg2aln(opt: MemOpt, bnt: BntSeq, l_query: int, query: np.ndarray,
            ar: Optional[AlnReg], mat: np.ndarray) -> MemAln:
    """bwamem.c:mem_reg2aln — region -> positioned alignment + CIGAR."""
    a = MemAln()
    if ar is None or ar.rb < 0 or ar.re < 0:
        a.rid = -1
        a.pos = -1
        a.flag |= 0x4
        return a
    qb, qe = ar.qb, ar.qe
    rb, re = ar.rb, ar.re
    a.mapq = approx_mapq(opt, ar) if ar.secondary < 0 else 0
    if ar.secondary >= 0:
        a.flag |= 0x100
    tmp = infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_del, opt.e_del)
    w2 = infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_ins, opt.e_ins)
    w2 = max(w2, tmp)
    if w2 > opt.w:
        w2 = min(w2, ar.w)
    last_sc = -(1 << 30)
    i = 0
    score, cigar, NM, MD = 0, [], -1, ""
    while True:
        w2 = min(w2, opt.w << 2)
        score, cigar, NM, MD = gen_cigar(opt, bnt, query[qb:qe], rb, re,
                                         w2, mat)
        if score == last_sc or w2 == opt.w << 2:
            break
        last_sc = score
        w2 <<= 1
        i += 1
        if i >= 3 or score >= ar.truesc - opt.a:
            break
    a.NM = NM
    a.MD = MD
    pos, is_rev = bnt.depos(rb if rb < bnt.l_pac else re - 1)
    a.is_rev = is_rev
    if cigar:  # squeeze out leading/trailing deletions
        if cigar[0][0] == 2:
            pos += cigar[0][1]
            cigar = cigar[1:]
        elif cigar[-1][0] == 2:
            cigar = cigar[:-1]
    if qb != 0 or qe != l_query:  # soft clips
        clip5 = l_query - qe if is_rev else qb
        clip3 = qb if is_rev else l_query - qe
        if clip5:
            cigar = [(3, clip5)] + cigar
        if clip3:
            cigar = cigar + [(3, clip3)]
    a.cigar = cigar
    a.rid = bnt.pos2rid(pos)
    assert a.rid == ar.rid
    a.pos = pos - bnt.anns[a.rid].offset
    a.score = ar.score
    a.sub = max(ar.sub, ar.csub)
    a.is_alt = ar.is_alt
    a.alt_sc = ar.alt_sc
    return a


def _cigar_rlen(cigar) -> int:
    return sum(ln for op, ln in cigar if op in (0, 2))


def aln2sam(opt: MemOpt, bnt: BntSeq, name: str, seq: np.ndarray,
            qual: Optional[str], n: int, alns: List[MemAln], which: int,
            mate: Optional[MemAln], rg_id: str = "",
            comment: str = "") -> str:
    """bwamem.c:mem_aln2sam — one SAM text line (no trailing newline)."""
    p = alns[which]
    flag = p.flag
    is_rev, rid, pos, n_cigar = p.is_rev, p.rid, p.pos, len(p.cigar)
    cigar = p.cigar
    m_rid, m_pos, m_rev, m_cigar = (-1, -1, 0, [])
    if mate is not None:
        flag |= 0x1
        m_rid, m_pos, m_rev, m_cigar = (mate.rid, mate.pos, mate.is_rev,
                                        mate.cigar)
    if rid < 0:
        flag |= 0x4
    if mate is not None and m_rid < 0:
        flag |= 0x8
    if rid < 0 and mate is not None and m_rid >= 0:  # copy mate coords
        rid, pos, is_rev = m_rid, m_pos, m_rev
        cigar = []
        n_cigar = 0
    if mate is not None and m_rid < 0 and rid >= 0:
        m_rid, m_pos, m_rev = rid, pos, is_rev
        m_cigar = []
    if is_rev:
        flag |= 0x10
    if mate is not None and m_rev:
        flag |= 0x20
    out = [name, str((flag & 0xFFFF) | (0x100 if flag & 0x10000 else 0))]
    if rid >= 0:
        out.append(bnt.anns[rid].name)
        out.append(str(pos + 1))
        out.append(str(p.mapq))
        if n_cigar:
            parts = []
            for op, ln in cigar:
                c = op
                if not (opt.flag & MEM_F_SOFTCLIP) and not p.is_alt \
                        and c in (3, 4):
                    c = 4 if which else 3
                parts.append(f"{ln}{'MIDSH'[c]}")
            out.append("".join(parts))
        else:
            out.append("*")
    else:
        out.extend(["*", "0", "0", "*"])
    # mate position
    if mate is not None and m_rid >= 0:
        out.append("=" if rid == m_rid else bnt.anns[m_rid].name)
        out.append(str(m_pos + 1))
        if rid == m_rid:
            p0 = pos + (_cigar_rlen(cigar) - 1 if is_rev else 0)
            p1 = m_pos + (_cigar_rlen(m_cigar) - 1 if m_rev else 0)
            if not m_cigar or not cigar:
                out.append("0")
            else:
                out.append(str(-(p0 - p1 + (1 if p0 > p1 else
                                            -1 if p0 < p1 else 0))))
        else:
            out.append("0")
    else:
        out.extend(["*", "0", "0"])
    # SEQ/QUAL (hard-clip trimming for supplementary records)
    if flag & 0x100:
        out.extend(["*", "*"])
    else:
        qb, qe = 0, len(seq)
        if n_cigar and which and not (opt.flag & MEM_F_SOFTCLIP) \
                and not p.is_alt:
            if not is_rev:
                if cigar[0][0] in (3, 4):
                    qb += cigar[0][1]
                if cigar[-1][0] in (3, 4):
                    qe -= cigar[-1][1]
            else:
                if cigar[0][0] in (3, 4):
                    qe -= cigar[0][1]
                if cigar[-1][0] in (3, 4):
                    qb += cigar[-1][1]
        if not is_rev:
            out.append(codes_to_str(seq[qb:qe]))
            out.append(qual[qb:qe] if qual else "*")
        else:
            out.append(codes_to_str(seq[qb:qe], rev=True))
            out.append(qual[qb:qe][::-1] if qual else "*")
    tags = []
    if n_cigar:
        tags.append(f"NM:i:{p.NM}")
        tags.append(f"MD:Z:{p.MD}")
    if p.score >= 0:
        tags.append(f"AS:i:{p.score}")
    if p.sub >= 0:
        tags.append(f"XS:i:{max(p.sub, p.alt_sc)}")
    if rg_id:
        tags.append(f"RG:Z:{rg_id}")
    if not (flag & 0x100):
        others = [i for i in range(n)
                  if i != which and not (alns[i].flag & 0x100)]
        if others:
            sa = []
            for i in range(n):
                r = alns[i]
                if i == which or (r.flag & 0x100):
                    continue
                cig = "".join(f"{ln}{'MIDSH'[op]}" for op, ln in r.cigar)
                sa.append(f"{bnt.anns[r.rid].name},{r.pos + 1},"
                          f"{'+-'[r.is_rev]},{cig},{r.mapq},{r.NM};")
            tags.append("SA:Z:" + "".join(sa))
        if p.alt_sc > 0:
            tags.append(f"pa:f:{p.score / p.alt_sc:.3f}")
    if p.XA:
        tags.append(f"XA:Z:{p.XA}")
    if (opt.flag & MEM_F_REF_HDR) and rid >= 0 \
            and bnt.anns[rid].anno not in ("", "(null)"):
        # -V: carry the reference FASTA comment in the XR tag
        # (mem_aln2sam's MEM_F_REF_HDR branch)
        tags.append("XR:Z:" + bnt.anns[rid].anno
                    .replace("\t", " ").replace("\n", " "))
    if comment:
        tags.append(comment)
    return "\t".join(out + tags)


def _get_pri_idx(xa_drop_ratio: float, regs: List[AlnReg], i: int) -> int:
    k = regs[i].secondary_all
    if k >= 0 and regs[i].score >= regs[k].score * xa_drop_ratio:
        return k
    return -1


def gen_alt(opt: MemOpt, bnt: BntSeq, regs: List[AlnReg], l_query: int,
            query: np.ndarray, mat: np.ndarray) -> List[Optional[str]]:
    """bwamem_extra.c:mem_gen_alt — XA strings per primary region."""
    n = len(regs)
    cnt = [0] * n
    has_alt = [False] * n
    tot = 0
    for i in range(n):
        r = _get_pri_idx(opt.XA_drop_ratio, regs, i)
        if r >= 0:
            cnt[r] += 1
            tot += 1
            if regs[i].is_alt:
                has_alt[r] = True
    XA: List[Optional[str]] = [None] * n
    if tot == 0:
        return XA
    aln: List[List[str]] = [[] for _ in range(n)]
    for i in range(n):
        r = _get_pri_idx(opt.XA_drop_ratio, regs, i)
        if r < 0:
            continue
        if cnt[r] > (opt.max_XA_hits_alt if has_alt[r] else opt.max_XA_hits):
            continue
        t = reg2aln(opt, bnt, l_query, query, regs[i], mat)
        cig = "".join(f"{ln}{'MIDSH'[op]}" for op, ln in t.cigar)
        aln[r].append(f"{bnt.anns[t.rid].name},{'+-'[t.is_rev]}{t.pos + 1},"
                      f"{cig},{t.NM};")
    for k in range(n):
        if aln[k]:
            XA[k] = "".join(aln[k])
    return XA


def reg2sam(opt: MemOpt, bnt: BntSeq, name: str, seq: np.ndarray,
            qual: Optional[str], l_query: int, regs: List[AlnReg],
            extra_flag: int, mate: Optional[MemAln], mat: np.ndarray,
            rg_id: str = "", comment: str = "") -> List[str]:
    """bwamem.c:mem_reg2sam — SE record emission for one read."""
    XA = None
    if not (opt.flag & MEM_F_ALL):
        XA = gen_alt(opt, bnt, regs, l_query, seq, mat)
    alns: List[MemAln] = []
    l = 0
    for k, p in enumerate(regs):
        if p.score < opt.T:
            continue
        if p.secondary >= 0 and (p.is_alt or not (opt.flag & MEM_F_ALL)):
            continue
        if p.secondary >= 0 and p.secondary < 0x7FFFFFFF \
                and p.score < regs[p.secondary].score * opt.drop_ratio:
            continue
        q = reg2aln(opt, bnt, l_query, seq, p, mat)
        assert q.rid >= 0
        q.XA = XA[k] if XA else None
        q.flag |= extra_flag
        if p.secondary >= 0:
            q.sub = -1  # don't output suboptimal score for secondaries
        if l and p.secondary < 0:
            q.flag |= 0x10000 if (opt.flag & MEM_F_NO_MULTI) else 0x800
        if not (opt.flag & MEM_F_KEEP_SUPP_MAPQ) and l \
                and not p.is_alt and q.mapq > alns[0].mapq:
            # cap supplementary mapq by the primary's (skipped by -q)
            q.mapq = alns[0].mapq
        l += 1
        alns.append(q)
    if not alns:
        t = reg2aln(opt, bnt, l_query, seq, None, mat)
        t.flag |= extra_flag
        return [aln2sam(opt, bnt, name, seq, qual, 1, [t], 0, mate,
                        rg_id, comment)]
    return [aln2sam(opt, bnt, name, seq, qual, len(alns), alns, k, mate,
                    rg_id, comment)
            for k in range(len(alns))]
