"""Native emit phase bridge: flat-array marshaling for
native/bwacore.cpp (the C++ port of mark_primary/reg2sam/sam_pe).

The Python implementations in regions.py/sam.py/pair.py remain the
bit-exactness reference; byte equality of the emitted SAM is pinned by
tests/test_native_emit.py.  Any failure here (toolchain missing, flag
we have not modeled) falls back to the Python path silently.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence

import numpy as np

from ..opts import MEM_F_PE, MemOpt

_LIB = None

# AlnReg int fields, in the order bwacore.cpp expects (NF = 18)
_REG_FIELDS = ("rb", "re", "qb", "qe", "rid", "score", "truesc", "sub",
               "alt_sc", "csub", "sub_n", "w", "seedcov", "secondary",
               "secondary_all", "seedlen0", "n_comp", "is_alt")


def _lib():
    global _LIB
    if _LIB is not None:
        return _LIB or None
    if os.environ.get("TPUBWA_NO_NATIVE") \
            or os.environ.get("TPUBWA_NO_NATIVE_EMIT"):
        _LIB = False
        return None
    try:
        from ..native import load_bwacore
        _LIB = load_bwacore()
    except Exception:  # pragma: no cover - toolchain missing
        _LIB = False
    return _LIB or None


_EMIT_STAT_KEYS = (
    "matesw_calls", "matesw_ns", "ksw_align_calls",
    "gen_alt_calls", "gen_alt_ns", "reg2aln_calls", "reg2aln_ns",
    "mem_pair_ns", "mark_primary_ns", "aln2sam_calls", "aln2sam_ns")


def emit_stats(reset: bool = False):
    """Emit-phase attribution counters from the native library (walls
    in ns + call counts for matesw/gen_alt/reg2aln/mem_pair/
    mark_primary/aln2sam).  Returns a dict, or None when the native
    lib is unavailable.  The counters answer the round-3 verdict's
    'where does the realistic-corpus emit time go' question."""
    lib = _lib()
    if lib is None:
        return None
    out = np.zeros(11, np.int64)
    lib.tpubwa_emit_stats(out.ctypes.data_as(
        ctypes.POINTER(ctypes.c_int64)), ctypes.c_int32(1 if reset
                                                        else 0))
    return dict(zip(_EMIT_STAT_KEYS, out.tolist()))


def _blob(items):
    """list of bytes -> (blob, offsets int64[n+1])."""
    off = np.zeros(len(items) + 1, np.int64)
    for i, b in enumerate(items):
        off[i + 1] = off[i] + len(b)
    return b"".join(items), off


class _BntCache:
    """Per-BntSeq flattened metadata (built once per process)."""

    def __init__(self, bnt):
        self.codes = np.ascontiguousarray(bnt.codes, dtype=np.uint8)
        n = len(bnt.anns)
        self.ann_off = np.asarray([a.offset for a in bnt.anns], np.int64)
        self.ann_len = np.asarray([a.length for a in bnt.anns], np.int64)
        self.ann_alt = np.asarray(
            [1 if a.is_alt else 0 for a in bnt.anns], np.uint8)
        self.name_blob, self.name_off = _blob(
            [a.name.encode() for a in bnt.anns])
        self.n = n


def _bnt_cache(bnt) -> _BntCache:
    c = getattr(bnt, "_native_cache", None)
    if c is None:
        c = _BntCache(bnt)
        bnt._native_cache = c
    return c


class FlatRegs:
    """Per-chunk alignment regions kept as the flat native ABI arrays
    (cnt int32[n_reads], iv int64[tot, 18] in _REG_FIELDS order,
    fr float64[tot]) end-to-end: the native planner emits them and the
    native emitter consumes them without ever materializing AlnReg
    objects.  Duck-types as a sequence of per-read AlnReg lists
    (lazy, for the Python fallbacks and tests); the hot paths
    (pestat, emit_batch_native) take the arrays directly."""

    __slots__ = ("cnt", "iv", "fr", "off")

    def __init__(self, cnt, iv, fr):
        self.cnt = np.asarray(cnt, np.int32)
        self.iv = np.asarray(iv, np.int64).reshape(-1, len(_REG_FIELDS))
        self.fr = np.asarray(fr, np.float64)
        self.off = np.zeros(len(self.cnt) + 1, np.int64)
        np.cumsum(self.cnt, out=self.off[1:])

    def __len__(self):
        return len(self.cnt)

    def rows(self, i):
        """(iv rows, fr rows) of read i — no object construction."""
        s, e = self.off[i], self.off[i + 1]
        return self.iv[s:e], self.fr[s:e]

    def __getitem__(self, i):
        from .regions import AlnReg
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        rows, frs = self.rows(i)
        return [AlnReg(**{name: int(p[f]) for f, name in
                          enumerate(_REG_FIELDS)},
                       frac_rep=float(frs[k]))
                for k, p in enumerate(rows)]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    @classmethod
    def from_lists(cls, all_regs) -> "FlatRegs":
        cnt = np.asarray([len(rs) for rs in all_regs], np.int32)
        tot = int(cnt.sum())
        iv = np.zeros((tot, len(_REG_FIELDS)), np.int64)
        fr = np.zeros(tot, np.float64)
        k = 0
        for rs in all_regs:
            for r in rs:
                for f, name in enumerate(_REG_FIELDS):
                    iv[k, f] = getattr(r, name)
                fr[k] = r.frac_rep
                k += 1
        return cls(cnt, iv, fr)

    @classmethod
    def concat(cls, parts: Sequence["FlatRegs"]) -> "FlatRegs":
        return cls(np.concatenate([p.cnt for p in parts]),
                   np.concatenate([p.iv for p in parts]),
                   np.concatenate([p.fr for p in parts]))


def emit_batch_native(opt: MemOpt, fmi, reads: Sequence,
                      all_regs, n_processed: int, rg_id: str,
                      pes) -> Optional[List[str]]:
    """Returns SAM lines, or None if the native path is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    from ..opts import MEM_F_REF_HDR
    if opt.flag & MEM_F_REF_HDR:
        # -V needs the .ann anno strings, which the native ABI does not
        # ship — rare flag, Python path handles it
        return None
    bnt = fmi.bnt
    bc = _bnt_cache(bnt)
    iv = np.asarray([
        opt.a, opt.b, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
        opt.w, opt.T, opt.flag, opt.min_seed_len, opt.max_matesw,
        opt.max_XA_hits, opt.max_XA_hits_alt, opt.pen_unpaired,
        int(opt.mapQ_coef_len), 1 if (opt.flag & MEM_F_PE) else 0,
        n_processed], np.int64)
    dv = np.asarray([opt.mapQ_coef_fac, opt.drop_ratio,
                     opt.XA_drop_ratio, opt.mask_level], np.float64)
    mat = np.ascontiguousarray(opt.scoring_matrix(), np.int32)

    rname_blob, rname_off = _blob([r.name.encode() for r in reads])
    seq_blob, seq_off = _blob(
        [np.ascontiguousarray(r.seq, np.uint8).tobytes() for r in reads])
    qual_blob, qual_off = _blob(
        [(r.qual or "").encode() for r in reads])
    comm_blob, comm_off = _blob(
        [(getattr(r, "comment", "") or "").encode() for r in reads])

    if isinstance(all_regs, FlatRegs):
        # the planner's arrays pass straight through — no object
        # round-trip on the hot path
        reg_cnt = all_regs.cnt
        reg_iv = np.ascontiguousarray(all_regs.iv, np.int64)
        reg_fr = np.ascontiguousarray(all_regs.fr, np.float64)
        if not len(reg_iv):
            reg_iv = np.zeros((1, len(_REG_FIELDS)), np.int64)
            reg_fr = np.zeros(1, np.float64)
    else:
        reg_cnt = np.asarray([len(rs) for rs in all_regs], np.int32)
        tot = int(reg_cnt.sum())
        reg_iv = np.zeros((max(tot, 1), len(_REG_FIELDS)), np.int64)
        reg_fr = np.zeros(max(tot, 1), np.float64)
        k = 0
        for rs in all_regs:
            for r in rs:
                for f, name in enumerate(_REG_FIELDS):
                    reg_iv[k, f] = getattr(r, name)
                reg_fr[k] = r.frac_rep
                k += 1

    pes_iv = np.zeros(12, np.int64)
    pes_dv = np.zeros(8, np.float64)
    if pes is not None:
        for d in range(4):
            pes_iv[d * 3] = pes[d].failed
            pes_iv[d * 3 + 1] = pes[d].low
            pes_iv[d * 3 + 2] = pes[d].high
            pes_dv[d * 2] = pes[d].avg
            pes_dv[d * 2 + 1] = pes[d].std
    else:
        pes_iv[0::3] = 1  # all directions failed (SE)

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    dp = ctypes.POINTER(ctypes.c_double)

    def P(a, t):
        return a.ctypes.data_as(t)

    cap = len(reads) * 1024 + (1 << 16)
    for attempt in range(2):
        out = ctypes.create_string_buffer(cap)
        n = lib.tpubwa_emit_batch(
            P(iv, i64p), P(dv, dp), P(mat, i32p),
            P(bc.codes, u8p), ctypes.c_int64(bnt.l_pac),
            ctypes.c_int32(bc.n), P(bc.ann_off, i64p),
            P(bc.ann_len, i64p), P(bc.ann_alt, u8p),
            ctypes.c_char_p(bc.name_blob), P(bc.name_off, i64p),
            ctypes.c_int64(len(reads)), ctypes.c_char_p(rname_blob),
            P(rname_off, i64p),
            ctypes.c_char_p(seq_blob), P(seq_off, i64p),
            ctypes.c_char_p(qual_blob), P(qual_off, i64p),
            ctypes.c_char_p(comm_blob), P(comm_off, i64p),
            P(reg_cnt, i32p), P(reg_iv, i64p), P(reg_fr, dp),
            P(pes_iv, i64p), P(pes_dv, dp),
            ctypes.c_char_p(rg_id.encode()),
            out, ctypes.c_int64(cap))
        if n >= 0:
            text = out.raw[:n].decode()
            return text.split("\n")[:-1] if text else []
        # the native side returns the exact needed size as -n; one
        # retry with that capacity must succeed — a second failure
        # means a size-accounting bug, so surface it instead of
        # silently degrading to the (50x slower) Python path
        cap = -n + 1
    import logging
    logging.getLogger("tpubwa").warning(
        "native emit failed twice (last needed %d bytes); "
        "falling back to Python emit", -n)
    return None


def _flat_intv_pos(reads, intv_rows, positions):
    """Shared packing: flat interval + position arrays (the native
    chain/plan ABI).  intv_rows is either the flat (rows [n,5],
    per-read counts) fast form or nested per-read lists; positions is
    the flat (pos, cnt) fast form or nested lists."""
    if isinstance(intv_rows, tuple):
        flat, counts = intv_rows
        intv = np.ascontiguousarray(flat, np.int64)
        counts = np.asarray(counts, np.int64)
        n_intv = int(counts.sum())
        if not n_intv:
            intv = np.zeros((1, 5), np.int64)
    else:
        counts = np.asarray([len(rows) for rows in intv_rows],
                            np.int64)
        n_intv = int(counts.sum())
        if n_intv:
            intv = np.ascontiguousarray(np.concatenate(
                [rows for rows in intv_rows if len(rows)]), np.int64)
        else:
            intv = np.zeros((1, 5), np.int64)
    intv_off = np.zeros(len(reads) + 1, np.int64)
    np.cumsum(counts, out=intv_off[1:])
    if isinstance(positions, tuple):
        pos, cnt = positions
        pos = np.ascontiguousarray(pos, np.int64)
        pos_off = np.zeros(n_intv + 1, np.int64)
        np.cumsum(cnt, out=pos_off[1:])
        if not len(pos):
            pos = np.zeros(1, np.int64)
    else:
        pos_chunks = []
        pos_off = [0]
        for ri, rows in enumerate(intv_rows):
            for ii in range(len(rows)):
                p = positions[ri][ii]
                pos_chunks.append(np.ascontiguousarray(p, np.int64))
                pos_off.append(pos_off[-1] + len(p))
        pos = np.concatenate(pos_chunks) if pos_chunks \
            else np.zeros(1, np.int64)
        pos_off = np.asarray(pos_off, np.int64)
    return intv, intv_off, pos, pos_off


def plan_batch_native(opt: MemOpt, fmi, reads: Sequence, intv_rows,
                      positions, extend_fn, qmax: int = 255,
                      tmax: int = 512, flat: bool = False):
    """Native chain + extension planning + region post for a chunk
    (bwacore.cpp planner).  extend_fn(desc [n, 11] int64) -> int32
    [n, 16] runs one device wave.  Returns per-read lists of AlnReg
    (or a FlatRegs view of the same arrays when flat=True), or None
    when the native path is unavailable."""
    import os
    if os.environ.get("TPUBWA_NO_NATIVE_PLAN"):
        return None
    lib = _lib()
    if lib is None:
        return None
    from .regions import AlnReg
    bnt = fmi.bnt
    bc = _bnt_cache(bnt)
    civ2 = np.asarray([
        opt.a, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.w,
        opt.pen_clip5, opt.pen_clip3, opt.zdrop, opt.max_chain_gap,
        opt.min_seed_len, opt.min_chain_weight, opt.max_chain_extend,
        opt.max_occ, qmax, tmax], np.int64)
    cdv2 = np.asarray([opt.mask_level, opt.drop_ratio,
                       opt.mask_level_redun], np.float64)
    mat = np.ascontiguousarray(opt.scoring_matrix(), np.int32)
    seq_blob, seq_off = _blob(
        [np.ascontiguousarray(r.seq, np.uint8).tobytes() for r in reads])
    intv, intv_off, pos, pos_off = _flat_intv_pos(reads, intv_rows,
                                                  positions)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    dp = ctypes.POINTER(ctypes.c_double)

    def P(a, t):
        return a.ctypes.data_as(t)

    h = lib.tpubwa_plan_init(
        P(civ2, i64p), P(cdv2, dp), P(mat, i32p),
        P(bc.codes, u8p), ctypes.c_int64(bnt.l_pac),
        ctypes.c_int32(bc.n), P(bc.ann_off, i64p),
        P(bc.ann_len, i64p), P(bc.ann_alt, u8p),
        ctypes.c_char_p(bc.name_blob), P(bc.name_off, i64p),
        ctypes.c_int64(len(reads)), ctypes.c_char_p(seq_blob),
        P(seq_off, i64p), P(intv, i64p), P(intv_off, i64p),
        P(pos, i64p), P(pos_off, i64p))
    h = ctypes.c_void_p(h)
    if not h:
        return None
    try:
        n_waves = n_jobs = 0
        if not os.environ.get("TPUBWA_NO_SPEC_EXT"):
            # exact wave 1, then speculate the rest: all remaining
            # seeds not skippable against wave-1's regions extend in
            # one batch and the plan replays in C++ — 2 device
            # dispatches per chunk instead of 2-4, with only a few %
            # of discarded rows (full speculation from an empty av
            # measured ~3x job inflation)
            cap = len(reads) + 8
            desc = np.zeros((cap, 11), np.int64)
            while True:
                n = lib.tpubwa_plan_next_wave(h, P(desc, i64p),
                                              ctypes.c_int64(cap))
                if n == -1:
                    cap *= 2
                    desc = np.zeros((cap, 11), np.int64)
                    continue
                break
            if n > 0:
                rows = np.ascontiguousarray(extend_fn(desc[:n]),
                                            np.int32)
                lib.tpubwa_plan_feed(h, P(rows, i32p))
                n_waves += 1
                n_jobs += int(n)
            cap = 2 * len(reads) + 64
            while True:
                desc = np.zeros((cap, 11), np.int64)
                n = lib.tpubwa_plan_spec_jobs(h, P(desc, i64p),
                                              ctypes.c_int64(cap))
                if n != -1:
                    break
                cap *= 2
            if n > 0:
                rows = np.ascontiguousarray(extend_fn(desc[:n]),
                                            np.int32)
                n_waves += 1
                n_jobs += int(n)
            else:
                rows = np.zeros((1, 16), np.int32)
            lib.tpubwa_plan_feed_spec(h, P(rows, i32p))
        else:
            cap = len(reads) + 8
            desc = np.zeros((cap, 11), np.int64)
            while True:
                n = lib.tpubwa_plan_next_wave(h, P(desc, i64p),
                                              ctypes.c_int64(cap))
                if n == -1:
                    cap *= 2
                    desc = np.zeros((cap, 11), np.int64)
                    continue
                if n == 0:
                    break
                rows = np.ascontiguousarray(extend_fn(desc[:n]),
                                            np.int32)
                lib.tpubwa_plan_feed(h, P(rows, i32p))
                n_waves += 1
                n_jobs += int(n)
        rcap = max(4 * len(reads), 64)
        while True:
            reg_cnt = np.zeros(len(reads), np.int32)
            reg_iv = np.zeros((rcap, 18), np.int64)
            reg_fr = np.zeros(rcap, np.float64)
            total = lib.tpubwa_plan_regions(
                h, P(reg_cnt, i32p), P(reg_iv, i64p), P(reg_fr, dp),
                ctypes.c_int64(rcap))
            if total >= 0:
                break
            rcap = -total
    finally:
        lib.tpubwa_plan_free(h)
    if flat:
        total = int(reg_cnt.sum())
        return (FlatRegs(reg_cnt, reg_iv[:total], reg_fr[:total]),
                n_waves, n_jobs)
    out: List[list] = []
    k = 0
    for ri in range(len(reads)):
        regs = []
        for _ in range(int(reg_cnt[ri])):
            p = reg_iv[k]
            r = AlnReg(rb=int(p[0]), re=int(p[1]), qb=int(p[2]),
                       qe=int(p[3]), rid=int(p[4]), score=int(p[5]),
                       truesc=int(p[6]), sub=int(p[7]),
                       alt_sc=int(p[8]), csub=int(p[9]),
                       sub_n=int(p[10]), w=int(p[11]),
                       seedcov=int(p[12]), secondary=int(p[13]),
                       secondary_all=int(p[14]), seedlen0=int(p[15]),
                       n_comp=int(p[16]), is_alt=int(p[17]),
                       frac_rep=float(reg_fr[k]))
            regs.append(r)
            k += 1
        out.append(regs)
    return out, n_waves, n_jobs


def chain_batch_native(opt: MemOpt, fmi, reads: Sequence, intv_rows,
                       positions) -> Optional[List[list]]:
    """Native mem_chain + chain_flt + flt_chained_seeds for a chunk.
    Returns per-read lists of host Chain objects (few per read), or
    None when the native path is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    from .chain import Chain, Seed
    bnt = fmi.bnt
    bc = _bnt_cache(bnt)
    civ = np.asarray([
        opt.a, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.w,
        opt.max_chain_gap, opt.min_seed_len, opt.min_chain_weight,
        opt.max_chain_extend, opt.max_occ], np.int64)
    cdv = np.asarray([opt.mask_level, opt.drop_ratio], np.float64)
    mat = np.ascontiguousarray(opt.scoring_matrix(), np.int32)
    seq_blob, seq_off = _blob(
        [np.ascontiguousarray(r.seq, np.uint8).tobytes() for r in reads])
    intv, intv_off, pos, pos_off = _flat_intv_pos(reads, intv_rows,
                                                  positions)
    n_pos = int(pos_off[-1])
    mc = max(n_pos + 8, 64)
    ms = max(n_pos + 8, 64)
    chain_cnt = np.zeros(len(reads), np.int32)
    chain_meta = np.zeros((mc, 3), np.int64)
    chain_fr = np.zeros(mc, np.float64)
    seeds = np.zeros((ms, 4), np.int64)

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    dp = ctypes.POINTER(ctypes.c_double)

    def P(a, t):
        return a.ctypes.data_as(t)

    rc = lib.tpubwa_chain_batch(
        P(civ, i64p), P(cdv, dp), P(mat, i32p),
        P(bc.codes, u8p), ctypes.c_int64(bnt.l_pac),
        ctypes.c_int32(bc.n), P(bc.ann_off, i64p), P(bc.ann_len, i64p),
        P(bc.ann_alt, u8p), ctypes.c_char_p(bc.name_blob),
        P(bc.name_off, i64p),
        ctypes.c_int64(len(reads)), ctypes.c_char_p(seq_blob),
        P(seq_off, i64p),
        P(intv, i64p), P(intv_off, i64p), P(pos, i64p),
        P(pos_off, i64p),
        P(chain_cnt, i32p), P(chain_meta, i64p), P(chain_fr, dp),
        ctypes.c_int64(mc), P(seeds, i64p), ctypes.c_int64(ms))
    if rc != 0:
        return None
    out = []
    ci = 0
    si = 0
    for ri in range(len(reads)):
        chains = []
        for _ in range(int(chain_cnt[ri])):
            rid, is_alt, n_seeds = (int(x) for x in chain_meta[ci])
            ss = [Seed(rbeg=int(seeds[si + j, 0]),
                       qbeg=int(seeds[si + j, 1]),
                       len=int(seeds[si + j, 2]),
                       score=int(seeds[si + j, 3]))
                  for j in range(n_seeds)]
            si += n_seeds
            c = Chain(rid=rid, pos=ss[0].rbeg if ss else 0, seeds=ss,
                      is_alt=is_alt, frac_rep=float(chain_fr[ci]))
            ci += 1
            chains.append(c)
        out.append(chains)
    return out
