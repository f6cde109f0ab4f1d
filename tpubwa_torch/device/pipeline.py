"""Per-batch aligner with GPU seed extension, the counterpart of
tpubwa/device/pipeline.py in its host-seeding, megaq, hybrid, reach
and cursor configurations, with the native planner or the Python one.

Stage plan per chunk of reads:
  A. SMEM seeding                  (device/smem.py: native C++ on the
                                    host by default; with
                                    TPUBWA_SEED_MODE=megaq, K2 and K3 on
                                    the device; with =hybrid, a share of
                                    each chunk on K2 and K3 beside the
                                    native seeder; with =reach or
                                    =cursor, K-reach or K-cur and K3)
  B. SA positions                  (in megaq and hybrid's device share,
                                    K-sa on ranks built on the device
                                    inside stage A; else the native
                                    bounded SA walk on the host over an
                                    index with text-position marks, or
                                    the SA walk on the device,
                                    occ.sa_lookup)
  C. chaining + extension planning (native planner,
                                    host/native_emit.py:plan_batch_native;
                                    without it, the native or Python
                                    chainer and host/regions.py's
                                    extension_plan generators)
  D. extension waves on the device (extend_fused.extend_seed_desc_np:
                                    tile gather + the CUDA kernel; the
                                    Python planner's waves through
                                    dispatch.WaveExtender)
  E. region post                   (native planner, or
                                    host/regions.py:sort_dedup_patch)

TPUBWA_NO_NATIVE_PLAN takes the Python planner; TPUBWA_NO_NATIVE takes
every native host stage away (seeding, SA walk, chaining, planning and
emit), so that seeding runs in megaq (K2 and K3) and the SA walk on the
device (K-sa), as in tpubwa.

A scoring matrix that is not bwa_fill_scmat-structured takes tpubwa's
non-descriptor route (tpubwa/device/pipeline.py:296-366): no native
planner and no descriptors, the Python planner's sequence-tile jobs
through ``extend_seed_batch_np`` on K1-mat, where tpubwa runs its host
scalar loops.  ``mem`` builds only bwa_fill_scmat matrices.

With a ``dp`` (``dist.sharding.DataParallel``, tpubwa's mesh mode) the
index is replicated, one ``DeviceIndex`` a replica, and stages A, B and
D split their reads, ranks and jobs over the replicas; the host stages
run once, on what one device would have given them.  With a ``tp``
(``dist.index_tp.TpIndex``, tpubwa's 'tp' mesh axis) megaq's rounds 1+2
and its fused SA walk read an index split into row slabs across
devices, K3, the extension and pac the aligner's whole index.

The regions equal tpubwa's DeviceAligner and the scalar host path
(tests/test_torch_pipeline.py), so pairing, MAPQ and SAM are the host
code (the port's copy of tpubwa's, in ``tpubwa_torch/host``).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np
import torch

from ..dist.index_tp import TpIndex
from ..host import native_emit, native_smem
from ..host.chain import chain_flt, flt_chained_seeds, mem_chain
from ..host.native_emit import (FlatRegs, chain_batch_native,
                                plan_batch_native)
from ..host.native_smem import sa_positions_native
from ..host.pipeline import align1_core
from ..host.regions import AlnReg, extension_plan, sort_dedup_patch
from ..index.fmindex import FMIndex
from ..io.fastq import Read
from ..opts import MemOpt
from ..ref import ksw
from ..utils import serial_pipeline
from .dispatch import WaveExtender
from .extend_fused import extend_seed_desc_np
from .extend_kernel import _mat_ab
from .occ import DeviceIndex, sa_lookup
from .smem import (HybridSplit, collect_intv_device, sa_counts,
                   segment_index)


def resolve_device(device="cuda") -> torch.device:
    """'cuda' (the default) raises when torch sees no card: nothing
    falls back to the CPU.  'cpu' runs the plain versions, and only
    when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no "
                           "CUDA device")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def reset_native_caches() -> None:
    """Forget the host bridges' native libraries (each caches its
    ``dlopen`` in a module global), so that the next call reads
    TPUBWA_NO_NATIVE* again: a switch set mid-process takes effect only
    after this.  The libraries stay built and loaded in ``native``."""
    native_emit._LIB = native_smem._LIB = None
    ksw._NATIVE = None


class DeviceAligner:
    """Seeding (host; megaq, reach or cursor on ``device``; or hybrid),
    SA and planning; extension waves on ``device``.

    The seed mode comes from TPUBWA_SEED_MODE when the aligner is made,
    default ``host``, or ``megaq`` where the native seeder is unavailable
    (TPUBWA_NO_NATIVE, or no build), as in tpubwa; an explicit ``host``
    with no seeder raises at the first chunk.  tpubwa defaults to
    ``hybrid`` on an accelerator (tpubwa/device/pipeline.py:138-148),
    from a reading on its TPU; the port keeps ``host`` until a benchmark
    on the card (ROADMAP [bench]) measures the split against both
    modes.  In ``hybrid`` the aligner
    owns one ``HybridSplit`` for its life (``hybrid``, read from
    TPUBWA_HYBRID_* when it is made); chunks are seeded one at a time on
    the prefetch thread, so it needs no lock.

    With a ``dp`` the devices are its replicas' (``device`` is not
    read): ``didxs`` holds one index a replica, ``didx`` replica 0's for
    the host-side code, and the seed mode defaults to ``megaq``, as in
    tpubwa's mesh mode (one host core cannot feed several devices).

    ``tp`` (a list of devices, or a ``dist.index_tp.TpIndex`` of
    ``fmi``) gives ``self.tp``, the index in row slabs over those
    devices: seed mode megaq (the default under ``tp``, tpubwa's mesh
    default) runs K2 and the fused SA walk on the slabs, each replica's
    under a ``dp`` too; ``didx`` stays whole on the aligner's device for
    K3, the extension and pac, as tpubwa keeps it."""

    def __init__(self, opt: MemOpt, fmi: FMIndex, device="cuda", dp=None,
                 tp=None):
        self.opt = opt
        self.fmi = fmi
        self.mat = opt.scoring_matrix()
        # descriptor extension (and the native planner) only for
        # bwa_fill_scmat matrices, as tpubwa's use_desc
        self.mat_scmat = _mat_ab(self.mat) is not None
        self.dp = dp
        if dp is None:
            self.device = resolve_device(device)
            self.didxs = None
            self.didx = DeviceIndex.from_fmindex(fmi, self.device)
        else:
            self.didxs = dp.replicate_index(fmi)
            self.didx = self.didxs[0]
            self.device = self.didx.device
        self.tp = tp
        if tp is not None and not isinstance(tp, TpIndex):
            self.tp = TpIndex(fmi, tp)
        self.extender = WaveExtender(opt, self.mat, self.device, dp=dp)
        # longer reads go to the scalar path (the kernel's lane bound)
        self.read_len_cap = 510
        # reads per seeding chunk, TPUBWA_CHUNK_READS as tpubwa reads it
        # (tpubwa/device/pipeline.py:159-162); nothing is compiled per
        # shape, so one default serves every batch and seed mode
        self.chunk_reads = int(os.environ.get("TPUBWA_CHUNK_READS", 16384))
        if self.chunk_reads < 1:
            raise ValueError("TPUBWA_CHUNK_READS must be positive, got "
                             f"{self.chunk_reads}")
        # 'host' (native seeding), 'megaq' (K2 + K3 on the device),
        # 'hybrid' (both, split by self.hybrid), 'reach' (K-reach + K3),
        # 'cursor' or 'fused' (K-cur + K3), 'mega' (K2 + K3) or 'split'
        # (K-fwd, K-bwd + K3); device/smem.py raises on any other
        default_mode = "host" if (native_smem._lib() is not None
                                  and dp is None and tp is None) else "megaq"
        self.seed_mode = os.environ.get("TPUBWA_SEED_MODE") or default_mode
        self.hybrid = HybridSplit.from_env()

    # -------------------------------------------------------------
    def _pack(self, reads: Sequence[Read], pad_to: int):
        L = max((r.l_seq for r in reads), default=1)
        Lp = 1
        while Lp < L:
            Lp <<= 1
        Lp = max(Lp, 32)
        arr = np.full((max(len(reads), pad_to), Lp), 4, np.uint8)
        lens = np.zeros(max(len(reads), pad_to), np.int32)
        lens[:len(reads)] = [r.l_seq for r in reads]
        if len(reads) and (lens[:len(reads)] == lens[0]).all():
            # uniform read length: one stack instead of a per-read loop
            arr[:len(reads), :lens[0]] = np.stack([r.seq for r in reads])
        else:
            for i, r in enumerate(reads):
                arr[i, :r.l_seq] = r.seq
        return arr, lens

    def _sa_positions(self, intv):
        """bwa's per-interval subsampling (step = occ/max_occ, at most
        max_occ samples) and the SA walk: the native marked walk on the
        host over an index with text-position marks, else
        ``occ.sa_lookup`` on the device (a stock-bwa index: the
        rank-sampled walk), the ranks uploaded once (under a ``dp``,
        each replica's part of them to it).  Returns flat (pos int64,
        cnt int64) in (read, interval-row) order."""
        flat, _counts = intv
        if not len(flat):
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        if self.opt.max_occ <= 0:    # -c 0: every seed over-occ
            return (np.zeros(0, np.int64),
                    np.zeros(len(flat), np.int64))
        nat = sa_positions_native(self.fmi, flat, self.opt.max_occ,
                                  threads=self.opt.n_threads)
        if nat is not None:
            return nat
        step, cnt = sa_counts(flat[:, 2], self.opt.max_occ)
        ends = np.cumsum(cnt)
        n = int(ends[-1])
        if n == 0:
            return np.zeros(0, np.int64), cnt
        k = np.arange(n, dtype=np.int64) - np.repeat(ends - cnt, cnt)
        ranks = np.repeat(flat[:, 0], cnt) + k * np.repeat(step, cnt)
        ranks = ranks.astype(self.didx.np_idt)

        def walk(i, lo, hi):
            didx = self.didx if self.dp is None else self.didxs[i]
            return sa_lookup(didx, torch.from_numpy(ranks[lo:hi]).to(
                didx.device)).cpu().numpy()

        pos = walk(0, 0, n) if self.dp is None else self.dp.map_rows(
            walk, n, "ranks")
        return pos.astype(np.int64), cnt

    def _sa_merge(self, flat, sa_cnt, sa_pos):
        """The chunk's SA positions from the seeding stage's segments
        (``collect_intv_device(..., return_sa=True)``), walking only the
        rows of cnt -1 through ``_sa_positions``: tpubwa's ``_sa_merge``
        contract (tpubwa/device/pipeline.py:224-258), and the same return
        as ``_sa_positions``.  Where a given count differs from bwa's
        subsampling of its row, or the positions do not fill the counts,
        it raises: nothing is recomputed in their place."""
        _, cnt = sa_counts(flat[:, 2], self.opt.max_occ)
        have = sa_cnt >= 0
        if (not np.array_equal(sa_cnt[have], cnt[have])
                or len(sa_pos) != int(cnt[have].sum())):
            bad = np.flatnonzero(have & (sa_cnt != cnt))
            raise RuntimeError(
                f"fused SA count mismatch: {len(bad)} of {len(flat)} rows "
                f"(first {bad[:3].tolist()}), {len(sa_pos)} positions for "
                f"{int(cnt[have].sum())}")
        if have.all():
            return sa_pos, cnt
        starts = np.cumsum(cnt) - cnt
        pos = np.zeros(int(cnt.sum()), np.int64)
        pos[segment_index(starts[have], cnt[have])] = sa_pos
        need = ~have
        pos[segment_index(starts[need], cnt[need])] = self._sa_positions(
            (flat[need], None))[0]
        return pos, cnt

    # -------------------------------------------------------------
    def _seed_chunk(self, chunk: Sequence[Read]):
        """Seeding + SA positions for one chunk (runs on the prefetch
        thread, overlapping the previous chunk's planning): the seeding
        stage's own positions where it gives them (megaq, hybrid), the
        SA stage for the rest."""
        pad = 32
        while pad < len(chunk):
            pad <<= 1
        arr, lens = self._pack(chunk, pad)
        flat, frid, qd, sa = collect_intv_device(
            self.opt, self._index(), arr, lens, self.fmi,
            mode=self.seed_mode, split=self.hybrid, dp=self.dp,
            return_sa=True, tp=self.tp)
        counts = np.bincount(frid, minlength=arr.shape[0])[:len(chunk)]
        intv = (flat, counts)
        positions = (self._sa_positions(intv) if sa is None
                     else self._sa_merge(flat, *sa))
        # qd: the chunk's reads, resident for the descriptor extension
        # (a list, one a replica, under a dp)
        return intv, positions, qd

    def _index(self):
        """The index the device stages take: the replicas' list under a
        ``dp``, else the one."""
        return self.didx if self.dp is None else self.didxs

    def _chunk_regs(self, chunk, intv_rows, positions, qd):
        """Chaining + planning, device extension waves and region post
        for one chunk: the native planner's FlatRegs, or, without it or
        under a matrix that is not bwa_fill_scmat-structured, per-read
        region lists from the Python planner."""
        opt, fmi, mat = self.opt, self.fmi, self.mat
        ext = self.extender
        use_desc = self.mat_scmat
        if use_desc:
            # on this (the main) thread: the prefetch thread seeds the
            # next chunk meanwhile
            ext.set_chunk_ctx(self._index(), qd, chunk, fmi.bnt)

            def extend_fn(desc):
                return extend_seed_desc_np(
                    self._index(), qd, desc, mat, opt.o_del, opt.e_del,
                    opt.o_ins, opt.e_ins, opt.zdrop, ext.tmax, dp=self.dp)

            planned = plan_batch_native(opt, fmi, chunk, intv_rows,
                                        positions, extend_fn, qmax=ext.qmax,
                                        tmax=ext.tmax, flat=True)
            if planned is not None:
                regs_flat, n_waves, n_jobs = planned
                ext.n_waves += n_waves
                ext.n_jobs += n_jobs
                return regs_flat
        # the Python planner (tpubwa/device/pipeline.py:328-367): chains
        # from the native chainer where it is built, else mem_chain
        chains_per_read = chain_batch_native(opt, fmi, chunk, intv_rows,
                                             positions)
        if chains_per_read is None:
            per_read_intv = _nest_intv(intv_rows)
            nested = _nest_positions(per_read_intv, positions)
        all_regs: List[List[AlnReg]] = []
        plans_by_read = []
        for ri, read in enumerate(chunk):
            if chains_per_read is not None:
                chains = chains_per_read[ri]
            else:
                chains = mem_chain(opt, fmi, read.seq,
                                   intvs=per_read_intv[ri],
                                   positions=nested[ri])
                chains = chain_flt(opt, chains)
                flt_chained_seeds(opt, fmi.bnt, read.l_seq, read.seq,
                                  chains, mat)
            regs: List[AlnReg] = []
            all_regs.append(regs)
            # chains of one read share `regs` and extend in order (the
            # skip test reads earlier regions); reads extend side by
            # side in waves, as descriptors of the resident reads (or
            # as sequence tiles, without descriptors)
            plans_by_read.append([
                extension_plan(opt, fmi.bnt, read.l_seq, read.seq, c,
                               regs, fused=True,
                               read_row=ri if use_desc else -1)
                for c in chains])
        ext.run_fused(_serialize_per_read(plans_by_read))
        out = []
        for read, regs in zip(chunk, all_regs):
            regs = sort_dedup_patch(opt, fmi.bnt, read.seq, regs, mat)
            for r in regs:
                if r.rid >= 0 and fmi.bnt.anns[r.rid].is_alt:
                    r.is_alt = 1
            out.append(regs)
        return out

    def align_batch(self, reads: Sequence[Read]) -> List[List[AlnReg]]:
        if not reads:
            return []
        if max(r.l_seq for r in reads) > self.read_len_cap:
            # route ONLY the oversize reads to the scalar path
            opt, fmi, mat = self.opt, self.fmi, self.mat
            long_idx = {i for i, r in enumerate(reads)
                        if r.l_seq > self.read_len_cap}
            if len(long_idx) == len(reads):
                return [align1_core(opt, fmi, r, mat) for r in reads]
            short = [r for i, r in enumerate(reads) if i not in long_idx]
            short_regs = iter(self.align_batch(short))
            return [align1_core(opt, fmi, r, mat) if i in long_idx
                    else next(short_regs)
                    for i, r in enumerate(reads)]
        ch = self.chunk_reads
        chunks = [reads[s:s + ch] for s in range(0, len(reads), ch)]
        if len(chunks) == 1 or serial_pipeline():
            parts = [self._chunk_regs(c, *self._seed_chunk(c))
                     for c in chunks]
            return parts[0] if len(parts) == 1 else _concat_parts(parts)
        # double buffer: seed chunk i+1 on a worker thread while this
        # thread plans and extends chunk i (the native calls release
        # the GIL)
        parts = []
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(self._seed_chunk, chunks[0])
            for i, chunk in enumerate(chunks):
                rows, positions, qd = fut.result()
                if i + 1 < len(chunks):
                    fut = ex.submit(self._seed_chunk, chunks[i + 1])
                parts.append(self._chunk_regs(chunk, rows, positions, qd))
        return _concat_parts(parts)

    def __call__(self, reads: Sequence[Read]) -> List[List[AlnReg]]:
        return self.align_batch(reads)


def _concat_parts(parts):
    """One batch's regions from its chunks': FlatRegs where every chunk
    was planned natively, else per-read lists."""
    if all(isinstance(p, FlatRegs) for p in parts):
        return FlatRegs.concat(parts)
    out: List[List[AlnReg]] = []
    for p in parts:
        out.extend(list(p) if isinstance(p, FlatRegs) else p)
    return out


def _nest_intv(intv):
    """Flat (rows, per-read counts) -> per-read row arrays (the
    mem_chain contract)."""
    flat, counts = intv
    return np.split(flat, np.cumsum(counts)[:-1])


def _nest_positions(per_read_intv, positions):
    """Flat (pos, cnt) -> per-read lists of per-interval position
    arrays (the mem_chain contract)."""
    pos, cnt = positions
    ends = np.cumsum(cnt)
    out = []
    ii = 0
    for rows in per_read_intv:
        per = []
        for _ in range(len(rows)):
            per.append(pos[int(ends[ii] - cnt[ii]):int(ends[ii])])
            ii += 1
        out.append(per)
    return out


def _serialize_per_read(plans_by_read):
    """One generator a read that runs its chains' plans one after
    another, passing each result to the plan that asked for it."""
    def chain_gens(gens):
        for g in gens:
            try:
                job = next(g)
                while True:
                    result = yield job
                    job = g.send(result)
            except StopIteration:
                continue
    return [chain_gens(gens) for gens in plans_by_read if gens]


def make_device_aligner(opt: MemOpt, fmi: FMIndex, device="cuda",
                        dp=None, tp=None) -> DeviceAligner:
    return DeviceAligner(opt, fmi, device=device, dp=dp, tp=tp)
