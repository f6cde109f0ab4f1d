"""Per-batch aligner with GPU seed extension, the counterpart of
tpubwa/device/pipeline.py in its host-seeding, megaq and hybrid
configurations.

Stage plan per chunk of reads:
  A. SMEM seeding                  (device/smem.py: native C++ on the
                                    host by default; with
                                    TPUBWA_SEED_MODE=megaq, K2 and K3 on
                                    the device; with =hybrid, a share of
                                    each chunk on K2 and K3 beside the
                                    native seeder)
  B. SA positions                  (native bounded SA walk on the host
                                    over an index with text-position
                                    marks; else the SA walk on the
                                    device, occ.sa_lookup)
  C. chaining + extension planning (native planner,
                                    host/native_emit.py:plan_batch_native)
  D. extension waves on the device (extend_fused.extend_seed_desc_np:
                                    tile gather + the CUDA kernel)
  E. region post                   (native planner)

The regions equal tpubwa's DeviceAligner and the scalar host path
(tests/test_torch_pipeline.py), so pairing, MAPQ and SAM are the host
code (the port's copy of tpubwa's, in ``tpubwa_torch/host``).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from ..host.native_emit import FlatRegs, plan_batch_native
from ..host.native_smem import sa_positions_native
from ..host.pipeline import align1_core
from ..host.regions import AlnReg
from ..index.fmindex import FMIndex
from ..io.fastq import Read
from ..opts import MemOpt
from ..utils import serial_pipeline
from .extend_fused import extend_seed_desc_np
from .extend_kernel import LANES, _mat_ab
from .occ import DeviceIndex, sa_lookup
from .smem import HybridSplit, collect_intv_device


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


@dataclass
class ExtendStats:
    """Extension limits handed to the planner, and the wave/job counts
    that bench.py-style callers read through ``aligner.extender``."""
    qmax: int = LANES - 1     # longest side the kernel takes (510 bp)
    tmax: int = 1024          # longest reference window
    n_waves: int = 0
    n_jobs: int = 0


class DeviceAligner:
    """Seeding (host, megaq on ``device``, or hybrid), SA and planning;
    extension waves on ``device``.

    The seed mode comes from TPUBWA_SEED_MODE when the aligner is made,
    default ``host``.  tpubwa defaults to ``hybrid`` on an accelerator
    (tpubwa/device/pipeline.py:138-148), from a reading on its TPU; the
    port keeps ``host`` until a benchmark on the card (ROADMAP [bench])
    measures the split against both modes.  In ``hybrid`` the aligner
    owns one ``HybridSplit`` for its life (``hybrid``, read from
    TPUBWA_HYBRID_* when it is made); chunks are seeded one at a time on
    the prefetch thread, so it needs no lock."""

    def __init__(self, opt: MemOpt, fmi: FMIndex, device="cuda"):
        self.opt = opt
        self.fmi = fmi
        self.mat = opt.scoring_matrix()
        if _mat_ab(self.mat) is None:
            raise NotImplementedError(
                "a scoring matrix that is not bwa_fill_scmat-structured "
                "needs the Python planner and WaveExtender (ROADMAP "
                "Queue 1 [waves])")
        self.device = resolve_device(device)
        self.didx = DeviceIndex.from_fmindex(fmi, self.device)
        self.extender = ExtendStats()
        # longer reads go to the scalar path (the kernel's lane bound)
        self.read_len_cap = 510
        # reads per seeding chunk (nothing is compiled per shape, so one
        # size serves every batch and both seed modes)
        self.chunk_reads = 16384
        # 'host' (native seeding), 'megaq' (K2 + K3 on the device) or
        # 'hybrid' (both, split by self.hybrid); device/smem.py raises
        # on the others
        self.seed_mode = os.environ.get("TPUBWA_SEED_MODE", "host")
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
        rank-sampled walk), the ranks uploaded once.  Returns flat
        (pos int64, cnt int64) in (read, interval-row) order."""
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
        size = flat[:, 2]
        step = np.where(size > self.opt.max_occ, size // self.opt.max_occ, 1)
        cnt = np.minimum((size + step - 1) // step, self.opt.max_occ)
        ends = np.cumsum(cnt)
        n = int(ends[-1])
        if n == 0:
            return np.zeros(0, np.int64), cnt
        k = np.arange(n, dtype=np.int64) - np.repeat(ends - cnt, cnt)
        ranks = np.repeat(flat[:, 0], cnt) + k * np.repeat(step, cnt)
        pos = sa_lookup(self.didx, torch.from_numpy(ranks.astype(
            self.didx.np_idt)).to(self.device))
        return pos.cpu().numpy().astype(np.int64), cnt

    # -------------------------------------------------------------
    def _seed_chunk(self, chunk: Sequence[Read]):
        """Seeding + SA positions for one chunk (runs on the prefetch
        thread, overlapping the previous chunk's planning)."""
        pad = 32
        while pad < len(chunk):
            pad <<= 1
        arr, lens = self._pack(chunk, pad)
        flat, frid, qd = collect_intv_device(self.opt, self.didx, arr,
                                             lens, self.fmi,
                                             mode=self.seed_mode,
                                             split=self.hybrid)
        counts = np.bincount(frid, minlength=arr.shape[0])[:len(chunk)]
        intv = (flat, counts)
        # qd: the chunk's reads, resident for the descriptor extension
        return intv, self._sa_positions(intv), qd

    def _chunk_regs(self, chunk, intv_rows, positions, qd):
        """Native chaining + planning, device extension waves, native
        region post for one chunk; returns FlatRegs."""
        opt = self.opt
        ext = self.extender

        def extend_fn(desc):
            return extend_seed_desc_np(
                self.didx, qd, desc, self.mat, opt.o_del, opt.e_del,
                opt.o_ins, opt.e_ins, opt.zdrop, ext.tmax)

        planned = plan_batch_native(opt, self.fmi, chunk, intv_rows,
                                    positions, extend_fn, qmax=ext.qmax,
                                    tmax=ext.tmax, flat=True)
        if planned is None:
            raise NotImplementedError(
                "the native planner is unavailable (TPUBWA_NO_NATIVE_PLAN "
                "or no tpubwa_torch/native build); the Python planner with "
                "WaveExtender is ROADMAP Queue 1 [waves]")
        regs_flat, n_waves, n_jobs = planned
        ext.n_waves += n_waves
        ext.n_jobs += n_jobs
        return regs_flat

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
            return parts[0] if len(parts) == 1 else FlatRegs.concat(parts)
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
        return FlatRegs.concat(parts)

    def __call__(self, reads: Sequence[Read]) -> List[List[AlnReg]]:
        return self.align_batch(reads)


def make_device_aligner(opt: MemOpt, fmi: FMIndex,
                        device="cuda") -> DeviceAligner:
    return DeviceAligner(opt, fmi, device=device)
