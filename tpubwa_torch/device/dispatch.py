"""Extension-wave dispatch: gather -> batch -> kernel -> scatter
(SURVEY.md §2 row 17, §3.4), the counterpart of tpubwa/device/dispatch.py.

Every read's mem_chain2aln logic runs as a host-side generator
(host/regions.py:extension_plan); this module advances all generators
in lockstep waves.

Fused (``run_fused``, the ``DeviceAligner``'s): each wave collects one
pending per-seed job per plan (``extension_plan(fused=True)``) and runs
it on the device as one batch: descriptor jobs ('D', the tiles gathered
on the device from the chunk's resident reads and the pac) through
``extend_seed_desc_np``, sequence-tile jobs through
``extend_seed_batch_np``; both are ``_fused_passes``' four launches of
the extension kernel.  The left -> right h0 dependency and the band
retries live inside a job, so one wave is one round of every read's
seeds.

Plain (``run``, tpubwa's ``fused=False``): each wave collects one
pending per-side job (qlen, q, tlen, t, w, end_bonus, h0) per plan
(``extension_plan()``) and runs them in blocks of 512 through
``extend_kernel.extend_batch_kernel_np`` on ``device`` (K1, or K1-mat
for a matrix that is not bwa_fill_scmat-structured).  The band retries
and the left -> right dependency are successive waves.

A job longer than the kernel takes (``qmax``, ``tmax``) runs tpubwa's
scalar loops inline, counted in ``n_fallback``: the kernel is never
tried on it.  With a ``dp`` (``dist.sharding.DataParallel``, tpubwa's
``mesh``) the fused waves split each wave's jobs over its replicas; the
plain ones run on ``device``, as tpubwa's take no mesh.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..opts import MemOpt
from ..ref.ksw import KswExt, ksw_extend
from .extend_fused import (extend_seed_batch_np, extend_seed_desc_np,
                           scalar_fused)
from .extend_kernel import LANES, extend_batch_kernel_np

# jobs a launch group of the plain waves (tpubwa's block)
BLOCK = 512


class WaveExtender:
    """Drives extension_plan generators to completion in batched waves
    on ``device``: per-seed jobs (``run_fused``) or per-side ones
    (``run``).  ``n_waves``, ``n_jobs`` and ``n_fallback`` count the
    waves, the jobs they ran and the jobs that took the scalar loops.
    ``qmax``/``tmax`` are also the limits that the native planner is
    given (device/pipeline.py).  With a ``dp`` the fused waves are split
    over its replicas."""

    def __init__(self, opt: MemOpt, mat: np.ndarray, device,
                 qmax: int = LANES - 1, tmax: int = 1024, dp=None):
        self.opt = opt
        self.dp = dp
        self.mat = np.asarray(mat, np.int32)
        self.device = device
        self.qmax = qmax
        self.tmax = tmax
        self.n_waves = 0
        self.n_jobs = 0
        self.n_fallback = 0
        self.ctx = None

    def _pen(self):
        o = self.opt
        return (self.mat, o.o_del, o.e_del, o.o_ins, o.e_ins, o.zdrop)

    def _scalar(self, job) -> KswExt:
        qlen, q, tlen, t, w, eb, h0 = job
        self.n_fallback += 1
        o = self.opt
        return ksw_extend(qlen, q, tlen, t, self.mat, o.o_del, o.e_del,
                          o.o_ins, o.e_ins, w, eb, o.zdrop, h0)

    def _scalar_fused(self, job) -> np.ndarray:
        self.n_fallback += 1
        if job[0] == 'D':
            job = self._materialize(job)
        return scalar_fused(job, *self._pen())

    # ---- descriptor mode (tiles built on the device from resident data)
    def set_chunk_ctx(self, didx, qd, reads, bnt) -> None:
        """The chunk whose descriptors the next waves run: the index,
        its reads on the device (``qd``, uint8 [B, L]) and on the host,
        and the reference for ``_materialize``; under a ``dp``, ``didx``
        and ``qd`` are lists, one a replica."""
        self.ctx = (didx, qd, reads, bnt)

    def _materialize(self, job):
        """Rebuild the sequence-tile job for a descriptor (an oversize
        one, for the scalar loops): the same slices the planner yields
        without descriptors."""
        _, ri, qbeg, slen, lq, rbeg, rmax0, rmax1, w0, h0, p5, p3 = job
        _, _, reads, bnt = self.ctx
        query = reads[ri].seq
        qe = qbeg + slen
        qlen_r = lq - qe
        empty = query[:0]
        if qbeg:
            qs = query[:qbeg][::-1].copy()
            tlen_l = rbeg - rmax0
            ts = bnt.get_seq(rmax0, rbeg)[::-1].copy()
        else:
            qs, tlen_l, ts = empty, 0, empty
        if qlen_r:
            tlen_r = rmax1 - rbeg - slen
            tr = bnt.get_seq(rbeg + slen, rmax1)
        else:
            tlen_r, tr = 0, empty
        return (qbeg, qs, tlen_l, ts, qlen_r, query[qe:], tlen_r, tr,
                w0, h0, p5, p3)

    def _oversize(self, job) -> bool:
        if job[0] == 'D':
            _, ri, qbeg, slen, lq, rbeg, rmax0, rmax1 = job[:8]
            qlen_r = lq - qbeg - slen
            tlen_l = rbeg - rmax0 if qbeg else 0
            tlen_r = rmax1 - rbeg - slen if qlen_r else 0
            return (qbeg > self.qmax or qlen_r > self.qmax
                    or tlen_l > self.tmax or tlen_r > self.tmax)
        return (job[0] > self.qmax or job[2] > self.tmax
                or job[4] > self.qmax or job[6] > self.tmax)

    def run_fused(self, plans: List) -> None:
        """plans: generators from extension_plan(fused=True); one job
        per seed, one device batch per wave."""
        live = []
        for g in plans:
            try:
                live.append([g, next(g)])
            except StopIteration:
                pass
        while live:
            for ent in live:
                job = ent[1]
                while job is not None and self._oversize(job):
                    try:
                        job = ent[0].send(self._scalar_fused(job))
                    except StopIteration:
                        job = None
                ent[1] = job
            live = [e for e in live if e[1] is not None]
            if not live:
                break
            self.n_waves += 1
            self.n_jobs += len(live)
            jobs = [e[1] for e in live]
            if jobs[0][0] == 'D':
                didx, qd = self.ctx[0], self.ctx[1]
                rows = extend_seed_desc_np(didx, qd, jobs, *self._pen(),
                                           self.tmax, dp=self.dp)
            else:
                rows = extend_seed_batch_np(jobs, *self._pen(), self.tmax,
                                            self.device, dp=self.dp)
            nxt = []
            for i, ent in enumerate(live):
                try:
                    ent[1] = ent[0].send(rows[i])
                    nxt.append(ent)
                except StopIteration:
                    pass
            live = nxt

    def run(self, plans: List) -> None:
        """plans: generators from extension_plan() (they append to
        their regions); one job per side, blocks of ``BLOCK`` jobs."""
        live = []
        for g in plans:
            try:
                live.append([g, next(g)])
            except StopIteration:
                pass
        while live:
            # oversize jobs take the scalar loops inline
            for ent in live:
                job = ent[1]
                while job is not None and (job[0] > self.qmax
                                           or job[2] > self.tmax):
                    try:
                        job = ent[0].send(self._scalar(job))
                    except StopIteration:
                        job = None
                ent[1] = job
            live = [e for e in live if e[1] is not None]
            if not live:
                break
            jobs = [dict(q=e[1][1][:e[1][0]], t=e[1][3][:e[1][2]],
                         w=e[1][4], end_bonus=e[1][5], h0=e[1][6])
                    for e in live]
            self.n_waves += 1
            self.n_jobs += len(jobs)
            parts = [extend_batch_kernel_np(jobs[s:s + BLOCK], *self._pen(),
                                            self.qmax, self.tmax,
                                            device=self.device)
                     for s in range(0, len(jobs), BLOCK)]
            res = [np.concatenate([p[k] for p in parts]) for k in range(6)]
            nxt = []
            for i, ent in enumerate(live):
                r = KswExt(*(int(x[i]) for x in res))
                try:
                    ent[1] = ent[0].send(r)
                    nxt.append(ent)
                except StopIteration:
                    pass
            live = nxt
