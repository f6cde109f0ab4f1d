"""Batched SMEM seeding for a read chunk, the counterpart of
tpubwa/device/smem.py:collect_intv_device.

Eight modes:

* ``host``: the native C++ seeder (tpubwa_torch/host/native_smem.py)
  runs the full 3-round mem_collect_intv protocol on the host, and the
  chunk's reads go up to the device once for the descriptor extension;
* ``megaq``: the three rounds on the device, rounds 1 and 2 in K2
  (``smem_fused.rounds12_megaq``) and round 3 in K3
  (``_seed_strategy_scan``), both hand-written CUDA in ``csrc/smem.cu``
  on CUDA tensors and their plain versions on CPU tensors.  Every row
  comes from them; the host only merges;
* ``hybrid``: the chunk's first k reads in megaq on a worker thread
  while the calling thread seeds the rest in native C++, k set each
  chunk by ``HybridSplit`` (tpubwa's equal-wall balancer);
* ``reach``: tpubwa's all-starts formulation (smem.py:133-194, 710-728):
  round 1 is the rightmost reach of every (read, start) in one K-reach
  launch (``rightmost_reach_all``), an SMEM wherever the reach grows;
  round 2 expands each re-seeding job (read, x, min_intv) into its
  starts 0..x, all jobs in one K-reach launch; round 3 in K3.  The posts
  are tensor ops on the reads' device;
* ``cursor``: tpubwa's bwt_smem1a job machine (``_rounds12_cursor``,
  smem.py:275-327): round 1 a job a read and round 2 a one-shot job a
  re-seeded row, each round one K-cur launch (``smem_cursor.
  run_smem_jobs``, a second for jobs past their row slots); round 3 in
  K3;
* ``mega``, ``fused`` and ``split``: tpubwa's machine modes, each the
  function of a kernel above scheduled another way on the TPU (the
  seeding output has one order, the merge's): mega's smem_chunk_machine
  runs rounds 1+2 a read in one dispatch, K2's function (``smem_fused.
  rounds12_megaq``); fused's smem_call_machine runs bwt_smem1a a job,
  one dispatch a round, mode cursor's protocol over K-cur; split's two
  machines run bwt_smem1a's forward passes, then the backward pass of
  each call they record: K-fwd and K-bwd (``smem_split.
  rounds12_split``), mode cursor's protocol over K-cur cut at its stack.
  Round 3 in K3.

With ``return_sa`` megaq also gives each row's SA positions, walked on
the device before the one copy to the host (tpubwa's fused SA,
smem_fused.py:_sa_from_rows): the ranks of bwa's subsampling are built
from K2's rows and K3's hits on the card (``sa_ranks``) and K-sa
(``occ.sa_lookup``) walks them.  In hybrid the host share's rows get
the native walk's positions, or -1 counts where the index has no marks.
The other device modes fuse no SA walk (tpubwa's ``sa_cnt12`` is None
there): the caller walks every row.

Over a ``DataParallel`` (``dp``), the device modes split the reads they
seed over the replicas (in hybrid, the device share's), each replica
holding the whole chunk for the extension, and host mode uploads the
reads to each.

Over an index split into row slabs (``tp``, a ``dist/index_tp.py:
TpIndex``; tpubwa's 'tp' mesh axis), megaq runs K2 and the fused SA walk
on the slabs and K3 on the whole index, as tpubwa seeds its rounds 1+2
on the shards and scans round 3 on the replicated index; the other
modes ignore ``tp``, as tpubwa's do.
"""

from __future__ import annotations

import ctypes
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from ..host.native_smem import (sa_positions_native,
                                smem_collect_batch_native)
from . import _build, smem_split
from .counts import bump
from .occ import (DeviceIndex, _kernel_route, _raise_on, bwt_extend_plain,
                  sa_lookup, set_intv)
from .occ import _SIGNATURES as _OCC_SIGNATURES
from .smem_cursor import rounds12_jobs, run_smem_jobs
from .smem_fused import (_SIGNATURES, base_intervals, check_reads,
                         index_args, read_lists, reseed_jobs, rounds12_megaq,
                         run_reads, stream_of)


def _reach_codes(q: torch.Tensor) -> torch.Tensor:
    """Read codes as K-reach takes them: uint8, anything outside 0-3 as
    4 (N)."""
    if q.dtype == torch.uint8:
        return q.contiguous()
    return torch.where((q < 0) | (q > 3), 4, q).to(torch.uint8).contiguous()


def rightmost_reach_plain(didx: DeviceIndex, q: torch.Tensor,
                          lens: torch.Tensor, read_idx: torch.Tensor,
                          starts: torch.Tensor, min_intv: torch.Tensor,
                          stats=None):
    """``rightmost_reach``'s contract in PyTorch ops: every live job one
    forward ``bwt_extend_plain`` a step, until none is left.  A ``stats``
    dict gets ``steps`` (int64 [n], the extensions a job made),
    ``occ_rows`` (the occ rows their occ4 queries read) and ``rounds``
    (the steps of the longest job)."""
    dt = didx.idt
    dev = q.device
    qc = _reach_codes(q).long()
    B, L = qc.shape
    ri = read_idx.long()
    b = starts.to(dt)
    jl = lens.long()[ri].to(dt)
    mi = min_intv.to(dt)

    def base_at(pos, rows):
        return qc[rows, torch.clamp(pos, 0, L - 1).long()].to(dt)

    c0 = base_at(b, ri)
    valid0 = (c0 <= 3) & (b < jl)
    ik = set_intv(didx, torch.where(valid0, c0, 0)).to(dt)
    live = valid0 & (ik[:, 2] >= mi)
    e = torch.where(live, b + 1, b)
    steps = torch.zeros(len(b), dtype=torch.int64, device=dev)
    rows = []
    t = 1
    idx = live.nonzero()[:, 0]
    while len(idx):
        pos = b[idx] + t
        c = base_at(pos, ri[idx])
        can = (pos < jl[idx]) & (c <= 3)
        idx, pos, c = idx[can], pos[can], c[can]
        if not len(idx):
            break
        st = {} if stats is not None else None
        ok = bwt_extend_plain(didx, ik[idx], False, stats=st)
        if st is not None:
            rows.append(st["occ_rows"])
        steps[idx] += 1
        nik = ok[torch.arange(len(idx), device=dev), (3 - c).long()]
        good = nik[:, 2] >= mi[idx]
        idx, pos, nik = idx[good], pos[good], nik[good]
        ik[idx] = nik
        e[idx] = pos + 1
        t += 1
    if stats is not None:
        stats["steps"] = steps
        stats["occ_rows"] = (torch.cat(rows) if rows else
                             torch.zeros(0, dtype=torch.int64, device=dev))
        stats["rounds"] = int(steps.max()) if len(steps) else 0
    return ik, e


def _reach_check(didx: DeviceIndex, q, lens, read_idx, starts, min_intv):
    """Raise unless the jobs lie in K-reach's domain."""
    if q.dim() != 2 or not q.shape[1]:
        raise ValueError(f"q must be [B, L >= 1], got {tuple(q.shape)}")
    n = len(read_idx)
    for name, x, dt in (("lens", lens, torch.int32),
                        ("read_idx", read_idx, torch.int32),
                        ("starts", starts, torch.int32),
                        ("min_intv", min_intv, didx.idt)):
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if x.device != didx.device or x.dim() != 1:
            raise ValueError(f"{name} must be 1-D on {didx.device}")
        if name != "lens" and len(x) != n:
            raise ValueError(f"{name} has {len(x)} jobs, read_idx {n}")
    if q.device != didx.device:
        raise ValueError(f"q is on {q.device}, the index on {didx.device}")
    if len(lens) != q.shape[0]:
        raise ValueError(f"{len(lens)} lens for {q.shape[0]} reads")
    if n and not bool(((read_idx >= 0) & (read_idx < q.shape[0])).all()):
        raise ValueError("read_idx outside the reads")


def rightmost_reach(didx: DeviceIndex, q: torch.Tensor, lens: torch.Tensor,
                    read_idx: torch.Tensor, starts: torch.Tensor,
                    min_intv: torch.Tensor):
    """tpubwa's ``_rightmost_reach`` (smem.py:62): for each job (a read of
    q, a start, a min_intv) the rightmost forward extension of
    ``q[read, start:]`` whose interval keeps size >= min_intv.  q
    uint8 or int32 [B, L] (codes 0-3; anything else is N), lens int32
    [B], read_idx and starts int32 [n], min_intv idt [n], all on the
    index's device.  Returns (ik idt [n, 3], the last interval taken: the
    first base's where it fails at once; e idt [n], the match's end, e
    == start where the first base fails).  CPU tensors run
    ``rightmost_reach_plain``; CUDA tensors launch csrc/occ.cu's K-reach
    (``rightmost_reach.launches``), which runs the jobs of a read that
    follow one another (``reach_jobs``' order) right to left, each from
    its neighbour's interval by one backward extension where it can."""
    _reach_check(didx, q, lens, read_idx, starts, min_intv)
    if not _kernel_route(q):
        return rightmost_reach_plain(didx, q, lens, read_idx, starts,
                                     min_intv)
    n = len(read_idx)
    ik = torch.empty((n, 3), dtype=didx.idt, device=q.device)
    e = torch.empty(n, dtype=didx.idt, device=q.device)
    if not n:
        return ik, e
    lib = _build.load("occ", _OCC_SIGNATURES)
    qc = _reach_codes(q)
    fm = didx.upload_fm()
    parts = [x.contiguous() for x in (lens, read_idx, starts, min_intv)]
    queue = torch.empty(1, dtype=torch.int64, device=q.device)
    rc = lib.tpubwa_rightmost_reach(
        fm["occ_blocks"].data_ptr(), fm["L2"].data_ptr(), didx.primary,
        didx.seq_len, int(didx.idt == torch.int64), qc.data_ptr(),
        qc.shape[1], *(x.data_ptr() for x in parts), ik.data_ptr(),
        e.data_ptr(), n, queue.data_ptr(), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "rightmost_reach")
    bump(rightmost_reach)
    return ik, e


rightmost_reach.launches = 0


def reach_jobs(B: int, L: int, idt, device):
    """The job arrays of every (read, start) of B reads of L columns
    (tpubwa's ``_rightmost_reach_all``, smem.py:48): read_idx and starts
    int32 [B * L], read-major, and min_intv ``idt`` ones."""
    read_idx = torch.arange(B, dtype=torch.int32,
                            device=device).repeat_interleave(L)
    starts = torch.arange(L, dtype=torch.int32, device=device).repeat(B)
    min_intv = torch.ones(B * L, dtype=idt, device=device)
    return read_idx, starts, min_intv


def rightmost_reach_all(didx: DeviceIndex, q: torch.Tensor,
                        lens: torch.Tensor):
    """tpubwa's ``_rightmost_reach_all`` (smem.py:48): ``reach_jobs``
    of q [B, L], built on q's device."""
    return rightmost_reach(didx, q, lens,
                           *reach_jobs(*q.shape, didx.idt, q.device))


def reach_round1(didx: DeviceIndex, qd: torch.Tensor, ld: torch.Tensor,
                 min_seed_len: int):
    """Round 1 of mode reach (tpubwa's smems_round1, smem.py:133) as
    tensors on the reads' device: one K-reach launch over every (read,
    start) of reads uint8 [B, L], lens int32 [B]; a start b below its
    read's length is an SMEM [b, e) where e > b, b == 0 or e(b - 1) <
    e(b), and e - b >= min_seed_len.  Returns (rows idt [n, 5] (x0, x1,
    size, qb, qe), rids int64 [n]), read-major, by start."""
    B, L = check_reads(didx, qd, ld)
    ik, e = rightmost_reach_all(didx, qd, ld)
    ik, e = ik.view(B, L, 3), e.view(B, L)
    b = torch.arange(L, dtype=e.dtype, device=e.device)
    is_smem = (b < ld[:, None]) & (e > b) & (e - b >= min_seed_len)
    is_smem[:, 1:] &= e[:, :-1] < e[:, 1:]
    r, s = is_smem.nonzero(as_tuple=True)
    return torch.cat([ik[r, s], b[s, None], e[r, s, None]], 1), r


def reseed_starts(rid: torch.Tensor, x: torch.Tensor,
                  min_intv: torch.Tensor):
    """Round 2's K-reach jobs in mode reach: each job (rid, x, min_intv)
    expanded into its starts 0..x, job after job, on the jobs' device.
    Returns (read_idx int32, starts int32, min_intv, job int64), [sum of
    x + 1] each."""
    nb = x.long() + 1
    total = int(nb.sum())
    job = torch.repeat_interleave(torch.arange(len(rid), device=rid.device),
                                  nb, output_size=total)
    starts = (torch.arange(total, device=rid.device)
              - (torch.cumsum(nb, 0) - nb)[job])
    return rid[job], starts.int(), min_intv[job], job


def reach_reseed(didx: DeviceIndex, qd: torch.Tensor, ld: torch.Tensor,
                 rid: torch.Tensor, x: torch.Tensor, min_intv: torch.Tensor,
                 min_seed_len: int):
    """Round 2 of mode reach (tpubwa's smems_reseed, smem.py:162) as
    tensors on the reads' device: each job (rid int32, x int32, min_intv
    idt, [m] each) expanded into its starts 0..x, all jobs in one
    K-reach launch (none where there is no job).  A start b of a job is
    an SMEM [b, e) where e covers x (e >= x + 1), e > b, b == 0 or the
    job's start b - 1 does not cover x or reaches less (e(b - 1) <
    e(b)), and e - b >= min_seed_len.  Returns (rows idt [n, 5], jobs
    int64 [n], the job of each row), job-major, by start."""
    check_reads(didx, qd, ld)
    if not len(rid):
        return (torch.zeros((0, 5), dtype=didx.idt, device=qd.device),
                torch.zeros(0, dtype=torch.int64, device=qd.device))
    read_idx, starts, job_mi, job = reseed_starts(rid, x, min_intv)
    ik, e = rightmost_reach(didx, qd, ld, read_idx, starts, job_mi)
    b = starts.to(e.dtype)
    valid = e >= x[job].to(e.dtype) + 1
    is_smem = valid & (e > b) & (e - b >= min_seed_len)
    is_smem[1:] &= (b[1:] == 0) | ~valid[:-1] | (e[:-1] < e[1:])
    at = is_smem.nonzero()[:, 0]
    return torch.cat([ik[at], b[at, None], e[at, None]], 1), job[at]


# tpubwa's two reach functions under its names and return contract, for
# code written against them; mode reach itself keeps its rows on the
# device (reach_round1, reach_reseed), and no path of the port calls these
def smems_round1(didx: DeviceIndex, qd: torch.Tensor, ld: torch.Tensor,
                 min_seed_len: int):
    """tpubwa's ``smems_round1`` (smem.py:133): every read's round-1
    SMEMs, one int64 [n, 5] numpy array (x0, x1, size, qb, qe) a read, by
    start (``reach_round1``)."""
    rows, rids = reach_round1(didx, qd, ld, min_seed_len)
    counts = torch.bincount(rids, minlength=len(ld)).tolist()
    return [r.numpy() for r in rows.long().cpu().split(counts)]


def smems_reseed(didx: DeviceIndex, qd: torch.Tensor, ld: torch.Tensor,
                 jobs, min_seed_len: int):
    """tpubwa's ``smems_reseed`` (smem.py:162): jobs = [(read, x,
    min_intv)] -> [(read, rows int64 [n, 5])], a pair a job, its maximal
    matches covering x with interval size >= min_intv
    (``reach_reseed``)."""
    if not jobs:
        return []
    rid, x, mi = zip(*jobs)
    dev = qd.device
    rows, job = reach_reseed(
        didx, qd, ld, torch.tensor(rid, dtype=torch.int32, device=dev),
        torch.tensor(x, dtype=torch.int32, device=dev),
        torch.tensor(mi, dtype=didx.idt, device=dev), min_seed_len)
    counts = torch.bincount(job, minlength=len(jobs)).tolist()
    return [(int(r), part.numpy()) for r, part in zip(
        rid, rows.long().cpu().split(counts))]


def _rounds12_reach(opt, didx: DeviceIndex, qd: torch.Tensor,
                    ld: torch.Tensor):
    """Rounds 1 and 2 of mode reach: (rows idt [n, 5], rids int64 [n]),
    every round-1 row (read-major), then every round-2 row (job by job),
    tpubwa's block order."""
    rows1, rids1 = reach_round1(didx, qd, ld, opt.min_seed_len)
    rid, x, mi = reseed_jobs(opt, rows1, rids1)
    rows2, job = reach_reseed(didx, qd, ld, rid, x, mi, opt.min_seed_len)
    return torch.cat([rows1, rows2]), torch.cat([rids1, rid.long()[job]])


def _rounds12_cursor(opt, didx: DeviceIndex, qd: torch.Tensor,
                     ld: torch.Tensor):
    """Rounds 1 and 2 of modes cursor and fused (tpubwa/device/smem.py:275,
    smem_fused.py:1616): the job protocol (``smem_cursor.rounds12_jobs``)
    over K-cur (``run_smem_jobs``).  Returns (rows idt [n, 5], rids int64
    [n]): round 1's rows (read-major), then round 2's (job by job)."""
    return rounds12_jobs(opt, didx, qd, ld, run_smem_jobs)


def _rounds12_mega(opt, didx: DeviceIndex, qd: torch.Tensor,
                   ld: torch.Tensor):
    """Rounds 1 and 2 of mode mega (tpubwa/device/smem_fused.py:1505, one
    dispatch for both rounds, round 2's jobs built on the device): K2
    (``rounds12_megaq`` on the flat index).  Returns (rows idt [n, 5],
    rids int64 [n]), read-major, each read's round 1 then its round 2."""
    return rounds12_megaq(opt, didx, qd, ld)


def _rounds12_split(opt, didx: DeviceIndex, qd: torch.Tensor,
                    ld: torch.Tensor):
    """Rounds 1 and 2 of mode split (tpubwa/device/smem_split.py:453):
    the job protocol over K-fwd, then K-bwd over every call it recorded
    (``smem_split.rounds12_split``)."""
    return smem_split.rounds12_split(opt, didx, qd, ld)


# the device modes other than megaq: their rounds 1 and 2 (tpubwa's
# mega, fused and split schedule the same function as K2, K-cur and K-cur
# cut at its stack)
_ROUNDS12 = {"reach": _rounds12_reach, "cursor": _rounds12_cursor,
             "mega": _rounds12_mega, "fused": _rounds12_cursor,
             "split": _rounds12_split}


def max_hits(L: int, min_len: int) -> int:
    """K3's hit slots a read (tpubwa/device/smem.py:209): a hit spans at
    least min_len + 1 bases and the next starts past it, so a read of at
    most L bases has fewer."""
    return L // max(int(min_len), 1) + 1


def seed_strategy1_plain(base, q, x: int, min_len: int, max_intv: int):
    """bwt_seed_strategy1 (ref/smem.py:seed_strategy1), a generator over
    ``smem_fused.run_reads``: (the next x, the row [x0, x1, size, qb, qe]
    or None, the bwt_extend calls the scan made)."""
    if q[x] > 3:
        return x + 1, None, 0
    ik = base[q[x]]
    for i in range(x + 1, len(q)):
        if q[i] > 3:
            return i + 1, None, i - x - 1
        ok = yield (ik, 3 - q[i], False)
        if ok[2] < max_intv and i - x >= min_len:
            return i + 1, [*ok, x, i + 1], i - x
        ik = ok
    return len(q), None, len(q) - x - 1


def seed_strategy_read(base, q, min_len: int, max_intv: int):
    """Round 3 of one read (native/smem.cpp:486-497), a generator over
    ``smem_fused.run_reads``: (its hit rows in query order, the most
    bwt_extend calls of one scan)."""
    hits, longest = [], 0
    x = 0
    while x < len(q):
        if q[x] > 3:
            x += 1
            continue
        x, m, steps = yield from seed_strategy1_plain(base, q, x, min_len,
                                                      max_intv)
        longest = max(longest, steps)
        if m is not None and m[2] > 0:
            hits.append(m)
    return hits, longest


def _seed_strategy_scan_plain(didx: DeviceIndex, qd: torch.Tensor,
                              ld: torch.Tensor, min_len: int, max_intv: int,
                              stats=None):
    """K3's contract, read by read: (hits idt [B, maxh, 5], zero past
    each read's n_hits, n_hits int32 [B]).  A ``stats`` dict gets
    ``steps`` (int32 [B], the bwt_extend calls a read), ``chain`` (the
    rounds of dependent steps a read's group of lanes makes in K3: one a
    step) and ``longest`` (the most steps of one bwt_seed_strategy1
    call in the read)."""
    B, L = check_reads(didx, qd, ld)
    base = base_intervals(didx)
    got, steps = run_reads(didx, [
        seed_strategy_read(base, q, min_len, max_intv)
        for q in read_lists(qd, ld)])
    hits = np.zeros((B, max_hits(L, min_len), 5), np.int64)
    for r, (rows, _) in enumerate(got):
        hits[r, :len(rows)] = np.asarray(rows, np.int64).reshape(-1, 5)
    if stats is not None:
        stats["steps"] = torch.tensor(steps, dtype=torch.int32)
        stats["chain"] = stats["steps"].clone()
        stats["longest"] = torch.tensor([g[1] for g in got],
                                        dtype=torch.int32)
    return (torch.from_numpy(hits).to(didx.idt).to(qd.device),
            torch.tensor([len(g[0]) for g in got], dtype=torch.int32,
                         device=qd.device))


def _seed_strategy_scan(didx: DeviceIndex, qd: torch.Tensor,
                        ld: torch.Tensor, min_len: int, max_intv: int,
                        stats=None):
    """Round 3 of mem_collect_intv (bwt_seed_strategy1 across each read)
    for a chunk: reads uint8 [B, L], lens int32 [B] -> (hits idt [B,
    maxh, 5] (x0, x1, size, qb, qe), zero past each read's count,
    n_hits int32 [B]), maxh = ``max_hits(L, min_len)``.  CPU tensors run
    ``_seed_strategy_scan_plain``; CUDA tensors launch K3
    (``csrc/smem.cu``, a group of lanes a read; ``_seed_strategy_scan.
    launches``).  A ``stats`` dict gets ``steps``, ``chain`` and
    ``longest`` (int32 [B], as the plain version's)."""
    B, L = check_reads(didx, qd, ld)
    if not _kernel_route(qd):
        return _seed_strategy_scan_plain(didx, qd, ld, min_len, max_intv,
                                         stats=stats)
    lib = _build.load("smem", _SIGNATURES)
    maxh = max_hits(L, min_len)
    dev = qd.device
    queue = torch.empty(1, dtype=torch.int32, device=dev)
    hits = torch.zeros((B, maxh, 5), dtype=didx.idt, device=dev)
    n_hits = torch.empty(B, dtype=torch.int32, device=dev)
    per_read = [torch.empty(B, dtype=torch.int32, device=dev)
                for _ in range(3)] if stats is not None else [None] * 3
    rc = lib.tpubwa_seed_strategy(
        *index_args(didx), qd.data_ptr(), L, ld.data_ptr(), B, int(min_len),
        int(max_intv), maxh, queue.data_ptr(), hits.data_ptr(),
        n_hits.data_ptr(), *(x if x is None else x.data_ptr()
                             for x in per_read), dev.index, stream_of(qd))
    _raise_on(rc, "seed_strategy")
    bump(_seed_strategy_scan)
    if stats is not None:
        stats.update(zip(("steps", "chain", "longest"), per_read))
    return hits, n_hits


_seed_strategy_scan.launches = 0


def k3_shape(lib, idx64: bool, n: int, device_index: int):
    """(cudaError, {group, blocks_per_sm, sms, blocks, groups}): K3's
    launch for ``n`` reads on the card (the C entry
    ``tpubwa_seed_strategy_shape``): the lanes a read, the blocks of 128
    threads an SM holds, the card's SMs, and the grid's blocks and groups
    of lanes; the error is the one a launch of ``n`` reads returns before
    it runs."""
    out = (ctypes.c_int64 * 5)()
    rc = lib.tpubwa_seed_strategy_shape(int(idx64), n, device_index, out)
    return rc, dict(zip(("group", "blocks_per_sm", "sms", "blocks",
                         "groups"), list(out)))


def _package_rows(flat, frid, reads, device):
    """The host path's return: flat rows, their read ids, and the
    chunk's reads as a uint8 tensor on ``device`` (resident for the
    descriptor extension)."""
    qd = torch.from_numpy(np.ascontiguousarray(reads, dtype=np.uint8))
    return flat, frid, qd.to(device)


def sa_counts(size, max_occ: int):
    """bwa's subsampling of an interval of ``size`` occurrences
    (bwamem.c:mem_chain head): step = size // max_occ where size passes
    max_occ, else 1, and min(ceil(size / step), max_occ) samples, none
    at max_occ <= 0 (-c 0).  ``size`` int64, a numpy array or a tensor;
    returns (step, cnt) of its kind."""
    if isinstance(size, torch.Tensor):
        if max_occ <= 0:
            return torch.ones_like(size), torch.zeros_like(size)
        step = torch.where(size > max_occ, size // max_occ, 1)
        return step, torch.clamp((size + step - 1) // step, max=max_occ)
    if max_occ <= 0:
        return np.ones_like(size), np.zeros_like(size)
    step = np.where(size > max_occ, size // max_occ, 1)
    return step, np.minimum((size + step - 1) // step, max_occ)


def segment_index(starts, cnt):
    """The flat indexes of segments ``cnt`` long starting at ``starts``
    (int64 numpy arrays), segment after segment."""
    ends = np.cumsum(cnt)
    return (np.repeat(np.asarray(starts, np.int64) - (ends - cnt), cnt)
            + np.arange(int(ends[-1]) if len(ends) else 0, dtype=np.int64))


def sa_ranks(didx: DeviceIndex, rows: torch.Tensor, keep: torch.Tensor,
             max_occ: int):
    """The ranks of bwa's subsampling for interval rows on the device
    (tpubwa/device/smem_fused.py:_sa_from_rows, exact sizes so no cap):
    rows idt [n, 5] (x0, x1, size, ...), keep bool [n] (a row that is
    not kept gets no samples) -> (cnt int64 [n], ranks idt [sum cnt]),
    rank k of a row x0 + k * step.  Tensor ops on the rows' device, in
    int64; the one sync reads the total."""
    size = torch.where(keep, rows[:, 2].long(), 0)
    step, cnt = sa_counts(size, max_occ)
    n = int(cnt.sum())
    if not n:
        return cnt, torch.zeros(0, dtype=didx.idt, device=rows.device)
    ends = torch.cumsum(cnt, 0)
    k = (torch.arange(n, dtype=torch.int64, device=rows.device)
         - torch.repeat_interleave(ends - cnt, cnt, output_size=n))
    ranks = (torch.repeat_interleave(rows[:, 0].long(), cnt, output_size=n)
             + k * torch.repeat_interleave(step, cnt, output_size=n))
    return cnt, ranks.to(didx.idt)


@dataclass
class Seeded:
    """One device's megaq output for its reads, on the host: K2's rows
    and read ids, K3's (hits, n_hits) or () where max_mem_intv is 0, and
    with the fused SA walk ``sa12`` and ``sa3``, the (cnt int64, pos
    int64) segments of K2's rows and of K3's valid hits (row-major), or
    None."""
    rows12: np.ndarray
    rids12: np.ndarray
    round3: tuple
    sa12: tuple = None
    sa3: tuple = None


def _megaq_rounds(opt, didx: DeviceIndex, qd: torch.Tensor,
                  ld: torch.Tensor, sa: bool = False, tp=None) -> Seeded:
    """K2's rounds 1+2 and K3's round 3 on reads already on the device,
    and with ``sa`` their rows' SA positions (``sa_ranks``, then K-sa on
    the same stream, no launch where no rank is sampled), all copied to
    the host after the last launch (the copies synchronise).  With a
    ``tp`` (a ``TpIndex``) K2 and K-sa read its slabs, launched from the
    reads' device, and K3 ``didx``."""
    slabs = didx if tp is None else tp.at(qd.device)
    rows12, rids12 = rounds12_megaq(opt, slabs, qd, ld)
    round3 = ()
    if opt.max_mem_intv > 0:
        round3 = _seed_strategy_scan(didx, qd, ld, opt.min_seed_len,
                                     opt.max_mem_intv)
    if sa:
        rows = rows12
        keep = torch.ones(len(rows12), dtype=torch.bool, device=qd.device)
        if round3:
            hits, n_hits = round3
            rows = torch.cat([rows12, hits.reshape(-1, 5)])
            keep = torch.cat([keep, (torch.arange(
                hits.shape[1], device=qd.device)[None, :]
                < n_hits[:, None]).reshape(-1)])
        cnt, ranks = sa_ranks(didx, rows, keep, opt.max_occ)
        pos = sa_lookup(slabs, ranks) if len(ranks) else ranks
    out = Seeded(rows12.cpu().numpy(), rids12.cpu().numpy(),
                 tuple(x.cpu().numpy() for x in round3))
    if sa:
        cnt, pos = cnt.cpu().numpy(), pos.cpu().numpy().astype(np.int64)
        n12 = len(rows12)
        cut = int(cnt[:n12].sum())
        cnt3 = cnt[n12:]
        if round3:
            hits, n_hits = out.round3
            cnt3 = cnt3.reshape(len(n_hits), -1)[
                np.arange(hits.shape[1])[None, :] < n_hits[:, None]]
        out.sa12, out.sa3 = (cnt[:n12], pos[:cut]), (cnt3, pos[cut:])
    return out


def _mode_rounds(opt, didx: DeviceIndex, qd: torch.Tensor, ld: torch.Tensor,
                 mode: str) -> Seeded:
    """A mode of ``_ROUNDS12``'s rounds on reads already on the device:
    ``_ROUNDS12[mode]`` and K3's round 3, copied to the host after the
    last launch.  No SA walk (``sa12`` and ``sa3`` None)."""
    rows12, rids12 = _ROUNDS12[mode](opt, didx, qd, ld)
    round3 = ()
    if opt.max_mem_intv > 0:
        round3 = _seed_strategy_scan(didx, qd, ld, opt.min_seed_len,
                                     opt.max_mem_intv)
    return Seeded(rows12.cpu().numpy(), rids12.cpu().numpy(),
                  tuple(x.cpu().numpy() for x in round3))


def merge_rounds(rows12, rids12, hits=None, n_hits=None, sa=None):
    """The chunk's rows as the seeding contract: K2's rows (idt [n, 5],
    read-major, each read's round 1 then round 2) and their read ids,
    then K3's hits ([B, maxh, 5] and n_hits [B], or None where round 3
    did not run), merged by one stable lexsort by (rid, qb, qe)
    (tpubwa/device/smem.py:767-771), which keeps ref/smem.py's order of
    ties.  Returns (flat int64 [n, 5], frid int64 [n]) numpy arrays;
    with ``sa``, the rows' SA segments (cnt int64 [n], pos int64) in the
    same concatenation order, also (cnt, pos) carried through the sort
    (tpubwa/device/smem.py:_permute_segments)."""
    blocks = [np.asarray(rows12).reshape(-1, 5)]
    rids = [np.asarray(rids12)]
    if hits is not None:
        hits, n_hits = np.asarray(hits), np.asarray(n_hits)
        valid = np.arange(hits.shape[1])[None, :] < n_hits[:, None]
        blocks.append(hits[valid])
        rids.append(np.nonzero(valid)[0])
    flat = np.concatenate(blocks).astype(np.int64)
    frid = np.concatenate(rids).astype(np.int64)
    order = np.lexsort((flat[:, 4], flat[:, 3], frid))
    if sa is None:
        return flat[order], frid[order]
    cnt, pos = sa
    if len(cnt) != len(flat) or int(cnt.sum()) != len(pos):
        raise RuntimeError(f"SA segments ({len(cnt)} rows, {len(pos)} "
                           f"positions) do not cover {len(flat)} rows")
    starts = np.cumsum(cnt) - cnt
    return (flat[order], frid[order],
            (cnt[order], pos[segment_index(starts[order], cnt[order])]))


def _merge(parts, sa: bool):
    """``merge_rounds`` over ``Seeded`` parts [(lo, Seeded)] of one chunk,
    read ids + lo, every part's K2 rows before every part's K3 hits, and
    with ``sa`` their SA segments in that order.  Returns (flat, frid,
    (cnt, pos) or None)."""
    none = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    rows = [np.zeros((0, 5), np.int64)] + [p.rows12 for _, p in parts]
    rids = [none[0]] + [p.rids12 + lo for lo, p in parts]
    round3 = tuple(np.concatenate(x) for x in zip(
        *[p.round3 for _, p in parts if p.round3]))
    segs = None
    if sa:
        segs = tuple(np.concatenate(x) for x in zip(
            none, *[p.sa12 for _, p in parts], *[p.sa3 for _, p in parts]))
    out = merge_rounds(np.concatenate(rows), np.concatenate(rids), *round3,
                       sa=segs)
    return out if sa else (*out, None)


def _upload(didx: DeviceIndex, reads: np.ndarray, lens: np.ndarray):
    """The chunk's reads (uint8 [B, L]) and lens (int32 [B]) on the
    index's device, uploaded once for seeding and the extension."""
    return tuple(torch.from_numpy(np.ascontiguousarray(x, t)).to(
        didx.device) for x, t in ((reads, np.uint8), (lens, np.int32)))


def _upload_dp(didxs, reads: np.ndarray, lens: np.ndarray, dp):
    """The whole chunk uploaded once to each replica: [(qd, ld)]."""
    return dp.map(lambda i, _: _upload(didxs[i], reads, lens),
                  [None] * dp.n)


def _collect_dp(didxs, uploads, n: int, dp, rounds, sa: bool = False):
    """A device mode over ``dp``'s replicas (tpubwa/device/smem.py:634-640:
    the reads replicated, the lanes sharded) for reads [0, n) of a chunk
    each replica holds (``uploads``): replica i seeds its part [lo, hi)
    through ``rounds(didx, qd, ld)`` (a ``Seeded``; with ``sa`` its SA
    segments too; a replica with an empty part launches nothing), and
    ``_merge`` runs once, on what one device would have seeded.  Returns
    (flat, frid, sa or None)."""
    def part(i, bounds):
        lo, hi = bounds
        if hi == lo:
            return None
        dp.note(i, "reads", hi - lo)
        qd, ld = uploads[i]
        got = rounds(didxs[i], qd[lo:hi], ld[lo:hi])
        if sa:
            dp.note(i, "ranks", len(got.sa12[1]) + len(got.sa3[1]))
        return lo, got

    return _merge([p for p in dp.map(part, dp.split(n)) if p is not None],
                  sa)


@dataclass
class HybridSplit:
    """Mode hybrid's balancer (tpubwa/device/smem.py:489-628), owned by
    the caller for a run of chunks.  A chunk of B reads sends its first
    ``k_for(B)`` = int(B * f) to the device; below ``k_floor`` the whole
    chunk is seeded in host mode.  With ``auto`` each split chunk's two
    walls move f towards equal walls (``update``).  ``chunks`` counts
    the chunks seeded on both sides; ``history`` holds (B, k, t_dev,
    t_host, f) a chunk, f the share it was split at (k 0 for a chunk
    seeded in host mode, k = B for one in megaq)."""
    f: float = 0.25
    auto: bool = True
    k_floor: int = 64
    chunks: int = 0
    history: list = field(default_factory=list)

    LO, HI = 0.02, 0.85       # the device share's clamps (tpubwa's)
    MIN_WALL = 1e-4           # s: a shorter wall is not a measurement

    @classmethod
    def from_env(cls):
        """tpubwa's knobs, with its defaults: TPUBWA_HYBRID_DEV_FRAC (the
        first share), TPUBWA_HYBRID_AUTO (0 pins it), and
        TPUBWA_HYBRID_K_FLOOR (the fewest device reads a split takes)."""
        env = os.environ.get
        return cls(f=float(env("TPUBWA_HYBRID_DEV_FRAC", "0.25")),
                   auto=env("TPUBWA_HYBRID_AUTO", "1") != "0",
                   k_floor=max(1, int(env("TPUBWA_HYBRID_K_FLOOR", "64"))))

    def k_for(self, B: int) -> int:
        return int(B * self.f)

    def update(self, B: int, k: int, t_dev: float, t_host: float):
        """Record a chunk; after a chunk seeded on both sides, move f by
        tpubwa's rule: f* = rate_d / (rate_d + rate_h) equalises the
        walls, and f <- clamp(f/2 + f*/2, LO, HI).  The first such chunk
        is not used (it pays the kernels' build and the index's first
        upload), nor are walls under MIN_WALL."""
        self.history.append((B, k, t_dev, t_host, self.f))
        if not 0 < k < B:
            return
        if (self.auto and self.chunks and t_dev > self.MIN_WALL
                and t_host > self.MIN_WALL):
            rate_d, rate_h = k / t_dev, (B - k) / t_host
            f_star = rate_d / (rate_d + rate_h)
            self.f = min(max(0.5 * self.f + 0.5 * f_star, self.LO),
                         self.HI)
        self.chunks += 1


def _uploads(didx, reads: np.ndarray, lens: np.ndarray, dp):
    """The chunk uploaded for seeding and the extension: (qd, ld) on the
    index's device, or under ``dp`` one such pair a replica."""
    if dp is None:
        return _upload(didx, reads, lens)
    return _upload_dp(didx, reads, lens, dp)


def _resident(uploads, dp):
    """The chunk's reads as the extension takes them: qd, or under
    ``dp`` a list, one a replica."""
    return uploads[0] if dp is None else [qd for qd, _ in uploads]


def _seed_megaq(opt, didx, uploads, n: int, dp, sa: bool, tp=None):
    """Mode megaq for reads [0, n) of an uploaded chunk, on the device or
    over ``dp``'s replicas: K2 seeds rounds 1+2 and K3 round 3 (with
    ``sa``, K-sa walks their rows' ranks; K2 and K-sa on ``tp``'s slabs
    where one is given), and the host merges their rows.  Returns (flat,
    frid, sa or None)."""
    def rounds(didx_, qd, ld):
        return _megaq_rounds(opt, didx_, qd, ld, sa=sa, tp=tp)

    return _seed_device(didx, uploads, n, dp, rounds, sa)


def _seed_device(didx, uploads, n: int, dp, rounds, sa: bool = False):
    """Reads [0, n) of an uploaded chunk through ``rounds(didx, qd, ld)``
    (a ``Seeded``) on the device, or over ``dp``'s replicas
    (``_collect_dp``).  Returns (flat, frid, sa or None)."""
    if dp is not None:
        return _collect_dp(didx, uploads, n, dp, rounds, sa=sa)
    qd, ld = uploads
    return _merge([(0, rounds(didx, qd[:n], ld[:n]))], sa)


def _collect_host(opt, didx, reads: np.ndarray, lens: np.ndarray, fmi,
                  dp):
    """Mode host: the native seeder's rows, the reads uploaded (to each
    replica under ``dp``); no SA positions (the caller walks them)."""
    rows6 = smem_collect_batch_native(opt, fmi, reads, lens)
    if rows6 is None:
        raise NotImplementedError(
            "the native seeder (tpubwa_torch/native/smem.cpp) is "
            "unavailable; seed mode 'megaq' seeds without it")
    if dp is not None:
        return rows6[:, :5], rows6[:, 5], dp.replicate(
            np.ascontiguousarray(reads, dtype=np.uint8)), None
    return (*_package_rows(rows6[:, :5], rows6[:, 5], reads, didx.device),
            None)


def _collect_hybrid(opt, didx, reads: np.ndarray, lens: np.ndarray, fmi,
                    split: HybridSplit, dp=None, sa: bool = False):
    """Mode hybrid: reads [:k] in megaq on a worker thread (its wall
    taken there, the synchronising copies included; under ``dp`` split
    over the replicas, so the wall is the slowest replica's) while this
    thread seeds reads [k:] in native C++ (ctypes releases the GIL) and,
    with ``sa``, walks their SA on the host (tpubwa/device/smem.py:
    573-577; -1 counts where the index has no marks); the device rows
    first, then the host rows with rid + k.  One ``split.update`` a
    chunk.  An error in the device share propagates: nothing reseeds it
    on the host."""
    B = len(lens)
    k = split.k_for(B)
    t0 = time.perf_counter()
    if smem_collect_batch_native(opt, fmi, reads[:0], lens[:0]) is None:
        up = _uploads(didx, reads, lens, dp)
        flat, frid, got_sa = _seed_megaq(opt, didx, up, B, dp, sa)
        split.update(B, B, time.perf_counter() - t0, 0.0)
        return flat, frid, _resident(up, dp), got_sa
    if k < split.k_floor:
        out = _collect_host(opt, didx, reads, lens, fmi, dp)
        split.update(B, 0, 0.0, time.perf_counter() - t0)
        return out
    up = _uploads(didx, reads, lens, dp)

    def device_share():
        t = time.perf_counter()
        rows = _seed_megaq(opt, didx, up, k, dp, sa)
        return rows, time.perf_counter() - t

    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(device_share)
        t = time.perf_counter()
        host6 = smem_collect_batch_native(opt, fmi, reads[k:], lens[k:])
        host_sa = sa_positions_native(
            fmi, host6[:, :5], opt.max_occ,
            threads=opt.n_threads) if sa else None
        t_host = time.perf_counter() - t
        (dflat, dfrid, dsa), t_dev = fut.result()
    split.update(B, k, t_dev, t_host)
    got_sa = None
    if sa:
        hpos, hcnt = host_sa or (np.zeros(0, np.int64),
                                 np.full(len(host6), -1, np.int64))
        got_sa = (np.concatenate([dsa[0], hcnt]),
                  np.concatenate([dsa[1], hpos]))
    return (np.concatenate([dflat, host6[:, :5]]),
            np.concatenate([dfrid, host6[:, 5] + k]), _resident(up, dp),
            got_sa)


def collect_intv_device(opt, didx, reads: np.ndarray, lens: np.ndarray,
                        fmi, mode: str = "host", split: HybridSplit = None,
                        dp=None, return_sa: bool = False, tp=None):
    """Full 3-round mem_collect_intv for a packed chunk (uint8 reads
    [B, L], int32 lens [B]).  Returns (flat int64 [n, 5] rows (x0, x1,
    size, qb, qe), frid int64 [n] read ids, qd uint8 [B, L] on the
    index's device); rows are in (read, qb, qe) order, the
    ref.smem.collect_intv contract per read.  ``mode``: 'host' (the
    native seeder on the host), 'megaq' (K2 and K3 on the index's
    device), 'hybrid' (a share of each, ``split`` the caller's balancer;
    without one, a new ``HybridSplit.from_env()``), 'reach' (K-reach's
    all-starts rounds 1 and 2, K3), 'cursor' or 'fused' (K-cur's job
    rounds 1 and 2, K3), 'mega' (K2's rounds 1 and 2, K3) or 'split'
    (K-fwd's and K-bwd's job rounds 1 and 2, K3); any other raises
    ValueError.  With a ``dp`` (``dist.sharding.DataParallel``),
    ``didx`` is the list of its replicas' indexes, every device mode (in
    hybrid, megaq's share) splits the reads over them, and ``qd`` is a
    list, the chunk's reads on each replica.  With a ``tp``
    (``dist/index_tp.py:TpIndex``) mode megaq seeds rounds 1+2 and walks
    the fused SA on its slabs (round 3 on ``didx``); the other modes do
    not read it.

    ``return_sa`` (tpubwa's): also return ``sa``, (cnt int64 [n], pos
    int64 [sum of cnt >= 0]) in the rows' order: megaq's rows get their
    positions from K-sa on ranks built on the device, hybrid's host
    share the native walk's, and a cnt of -1 marks a row left to the
    caller's SA stage.  ``sa`` is None in host mode and in the modes of
    ``_ROUNDS12`` (reach, cursor, mega, fused, split), and in every mode
    under TPUBWA_NO_SA_FUSE (tpubwa's opt-out): the caller then walks
    every row."""
    sa = return_sa and not os.environ.get("TPUBWA_NO_SA_FUSE")
    if mode == "megaq":
        up = _uploads(didx, reads, lens, dp)
        flat, frid, got_sa = _seed_megaq(opt, didx, up, len(lens), dp, sa,
                                         tp=tp)
        out = (flat, frid, _resident(up, dp), got_sa)
    elif mode == "hybrid":
        out = _collect_hybrid(opt, didx, reads, lens, fmi,
                              split or HybridSplit.from_env(), dp=dp, sa=sa)
    elif mode in _ROUNDS12:
        up = _uploads(didx, reads, lens, dp)
        flat, frid, _ = _seed_device(
            didx, up, len(lens), dp,
            lambda didx_, qd, ld: _mode_rounds(opt, didx_, qd, ld, mode))
        out = (flat, frid, _resident(up, dp), None)
    elif mode != "host":
        raise ValueError(f"unknown seed mode {mode!r}")
    else:
        out = _collect_host(opt, didx, reads, lens, fmi, dp)
    return out if return_sa else out[:3]
