"""Batched SMEM seeding for a read chunk, the counterpart of
tpubwa/device/smem.py:collect_intv_device.

Three modes:

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
  chunk by ``HybridSplit`` (tpubwa's equal-wall balancer).

tpubwa's other machine modes are not ported on purpose (ROADMAP).
"""

from __future__ import annotations

import ctypes
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from ..host.native_smem import smem_collect_batch_native
from . import _build
from .occ import DeviceIndex, _kernel_route, _raise_on
from .smem_fused import (_SIGNATURES, base_intervals, check_reads,
                         index_args, read_lists, rounds12_megaq, run_reads,
                         stream_of)

_NOT_PORTED = ("seed mode {!r} is one of tpubwa's TPU seeding machines "
               "that the port leaves out on purpose (ROADMAP Queue 1, 'Not "
               "ported on purpose'); use 'megaq' or 'host'")


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
    _seed_strategy_scan.launches += 1
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


def merge_rounds(rows12, rids12, hits=None, n_hits=None):
    """The chunk's rows as the seeding contract: K2's rows (idt [n, 5],
    read-major, each read's round 1 then round 2) and their read ids,
    then K3's hits ([B, maxh, 5] and n_hits [B], or None where round 3
    did not run), merged by one stable lexsort by (rid, qb, qe)
    (tpubwa/device/smem.py:767-771), which keeps ref/smem.py's order of
    ties.  Returns (flat int64 [n, 5], frid int64 [n]) numpy arrays."""
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
    return flat[order], frid[order]


def _upload(didx: DeviceIndex, reads: np.ndarray, lens: np.ndarray):
    """The chunk's reads (uint8 [B, L]) and lens (int32 [B]) on the
    index's device, uploaded once for seeding and the extension."""
    return tuple(torch.from_numpy(np.ascontiguousarray(x, t)).to(
        didx.device) for x, t in ((reads, np.uint8), (lens, np.int32)))


def _collect_megaq(opt, didx: DeviceIndex, qd: torch.Tensor,
                   ld: torch.Tensor):
    """Mode megaq on reads already on the device: K2 seeds rounds 1+2 and
    K3 round 3, and the host merges their rows (``merge_rounds``).  The
    ``.cpu()`` copies synchronise with the launches.  Returns (flat,
    frid)."""
    rows12, rids12 = rounds12_megaq(opt, didx, qd, ld)
    round3 = ()
    if opt.max_mem_intv > 0:
        round3 = tuple(x.cpu() for x in _seed_strategy_scan(
            didx, qd, ld, opt.min_seed_len, opt.max_mem_intv))
    return merge_rounds(rows12.cpu(), rids12.cpu(), *round3)


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


def _collect_hybrid(opt, didx: DeviceIndex, reads: np.ndarray,
                    lens: np.ndarray, fmi, split: HybridSplit):
    """Mode hybrid: reads [:k] through K2 and K3 on a worker thread (its
    wall taken there, the synchronising copies included) while this
    thread seeds reads [k:] in native C++ (ctypes releases the GIL);
    the device rows first, then the host rows with rid + k.  An error in
    the device share propagates: nothing reseeds it on the host."""
    B = len(lens)
    k = split.k_for(B)
    t0 = time.perf_counter()
    if smem_collect_batch_native(opt, fmi, reads[:0], lens[:0]) is None:
        qd, ld = _upload(didx, reads, lens)
        flat, frid = _collect_megaq(opt, didx, qd, ld)
        split.update(B, B, time.perf_counter() - t0, 0.0)
        return flat, frid, qd
    if k < split.k_floor:
        out = collect_intv_device(opt, didx, reads, lens, fmi, mode="host")
        split.update(B, 0, 0.0, time.perf_counter() - t0)
        return out
    qd, ld = _upload(didx, reads, lens)

    def device_share():
        t = time.perf_counter()
        rows = _collect_megaq(opt, didx, qd[:k], ld[:k])
        return rows, time.perf_counter() - t

    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(device_share)
        t = time.perf_counter()
        host6 = smem_collect_batch_native(opt, fmi, reads[k:], lens[k:])
        t_host = time.perf_counter() - t
        (dflat, dfrid), t_dev = fut.result()
    split.update(B, k, t_dev, t_host)
    return (np.concatenate([dflat, host6[:, :5]]),
            np.concatenate([dfrid, host6[:, 5] + k]), qd)


def collect_intv_device(opt, didx: DeviceIndex, reads: np.ndarray,
                        lens: np.ndarray, fmi, mode: str = "host",
                        split: HybridSplit = None):
    """Full 3-round mem_collect_intv for a packed chunk (uint8 reads
    [B, L], int32 lens [B]).  Returns (flat int64 [n, 5] rows (x0, x1,
    size, qb, qe), frid int64 [n] read ids, qd uint8 [B, L] on the
    index's device); rows are in (read, qb, qe) order, the
    ref.smem.collect_intv contract per read.  ``mode``: 'host' (the
    native seeder on the host), 'megaq' (K2 and K3 on the index's
    device) or 'hybrid' (a share of each, ``split`` the caller's
    balancer; without one, a new ``HybridSplit.from_env()``).  SA
    positions are left to the caller."""
    if mode == "megaq":
        qd, ld = _upload(didx, reads, lens)
        return (*_collect_megaq(opt, didx, qd, ld), qd)
    if mode == "hybrid":
        return _collect_hybrid(opt, didx, reads, lens, fmi,
                               split or HybridSplit.from_env())
    if mode in ("mega", "fused", "split", "cursor", "reach"):
        raise NotImplementedError(_NOT_PORTED.format(mode))
    if mode != "host":
        raise ValueError(f"unknown seed mode {mode!r}")
    rows6 = smem_collect_batch_native(opt, fmi, reads, lens)
    if rows6 is None:
        raise NotImplementedError(
            "the native seeder (tpubwa_torch/native/smem.cpp) is "
            "unavailable; seed mode 'megaq' seeds without it")
    return _package_rows(rows6[:, :5], rows6[:, 5], reads, didx.device)
