"""bwt_smem1a over a queue of jobs, the counterpart of
tpubwa/device/smem_cursor.py (seed mode ``cursor``).

A job is (read, x0, min_intv, one_shot).  A one-shot job makes one
bwt_smem1a(x0, min_intv) call (round 2's re-seeding); any other starts at
x0 and restarts at each call's return, past N bases, until its read
ends (round 1, x0 = 0, min_intv 1).  A job's rows are the SMEMs those
calls find, with rows of fewer than min_seed_len bases dropped (tpubwa's
on-device length filter), each call's by query start.

Two versions, bit-identical by test:

* ``run_smem_jobs_plain``: job by job over ``smem_fused.smem1a_plain``,
  the pending extensions of all jobs batched a step by
  ``smem_fused.run_reads``;
* K-cur, the hand-written CUDA kernel ``smem_jobs_kernel`` of
  ``csrc/smem.cu`` (a warp a job from a job queue, over
  ``csrc/smem.cuh:smem1a``), reached through ``run_smem_jobs`` for CUDA
  tensors, with K2's two-launch protocol (``smem_fused.collect12``).

``run_smem_jobs`` routes by the tensors' device: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises.  Unlike
tpubwa's lockstep machine, the kernel has no stack or row caps, no
overflow flag and no host fallback: a warp's stacks hold L + 1
intervals, so no job overflows, and a job with more rows than its slots
is counted exactly and re-run with room for them.  K-cur keeps three
stacks a warp in shared memory, so it takes reads of at most
``kcur_max_len`` bases; both routes refuse longer ones.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .counts import bump
from .occ import DeviceIndex, I64, _kernel_route, _raise_on
from .smem_fused import (_SIGNATURES, H100_BLOCK_SMEM, K2_SLOTS,
                         base_intervals, check_reads, collect12, index_args,
                         new_tally, read_lists, reseed_jobs, run_reads,
                         smem1a_plain, stream_of)

# K-cur's stacks a job, in its warp's shared memory: curr, prev and a
# call's rows, L + 1 intervals each
KCUR_STACKS = 3


def kcur_max_len(idt) -> int:
    """The longest read K-cur takes on an H100 with ranks of ``idt``: its
    warp's ``KCUR_STACKS`` x (L + 1) intervals of five ranks must fit a
    block's shared memory."""
    return H100_BLOCK_SMEM // (KCUR_STACKS * 5 * idt.itemsize) - 1


def check_kcur_len(L: int, idt, max_len: int):
    """Raise RuntimeError, naming the limit, where reads of ``L`` bases
    are longer than ``max_len`` (``kcur_max_len``)."""
    if L > max_len:
        raise RuntimeError(
            f"K-cur takes reads of at most {max_len} bases with {idt} ranks "
            f"(its {KCUR_STACKS} stacks of L + 1 intervals a job live in a "
            f"block's shared memory), got L = {L}")


def check_jobs(didx: DeviceIndex, qd: torch.Tensor, ld: torch.Tensor, jobs):
    """Raise unless ``jobs`` = (read int32, x0 int32, min_intv of the
    index's rank type, one_shot bool), 1-D of one length, contiguous, on
    the index's device, each read one of ``qd``'s and each x0 >= 0;
    returns (B, L) of the reads."""
    B, L = check_reads(didx, qd, ld)
    if len(jobs) != 4:
        raise ValueError("jobs must be (read, x0, min_intv, one_shot)")
    n = len(jobs[0])
    for name, x, dt in zip(("read", "x0", "min_intv", "one_shot"), jobs,
                           (torch.int32, torch.int32, didx.idt, torch.bool)):
        if x.dtype != dt or x.dim() != 1 or len(x) != n:
            raise ValueError(f"{name} must be {dt} [{n}], got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != didx.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {didx.device}")
    read, x0 = jobs[:2]
    if n and not bool(((read >= 0) & (read < B) & (x0 >= 0)).all()):
        raise ValueError("a job's read outside the reads, or x0 < 0")
    return B, L


def round1_jobs(n_reads: int, idt, device):
    """Mode cursor's round-1 jobs (tpubwa/device/smem.py:283-286): a job
    (read, 0, 1, not one-shot) a read of ``n_reads``, on ``device``."""
    return (torch.arange(n_reads, dtype=torch.int32, device=device),
            torch.zeros(n_reads, dtype=torch.int32, device=device),
            torch.ones(n_reads, dtype=idt, device=device),
            torch.zeros(n_reads, dtype=torch.bool, device=device))


def round2_jobs(opt, rows: torch.Tensor, counts: torch.Tensor):
    """Round 2's jobs (tpubwa/device/smem.py:301-313) from round 1's rows
    (job-major) and counts (a job a read): a one-shot job (read, x,
    min_intv) a re-seeded row (``smem_fused.reseed_jobs``)."""
    rids = torch.repeat_interleave(
        torch.arange(len(counts), device=rows.device), counts.long())
    rid, x, mi = reseed_jobs(opt, rows, rids)
    return rid, x, mi, torch.ones(len(rid), dtype=torch.bool,
                                  device=rows.device)


def rounds12_jobs(opt, didx: DeviceIndex, qd: torch.Tensor,
                  ld: torch.Tensor, run):
    """Rounds 1 and 2 as jobs (tpubwa/device/smem.py:275, the protocol of
    seed modes cursor, fused and split): round 1 a job a read
    (``round1_jobs``), round 2 a one-shot job a re-seeded round-1 row
    (``round2_jobs``; nothing runs where there is none), each through
    ``run(didx, qd, ld, jobs, min_seed_len)`` -> (rows, counts a job),
    ``run_smem_jobs``'s contract.  Returns (rows idt [n, 5], rids int64
    [n]): round 1's rows (read-major), then round 2's (job by job)."""
    jobs = round1_jobs(len(ld), didx.idt, qd.device)
    rows1, n1 = run(didx, qd, ld, jobs, opt.min_seed_len)
    rids1 = torch.repeat_interleave(jobs[0].long(), n1.long())
    jobs = round2_jobs(opt, rows1, n1)
    if not len(jobs[0]):
        return rows1, rids1
    rows2, n2 = run(didx, qd, ld, jobs, opt.min_seed_len)
    return (torch.cat([rows1, rows2]),
            torch.cat([rids1, torch.repeat_interleave(jobs[0].long(),
                                                      n2.long())]))


def job_plain(base, q, x0: int, min_intv: int, one_shot: bool,
              min_seed_len: int, tally):
    """One job (see the module), a generator over ``run_reads``: its rows
    [x0, x1, size, qb, qe] of at least min_seed_len bases, each call's by
    query start.  ``tally`` (``smem_fused.new_tally``) is added to."""
    rows = []
    x = x0
    while x < len(q):
        if q[x] > 3:  # smem1a would return x + 1, with no rows
            if one_shot:
                break
            x += 1
            continue
        mem, x = yield from smem1a_plain(base, q, x, min_intv, tally)
        rows += [m for m in mem if m[4] - m[3] >= min_seed_len]
        if one_shot:
            break
    return rows


def run_smem_jobs_plain(didx: DeviceIndex, qd: torch.Tensor,
                        ld: torch.Tensor, jobs, min_seed_len: int,
                        stats=None):
    """K-cur's contract, job by job: (rows idt [n, 5], counts int32
    [jobs]).  A ``stats`` dict gets ``steps`` and ``chain`` (int32 a job,
    as K2's a read) and ``second_launch_reads`` (0: the plain version
    has no slots)."""
    check_jobs(didx, qd, ld, jobs)
    check_kcur_len(qd.shape[1], didx.idt, kcur_max_len(didx.idt))
    base = base_intervals(didx)
    reads = read_lists(qd, ld)
    read, x0, mi, once = (x.tolist() for x in jobs)
    tallies = [new_tally() for _ in read]
    got, steps = run_reads(didx, [
        job_plain(base, reads[r], x, m, o, min_seed_len, t)
        for r, x, m, o, t in zip(read, x0, mi, once, tallies)])
    rows = [row for rs in got for row in rs]
    if stats is not None:
        stats["steps"] = torch.tensor(steps, dtype=torch.int32)
        stats["chain"] = torch.tensor([t["chain"] for t in tallies],
                                      dtype=torch.int32)
        stats["second_launch_reads"] = 0
    return (torch.tensor(rows, dtype=didx.idt).reshape(-1, 5).to(qd.device),
            torch.tensor([len(g) for g in got], dtype=torch.int32,
                         device=qd.device))


def kcur_shape(lib, idx64: bool, L: int, device_index: int):
    """(cudaError, {warp_bytes, warps, blocks_per_sm, sms, max_len}):
    K-cur's launch shape for reads of ``L`` bases on the card (the C
    entry ``tpubwa_smem_jobs_shape``); the error is the one a launch at
    ``L`` returns before it runs."""
    out = (ctypes.c_int64 * 5)()
    rc = lib.tpubwa_smem_jobs_shape(int(idx64), L, device_index, out)
    return rc, dict(zip(("warp_bytes", "warps", "blocks_per_sm", "sms",
                         "max_len"), list(out)))


def run_smem_jobs(didx: DeviceIndex, qd: torch.Tensor, ld: torch.Tensor,
                  jobs, min_seed_len: int, slots: int = K2_SLOTS,
                  stats=None):
    """tpubwa's ``run_smem_jobs`` (smem_cursor.py:293): the rows of each
    job (see the module) of ``jobs`` = (read int32 [n], x0 int32 [n],
    min_intv idt [n], one_shot bool [n]) on reads uint8 [B, L] (codes, 4
    = N) of lens int32 [B].  Returns (rows idt [m, 5] (x0, x1, size, qb,
    qe), job-major, counts int32 [n]), on the reads' device.  CPU tensors
    run ``run_smem_jobs_plain``; CUDA tensors launch K-cur, with
    ``slots`` row slots a job in the first launch and a second launch
    for the jobs with more (``run_smem_jobs.launches`` counts them).
    Reads longer than K-cur takes raise RuntimeError on both routes
    (``kcur_max_len``).  A ``stats`` dict gets ``steps`` and ``chain``
    (int32 a job) and ``second_launch_reads`` (the jobs re-run)."""
    check_jobs(didx, qd, ld, jobs)
    L = qd.shape[1]
    if slots < 1:
        raise ValueError(f"slots must be positive, got {slots}")
    if not _kernel_route(qd):
        return run_smem_jobs_plain(didx, qd, ld, jobs, min_seed_len,
                                   stats=stats)
    lib = _build.load("smem", _SIGNATURES)
    dev, idt = qd.device, didx.idt
    queue = torch.empty(1, dtype=torch.int32, device=dev)
    read, x0, mi, once = jobs

    def launch(ids, width):
        n = len(ids)
        rows = torch.empty((n, width, 5), dtype=idt, device=dev)
        counts, steps, chain = (torch.empty(n, dtype=torch.int32,
                                            device=dev) for _ in range(3))
        rc = lib.tpubwa_smem_jobs(
            *index_args(didx), qd.data_ptr(), L, ld.data_ptr(),
            read.data_ptr(), x0.data_ptr(), mi.data_ptr(), once.data_ptr(),
            ids.data_ptr(), n, min_seed_len, width, queue.data_ptr(),
            rows.data_ptr(), counts.data_ptr(), steps.data_ptr(),
            chain.data_ptr(), dev.index, stream_of(qd))
        if rc:
            _, shape = kcur_shape(lib, idt == I64, L, dev.index)
            check_kcur_len(L, idt, shape["max_len"])
        _raise_on(rc, "smem_jobs")
        bump(run_smem_jobs)
        return rows, counts, steps, chain

    rows, job = collect12(launch, len(read), slots, dev, stats=stats)
    return rows, torch.bincount(job, minlength=len(read)).int()


run_smem_jobs.launches = 0
