"""bwt_smem1a cut at its stack, the counterpart of
tpubwa/device/smem_split.py (seed mode ``split``).

A job is K-cur's (``smem_cursor``): (read, x0, min_intv, one_shot).  Its
forward passes and their backward passes run apart:

* ``run_fwd``: each job's bwt_smem1a calls up to their stacks
  (``smem_fused.smem1a_fwd_plain``, csrc/smem.cuh:smem1a_fwd): a job
  restarts at each call's return (past N bases) until its read ends,
  unless it is one-shot.  Its output, ``Calls``, holds every call (its
  job, x, stack size m and return) and every call's stack, the pushed
  intervals (x0, x1, size, qe) longest match first: the order the
  backward pass reads them in;
* ``run_bwd``: each recorded call's backward pass from its stack
  (``smem_fused.smem1a_bwd_plain``, csrc/smem.cuh:smem1a_bwd), its rows
  of at least min_seed_len bases by query start.  A call emits at most m
  rows, so call i's rows fit the slots of its stack, and the rows of all
  calls are sized by one prefix sum of m.

Forward then backward is ``run_smem_jobs``'s function (``run_split``), and
``rounds12_split`` runs mode cursor's job protocol over it, as tpubwa's
rounds12_split (:566-627) runs its two machines: round 1's forward over a
job a read and the backward over every call, then round 2's one-shot
jobs likewise.  Its contract is tpubwa's (flat rows and read ids,
unsorted), as device tensors.

Two versions of each half, bit-identical by test:

* ``run_fwd_plain`` and ``run_bwd_plain``, job by job and call by call as
  generators over ``smem_fused.run_reads``;
* K-fwd and K-bwd, the hand-written CUDA kernels ``smem_fwd_kernel``
  (a warp a job from a job queue, ``slots`` stack intervals a job and a
  second launch for the jobs with more, K2's protocol) and
  ``smem_bwd_kernel`` (a warp a call from a call queue) of
  ``csrc/smem.cu``, reached through ``run_fwd`` and ``run_bwd`` for CUDA
  tensors.

The wrappers route by the tensors' device: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises.  tpubwa's caps (P,
MAXC, MAXM, CAPF), its overflow flags, span buckets, second chance and
host redo have no counterpart: every bound comes from the read's length.
K-bwd keeps three stacks a warp in shared memory (K-fwd two), so both
take reads of at most ``ksplit_max_len`` bases, and both routes refuse
longer ones.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build
from .counts import bump
from .occ import DeviceIndex, I64, _kernel_route, _raise_on
from .smem_cursor import check_jobs, rounds12_jobs
from .smem_fused import (_SIGNATURES, H100_BLOCK_SMEM, base_intervals,
                         index_args, new_tally, read_lists, run_reads,
                         smem1a_bwd_plain, smem1a_fwd_plain, stream_of)

# stack intervals a job in K-fwd's first launch: a 100-base round-1 job
# pushes a few calls of a dozen or two intervals; a job with more is
# re-run with room for them
FWD_SLOTS = 128
# the stacks a warp keeps in shared memory, L + 1 intervals each: K-fwd's
# curr and prev, K-bwd's curr, prev and the call's rows
FWD_STACKS, BWD_STACKS = 2, 3


def ksplit_max_len(idt, stacks: int = BWD_STACKS) -> int:
    """The longest read seed mode split takes on an H100 with ranks of
    ``idt``: K-bwd's ``BWD_STACKS`` x (L + 1) intervals of five ranks
    must fit a block's shared memory (K-fwd's own limit, at
    ``FWD_STACKS``, is longer; both wrappers refuse past K-bwd's)."""
    return H100_BLOCK_SMEM // (stacks * 5 * idt.itemsize) - 1


def check_ksplit_len(L: int, idt, max_len: int):
    """Raise RuntimeError, naming the limit, where reads of ``L`` bases
    are longer than ``max_len`` (``ksplit_max_len``)."""
    if L > max_len:
        raise RuntimeError(
            f"K-fwd and K-bwd take reads of at most {max_len} bases with "
            f"{idt} ranks (K-bwd's {BWD_STACKS} stacks of L + 1 "
            f"intervals a call live in a block's shared memory), got L = "
            f"{L}")


@dataclass
class Calls:
    """The forward passes' output: the calls, job-major and in order
    within a job, each with its job (int64), x, m (its stack's size) and
    ret (the next x) (int32 [c] each), and ``stack`` (idt [sum of m, 4]:
    x0, x1, size, qe), the calls' stacks one after another, each longest
    match first."""
    job: torch.Tensor
    x: torch.Tensor
    m: torch.Tensor
    ret: torch.Tensor
    stack: torch.Tensor


def bwd_calls(jobs, calls: Calls):
    """``run_bwd``'s calls from ``run_fwd``'s: (read int32, x int32, m
    int32, min_intv of the jobs' type), their job's read and min_intv."""
    return (jobs[0][calls.job], calls.x, calls.m, jobs[2][calls.job])


# ---------------------------------------------------------------------
# the plain versions

def fwd_job_plain(base, q, x0: int, min_intv: int, one_shot: bool, tally):
    """One job's forward passes, a generator over ``run_reads``: [(x,
    stack, ret)] a call, the stack as ``smem1a_fwd_plain`` leaves it."""
    calls = []
    x = x0
    while x < len(q):
        if q[x] > 3:  # smem1a would return x + 1, with no call
            if one_shot:
                break
            x += 1
            continue
        stack, ret = yield from smem1a_fwd_plain(base, q, x, min_intv, tally)
        calls.append((x, stack, ret))
        if one_shot:
            break
        x = ret
    return calls


def run_fwd_plain(didx: DeviceIndex, qd: torch.Tensor, ld: torch.Tensor,
                  jobs, stats=None) -> Calls:
    """K-fwd's contract, job by job: the ``Calls`` of ``jobs``.  A
    ``stats`` dict gets ``steps`` and ``chain`` (int32 a job: forward
    steps, one a round each) and ``second_launch_jobs`` (0: the plain
    version has no slots)."""
    check_jobs(didx, qd, ld, jobs)
    check_ksplit_len(qd.shape[1], didx.idt, ksplit_max_len(didx.idt))
    base = base_intervals(didx)
    reads = read_lists(qd, ld)
    read, x0, mi, once = (x.tolist() for x in jobs)
    tallies = [new_tally() for _ in read]
    got, steps = run_reads(didx, [
        fwd_job_plain(base, reads[r], x, m, o, t)
        for r, x, m, o, t in zip(read, x0, mi, once, tallies)])
    job, head, stack = [], [], []
    for j, calls in enumerate(got):
        for x, st, ret in calls:
            job.append(j)
            head.append((x, len(st), ret))
            stack += [(p[0], p[1], p[2], p[4]) for p in st]
    if stats is not None:
        stats["steps"] = torch.tensor(steps, dtype=torch.int32)
        stats["chain"] = torch.tensor([t["chain"] for t in tallies],
                                      dtype=torch.int32)
        stats["second_launch_jobs"] = 0
    dev = qd.device
    head = torch.tensor(head, dtype=torch.int32).reshape(-1, 3).T
    return Calls(torch.tensor(job, dtype=I64, device=dev),
                 *(c.contiguous().to(dev) for c in head),
                 torch.tensor(stack, dtype=didx.idt).reshape(-1, 4).to(dev))


def bwd_call_plain(q, x: int, min_intv: int, prev, min_seed_len: int,
                   tally):
    """One call's backward pass from its stack ``prev`` (intervals [x0,
    x1, size, 0, qe], longest match first), a generator over
    ``run_reads``: its rows of at least min_seed_len bases by query
    start."""
    mem = yield from smem1a_bwd_plain(q, x, min_intv, prev, tally)
    return [m for m in mem if m[4] - m[3] >= min_seed_len]


def check_calls(didx: DeviceIndex, qd: torch.Tensor, ld: torch.Tensor, read,
                x, m, min_intv, stack):
    """Raise unless the calls (read int32, x int32, m int32, min_intv of
    the index's rank type, 1-D of one length, contiguous) and their
    stacks (idt [sum of m, 4], contiguous) lie on the index's device, each
    read one of ``qd``'s, 0 <= x < its length and 1 <= m <= its length -
    x (a call pushes intervals of distinct ends past x, so K-bwd's stacks
    of L + 1 hold any); returns (B, L)."""
    B, L = check_jobs(didx, qd, ld, (read, x, min_intv,
                                     torch.zeros_like(read, dtype=torch.bool)))
    n = len(read)
    if m.dtype != torch.int32 or m.dim() != 1 or len(m) != n:
        raise ValueError(f"m must be int32 [{n}], got {m.dtype} "
                         f"{tuple(m.shape)}")
    if m.device != didx.device or not m.is_contiguous():
        raise ValueError(f"m must be contiguous on {didx.device}")
    if (stack.dtype != didx.idt or stack.dim() != 2 or stack.shape[1] != 4
            or stack.device != didx.device or not stack.is_contiguous()):
        raise ValueError(f"stack must be contiguous {didx.idt} [s, 4] on "
                         f"{didx.device}, got {stack.dtype} "
                         f"{tuple(stack.shape)}")
    if n and not bool(((m >= 1) & (m <= ld[read.long()] - x)).all()):
        raise ValueError("a call whose stack is empty or longer than its "
                         "read past x")
    if int(m.long().sum()) != len(stack):
        raise ValueError(f"{len(stack)} stack intervals for calls of "
                         f"{int(m.long().sum())}")
    return B, L


def run_bwd_plain(didx: DeviceIndex, qd: torch.Tensor, ld: torch.Tensor,
                  read, x, m, min_intv, stack, min_seed_len: int,
                  stats=None):
    """K-bwd's contract, call by call: (rows idt [r, 5], call-major, each
    call's by query start, counts int32 [calls]).  A ``stats`` dict gets
    ``steps`` and ``chain`` (int32 a call: the backward extensions, and
    the strips of up to 32 of them)."""
    check_calls(didx, qd, ld, read, x, m, min_intv, stack)
    check_ksplit_len(qd.shape[1], didx.idt, ksplit_max_len(didx.idt))
    reads = read_lists(qd, ld)
    st = stack.tolist()
    ends = torch.cumsum(m.long(), 0).tolist()
    tallies = [new_tally() for _ in ends]
    got, steps = run_reads(didx, [
        bwd_call_plain(reads[r], xc, mi, [[*p[:3], 0, p[3]]
                                          for p in st[e - mc:e]],
                       min_seed_len, t)
        for r, xc, mc, mi, e, t in zip(read.tolist(), x.tolist(), m.tolist(),
                                       min_intv.tolist(), ends, tallies)])
    if stats is not None:
        stats["steps"] = torch.tensor(steps, dtype=torch.int32)
        stats["chain"] = torch.tensor([t["chain"] for t in tallies],
                                      dtype=torch.int32)
    rows = [row for rs in got for row in rs]
    return (torch.tensor(rows, dtype=didx.idt).reshape(-1, 5).to(qd.device),
            torch.tensor([len(g) for g in got], dtype=torch.int32,
                         device=qd.device))


# ---------------------------------------------------------------------
# the kernels

def ksplit_shape(lib, bwd: bool, idx64: bool, L: int, device_index: int):
    """(cudaError, {warp_bytes, warps, blocks_per_sm, sms, max_len}):
    K-fwd's (or with ``bwd`` K-bwd's) launch shape for reads of ``L``
    bases on the card (the C entry ``tpubwa_smem_split_shape``); the
    error is the one a launch at ``L`` returns before it runs."""
    out = (ctypes.c_int64 * 5)()
    rc = lib.tpubwa_smem_split_shape(int(bwd), int(idx64), L, device_index,
                                     out)
    return rc, dict(zip(("warp_bytes", "warps", "blocks_per_sm", "sms",
                         "max_len"), list(out)))


def _refused(lib, rc: int, bwd: bool, idt, L: int, device_index: int,
             what: str):
    """Raise for a launch's error: the card's length refusal where it is
    one."""
    if rc:
        _, shape = ksplit_shape(lib, bwd, idt == I64, L, device_index)
        check_ksplit_len(L, idt, shape["max_len"])
    _raise_on(rc, what)


def _flat(ids: torch.Tensor, buf: torch.Tensor, count: torch.Tensor):
    """The first ``count[i]`` entries of each ``buf[i]`` ([n, width, k]),
    one after another, with the job ``ids[i]`` of each (int64)."""
    keep = (torch.arange(buf.shape[1], device=buf.device)[None, :]
            < count[:, None])
    return buf[keep], ids.long()[:, None].expand(-1, buf.shape[1])[keep]


def collect_calls(launch, n_jobs: int, slots: int, device,
                  stats=None) -> Calls:
    """K-fwd's launches (K2's protocol, ``smem_fused.collect12``):
    ``launch(ids, width)`` runs the jobs ``ids`` (int32 [n]) with
    ``width`` stack intervals each and returns (stack idt [n, width, 4],
    calls int32 [n, width, 3], n_calls, n_intv, steps, chain int32 [n]),
    the counts exact past the slots.  The first launch runs every job;
    the second, only where it runs, the jobs whose intervals passed
    ``slots``, with room for the most.  Returns their ``Calls``; a
    ``stats`` dict gets ``steps`` and ``chain`` (int32 a job) and
    ``second_launch_jobs``."""
    ids = torch.arange(n_jobs, dtype=torch.int32, device=device)
    stack, calls, n_calls, n_intv, steps, chain = launch(ids, slots)
    over = n_intv > slots
    n_over = int(over.sum())
    parts = [(ids, stack, calls, torch.where(over, 0, n_calls),
              torch.where(over, 0, n_intv))]
    if n_over:
        again = ids[over]
        parts.append((again, *launch(again, int(n_intv.max()))[:4]))
    heads, stacks = zip(*[(_flat(i, c, nc), _flat(i, s, ni))
                          for i, s, c, nc, ni in parts])
    (head, job), (stack, sjob) = ((torch.cat(a), torch.cat(b))
                                  for a, b in (zip(*heads), zip(*stacks)))
    if n_over:  # job-major again: the re-run jobs' calls and stacks
        order = torch.sort(job, stable=True).indices
        head, job = head[order], job[order]
        stack = stack[torch.sort(sjob, stable=True).indices]
    if stats is not None:
        stats.update(steps=steps, chain=chain, second_launch_jobs=n_over)
    return Calls(job, *(c.contiguous() for c in head.T), stack.contiguous())


def call_rows(rows: torch.Tensor, counts: torch.Tensor, m: torch.Tensor):
    """K-bwd's rows, call-major: the first ``counts[i]`` of the ``m[i]``
    slots of each call, the calls' slots one after another in ``rows``."""
    mm = m.long()
    total = len(rows)
    call = torch.repeat_interleave(torch.arange(len(m), device=rows.device),
                                   mm, output_size=total)
    at = torch.arange(total, device=rows.device) - (torch.cumsum(mm, 0)
                                                    - mm)[call]
    return rows[at < counts[call]]


def run_fwd(didx: DeviceIndex, qd: torch.Tensor, ld: torch.Tensor, jobs,
            slots: int = FWD_SLOTS, stats=None) -> Calls:
    """tpubwa's ``run_fwd`` (smem_split.py:384): the ``Calls`` of each job
    of ``jobs`` = (read int32 [n], x0 int32 [n], min_intv idt [n],
    one_shot bool [n]) on reads uint8 [B, L] (codes, 4 = N) of lens int32
    [B], on the reads' device.  CPU tensors run ``run_fwd_plain``; CUDA
    tensors launch K-fwd, with ``slots`` stack intervals a job in the
    first launch and a second launch, with room for the most, for the
    jobs with more (``run_fwd.launches`` counts both).  Reads longer than
    K-fwd takes raise RuntimeError on both routes (``ksplit_max_len``).
    A ``stats`` dict gets ``steps`` and ``chain`` (int32 a job) and
    ``second_launch_jobs``."""
    check_jobs(didx, qd, ld, jobs)
    L = qd.shape[1]
    if slots < 1:
        raise ValueError(f"slots must be positive, got {slots}")
    check_ksplit_len(L, didx.idt, ksplit_max_len(didx.idt))
    if not _kernel_route(qd):
        return run_fwd_plain(didx, qd, ld, jobs, stats=stats)
    lib = _build.load("smem", _SIGNATURES)
    dev, idt = qd.device, didx.idt
    queue = torch.empty(1, dtype=torch.int32, device=dev)
    read, x0, mi, once = jobs

    def launch(ids, width):
        n = len(ids)
        stack = torch.empty((n, width, 4), dtype=idt, device=dev)
        calls = torch.empty((n, width, 3), dtype=torch.int32, device=dev)
        per_job = [torch.empty(n, dtype=torch.int32, device=dev)
                   for _ in range(4)]  # n_calls, n_intv, steps, chain
        rc = lib.tpubwa_smem_fwd(
            *index_args(didx), qd.data_ptr(), L, ld.data_ptr(),
            read.data_ptr(), x0.data_ptr(), mi.data_ptr(), once.data_ptr(),
            ids.data_ptr(), n, width, queue.data_ptr(), stack.data_ptr(),
            calls.data_ptr(), *(x.data_ptr() for x in per_job), dev.index,
            stream_of(qd))
        _refused(lib, rc, False, idt, L, dev.index, "smem_fwd")
        bump(run_fwd)
        return (stack, calls, *per_job)

    return collect_calls(launch, len(read), slots, dev, stats=stats)


run_fwd.launches = 0


def run_bwd(didx: DeviceIndex, qd: torch.Tensor, ld: torch.Tensor, read, x,
            m, min_intv, stack, min_seed_len: int, stats=None):
    """tpubwa's ``run_bwd`` (smem_split.py:418): each call's backward pass
    from its stack; the calls are (read int32 [c], x int32 [c], m int32
    [c], min_intv idt [c]) and their stacks ``stack`` (idt [sum of m,
    4], as ``Calls.stack``; ``bwd_calls`` makes the calls of a
    ``Calls``).  Returns (rows idt [r, 5] (x0, x1, size, qb, qe), call-major,
    each call's by query start, counts int32 [c]), on the reads' device.
    CPU tensors run ``run_bwd_plain``; CUDA tensors launch K-bwd once
    (``run_bwd.launches``), its rows sized by the calls' m.  Reads longer
    than K-bwd takes raise RuntimeError on both routes.  A ``stats``
    dict gets ``steps`` and ``chain`` (int32 a call)."""
    check_calls(didx, qd, ld, read, x, m, min_intv, stack)
    L = qd.shape[1]
    check_ksplit_len(L, didx.idt, ksplit_max_len(didx.idt))
    if not _kernel_route(qd):
        return run_bwd_plain(didx, qd, ld, read, x, m, min_intv, stack,
                             min_seed_len, stats=stats)
    lib = _build.load("smem", _SIGNATURES)
    dev, idt = qd.device, didx.idt
    n, total = len(read), len(stack)
    mm = m.long()
    off = torch.cumsum(mm, 0) - mm
    queue = torch.empty(1, dtype=torch.int32, device=dev)
    rows = torch.empty((total, 5), dtype=idt, device=dev)
    counts, steps, chain = (torch.empty(n, dtype=torch.int32, device=dev)
                            for _ in range(3))
    rc = lib.tpubwa_smem_bwd(
        *index_args(didx), qd.data_ptr(), L, read.data_ptr(), x.data_ptr(),
        m.data_ptr(), off.data_ptr(), min_intv.data_ptr(), stack.data_ptr(),
        n, min_seed_len, queue.data_ptr(), rows.data_ptr(),
        counts.data_ptr(), steps.data_ptr(), chain.data_ptr(), dev.index,
        stream_of(qd))
    _refused(lib, rc, True, idt, L, dev.index, "smem_bwd")
    bump(run_bwd)
    if stats is not None:
        stats.update(steps=steps, chain=chain)
    return call_rows(rows, counts, m), counts


run_bwd.launches = 0


def run_split(didx: DeviceIndex, qd: torch.Tensor, ld: torch.Tensor, jobs,
              min_seed_len: int):
    """``run_smem_jobs``'s contract through the halves: ``run_fwd`` over
    ``jobs``, then ``run_bwd`` over every call it recorded.  Returns
    (rows idt [n, 5], job-major, counts int32 [jobs])."""
    calls = run_fwd(didx, qd, ld, jobs)
    rows, n = run_bwd(didx, qd, ld, *bwd_calls(jobs, calls), calls.stack,
                      min_seed_len)
    counts = torch.zeros(len(jobs[0]), dtype=I64, device=qd.device)
    return rows, counts.index_add_(0, calls.job, n.long()).int()


def rounds12_split(opt, didx: DeviceIndex, qd: torch.Tensor,
                   ld: torch.Tensor):
    """tpubwa's ``rounds12_split`` (smem_split.py:453): rounds 1 and 2 as
    jobs (``smem_cursor.rounds12_jobs``) over ``run_split``: round 1's
    forward passes a job a read, then the backward pass of every call,
    then round 2's one-shot jobs likewise.  Returns (rows idt [n, 5], rids
    int64 [n]): round 1's rows (read-major), then round 2's (job by
    job)."""
    return rounds12_jobs(opt, didx, qd, ld, run_split)
