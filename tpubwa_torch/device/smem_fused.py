"""Rounds 1 and 2 of mem_collect_intv for a read chunk on the device, the
counterpart of tpubwa/device/smem_fused.py:rounds12_megaq (seed mode
``megaq``).

Two versions, bit-identical by test:

* ``rounds12_plain``: read by read, in the shape of ``ref/smem.py``,
  over the plain ``set_intv``/``bwt_extend_plain`` of ``device/occ.py``;
  for the tests and ``chip_smoke.py``'s phase 3h (it steps one interval
  at a time, far too slow for a chunk);
* K2, the hand-written CUDA kernel ``collect12_kernel`` of
  ``csrc/smem.cu`` (a warp a read from a read queue, over
  ``csrc/smem.cuh``), reached through ``rounds12_megaq`` for CUDA
  tensors.

``rounds12_megaq`` routes by the tensors' device: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises.  Over an
index split into row slabs (``dist/index_tp.py:TpIndex``) the plain
version reads through its routed accessors and the card runs K2's TP
instantiation, which takes each row from the slab that holds it.  Nothing
falls back from one to the other, and no row is seeded on the host.  K2
keeps a read's stacks in shared memory, so it takes reads of at most
``k2_max_len`` bases; both routes refuse longer ones.

Unlike tpubwa's lockstep machine, K2 follows bwa's scalar protocol read
by read (the port's native seeder, ``native/smem.cpp``): every bound
comes from the read's length, so no lane overflows, and there is no
retry machine, host tail or SA fusion.  A read's rows go to a fixed
number of row slots; a read with more is counted exactly and re-run in
a second launch with room for the largest count (``collect12``).  The
plain version counts what the kernel's warp does one step after
another (``stats["chain"]``: forward steps, and backward strips of up
to 32 intervals).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .counts import bump
from .occ import (DeviceIndex, I64, _kernel_route, _raise_on,
                  bwt_extend_plain, set_intv, sharded)

# row slots a read in K2's first launch: a 100 bp read has a few rows,
# a repeat more; a read with more is re-run (collect12), a launch whose
# time is its reads' chains (PERF.md §6: at 32 slots, two reads of 33
# rows cost a third of the chunk's first launch)
K2_SLOTS = 64
# K2's stacks a read, in its warp's shared memory: curr, prev, a call's
# rows and round 1's rows, L + 1 intervals each
K2_STACKS = 4
# a block's shared memory on an H100 (the card K2 is written for): the
# CPU route refuses what the card refuses
H100_BLOCK_SMEM = 232448
# lanes a warp: a backward strip
WARP = 32

_VP, _CI, _CL = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # (occ, L2, primary, seq_len, idx64, q, L, lens, rids, n,
    #  min_seed_len, split_len, split_width, slots, queue, rows,
    #  counts, steps, chain, device, stream) -> cudaError_t
    "tpubwa_smem_rounds12": (_CI, [_VP, _VP, _CL, _CL, _CI, _VP, _CL, _VP,
                                   _VP, _CL, _CI, _CI, _CL, _CI, _VP, _VP,
                                   _VP, _VP, _VP, _CI, _VP]),
    # (idx64, L, device, out int64[5]) -> cudaError_t
    "tpubwa_smem_rounds12_shape": (_CI, [_CI, _CL, _CI, _VP]),
    # K2's TP instantiation: (n_slabs, the occ slab table, then
    # tpubwa_smem_rounds12's arguments from L2 on) -> cudaError_t
    "tpubwa_smem_rounds12_tp": (_CI, [_CI, _VP, _VP, _CL, _CL, _CI, _VP,
                                      _CL, _VP, _VP, _CL, _CI, _CI, _CL,
                                      _CI, _VP, _VP, _VP, _VP, _VP, _CI,
                                      _VP]),
    # (occ, L2, primary, seq_len, idx64, q, L, lens, n, min_len,
    #  max_intv, maxh, queue, hits, n_hits, steps, chain, longest, device,
    #  stream) -> cudaError_t
    "tpubwa_seed_strategy": (_CI, [_VP, _VP, _CL, _CL, _CI, _VP, _CL, _VP,
                                   _CL, _CI, _CL, _CI, _VP, _VP, _VP, _VP,
                                   _VP, _VP, _CI, _VP]),
    # (idx64, n, device, out int64[5]) -> cudaError_t
    "tpubwa_seed_strategy_shape": (_CI, [_CI, _CL, _CI, _VP]),
    # K-cur: (occ, L2, primary, seq_len, idx64, q, L, lens, read, x0,
    #  min_intv, one_shot, ids, n, min_seed_len, slots, queue, rows,
    #  counts, steps, chain, device, stream) -> cudaError_t
    "tpubwa_smem_jobs": (_CI, [_VP, _VP, _CL, _CL, _CI, _VP, _CL, _VP, _VP,
                               _VP, _VP, _VP, _VP, _CL, _CI, _CI, _VP, _VP,
                               _VP, _VP, _VP, _CI, _VP]),
    # (idx64, L, device, out int64[5]) -> cudaError_t
    "tpubwa_smem_jobs_shape": (_CI, [_CI, _CL, _CI, _VP]),
    # K-fwd: (occ, L2, primary, seq_len, idx64, q, L, lens, read, x0,
    #  min_intv, one_shot, ids, n, slots, queue, stack, calls, n_calls,
    #  n_intv, steps, chain, device, stream) -> cudaError_t
    "tpubwa_smem_fwd": (_CI, [_VP, _VP, _CL, _CL, _CI, _VP, _CL, _VP, _VP,
                              _VP, _VP, _VP, _VP, _CL, _CI, _VP, _VP, _VP,
                              _VP, _VP, _VP, _VP, _CI, _VP]),
    # K-bwd: (occ, L2, primary, seq_len, idx64, q, L, read, x, m, off,
    #  min_intv, stack, n, min_seed_len, queue, rows, counts, steps,
    #  chain, device, stream) -> cudaError_t
    "tpubwa_smem_bwd": (_CI, [_VP, _VP, _CL, _CL, _CI, _VP, _CL, _VP, _VP,
                              _VP, _VP, _VP, _VP, _CL, _CI, _VP, _VP, _VP,
                              _VP, _VP, _CI, _VP]),
    # (kind, idx64, L, n, device, out int64[10]) -> cudaError_t
    "tpubwa_smem_split_shape": (_CI, [_CI, _CI, _CL, _CL, _CI, _VP]),
}


def split_len_of(opt) -> int:
    """bwa's split_len: reads at least this long are re-seeded."""
    return int(opt.min_seed_len * opt.split_factor + 0.499)


def reseed_jobs(opt, rows: torch.Tensor, rids: torch.Tensor):
    """Round 2's jobs from round 1's rows (tpubwa/device/smem.py:713-719,
    303-307): a row of at least split_len bases and at most split_width
    occurrences re-seeds from its middle, (qb + qe) >> 1, at min_intv =
    size + 1.  Returns (rid int32, x int32, min_intv of the rows' type),
    in the rows' order, on their device."""
    keep = ((rows[:, 4] - rows[:, 3] >= split_len_of(opt))
            & (rows[:, 2] <= opt.split_width))
    kept = rows[keep]
    return (rids[keep].int(), ((kept[:, 3] + kept[:, 4]) >> 1).int(),
            kept[:, 2] + 1)


def check_reads(didx: DeviceIndex, qd: torch.Tensor, ld: torch.Tensor):
    """Raise unless ``qd`` is uint8 [B, L] and ``ld`` int32 [B] in
    [0, L], contiguous, on the index's device; returns (B, L)."""
    if qd.dtype != torch.uint8 or qd.dim() != 2:
        raise ValueError(f"reads must be uint8 [B, L], got {qd.dtype} "
                         f"{tuple(qd.shape)}")
    B, L = qd.shape
    if ld.dtype != torch.int32 or tuple(ld.shape) != (B,):
        raise ValueError(f"lens must be int32 [{B}], got {ld.dtype} "
                         f"{tuple(ld.shape)}")
    for name, x in (("reads", qd), ("lens", ld)):
        if x.device != didx.device:
            raise ValueError(f"{name} is on {x.device}, the index on "
                             f"{didx.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if B and bool(((ld < 0) | (ld > L)).any()):
        raise ValueError(f"a read length outside [0, {L}]")
    return B, L


def index_args(didx: DeviceIndex):
    """The index arguments of csrc/smem.cu's entries: occ, L2, primary,
    seq_len, idx64."""
    fm = didx.upload_fm()
    return (fm["occ_blocks"].data_ptr(), fm["L2"].data_ptr(), didx.primary,
            didx.seq_len, int(didx.idt == I64))


def stream_of(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


# ---------------------------------------------------------------------
# the plain version (ref/smem.py's shape, one read at a time)
#
# Each read's protocol is a generator that yields its next extension, an
# interval (x0, x1, size), a base and a direction, and is sent the
# extended interval (x0, x1, size) back; ``run_reads`` batches the
# pending extensions of all reads into one bwt_extend_plain call a
# direction and step.  A read's steps are its own, in its own order:
# only the calls are shared.

def run_reads(didx: DeviceIndex, gens):
    """Drive one generator a read (see above) to its end over
    ``device/occ.py``'s plain ``bwt_extend_plain``.  Returns (their
    return values, the bwt_extend calls each made)."""
    out, steps, pending = [None] * len(gens), [0] * len(gens), {}

    def advance(r, value):
        try:
            pending[r] = gens[r].send(value)
        except StopIteration as stop:
            out[r] = stop.value
            pending.pop(r, None)

    for r in range(len(gens)):
        advance(r, None)
    while pending:
        for is_back in (True, False):
            rs = [r for r, req in pending.items() if req[2] == is_back]
            if not rs:
                continue
            ik = torch.tensor([pending[r][0] for r in rs], dtype=didx.idt,
                              device=didx.device)
            c = torch.tensor([pending[r][1] for r in rs], device=didx.device)
            ok = bwt_extend_plain(didx, ik, is_back)[
                torch.arange(len(rs), device=didx.device), c].tolist()
            for r, v in zip(rs, ok):
                steps[r] += 1
                advance(r, tuple(v))
    return out, steps


def base_intervals(didx: DeviceIndex):
    """set_intv of each base, as four (x0, x1, size)."""
    return [tuple(v) for v in set_intv(didx, torch.arange(4)).tolist()]


def new_tally():
    """What K2's warp does with a read, counted by the plain version:
    ``chain`` (forward steps, plus backward strips of up to ``WARP``
    intervals: the rounds of bwt_extend calls made one after another),
    ``widest`` (the most intervals one backward step extends) and
    ``late`` (backward steps whose first failing interval follows a
    survivor, where without the survivor it would be emitted: none on an
    index, where the sizes grow along the stack)."""
    return {"chain": 0, "widest": 0, "late": 0}


def smem1a_fwd_plain(base, q, x: int, min_intv: int, tally):
    """smem1a's forward half (csrc/smem.cuh:smem1a_fwd), a generator over
    ``run_reads``: from x (q[x] <= 3) the stack of pushed intervals
    [x0, x1, size, 0, qe], longest match (smallest interval) first, and
    the call's return, the first interval's qe."""
    n = len(q)
    min_intv = max(min_intv, 1)
    ik = [*base[q[x]], 0, x + 1]
    curr = []
    i = x + 1
    while i < n:
        if q[i] > 3:
            curr.append(ik)
            break
        # forward extension reads the complement's slot
        ok = [*(yield (ik[:3], 3 - q[i], False)), ik[3], ik[4]]
        tally["chain"] += 1
        if ok[2] != ik[2]:
            curr.append(ik)
            if ok[2] < min_intv:
                break
        ik = ok
        ik[4] = i + 1
        i += 1
    if i == n:
        curr.append(ik)
    curr.reverse()
    return curr, curr[0][4]


def smem1a_bwd_plain(q, x: int, min_intv: int, prev, tally):
    """smem1a's backward half (csrc/smem.cuh:smem1a_bwd), a generator over
    ``run_reads``: from the stack ``prev`` that ``smem1a_fwd_plain`` left
    for a call at x, the SMEMs [x0, x1, size, qb, qe] by query start."""
    min_intv = max(min_intv, 1)
    mem = []
    i = x - 1
    while i >= -1:
        c = -1 if i < 0 or q[i] > 3 else q[i]
        if c >= 0:
            tally["chain"] += -(-len(prev) // WARP)
            tally["widest"] = max(tally["widest"], len(prev))
        curr, failed = [], False
        for p in prev:
            ok = (yield (p[:3], c, True)) if c >= 0 else None
            if c < 0 or ok[2] < min_intv:
                emits = not mem or i + 1 < mem[-1][3]
                tally["late"] += bool(curr) and emits and not failed
                failed = True
                if not curr and emits:
                    mem.append([p[0], p[1], p[2], i + 1, p[4]])
            elif not curr or ok[2] != curr[-1][2]:
                curr.append([*ok, p[3], p[4]])
        if not curr:
            break
        prev = curr
        i -= 1
    mem.reverse()
    return mem


def smem1a_plain(base, q, x: int, min_intv: int, tally):
    """bwt_smem1a with max_intv = 0 (ref/smem.py:smem1a), a generator
    over ``run_reads``: the SMEMs of q (a list of codes) covering x, as
    [x0, x1, size, qb, qe] by query start, and the next x.  ``base``:
    ``base_intervals``; ``tally`` (``new_tally``) is added to.  It is
    ``smem1a_fwd_plain``, then ``smem1a_bwd_plain`` on the stack it
    leaves (seed mode split runs the halves apart)."""
    if q[x] > 3:
        return [], x + 1
    prev, ret = yield from smem1a_fwd_plain(base, q, x, min_intv, tally)
    mem = yield from smem1a_bwd_plain(q, x, min_intv, prev, tally)
    return mem, ret


def collect12_read(base, q, min_seed_len: int, split_len: int,
                   split_width: int, tally):
    """Rounds 1 and 2 of one read (native/smem.cpp:468-485), a generator
    over ``run_reads``: the round-1 rows of at least min_seed_len bases,
    then the round-2 rows of each re-seeded round-1 row in turn.
    ``tally`` (``new_tally``) is added to."""
    r1 = []
    x = 0
    while x < len(q):
        if q[x] > 3:
            x += 1
            continue
        mem, x = yield from smem1a_plain(base, q, x, 1, tally)
        r1 += [m for m in mem if m[4] - m[3] >= min_seed_len]
    r2 = []
    for p in r1:
        if p[4] - p[3] < split_len or p[2] > split_width:
            continue
        mem, _ = yield from smem1a_plain(base, q, (p[3] + p[4]) >> 1,
                                         p[2] + 1, tally)
        r2 += [m for m in mem if m[4] - m[3] >= min_seed_len]
    return r1 + r2


def read_lists(qd: torch.Tensor, ld: torch.Tensor):
    """Each read's codes as a list of ints."""
    qn, lens = qd.cpu().numpy(), ld.cpu().numpy()
    return [qn[r, :lens[r]].tolist() for r in range(len(lens))]


def rounds12_plain(opt, didx: DeviceIndex, qd: torch.Tensor,
                   ld: torch.Tensor, stats=None):
    """K2's contract, read by read: (rows idt [n, 5] (x0, x1, size, qb,
    qe), rids int64 [n]), read-major, each read's rows in the order
    found.  A ``stats`` dict gets ``steps`` (int32 [B], the bwt_extend
    calls a read), ``chain``, ``widest`` and ``late`` (int32 [B] each,
    see ``new_tally``) and ``second_launch_reads`` (0: the plain version
    has no slots)."""
    check_reads(didx, qd, ld)
    base = base_intervals(didx)
    reads = read_lists(qd, ld)
    tallies = [new_tally() for _ in reads]
    got, steps = run_reads(didx, [
        collect12_read(base, q, opt.min_seed_len, split_len_of(opt),
                       opt.split_width, t) for q, t in zip(reads, tallies)])
    rows = [row for rs in got for row in rs]
    rids = [r for r, rs in enumerate(got) for _ in rs]
    if stats is not None:
        stats["steps"] = torch.tensor(steps, dtype=torch.int32)
        for key in new_tally():
            stats[key] = torch.tensor([t[key] for t in tallies],
                                      dtype=torch.int32)
        stats["second_launch_reads"] = 0
    return (torch.tensor(rows, dtype=didx.idt).reshape(-1, 5).to(qd.device),
            torch.tensor(rids, dtype=I64, device=qd.device))


# ---------------------------------------------------------------------
# the kernel

def k2_max_len(idt) -> int:
    """The longest read K2 takes on an H100 with ranks of ``idt``: its
    warp's stacks, ``K2_STACKS`` x (L + 1) intervals of five ranks, must
    fit a block's shared memory."""
    return H100_BLOCK_SMEM // (K2_STACKS * 5 * idt.itemsize) - 1


def check_k2_len(L: int, idt, max_len: int):
    """Raise RuntimeError, naming the limit, where reads of ``L`` bases
    are longer than ``max_len`` (``k2_max_len``)."""
    if L > max_len:
        raise RuntimeError(
            f"K2 takes reads of at most {max_len} bases with {idt} ranks "
            f"(its {K2_STACKS} stacks of L + 1 intervals a read live in a "
            f"block's shared memory), got L = {L}")


def collect12(launch, n_reads: int, slots: int, device, stats=None):
    """K2's launches (and K-cur's, a job for a read:
    ``smem_cursor.run_smem_jobs``): ``launch(rids, slots)`` seeds the
    reads ``rids``
    (int32 [n]) with ``slots`` row slots each and returns (rows idt
    [n, slots, 5], counts int32 [n], steps int32 [n], chain int32 [n]); a
    count past ``slots`` is exact, its rows past the slots unwritten.
    The first launch seeds every read; the second, only where it runs,
    the reads whose count passed ``slots``, with as many slots as the
    largest count.  Returns (rows idt [n, 5], rids int64 [n]),
    read-major."""
    rids = torch.arange(n_reads, dtype=torch.int32, device=device)
    rows, counts, steps, chain = launch(rids, slots)
    over = counts > slots
    n_over = int(over.sum())
    parts = [(rids, rows, torch.where(over, 0, counts), slots)]
    if n_over:
        again = rids[over]
        most = int(counts.max())
        rows2, counts2, _, _ = launch(again, most)
        parts.append((again, rows2, counts2, most))
    out_rows, out_rids = [], []
    for r, x, c, width in parts:
        keep = torch.arange(width, device=device)[None, :] < c[:, None]
        out_rows.append(x[keep])
        out_rids.append(r.long()[:, None].expand(-1, width)[keep])
    rows, rids = torch.cat(out_rows), torch.cat(out_rids)
    if n_over:
        order = torch.sort(rids, stable=True).indices
        rows, rids = rows[order], rids[order]
    if stats is not None:
        stats["steps"] = steps
        stats["chain"] = chain
        stats["second_launch_reads"] = n_over
    return rows, rids


def k2_shape(lib, idx64: bool, L: int, device_index: int):
    """(cudaError, {warp_bytes, warps, blocks_per_sm, sms, max_len}): K2's
    launch shape for reads of ``L`` bases on the card (the C entry
    ``tpubwa_smem_rounds12_shape``); the error is the one a launch at
    ``L`` returns before it runs."""
    out = (ctypes.c_int64 * 5)()
    rc = lib.tpubwa_smem_rounds12_shape(int(idx64), L, device_index, out)
    return rc, dict(zip(("warp_bytes", "warps", "blocks_per_sm", "sms",
                         "max_len"), list(out)))


def rounds12_megaq(opt, didx: DeviceIndex, qd: torch.Tensor,
                   ld: torch.Tensor, slots: int = K2_SLOTS, stats=None):
    """Rounds 1 and 2 of mem_collect_intv for a chunk: reads uint8 [B, L]
    (codes, 4 = N), lens int32 [B] -> (rows idt [n, 5] (x0, x1, size, qb,
    qe), rids int64 [n]), read-major, each read's round-1 rows then its
    round-2 rows in the order found (the native seeder's).  CPU tensors
    run ``rounds12_plain``; CUDA tensors launch K2 (``csrc/smem.cu``),
    with ``slots`` row slots a read in the first launch
    (``rounds12_megaq.launches`` counts the launches).  Reads longer than
    K2 takes raise RuntimeError on both routes (``k2_max_len``: on the
    card the card's own limit, which the launch reports by refusing).  A
    ``stats`` dict gets ``steps`` and ``chain`` (int32 [B], bwt_extend
    calls a read and the rounds of them made one after another) and
    ``second_launch_reads``.  Over a ``TpIndex`` the card runs K2's TP
    instantiation (``rounds12_megaq.tp_launches``); a mark-less one
    raises NotImplementedError on both routes (tpubwa's)."""
    B, L = check_reads(didx, qd, ld)
    if slots < 1:
        raise ValueError(f"slots must be positive, got {slots}")
    tp = sharded(didx)
    if tp:
        tp.check_marked()
    if not _kernel_route(qd):
        check_k2_len(L, didx.idt, k2_max_len(didx.idt))
        return rounds12_plain(opt, didx, qd, ld, stats=stats)
    lib = _build.load("smem", _SIGNATURES)
    if tp:
        entry, count = lib.tpubwa_smem_rounds12_tp, "tp_launches"
        index = (tp.n, tp.kernel_table("occ_blocks"), tp.L2.data_ptr(),
                 tp.primary, tp.seq_len, int(tp.idt == I64))
    else:
        entry, count = lib.tpubwa_smem_rounds12, "launches"
        index = index_args(didx)
    dev, idt = qd.device, didx.idt
    queue = torch.empty(1, dtype=torch.int32, device=dev)

    def launch(rids, width):
        n = len(rids)
        rows = torch.empty((n, width, 5), dtype=idt, device=dev)
        counts = torch.empty(n, dtype=torch.int32, device=dev)
        steps = torch.empty(n, dtype=torch.int32, device=dev)
        chain = torch.empty(n, dtype=torch.int32, device=dev)
        rc = entry(
            *index, qd.data_ptr(), L, ld.data_ptr(), rids.data_ptr(), n,
            opt.min_seed_len, split_len_of(opt), opt.split_width, width,
            queue.data_ptr(), rows.data_ptr(), counts.data_ptr(),
            steps.data_ptr(), chain.data_ptr(), dev.index, stream_of(qd))
        if rc:
            _, shape = k2_shape(lib, idt == I64, L, dev.index)
            check_k2_len(L, idt, shape["max_len"])
        _raise_on(rc, "smem_rounds12")
        bump(rounds12_megaq, count)
        return rows, counts, steps, chain

    return collect12(launch, B, slots, dev, stats=stats)


rounds12_megaq.launches = 0
rounds12_megaq.tp_launches = 0
