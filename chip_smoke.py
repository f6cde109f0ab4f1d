#!/usr/bin/env python3
"""Smoke run of tpubwa_torch on one NVIDIA GPU: the quickest proof that
the port builds, agrees with its plain PyTorch versions, and runs
`mem` end to end on the card.

Usage (from the root of a checkout, one CUDA card visible):

    python3 chip_smoke.py

Phases, one output line each (a failing phase raises, exit != 0):
  1. toolchain facts (torch, CUDA, nvcc, triton, nvidia-smi);
  2. build of the CUDA kernels from tpubwa_torch/csrc (nvcc, sm_90a; one
     nvcc per source, all five started together), with ptxas's
     registers and spills for each;
  3. the extension kernel == extend_batch_plain on the card, exactly,
     at the three tile shapes of the main path (W 128, 256, 512) and on
     the strip-edge jobs (long gap runs, row-max ties 32 and 64 columns
     apart, every band residue mod 32, closed bands); a tile too wide
     for a block's shared memory must raise; and descriptor extension
     kernel == plain on adversarial descriptors, with CUDA-event times
     of a 4,096-row wave, of each of its four launches alone and of the
     wave without the extension;
 3b. the int16 extension kernel (a warp per job, two columns a lane in
     16-bit halves) == extend_batch16_plain == K1's kernel, exactly,
     each launch synchronised, at phase 3's three tile shapes, on the
     64-column strip-edge jobs (every band residue mod 64, odd beg,
     row-max ties 64 and 128 columns apart, F runs across 64-column
     edges), on jobs at both edges of the int16 domain (h0 and gap
     open) and on jobs whose band's cap moves beg to 1; a tile too wide
     for a block's shared memory must raise; at the main shape its time
     and K1's through the wrappers and alone in interleaved passes
     (i16_over_k1), with the rows, cells a row and strips of 32 and 64
     a row; then the ported int16
     experiment (tpubwa_torch.scripts.exp_int16_kernel.main: int32
     against int16 timing, and its 1,920-job equality fuzz, which must
     find 0 mismatches), whose int16 kernel launches are counted;
 3c. every K1-real variant's kernel (an instantiation of extend.cu's
     template) == extend_real_plain, exactly, each launch synchronised,
     at phase 3's main shape, on the script's jobs, on jobs built for
     z-drop and the band write-back and on the W 128 strip-edge jobs
     (each no-* variant must differ from full on one job at least); the
     four exact variants == K1's kernel, no-zdrop == K1 with zdrop 0,
     no-scan == K1-floor's -scan; full, -u2 and -u4 == plain on the
     experiment's 131,072 jobs; every variant and K1 timed alone in
     interleaved passes, with full's time over K1's; then the ported
     real-kernel experiment
     (tpubwa_torch.scripts.exp_kernel_real.main at 512, 16,384 and
     131,072 jobs, and its equality fuzz against K1), whose K1-real
     launches are counted;
 3d. every K1-floor ablation (scan, pk, hopen, trim, trees, scan+trees)
     == extend_batch_plain with the same ablation, exactly, on phase
     3's main shape, the floor script's 512 jobs, z-drop jobs and the
     strip-edge jobs (each must differ from K1 on one job at least),
     and the floor entry with no ablation == K1's entry; then the
     ported floor experiment
     (tpubwa_torch.scripts.exp_kernel_floor.main at 512 and 131,072
     jobs), whose K1-floor launches are counted;
 3e. compute-sanitizer's memcheck and initcheck over every
     instantiation of the three sources (K1 and its 15 floor
     ablations, K1-i16, K1-real's 10 variants, K1-bd's 9) on 256 jobs,
     in a child process: any error it reports fails; a tool that is
     missing or cannot run the child is printed as such, never as a
     pass;
 3f. every K1-bd variant's kernel (a warp per job in its live and its
     frozen pass) == extend_bd_plain, exactly, on phase 3's main shape,
     the breakdown script's 512 jobs, jobs that die at rows of their own
     (alone and beside a survivor), 64 jobs whose tlen exceeds N (tdot's
     row cap), a 252-row tile and jobs whose frozen trim reads above
     their last live row's end_i (each variant must differ from baseline
     on one job at least; a dying job alone must differ from its result
     in the launch); a tile too wide for a block's shared memory must
     raise; at the main shape baseline alone beside K1 alone
     (bd_over_k1), its live and frozen kernels' device times from a
     torch.profiler trace of its launches, with the live and frozen
     cells; then the ported breakdown experiment
     (tpubwa_torch.scripts.exp_kernel_breakdown.main at 512 and
     131,072 jobs), whose K1-bd launches are counted;
  4. `mem --device cuda` on tests/golden: SE and PE SAM byte-equal to
     the snapshots (tpubwa's own output), @PG stripped;
  5. the main path at real size: 2 batches x 8,192 pairs of 100 bp PE
     reads on the 64 Mbp repeat-realistic synthetic genome, through
     the port's process_batches with its aligner on cuda; the first 512
     pairs' SAM equals a run with device="cpu" and one through the
     port's scalar host pipeline; then the four launches of the first
     batch's first wave, each timed alone (the shape the main path
     gives K1), and the seeding stage's wall (native seeding on the
     host, the GPU bracketed by synchronize).  The native walk serves
     every SA position: no FM array goes up to the card;
 5b. the same index as a user's stock bwa files (save_bwa, its ALT
     contig in a .alt file, loaded as `mem` loads a prefix), through
     the port's aligner on cuda on phase 5's 2 x 8,192 pairs: the SA
     positions come from K-sa (csrc/occ.cu's rank-sampled walk).  Its
     SAM must equal phase 5's byte for byte; K-sa must launch, the
     extension kernel K-ext must not.  Reads/s, the SA stage's wall
     (the GPU bracketed by synchronize), the ranks walked, and the
     first launch's ranks again: K-sa alone (its C entry) and through
     its wrapper in interleaved passes, alone after a 64 MB write that
     flushes L2 (cold), beside its plain version and its bound, with
     the LF steps of its longest walk and the time a step of that walk
     takes, its grid (blocks, warps an SM) and registers, and the SASS
     loads of one LF step in both walks (how many rounds they issue
     in);
 3g. (after 5b, whose index it uses) K-sa and K-ext == their plain
     versions in every instantiation (marked and rank-sampled walk,
     backward and forward extension, int32 and int64 ranks) on the
     3,000-base test genome and on phase 5's 64 Mbp index (2^16
     random ranks and the edge ranks; intervals from set_intv, then a
     backward and a forward step), K-sa == the native walk on the
     marked 64 Mbp index, each 64 Mbp instantiation timed alone (its C
     entry) in interleaved passes (K-sa also cold, K-ext also through
     its wrapper), with the LF steps a rank and a warp; K-sa's C entry
     must refuse 2^31 - 1 ranks (its rank queue's range) before it
     runs; then the extension path driven once with the counts at 0;
 5c. phase 5's 2 x 8,192 pairs through the port's aligner on cuda with
     TPUBWA_SEED_MODE=megaq (as `mem` runs it): every seeding row from
     K2 and K3 (csrc/smem.cu), with the counts at 0 just before the run.
     Its SAM must equal phase 5's byte for byte.  Reads/s and the
     seeding stage's wall beside phase 5's, the reads that took K2's
     second launch, and each mode's device busy share over a profiled
     pass of the first batch;
 3h. (after 5c, whose first chunk it uses) K2 and K3 == their plain
     versions (on CPU copies of the index) in every instantiation, K2
     also at one row slot a read (its second launch), with their steps
     and chain a read (K3's longest scan a read too), on the 3,000-base
     genome and on 256 reads of 5c's first chunk with the edge reads
     (across the sentinel's row both ways, a repeat unit, random, one
     base, all N); megaq rows == the native seeder's on all 32,768 of
     phase 5's reads, int32 and int64; then each kernel alone on that
     chunk (16,384 reads, the main path's launch) in interleaved passes
     (K3 in both instantiations), with its bwt_extend steps a read, the
     sectors of the index it reads (counted by csrc/smem_host.cpp) and
     its chain a read (K2, a warp a read: forward steps plus backward
     strips; K3, a group of lanes a read: one step a round, with the
     longest single scan and the time a step of the longest chain); K2's
     launch shape (warps a block and an SM) and registers, K3's (lanes a
     read, warps an SM, the grid), registers and stack frame in both
     instantiations and the rounds of its step's row loads in SASS; K2
     must refuse reads one base past its limit, in the C entry and the
     wrapper; and the global loads of K2's and K3's SASS;
 5d. phase 5's 2 x 8,192 pairs in megaq on 5b's stock-bwa index: K2 and
     K3 seed every read and K-sa walks every SA position in one run,
     with the counts at 0 just before it.  Its SAM must equal phase 5's
     byte for byte, and K2, K3 and K-sa must each launch.
 5e. phase 5's 2 x 8,192 pairs with TPUBWA_SEED_MODE=hybrid (tpubwa's
     defaults: share 0.25 at first, the balancer on, floor 64): each
     chunk's first k reads on K2 and K3 beside the native seeder on the
     rest, in two passes (16,384-read chunks, then 4,096), each with a
     new balancer and the counts at 0 just before it.  Each pass's SAM
     must equal phase 5's byte for byte, K2 and K3 must launch, and every
     chunk of at least k_floor / f reads must be split (0 < k < B); each
     chunk's (B, k, t_dev, t_host, f) and each pass's reads/s and seeding
     stage beside phase 5's and 5c's.
Then the bounds (each kernel's least time on this card: the band cells
its plain version counted on the timed inputs, times the integer
instructions per cell, over the card's integer rate; or its bytes over
HBM bandwidth, whichever is larger.  The instructions per cell are
constants of the recurrence, RECURRENCE_OPS, so the bound does not move
with the kernel's design.  The FM-index kernels are bound by bytes
alone: the distinct 32-byte sectors of the index that the plain
version's reads touch, with their inputs and outputs), a JSON line
of the kernels (launches on each kernel's path: K1
in phase 5, K-sa in 5b, K2 and K3 in 5c and 5e, the int16 kernel in the
experiment of phase 3b, K1-real in that of 3c, K1-floor in that of 3d,
K1-bd in that of 3f, K-ext on 3g's extension path; errors, times,
bounds) and, last,
{"ok": true, "device": {...}}.

Everything it builds or caches (kernels, the native host libraries, the
benchmark index) goes under build/ in the checkout.  It imports nothing
of JAX and nothing of the tpubwa package.
"""
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(ROOT, "build")
DEV = "cuda"
GENOME_MB = 64          # the benchmark genome of phase 5
PAIRS = 8192            # pairs per batch in phase 5 (2 batches)
HBM_BYTES_S = 3.35e12   # H100 SXM HBM3 (NVIDIA's data sheet)
INT32_LANES = 64        # INT32 lanes per SM per clock on Hopper
SCHED_LANES = 128       # 4 schedulers x 32 lanes per SM per clock
# Integer instructions per band cell of the ksw_extend recurrence (score,
# M, H, E, F, the running max and argmax), as constants: ALU-only ops and
# all issued integer ops, the least any kernel of this repo has needed
# for them (its one-thread-per-job band loop in SASS, without memory,
# control, moves, address arithmetic and the loop counter).  K1's,
# K1-real's and K1-floor's bounds use these, so that the bound is that
# of the work and does not follow the kernel's design.  K1-floor's row
# is its -scan instantiation: no F term.  K1-real's row is the same
# recurrence under its script's fixed scoring, which folds into
# immediates: one op a cell fewer, read in SASS from the one-thread-per-
# job band loop that ran K1-real's full with that scoring compiled in.
# K1-i16's row is K1's recurrence on int16 cells, two to every 32-bit
# operation: Hopper's 16x2 instructions (VIADDMNMX.S16x2, VIMNMX.S16x2,
# VIADD.16x2) compute both halves of a register at once, so the least
# work a cell needs in int16 is half K1's.  K1-bd's row is K1-real's
# recurrence under the same fixed scoring without the argmax, which
# K1-bd does not keep: the one-thread K1-real loop (`git show
# 5163bc9:tpubwa_torch/csrc/extend_real.cu`, nvcc -O3 for sm_90a, read
# by sass_loops) gives 12.25 / 14.25 for full, K1-real's row, and
# 11.0 / 12.0 for its no-mj instantiation, whose loop keeps the row max
# alone.  A cell of that loop (SASS, 4 cells a trip): the score (2
# ISETP, 2 SEL), M (ISETP, IMAD.IADD, SEL), max(M - oe, 0) (VIADDMNMX,
# shared by E and F under the fixed scoring), E (VIADDMNMX), F
# (VIADDMNMX), H = max(M, E, F, 0) (VIMNMX3.RELU), the row max (VIMNMX):
# 11 ALU ops and the one IMAD.IADD.  K1-bd's frozen cells need neither
# F (the frozen pass's proof in csrc/extend_bd.cu) nor the E update (a
# frozen row's E stays as it was handed over), so their row is 3 ops
# fewer: 8.0 / 9.0, H a two-way max with the relu, still one op.
RECURRENCE_OPS = {
    "ksw_extend": {"alu_per_cell": 13.25, "int_per_cell": 15.25},
    "ksw_extend_real": {"alu_per_cell": 12.25, "int_per_cell": 14.25},
    "ksw_extend_floor": {"alu_per_cell": 11.25, "int_per_cell": 13.25},
    "ksw_extend16": {"alu_per_cell": 6.625, "int_per_cell": 7.625},
    "ksw_extend_bd": {"alu_per_cell": 11.0, "int_per_cell": 12.0},
    "ksw_extend_bd_frozen": {"alu_per_cell": 8.0, "int_per_cell": 9.0},
}

# The kernels line's rows: (name, source under tpubwa_torch/csrc, the TPU
# kernel it replaces, the instantiation whose SASS strip loop and
# registers are printed, {the case's count of cells: its RECURRENCE_OPS
# key}).  Each row is one instantiation: K1 and K1-real's full are
# extend_kernel<0>, the floor row its -scan instantiation
# extend_kernel<1>, K1-bd's baseline the live pass extend_bd_live<kTable,
# no N cap, all on>.  Every row takes its work per cell from
# RECURRENCE_OPS (K1-bd's live and frozen cells each their own), with
# the kernel's own strip loop (its opcodes among it) and registers
# beside it as information.
KERNEL_ROWS = (
    ("ksw_extend", "extend", "tpubwa/device/extend_pallas.py:162",
     r"extend_kernelILi0EE", {"cells": "ksw_extend"}),
    ("ksw_extend16", "extend16", "scripts/exp_int16_kernel.py:48",
     r"extend16_kernel", {"cells": "ksw_extend16"}),
    ("extend_real", "extend", "scripts/exp_kernel_real.py:87",
     r"extend_kernelILi0EE", {"cells": "ksw_extend_real"}),
    ("ksw_extend_floor", "extend", "tpubwa/device/extend_pallas.py:224",
     r"extend_kernelILi1EE", {"cells": "ksw_extend_floor"}),
    ("ksw_extend_bd", "extend_bd", "scripts/exp_kernel_breakdown.py:54",
     r"extend_bd_liveILi0ELb0ELb1ELb1ELb1ELb1EE",
     {"live_cells": "ksw_extend_bd", "frozen_cells": "ksw_extend_bd_frozen"}))


def cell_ops(case, charge):
    """The work per cell of ``case``, averaged over its cells: each count
    of cells named in ``charge`` ({case key: RECURRENCE_OPS key}) at its
    own constant.  The counts must add up to ``case["cells"]``."""
    if sum(case[k] for k in charge) != case["cells"]:
        raise AssertionError(f"{sorted(charge)} do not add up to the cells")
    return {o: sum(case[k] * RECURRENCE_OPS[r][o] for k, r in charge.items())
            / case["cells"] for o in ("alu_per_cell", "int_per_cell")}


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def cuda_ms(fn, reps):
    """Mean ms per call over ``reps`` calls after one warm-up, timed
    with CUDA events on the current stream."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_ms(torch, fn, names, reps):
    """{name: mean device ms per launch} of the kernels whose names hold
    each of ``names``, from a torch.profiler (CUPTI) trace of ``reps``
    calls of ``fn`` after one warm-up: the time of each kernel of a
    launch that runs several, with the launch as its callers make it.
    None for a name whose kernels the trace holds no device time of."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = {k: [0.0, 0] for k in names}
    for ev in prof.key_averages():
        for k in names:
            if k in ev.key and ev.device_time_total > 0:
                us[k][0] += ev.device_time_total
                us[k][1] += ev.count
    return {k: round(t / n / 1e3, 4) if n else None
            for k, (t, n) in us.items()}


def timed_once(torch, fn):
    """(fn(), ms): one call timed with CUDA events (the plain versions
    are timed by the call that is compared)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def make_jobs(rng, n, W, tmax):
    """n extension jobs at one (W, tmax) shape: 80% queries copied from
    their target with SNPs and a small indel (high scores, band
    excursions that need the second band trial at small w), N codes on
    both sides, 5% empty targets and 2% empty queries; sorted by target
    length as the main path sorts them."""
    import numpy as np
    t = rng.integers(0, 4, (n, tmax)).astype(np.int32)
    j = np.arange(W)[None, :]
    cut = rng.integers(0, W, n)[:, None]
    shift = (rng.integers(-3, 4, n) * (rng.random(n) < 0.3))[:, None]
    src = np.clip(np.where(j < cut, j, j + shift), 0, tmax - 1)
    q = np.take_along_axis(t, src, axis=1)
    snp = rng.random((n, W)) < 0.03
    q = np.where(snp, (q + 1) % 4, q)
    rand = rng.random(n) < 0.2
    q[rand] = rng.integers(0, 4, (int(rand.sum()), W))
    q[rng.random((n, W)) < 0.005] = 4
    t[rng.random((n, tmax)) < 0.005] = 4
    qlen = rng.integers(1, W, n)
    tlen = rng.integers(1, tmax + 1, n)
    tlen[rng.random(n) < 0.05] = 0
    qlen[rng.random(n) < 0.02] = 0
    q[j >= qlen[:, None]] = 4
    t[np.arange(tmax)[None, :] >= tlen[:, None]] = 4
    p = np.stack([qlen, tlen, rng.integers(1, 60, n),
                  rng.choice([3, 10, 25, 100], n),
                  rng.choice([0, 5], n)], axis=1).astype(np.int32)
    order = np.argsort(-tlen, kind="stable")
    return q[order].astype(np.int32), t[order], p[order]


def retry_descs(bnt, rng, n, L=100):
    """n descriptor rows (and their reads, uint8 [n, L]) whose left or
    right side crosses a 3-base deletion at band w = 4: the band
    excursion reaches 3/4 w, so each side takes the second band
    trial (w = 8)."""
    import numpy as np
    reads = np.zeros((n, L), np.uint8)
    rows = []
    qbeg, slen, gap = 30, 25, 3
    for k in range(n):
        s = int(rng.integers(64, bnt.l_pac - L - 64))
        ref = bnt.get_seq(s, s + L + gap)
        d = 70 if k % 2 else 12          # in the right / left side
        reads[k] = np.concatenate([ref[:d], ref[d + gap:]])
        rbeg = s + qbeg + (gap if d < qbeg else 0)
        rows.append((k, qbeg, slen, L, rbeg, s - 20, s + L + 20, 4, slen,
                     5, 5))
    return reads, np.asarray(rows, np.int64)


def adversarial_descs(rng, lp, B, L, n):
    """(A copy of scripts/chip_desc_equality.py:mk_descs: that script is
    the JAX reference's TPU tooling and edits sys.path when imported;
    the port imports nothing of the reference.)  Adversarial
    descriptors honoring the extension_plan contract
    (windows never cross l_pac; host/regions.py clips rmax) while
    hitting every alignment edge the word path cares about."""
    import numpy as np
    rows = []
    for k in range(n):
        lq = int(rng.integers(60, L + 1))
        # sweep every sub-word phase of qbeg and rbeg
        qbeg = (k % 16) if k % 3 == 0 else int(rng.integers(0, lq - 19))
        qbeg = min(qbeg, lq - 20)
        slen = int(rng.integers(19, min(40, lq - qbeg) + 1))
        if k % 5 == 0:
            slen = lq - qbeg          # no right side
        if k % 7 == 0:
            qbeg = 0                  # no left side
        side_rev = (k >> 1) % 2
        lo, hi = (lp, 2 * lp) if side_rev else (0, lp)
        rbeg = int(rng.integers(lo, hi - slen))
        rbeg = (rbeg & ~15) | (k % 16)      # force sub-word phase
        rbeg = max(lo, min(rbeg, hi - slen))
        if k % 13 == 0:
            rbeg = lo                 # window flush at boundary start
        if k % 13 == 1:
            rbeg = hi - slen          # window flush at boundary end
        tl = int(rng.integers(0, 200)) if qbeg else 0
        tr = (int(rng.integers(0, 200)) if lq - qbeg - slen else 0)
        rmax0 = max(lo, rbeg - tl)
        rmax1 = min(hi, rbeg + slen + tr)
        rows.append((int(rng.integers(0, B)), qbeg, slen, lq, rbeg,
                     rmax0, rmax1, int(rng.choice([25, 100])), slen,
                     5, 5))
    return np.asarray(rows, np.int64)


def materialize(bnt, reads, d):
    """Scalar job tuple for one descriptor row (the oracle's input); a
    copy of scripts/chip_desc_equality.py:materialize, for the reason
    adversarial_descs gives."""
    ri, qbeg, slen, lq, rbeg, rmax0, rmax1 = (int(x) for x in d[:7])
    query = reads[ri][:lq]
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
            int(d[7]), int(d[8]), int(d[9]), int(d[10]))


def launch_facts(torch, q, t, p, pen, cells=True):
    """One K1 launch of a path, timed again on its own inputs: N, W,
    tmax, the jobs that have a target, K1 through the wrapper and alone
    (the C entry, without the wrapper's checks), and the band cells the
    plain version counts (``cells``: it takes a host sync a row)."""
    from tpubwa_torch.device import extend_kernel as ek
    facts = {"N": q.shape[0], "W": q.shape[1], "tmax": t.shape[1],
             "live_jobs": int((p[:, 1] > 0).sum()),
             "ms": round(cuda_ms(lambda: ek.extend_batch(q, t, p, *pen), 10),
                         4),
             "alone_ms": round(cuda_ms(
                 lambda: ek._extend_cuda(q, t, p, *pen), 10), 4)}
    if cells:
        stats = {}
        ek.extend_batch_plain(q, t, p, *pen, stats=stats)
        facts["cells"] = stats.get("cells", 0)
    return facts


def phase_toolchain(torch):
    from tpubwa_torch.device import _build
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    nvcc = _run([_build._nvcc(), "--version"]).splitlines()[-1]
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = None
    print("[1 toolchain] " + json.dumps({
        "python": sys.version.split()[0], "torch": torch.__version__,
        "torch_cuda": torch.version.cuda, "nvcc": nvcc,
        "triton": triton_v, "gpu": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count()}), flush=True)
    print(smi, flush=True)
    return smi


def phase_build():
    from concurrent.futures import ThreadPoolExecutor
    from tpubwa_torch.device import _build
    from tpubwa_torch.device import extend_kernel as ek
    from tpubwa_torch.device import occ
    from tpubwa_torch.scripts import exp_int16_kernel as x16
    from tpubwa_torch.scripts import exp_kernel_breakdown as xb
    from tpubwa_torch.device import smem_fused
    kernels = {"extend": ek._SIGNATURES, "extend16": x16._SIGNATURES,
               "extend_bd": xb._SIGNATURES, "occ": occ._SIGNATURES,
               "smem": smem_fused._SIGNATURES}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as ex:
        futures = [ex.submit(_build.load, name, sigs)
                   for name, sigs in kernels.items()]
        for f in futures:
            f.result()
    built = []
    for name in kernels:
        info = _build.build_info[name]
        ptxas = [l.strip() for l in info["ptxas"].splitlines()
                 if "registers" in l or "spill" in l]
        if not ptxas:
            raise AssertionError(f"no ptxas report for {name}")
        built.append({"source": f"tpubwa_torch/csrc/{name}.cu",
                      "nvcc_s": round(info["seconds"], 3),
                      "ptxas": ptxas})
    print("[2 build] " + json.dumps({
        "kernels": built, "load_s": round(time.perf_counter() - t0, 3)}),
        flush=True)


def strip_edge_sets(np):
    """[(W, tmax, names, (q, t, p))]: the strip-edge jobs
    (exp_kernel_floor.strip_edge_jobs) of each tile shape as one launch,
    with the set each job belongs to."""
    from tpubwa_torch.scripts import exp_kernel_floor as xf
    out = []
    for W, tmax in xf.STRIP_SHAPES:
        sets = xf.strip_edge_jobs(W, tmax)
        names = [name for name, s in sets.items() for _ in s[0]]
        out.append((W, tmax, names, tuple(
            np.concatenate([s[k] for s in sets.values()]) for k in range(3))))
    return out


def held_to_plain(torch, what, got, want, names=None):
    """Raise unless ``got`` equals ``want`` exactly; returns the largest
    absolute difference (0)."""
    if not torch.equal(got, want):
        bad = (got != want).any(1).nonzero()[:3, 0].tolist()
        where = f" ({[names[k] for k in bad]})" if names else ""
        raise AssertionError(f"{what}: rows {bad}{where}: "
                             f"{got[bad].tolist()} vs {want[bad].tolist()}")
    return int((got.long() - want.long()).abs().max()) if len(got) else 0


def phase_kernel(torch, np):
    from tpubwa_torch.opts import MemOpt
    from tpubwa_torch.device import extend_kernel as ek
    o = MemOpt()
    pen = (o.a, o.b, o.o_del, o.e_del, o.o_ins, o.e_ins)
    rng = np.random.default_rng(0x5EED)
    cases = []
    max_err = 0
    main_shape = None
    for W, tmax in ((128, 256), (256, 512), (512, 512)):
        for n in (512, 8192):
            for zdrop in (0, 100):
                q, t, p = (torch.from_numpy(x).to(DEV)
                           for x in make_jobs(rng, n, W, tmax))

                def kern():
                    return ek.extend_batch(q, t, p, *pen, zdrop)

                stats = {}
                got = kern()
                want, plain_ms = timed_once(
                    torch, lambda: ek.extend_batch_plain(
                        q, t, p, *pen, zdrop, stats=stats))
                err = held_to_plain(
                    torch, f"kernel != plain at W={W} tmax={tmax} n={n} "
                    f"zdrop={zdrop}", got, want)
                ms = cuda_ms(kern, 20)
                max_err = max(max_err, err)
                case = {"W": W, "tmax": tmax, "n": n, "zdrop": zdrop,
                        "equal": True, "ms": round(ms, 4),
                        "plain_ms": round(plain_ms, 3),
                        "cells": stats["cells"],
                        "bytes": 4 * (q.numel() + t.numel() + p.numel()
                                      + got.numel())}
                cases.append(case)
                if (W, tmax, n, zdrop) == (128, 256, 8192, 100):
                    main_shape = case
    edges = []
    for W, tmax, names, arrays in strip_edge_sets(np):
        q, t, p = (torch.from_numpy(x).to(DEV) for x in arrays)
        for zdrop in (0, 100):
            stats = {}
            max_err = max(max_err, held_to_plain(
                torch, f"kernel != plain on the strip-edge jobs at W={W} "
                f"zdrop={zdrop}", ek.extend_batch(q, t, p, *pen, zdrop),
                ek.extend_batch_plain(q, t, p, *pen, zdrop, stats=stats),
                names))
        edges.append({"W": W, "tmax": tmax, "n": len(names), "equal": True,
                      "cells": stats["cells"]})
    # a tile whose block cannot fit the card's shared memory is refused
    # in the wrapper, and the next launch runs
    wide = 1 << 15
    try:
        ek.extend_batch(torch.full((2, wide), 4, dtype=torch.int32,
                                   device=DEV), t[:2], p[:2], *pen, 100)
    except RuntimeError as e:
        refused = str(e)
    else:
        raise AssertionError(f"a {wide}-column tile was launched")
    held_to_plain(torch, "kernel != plain after a refused launch",
                  ek.extend_batch(q, t, p, *pen, 100),
                  ek.extend_batch_plain(q, t, p, *pen, 100), names)
    occupancy = {W: ek.occupancy(W) for W in (128, 256, 512)}
    desc = phase_desc(torch, np)
    print("[3 kernel==plain] " + json.dumps(
        {"tolerance": 0, "cases": cases, "strip_edges": edges,
         "refused": refused, "occupancy": occupancy, "desc": desc,
         "max_abs_err": max_err}),
        flush=True)
    return main_shape, max_err


def int16_edge_jobs(rng, n=48, W=128, tmax=256):
    """(q, t, p, pen_h0, pen_gap): make_jobs whose every third job sits
    on the int16 domain's h0 bound, h0 + a (qlen + 1) + W e_ins = 32,767
    under pen_h0 (the default scoring), and the same jobs with h0 at most
    60 under pen_gap, whose o_del + e_del = 24,576 meets the gap bound
    max(b, 8192) + o_del + e_del = 32,768 (exp_int16_kernel.check_int16).
    A sum that wraps in 16 bits shows on these jobs first."""
    from tpubwa_torch.opts import MemOpt
    o = MemOpt()
    pen = (o.a, o.b, o.o_del, o.e_del, o.o_ins, o.e_ins)
    q, t, p = make_jobs(rng, n, W, tmax)
    edge = p.copy()
    edge[::3, 2] = 32767 - o.a * (p[::3, 0] + 1) - W * o.e_ins
    gap = (o.a, o.b, 32768 - 8192 - o.e_del, o.e_del, o.o_ins, o.e_ins)
    return q, t, edge, p, pen, gap


# capped_band_jobs' scoring: an insertion opens for e_ins alone
CAP_SCORING = (2, 6, 6, 2, 0, 1)


def capped_band_jobs(rng, n):
    """n jobs under narrow bands (w 1-3), each target the query behind
    w + 1 random bases, so the best path runs just outside the band's
    left edge.  The band's cap moves beg to 1 at row w + 1 while column
    0 still holds (h1, E) from row w: under CAP_SCORING a kernel that
    let that stale pair into the band's F gap would differ from the
    plain version (K1-i16 reads the column below an odd beg as 0)."""
    import numpy as np
    q = np.full((n, 128), 4, np.int32)
    t = np.full((n, 128), 4, np.int32)
    p = np.zeros((n, 5), np.int32)
    for k in range(n):
        w = int(rng.integers(1, 4))
        ql, tl = int(rng.integers(2, 24)), int(rng.integers(w + 2, w + 30))
        q[k, :ql] = rng.integers(0, 4, ql)
        t[k, :tl] = rng.integers(0, 4, tl)
        m = max(0, min(ql, tl - w - 1))
        t[k, w + 1:w + 1 + m] = q[k, :m]
        p[k] = (ql, tl, int(rng.integers(10, 80)), w, 5)
    return q, t, p


def phase_kernel16(torch, np):
    """The int16 kernel (csrc/extend16.cu) against its plain version and
    K1's kernel, exactly, each launch synchronised before anything is
    timed: make_jobs at the three tile shapes of the main path (W 128,
    256, 512; 512 and 8,192 jobs; zdrop 0 and 100), the 64-column
    strip-edge jobs of each shape (exp_kernel_floor.strip_edge_jobs at
    strip 64: every band residue mod 64, odd beg, ties 64 and 128 apart,
    F runs across 64-column edges), the int16 domain-edge jobs
    (int16_edge_jobs) and 256 capped_band_jobs; a tile too wide for a
    block's shared memory must raise.  Then, at the main shape
    (make_jobs W 128, tmax 256, N 8,192, zdrop 100), both kernels
    through their wrappers (mean of 20 calls) and alone in 4 interleaved
    passes of 16-launch chains (``i16_over_k1``), beside the rows, cells
    a row and strips of 32 and 64 a row that the plain version counts.
    Then the ported experiment with the counts set to 0 just before it
    and read just after."""
    from tpubwa_torch.opts import MemOpt
    from tpubwa_torch.device import extend_kernel as ek
    from tpubwa_torch.scripts import exp_int16_kernel as x16
    from tpubwa_torch.scripts import exp_kernel_floor as xf
    o = MemOpt()
    pen = (o.a, o.b, o.o_del, o.e_del, o.o_ins, o.e_ins)
    rng = np.random.default_rng(0x16)
    sets = []      # (name, arrays, scoring, zdrops)
    # one draw a case, in the order phase 3b has always drawn them, so
    # that W 128 and 256 hold the jobs of earlier runs
    for W, tmax in xf.STRIP_SHAPES:
        for n in (512, 8192):
            for zdrop in (0, 100):
                sets.append((f"make_jobs W{W} n{n}",
                             make_jobs(rng, n, W, tmax), pen, (zdrop,)))
    for W, tmax in xf.STRIP_SHAPES:
        edges = xf.strip_edge_jobs(W, tmax, strip=64)
        sets.append((f"strip_edges64 W{W}", tuple(np.concatenate(
            [s[k] for s in edges.values()]) for k in range(3)), xf.SCORING,
            (0, 100)))
    q, t, edge, p, pen_h0, pen_gap = int16_edge_jobs(rng)
    sets += [("int16 h0 edge", (q, t, edge), pen_h0, (0, 100)),
             ("int16 gap edge", (q, t, p), pen_gap, (0, 100)),
             ("capped band", capped_band_jobs(rng, 256), CAP_SCORING,
              (0, 100))]
    checked = []
    max_err = 0
    for name, arrays, scoring, zdrops in sets:
        q, t, p = (torch.from_numpy(np.ascontiguousarray(x)).to(DEV)
                   for x in arrays)
        for zdrop in zdrops:
            got = x16.extend_batch16(q, t, p, *scoring, zdrop)
            # a fault shows at its kernel
            torch.cuda.synchronize()
            stats = {}
            want, plain_ms = timed_once(
                torch, lambda: x16.extend_batch16_plain(
                    q, t, p, *scoring, zdrop, stats=stats))
            ref = ek.extend_batch(q, t, p, *scoring, zdrop)
            for other, x in (("plain", want), ("K1", ref)):
                max_err = max(max_err, held_to_plain(
                    torch, f"int16 kernel != {other} on {name} zdrop="
                    f"{zdrop}", got, x))
            checked.append({"set": name, "n": len(q), "zdrop": zdrop,
                            "equal": True, "cells": stats["cells"]})
            if (name, zdrop) == ("make_jobs W128 n8192", 100):
                main = (q, t, p, got, plain_ms, stats)
    q, t, p, got, plain_ms, stats = main
    # a tile whose block cannot fit the card's shared memory (W 4,096:
    # 263,168 bytes) is refused in the wrapper with its cudaError, and
    # the next launch runs
    try:
        x16.extend_batch16(torch.full((2, 4096), 4, dtype=torch.int32,
                                      device=DEV), t[:2], p[:2], *pen, 100)
    except RuntimeError as e:
        refused = str(e)
    else:
        raise AssertionError("a 4096-column int16 tile was launched")
    held_to_plain(torch, "int16 kernel != plain after a refused launch",
                  x16.extend_batch16(q, t, p, *pen, 100), got)

    def kern():
        return x16.extend_batch16(q, t, p, *pen, 100)

    def k1():
        return ek.extend_batch(q, t, p, *pen, 100)

    alone = xf.interleaved_min(
        {"K1": lambda: ek._extend_cuda(q, t, p, *pen, 100),
         "i16": lambda: x16._extend16_cuda(q, t, p, *pen, 100)},
        16, 4, torch.device(DEV))
    rows = stats["rows"]
    main_shape = {
        "W": 128, "tmax": 256, "n": len(q), "zdrop": 100,
        "ms": round(cuda_ms(kern, 20), 4), "k1_ms": round(cuda_ms(k1, 20), 4),
        "kernel_alone_ms": round(alone["i16"], 4),
        "k1_alone_ms": round(alone["K1"], 4),
        "i16_over_k1": round(alone["i16"] / alone["K1"], 4),
        "plain_ms": round(plain_ms, 3), "cells": stats["cells"],
        "rows": rows, "cells_per_row": round(stats["cells"] / rows, 3),
        "strips32_per_row": round(stats["strips32"] / rows, 4),
        "strips64_per_row": round(stats["strips64"] / rows, 4),
        "bytes": 4 * (q.numel() + t.numel() + p.numel() + got.numel())}
    ek.extend_batch.launches = 0
    x16.extend_batch16.launches = 0
    res = x16.main(["--device", DEV, "--jobs", "512,1024,16384,131072"])
    launches = x16.extend_batch16.launches
    k1_launches = ek.extend_batch.launches
    if launches <= 0 or k1_launches <= 0:
        raise AssertionError("the int16 experiment launched "
                             f"{launches} int16 and {k1_launches} K1 "
                             "kernels")
    if res["fuzz_mismatches"] != 0 or res["fuzz_jobs"] != 1920:
        raise AssertionError(f"int16 fuzz: {res}")
    print("[3b int16 kernel==plain==K1] " + json.dumps(
        {"tolerance": 0, "checked": checked, "main_shape": main_shape,
         "refused": refused, "max_abs_err": max_err,
         "experiment": {"timing": [{k: round(v, 4) for k, v in r.items()}
                                   for r in res["timing"]],
                        "fuzz_jobs": res["fuzz_jobs"],
                        "fuzz_mismatches": res["fuzz_mismatches"],
                        "i16_launches": launches,
                        "k1_launches": k1_launches}}),
        flush=True)
    return main_shape, max_err, launches


def phase_desc(torch, np):
    """Descriptor extension (tile gather + four extension passes) with
    the kernel vs with the plain version on the card, on the
    adversarial descriptor set; both also vs the scalar oracle."""
    from tpubwa_torch.index import FMIndex
    from tpubwa_torch.opts import MemOpt
    from tpubwa_torch.sim import make_bench_bnt
    from tpubwa_torch.device.extend_fused import (extend_seed_desc_np,
                                                  scalar_fused)
    from tpubwa_torch.device.extend_kernel import (extend_batch,
                                                   extend_batch_plain)
    from tpubwa_torch.device.occ import DeviceIndex
    rng = np.random.default_rng(11)
    fmi = FMIndex.build(make_bench_bnt(400_000, rng, realistic=True))
    didx = DeviceIndex.from_fmindex(fmi, DEV)
    opt = MemOpt()
    mat = opt.scoring_matrix()
    rng = np.random.default_rng(0xD35C)
    B, L, n = 32, 100, 1024
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    text = fmi.bnt.doubled()
    for i in range(0, B, 2):   # genome-echo reads: high-score paths
        s = int(rng.integers(0, len(text) - L))
        reads[i] = text[s:s + L]
    reads[1, 40:42] = 4        # N codes in a query
    da = adversarial_descs(rng, fmi.bnt.l_pac, B, L, n - 128)
    # jobs that take the second band trial, on reads of their own
    r2, d2 = retry_descs(fmi.bnt, rng, 128, L)
    d2[:, 0] += B
    reads = np.concatenate([reads, r2])
    da = np.concatenate([da, d2])
    qd = torch.from_numpy(reads).to(DEV)
    args = (mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop,
            512)
    got = extend_seed_desc_np(didx, qd, da, *args)
    want = extend_seed_desc_np(didx, qd, da, *args,
                               extend=extend_batch_plain)
    if not np.array_equal(got, want):
        bad = np.nonzero((got != want).any(1))[0][:3].tolist()
        raise AssertionError(f"descriptor kernel != plain at rows {bad}")
    n_oracle = 0
    for i in range(n):
        job = materialize(fmi.bnt, reads, da[i])
        ref = scalar_fused(job, mat, opt.o_del, opt.e_del, opt.o_ins,
                           opt.e_ins, opt.zdrop)
        ok = bool(got[i, 14] == ref[14] and got[i, 15] == ref[15])
        if job[0] > 0:
            ok &= (got[i, :6].tolist() == ref[:6].tolist()
                   and got[i, 12] == ref[12])
        if job[4] > 0:
            ok &= (got[i, 6:12].tolist() == ref[6:12].tolist()
                   and got[i, 13] == ref[13])
        if not ok:
            raise AssertionError(f"descriptor row {i} != scalar oracle: "
                                 f"{got[i].tolist()} vs {ref.tolist()}")
        n_oracle += 1
    retried = int(((got[:, 12] == 2 * da[:, 7])
                   | (got[:, 13] == 2 * da[:, 7])).sum())
    # a realistic wave: 4,096 descriptors over 1,024 reads
    rng = np.random.default_rng(7)
    reads = rng.integers(0, 4, (1024, L)).astype(np.uint8)
    wave = adversarial_descs(rng, fmi.bnt.l_pac, 1024, L, 4096)
    qd = torch.from_numpy(reads).to(DEV)
    ms = cuda_ms(lambda: extend_seed_desc_np(didx, qd, wave, *args), 10)
    plain_ms = cuda_ms(lambda: extend_seed_desc_np(
        didx, qd, wave, *args, extend=extend_batch_plain), 3)
    # where the wave's time goes: its four launches, each timed alone on
    # its own inputs, and the wave with a stand-in for the extension
    # (host sort, copy in, tile gather, the passes' glue, copy out)
    seen = []

    def keep(q, t, p, *pen):
        seen.append((q, t, p, pen))
        return extend_batch(q, t, p, *pen)

    def no_extend(q, t, p, *pen):
        return torch.zeros((q.shape[0], 6), dtype=torch.int32,
                           device=q.device)

    extend_seed_desc_np(didx, qd, wave, *args, extend=keep)
    launches = [launch_facts(torch, *x) for x in seen]
    rest_ms = cuda_ms(lambda: extend_seed_desc_np(
        didx, qd, wave, *args, extend=no_extend), 10)
    return {"n": n, "equal": True, "oracle_equal": n_oracle,
            "band_retries": retried, "wave4096_ms": round(ms, 3),
            "wave4096_plain_ms": round(plain_ms, 3),
            "wave4096_without_extension_ms": round(rest_ms, 3),
            "wave4096_launches": launches}


def phase_kernel_real(torch, np):
    """Every K1-real variant's kernel (an instantiation of csrc/extend.cu's
    extend_kernel) against its plain version on the card, tolerance 0,
    each launch followed by a synchronise, at phase 3's main shape
    (make_jobs W 128, tmax 256, N 8,192), on 512 of the script's jobs,
    on 256 jobs each built so that only z-drop, or only the band
    write-back, separates no-zdrop and no-wbmask from full, and on the
    strip-edge jobs at W 128; each no-* kernel must differ from full's
    on at least one of these jobs.  The four exact variants against
    K1's kernel, no-zdrop against K1 with zdrop 0 and no-scan against
    K1-floor's -scan; full, -u2 and -u4 against the plain version on the
    experiment's own 131,072 jobs.  At the main shape every variant and
    K1 are timed alone in 4 interleaved passes of 16-launch chains, as
    the floor experiment times its rows (``full_over_k1``: full's
    minimum over K1's), with the zero fill of K1-real's [N, 128] output
    that K1's call does not make (``out_fill_ms``).  Then the ported
    experiment, with the counts set to 0 just before it and read just
    after."""
    from tpubwa_torch.device import extend_kernel as ek
    from tpubwa_torch.scripts import exp_kernel_floor as xf
    from tpubwa_torch.scripts import exp_kernel_real as xr
    pen = (*xr.SCORING, xr.ZDROP)
    rng = np.random.default_rng(0x4EA1)
    edges = xf.strip_edge_jobs(128, 256)
    sets = {"make_jobs": make_jobs(rng, 8192, 128, 256),
            "script": xr.script_jobs(rng, 512),
            "zdrop": xr.zdrop_jobs(rng, 256),
            "wbmask": xr.wbmask_jobs(rng, 256),
            "strip_edges_128": tuple(np.concatenate(
                [s[k] for s in edges.values()]) for k in range(3))}
    variants = {v: {} for v in xr.VARIANTS}
    differs = {v: 0 for v in xr.VARIANTS if v.startswith("no-")}
    max_err = 0
    main_case = None

    def held(name, v, got, refs):
        for other, x in refs:
            if not torch.equal(got[:, :x.shape[1]], x):
                bad = (got[:, :x.shape[1]] != x).any(1).nonzero()[:3, 0]
                raise AssertionError(f"K1-real {v} != {other} on {name} "
                                     f"jobs: rows {bad.tolist()}")

    for name, arrays in sets.items():
        q, t, p = (torch.from_numpy(np.ascontiguousarray(x)).to(DEV)
                   for x in arrays)
        k1 = ek.extend_batch(q, t, p, *pen)
        # what the variants that share an instantiation must equal
        refs = {v: [("K1", k1)] for v in xr.TIMED}
        refs["no-zdrop"] = [("K1 zdrop 0", ek.extend_batch(
            q, t, p, *xr.SCORING, 0))]
        refs["no-scan"] = [("K1-floor -scan", ek.extend_batch(
            q, t, p, *pen, ablate=("scan",)))]
        full = None
        for v in xr.VARIANTS:
            stats = {}
            got = xr.extend_real(q, t, p, v)
            # a fault shows at its kernel
            torch.cuda.synchronize()
            want, plain_ms = timed_once(
                torch, lambda: xr.extend_real_plain(q, t, p, v, stats=stats))
            max_err = max(max_err, int((got.long() - want.long()).abs().max()))
            held(name, v, got, [("plain", want)] + refs.get(v, []))
            if v == "full":
                full = got
            elif v in differs:
                differs[v] += int((got[:, :6] != full[:, :6]).any(1).sum())
            if name != "make_jobs":
                continue
            case = {"ms": round(cuda_ms(
                        lambda v=v: xr.extend_real(q, t, p, v), 20), 4),
                    "plain_ms": round(plain_ms, 3),
                    "cells": stats["cells"]}
            variants[v] = case
            if v == "full":
                main_case = dict(case, bytes=4 * (
                    q.numel() + t.numel() + p.numel() + got.numel()))
        if name == "make_jobs":
            # each variant alone, and K1 alone on the same inputs: the
            # yardstick of the row.  A K1-real call also zeroes its
            # [N, 128] output (K1's is an uninitialised [N, 6]); that
            # fill is timed alone beside them
            alone = xf.interleaved_min(dict(
                {"K1": lambda: ek._extend_cuda(q, t, p, *pen),
                 "fill": lambda: torch.zeros((len(q), xr.OUT_LANES),
                                             dtype=torch.int32, device=DEV)},
                **{v: lambda v=v: xr._extend_real_cuda(q, t, p, v)
                   for v in xr.VARIANTS}), 16, 4, torch.device(DEV))
            for v in xr.VARIANTS:
                variants[v]["alone_ms"] = round(alone[v], 4)
            main_case["k1_alone_ms"] = round(alone["K1"], 4)
            full_over_k1 = round(alone["full"] / alone["K1"], 4)
            fill_ms = round(alone["fill"], 4)
    vacuous = [v for v, k in differs.items() if k == 0]
    if vacuous:
        raise AssertionError(f"{vacuous} equal full on every job: their "
                             "comparison with the plain version is vacuous")
    sizes = (512, 16384, 131072)
    n_big, big = xr.experiment_jobs(sizes)[-1]
    q, t, p = (torch.from_numpy(x).to(DEV) for x in big)
    large = {}
    for v in ("full", "rollred-fused-u2", "rollred-fused-u4"):
        got = xr.extend_real(q, t, p, v)
        torch.cuda.synchronize()
        want, plain_ms = timed_once(
            torch, lambda: xr.extend_real_plain(q, t, p, v))
        max_err = max(max_err, int((got.long() - want.long()).abs().max()))
        held(f"the experiment's {n_big}", v, got, [("plain", want)])
        large[v] = {"equal": True, "plain_ms": round(plain_ms, 3)}
    del q, t, p, got, want
    ek.extend_batch.launches = 0
    xr.extend_real.launches = 0
    res = xr.main(["--device", DEV, "--jobs", ",".join(map(str, sizes)),
                   "--k1", "2", "--k2", "10", "--trials", "3", "--fuzz",
                   "30"])
    launches = xr.extend_real.launches
    if launches <= 0 or ek.extend_batch.launches <= 0:
        raise AssertionError(f"the real-kernel experiment launched "
                             f"{launches} K1-real and "
                             f"{ek.extend_batch.launches} K1 kernels")
    if res["fuzz_mismatches"] != 0 or res["fuzz_jobs"] != 1920:
        raise AssertionError(f"K1-real fuzz: {res}")
    print("[3c K1-real kernel==plain, exact variants==K1] " + json.dumps(
        {"tolerance": 0, "jobs": {k: len(v[0]) for k, v in sets.items()},
         "variants": variants, "k1_alone_ms": main_case["k1_alone_ms"],
         "full_over_k1": full_over_k1, "out_fill_ms": fill_ms,
         "differs_from_full": differs,
         f"experiment_{n_big}_jobs": large, "max_abs_err": max_err,
         "experiment": {"timing": [{k: round(v, 4) for k, v in r.items()}
                                   for r in res["timing"]],
                        "fuzz_jobs": res["fuzz_jobs"],
                        "fuzz_mismatches": res["fuzz_mismatches"],
                        "real_launches": launches}}), flush=True)
    return main_case, max_err, launches


FLOOR_SPECS = (("scan",), ("pk",), ("hopen",), ("trim",), ("trees",),
               ("scan", "trees"))


def phase_kernel_floor(torch, np):
    """Every K1-floor ablation's kernel against its plain version on the
    card, tolerance 0, at phase 3's main shape (make_jobs W 128, tmax
    256, N 8,192), on the floor script's 512 jobs, on 256 z-drop jobs
    and on the strip-edge jobs of the three tile shapes; each must
    differ from K1 on at least one of these jobs, and
    the floor entry with no ablation must equal K1's entry.  Then the
    ported experiment, with the counts set to 0 just before it and read
    just after.  The row of the kernels line is the -scan
    instantiation's at the main shape."""
    from tpubwa_torch.device import extend_kernel as ek
    from tpubwa_torch.scripts import exp_kernel_floor as xf
    from tpubwa_torch.scripts import exp_kernel_real as xr
    pen = (*xr.SCORING, xr.ZDROP)
    rng = np.random.default_rng(0xF100)
    sets = {"make_jobs": make_jobs(rng, 8192, 128, 256),
            "script": xf.floor_jobs(512),
            "zdrop": xr.zdrop_jobs(rng, 256)}
    edge_names = {}
    for W, _, names, arrays in strip_edge_sets(np):
        sets[f"strip_edges_{W}"] = arrays
        edge_names[f"strip_edges_{W}"] = names
    differs = {"+".join(s): 0 for s in FLOOR_SPECS}
    cases = {}
    max_err = 0
    main_case = None
    for name, arrays in sets.items():
        q, t, p = (torch.from_numpy(np.ascontiguousarray(x)).to(DEV)
                   for x in arrays)
        k1 = ek.extend_batch(q, t, p, *pen)
        if not torch.equal(ek._extend_floor_cuda(q, t, p, *pen, 0), k1):
            raise AssertionError(f"floor entry, no ablation != K1 on {name}")
        for spec in FLOOR_SPECS:
            label = "+".join(spec)
            stats = {}
            got = ek.extend_batch(q, t, p, *pen, ablate=spec)
            want, plain_ms = timed_once(torch, lambda: ek.extend_batch_plain(
                q, t, p, *pen, stats=stats, ablate=spec))
            max_err = max(max_err, held_to_plain(
                torch, f"K1-floor {label} != plain on {name} jobs", got,
                want, edge_names.get(name)))
            differs[label] += int((got != k1).any(1).sum())
            if name != "make_jobs":
                continue
            mask = ek.ablate_mask(spec)
            case = {"ms": round(cuda_ms(lambda s=spec: ek.extend_batch(
                        q, t, p, *pen, ablate=s), 20), 4),
                    "alone_ms": round(cuda_ms(lambda m=mask: (
                        ek._extend_floor_cuda(q, t, p, *pen, m)), 20), 4),
                    "plain_ms": round(plain_ms, 3), "cells": stats["cells"]}
            cases[label] = case
            if spec == ("scan",):
                main_case = dict(case, bytes=4 * (
                    q.numel() + t.numel() + p.numel() + got.numel()))
        if name == "make_jobs":
            cases["K1"] = {"alone_ms": round(cuda_ms(
                lambda: ek._extend_cuda(q, t, p, *pen), 20), 4)}
    vacuous = [k for k, v in differs.items() if v == 0]
    if vacuous:
        raise AssertionError(f"{vacuous} equal K1 on every job: their "
                             "comparison with the plain version is vacuous")
    ek.extend_batch.launches = 0
    ek.extend_batch.floor_launches = 0
    res = xf.main(["--device", DEV, "--jobs", "512,131072"])
    launches = ek.extend_batch.floor_launches
    if launches <= 0 or ek.extend_batch.launches <= 0:
        raise AssertionError(f"the floor experiment launched {launches} "
                             f"K1-floor and {ek.extend_batch.launches} K1 "
                             "kernels")
    print("[3d K1-floor kernel==plain, no ablation==K1] " + json.dumps(
        {"tolerance": 0, "jobs": {k: len(v[0]) for k, v in sets.items()},
         "specs": cases, "differs_from_k1": differs, "max_abs_err": max_err,
         "experiment": {"timing": res["timing"], "floor_launches": launches,
                        "k1_launches": ek.extend_batch.launches}}),
        flush=True)
    return main_case, max_err, launches


def phase_kernel_bd(torch, np):
    """Every K1-bd variant's kernel against its plain version on the
    card, tolerance 0, on seven launches: phase 3's main shape
    (make_jobs W 128, tmax 256, N 8,192), the script's 512 jobs, 64 jobs
    that each die at a row of their own, the same beside a job that
    survives, 64 of the script's jobs (tlen 200 > N: tdot's row cap),
    256 jobs on a 252-row tile (t8-slice's clip, unroll2's extra row)
    and 256 jobs whose frozen trim reads above their last live row's
    end_i (exp_kernel_breakdown.frozen_edge_jobs).  Each variant must
    differ from baseline on one job at least, and a dying job's kernel
    result launched alone must differ from its result in the launch
    (the coupling).  A tile too wide for a block's shared memory must
    raise, and the next launch run right.  At the main shape, baseline
    alone beside K1 alone on the same jobs under the same scoring
    (``bd_over_k1``), in 4 interleaved passes of 16-launch chains, and
    its live and frozen kernels' device times from a trace of 64 of its
    launches (``kernel_ms``).  Then the ported
    experiment at 512 and 131,072 jobs, with the count set to 0 just
    before it and read just after.  The row of the kernels line is
    baseline's at the main shape."""
    from tpubwa_torch.device import extend_kernel as ek
    from tpubwa_torch.scripts import exp_kernel_breakdown as xb
    from tpubwa_torch.scripts import exp_kernel_floor as xf
    rng = np.random.default_rng(0xBD)
    dying = xb.dying_jobs(rng, 64)
    sets = {"make_jobs": make_jobs(rng, 8192, 128, 256),
            "script": xb.bd_jobs(512),
            "dying": dying,
            "dying+survivor": tuple(np.concatenate([a, b]) for a, b in
                                    zip(dying, xb.bd_jobs(1))),
            "tdot_cap": xb.bd_jobs(64),
            "clip252": xb.clip_jobs(rng, 256),
            "frozen_edge": xb.frozen_edge_jobs(rng, 255)}
    differs = {v: 0 for v in xb.VARIANTS[1:]}
    cases, max_err, main_case = {}, 0, None
    above_live_end = {}
    for name, arrays in sets.items():
        q, t, p = (torch.from_numpy(np.ascontiguousarray(x)).to(DEV)
                   for x in arrays)
        base = None
        for v in xb.VARIANTS:
            stats = {}
            got = xb.extend_bd(q, t, p, v)
            want, plain_ms = timed_once(torch, lambda: xb.extend_bd_plain(
                q, t, p, v, stats=stats))
            max_err = max(max_err, int((got.long() - want.long()).abs().max()))
            if not torch.equal(got, want):
                bad = (got != want).any(1).nonzero()[:3, 0].tolist()
                raise AssertionError(
                    f"K1-bd {v} != plain on {name} jobs: rows {bad}: "
                    f"{got[bad, :4].tolist()} vs {want[bad, :4].tolist()}")
            if v == "baseline":
                base = got
                above_live_end[name] = stats["frozen_above_live_end"]
            else:
                differs[v] += int((got[:, :4] != base[:, :4]).any(1).sum())
            if name != "make_jobs":
                continue
            case = {"ms": round(cuda_ms(
                        lambda v=v: xb.extend_bd(q, t, p, v), 20), 4),
                    "alone_ms": round(cuda_ms(
                        lambda v=v: xb._extend_bd_cuda(q, t, p, v), 20), 4),
                    "plain_ms": round(plain_ms, 3),
                    **{k: stats[k] for k in ("cells", "live_cells",
                                             "frozen_cells")}}
            cases[v] = case
            if v == "baseline":
                main_case = dict(case, bytes=4 * (
                    q.numel() + t.numel() + p.numel() + got.numel()))
        if name == "make_jobs":
            # baseline whole and K1 on the same jobs under the same
            # scoring alone, in interleaved passes; then each of
            # baseline's two kernels from a device trace of its launches
            alone = xf.interleaved_min({
                "K1": lambda: ek._extend_cuda(q, t, p, *xb.SCORING, 100),
                "baseline": lambda: xb._extend_bd_cuda(q, t, p, "baseline")},
                16, 4, torch.device(DEV))
            main_case["alone_interleaved_ms"] = {
                k: round(v, 4) for k, v in alone.items()}
            main_case["bd_over_k1"] = round(alone["baseline"] / alone["K1"],
                                            4)
            main_case["pass_ms"] = kernel_ms(
                torch, lambda: xb._extend_bd_cuda(q, t, p, "baseline"),
                ("extend_bd_live", "extend_bd_frozen"), 64)
        if name == "dying":
            # the coupling: alone, a dying job stops where it dies
            coupled = [k for k in range(8)
                       if not torch.equal(xb.extend_bd(
                           q[k:k + 1], t[k:k + 1], p[k:k + 1])[0], base[k])]
            if not coupled:
                raise AssertionError("K1-bd: each of 8 dying jobs alone "
                                     "equals its result in the launch")
    vacuous = [v for v, k in differs.items() if k == 0]
    if vacuous:
        raise AssertionError(f"{vacuous} equal baseline on every job: their "
                             "comparison with the plain version is vacuous")
    if not above_live_end["frozen_edge"]:
        raise AssertionError("frozen_edge_jobs never read above the last "
                             "live end_i")
    # a tile whose block cannot fit the card's shared memory is refused
    # in the wrapper, and the next launch runs
    wide = 1 << 13
    q, t, p = (torch.from_numpy(x).to(DEV) for x in xb.bd_jobs(2))
    try:
        xb.extend_bd(torch.full((2, wide), 4, dtype=torch.int32, device=DEV),
                     t, p)
    except RuntimeError as e:
        refused = str(e)
    else:
        raise AssertionError(f"a {wide}-column K1-bd tile was launched")
    if not torch.equal(xb.extend_bd(q, t, p), xb.extend_bd_plain(q, t, p)):
        raise AssertionError("K1-bd != plain after a refused launch")
    xb.extend_bd.launches = 0
    res = xb.main(["--device", DEV, "--jobs", "512,131072"])
    launches = xb.extend_bd.launches
    if launches <= 0:
        raise AssertionError("the breakdown experiment launched no K1-bd "
                             "kernel")
    print("[3f K1-bd kernel==plain] " + json.dumps(
        {"tolerance": 0, "jobs": {k: len(v[0]) for k, v in sets.items()},
         "variants": cases,
         "alone_interleaved_ms": main_case["alone_interleaved_ms"],
         "bd_over_k1": main_case["bd_over_k1"],
         "pass_ms": main_case["pass_ms"],
         "differs_from_baseline": differs,
         "frozen_above_live_end": above_live_end, "refused": refused,
         "coupled_dying_jobs": coupled, "max_abs_err": max_err,
         "experiment": {"timing": res["timing"], "bd_launches": launches}}),
        flush=True)
    return main_case, max_err, launches


# the child of phase 3e: every instantiation once on 256 jobs, each
# followed by a synchronise, so that a fault shows at its kernel
_SANITIZED = """
import sys
sys.path.insert(0, {root!r})
import numpy as np, torch
from chip_smoke import make_jobs
from tpubwa_torch.device import extend_kernel as ek
from tpubwa_torch.scripts import exp_int16_kernel as x16
from tpubwa_torch.scripts import exp_kernel_breakdown as xb
from tpubwa_torch.scripts import exp_kernel_real as xr
q, t, p = (torch.from_numpy(np.ascontiguousarray(x)).cuda()
           for x in make_jobs(np.random.default_rng(3), 256, 128, 256))
torch.cuda.synchronize()
print("inputs on the card", flush=True)
pen = (*xr.SCORING, xr.ZDROP)
runs = [lambda: ek._extend_cuda(q, t, p, *pen)]
runs += [lambda m=m: ek._extend_floor_cuda(q, t, p, *pen, m)
         for m in range(1, 16)]
runs += [lambda: x16._extend16_cuda(q, t, p, *pen)]
runs += [lambda v=v: xr._extend_real_cuda(q, t, p, v)
         for v in xr.VARIANTS if v != "rollred-fused"]
runs += [lambda v=v: xb._extend_bd_cuda(q, t, p, v) for v in xb.VARIANTS]
for run in runs:
    run()
    torch.cuda.synchronize()
print("sanitized", len(runs), "instantiations")
"""
SANITIZED_RUNS = 36


def _sanitizer():
    """(compute-sanitizer's path or None, the paths searched): PATH, then
    beside nvcc, then the toolkit's compute-sanitizer/ folder."""
    from tpubwa_torch.device import _build
    paths = [shutil.which("compute-sanitizer") or "PATH"]
    try:
        cuda = os.path.dirname(os.path.dirname(_build._nvcc()))
    except RuntimeError:
        cuda = "/usr/local/cuda"
    paths += [os.path.join(cuda, "bin", "compute-sanitizer"),
              os.path.join(cuda, "compute-sanitizer", "compute-sanitizer")]
    for path in paths:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path, paths
    return None, paths


def phase_sanitizer():
    """compute-sanitizer memcheck and initcheck over every instantiation
    (the child _SANITIZED).  Raises if the tool reports an error once
    the child's inputs are on the card (every kernel of ours runs after
    that), or if the child then fails.  A tool that is missing, or that
    fails before that point (on torch's own setup, before any kernel of
    ours), is printed as such: it checked nothing, and is no pass."""
    tool, searched = _sanitizer()
    if tool is None:
        print(f"[sanitizer] not found: {', '.join(searched)}", flush=True)
        return {"found": False, "searched": searched}
    res = {"tool": tool}
    for kind in ("memcheck", "initcheck"):
        t0 = time.perf_counter()
        try:
            run = subprocess.run(
                [tool, "--tool", kind, sys.executable, "-c",
                 _SANITIZED.format(root=ROOT)], cwd=ROOT, capture_output=True,
                text=True, timeout=300)
            out, rc = run.stdout + run.stderr, run.returncode
        except subprocess.TimeoutExpired as e:
            out, rc = f"timed out after {e.timeout} s", None
        summary = re.findall(r"ERROR SUMMARY: (\d+) errors?", out)
        errors = int(summary[-1]) if summary else None
        started = "inputs on the card" in out
        ran = f"sanitized {SANITIZED_RUNS} instantiations" in out
        if started and (errors or not ran):
            raise AssertionError(f"compute-sanitizer {kind}: {errors} errors"
                                 f", child rc {rc}\n{out[-3000:]}")
        res[kind] = {"errors": errors, "checked_all": ran and errors == 0,
                     "rc": rc, "seconds": round(time.perf_counter() - t0, 1)}
        if not res[kind]["checked_all"]:
            # the tool's own first reports: why it checked nothing
            res[kind]["did_not_check"] = [
                l.strip("= ") for l in out.splitlines()
                if l.startswith("=========") and "Host Frame" not in l
                and l.strip("= ")][:4] or out[-300:]
    print("[3e sanitizer] " + json.dumps(res), flush=True)
    return res


def card_rates(torch):
    """The card's SMs, top SM clock and integer rates (lane instructions
    per second): the INT32 pipe's SMs x 64 x clock, and the SM's issue
    rate, SMs x 4 schedulers x 32 lanes x clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(_run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                      "--format=csv,noheader,nounits"]).splitlines()[0])
    return {"sms": sms, "clock_max_mhz": mhz,
            "int32_per_s": sms * INT32_LANES * mhz * 1e6,
            "issue_per_s": sms * SCHED_LANES * mhz * 1e6}


def _cuobjdump():
    for tool in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if tool and os.path.exists(tool):
            return tool
    raise RuntimeError("cuobjdump not found (PATH or /usr/local/cuda/bin)")


_CONTROL = {"BRA", "BSSY", "BSYNC", "NOP", "EXIT", "WARPSYNC", "BAR", "RET",
            "CALL", "BREAK", "YIELD", "BMOV"}
_MOVES = {"MOV", "S2R", "CS2R"}
_WARP = {"SHFL", "REDUX", "VOTE", "MATCH"}
_GUARD = re.compile(r"^@(!?)(U?P\w+)\s+")


def sass_class(op):
    """The class of one SASS instruction: ``memory`` (loads, stores,
    atomics), ``control`` (branches, barriers, NOP), ``move``,
    ``uniform`` (the per-warp uniform datapath, U*), ``warp`` (shuffles,
    warp reductions and votes), ``int_fma`` (IMAD
    and VIADD, which may issue on the FMA pipe) or ``int_alu`` (every
    other integer op: compares, selects, min/max, logic, adds)."""
    mnem = _GUARD.sub("", op.strip()).split()[0]
    base = mnem.split(".")[0]
    if base in _WARP:
        return "warp"
    if base.startswith(("LD", "ST", "ATOM", "RED")):
        return "memory"
    if base in _CONTROL:
        return "control"
    if base in _MOVES or mnem.startswith("IMAD.MOV"):
        return "move"
    if base.startswith("U"):
        return "uniform"
    if base in ("IMAD", "VIADD"):
        return "int_fma"
    return "int_alu"


def _regs(operand, width=1):
    """The registers (R<n>, P<n>) an operand names; ``width`` 2 or 4 for
    a 64- or 128-bit register operand."""
    out = []
    for m in re.finditer(r"\b([RP])(\d+)(\.64)?\b", operand):
        n = 2 if m.group(3) else width
        out += [f"{m.group(1)}{int(m.group(2)) + k}" for k in range(n)]
    return out


def def_use(op):
    """(writes, address reads, other reads, predicated) of one SASS
    instruction, by register name."""
    guard = _GUARD.match(op.strip())
    text = _GUARD.sub("", op.strip())
    parts = text.split(None, 1)
    mnem = parts[0]
    ops = [x.strip() for x in parts[1].split(",")] if len(parts) > 1 else []
    width = 4 if ".128" in mnem else 2 if ".64" in mnem else 1
    reads = [guard.group(2)] if guard else []
    addr = [r for x in ops if "[" in x
            for r in _regs(re.findall(r"\[([^\]]*)\]", x)[-1])]
    if sass_class(op) == "memory":
        plain = [x for x in ops if "[" not in x]
        if mnem.startswith(("ST", "RED")):
            return [], addr, reads + [r for x in plain
                                      for r in _regs(x, width)], guard
        return ([r for x in plain[:1] for r in _regs(x, width)], addr,
                reads + [r for x in plain[1:] for r in _regs(x)], guard)
    if sass_class(op) == "control" or not ops:
        return [], [], reads + [r for x in ops for r in _regs(x)], guard
    n_dest = 2 if len(ops) > 2 and re.fullmatch(r"P(\d|T)", ops[1]) else 1
    wide = 2 if ".WIDE" in mnem else 1
    writes = [r for x in ops[:n_dest] for r in _regs(x, wide)]
    srcs = ops[n_dest:]
    for k, x in enumerate(srcs):
        reads += _regs(x, wide if ".WIDE" in mnem and k == len(srcs) - 1
                       else 1)
    return writes, [], reads, guard


def address_ops(body):
    """Indices in the loop ``body`` of its address arithmetic: the
    instructions whose results are read, in the loop (around its back
    edge, up to the next unpredicated write), only as the address of a
    load or store or by other address arithmetic (the largest such set:
    an address stepped each trip feeds itself around the back edge)."""
    du = [def_use(op) for op in body]
    n = len(body)

    def uses(k, reg):
        out = []
        for step in range(1, n + 1):
            j = (k + step) % n
            writes, addr, reads, guard = du[j]
            if reg in addr:
                out.append((j, "addr"))
            if reg in reads:
                out.append((j, "data"))
            if reg in writes and not guard:
                break
        return out

    users = {k: [u for r in du[k][0] for u in uses(k, r)]
             for k in range(n)
             if du[k][0] and sass_class(body[k]) not in ("memory", "control")}
    found = {k for k, us in users.items() if us}
    while True:
        # keep those that lead to an address ...
        reach = {k for k in found
                 if any(kind == "addr" for _, kind in users[k])}
        grew = True
        while grew:
            grew = False
            for k in found - reach:
                if any(j in reach for j, _ in users[k]):
                    reach.add(k)
                    grew = True
        # ... and whose every other reader is one of them
        kept = {k for k in reach
                if all(kind == "addr" or j in reach for j, kind in users[k])}
        if kept == found:
            return found
        found = kept


def loop_control(body, pred):
    """Indices in ``body`` of the loop's own control arithmetic: the
    compare that sets the back branch's predicate ``pred``, and the
    counters it reads that the loop only steps by a constant (written
    only as ``R = R + imm`` and read by nothing else in the loop)."""
    du = [def_use(op) for op in body]
    setters = [k for k, (w, _, _, _) in enumerate(du) if pred in w]
    if not setters:
        return set()
    cmp_k = setters[-1]
    out = {cmp_k}
    for reg in du[cmp_k][2]:
        writers = [k for k, (w, _, _, _) in enumerate(du)
                   if reg in w and k != cmp_k]
        readers = [k for k, (_, a, r, _) in enumerate(du)
                   if (reg in a or reg in r) and k != cmp_k
                   and k not in writers]
        step = all(re.fullmatch(rf"(VIADD|IADD3) {reg}, {reg}(\.reuse)?, "
                                r"-?0x[0-9a-f]+(, RZ)?", body[k].strip())
                   for k in writers)
        if writers and step and not readers:
            out.update(writers)
    return out


def sass_function(text, function, operand_predicates=False):
    """(name, instructions, loops) of the one function in ``cuobjdump
    -sass`` output whose mangled name matches the regex ``function``:
    its (address, instruction) pairs and its loops (a backward branch to
    an earlier address) as (first address, branch address, predicate).
    ``operand_predicates`` also takes a branch with a second predicate
    as its first operand (``@!P3 BRA P4, 0x1b90``)."""
    funcs, cur, labels, pending = {}, None, {}, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
            labels[cur] = {}
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m and cur:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;", line)
        if m and cur:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[cur][lab] = addr
            pending = []
            funcs[cur].append((addr, m.group(2)))
    names = [f for f in funcs if re.search(function, f)]
    if len(names) != 1:
        raise AssertionError(f"{len(names)} functions match {function!r} "
                             f"of {list(funcs)}")
    ins = funcs[names[0]]
    loops = []
    for addr, op in ins:
        m = re.search(r"^(?:@(!?P\w+)\s+)?BRA\S*\s+"
                      + (r"(?:!?U?P\w+,\s*)?" if operand_predicates else "")
                      + r"(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", op.strip())
        if not m:
            continue
        target = (labels[names[0]].get(m.group(2)) if m.group(2)
                  else int(m.group(3), 16))
        if target is not None and target <= addr:
            loops.append((target, addr, m.group(1)))
    return names[0], ins, loops


def sass_strip_loop(text, function):
    """What one strip of a row costs a warp-per-job kernel, as
    information beside its bound (it is not part of it): the smallest
    loop of the function that both stores to shared memory and shuffles,
    with its issued instructions, its warp operations (shuffles, warp
    reductions, votes), its shared loads and stores, the loops nested in
    it (each counted for one trip) and the count of each opcode in it
    (``VIADDMNMX.S16x2``: 3, which shows a 16x2 operation as one
    instruction).  None if the function has no such loop."""
    name, ins, loops = sass_function(text, function,
                                     operand_predicates=True)
    found = []
    for lo, hi, _ in loops:
        body = [op for a, op in ins if lo <= a <= hi]
        ops = [_GUARD.sub("", op.strip()).split(".")[0].split()[0]
               for op in body]
        if "STS" in ops and "SHFL" in ops:
            found.append((len(body), lo, hi, body, ops))
    if not found:
        return None
    _, lo, hi, body, ops = min(found)
    mnems = [_GUARD.sub("", op.strip()).split()[0] for op in body]
    return {"function": name, "loops": len(loops),
            "instructions": sum(op != "NOP" for op in ops),
            "nested_loops": sum((a, b) != (lo, hi) and lo <= a and b <= hi
                                for a, b, _ in loops),
            **{k.lower(): ops.count(k)
               for k in ("SHFL", "REDUX", "VOTE", "LDS", "STS")},
            "opcodes": {m: mnems.count(m) for m in sorted(set(mnems))
                        if m != "NOP"}}


def ptxas_usage(report, function, stack=False):
    """{"registers", "spill_bytes"} of the one function in a ``ptxas
    -v`` report whose mangled name matches the regex ``function``, and
    its "stack_bytes" (stack frame) where ``stack``."""
    found = re.findall(
        r"Function properties for (\S+)\s+(\d+) bytes stack frame, (\d+) "
        r"bytes spill stores, (\d+) bytes spill loads\s+ptxas info\s*: Used "
        r"(\d+) registers", report)
    found = [f for f in found if re.search(function, f[0])]
    if len(found) != 1:
        raise AssertionError(f"{len(found)} functions match {function!r} in "
                             "the ptxas report")
    _, frame, stores, loads, regs = found[0]
    out = {"registers": int(regs), "spill_bytes": int(stores) + int(loads)}
    if stack:
        out["stack_bytes"] = int(frame)
    return out


def sass_loops(text, function):
    """The inner band loop of a one-thread-per-job kernel in ``cuobjdump
    -sass`` output.

    No row of the kernels line calls it: every kernel keeps its row in
    shared memory now.  It is how RECURRENCE_OPS was read and is
    re-derived, from the one-thread loops in git's history (``git show
    5163bc9:tpubwa_torch/csrc/extend_real.cu``, built by nvcc -O3 for
    sm_90a and disassembled by cuobjdump -sass).

    Takes the one function whose mangled name matches the regex
    ``function`` and finds its loops (a backward branch to an earlier
    address).  The inner band loop is an innermost loop that both stores
    and loads global memory: it writes each cell's (h, e) scratch once,
    and reads it and the query code, so its stores count its cells.
    Returns, per cell, all its instructions (``sass``) and its integer
    work (``int_alu`` + ``int_fma``): every instruction except memory,
    control, moves, the uniform datapath, 64-bit address arithmetic and
    the loop's own counter and exit compare.  Where the compiler
    unrolled the loop and kept a remainder, the candidate with the least
    integer work per cell is taken (a bound wants the least work)."""
    name, ins, loops = sass_function(text, function)
    inner = [lp for lp in loops
             if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1]
                        for o in loops)]
    found = []
    for lo, hi, pred in inner:
        body = [op for a, op in ins if lo <= a <= hi]
        stores = sum(sass_class(op) == "memory"
                     and bool(re.search(r"\bSTG?\.E", op)) for op in body)
        loads = sum(bool(re.search(r"\bLDG?\.E", op)) for op in body)
        if not stores or loads < stores:
            continue
        ctl = loop_control(body, pred.lstrip("!")) if pred else set()
        adr = address_ops(body)
        counts = {}
        for k, op in enumerate(body):
            c = ("loop_control" if k in ctl else "address" if k in adr
                 else sass_class(op))
            counts[c] = counts.get(c, 0) + 1
        work = counts.get("int_alu", 0) + counts.get("int_fma", 0)
        issued = sum(not re.search(r"\bNOP\b", op) for op in body)
        found.append({"instructions": issued, "stores": stores,
                      "loads": loads, "classes": counts,
                      "sass_per_cell": issued / stores,
                      "int_per_cell": work / stores,
                      "alu_per_cell": counts.get("int_alu", 0) / stores})
    if not found:
        raise AssertionError(f"{name}: no inner band loop among "
                             f"{len(loops)} loops")
    best = min(found, key=lambda f: f["int_per_cell"])
    return dict(best, function=name, loops=len(loops),
                inner_candidates=len(found))


def ldg_width(op):
    """The width in bits of a global load (``LDG``), None for any other
    SASS instruction."""
    mnem = _GUARD.sub("", op.strip()).split()[0]
    if not mnem.startswith("LDG"):
        return None
    return 128 if ".128" in mnem else 64 if ".64" in mnem else 32


def ldg_counts(ops):
    """{width in bits (a string): global loads} of the instructions."""
    out = {}
    for op in ops:
        w = ldg_width(op)
        if w:
            out[str(w)] = out.get(str(w), 0) + 1
    return out


def sass_loads(text, function):
    """The global loads of the one function in ``cuobjdump -sass``
    output whose mangled name matches the regex ``function``, as
    information: how many of each width (bits), and for each innermost
    loop that holds one, its loads, its instructions and whether a
    load's value is read before the loop's back branch (``waits``: then
    each trip's load waits for the last trip's, so the loop's loads
    issue one after another)."""
    name, ins, loops = sass_function(text, function)
    inner = [lp for lp in loops
             if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1]
                        for o in loops)]
    found = []
    for lo, hi, _ in inner:
        body = [op for a, op in ins if lo <= a <= hi]
        if not ldg_counts(body):
            continue
        waits = False
        for k, op in enumerate(body):
            if ldg_width(op):
                dest = set(def_use(op)[0])
                waits |= any(dest & set(r for part in def_use(later)[1:3]
                                        for r in part)
                             for later in body[k + 1:])
        found.append({"at": hex(lo), "instructions": len(body),
                      "ldg": ldg_counts(body), "waits": waits})
    return {"function": name, "ldg": ldg_counts(op for _, op in ins),
            "loops": found}


def bound(case, loop, rates):
    """(bound_ms, bound_by, parts): the larger of the bytes the call must
    move (each input read once, the output written once) over HBM
    bandwidth, and its band cells times the integer work per cell
    (``loop``: a RECURRENCE_OPS entry) over the card's integer rate.
    That rate is the
    lesser pair of limits: the INT32 pipe's 64 lanes per SM for the
    ALU-only ops, and the SM's issue rate (4 x 32 lanes) for all of
    them, IMAD and VIADD included (they may go to the FMA pipe)."""
    t_bytes = case["bytes"] / HBM_BYTES_S * 1e3
    t_alu = case["cells"] * loop["alu_per_cell"] / rates["int32_per_s"] * 1e3
    t_issue = (case["cells"] * loop["int_per_cell"] / rates["issue_per_s"]
               * 1e3)
    t_ops = max(t_alu, t_issue)
    parts = {"bytes_ms": t_bytes, "int_alu_ms": t_alu, "issue_ms": t_issue}
    return ((t_bytes, "bytes", parts) if t_bytes > t_ops
            else (t_ops, "operations", parts))


def phase_golden(torch):
    """`mem --device cuda` on the golden corpus: SE through
    `python -m tpubwa_torch` in a child process, PE through the CLI's
    main() in this process (so the kernel's launch count is visible)."""
    import tempfile
    from tpubwa_torch.cli import main as cli_main
    from tpubwa_torch.device import extend_kernel as ek
    gold = os.path.join(ROOT, "tests", "golden")
    os.makedirs(BUILD, exist_ok=True)
    res = {}
    with tempfile.TemporaryDirectory(dir=BUILD) as d:
        prefix = os.path.join(d, "g")
        assert cli_main(["index", os.path.join(gold, "ref.fa"), "-p",
                         prefix]) == 0
        mem = ["mem", "--device", DEV, prefix]
        subprocess.run([sys.executable, "-m", "tpubwa_torch", *mem,
                        os.path.join(gold, "se.fq"), "-o",
                        os.path.join(d, "se.sam")],
                       cwd=ROOT, check=True, capture_output=True)
        before = ek.extend_batch.launches
        assert cli_main([*mem, os.path.join(gold, "pe1.fq"),
                         os.path.join(gold, "pe2.fq"), "-o",
                         os.path.join(d, "pe.sam")]) == 0
        launched = ek.extend_batch.launches - before
        for name in ("se.sam", "pe.sam"):
            with open(os.path.join(d, name)) as fh:
                got = "".join(l for l in fh if not l.startswith("@PG"))
            with open(os.path.join(gold, name)) as fh:
                if got != fh.read():
                    raise AssertionError(f"golden {name} differs on {DEV}")
            res[name] = len(got.splitlines())
    if launched <= 0:
        raise AssertionError("golden PE mem never launched the kernel")
    print("[4 golden] " + json.dumps({"byte_equal": res,
                                      "pe_kernel_launches": launched}),
          flush=True)


def phase_main_path(torch, np):
    from tpubwa_torch.host.pipeline import process_batches
    from tpubwa_torch.opts import MEM_F_PE, MemOpt
    from tpubwa_torch.sim import bench_index, simulate_pe
    from tpubwa_torch.device import extend_kernel as ek
    from tpubwa_torch.device.pipeline import make_device_aligner
    t0 = time.perf_counter()
    fmi = bench_index(GENOME_MB, realistic=True,
                      cache_dir=os.path.join(BUILD, "bench-cache"))
    index_s = time.perf_counter() - t0
    opt = MemOpt(flag=MEM_F_PE)
    rng = np.random.default_rng(1)
    aligner = make_device_aligner(opt, fmi, device=DEV)
    # warm-up batch (first use of every path), not timed
    warm = simulate_pe(fmi.bnt, 1024, 100, rng)
    for _ in process_batches(opt, fmi, iter([warm]), 0, align_fn=aligner):
        pass
    batches = [simulate_pe(fmi.bnt, PAIRS, 100, rng) for _ in range(2)]
    n_reads = sum(len(b) for b in batches)
    w0, j0 = aligner.extender.n_waves, aligner.extender.n_jobs
    ek.extend_batch.launches = 0
    torch.cuda.synchronize()
    n_mapped = 0
    sam_lines = []
    with SeedTimer(torch) as seeding:
        t0 = time.perf_counter()
        for batch, lines in process_batches(opt, fmi, iter(batches), 0,
                                            align_fn=aligner):
            for line in lines:
                f = line.split("\t")
                if len(f) < 11:
                    raise AssertionError(f"malformed SAM line: {line[:80]}")
                n_mapped += not int(f[1]) & 4
            sam_lines += lines
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = ek.extend_batch.launches
    n_lines = len(sam_lines)
    # the native walk served every SA position: no FM array went up
    if aligner.didx._fm is not None:
        raise AssertionError("phase 5 uploaded the FM arrays")
    n_waves = aligner.extender.n_waves - w0
    n_jobs = aligner.extender.n_jobs - j0
    if launches <= 0:
        raise AssertionError("the main path never launched the kernel")
    if n_lines < n_reads or n_mapped < 0.8 * n_reads:
        raise AssertionError(f"{n_lines} SAM lines, {n_mapped} mapped "
                             f"for {n_reads} reads")
    # the first 512 pairs again: through the plain version on the CPU,
    # and through the port's scalar host pipeline (align_fn=None, the
    # path tpubwa's own tests hold its device pipeline to)
    first = batches[0][:1024]
    cpu = make_device_aligner(opt, fmi, device="cpu")
    sam = {}
    for name, fn in ((DEV, aligner), ("cpu", cpu), ("scalar", None)):
        sam[name] = [l for _, lines in process_batches(
            opt, fmi, iter([first]), 0, align_fn=fn) for l in lines]
    for name in ("cpu", "scalar"):
        if sam[DEV] != sam[name]:
            raise AssertionError(f"first 512 pairs: {DEV} SAM != {name}")
    # what the main path gives K1: the first batch again, untimed, with
    # the four launches of its first wave kept and timed alone
    from tpubwa_torch.device import pipeline as dp
    from tpubwa_torch.device.extend_kernel import extend_batch
    seen = []

    def keep(q, t, p, *pen):
        if len(seen) < 4:
            seen.append((q, t, p, pen))
        return extend_batch(q, t, p, *pen)

    def wave(*a):
        return desc_np(*a, extend=keep)

    desc_np, dp.extend_seed_desc_np = dp.extend_seed_desc_np, wave
    try:
        for _ in process_batches(opt, fmi, iter(batches[:1]), 0,
                                 align_fn=aligner):
            pass
    finally:
        dp.extend_seed_desc_np = desc_np
    first_wave = [launch_facts(torch, *x) for x in seen]
    print("[5 main path] " + json.dumps({
        "genome": f"{GENOME_MB} Mbp repeat-realistic "
                  f"(tpubwa_torch.sim.bench_index({GENOME_MB}, realistic=True))",
        "index_s": round(index_s, 1), "reads": n_reads,
        "seconds": round(dt, 3), "reads_per_s": round(n_reads / dt, 1),
        "seeding_s": round(seeding.s, 3), "seed_mode": aligner.seed_mode,
        "sam_lines": n_lines, "mapped": n_mapped,
        "n_waves": n_waves, "n_jobs": n_jobs,
        "kernel_launches": launches, "fm_arrays_uploaded": False,
        "first_wave_launches": first_wave,
        "cpu_and_scalar_equal_pairs": len(first) // 2}), flush=True)
    return {"launches": launches, "fmi": fmi, "opt": opt,
            "batches": batches, "sam": sam_lines,
            "reads_per_s": n_reads / dt, "seeding_s": seeding.s,
            "aligner": aligner}


SECTOR = 32             # bytes of one DRAM sector, the unit of a load
OCC_ROW = 48            # bytes of an occ row (4 counts + 8 BWT words)
MARK_ROW = 32           # bytes of a mark row


def sectors(index, elem_bytes):
    """The distinct 32-byte sectors that reading elements ``index``
    (any order, repeats allowed) of an array of ``elem_bytes``-byte
    elements touches."""
    import numpy as np
    index = np.unique(np.asarray(index, np.int64))
    if not len(index):
        return 0
    first = index * elem_bytes // SECTOR
    last = (index * elem_bytes + elem_bytes - 1) // SECTOR
    return len(np.unique(np.concatenate([
        np.minimum(first + j, last)
        for j in range(int((last - first).max()) + 1)])))


def fm_bytes(io_bytes, reads):
    """The bytes an FM-index kernel must move: ``io_bytes`` (its inputs
    and outputs, each once) and the distinct sectors of the index it
    reads, ``reads`` = [(element indices, element bytes)], plus one
    sector for L2."""
    return io_bytes + SECTOR * (1 + sum(sectors(i, e) for i, e in reads))


def bytes_bound(case):
    """(bound_ms, "bytes", parts) of a row bound by bytes alone: the
    bytes its run must move (``case["bytes"]``) over HBM bandwidth.  The
    FM-index kernels do a few dozen integer ops for each 48-byte row
    they read, so their operations are far below their bytes."""
    t = case["bytes"] / HBM_BYTES_S * 1e3
    return t, "bytes", {"bytes_ms": t}


def walk_case(torch, np, didx, ranks, ms, plain_ms, stats, cold_ms=None):
    """A K-sa case: its times (``ms`` warm, ``cold_ms`` after a write
    that flushes L2), the LF steps a rank and a warp (32 consecutive
    ranks, one warp of the first form), the time a step of the longest
    walk takes (``us_per_step_longest``: the launch over its longest
    walk's steps, the chain no design can shorten), the 64-byte HBM
    units all its steps read (``step_atoms``, and ``atoms_ms``, their
    time at HBM's peak rate were none in L2) and the bytes of its walk
    (the distinct sectors; from the plain version's reads, ``stats``)."""
    isz = 8 if didx.idt == torch.int64 else 4
    steps = stats["steps"].cpu().numpy()
    pad = np.zeros(-len(steps) % 32, steps.dtype)
    warp_max = np.concatenate([steps, pad]).reshape(-1, 32).max(1)
    longest = int(steps.max())
    # every step's reads in 64-byte units of HBM (two sectors), as if
    # none were in L2: a 48-byte occ row spans one or two, a 32-byte
    # mark row and a sample one
    at = stats["occ_rows"].cpu().numpy().astype(np.int64) * OCC_ROW
    atoms = int(((at + OCC_ROW - 1) // 64 - at // 64 + 1).sum()
                + len(stats["mark_rows"]) + len(stats["samples"]))
    return {"n": len(ranks), "ms": ms and round(ms, 4),
            "cold_ms": cold_ms and round(cold_ms, 4),
            "plain_ms": round(plain_ms, 3),
            "steps_mean": round(float(steps.mean()), 3),
            "steps_max": longest,
            "us_per_step_longest": (round(ms * 1e3 / longest, 4)
                                    if ms and longest else None),
            "warp_max_steps_mean": round(float(warp_max.mean()), 3),
            "step_atoms": atoms,
            "atoms_ms": round(atoms * 64 / HBM_BYTES_S * 1e3, 6),
            "bytes": fm_bytes(2 * isz * len(ranks), [
                (stats["occ_rows"].cpu().numpy(), OCC_ROW),
                (stats["mark_rows"].cpu().numpy(), MARK_ROW),
                (stats["samples"].cpu().numpy(), isz)])}


FLUSH_BYTES = 64 << 20  # a write past the H100's 50 MB L2


def cold_ms(torch, fn, reps=8):
    """The least device time of one call of ``fn`` right after a write of
    FLUSH_BYTES, which leaves none of the index in L2: CUDA events around
    the call alone, the stream held busy by a spin kernel while the host
    queues it, so no host time falls inside the window."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEV)
    best = None
    for r in range(reps):
        flush.fill_(r + 1)
        torch.cuda._sleep(1 << 18)
        _, ms = timed_once(torch, fn)
        best = ms if best is None else min(best, ms)
    return best


def ksa_alone(torch, didx, ranks, lib=None, max_blocks=0, n=None):
    """K-sa's C entry alone on preallocated buffers: a launch not counted
    on the wrapper, which raises if the entry fails.  Its buffers live on
    the returned function (``.buffers``: ranks, out, queue); its
    ``.entry`` makes the call and returns the entry's code.  ``lib``:
    another build of csrc/occ.cu's entries (the package's own where
    None); ``n``: the count passed to the entry (len(ranks) where
    None)."""
    from tpubwa_torch.device import _build, occ
    lib = lib or _build.load("occ", occ._SIGNATURES)
    fm = didx.upload_fm()
    out = torch.empty_like(ranks)
    queue = torch.empty(1, dtype=torch.int32, device=ranks.device)
    args = (fm["occ_blocks"].data_ptr(), fm["L2"].data_ptr(),
            fm["mark_rows"].data_ptr(), fm["sa_marked"].data_ptr(),
            fm["sa_sample"].data_ptr(), didx.primary, didx.seq_len,
            didx.mark_D, int(didx.idt == torch.int64), ranks.data_ptr(),
            out.data_ptr(), len(ranks) if n is None else n, queue.data_ptr(),
            None, max_blocks, ranks.device.index,
            torch.cuda.current_stream(ranks.device).cuda_stream)

    def launch():
        if launch.entry():
            raise AssertionError("K-sa's launch failed")
    launch.entry = lambda: lib.tpubwa_sa_lookup(*args)
    launch.buffers = (ranks, out, queue)
    return launch


def kext_alone(torch, didx, ik, is_back):
    """K-ext's C entry alone on preallocated buffers (``.buffers``: ik,
    out), a launch not counted on the wrapper."""
    from tpubwa_torch.device import _build, occ
    lib = _build.load("occ", occ._SIGNATURES)
    fm = didx.upload_fm()
    out = torch.empty((len(ik), 4, 3), dtype=ik.dtype, device=ik.device)
    args = (fm["occ_blocks"].data_ptr(), fm["L2"].data_ptr(), didx.primary,
            didx.seq_len, int(didx.idt == torch.int64), int(bool(is_back)),
            ik.data_ptr(), out.data_ptr(), len(ik), ik.device.index,
            torch.cuda.current_stream(ik.device).cuda_stream)

    def launch():
        if lib.tpubwa_bwt_extend(*args):
            raise AssertionError("K-ext's launch failed")
    launch.buffers = (ik, out)
    return launch


def ksa_launch_facts(torch, didx, n):
    """K-sa's launch for ``n`` ranks on this card: the blocks of 128
    threads an SM holds (the occupancy query), the grid's blocks and the
    warps an SM, and each instantiation's registers from ptxas."""
    from tpubwa_torch.device import _build, occ
    lib = _build.load("occ", occ._SIGNATURES)
    rc, shape = occ.sa_lookup_shape(lib, didx, n,
                                    torch.cuda.current_device())
    if rc:
        raise AssertionError(f"K-sa refuses {n} ranks")
    report = _build.build_info["occ"]["ptxas"]
    return {"launch": dict(shape, warps_per_sm=shape["blocks_per_sm"] * 4),
            "ptxas": {f"{walk}/{dt}": ptxas_usage(
                report, rf"sa_lookup_kernelI{m}Lb{b}EE")
                for walk, b in (("sampled", 0), ("marked", 1))
                for dt, m in (("int32", "i"), ("int64", "l"))}}


def ksa_refusal(torch, didx):
    """K-sa's C entry called with 2^31 - 1 ranks (4 in the tensor): it
    must refuse before anything runs (a nonzero cudaError, the queue word
    not zeroed, no position written)."""
    n = (1 << 31) - 1
    call = ksa_alone(torch, didx, torch.zeros(4, dtype=didx.idt, device=DEV),
                     n=n)
    _, out, queue = call.buffers
    out.fill_(-7)
    queue.fill_(-7)
    rc = call.entry()
    torch.cuda.synchronize()
    if rc == 0 or bool((out != -7).any() | (queue != -7).any()):
        raise AssertionError(f"K-sa ran {n} ranks")
    return {"n": n, "refused_rc": rc}


def load_rounds(text, function, min_width=128):
    """The row loads of one step of a walk in ``cuobjdump -sass`` output:
    of the one function whose mangled name matches the regex
    ``function``, the innermost loop that holds the most 128-bit global
    loads, its loads by width, and the rounds its 128-bit loads
    (``rounds_128``) and its loads of at least ``min_width`` bits
    (``rounds``) issue in.  A round ends where an instruction reads a
    register that a load of the round wrote, so one round means that
    every row of the step is requested before any is used: a step is one
    trip to memory."""
    name, ins, loops = sass_function(text, function)
    inner = [lp for lp in loops
             if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1]
                        for o in loops)]

    best = None
    for lo, hi, _ in inner:
        body = [op for a, op in ins if lo <= a <= hi]
        n128 = sum(ldg_width(op) == 128 for op in body)
        if n128 and (best is None or n128 > best[2]):
            best = (lo, body, n128)
    if best is None:
        raise AssertionError(f"{name}: no loop with a 128-bit load")
    lo, body, n128 = best

    def count(widths):
        rounds, pending = 0, set()
        for op in body:
            writes, addr, reads, _ = def_use(op)
            if pending & set(addr + reads):
                pending = set()
            if widths(ldg_width(op)):
                rounds += not pending
                pending |= set(writes)
        return rounds

    return {"function": name, "loop_at": hex(lo), "instructions": len(body),
            "ldg": ldg_counts(body), "ldg128": n128,
            "rounds_128": count(lambda w: w == 128),
            "rounds": count(lambda w: w is not None and w >= min_width)}


def ksa_sass():
    """K-sa's global loads in both walks (int32): ``sass_loads`` of each
    instantiation and the row loads of one step (``load_rounds``)."""
    from tpubwa_torch.device import _build
    text = _run([_cuobjdump(), "-sass", _build.build_info["occ"]["so"]])
    return {walk: {"sass_loads": sass_loads(text, fn),
                   "step": load_rounds(text, fn)}
            for walk, fn in (("sampled", r"sa_lookup_kernelIiLb0EE"),
                             ("marked", r"sa_lookup_kernelIiLb1EE"))}


def extend_case(torch, didx, ik, ms, plain_ms, stats):
    """A K-ext case: its times and bytes (ik in, [4, 3] out, the occ
    rows of its two occ4 queries)."""
    isz = 8 if didx.idt == torch.int64 else 4
    return {"n": len(ik), "ms": ms and round(ms, 4),
            "plain_ms": round(plain_ms, 3),
            "bytes": fm_bytes(15 * isz * len(ik), [
                (stats["occ_rows"].cpu().numpy(), OCC_ROW)])}


def int64_twin(torch, didx):
    """``didx`` with int64 ranks: the same arrays, the other
    instantiations of the kernels."""
    import dataclasses
    return dataclasses.replace(didx, idt=torch.int64, _fm=None)


def held_fm(torch, what, got, want):
    """Raise unless the kernel's ``got`` equals the plain ``want``
    exactly; returns (mismatching rows, largest absolute difference),
    (0, 0)."""
    diff = (got != want).reshape(len(got), -1).any(1)
    if bool(diff.any()):
        k = int(diff.nonzero()[0, 0])
        raise AssertionError(f"{what}: {int(diff.sum())} rows differ, first "
                             f"{k}: {got[k].tolist()} vs {want[k].tolist()}")
    return 0, int((got.long() - want.long()).abs().max()) if len(got) else 0


def fm_variants(torch, indexes):
    """{(marks, "int32" | "int64"): DeviceIndex}: each index of
    ``indexes`` ({marks: DeviceIndex}, int32 ranks) and its int64 twin,
    the other instantiations of the kernels."""
    return {(marks, dt): x if dt == "int32" else int64_twin(torch, x)
            for marks, x in indexes.items() for dt in ("int32", "int64")}


def fm_checks(torch, np, label, variants, rng, n):
    """Both kernels, every instantiation, == plain on one genome's
    ``variants`` (fm_variants): ``n`` random ranks and the edge ranks;
    ``n`` intervals from set_intv, then a backward and a forward
    extension step (a random base each).  Returns {case: facts}, each
    with its mismatches (0), its inputs and, for K-sa, its positions."""
    from tpubwa_torch.device import occ
    out = {}
    for (marks, dt), didx in variants.items():
        tag = f"{label}/{marks}/{dt}"
        sl = didx.seq_len
        m = np.arange(0, sl + 2, 128)[:4096]
        ranks = np.concatenate([
            [0, 1, didx.primary - 1, didx.primary, didx.primary + 1, sl - 1,
             sl], m - 1, m, m + 1, rng.integers(0, sl + 1, n)])
        ranks = ranks[(ranks >= 0) & (ranks <= sl)]
        r = torch.from_numpy(ranks.astype(didx.np_idt)).to(DEV)
        got = occ.sa_lookup(didx, r)
        torch.cuda.synchronize()
        stats = {}
        want, plain_ms = timed_once(
            torch, lambda: occ.sa_lookup_plain(didx, r, stats=stats))
        bad, err = held_fm(torch, f"{tag} sa_lookup", got, want)
        case = {"mismatches": bad, "max_abs_err": err, "didx": didx,
                "ranks": r, "got": got}
        case.update(walk_case(torch, np, didx, ranks, None, plain_ms,
                              stats))
        out[f"{tag}/sa_lookup"] = case
        ik = occ.set_intv(didx, torch.from_numpy(
            rng.integers(0, 4, n)).to(DEV))
        for is_back in (True, False):
            got = occ.bwt_extend(didx, ik, is_back)
            torch.cuda.synchronize()
            stats = {}
            want, plain_ms = timed_once(torch, lambda: occ.bwt_extend_plain(
                didx, ik, is_back, stats=stats))
            step = "back" if is_back else "fwd"
            bad, err = held_fm(torch, f"{tag} bwt_extend {step}", got, want)
            case = {"mismatches": bad, "max_abs_err": err, "didx": didx,
                    "ik": ik, "is_back": is_back, "got": got}
            case.update(extend_case(torch, didx, ik, None, plain_ms,
                                    stats))
            out[f"{tag}/bwt_extend_{step}"] = case
            ik = got[torch.arange(n, device=DEV), torch.from_numpy(
                rng.integers(0, 4, n)).to(DEV)].contiguous()
    return out


def small_index(tmp):
    """tests/test_torch_occ.py's genome (3,000 random bases, seed 11),
    marked, and its save_bwa/load_bwa round trip (no marks)."""
    import numpy as np
    from tpubwa_torch.index import FMIndex
    from tpubwa_torch.index.build import BntSeq, SeqAnn
    codes = np.random.default_rng(11).integers(0, 4, 3000).astype(np.uint8)
    fmi = FMIndex.build(BntSeq(l_pac=3000, anns=[SeqAnn(
        name="g", anno="", offset=0, length=3000, n_ambs=0)], ambs=[],
        seed=11, codes=codes))
    fmi.save_bwa(os.path.join(tmp, "g"))
    return fmi, FMIndex.load_bwa(os.path.join(tmp, "g"))


def phase_occ(torch, np, fmi, stock):
    """[3g occ]: K-sa and K-ext == plain in every instantiation on the
    small genome and on phase 5's 64 Mbp index (marked, and its stock-bwa
    round trip ``stock``, 5b's), K-sa == the native walk on the marked
    one, each kernel timed in interleaved passes; then the extension
    path (set_intv, a backward and a forward step) driven once with the
    counts at 0.  Returns (the bwt_extend row's case, its launches, the
    largest K-sa difference from plain)."""
    import tempfile
    from tpubwa_torch.device import occ
    from tpubwa_torch.device.occ import DeviceIndex
    from tpubwa_torch.host.native_smem import sa_positions_native
    from tpubwa_torch.scripts.exp_kernel_floor import interleaved_min
    rng = np.random.default_rng(0x0CC)
    with tempfile.TemporaryDirectory(dir=BUILD) as d:
        sm, sm_bwa = small_index(d)
    cases = fm_checks(torch, np, "3 kb", fm_variants(torch, {
        "marked": DeviceIndex.from_fmindex(sm, DEV),
        "unmarked": DeviceIndex.from_fmindex(sm_bwa, DEV)}), rng, 4096)
    big = {"marked": DeviceIndex.from_fmindex(fmi, DEV),
           "unmarked": DeviceIndex.from_fmindex(stock, DEV)}
    cases.update(fm_checks(torch, np, f"{GENOME_MB} Mbp",
                           fm_variants(torch, big), rng, 1 << 16))
    # the marked 64 Mbp walk against the native one, rank by rank
    case = cases[f"{GENOME_MB} Mbp/marked/int32/sa_lookup"]
    ranks = case["ranks"].cpu().numpy().astype(np.int64)
    flat = np.zeros((len(ranks), 5), np.int64)
    flat[:, 0], flat[:, 2] = ranks, 1
    nat = sa_positions_native(fmi, flat, 1)
    if nat is None:
        raise AssertionError("the native walk is unavailable")
    native_mismatches = int((case["got"].cpu().numpy() != nat[0]).sum())
    if native_mismatches:
        raise AssertionError(f"K-sa != the native walk on "
                             f"{native_mismatches} ranks")
    # times: every 64 Mbp instantiation alone (its C entry on its own
    # buffers) in interleaved passes, K-ext through its wrapper too (a
    # call costs the host about as long as the kernel runs), and K-sa
    # once more after a write that flushes L2
    fns = {}
    for key, c in cases.items():
        if not key.startswith(f"{GENOME_MB} Mbp"):
            continue
        if "ranks" in c:
            fns[key] = ksa_alone(torch, c["didx"], c["ranks"])
        else:
            fns[key] = kext_alone(torch, c["didx"], c["ik"], c["is_back"])
            fns[f"{key} wrapper"] = (
                lambda x, ik, b: lambda: occ.bwt_extend(x, ik, b))(
                    c["didx"], c["ik"], c["is_back"])
    best = interleaved_min(fns, 20, 4, torch.device(DEV))
    for key, ms in best.items():
        if key.endswith(" wrapper"):
            continue
        c = cases[key]
        c["ms"] = round(ms, 4)
        if not torch.equal(fns[key].buffers[1], c["got"]):
            raise AssertionError(f"{key}: alone != its wrapper")
        if "ranks" in c:
            c["cold_ms"] = round(cold_ms(torch, fns[key]), 4)
            if c["steps_max"]:
                c["us_per_step_longest"] = round(ms * 1e3 / c["steps_max"], 4)
        else:
            c["wrapper_ms"] = round(best[f"{key} wrapper"], 4)
    # the extension path, its launches counted: set_intv, then a
    # backward and a forward step, each on a random base of the last
    didx = big["marked"]
    pick = [torch.from_numpy(rng.integers(0, 4, 1 << 16)).to(DEV)
            for _ in range(3)]
    occ.sa_lookup.launches = occ.bwt_extend.launches = 0
    ik = occ.set_intv(didx, pick[0])
    for is_back, c in ((True, pick[1]), (False, pick[2])):
        ik = occ.bwt_extend(didx, ik, is_back)[
            torch.arange(len(c), device=DEV), c].contiguous()
    torch.cuda.synchronize()
    ext_launches = occ.bwt_extend.launches
    if ext_launches != 2 or occ.sa_lookup.launches:
        raise AssertionError(f"the extension path launched "
                             f"{ext_launches} extensions")
    shown = {k: {f: v for f, v in c.items()
                 if f not in ("didx", "ranks", "got", "ik", "is_back")}
             for k, c in cases.items()}
    print("[3g occ] " + json.dumps({
        "tolerance": 0, "cases": shown,
        "native_walk": {"ranks": len(ranks), "mismatches": native_mismatches},
        "sa_lookup_refusal": {dt: ksa_refusal(torch, x) for dt, x in (
            ("int32", didx), ("int64", int64_twin(torch, didx)))},
        "extension_path_launches": ext_launches}), flush=True)
    row = cases[f"{GENOME_MB} Mbp/marked/int32/bwt_extend_fwd"]
    err = {name: max(c["max_abs_err"] for k, c in cases.items()
                     if name in k) for name in ("sa_lookup", "bwt_extend")}
    return dict(row, max_abs_err=err["bwt_extend"]), ext_launches, \
        err["sa_lookup"]


def phase_stock_bwa(torch, np, main):
    """[5b stock-bwa]: phase 5's index written as stock bwa files (its
    ALT contig in a .alt file, as bwa.kit lists them) and loaded back as
    `mem` loads a prefix (cli.load_index: no text-position marks), then
    phase 5's 2 x 8,192
    pairs through the port's aligner on cuda: the SA positions come
    from K-sa.  Its SAM must equal phase 5's byte for byte.  Returns
    (the stock index, the sa_lookup row's case, K-sa's launches, and the
    first launch's (index, ranks))."""
    import tempfile
    from tpubwa_torch.device import extend_kernel as ek
    from tpubwa_torch.device import occ
    from tpubwa_torch.device import pipeline as dp
    from tpubwa_torch.host.pipeline import process_batches
    from tpubwa_torch.cli import load_index
    from tpubwa_torch.sim import simulate_pe
    from tpubwa_torch.scripts.exp_kernel_floor import interleaved_min
    fmi, opt, batches = main["fmi"], main["opt"], main["batches"]
    with tempfile.TemporaryDirectory(dir=BUILD) as d:
        prefix = os.path.join(d, "stock")
        t0 = time.perf_counter()
        fmi.save_bwa(prefix)
        # the ALT contigs as bwa.kit lists them: stock files carry none
        with open(prefix + ".alt", "w") as fh:
            fh.writelines(f"{a.name}\n" for a in fmi.bnt.anns if a.is_alt)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        stock = load_index(prefix)
        index_s = time.perf_counter() - t0
    if stock.sa_mark_D:
        raise AssertionError("a stock-bwa index came back with marks")
    aligner = dp.make_device_aligner(opt, stock, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aligner.didx.upload_fm()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    warm = simulate_pe(stock.bnt, 1024, 100, np.random.default_rng(2))
    for _ in process_batches(opt, stock, iter([warm]), 0, align_fn=aligner):
        pass
    sa = {"s": 0.0, "ranks": 0}
    sa_positions = aligner._sa_positions

    def timed_sa(intv):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = sa_positions(intv)
        torch.cuda.synchronize()
        sa["s"] += time.perf_counter() - t
        sa["ranks"] += len(out[0])
        return out

    seen = []

    def keep(didx, ranks):
        if not seen:
            seen.append(ranks)
        return lookup(didx, ranks)

    aligner._sa_positions = timed_sa
    lookup, dp.sa_lookup = dp.sa_lookup, keep
    try:
        occ.sa_lookup.launches = occ.bwt_extend.launches = 0
        ek.extend_batch.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lines = [l for _, ls in process_batches(
            opt, stock, iter(batches), 0, align_fn=aligner) for l in ls]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = occ.sa_lookup.launches
        ext_launches = occ.bwt_extend.launches
        k1_launches = ek.extend_batch.launches
    finally:
        dp.sa_lookup = lookup
    if launches <= 0:
        raise AssertionError("5b never launched the SA walk")
    if ext_launches:
        raise AssertionError(f"5b launched the extension {ext_launches} "
                             "times (it is not on mem)")
    if lines != main["sam"]:
        raise AssertionError(f"5b SAM != phase 5's ({len(lines)} vs "
                             f"{len(main['sam'])} lines, first diff "
                             f"{sam_diff(lines, main['sam'])})")
    # the first launch's ranks again: K-sa alone (its C entry) and
    # through its wrapper in interleaved passes, alone once more after a
    # write that flushes L2, the plain version, the bytes of the walk
    didx, ranks = aligner.didx, seen[0]
    got = occ.sa_lookup(didx, ranks)
    stats = {}
    want, plain_ms = timed_once(
        torch, lambda: occ.sa_lookup_plain(didx, ranks, stats=stats))
    _, err = held_fm(torch, "5b's K-sa launch", got, want)
    alone = ksa_alone(torch, didx, ranks)
    best = interleaved_min({
        "alone": alone, "wrapper": lambda: occ.sa_lookup(didx, ranks)}, 20,
        4, torch.device(DEV))
    cold = cold_ms(torch, alone)
    held_fm(torch, "5b's K-sa launch alone", alone.buffers[1], want)
    case = walk_case(torch, np, didx, ranks.cpu().numpy(), best["alone"],
                     plain_ms, stats, cold_ms=cold)
    case.update(wrapper_ms=round(best["wrapper"], 4),
                bound_ms=round(bytes_bound(case)[0], 6), max_abs_err=err,
                **ksa_launch_facts(torch, didx, len(ranks)))
    n_reads = sum(len(b) for b in batches)
    print("[5b stock-bwa] " + json.dumps({
        "index": "phase 5's, save_bwa + .alt, cli.load_index (no "
                 ".tpubwa.npz)",
        "save_s": round(save_s, 3), "index_s": round(index_s, 3),
        "fm_upload_s": round(upload_s, 3), "reads": n_reads,
        "seconds": round(dt, 3), "reads_per_s": round(n_reads / dt, 1),
        "phase5_reads_per_s": round(main["reads_per_s"], 1),
        "sam_lines": len(lines), "sam_equal_to_phase5": True,
        "sa_stage_s": round(sa["s"], 3), "ranks_walked": sa["ranks"],
        "sa_lookup_launches": launches, "bwt_extend_launches": ext_launches,
        "k1_launches": k1_launches, "sa_launch": case,
        "sass": ksa_sass()}), flush=True)
    return stock, case, launches, (didx, ranks)


def busy_share(torch, fn):
    """(fn(), its wall s, the device's busy share of that wall): the
    union of the device's kernel and copy intervals in a torch.profiler
    (CUPTI) trace of one call of ``fn``, over its host wall, the device
    bracketed by synchronize; None where the trace holds no device
    event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return out, wall, (busy / 1e6 / wall if spans else None)


class SeedTimer:
    """The seeding stage's wall: ``pipeline.collect_intv_device`` wrapped,
    each call bracketed by synchronize, summed over the calls made inside
    the ``with``."""

    def __init__(self, torch):
        self.torch, self.s, self.calls = torch, 0.0, 0

    def __enter__(self):
        from tpubwa_torch.device import pipeline as dp
        self.dp, self.real = dp, dp.collect_intv_device

        def timed(*a, **k):
            self.torch.cuda.synchronize()
            t = time.perf_counter()
            out = self.real(*a, **k)
            self.torch.cuda.synchronize()
            self.s += time.perf_counter() - t
            self.calls += 1
            return out

        dp.collect_intv_device = timed
        return self

    def __exit__(self, *exc):
        self.dp.collect_intv_device = self.real


def seed_aligner(opt, fmi, mode):
    """The port's aligner on the card as `mem` makes it with
    TPUBWA_SEED_MODE=``mode`` (the mode is read when it is made)."""
    from tpubwa_torch.device.pipeline import make_device_aligner
    old = os.environ.get("TPUBWA_SEED_MODE")
    os.environ["TPUBWA_SEED_MODE"] = mode
    try:
        aligner = make_device_aligner(opt, fmi, device=DEV)
    finally:
        if old is None:
            del os.environ["TPUBWA_SEED_MODE"]
        else:
            os.environ["TPUBWA_SEED_MODE"] = old
    if aligner.seed_mode != mode:
        raise AssertionError("the aligner did not take TPUBWA_SEED_MODE")
    return aligner


def phase_megaq(torch, np, main):
    """[5c megaq]: phase 5's 2 x 8,192 pairs through the port's aligner on
    cuda with TPUBWA_SEED_MODE=megaq: every seeding row comes from K2 and
    K3 (csrc/smem.cu).  Its SAM must equal phase 5's byte for byte; K2
    and K3 must launch, with the counts at 0 just before the run.
    Reads/s and the seeding stage's wall beside phase 5's, the reads that
    took K2's second launch, and each mode's device busy share over a
    profiled pass of the first batch.  Returns the facts, with the first
    chunk's K2 inputs (``chunk``: opt, didx, qd, ld) for phase 3h."""
    from tpubwa_torch.device import extend_kernel as ek
    from tpubwa_torch.device import smem, smem_fused
    from tpubwa_torch.host.pipeline import process_batches
    from tpubwa_torch.sim import simulate_pe
    fmi, opt, batches = main["fmi"], main["opt"], main["batches"]
    aligner = seed_aligner(opt, fmi, "megaq")
    warm = simulate_pe(fmi.bnt, 1024, 100, np.random.default_rng(2))
    for _ in process_batches(opt, fmi, iter([warm]), 0, align_fn=aligner):
        pass
    seen = {"calls": [], "reads": 0, "second": 0}
    k2 = smem.rounds12_megaq

    def kept(opt_, didx, qd, ld, **kw):
        stats = {}
        out = k2(opt_, didx, qd, ld, stats=stats, **kw)
        if not seen["calls"]:
            seen["calls"].append((opt_, didx, qd, ld))
        seen["reads"] += len(ld)
        seen["second"] += stats["second_launch_reads"]
        return out

    smem.rounds12_megaq = kept
    try:
        smem_fused.rounds12_megaq.launches = 0
        smem._seed_strategy_scan.launches = 0
        ek.extend_batch.launches = 0
        torch.cuda.synchronize()
        with SeedTimer(torch) as seeding:
            t0 = time.perf_counter()
            lines = [l for _, ls in process_batches(
                opt, fmi, iter(batches), 0, align_fn=aligner) for l in ls]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches = {"smem_rounds12": smem_fused.rounds12_megaq.launches,
                    "seed_strategy": smem._seed_strategy_scan.launches,
                    "ksw_extend": ek.extend_batch.launches}
    finally:
        smem.rounds12_megaq = k2
    if not launches["smem_rounds12"] or not launches["seed_strategy"]:
        raise AssertionError(f"5c launched {launches}")
    if lines != main["sam"]:
        raise AssertionError(f"5c SAM != phase 5's ({len(lines)} vs "
                             f"{len(main['sam'])} lines, first diff "
                             f"{sam_diff(lines, main['sam'])})")
    # each mode's busy share over one profiled pass of the first batch
    busy = {}
    for name, fn in (("phase5_host", main["aligner"]), ("megaq", aligner)):
        _, wall, share = busy_share(torch, lambda: [
            0 for _ in process_batches(opt, fmi, iter(batches[:1]), 0,
                                       align_fn=fn)])
        busy[name] = {"wall_s": round(wall, 3), "busy_share":
                      share if share is None else round(share, 5)}
    n_reads = sum(len(b) for b in batches)
    facts = {"reads": n_reads, "seconds": round(dt, 3),
             "reads_per_s": round(n_reads / dt, 1),
             "phase5_reads_per_s": round(main["reads_per_s"], 1),
             "seeding_s": round(seeding.s, 3),
             "phase5_seeding_s": round(main["seeding_s"], 3),
             "seeding_calls": seeding.calls, "sam_lines": len(lines),
             "sam_equal_to_phase5": True, "launches": launches,
             "k2_second_launch_reads": seen["second"],
             "k2_second_launch_share": round(seen["second"] / seen["reads"],
                                             6),
             "first_batch_pass": busy}
    print("[5c megaq] " + json.dumps(facts), flush=True)
    return dict(facts, chunk=seen["calls"][0])


def phase_megaq_stock(torch, np, main, stock):
    """[5d megaq-stock]: phase 5's 2 x 8,192 pairs through the port's
    aligner on cuda with TPUBWA_SEED_MODE=megaq on 5b's stock-bwa index
    (``stock``, no text-position marks): K2 and K3 seed every read and
    K-sa walks every SA position, all three on one run.  Its SAM must
    equal phase 5's byte for byte; K2, K3 and K-sa must each launch, with
    the counts at 0 just before the run."""
    from tpubwa_torch.device import extend_kernel as ek
    from tpubwa_torch.device import occ, smem, smem_fused
    from tpubwa_torch.host.pipeline import process_batches
    from tpubwa_torch.sim import simulate_pe
    opt, batches = main["opt"], main["batches"]
    aligner = seed_aligner(opt, stock, "megaq")
    warm = simulate_pe(stock.bnt, 1024, 100, np.random.default_rng(2))
    for _ in process_batches(opt, stock, iter([warm]), 0, align_fn=aligner):
        pass
    smem_fused.rounds12_megaq.launches = 0
    smem._seed_strategy_scan.launches = 0
    occ.sa_lookup.launches = occ.bwt_extend.launches = 0
    ek.extend_batch.launches = 0
    torch.cuda.synchronize()
    with SeedTimer(torch) as seeding:
        t0 = time.perf_counter()
        lines = [l for _, ls in process_batches(
            opt, stock, iter(batches), 0, align_fn=aligner) for l in ls]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = {"smem_rounds12": smem_fused.rounds12_megaq.launches,
                "seed_strategy": smem._seed_strategy_scan.launches,
                "sa_lookup": occ.sa_lookup.launches,
                "bwt_extend": occ.bwt_extend.launches,
                "ksw_extend": ek.extend_batch.launches}
    if not all(launches[k] for k in ("smem_rounds12", "seed_strategy",
                                     "sa_lookup")):
        raise AssertionError(f"5d launched {launches}")
    if lines != main["sam"]:
        raise AssertionError(f"5d SAM != phase 5's ({len(lines)} vs "
                             f"{len(main['sam'])} lines, first diff "
                             f"{sam_diff(lines, main['sam'])})")
    n_reads = sum(len(b) for b in batches)
    facts = {"index": "5b's (stock bwa files, no marks)", "reads": n_reads,
             "seconds": round(dt, 3), "reads_per_s": round(n_reads / dt, 1),
             "phase5_reads_per_s": round(main["reads_per_s"], 1),
             "seeding_s": round(seeding.s, 3), "sam_lines": len(lines),
             "sam_equal_to_phase5": True, "launches": launches}
    print("[5d megaq-stock] " + json.dumps(facts), flush=True)
    return facts


def sam_diff(lines, want):
    """Where two SAM texts part: the first differing line, or -1 where
    their lengths differ."""
    if len(lines) != len(want):
        return -1
    return next(i for i, (a, b) in enumerate(zip(lines, want)) if a != b)


def phase_hybrid(torch, np, main, megaq):
    """[5e hybrid]: phase 5's 2 x 8,192 pairs through the port's aligner
    on cuda with TPUBWA_SEED_MODE=hybrid and the TPUBWA_HYBRID_* defaults
    (as `mem` runs it): each chunk's first k reads on K2 and K3 beside
    the native seeder on the rest, k from the balancer.  Pass 1 at the
    aligner's chunk size (16,384 reads), pass 2 at 4,096 (eight chunks
    for the balancer to move over), each with a new balancer (after the
    warm-up, as a `mem` run starts) and the counts at 0 just before it.
    Each pass's SAM must equal phase 5's byte for byte, K2 and K3 must
    launch, and every chunk of at least k_floor / f reads must be seeded
    on both sides (0 < k < B).  Prints each chunk's (B, k, t_dev, t_host,
    f), reads/s and the seeding stage's wall beside phase 5's and 5c's.
    Returns the facts, with both passes' launches summed."""
    from tpubwa_torch.device import smem, smem_fused
    from tpubwa_torch.device.smem import HybridSplit
    from tpubwa_torch.host.pipeline import process_batches
    from tpubwa_torch.sim import simulate_pe
    fmi, opt, batches = main["fmi"], main["opt"], main["batches"]
    aligner = seed_aligner(opt, fmi, "hybrid")
    warm = simulate_pe(fmi.bnt, 1024, 100, np.random.default_rng(2))
    for _ in process_batches(opt, fmi, iter([warm]), 0, align_fn=aligner):
        pass
    n_reads = sum(len(b) for b in batches)
    launches = {"smem_rounds12": 0, "seed_strategy": 0}
    facts = {"reads": n_reads,
             "phase5_reads_per_s": round(main["reads_per_s"], 1),
             "phase5_seeding_s": round(main["seeding_s"], 3),
             "megaq_5c_reads_per_s": megaq["reads_per_s"],
             "megaq_5c_seeding_s": megaq["seeding_s"]}
    for name, chunk_reads in (("pass1", aligner.chunk_reads),
                              ("pass2", 4096)):
        aligner.chunk_reads = chunk_reads
        aligner.hybrid = split = HybridSplit.from_env()
        smem_fused.rounds12_megaq.launches = 0
        smem._seed_strategy_scan.launches = 0
        torch.cuda.synchronize()
        with SeedTimer(torch) as seeding:
            t0 = time.perf_counter()
            lines = [l for _, ls in process_batches(
                opt, fmi, iter(batches), 0, align_fn=aligner) for l in ls]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        got = {"smem_rounds12": smem_fused.rounds12_megaq.launches,
               "seed_strategy": smem._seed_strategy_scan.launches}
        if not all(got.values()):
            raise AssertionError(f"5e {name} launched {got}")
        if lines != main["sam"]:
            raise AssertionError(
                f"5e {name} SAM != phase 5's ({len(lines)} vs "
                f"{len(main['sam'])} lines, first diff "
                f"{sam_diff(lines, main['sam'])})")
        chunks = [dict(zip(("B", "k", "t_dev", "t_host", "f"), h))
                  for h in split.history]
        if len(chunks) != seeding.calls:
            raise AssertionError(f"5e {name}: {seeding.calls} chunks "
                                 f"seeded, {len(chunks)} in the history")
        for c in chunks:
            if c["B"] * c["f"] >= split.k_floor and not 0 < c["k"] < c["B"]:
                raise AssertionError(f"5e {name}: a chunk not split: {c}")
        for k in launches:
            launches[k] += got[k]
        facts[name] = {
            "chunk_reads": chunk_reads, "seconds": round(dt, 3),
            "reads_per_s": round(n_reads / dt, 1),
            "seeding_s": round(seeding.s, 3), "sam_lines": len(lines),
            "sam_equal_to_phase5": True, "launches": got,
            "k_floor": split.k_floor, "f_after": round(split.f, 6),
            "chunks": [{k: round(v, 6) if k in ("t_dev", "t_host", "f")
                        else v for k, v in c.items()} for c in chunks]}
    facts["launches"] = launches
    print("[5e hybrid] " + json.dumps(facts), flush=True)
    return facts


def edge_reads(np, text, rng):
    """Reads at the protocol's edges: across the sentinel's row both ways
    (30 random bases then the doubled text's first 70: a backward step
    from that prefix; its last 70 then 30 random bases: a forward step
    whose reverse complement is that prefix), a 40-base unit of the
    text repeated, a random read, one base, all N."""
    r30 = rng.integers(0, 4, (2, 30)).astype(np.uint8)
    return [np.concatenate([r30[0], text[:70]]),
            np.concatenate([text[len(text) - 70:], r30[1]]),
            np.tile(text[1000:1040], 3)[:100].copy(),
            rng.integers(0, 4, 100).astype(np.uint8), text[500:501].copy(),
            np.full(100, 4, np.uint8)]


def pack_reads(np, reads, L=128):
    arr = np.full((len(reads), L), 4, np.uint8)
    lens = np.array([len(r) for r in reads], np.int32)
    for i, r in enumerate(reads):
        arr[i, :len(r)] = r
    return arr, lens


def seeding_checks(torch, np, label, fmi, arr, lens, opt):
    """K2 (both launches, and with one slot a read) and K3 == their plain
    versions, every instantiation, on ``arr``/``lens``: the kernels on the
    card, the plain versions on CPU copies of the index.  Returns
    {instantiation: facts}, each with the plain version's ms."""
    from tpubwa_torch.device import smem, smem_fused
    from tpubwa_torch.device.occ import DeviceIndex
    gpu = DeviceIndex.from_fmindex(fmi, DEV)
    cpu = DeviceIndex.from_fmindex(fmi, "cpu")
    q, ld = torch.from_numpy(arr), torch.from_numpy(lens)
    out = {}
    for dt in ("int32", "int64"):
        g, c = (gpu, cpu) if dt == "int32" else (int64_twin(torch, gpu),
                                                 int64_twin(torch, cpu))
        t0 = time.perf_counter()
        want_stats = {}
        want = smem_fused.rounds12_plain(opt, c, q, ld, stats=want_stats)
        plain12 = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want3_stats = {}
        want3 = smem._seed_strategy_scan_plain(c, q, ld, opt.min_seed_len,
                                               opt.max_mem_intv,
                                               stats=want3_stats)
        plain3 = (time.perf_counter() - t0) * 1e3
        second = 0
        for slots in (smem_fused.K2_SLOTS, 1):
            stats = {}
            got = smem_fused.rounds12_megaq(opt, g, q.to(DEV), ld.to(DEV),
                                            slots=slots, stats=stats)
            torch.cuda.synchronize()
            for key in ("steps", "chain"):
                if not torch.equal(stats[key].cpu(), want_stats[key]):
                    raise AssertionError(f"{label}/{dt} K2 {key} (slots "
                                         f"{slots}) != plain")
            if got[0].shape != want[0].shape:
                raise AssertionError(f"{label}/{dt} K2 (slots {slots}): "
                                     f"{len(got[0])} rows, plain "
                                     f"{len(want[0])}")
            for a, b, what in ((got[0], want[0], "rows"),
                               (got[1], want[1], "rids")):
                held_fm(torch, f"{label}/{dt} K2 {what} (slots {slots})",
                        a.cpu().reshape(len(a), -1),
                        b.reshape(len(b), -1))
            second = max(second, stats["second_launch_reads"])
        stats3 = {}
        got3 = smem._seed_strategy_scan(g, q.to(DEV), ld.to(DEV),
                                        opt.min_seed_len, opt.max_mem_intv,
                                        stats=stats3)
        torch.cuda.synchronize()
        for key in ("steps", "chain", "longest"):
            if not torch.equal(stats3[key].cpu(), want3_stats[key]):
                raise AssertionError(f"{label}/{dt} K3 {key} != plain")
        for a, b, what in ((got3[0], want3[0], "hits"),
                           (got3[1], want3[1], "n_hits")):
            held_fm(torch, f"{label}/{dt} K3 {what}",
                    a.cpu().reshape(len(a), -1), b.reshape(len(b), -1))
        out[dt] = {"reads": len(arr), "rows12": len(want[0]),
                   "hits": int(want3[1].sum()), "mismatches": 0,
                   "second_launch_reads_at_1_slot": second,
                   "plain_ms": {"smem_rounds12": round(plain12, 3),
                                "seed_strategy": round(plain3, 3)}}
    return out


def seeding_bytes(torch, np, didx, qd, ld, opt, kernel, out_rows):
    """The bytes a launch of K2 (``kernel`` 0, every read of the chunk)
    or K3 (1) must move: the reads and lens, the rows it writes
    (``out_rows``) and their counts, and the distinct sectors of the
    index it reads, counted by csrc/smem_host.cpp (built without the
    sanitizers) on the same inputs."""
    from tpubwa_torch.device import smem, smem_fused, warp_host
    fm = didx.upload_fm()
    arrays = {"occ_blocks": fm["occ_blocks"].cpu().numpy().view(np.uint32),
              "L2": fm["L2"].cpu().numpy(), "primary": didx.primary,
              "seq_len": didx.seq_len}
    B, L = qd.shape
    *_, rows = warp_host.smem_host(
        arrays, qd.cpu().numpy(), ld.cpu().numpy(), kernel,
        (opt.min_seed_len, smem_fused.split_len_of(opt), opt.split_width,
         opt.max_mem_intv, smem.max_hits(L, opt.min_seed_len)),
        slots=smem_fused.K2_SLOTS, count_rows=True, sanitize=False)
    isz = 8 if didx.idt == torch.int64 else 4
    io = B * L + 4 * B + out_rows * 5 * isz + 4 * B
    return fm_bytes(io, [(rows, OCC_ROW)]), len(rows)


def k2_alone(torch, opt, didx, qd, ld, lib=None):
    """K2's C entry alone on preallocated buffers (every read, the row
    slots of the first launch): a launch not counted on the wrapper.
    The buffers live on the returned function (``.buffers``: rids,
    queue, rows, counts, steps, chain), which launches on their
    pointers.  ``lib``: another build of csrc/smem.cu's entries (the
    package's own where None)."""
    from tpubwa_torch.device import _build, smem_fused as sf
    lib = lib or _build.load("smem", sf._SIGNATURES)
    B, L = qd.shape
    rids = torch.arange(B, dtype=torch.int32, device=DEV)
    queue = torch.empty(1, dtype=torch.int32, device=DEV)
    rows = torch.empty((B, sf.K2_SLOTS, 5), dtype=didx.idt, device=DEV)
    counts, steps, chain = (torch.empty(B, dtype=torch.int32, device=DEV)
                            for _ in range(3))
    args = (*sf.index_args(didx), qd.data_ptr(), L, ld.data_ptr(),
            rids.data_ptr(), B, opt.min_seed_len, sf.split_len_of(opt),
            opt.split_width, sf.K2_SLOTS, queue.data_ptr(),
            rows.data_ptr(), counts.data_ptr(), steps.data_ptr(),
            chain.data_ptr(), qd.device.index, sf.stream_of(qd))

    def launch():
        if lib.tpubwa_smem_rounds12(*args):
            raise AssertionError("K2's launch failed")
    launch.buffers = (rids, queue, rows, counts, steps, chain)
    return launch


def k2_refusals(torch, didx, qd, ld, opt):
    """K2 on reads one base longer than it takes, each rank type: the C
    entry must refuse before it runs (a nonzero cudaError, nothing
    written) and the wrapper raise RuntimeError naming the limit.
    Returns {rank type: facts}, with the launch shape at the longest
    length it takes."""
    from tpubwa_torch.device import _build, smem_fused as sf
    lib = _build.load("smem", sf._SIGNATURES)
    out = {}
    for dt, x in (("int32", didx), ("int64", int64_twin(torch, didx))):
        _, shape = sf.k2_shape(lib, x.idt == torch.int64, 128,
                               qd.device.index)
        most = shape["max_len"]
        if most != sf.k2_max_len(x.idt):
            raise AssertionError(f"K2's limit {most} != k2_max_len")
        wide = torch.full((len(ld), most + 1), 4, dtype=torch.uint8,
                          device=DEV)
        wide[:, :qd.shape[1]] = qd
        queue, counts = (torch.full((n,), -7, dtype=torch.int32, device=DEV)
                         for n in (1, len(ld)))
        rids = torch.arange(len(ld), dtype=torch.int32, device=DEV)
        rows = torch.empty((len(ld), 1, 5), dtype=x.idt, device=DEV)
        rc = lib.tpubwa_smem_rounds12(
            *sf.index_args(x), wide.data_ptr(), most + 1, ld.data_ptr(),
            rids.data_ptr(), len(ld), opt.min_seed_len, sf.split_len_of(opt),
            opt.split_width, 1, queue.data_ptr(), rows.data_ptr(),
            counts.data_ptr(), None, None, qd.device.index,
            sf.stream_of(wide))
        torch.cuda.synchronize()
        if rc == 0 or bool((counts != -7).any() | (queue != -7).any()):
            raise AssertionError(f"K2 ran reads of {most + 1} bases ({dt})")
        try:
            sf.rounds12_megaq(opt, x, wide, ld)
        except RuntimeError as e:
            if f"at most {most} bases" not in str(e):
                raise
            said = str(e)
        else:
            raise AssertionError(f"the wrapper took {most + 1} bases ({dt})")
        _, at_most = sf.k2_shape(lib, x.idt == torch.int64, most,
                                 qd.device.index)
        out[dt] = {"max_len": most, "refused_rc": rc, "raised": said,
                   "shape_at_max_len": at_most}
    return out


def k3_alone(torch, opt, didx, qd, ld, lib=None):
    """K3's C entry alone on preallocated buffers, which live on the
    returned function (``.buffers``: queue, hits, n_hits, steps, chain,
    longest), as does the index whose device arrays it reads
    (``.index``: an index made for the call, such as an int64 twin, would
    free them when dropped).  ``lib``: another build of csrc/smem.cu's
    entries (the package's own where None)."""
    from tpubwa_torch.device import _build, smem, smem_fused as sf
    lib = lib or _build.load("smem", sf._SIGNATURES)
    B, L = qd.shape
    maxh = smem.max_hits(L, opt.min_seed_len)
    queue = torch.empty(1, dtype=torch.int32, device=DEV)
    hits = torch.zeros((B, maxh, 5), dtype=didx.idt, device=DEV)
    n_hits, steps, chain, longest = (
        torch.empty(B, dtype=torch.int32, device=DEV) for _ in range(4))
    args = (*sf.index_args(didx), qd.data_ptr(), L, ld.data_ptr(), B,
            opt.min_seed_len, opt.max_mem_intv, maxh, queue.data_ptr(),
            hits.data_ptr(), n_hits.data_ptr(), steps.data_ptr(),
            chain.data_ptr(), longest.data_ptr(), qd.device.index,
            sf.stream_of(qd))

    def launch():
        if lib.tpubwa_seed_strategy(*args):
            raise AssertionError("K3's launch failed")
    launch.buffers = (queue, hits, n_hits, steps, chain, longest)
    launch.index = didx
    return launch


def phase_seeding(torch, np, main, megaq):
    """[3h seeding]: K2 and K3 == their plain versions in each
    instantiation (int32 and int64 ranks; K2 also with one row slot a
    read, so most reads take its second launch) on the 3,000-base test
    genome and on 256 reads of phase 5's first chunk with the edge
    reads; megaq rows == the native seeder's on all 32,768 of phase 5's
    reads, both instantiations; then, on 5c's first chunk (the launch the
    main path gives K2), each kernel alone in interleaved passes, its
    wrapper, its bwt_extend steps a read and a warp, and its bytes.
    Returns {kernel: (launches, max_abs_err, case)}."""
    import tempfile
    from tpubwa_torch.device import smem, smem_fused
    from tpubwa_torch.device.smem import collect_intv_device
    from tpubwa_torch.host.native_smem import smem_collect_batch_native
    from tpubwa_torch.scripts.exp_kernel_floor import interleaved_min
    fmi, opt = main["fmi"], main["opt"]
    rng = np.random.default_rng(0x5EED)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD) as d:
        sm, _ = small_index(d)
    text = sm.bnt.doubled()
    small = [text[s:s + 100].copy()
             for s in rng.integers(0, len(text) - 100, 250)]
    for r in small[:100]:
        r[rng.integers(0, 100, 3)] = rng.integers(0, 5, 3)
    cases = {}
    cases["3 kb"] = seeding_checks(
        torch, np, "3 kb", sm, *pack_reads(np, small + edge_reads(
            np, text, rng)), opt)
    _, _, qd, ld = megaq["chunk"]
    qn, lens = qd[:256].cpu().numpy(), ld[:256].cpu().numpy()
    big = [qn[i, :lens[i]] for i in range(256)]
    cases[f"{GENOME_MB} Mbp"] = seeding_checks(
        torch, np, f"{GENOME_MB} Mbp", fmi, *pack_reads(
            np, big + edge_reads(np, fmi.bnt.doubled(), rng)), opt)
    # megaq == the native seeder on every read of phase 5, both types
    gpu = megaq["chunk"][1]
    native = {}
    for dt, didx in (("int32", gpu), ("int64", int64_twin(torch, gpu))):
        n_rows = 0
        for batch in main["batches"]:
            arr, lens = pack_reads(np, [r.seq for r in batch])
            got = collect_intv_device(opt, didx, arr, lens, fmi,
                                      mode="megaq")
            want = smem_collect_batch_native(opt, fmi, arr, lens, threads=8)
            if not (np.array_equal(got[0], want[:, :5])
                    and np.array_equal(got[1], want[:, 5])):
                raise AssertionError(f"megaq ({dt}) != the native seeder")
            n_rows += len(want)
        native[dt] = {"reads": sum(len(b) for b in main["batches"]),
                      "rows": n_rows, "mismatches": 0}
    # the main path's K2 launch: 5c's first chunk
    opt_, didx, qd, ld = megaq["chunk"]
    stats12, stats3 = {}, {}
    rows12, rids12 = smem_fused.rounds12_megaq(opt_, didx, qd, ld,
                                               stats=stats12)
    hits, n_hits = smem._seed_strategy_scan(didx, qd, ld, opt_.min_seed_len,
                                            opt_.max_mem_intv, stats=stats3)
    torch.cuda.synchronize()
    alone = {"smem_rounds12": k2_alone(torch, opt_, didx, qd, ld),
             "seed_strategy": k3_alone(torch, opt_, didx, qd, ld),
             "seed_strategy int64": k3_alone(
                 torch, opt_, int64_twin(torch, didx), qd, ld)}
    best = interleaved_min({
        **alone,
        "smem_rounds12 wrapper": lambda: smem_fused.rounds12_megaq(
            opt_, didx, qd, ld),
        "seed_strategy wrapper": lambda: smem._seed_strategy_scan(
            didx, qd, ld, opt_.min_seed_len, opt_.max_mem_intv)},
        10, 4, torch.device(DEV))
    # what the timed launches left: K2's exact counts, steps and chain,
    # K3's hits
    *_, counts, steps, chain = alone["smem_rounds12"].buffers
    want_counts = torch.bincount(rids12, minlength=len(ld))
    if not (torch.equal(counts.long(), want_counts)
            and torch.equal(steps, stats12["steps"])
            and torch.equal(chain, stats12["chain"])):
        raise AssertionError("K2 alone != its wrapper's counts, steps and "
                             "chain")
    for name in ("seed_strategy", "seed_strategy int64"):
        _, got_hits, *got = alone[name].buffers
        if not (torch.equal(got_hits.long(), hits.long()) and all(
                torch.equal(a, b) for a, b in zip(got, (
                    n_hits, *(stats3[k] for k in ("steps", "chain",
                                                  "longest")))))):
            raise AssertionError(f"{name} alone != its wrapper's hits, "
                                 "counts, steps, chain and longest scan")
    # the plain versions step one interval at a time: timed on 256 of the
    # chunk's reads and the edge reads, not on the chunk
    plain256 = cases[f"{GENOME_MB} Mbp"]["int32"]["plain_ms"]
    out = {}
    for name, stats, n_out, kernel in (
            ("smem_rounds12", stats12, len(rows12), 0),
            ("seed_strategy", stats3, int(n_hits.sum()), 1)):
        steps = stats["steps"].cpu().numpy()
        nbytes, n_occ = seeding_bytes(torch, np, didx, qd, ld, opt_, kernel,
                                      n_out)
        case = {"reads": len(ld), "rows": n_out,
                "ms": round(best[name], 4),
                "wrapper_ms": round(best[f"{name} wrapper"], 4),
                "plain_ms": plain256[name],
                "plain_reads": cases[f"{GENOME_MB} Mbp"]["int32"]["reads"],
                "steps_mean": round(float(steps.mean()), 3),
                "steps_max": int(steps.max()),
                "occ_rows_read": n_occ, "bytes": nbytes,
                "max_abs_err": 0}
        # the rounds of dependent steps a read's warp (K2) or group of
        # lanes (K3) made: what the launch waits for
        chain = stats["chain"].cpu().numpy()
        case.update(chain_mean=round(float(chain.mean()), 3),
                    chain_max=int(chain.max()))
        if kernel:  # K3: the launch over its longest chain, a step
            case.update(
                longest_scan=int(stats["longest"].max()),
                us_per_step_longest_chain=round(
                    best[name] * 1e3 / max(int(chain.max()), 1), 4),
                int64_ms=round(best[f"{name} int64"], 4))
        case["bound_ms"] = round(bytes_bound(case)[0], 6)
        out[name] = case
    out["smem_rounds12"]["second_launch_reads"] = stats12[
        "second_launch_reads"]
    out["smem_rounds12"].update(k2_launch_facts(torch, didx, qd.shape[1]))
    out["seed_strategy"].update(k3_launch_facts(torch, len(ld)))
    print("[3h seeding] " + json.dumps({
        "tolerance": 0, "cases": cases, "native_seeder": native,
        "main_launch": out, "card": "the first chunk of 5c (16,384 reads)",
        "k2_refusals": k2_refusals(torch, didx, qd, ld, opt_),
        "sass_loads": seeding_sass(),
        "seconds": round(time.perf_counter() - t_phase, 1)}), flush=True)
    return out


def k2_launch_facts(torch, didx, L):
    """K2's launch at reads of L bases on this card: the warps a block,
    the blocks and warps an SM the occupancy query allows, the bytes of a
    warp's stacks, and each instantiation's registers from ptxas."""
    from tpubwa_torch.device import _build, smem_fused as sf
    lib = _build.load("smem", sf._SIGNATURES)
    rc, shape = sf.k2_shape(lib, didx.idt == torch.int64, L,
                            torch.cuda.current_device())
    if rc:
        raise AssertionError(f"K2 refuses reads of {L} bases")
    report = _build.build_info["smem"]["ptxas"]
    return {"launch": dict(shape, warps_per_sm=shape["warps"]
                           * shape["blocks_per_sm"]),
            "ptxas": {dt: ptxas_usage(report, rf"collect12_kernelI{m}E")
                      for dt, m in (("int32", "i"), ("int64", "l"))}}


def k3_launch_facts(torch, n):
    """K3's launch for ``n`` reads on this card: the lanes a read and
    groups a warp, the blocks and warps an SM the occupancy query allows
    and the grid's blocks and groups, each instantiation's registers and
    stack frame from ptxas, and the loads of its step's loop in SASS
    (``load_rounds``: the rounds its row loads, 8 bytes and wider, issue
    in).  The entry must refuse 2^31 - 1 reads, which its read queue's
    int32 counter cannot take (the shape query's error, as a launch
    returns it before it runs)."""
    from tpubwa_torch.device import _build, smem, smem_fused as sf
    lib = _build.load("smem", sf._SIGNATURES)
    launch = {}
    for dt in ("int32", "int64"):
        rc, shape = smem.k3_shape(lib, dt == "int64", n,
                                  torch.cuda.current_device())
        if rc:
            raise AssertionError(f"K3 refuses {n} reads ({dt})")
        launch[dt] = dict(shape, groups_per_warp=32 // shape["group"],
                          warps_per_sm=4 * shape["blocks_per_sm"])
        refused, _ = smem.k3_shape(lib, dt == "int64", (1 << 31) - 1,
                                   torch.cuda.current_device())
        if not refused:
            raise AssertionError(f"K3 takes 2^31 - 1 reads ({dt})")
        launch[dt]["refused_rc"] = refused
    report = _build.build_info["smem"]["ptxas"]
    text = _run([_cuobjdump(), "-sass", _build.build_info["smem"]["so"]])
    return {"launch": launch,
            "ptxas": {dt: ptxas_usage(report, rf"seed_strategy_kernelI{m}E",
                                      stack=True)
                      for dt, m in (("int32", "i"), ("int64", "l"))},
            "step": load_rounds(text, r"seed_strategy_kernelIiE",
                                min_width=64)}


def seeding_sass():
    """The global loads of K2 and K3 (int32) in their SASS (sass_loads):
    how wide, and whether a loop's loads wait for one another."""
    from tpubwa_torch.device import _build
    text = _run([_cuobjdump(), "-sass", _build.build_info["smem"]["so"]])
    return {name: sass_loads(text, rf"{fn}IiE")
            for name, fn in (("smem_rounds12", "collect12_kernel"),
                             ("seed_strategy", "seed_strategy_kernel"))}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch sees no CUDA device\n")
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import tpubwa_torch  # noqa: F401  (fails outside a checkout)
    phase_toolchain(torch)
    phase_build()
    main_case, max_err = phase_kernel(torch, np)
    case16, err16, launches16 = phase_kernel16(torch, np)
    case_real, err_real, launches_real = phase_kernel_real(torch, np)
    case_floor, err_floor, launches_floor = phase_kernel_floor(torch, np)
    phase_sanitizer()
    case_bd, err_bd, launches_bd = phase_kernel_bd(torch, np)
    phase_golden(torch)
    main_path = phase_main_path(torch, np)
    launches = main_path["launches"]
    stock, sa_case, sa_launches, _ = phase_stock_bwa(torch, np, main_path)
    ext_case, ext_launches, sa_err = phase_occ(torch, np, main_path["fmi"],
                                               stock)
    sa_case["max_abs_err"] = max(sa_case["max_abs_err"], sa_err)
    megaq = phase_megaq(torch, np, main_path)
    seeding = phase_seeding(torch, np, main_path, megaq)
    phase_megaq_stock(torch, np, main_path, stock)
    hybrid = phase_hybrid(torch, np, main_path, megaq)
    bad = sorted(k for k in sys.modules if k in ("jax", "tpubwa")
                 or k.startswith(("jax.", "tpubwa.")))
    if bad:
        raise AssertionError(f"imported {bad[:5]}")
    from tpubwa_torch.device import _build
    rates = card_rates(torch)
    kernels, sass, disasm = [], {}, {}
    results = {"ksw_extend": (launches, max_err, main_case),
               "ksw_extend16": (launches16, err16, case16),
               "extend_real": (launches_real, err_real, case_real),
               "ksw_extend_floor": (launches_floor, err_floor, case_floor),
               "ksw_extend_bd": (launches_bd, err_bd, case_bd)}
    for name, src, replaces, function, ops in KERNEL_ROWS:
        n, err, case = results[name]
        if src not in disasm:
            disasm[src] = _run([_cuobjdump(), "-sass",
                                _build.build_info[src]["so"]])
        loop = dict(cell_ops(case, ops),
                    ops_from={k: f"RECURRENCE_OPS[{r!r}]"
                              for k, r in ops.items()},
                    strip_loop=sass_strip_loop(disasm[src], function),
                    **ptxas_usage(_build.build_info[src]["ptxas"],
                                  function))
        bound_ms, bound_by, parts = bound(case, loop, rates)
        sass[name] = dict(loop, bytes=case["bytes"],
                          **{k: case[k] for k in ("cells", *ops)},
                          **{k: round(v, 6) for k, v in parts.items()})
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tpubwa_torch/csrc/{src}.cu", "replaces": replaces,
            "launches": n, "max_abs_err": err, "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": round(bound_ms, 6),
            "bound_by": bound_by, "library_ms": None})
    # the FM-index rows: bound by bytes alone (the distinct sectors of
    # the index their run reads, from the plain version's reads)
    for name, replaces, n, case in (
            ("sa_lookup", "tpubwa/device/occ.py:303", sa_launches, sa_case),
            ("bwt_extend", "tpubwa/device/occ.py:202", ext_launches,
             ext_case)):
        bound_ms, bound_by, parts = bytes_bound(case)
        sass[name] = dict(bytes=case["bytes"], n=case["n"],
                          **{k: round(v, 6) for k, v in parts.items()})
        kernels.append({
            "name": name, "route": "cuda", "source": "tpubwa_torch/csrc/occ.cu",
            "replaces": replaces, "launches": n,
            "max_abs_err": case["max_abs_err"],
            "ms": case["ms"], "plain_ms": case["plain_ms"],
            "bound_ms": round(bound_ms, 6), "bound_by": bound_by,
            "library_ms": None})
    # the seeding rows: bound by bytes alone, the distinct sectors of the
    # index the main path's first K2 and K3 launches read (csrc/smem_host)
    for name, replaces in (
            ("smem_rounds12", "tpubwa/device/smem_fused.py:872"),
            ("seed_strategy", "tpubwa/device/smem.py:199")):
        case = seeding[name]
        bound_ms, bound_by, parts = bytes_bound(case)
        sass[name] = dict(bytes=case["bytes"], reads=case["reads"],
                          **{k: round(v, 6) for k, v in parts.items()})
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tpubwa_torch/csrc/smem.cu", "replaces": replaces,
            "launches": megaq["launches"][name] + hybrid["launches"][name],
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": round(bound_ms, 6),
            "bound_by": bound_by, "library_ms": None})
    print("[bounds] " + json.dumps({"card": rates, "hbm_bytes_s":
                                    HBM_BYTES_S, "kernels": sass}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
