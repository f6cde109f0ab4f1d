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
 3i. K1-mat (extend.cu's kMat instantiation: the score from a 5 x 5
     table) == extend_batch_plain(mat=), exactly, each launch
     synchronised, on phase 3's twelve job sets under three matrices
     (the entry step's, transition/transversion, a positive entry off
     the diagonal), and == K1's kernel at bwa_fill_scmat's matrix; at
     phase 3's main shape K1-mat alone (tt and scmat) beside K1 alone in
     interleaved passes, with its plain version's band cells;
  4. `mem --device cuda` on tests/golden: SE and PE SAM byte-equal to
     the snapshots (tpubwa's own output), @PG stripped;
 4b. `mem --device cuda --shard i/3` on the golden SE reads, the three
     shards merged by `merge`: the body equals phase 4's SE SAM byte for
     byte; PE with `-I 350,30 --shard i/2` likewise against an unsharded
     PE run with the same -I;
 4c. two `python -m tpubwa_torch mem --dist --device cuda` processes
     (torch.distributed over gloo on 127.0.0.1 and a free port, RANK 0
     and 1 of WORLD_SIZE 2, both on the one card), each with a timeout,
     on the golden SE reads and on the PE reads with `-I 350,30`: rank
     0's merged body equals phase 4's SE SAM, and the unsharded PE run
     with the same -I, byte for byte; both shards are non-empty and rank
     0's `dist_done` metric counts every read;
 4d. tpubwa_torch.dist.dryrun.dryrun_multidevice over [cuda:0, cuda:0]
     at its 1.5 Mbp, 1,024-pair default: the aligner over two replicas
     on the card (megaq) SAM-equal to the card alone (host seeding); and
     its tp leg, the first 128 pairs through an aligner over the index
     in two slabs on the card (K2's and K-sa's TP instantiations
     launched), SAM-equal to the card alone;
  6. tpubwa_torch.entry's step on the card (K-reach over every position
     of 64 reads on a 4 kb genome, K-sa on its anchors, K1-mat under the
     step's matrix), the three counts at 0 just before it: e, pos and
     score == the same step on the CPU (the plain versions), each kernel
     launched;
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
     runs; the TP instantiations of K-sa (the marked walk) and K-ext
     over 2 and 3 slabs on the card (dist/index_tp.py:TpIndex), int32
     and int64, == their plain versions over the slabs' routed
     accessors and == the flat kernels, on both genomes' same inputs,
     the 64 Mbp int32 ones timed alone beside the flat ones in the same
     interleaved passes, their bounds from the distinct sectors of the
     slabs' own rows; then the extension path driven once with the
     counts at 0, flat and over 2 slabs;
 5c. phase 5's 2 x 8,192 pairs through the port's aligner on cuda with
     TPUBWA_SEED_MODE=megaq (as `mem` runs it): every seeding row from
     K2 and K3 (csrc/smem.cu), and every SA position from K-sa's marked
     walk on ranks built on the card inside the seeding stage (K-sa
     once a chunk), with the counts at 0 just before the run.  Its SAM
     must equal phase 5's byte for byte, and the first chunk's fused
     (cnt, pos) the native walk's on the same rows; K-sa alone on those
     ranks in interleaved passes, beside its plain version and its
     bound, and the rank build's wall.  Reads/s and the seeding stage's
     wall beside phase 5's, the reads that took K2's second launch, and
     each mode's device busy share over a profiled pass of the first
     batch;
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
     wrapper; and the global loads of K2's and K3's SASS.  K2's TP
     instantiation over 2 and 3 slabs == plain on the 3 kb and 256-read
     sets (one row slot a read too), its plain version over the slabs'
     accessors == over the flat index, and on 5c's first chunk its rows,
     counts, steps and chain == K2 flat's; K2's and K-sa's TP
     instantiations alone beside the flat ones (K-sa on 5c's fused
     ranks, == the flat walk's positions and the plain walk over the
     slabs) in the same interleaved passes, with their bounds; each TP
     instantiation's registers and the rounds of its row loads in SASS
     beside the flat one's;
 3j. (after 3h) K-reach == rightmost_reach_plain over every start 0-99 of
     every read of 5c's first chunk on the 64 Mbp index (1,638,400 jobs),
     int32, and int64 on the first 65,536; K-reach alone warm
     (interleaved passes) and cold, beside its plain version and its
     bound, with the steps a job and the longest walk;
 3k. (after 3j) K-cur (csrc/smem.cu's smem_jobs_kernel, seed mode
     cursor's bwt_smem1a a warp a job) == run_smem_jobs_plain in every
     instantiation, on round-1 jobs and the round-2 jobs of their rows,
     at 64 row slots a job and at one, on the 3,000-base genome and on
     262 reads of 5c's first chunk; on that chunk mode cursor's rounds
     1+2 merged == K2's, K-cur's round-1 and round-2 launches alone
     beside K2 alone in interleaved passes, with steps and chain a job,
     each launch's bound from the distinct sectors it reads
     (csrc/smem_host.cpp), its launch shape and registers, and K2's and
     K3's SASS digests;
 5k. (after 3k) phase 5's 2 x 8,192 pairs with TPUBWA_SEED_MODE=reach,
     then =cursor, the counts at 0 just before each: reach seeds rounds
     1 and 2 on K-reach (two launches a chunk), cursor on K-cur (two or
     more), both round 3 on K3, no K2 and no fused SA walk.  Each SAM
     must equal phase 5's byte for byte.  Reads/s and the seeding
     stage's wall beside phase 5's and 5c's, the launches, and mode
     reach's two K-reach launches on 5c's first chunk (round 1, every
     (read, column); round 2, every start 0..x of every job), each ==
     rightmost_reach_plain on the same inputs, alone in interleaved
     passes, with its trips a job and its bound from the distinct occ
     rows it reads (the round-1 launch is K-reach's row below);
 5d. phase 5's 2 x 8,192 pairs in megaq on 5b's stock-bwa index: K2 and
     K3 seed every read and K-sa walks every SA position (fused into
     seeding, once a chunk) in one run, with the counts at 0 just
     before it.  Its SAM must equal phase 5's byte for byte, and K2, K3
     and K-sa must each launch.
 5g. 5d through the aligner over a DataParallel([cuda:0, cuda:0]): two
     replicas of the index on the card, each chunk's reads (K2, K3, and
     K-sa on each replica's own rows, once a chunk) and extension jobs
     (K1) split between them, each
     replica on a worker thread and a stream of its own; again over
     every card where torch sees more than one.  Its SAM must equal
     phase 5's byte for byte, and K2, K3, K-sa and K1 must each launch
     on both replicas (the replicas' tallies and the locked counts, at
     0 just before the run).  Each replica's reads, ranks and jobs, and
     reads/s beside phase 5's and 5d's.
 5e. phase 5's 2 x 8,192 pairs with TPUBWA_SEED_MODE=hybrid (tpubwa's
     defaults: share 0.25 at first, the balancer on, floor 64): each
     chunk's first k reads on K2 and K3 (their SA on the marked K-sa,
     once a chunk) beside the native seeder and walk on the rest, in two
     passes (16,384-read chunks, then 4,096), each with a new balancer
     and the counts at 0 just before it.  Each pass's SAM must equal
     phase 5's byte for byte, K2, K3 and K-sa must launch, and every
     chunk of at least k_floor / f reads must be split (0 < k < B); each
     chunk's (B, k, t_dev, t_host, f) and each pass's reads/s and seeding
     stage beside phase 5's and 5c's.
 5h. 5e through the aligner over a DataParallel([cuda:0, cuda:0]) with
     TPUBWA_SEED_MODE=hybrid: each chunk's device share split between
     the two replicas (K2, K3 and the marked K-sa on each), the chunk on
     both for K1, one balancer for the aligner; both passes, each with
     a new balancer and the counts and tallies at 0 just before it.
     Each pass's SAM must equal phase 5's byte for byte, K2, K3 and
     K-sa must launch on both replicas, and every chunk of at least
     k_floor / f reads must be split; each replica's tallies, each
     chunk's (B, k, t_dev, t_host, f) and reads/s beside 5e's.
 5i. phase 5's 2 x 8,192 pairs in megaq through the aligner over
     TpIndex(fmi, [cuda:0, cuda:0]) (the occ, mark and sa_marked rows
     in two slabs on the card; K2 and the fused K-sa read each row from
     the slab that holds it, K3, the extension and pac the whole index),
     then over 3 slabs, and over one slab a card where torch sees more
     than one (peer access; a failure there fails the phase).  Each
     pass's SAM must equal phase 5's byte for byte; K2's and K-sa's TP
     instantiations must launch (K-sa once a chunk) and the flat K2 and
     K-sa must not, with the counts at 0 just before the run; each slab
     holds padded total / n rows.  The seeding stage's wall and reads/s
     beside 5c's.
 5f. the first 1,024 pairs of phase 5's first batch, one batch, three
     ways: native (the reference), TPUBWA_NO_NATIVE_PLAN=1 (the Python
     planner, its extension waves through dispatch.WaveExtender) and
     TPUBWA_NO_NATIVE=1 (megaq seeding, the marked SA walk on the card,
     chaining, planning and emit in Python), a new aligner and the
     native caches reset for each.  Both no-native SAMs must equal the
     native run's byte for byte; K1 must launch on both, and K2, K3 and
     the marked K-sa on the TPUBWA_NO_NATIVE run, with the counts at 0
     just before each run.  Each run's launches, waves, jobs,
     scalar-loop jobs, reads/s and wall beside the card's name and
     power limit.
 5j. the first 2,048 reads of phase 5: (a) chained by the host stages,
     then WaveExtender.run (plain waves) over extension_plan() generators
     (per-side waves of 512-job blocks) under bwa_fill_scmat's matrix (K1)
     and a transition/transversion one (K1-mat), each run's regions ==
     host/regions.py:chain2aln's; (b) process_batches with the aligner on
     cuda under that matrix (the non-descriptor route, K1-mat), SAM ==
     the same run with extension through the scalar trial loops
     (tpubwa's route for such a matrix); K1 or K1-mat launched where
     expected, with the counts at 0 just before each run; waves, jobs,
     scalar-loop jobs and reads/s beside the card's name and power
     limit.
Then the bounds (each kernel's least time on this card: the band cells
its plain version counted on the timed inputs, times the integer
instructions per cell, over the card's integer rate; or its bytes over
HBM bandwidth, whichever is larger.  The instructions per cell are
constants of the recurrence, RECURRENCE_OPS, so the bound does not move
with the kernel's design.  The FM-index kernels are bound by bytes
alone: the distinct 32-byte sectors of the index that the plain
version's reads touch, with their inputs and outputs), the smoke's
wall and each phase's, a JSON line of the kernels (launches on each kernel's paths: K1
in phase 5, 5f, 5g, 5h, 5j and 5k, K1-mat in 6 and 5j, K-reach in 6 and
5k, K-cur in 5k, K-sa in 5b, 5c, 5d, 5e, 5f, 5g, 5h and 6, K2 in 5c, 5d,
5e, 5f, 5g and 5h, K3 there and in 5k,
K2's and K-sa's TP instantiations in 5i and 4d's tp leg, K-ext's on 3g's
extension path over slabs, the int16 kernel in the
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
     {"live_cells": "ksw_extend_bd", "frozen_cells": "ksw_extend_bd_frozen"}),
    ("ksw_extend_mat", "extend", "tpubwa/device/extend.py:33",
     r"extend_kernelILi2048EE", {"cells": "ksw_extend"}))


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
    with ThreadPoolExecutor(len(kernels) + 1) as ex:
        futures = [ex.submit(_build.load, name, sigs)
                   for name, sigs in kernels.items()]
        # K-fwd's g32 form (a warp a job, the first design's layout),
        # which 3l times beside the shipped one
        g32 = ex.submit(split_form, "g32")
        for f in futures:
            f.result()
        g32.result()
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


SPLIT_BUILT = {}        # K-fwd's forms built this run


def split_form(form):
    """(the ctypes handle, its sources' directory) of csrc/smem.cu built
    in K-fwd's form ``form`` (``warp_host.SPLIT_FORMS``) under
    build/split_forms, once a run."""
    from tpubwa_torch.device import _build, smem_fused, warp_host
    if form not in SPLIT_BUILT:
        out = _build.BUILD.parent / "split_forms" / form
        lib, _ = _build.build_edited("smem", warp_host.SPLIT_FORMS[form], out,
                                     smem_fused._SIGNATURES)
        SPLIT_BUILT[form] = (lib, out)
    return SPLIT_BUILT[form]


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


def phase_shard(torch):
    """[4b shard]: `mem --device cuda --shard i/3` on the golden SE reads
    for i = 0, 1, 2, merged by `merge`: the body must equal the golden
    SE SAM's (phase 4's unsharded run) byte for byte; PE with `-I
    350,30 --shard i/2`, merged, must equal an unsharded PE run with the
    same -I.  The FASTQs are copied next to the index first, so that the
    record sidecars (<fastq>.tpubwa.fai) land in build/."""
    import tempfile
    from tpubwa_torch.cli import main as cli_main
    from tpubwa_torch.device import extend_kernel as ek
    gold = os.path.join(ROOT, "tests", "golden")
    t0 = time.perf_counter()
    res = {}
    ek.extend_batch.launches = 0
    with tempfile.TemporaryDirectory(dir=BUILD) as d:
        prefix = os.path.join(d, "g")
        assert cli_main(["index", os.path.join(gold, "ref.fa"), "-p",
                         prefix]) == 0
        for name in ("se.fq", "pe1.fq", "pe2.fq"):
            shutil.copy(os.path.join(gold, name), d)

        def body(path):
            with open(path) as fh:
                return "".join(l for l in fh if not l.startswith("@"))

        def mem(out, fqs, *extra):
            assert cli_main(["mem", "--device", DEV, *extra, prefix,
                             *(os.path.join(d, f) for f in fqs), "-o",
                             os.path.join(d, out)]) == 0
            return os.path.join(d, out)

        with open(os.path.join(gold, "se.sam")) as fh:
            want = {"se": "".join(l for l in fh if not l.startswith("@"))}
        want["pe"] = body(mem("pe_full.sam", ["pe1.fq", "pe2.fq"],
                              "-I", "350,30"))
        for kind, fqs, n, extra in (
                ("se", ["se.fq"], 3, ()),
                ("pe", ["pe1.fq", "pe2.fq"], 2, ("-I", "350,30"))):
            shards = [mem(f"{kind}{i}.sam", fqs, *extra, "--shard",
                          f"{i}/{n}") for i in range(n)]
            merged = os.path.join(d, f"{kind}_merged.sam")
            assert cli_main(["merge", "-o", merged, *shards]) == 0
            got = body(merged)
            if got != want[kind]:
                raise AssertionError(f"4b: merged {kind} shards != the "
                                     "unsharded run")
            res[kind] = {"shards": n, "sam_lines": len(got.splitlines()),
                         "byte_equal": True}
    launches = ek.extend_batch.launches
    if launches <= 0:
        raise AssertionError("4b never launched the extension kernel")
    res.update(ksw_extend_launches=launches,
               seconds=round(time.perf_counter() - t0, 3))
    print("[4b shard] " + json.dumps(res), flush=True)


DIST_TIMEOUT = 300       # s a `mem --dist` process may take in 4c


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_dist(torch):
    """[4c dist]: two `python -m tpubwa_torch mem --dist --device cuda`
    processes (RANK 0 and 1, WORLD_SIZE 2, gloo on 127.0.0.1 and a free
    port, both on the one card) on the golden SE reads, and on the PE
    reads with `-I 350,30`: rank 0 merges the two shards into -o.  The
    SE body must equal the golden SE SAM's (phase 4's) byte for byte; the
    PE body an unsharded PE run's with the same -I (without -I the
    insert-size statistics are a batch's, as in stock bwa, and a shard is
    a batch of its own; 4b likewise).  Both shards must be non-empty, and
    rank 0's `dist_done` metric must count every read.  A process past
    DIST_TIMEOUT is killed and fails the phase."""
    import tempfile
    from tpubwa_torch.cli import main as cli_main
    gold = os.path.join(ROOT, "tests", "golden")
    t0 = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory(dir=BUILD) as d:
        prefix = os.path.join(d, "g")
        assert cli_main(["index", os.path.join(gold, "ref.fa"), "-p",
                         prefix]) == 0
        for name in ("se.fq", "pe1.fq", "pe2.fq"):
            shutil.copy(os.path.join(gold, name), d)

        def body(path):
            with open(path) as fh:
                return "".join(l for l in fh if not l.startswith("@"))

        with open(os.path.join(gold, "se.sam")) as fh:
            want = {"se": "".join(l for l in fh if not l.startswith("@"))}
        pe = [os.path.join(d, f) for f in ("pe1.fq", "pe2.fq")]
        assert cli_main(["mem", "--device", DEV, "-I", "350,30", prefix,
                         *pe, "-o", os.path.join(d, "pe_full.sam")]) == 0
        want["pe"] = body(os.path.join(d, "pe_full.sam"))
        for kind, fqs, extra in (("se", ["se.fq"], []),
                                 ("pe", ["pe1.fq", "pe2.fq"],
                                  ["-I", "350,30"])):
            out = os.path.join(d, f"{kind}.sam")
            metrics = os.path.join(d, f"{kind}.jsonl")
            port = free_port()
            t = time.perf_counter()
            procs = []
            for rank in range(2):
                env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                           WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=str(port))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "tpubwa_torch", "mem", "--dist",
                     "--device", DEV, *extra,
                     *(["--metrics", metrics] if rank == 0 else []),
                     "-o", out, prefix,
                     *(os.path.join(d, f) for f in fqs)],
                    cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                    stderr=subprocess.PIPE, text=True))
            errs = []
            try:
                for p in procs:
                    errs.append(p.communicate(timeout=DIST_TIMEOUT)[1])
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            if any(p.returncode for p in procs):
                raise AssertionError(f"4c {kind}: exit codes "
                                     f"{[p.returncode for p in procs]}: "
                                     f"{[e[-1500:] for e in errs]}")
            wall = time.perf_counter() - t
            got = body(out)
            if got != want[kind]:
                raise AssertionError(f"4c: merged {kind} != the "
                                     "unsharded run")
            shards = [len(body(f"{out}.shard{i:05d}").splitlines())
                      for i in range(2)]
            if not all(shards):
                raise AssertionError(f"4c {kind}: an empty shard {shards}")
            with open(metrics) as fh:
                done = [json.loads(l) for l in fh
                        if json.loads(l)["event"] == "dist_done"]
            n_reads = sum(sum(1 for _ in open(os.path.join(d, f))) // 4
                          for f in fqs)
            if len(done) != 1 or done[0]["reads"] != n_reads:
                raise AssertionError(f"4c {kind}: dist_done {done}")
            res[kind] = {"processes": 2, "sam_lines": len(got.splitlines()),
                         "shard_lines": shards, "byte_equal": True,
                         "dist_done": {k: done[0][k] for k in (
                             "processes", "reads", "reads_per_s",
                             "per_host")},
                         "wall_s": round(wall, 3)}
    res["seconds"] = round(time.perf_counter() - t0, 3)
    print("[4c dist] " + json.dumps(res), flush=True)


def phase_dryrun(torch):
    """[4d dryrun]: ``dist.dryrun.dryrun_multidevice`` over [cuda:0,
    cuda:0] at its default 1.5 Mbp, 1,024 pairs: a realistic genome's
    PE reads through the aligner over the two replicas (megaq) and on
    the card alone (host seeding), SAM-equal; then its tp leg, the first
    128 pairs through an aligner over ``TpIndex(fmi, [cuda:0, cuda:0])``
    (K2's and K-sa's TP instantiations), SAM-equal to the card alone.
    Returns the leg's TP launches (counted from 0 over the dryrun)."""
    from tpubwa_torch.dist.dryrun import dryrun_multidevice
    t0 = time.perf_counter()
    tp_counts(reset=True)
    facts = dryrun_multidevice(["cuda:0", "cuda:0"])
    launches = tp_counts()
    if "tp" not in facts or not launches["smem_rounds12_tp"] \
            or not launches["sa_lookup_tp"]:
        raise AssertionError(f"4d's tp leg launched {launches}")
    print("[4d dryrun] " + json.dumps(dict(
        facts, launches=launches,
        seconds=round(time.perf_counter() - t0, 3))), flush=True)
    return launches


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

    def wave(*a, **kw):
        return desc_np(*a, extend=keep, **kw)

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


def kext_alone(torch, didx, ik, is_back, lib=None):
    """K-ext's C entry alone on preallocated buffers (``.buffers``: ik,
    out), a launch not counted on the wrapper; ``lib`` as in
    ``ksa_alone``."""
    from tpubwa_torch.device import _build, occ
    lib = lib or _build.load("occ", occ._SIGNATURES)
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
                report, rf"sa_lookup_kernelI{m}Lb{b}ELb0EE")
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


def load_rounds(text, function, min_width=128, loop=True):
    """The row loads of one step of a walk in ``cuobjdump -sass`` output:
    of the one function whose mangled name matches the regex
    ``function``, the innermost loop that holds the most 128-bit global
    loads, its loads by width, and the rounds its 128-bit loads
    (``rounds_128``) and its loads of at least ``min_width`` bits
    (``rounds``) issue in.  A round ends where an instruction reads a
    register that a load of the round wrote, so one round means that
    every row of the step is requested before any is used: a step is one
    trip to memory.  ``loop`` False counts the whole function (a kernel
    with no loop, one query a thread)."""
    name, ins, loops = sass_function(text, function)
    inner = [lp for lp in loops
             if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1]
                        for o in loops)]
    if not loop:
        inner = [(ins[0][0], ins[-1][0], None)]

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
            for walk, fn in (("sampled", r"sa_lookup_kernelIiLb0ELb0EE"),
                             ("marked", r"sa_lookup_kernelIiLb1ELb0EE"))}


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


TP_SLABS = (2, 3)       # the TP checks' slabs, all on DEV (the one card)


def slab_reads(tp, name, index, elem_bytes):
    """``fm_bytes``'s reads of ``tp``'s array ``name`` at ``index`` (rows
    of the whole array, any order), one entry a slab with its rows
    counted from the slab's start: each slab is its own allocation, so
    the sectors are the slabs' own."""
    import numpy as np
    index = np.asarray(index, np.int64)
    per = tp.slab_rows[name]
    return [(index[index // per == s] - s * per, elem_bytes)
            for s in range(tp.n)]


def tp_walk_bytes(tp, n, stats):
    """The bytes K-sa's TP walk of ``n`` ranks must move: the ranks and
    positions, and the distinct sectors of the slabs its steps read
    (``stats``: the plain walk's reads, which are the kernel's)."""
    isz = tp.idt.itemsize
    got = {k: stats[k].cpu().numpy() for k in ("occ_rows", "mark_rows",
                                               "samples")}
    return fm_bytes(2 * isz * n, slab_reads(
        tp, "occ_blocks", got["occ_rows"], OCC_ROW) + slab_reads(
        tp, "mark_rows", got["mark_rows"], MARK_ROW) + slab_reads(
        tp, "sa_marked", got["samples"], isz))


def tp_extend_bytes(tp, n, stats):
    """The bytes K-ext's TP instantiation must move on ``n`` intervals:
    ik in, [4, 3] out, and the distinct sectors of the occ slabs its two
    occ4 queries read (``stats``: the plain version's)."""
    return fm_bytes(15 * tp.idt.itemsize * n, slab_reads(
        tp, "occ_blocks", stats["occ_rows"].cpu().numpy(), OCC_ROW))


def ksa_tp_alone(torch, tp, ranks):
    """K-sa's TP entry (the marked walk over ``tp``'s slabs) alone on
    preallocated buffers (``.buffers``: ranks, out, queue), a launch not
    counted on the wrapper."""
    from tpubwa_torch.device import _build, occ
    lib = _build.load("occ", occ._SIGNATURES)
    out = torch.empty_like(ranks)
    queue = torch.empty(1, dtype=torch.int32, device=ranks.device)
    tables = [tp.kernel_table(k) for k in ("occ_blocks", "mark_rows",
                                           "sa_marked")]
    args = (tp.n, *tables, tp.L2.data_ptr(), tp.primary, tp.seq_len,
            tp.mark_D, int(tp.idt == torch.int64), ranks.data_ptr(),
            out.data_ptr(), len(ranks), queue.data_ptr(), None, 0,
            ranks.device.index,
            torch.cuda.current_stream(ranks.device).cuda_stream)

    def launch():
        if lib.tpubwa_sa_lookup_tp(*args):
            raise AssertionError("K-sa (tp)'s launch failed")
    launch.buffers = (ranks, out, queue)
    launch.index = tp
    return launch


def kext_tp_alone(torch, tp, ik, is_back):
    """K-ext's TP entry alone on preallocated buffers (``.buffers``: ik,
    out), a launch not counted on the wrapper."""
    from tpubwa_torch.device import _build, occ
    lib = _build.load("occ", occ._SIGNATURES)
    out = torch.empty((len(ik), 4, 3), dtype=ik.dtype, device=ik.device)
    table = tp.kernel_table("occ_blocks")
    args = (tp.n, table, tp.L2.data_ptr(), tp.primary, tp.seq_len,
            int(tp.idt == torch.int64), int(bool(is_back)), ik.data_ptr(),
            out.data_ptr(), len(ik), ik.device.index,
            torch.cuda.current_stream(ik.device).cuda_stream)

    def launch():
        if lib.tpubwa_bwt_extend_tp(*args):
            raise AssertionError("K-ext (tp)'s launch failed")
    launch.buffers = (ik, out)
    launch.index = tp
    return launch


def fm_tp_checks(torch, np, cases):
    """The TP instantiations of K-sa (the marked walk) and K-ext over
    ``TP_SLABS`` slabs of each marked index of ``cases`` (fm_checks', both
    rank types) on DEV: on the same ranks and intervals, each == its
    plain version over the slabs' routed accessors and == the flat
    kernel's output, exactly.  Returns ({case: facts}, {case: its launch
    alone}) with the 64 Mbp int32 cases' launches."""
    from tpubwa_torch.device import occ
    from tpubwa_torch.dist.index_tp import TpIndex
    out, alone, slabbed = {}, {}, {}
    for key, c in cases.items():
        label, marks, dt, what = key.split("/")
        if marks != "marked":
            continue
        for n in TP_SLABS:
            if (label, dt, n) not in slabbed:
                slabbed[label, dt, n] = TpIndex.from_index(c["didx"],
                                                           [DEV] * n)
            tp = slabbed[label, dt, n]
            tag = f"{label}/{dt}/{n} slabs/{what}"
            stats = {}
            if "ranks" in c:
                got = occ.sa_lookup(tp, c["ranks"])
                torch.cuda.synchronize()
                want, plain_ms = timed_once(torch, lambda: occ.sa_lookup_plain(
                    tp, c["ranks"], stats=stats))
                nbytes = tp_walk_bytes(tp, len(c["ranks"]), stats)
            else:
                got = occ.bwt_extend(tp, c["ik"], c["is_back"])
                torch.cuda.synchronize()
                want, plain_ms = timed_once(
                    torch, lambda: occ.bwt_extend_plain(
                        tp, c["ik"], c["is_back"], stats=stats))
                nbytes = tp_extend_bytes(tp, len(c["ik"]), stats)
            bad, err = held_fm(torch, f"{tag} (tp)", got, want)
            held_fm(torch, f"{tag} (tp) vs flat", got, c["got"])
            out[tag] = {"n": c["n"], "slabs": n, "mismatches": bad,
                        "max_abs_err": err, "ms": None,
                        "plain_ms": round(plain_ms, 3), "bytes": nbytes,
                        "slab_rows": tp.slab_rows, "got": got}
            if label == f"{GENOME_MB} Mbp" and dt == "int32":
                alone[tag] = (ksa_tp_alone(torch, tp, c["ranks"])
                              if "ranks" in c else kext_tp_alone(
                                  torch, tp, c["ik"], c["is_back"]))
    return out, alone


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
    one, the TP instantiations over 2 and 3 slabs (``fm_tp_checks``),
    each kernel timed in interleaved passes; then the extension path
    (set_intv, a backward and a forward step) driven once with the
    counts at 0, on the flat index and over 2 slabs.  Returns (the
    bwt_extend row's case, its launches, the largest K-sa difference
    from plain, (the bwt_extend_tp row's case, its launches))."""
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
    # the TP instantiations over 2 and 3 slabs of each marked index
    tp_cases, tp_alone = fm_tp_checks(torch, np, cases)
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
    fns.update(tp_alone)
    best = interleaved_min(fns, 20, 4, torch.device(DEV))
    for key, ms in best.items():
        if key in tp_alone:
            c = tp_cases[key]
            c["ms"] = round(ms, 4)
            if not torch.equal(tp_alone[key].buffers[1], c["got"]):
                raise AssertionError(f"{key}: alone != its wrapper")
            continue
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
    # the same path over the index in 2 slabs: K-ext's TP instantiation
    from tpubwa_torch.dist.index_tp import TpIndex
    tp = TpIndex.from_index(didx, [DEV, DEV])
    occ.bwt_extend.launches = occ.bwt_extend.tp_launches = 0
    ik = occ.set_intv(tp, pick[0])
    for is_back, c in ((True, pick[1]), (False, pick[2])):
        ik = occ.bwt_extend(tp, ik, is_back)[
            torch.arange(len(c), device=DEV), c].contiguous()
    torch.cuda.synchronize()
    ext_tp_launches = occ.bwt_extend.tp_launches
    if ext_tp_launches != 2 or occ.bwt_extend.launches:
        raise AssertionError(f"the extension path over slabs launched "
                             f"{ext_tp_launches} TP extensions")
    shown = {k: {f: v for f, v in c.items()
                 if f not in ("didx", "ranks", "got", "ik", "is_back")}
             for k, c in {**cases, **tp_cases}.items()}
    print("[3g occ] " + json.dumps({
        "tolerance": 0, "cases": shown,
        "native_walk": {"ranks": len(ranks), "mismatches": native_mismatches},
        "sa_lookup_refusal": {dt: ksa_refusal(torch, x) for dt, x in (
            ("int32", didx), ("int64", int64_twin(torch, didx)))},
        "extension_path_launches": ext_launches,
        "tp_extension_path_launches": ext_tp_launches}), flush=True)
    row = cases[f"{GENOME_MB} Mbp/marked/int32/bwt_extend_fwd"]
    err = {name: max(c["max_abs_err"] for k, c in cases.items()
                     if name in k) for name in ("sa_lookup", "bwt_extend")}
    tp_row = tp_cases[f"{GENOME_MB} Mbp/int32/2 slabs/bwt_extend_fwd"]
    tp_err = max(c["max_abs_err"] for k, c in tp_cases.items()
                 if "bwt_extend" in k)
    return dict(row, max_abs_err=err["bwt_extend"]), ext_launches, \
        err["sa_lookup"], (dict(tp_row, max_abs_err=tp_err), ext_tp_launches)


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
    the ``with``; ``first`` keeps the first call's output (rows, read
    ids, reads and, in megaq and hybrid, the fused SA segments)."""

    def __init__(self, torch):
        self.torch, self.s, self.calls, self.first = torch, 0.0, 0, None

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
            if self.first is None:
                self.first = out
            return out

        dp.collect_intv_device = timed
        return self

    def __exit__(self, *exc):
        self.dp.collect_intv_device = self.real


def seed_aligner(opt, fmi, mode, dp=None):
    """The port's aligner on the card (over ``dp``'s replicas where one
    is given) as `mem` makes it with TPUBWA_SEED_MODE=``mode`` (the mode
    is read when it is made)."""
    from tpubwa_torch.device.pipeline import make_device_aligner
    old = os.environ.get("TPUBWA_SEED_MODE")
    os.environ["TPUBWA_SEED_MODE"] = mode
    try:
        aligner = make_device_aligner(opt, fmi, device=DEV, dp=dp)
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
    K3 (csrc/smem.cu), and every SA position from K-sa's marked walk on
    ranks built on the card, fused into the seeding stage.  Its SAM must
    equal phase 5's byte for byte; K2, K3 and the marked K-sa must
    launch, K-sa once a chunk, with the counts at 0 just before the run;
    the first chunk's fused (cnt, pos) must equal the native walk's
    (``_sa_positions``) on the same rows.  Then K-sa on those ranks:
    alone in interleaved passes, its plain version, its bound, and the
    rank build's wall.  Reads/s and the seeding stage's wall beside phase
    5's, the reads that took K2's second launch, and each mode's device
    busy share over a profiled pass of the first batch.  Returns the
    facts, with the first chunk's K2 inputs (``chunk``: opt, didx, qd,
    ld) and K-sa alone on its ranks with the plain walk's reads
    (``walk``) for phase 3h."""
    from tpubwa_torch.device import extend_kernel as ek
    from tpubwa_torch.device import occ, smem, smem_fused
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
        occ.sa_lookup.launches = occ.sa_lookup.marked_launches = 0
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
                    "sa_lookup": occ.sa_lookup.launches,
                    "sa_lookup_marked": occ.sa_lookup.marked_launches,
                    "ksw_extend": ek.extend_batch.launches}
    finally:
        smem.rounds12_megaq = k2
    if (not launches["smem_rounds12"] or not launches["seed_strategy"]
            or launches["sa_lookup"] != seeding.calls
            or launches["sa_lookup_marked"] != seeding.calls):
        raise AssertionError(f"5c launched {launches} in {seeding.calls} "
                             "chunks")
    if lines != main["sam"]:
        raise AssertionError(f"5c SAM != phase 5's ({len(lines)} vs "
                             f"{len(main['sam'])} lines, first diff "
                             f"{sam_diff(lines, main['sam'])})")
    fused, ksa, walk_stats = fused_walk_checks(torch, np, aligner,
                                               seeding.first)
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
             "first_batch_pass": busy, "fused_sa": fused}
    print("[5c megaq] " + json.dumps(facts), flush=True)
    return dict(facts, chunk=seen["calls"][0], walk=(ksa, walk_stats))


TP_KERNELS = {"smem_rounds12": "rounds12_megaq.launches",
              "smem_rounds12_tp": "rounds12_megaq.tp_launches",
              "seed_strategy": "_seed_strategy_scan.launches",
              "sa_lookup": "sa_lookup.launches",
              "sa_lookup_tp": "sa_lookup.tp_launches"}


def tp_counts(reset=False):
    """The launch counts of 5i's kernels (``TP_KERNELS``), or with
    ``reset`` set them to 0 (and K1's)."""
    from tpubwa_torch.device import extend_kernel as ek
    from tpubwa_torch.device import occ, smem, smem_fused
    fns = {"rounds12_megaq": smem_fused.rounds12_megaq,
           "_seed_strategy_scan": smem._seed_strategy_scan,
           "sa_lookup": occ.sa_lookup}
    if reset:
        for key in TP_KERNELS.values():
            fn, attr = key.split(".")
            setattr(fns[fn], attr, 0)
        occ.sa_lookup.marked_launches = ek.extend_batch.launches = 0
        return None
    return {name: getattr(fns[key.split(".")[0]], key.split(".")[1])
            for name, key in TP_KERNELS.items()}


def phase_megaq_tp(torch, np, main, megaq):
    """[5i tp]: phase 5's 2 x 8,192 pairs in megaq through the port's
    aligner over ``TpIndex(fmi, [cuda:0, cuda:0])`` (the index's occ,
    mark and sa_marked rows in two slabs on the card; K2 and the fused
    K-sa read each row from the slab that holds it, K3, the extension
    and pac the aligner's whole index), then over 3 slabs, between two
    passes of 5c's aligner (megaq on the flat index), and over one slab
    a card where torch sees more than one.  Each pass's SAM must equal
    phase 5's byte for byte; over slabs, K2's and K-sa's TP
    instantiations must launch (K-sa once a chunk) and the flat K2 and
    K-sa must not, with the counts at 0 just before the run, and each
    slab holds padded total / n rows.  Each pass's seeding stage wall
    and reads/s, in the order run.  Returns the TP launches summed over
    the passes."""
    from tpubwa_torch.device.pipeline import make_device_aligner
    from tpubwa_torch.dist.index_tp import TpIndex
    from tpubwa_torch.host.pipeline import process_batches
    from tpubwa_torch.sim import simulate_pe
    fmi, opt, batches = main["fmi"], main["opt"], main["batches"]
    n_reads = sum(len(b) for b in batches)
    cards = torch.cuda.device_count()
    runs = [None, [DEV, DEV], [DEV] * 3, None]
    if cards > 1:
        runs.append([f"cuda:{i}" for i in range(cards)])
    flat = seed_aligner(opt, fmi, "megaq")
    warm = simulate_pe(fmi.bnt, 1024, 100, np.random.default_rng(2))
    total = {"smem_rounds12_tp": 0, "sa_lookup_tp": 0}
    for order, devices in enumerate(runs):
        facts = {"pass": order, "index": "flat (5c's aligner)"}
        aligner = flat
        if devices is not None:
            t0 = time.perf_counter()
            tp = TpIndex(fmi, devices)
            facts = {"pass": order, "devices": [str(d) for d in tp.devices],
                     "slabs": tp.n, "slab_rows": tp.slab_rows,
                     "rows_total": tp.rows_total, "slab_bytes": tp.nbytes(),
                     "slab_s": round(time.perf_counter() - t0, 3)}
            for name, per in tp.slab_rows.items():
                if per * tp.n != tp.rows_total[name] or any(
                        len(x) != per for x in tp.slabs[name]):
                    raise AssertionError(f"5i {devices}: {name} slabs of "
                                         f"{[len(x) for x in tp.slabs[name]]}")
            aligner = make_device_aligner(opt, fmi, device=DEV, tp=tp)
            if aligner.seed_mode != "megaq":
                raise AssertionError(f"5i seeds in {aligner.seed_mode}")
        if aligner is not flat or order == 0:  # its first pass
            for _ in process_batches(opt, fmi, iter([warm]), 0,
                                     align_fn=aligner):
                pass
        tp_counts(reset=True)
        torch.cuda.synchronize()
        with SeedTimer(torch) as seeding:
            t0 = time.perf_counter()
            lines = [l for _, ls in process_batches(
                opt, fmi, iter(batches), 0, align_fn=aligner) for l in ls]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches = tp_counts()
        slabbed = devices is not None
        if slabbed and (not launches["smem_rounds12_tp"]
                        or not launches["seed_strategy"]
                        or launches["sa_lookup_tp"] != seeding.calls
                        or launches["smem_rounds12"]
                        or launches["sa_lookup"]):
            raise AssertionError(f"5i {devices} launched {launches} in "
                                 f"{seeding.calls} chunks")
        if lines != main["sam"]:
            raise AssertionError(f"5i {devices}: SAM != phase 5's "
                                 f"({len(lines)} vs {len(main['sam'])} "
                                 f"lines, first diff "
                                 f"{sam_diff(lines, main['sam'])})")
        if slabbed:
            for name in total:
                total[name] += launches[name]
        print("[5i tp] " + json.dumps(dict(
            facts, seed_mode=aligner.seed_mode, reads=n_reads,
            seconds=round(dt, 3), reads_per_s=round(n_reads / dt, 1),
            seeding_s=round(seeding.s, 3), seeding_calls=seeding.calls,
            sam_lines=len(lines), sam_equal_to_phase5=True,
            launches=launches, cards_seen=cards,
            **{"5c_reads_per_s": megaq["reads_per_s"],
               "5c_seeding_s": megaq["seeding_s"]})), flush=True)
        if slabbed:
            del aligner, tp
    if cards < 2:
        print("[5i tp] " + json.dumps({
            "one_slab_a_card": "not run: torch sees one card"}), flush=True)
    return total


def fused_walk_checks(torch, np, aligner, first):
    """5c's first chunk: its fused SA segments (cnt, pos) == the native
    walk's (``aligner._sa_positions``) on the same rows; then the chunk's
    ranks built again on the card (``smem.sa_ranks``, its wall by the
    host clock with the card synchronised, mean of 10), K-sa's marked
    walk on them alone in interleaved passes (its output == the fused
    positions), its plain version once (== the kernel) and the walk's
    bound (``walk_case``: the bytes of the distinct sectors it reads).
    Returns (the facts, K-sa alone on those ranks (``ksa_alone``), the
    plain walk's stats)."""
    from tpubwa_torch.device import occ, smem
    from tpubwa_torch.scripts.exp_kernel_floor import interleaved_min
    flat, _, _, sa = first
    if sa is None:
        raise AssertionError("5c's seeding stage gave no SA positions")
    cnt, pos = sa
    want_pos, want_cnt = aligner._sa_positions((flat, None))
    if not (np.array_equal(cnt, want_cnt) and np.array_equal(pos, want_pos)):
        raise AssertionError(f"5c's fused SA != the native walk's: counts "
                             f"{int((cnt != want_cnt).sum())} rows apart")
    didx = aligner.didx
    rows = torch.from_numpy(flat).to(DEV).to(didx.idt)
    keep = torch.ones(len(flat), dtype=torch.bool, device=DEV)
    times = []
    for _ in range(11):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got_cnt, ranks = smem.sa_ranks(didx, rows, keep, aligner.opt.max_occ)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    if not np.array_equal(got_cnt.cpu().numpy(), cnt):
        raise AssertionError("sa_ranks' counts != the fused ones")
    ksa = ksa_alone(torch, didx, ranks)
    ms = interleaved_min({"ksa": ksa}, 20, 4, torch.device(DEV))["ksa"]
    if not np.array_equal(ksa.buffers[1].cpu().numpy().astype(np.int64),
                          pos):
        raise AssertionError("K-sa alone != the fused positions")
    stats = {}
    plain, plain_ms = timed_once(
        torch, lambda: occ.sa_lookup_plain(didx, ranks, stats=stats))
    err = int((plain.long() - ksa.buffers[1].long()).abs().max())
    if err:
        raise AssertionError(f"K-sa != plain on 5c's ranks by {err}")
    case = walk_case(torch, np, didx, ranks, ms, plain_ms, stats)
    bound_ms, _, _ = bytes_bound(case)
    return {"rows": len(flat), "ranks": len(ranks), "marked": True,
            "equal_to_native_walk": True,
            "rank_build_ms": round(1e3 * float(np.mean(times[1:])), 4),
            "ksa": dict(case, bound_ms=round(bound_ms, 6), max_abs_err=err)
            }, ksa, stats


def phase_megaq_stock(torch, np, main, stock):
    """[5d megaq-stock]: phase 5's 2 x 8,192 pairs through the port's
    aligner on cuda with TPUBWA_SEED_MODE=megaq on 5b's stock-bwa index
    (``stock``, no text-position marks): K2 and K3 seed every read and
    K-sa walks every SA position, fused into the seeding stage, all
    three on one run.  Its SAM must equal phase 5's byte for byte; K2
    and K3 must launch and K-sa once a chunk, with the counts at 0 just
    before the run."""
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
    if (not all(launches[k] for k in ("smem_rounds12", "seed_strategy"))
            or launches["sa_lookup"] != seeding.calls):
        raise AssertionError(f"5d launched {launches} in {seeding.calls} "
                             "chunks")
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


DP_KERNELS = {"smem_rounds12": "rounds12_megaq.launches",
              "seed_strategy": "_seed_strategy_scan.launches",
              "sa_lookup": "sa_lookup.launches",
              "ksw_extend": "extend_batch.launches"}


def phase_megaq_dp(torch, np, main, stock, d5):
    """[5g dp]: 5d (phase 5's 2 x 8,192 pairs in megaq on 5b's stock-bwa
    index) through the port's aligner over ``DataParallel([cuda:0,
    cuda:0])`` (two replicas of the index on the one card, each chunk's
    reads and extension jobs split between them, and each replica's SA
    walk fused into its seeding), and again over every card where there
    are more.  Each run's SAM must equal phase 5's byte for byte, and
    K2, K3, K-sa and K1 must each launch on every replica, K-sa once a
    chunk, by the replicas' tallies and by the locked counts, all at 0
    just before the run.  Each replica's reads, ranks and jobs, and
    reads/s beside phase 5's and 5d's.  Returns the launches summed over
    the runs, by the kernels line's names."""
    from tpubwa_torch.device import extend_kernel as ek
    from tpubwa_torch.device import occ, smem, smem_fused
    from tpubwa_torch.device.pipeline import make_device_aligner
    from tpubwa_torch.dist.sharding import DataParallel
    from tpubwa_torch.host.pipeline import process_batches
    from tpubwa_torch.sim import simulate_pe
    opt, batches = main["opt"], main["batches"]
    runs = [["cuda:0", "cuda:0"]]
    if torch.cuda.device_count() > 1:
        runs.append([f"cuda:{i}" for i in range(torch.cuda.device_count())])
    total = dict.fromkeys(DP_KERNELS, 0)
    n_reads = sum(len(b) for b in batches)
    for devices in runs:
        dp = DataParallel.over(devices)
        aligner = make_device_aligner(opt, stock, dp=dp)
        if aligner.seed_mode != "megaq":
            raise AssertionError(f"5g seeds in {aligner.seed_mode}")
        warm = simulate_pe(stock.bnt, 1024, 100, np.random.default_rng(2))
        for _ in process_batches(opt, stock, iter([warm]), 0,
                                 align_fn=aligner):
            pass
        dp.synchronize()
        for t in dp.tally:
            t.clear()
        smem_fused.rounds12_megaq.launches = 0
        smem._seed_strategy_scan.launches = 0
        occ.sa_lookup.launches = occ.bwt_extend.launches = 0
        ek.extend_batch.launches = 0
        t0 = time.perf_counter()
        lines = [l for _, ls in process_batches(
            opt, stock, iter(batches), 0, align_fn=aligner) for l in ls]
        dp.synchronize()
        dt = time.perf_counter() - t0
        launches = {"smem_rounds12": smem_fused.rounds12_megaq.launches,
                    "seed_strategy": smem._seed_strategy_scan.launches,
                    "sa_lookup": occ.sa_lookup.launches,
                    "ksw_extend": ek.extend_batch.launches,
                    "bwt_extend": occ.bwt_extend.launches}
        replicas = [{"device": str(d), **{k: t.get(k, 0) for k in (
            "reads", "ranks", "jobs")}, "launches": {
                name: t.get(key, 0) for name, key in DP_KERNELS.items()}}
            for d, t in zip(dp.devices, dp.tally)]
        idle = [(r["device"], name) for r in replicas
                for name, n in r["launches"].items() if not n]
        if idle:
            raise AssertionError(f"5g {devices}: no launch of {idle}")
        chunks = -(-max(len(b) for b in batches) // aligner.chunk_reads)
        walks = [r["launches"]["sa_lookup"] for r in replicas]
        if walks != [len(batches) * chunks] * len(replicas):
            raise AssertionError(f"5g {devices}: K-sa launched {walks} a "
                                 f"replica, not one a chunk")
        for name in DP_KERNELS:
            if launches[name] != sum(r["launches"][name] for r in replicas):
                raise AssertionError(f"5g: {name} counted {launches[name]}"
                                     f", the replicas {replicas}")
            total[name] += launches[name]
        if lines != main["sam"]:
            raise AssertionError(f"5g {devices}: SAM != phase 5's "
                                 f"({len(lines)} vs {len(main['sam'])} "
                                 f"lines, first diff "
                                 f"{sam_diff(lines, main['sam'])})")
        print("[5g dp] " + json.dumps({
            "devices": devices, "index": "5b's (stock bwa files, no marks)",
            "seed_mode": aligner.seed_mode, "reads": n_reads,
            "seconds": round(dt, 3), "reads_per_s": round(n_reads / dt, 1),
            "phase5_reads_per_s": round(main["reads_per_s"], 1),
            "5d_reads_per_s": d5["reads_per_s"], "sam_lines": len(lines),
            "sam_equal_to_phase5": True, "launches": launches,
            "replicas": replicas}), flush=True)
        dp.close()
    return total


def sam_diff(lines, want):
    """Where two SAM texts part: the first differing line, or -1 where
    their lengths differ."""
    if len(lines) != len(want):
        return -1
    return next(i for i, (a, b) in enumerate(zip(lines, want)) if a != b)


HYBRID_KERNELS = {"smem_rounds12": "rounds12_megaq.launches",
                  "seed_strategy": "_seed_strategy_scan.launches",
                  "sa_lookup": "sa_lookup.launches",
                  "sa_lookup_marked": "sa_lookup.marked_launches"}


def hybrid_passes(torch, np, main, aligner, tag, dp=None):
    """Phase 5's batches through ``aligner`` (seed mode hybrid) in two
    passes, at the aligner's chunk size (16,384 reads) and at 4,096
    (eight chunks for the balancer to move over), each with a new
    balancer (after the warm-up, as a `mem` run starts) and the counts
    (and ``dp``'s tallies) at 0 just before it.  Each pass's SAM must
    equal phase 5's byte for byte, K2, K3 and the marked K-sa must
    launch (on every replica of ``dp``), K-sa once a split chunk, and
    every chunk of at least k_floor / f reads must be split (0 < k <
    B).  Returns {pass: facts} and the launches summed."""
    from tpubwa_torch.device import occ, smem, smem_fused
    from tpubwa_torch.device.smem import HybridSplit
    from tpubwa_torch.host.pipeline import process_batches
    fmi, opt, batches = main["fmi"], main["opt"], main["batches"]
    counters = {"smem_rounds12": (smem_fused.rounds12_megaq, "launches"),
                "seed_strategy": (smem._seed_strategy_scan, "launches"),
                "sa_lookup": (occ.sa_lookup, "launches"),
                "sa_lookup_marked": (occ.sa_lookup, "marked_launches")}
    n_reads = sum(len(b) for b in batches)
    launches, out = dict.fromkeys(counters, 0), {}
    for name, chunk_reads in (("pass1", aligner.chunk_reads),
                              ("pass2", 4096)):
        aligner.chunk_reads = chunk_reads
        aligner.hybrid = split = HybridSplit.from_env()
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        if dp is not None:
            dp.synchronize()
            for t in dp.tally:
                t.clear()
        torch.cuda.synchronize()
        with SeedTimer(torch) as seeding:
            t0 = time.perf_counter()
            lines = [l for _, ls in process_batches(
                opt, fmi, iter(batches), 0, align_fn=aligner) for l in ls]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        got = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
        chunks = [dict(zip(("B", "k", "t_dev", "t_host", "f"), h))
                  for h in split.history]
        n_split = sum(0 < c["k"] < c["B"] for c in chunks)
        if (not all(got.values()) or got["sa_lookup"] != got[
                "sa_lookup_marked"] or got["sa_lookup"] < n_split):
            raise AssertionError(f"{tag} {name} launched {got} in "
                                 f"{n_split} split chunks")
        if lines != main["sam"]:
            raise AssertionError(
                f"{tag} {name} SAM != phase 5's ({len(lines)} vs "
                f"{len(main['sam'])} lines, first diff "
                f"{sam_diff(lines, main['sam'])})")
        if len(chunks) != seeding.calls:
            raise AssertionError(f"{tag} {name}: {seeding.calls} chunks "
                                 f"seeded, {len(chunks)} in the history")
        for c in chunks:
            if c["B"] * c["f"] >= split.k_floor and not 0 < c["k"] < c["B"]:
                raise AssertionError(f"{tag} {name}: a chunk not split: {c}")
        for k in launches:
            launches[k] += got[k]
        out[name] = {
            "chunk_reads": chunk_reads, "seconds": round(dt, 3),
            "reads_per_s": round(n_reads / dt, 1),
            "seeding_s": round(seeding.s, 3), "sam_lines": len(lines),
            "sam_equal_to_phase5": True, "launches": got,
            "k_floor": split.k_floor, "f_after": round(split.f, 6),
            "chunks": [{k: round(v, 6) if k in ("t_dev", "t_host", "f")
                        else v for k, v in c.items()} for c in chunks]}
        if dp is not None:
            replicas = [{"device": str(d), **{k: t.get(k, 0) for k in (
                "reads", "ranks", "jobs")}, "launches": {
                    n: t.get(key, 0) for n, key in HYBRID_KERNELS.items()}}
                for d, t in zip(dp.devices, dp.tally)]
            idle = [(r["device"], n) for r in replicas
                    for n, c in r["launches"].items() if not c]
            if idle:
                raise AssertionError(f"{tag} {name}: no launch of {idle}")
            out[name]["replicas"] = replicas
    return out, launches


def phase_hybrid(torch, np, main, megaq):
    """[5e hybrid]: phase 5's 2 x 8,192 pairs through the port's aligner
    on cuda with TPUBWA_SEED_MODE=hybrid and the TPUBWA_HYBRID_* defaults
    (as `mem` runs it): each chunk's first k reads on K2 and K3, their
    SA on K-sa's marked walk, beside the native seeder and walk on the
    rest, k from the balancer; both passes of ``hybrid_passes``.  Prints
    each chunk's (B, k, t_dev, t_host, f), reads/s and the seeding
    stage's wall beside phase 5's and 5c's.  Returns the facts, with
    both passes' launches summed."""
    from tpubwa_torch.host.pipeline import process_batches
    from tpubwa_torch.sim import simulate_pe
    fmi, opt = main["fmi"], main["opt"]
    aligner = seed_aligner(opt, fmi, "hybrid")
    warm = simulate_pe(fmi.bnt, 1024, 100, np.random.default_rng(2))
    for _ in process_batches(opt, fmi, iter([warm]), 0, align_fn=aligner):
        pass
    passes, launches = hybrid_passes(torch, np, main, aligner, "5e")
    facts = {"reads": sum(len(b) for b in main["batches"]),
             "phase5_reads_per_s": round(main["reads_per_s"], 1),
             "phase5_seeding_s": round(main["seeding_s"], 3),
             "megaq_5c_reads_per_s": megaq["reads_per_s"],
             "megaq_5c_seeding_s": megaq["seeding_s"], **passes,
             "launches": launches}
    print("[5e hybrid] " + json.dumps(facts), flush=True)
    return facts


def phase_hybrid_dp(torch, np, main, hybrid):
    """[5h hybrid-dp]: 5e through the port's aligner over
    ``DataParallel([cuda:0, cuda:0])`` with TPUBWA_SEED_MODE=hybrid: each
    chunk's device share split between the two replicas of the index on
    the one card (K2, K3 and the marked K-sa on each, on its own worker
    thread and stream), the whole chunk uploaded once to each for K1,
    the native seeder and walk on the rest; one balancer for the
    aligner, its device wall the slower replica's.  Both passes of
    ``hybrid_passes``, K2, K3 and K-sa launching on both replicas.
    Prints each replica's reads, ranks, jobs and launches, each chunk's
    (B, k, t_dev, t_host, f) and reads/s beside 5e's.  Returns the
    launches summed, with K1's."""
    from tpubwa_torch.device import extend_kernel as ek
    from tpubwa_torch.dist.sharding import DataParallel
    from tpubwa_torch.host.pipeline import process_batches
    from tpubwa_torch.sim import simulate_pe
    fmi, opt = main["fmi"], main["opt"]
    dp = DataParallel.over(["cuda:0", "cuda:0"])
    try:
        aligner = seed_aligner(opt, fmi, "hybrid", dp=dp)
        warm = simulate_pe(fmi.bnt, 1024, 100, np.random.default_rng(2))
        for _ in process_batches(opt, fmi, iter([warm]), 0,
                                 align_fn=aligner):
            pass
        ek.extend_batch.launches = 0
        passes, launches = hybrid_passes(torch, np, main, aligner, "5h",
                                         dp=dp)
        launches["ksw_extend"] = ek.extend_batch.launches
    finally:
        dp.close()
    print("[5h hybrid-dp] " + json.dumps({
        "devices": [str(d) for d in dp.devices], "index": "phase 5's "
        "(marked)", "reads": sum(len(b) for b in main["batches"]),
        "5e_reads_per_s": [hybrid[p]["reads_per_s"]
                           for p in ("pass1", "pass2")],
        **passes, "launches": launches}), flush=True)
    return launches


# pairs of phase 5's first batch that 5f aligns: at 2,048 the Python path
# under TPUBWA_NO_NATIVE took 152.9 s on an H100 host, past 5f's share of
# the run's time limit
NO_NATIVE_PAIRS = 1024
# the TPUBWA_NO_NATIVE run's pairs, the first of those: its seeding,
# chaining and emit in Python take ~50 ms a read (81-108 s at 1,024
# pairs, PERF.md)
PYTHON_PAIRS = 256


def phase_no_native(torch, np, main):
    """[5f no-native]: the first 1,024 pairs of phase 5's first batch, one
    batch, through `mem`'s path on cuda, each run with a new aligner and
    the native caches reset: native (the reference) and
    TPUBWA_NO_NATIVE_PLAN=1 (the Python planner's waves), then the first
    256 of them (``PYTHON_PAIRS``) native again and TPUBWA_NO_NATIVE=1
    (megaq seeding, the marked SA walk on the card, chaining, planning
    and emit in Python).  Each no-native SAM must equal the native run's
    on the same pairs byte for byte; K1 must launch on both paths,
    and K2, K3 and the marked K-sa on the TPUBWA_NO_NATIVE one, with the
    counts at 0 just before each run.  Each run's launches, waves, jobs
    and scalar-loop jobs, reads/s and wall, beside the card's name and
    power limit.  Returns the launches of the two no-native runs,
    summed."""
    from tpubwa_torch.device import extend_kernel as ek
    from tpubwa_torch.device import occ, smem, smem_fused
    from tpubwa_torch.device.pipeline import (make_device_aligner,
                                              reset_native_caches)
    from tpubwa_torch.host.pipeline import process_batches
    fmi, opt = main["fmi"], main["opt"]
    batch = main["batches"][0][:2 * NO_NATIVE_PAIRS]
    cut = batch[:2 * PYTHON_PAIRS]
    counters = {"ksw_extend": ek.extend_batch,
                "smem_rounds12": smem_fused.rounds12_megaq,
                "seed_strategy": smem._seed_strategy_scan,
                "sa_lookup": occ.sa_lookup}
    card = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]
    facts = {"reads": len(batch), "card": card}
    sams, total = {}, dict.fromkeys(counters, 0)
    total["sa_lookup_marked"] = 0
    # (run, switch, its reads, the native run it must equal)
    for name, switch, reads, ref in (
            ("native", None, batch, None),
            ("no_native_plan", "TPUBWA_NO_NATIVE_PLAN", batch, "native"),
            ("native_cut", None, cut, None),
            ("no_native", "TPUBWA_NO_NATIVE", cut, "native_cut")):
        if switch:
            os.environ[switch] = "1"
        reset_native_caches()
        try:
            aligner = make_device_aligner(opt, fmi, device=DEV)
            if switch == "TPUBWA_NO_NATIVE":
                aligner.didx.upload_fm()   # the FM arrays, before the clock
            for c in counters.values():
                c.launches = 0
            occ.sa_lookup.marked_launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sams[name] = [l for _, ls in process_batches(
                opt, fmi, iter([reads]), 0, align_fn=aligner) for l in ls]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got = {k: c.launches for k, c in counters.items()}
            got["sa_lookup_marked"] = occ.sa_lookup.marked_launches
        finally:
            if switch:
                del os.environ[switch]
            reset_native_caches()
        ext = aligner.extender
        facts[name] = {
            "seed_mode": aligner.seed_mode, "reads": len(reads),
            "seconds": round(dt, 3),
            "reads_per_s": round(len(reads) / dt, 1), "launches": got,
            "n_waves": ext.n_waves, "n_jobs": ext.n_jobs,
            "n_fallback": ext.n_fallback, "sam_lines": len(sams[name])}
        if switch is None:
            continue
        need = ["ksw_extend"]
        if switch == "TPUBWA_NO_NATIVE":
            need += ["smem_rounds12", "seed_strategy", "sa_lookup_marked"]
        if not all(got[k] > 0 for k in need):
            raise AssertionError(f"5f {name} launched {got}")
        if sams[name] != sams[ref]:
            raise AssertionError(
                f"5f {name} SAM != the native run's ({len(sams[name])} vs "
                f"{len(sams[ref])} lines, first diff "
                f"{sam_diff(sams[name], sams[ref])})")
        facts[name]["sam_equal_to_native"] = True
        for k in total:
            total[k] += got[k]
    facts["launches"] = total
    print("[5f no-native] " + json.dumps(facts), flush=True)
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
    card, the plain versions on CPU copies of the index; K2's TP
    instantiation too, over ``TP_SLABS`` slabs on DEV at one row slot a
    read, and (int32) the plain version over 2 slabs' routed accessors ==
    over the flat index.  Returns {instantiation: facts}, each with the
    plain versions' ms."""
    from tpubwa_torch.device import smem, smem_fused
    from tpubwa_torch.device.occ import DeviceIndex
    from tpubwa_torch.dist.index_tp import TpIndex
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
        # K2's TP instantiation over 2 and 3 slabs, one row slot a read
        # (most reads take its second launch)
        for n in TP_SLABS:
            stats = {}
            got = smem_fused.rounds12_megaq(
                opt, TpIndex.from_index(g, [DEV] * n), q.to(DEV), ld.to(DEV),
                slots=1, stats=stats)
            torch.cuda.synchronize()
            if not all(torch.equal(stats[k].cpu(), want_stats[k])
                       for k in ("steps", "chain")):
                raise AssertionError(f"{label}/{dt} K2 (tp, {n} slabs) "
                                     "steps or chain != plain")
            for a, b, what in ((got[0], want[0], "rows"),
                               (got[1], want[1], "rids")):
                if a.shape != b.shape:
                    raise AssertionError(f"{label}/{dt} K2 (tp, {n} slabs) "
                                         f"{what}: {tuple(a.shape)}")
                held_fm(torch, f"{label}/{dt} K2 {what} (tp, {n} slabs)",
                        a.cpu().reshape(len(a), -1), b.reshape(len(b), -1))
        plain12_tp = None
        if dt == "int32":  # the plain version over 2 slabs' accessors
            t0 = time.perf_counter()
            tp_want = smem_fused.rounds12_plain(
                opt, TpIndex.from_index(c, ["cpu", "cpu"]), q, ld)
            plain12_tp = (time.perf_counter() - t0) * 1e3
            if not (torch.equal(tp_want[0], want[0])
                    and torch.equal(tp_want[1], want[1])):
                raise AssertionError(f"{label} K2's plain version over "
                                     "slabs != over the flat index")
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
                   "k2_tp_slabs": list(TP_SLABS),
                   "plain_ms": {"smem_rounds12": round(plain12, 3),
                                "seed_strategy": round(plain3, 3)}}
        if plain12_tp is not None:
            out[dt]["plain_ms"]["smem_rounds12_tp"] = round(plain12_tp, 3)
    return out


def seeding_bytes(torch, np, didx, qd, ld, opt, kernel, out_rows):
    """The bytes a launch of K2 (``kernel`` 0, every read of the chunk)
    or K3 (1) must move: the reads and lens, the rows it writes
    (``out_rows``) and their counts, and the distinct sectors of the
    index it reads, counted by csrc/smem_host.cpp (built without the
    sanitizers) on the same inputs.  Returns (the bytes, the distinct
    occ rows, (the inputs' and outputs' bytes, those rows))."""
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
    return fm_bytes(io, [(rows, OCC_ROW)]), len(rows), (io, rows)


def k2_alone(torch, opt, didx, qd, ld, lib=None, tp=None):
    """K2's C entry alone on preallocated buffers (every read, the row
    slots of the first launch): a launch not counted on the wrapper.
    The buffers live on the returned function (``.buffers``: rids,
    queue, rows, counts, steps, chain), which launches on their
    pointers.  ``lib``: another build of csrc/smem.cu's entries (the
    package's own where None); ``tp``: K2's TP instantiation over that
    TpIndex's slabs."""
    from tpubwa_torch.device import _build, smem_fused as sf
    lib = lib or _build.load("smem", sf._SIGNATURES)
    entry, index = lib.tpubwa_smem_rounds12, sf.index_args(didx)
    if tp is not None:
        entry = lib.tpubwa_smem_rounds12_tp
        index = (tp.n, tp.kernel_table("occ_blocks"), tp.L2.data_ptr(),
                 tp.primary, tp.seq_len, int(tp.idt == torch.int64))
    B, L = qd.shape
    rids = torch.arange(B, dtype=torch.int32, device=DEV)
    queue = torch.empty(1, dtype=torch.int32, device=DEV)
    rows = torch.empty((B, sf.K2_SLOTS, 5), dtype=didx.idt, device=DEV)
    counts, steps, chain = (torch.empty(B, dtype=torch.int32, device=DEV)
                            for _ in range(3))
    args = (*index, qd.data_ptr(), L, ld.data_ptr(),
            rids.data_ptr(), B, opt.min_seed_len, sf.split_len_of(opt),
            opt.split_width, sf.K2_SLOTS, queue.data_ptr(),
            rows.data_ptr(), counts.data_ptr(), steps.data_ptr(),
            chain.data_ptr(), qd.device.index, sf.stream_of(qd))

    def launch():
        if entry(*args):
            raise AssertionError("K2's launch failed")
    launch.buffers = (rids, queue, rows, counts, steps, chain)
    launch.index = tp
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
    wrapper, its bwt_extend steps a read and a warp, and its bytes; K2's
    and K-sa's TP instantiations over 2 and 3 slabs alone beside them
    (K-sa on 5c's ranks), == the flat kernels, with their bounds and
    SASS.  Returns {kernel: case}, the TP rows' under
    ``smem_rounds12_tp`` and ``sa_lookup_tp``."""
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
    # the TP instantiations beside the flat ones: K2 on the chunk, K-sa
    # on its fused walk's ranks (5c), over 2 and 3 slabs on DEV
    from tpubwa_torch.device import occ
    from tpubwa_torch.dist.index_tp import TpIndex
    ksa, walk_stats = megaq["walk"]
    ranks = ksa.buffers[0]
    tps = {n: TpIndex.from_index(didx, [DEV] * n) for n in TP_SLABS}
    alone["sa_lookup"] = ksa
    for n, tp in tps.items():
        alone[f"smem_rounds12_tp {n}"] = k2_alone(torch, opt_, didx, qd, ld,
                                                  tp=tp)
        alone[f"sa_lookup_tp {n}"] = ksa_tp_alone(torch, tp, ranks)
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
    # K2's TP instantiation: rows (in their slots), counts, steps and
    # chain == K2 flat's; K-sa's: positions == the flat walk's
    *_, rows, counts, steps, chain = alone["smem_rounds12"].buffers
    slot = (torch.arange(rows.shape[1], device=DEV)[None, :]
            < counts.clamp(max=rows.shape[1])[:, None])
    for n in TP_SLABS:
        *_, t_rows, t_counts, t_steps, t_chain = alone[
            f"smem_rounds12_tp {n}"].buffers
        if not (torch.equal(t_counts, counts) and torch.equal(t_steps, steps)
                and torch.equal(t_chain, chain)
                and torch.equal(t_rows[slot], rows[slot])):
            raise AssertionError(f"K2 (tp, {n} slabs) != K2 flat on 5c's "
                                 "first chunk")
        if not torch.equal(alone[f"sa_lookup_tp {n}"].buffers[1],
                           ksa.buffers[1]):
            raise AssertionError(f"K-sa (tp, {n} slabs) != K-sa flat on "
                                 "5c's ranks")
    tp_stats = {}
    tp_plain, tp_plain_ms = timed_once(torch, lambda: occ.sa_lookup_plain(
        tps[2], ranks, stats=tp_stats))
    _, ksa_err = held_fm(torch, "K-sa (tp) on 5c's ranks", alone[
        "sa_lookup_tp 2"].buffers[1], tp_plain)
    # the plain versions step one interval at a time: timed on 256 of the
    # chunk's reads and the edge reads, not on the chunk
    plain256 = cases[f"{GENOME_MB} Mbp"]["int32"]["plain_ms"]
    out = {}
    for name, stats, n_out, kernel in (
            ("smem_rounds12", stats12, len(rows12), 0),
            ("seed_strategy", stats3, int(n_hits.sum()), 1)):
        steps = stats["steps"].cpu().numpy()
        nbytes, n_occ, read = seeding_bytes(torch, np, didx, qd, ld, opt_,
                                            kernel, n_out)
        if not kernel:
            k2_read = read
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
    # the TP rows: their bound from the sectors of the slabs' own rows
    io, occ_rows = k2_read
    tp2 = tps[2]
    out["smem_rounds12_tp"] = {
        "reads": len(ld), "slabs": 2, "ms": round(best["smem_rounds12_tp 2"],
                                                  4),
        "ms_3_slabs": round(best["smem_rounds12_tp 3"], 4),
        "flat_ms": round(best["smem_rounds12"], 4),
        "plain_ms": cases[f"{GENOME_MB} Mbp"]["int32"]["plain_ms"][
            "smem_rounds12_tp"],
        "plain_reads": cases[f"{GENOME_MB} Mbp"]["int32"]["reads"],
        "bytes": fm_bytes(io, slab_reads(tp2, "occ_blocks", occ_rows,
                                         OCC_ROW)),
        "slab_rows": tp2.slab_rows, "max_abs_err": 0}
    out["sa_lookup_tp"] = {
        "n": len(ranks), "slabs": 2, "ms": round(best["sa_lookup_tp 2"], 4),
        "ms_3_slabs": round(best["sa_lookup_tp 3"], 4),
        "flat_ms": round(best["sa_lookup"], 4),
        "plain_ms": round(tp_plain_ms, 3),
        "bytes": tp_walk_bytes(tp2, len(ranks), walk_stats),
        "max_abs_err": ksa_err}
    for name in ("smem_rounds12_tp", "sa_lookup_tp"):
        out[name]["bound_ms"] = round(bytes_bound(out[name])[0], 6)
    out["smem_rounds12"].update(k2_launch_facts(torch, didx, qd.shape[1]))
    out["seed_strategy"].update(k3_launch_facts(torch, len(ld)))
    print("[3h seeding] " + json.dumps({
        "tolerance": 0, "cases": cases, "native_seeder": native,
        "main_launch": out, "card": "the first chunk of 5c (16,384 reads)",
        "k2_refusals": k2_refusals(torch, didx, qd, ld, opt_),
        "sass_loads": seeding_sass(), "tp_sass": tp_sass(),
        "sass_digest": seeding_digest(),
        "seconds": round(time.perf_counter() - t_phase, 1)}), flush=True)
    return out


def tp_sass():
    """Each TP instantiation beside its flat one (int32): its registers
    and spills (ptxas) and its row loads in SASS (``load_rounds``: of the
    loop of a step, in K-sa's marked walk and K2; of the whole kernel in
    K-ext, one query a thread)."""
    from tpubwa_torch.device import _build
    out, text = {}, {}
    for name, src, fn, loop in (
            ("sa_lookup", "occ", r"sa_lookup_kernelIiLb1ELb{}EE", True),
            ("bwt_extend", "occ", r"bwt_extend_kernelIiLb0ELb{}EE", False),
            ("smem_rounds12", "smem", r"collect12_kernelIiLb{}EE", True)):
        if src not in text:
            text[src] = _run([_cuobjdump(), "-sass",
                              _build.build_info[src]["so"]])
        report = _build.build_info[src]["ptxas"]
        out[name] = {form: dict(ptxas_usage(report, fn.format(b)),
                                step=load_rounds(text[src], fn.format(b),
                                                 loop=loop))
                     for form, b in (("flat", 0), ("tp", 1))}
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
            "ptxas": {dt: ptxas_usage(report, rf"collect12_kernelI{m}Lb0EE")
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


def split_kernels(csrc=None):
    """{K-fwd, K-bwd: the regex of its SASS or ptxas function's name, {}
    for the rank type's letter}, at K-fwd's group size in the sources
    ``csrc`` (the package's where None)."""
    from tpubwa_torch.device import warp_host
    k = warp_host.split_constants(csrc or warp_host.CSRC)
    return {"smem_fwd": rf"smem_fwd_kernelI{{}}Li{k['kFwdGroup']}EE",
            "smem_bwd": r"smem_bwd_kernelI{}E"}


# K2, K2-tp, K3, K-cur, K-fwd and K-bwd, each rank type: their SASS
# functions' names
SEEDING_KERNELS = {
    f"{k}/{dt}": fn.format(m)
    for dt, m in (("int32", "i"), ("int64", "l"))
    for k, fn in (("smem_rounds12", r"collect12_kernelI{}Lb0EE"),
                  ("smem_rounds12_tp", r"collect12_kernelI{}Lb1EE"),
                  ("seed_strategy", r"seed_strategy_kernelI{}E"),
                  ("smem_jobs", r"smem_jobs_kernelI{}E"),
                  *split_kernels().items())}
# K2's, K2-tp's, K3's and K-cur's SASS (seeding_digest) as built from the
# sources before the split kernels' group designs, on the card's
# toolchain (nvcc 12.9, NVCC_FLAGS): the redesign adds beside them and
# must leave them as they were
KEPT_DIGEST = {
    f"{k}/{dt}": {"instructions": n, "sha256": h}
    for k, dt, n, h in (
        ("smem_rounds12", "int32", 2976, "f345e89852821d63"),
        ("smem_rounds12_tp", "int32", 3536, "d0d95cc371431dfd"),
        ("seed_strategy", "int32", 880, "096dad6fb9474d1e"),
        ("smem_jobs", "int32", 1608, "0bab337f338430eb"),
        ("smem_rounds12", "int64", 3296, "e5a5d62f23bbaf21"),
        ("smem_rounds12_tp", "int64", 3880, "a0c1b4d6fb6cbe5d"),
        ("seed_strategy", "int64", 1016, "d5d972ea4c983efe"),
        ("smem_jobs", "int64", 2104, "f97c777930a8e655"))}


def seeding_digest(so=None, kernels=None):
    """{kernel/rank type: its SASS instructions and a digest of their
    text} of every instantiation of the seeding kernels (or those whose
    name is in ``kernels``), from the package's build of csrc/smem.cu or
    the library ``so`` (another checkout's build, for a side by side):
    two builds whose kernels compile alike give equal digests."""
    import hashlib
    from tpubwa_torch.device import _build
    text = _run([_cuobjdump(), "-sass", so or _build.build_info["smem"]["so"]])
    out = {}
    for key, fn in SEEDING_KERNELS.items():
        if kernels is not None and key.split("/")[0] not in kernels:
            continue
        _, ins, _ = sass_function(text, fn)
        out[key] = {"instructions": len(ins), "sha256": hashlib.sha256(
            "\n".join(op for _, op in ins).encode()).hexdigest()[:16]}
    return out


def seeding_sass():
    """The global loads of K2 and K3 (int32) in their SASS (sass_loads):
    how wide, and whether a loop's loads wait for one another."""
    from tpubwa_torch.device import _build
    text = _run([_cuobjdump(), "-sass", _build.build_info["smem"]["so"]])
    return {name: sass_loads(text, fn)
            for name, fn in (("smem_rounds12", r"collect12_kernelIiLb0EE"),
                             ("seed_strategy", r"seed_strategy_kernelIiE"))}


def phase_kernel_mat(torch, np):
    """[3i K1-mat]: K1-mat (csrc/extend.cu's kMat instantiation) ==
    extend_batch_plain(mat=) on phase 3's twelve job sets under three
    matrices (the entry step's, transition/transversion, a positive
    entry off the diagonal), and == K1's kernel at bwa_fill_scmat's
    matrix, each launch synchronised; then, at phase 3's main shape
    under the transition/transversion matrix, K1-mat alone beside K1
    alone (and K1-mat at scmat) in interleaved passes, with the band
    cells of its plain version.  Returns (the row's case, its largest
    difference from plain)."""
    from tpubwa_torch.device import extend_kernel as ek
    from tpubwa_torch.entry import ENTRY_MAT
    from tpubwa_torch.opts import MemOpt
    from tpubwa_torch.scripts.exp_kernel_floor import interleaved_min
    o = MemOpt()
    pen4 = (o.o_del, o.e_del, o.o_ins, o.e_ins)
    scmat = o.scoring_matrix()
    mats = {"entry": ENTRY_MAT, "tt": ek.tt_matrix(),
            "positive": ek.positive_matrix()}
    t0 = time.perf_counter()
    rng = np.random.default_rng(0x5EED)   # phase 3's sets, in its order
    cases, max_err, main = [], 0, None
    for W, tmax in ((128, 256), (256, 512), (512, 512)):
        for n in (512, 8192):
            for zdrop in (0, 100):
                q, t, p = (torch.from_numpy(x).to(DEV)
                           for x in make_jobs(rng, n, W, tmax))
                case = {"W": W, "tmax": tmax, "n": n, "zdrop": zdrop}
                for name, mat in mats.items():
                    got = ek.extend_batch(q, t, p, None, None, *pen4, zdrop,
                                          mat=mat)
                    torch.cuda.synchronize()
                    stats = {}
                    want, plain_ms = timed_once(
                        torch, lambda: ek.extend_batch_plain(
                            q, t, p, None, None, *pen4, zdrop, stats=stats,
                            mat=mat))
                    max_err = max(max_err, held_to_plain(
                        torch, f"K1-mat != plain under {name} at W={W} "
                        f"n={n} zdrop={zdrop}", got, want))
                    case[name] = {"cells": stats["cells"],
                                  "plain_ms": round(plain_ms, 3)}
                k1 = ek.extend_batch(q, t, p, o.a, o.b, *pen4, zdrop)
                held_to_plain(torch, f"K1-mat at scmat != K1 at W={W} n={n} "
                              f"zdrop={zdrop}", ek.extend_batch(
                                  q, t, p, None, None, *pen4, zdrop,
                                  mat=scmat), k1)
                case["equal_to_k1_at_scmat"] = True
                cases.append(case)
                if (W, tmax, n, zdrop) == (128, 256, 8192, 100):
                    main = (q, t, p, case)
    q, t, p, case = main
    tt = mats["tt"]
    alone = interleaved_min(
        {"K1": lambda: ek._extend_cuda(q, t, p, o.a, o.b, *pen4, 100),
         "K1-mat/tt": lambda: ek._extend_mat_cuda(q, t, p, tt, *pen4, 100),
         "K1-mat/scmat": lambda: ek._extend_mat_cuda(q, t, p, scmat, *pen4,
                                                     100)},
        16, 4, torch.device(DEV))
    stats = {}
    ek.extend_batch_plain(q, t, p, o.a, o.b, *pen4, 100, stats=stats)
    row = {"W": 128, "tmax": 256, "n": len(q), "zdrop": 100, "matrix": "tt",
           "ms": round(alone["K1-mat/tt"], 4),
           "k1_ms": round(alone["K1"], 4),
           "scmat_ms": round(alone["K1-mat/scmat"], 4),
           "mat_over_k1_at_scmat": round(alone["K1-mat/scmat"]
                                         / alone["K1"], 4),
           "plain_ms": case["tt"]["plain_ms"], "cells": case["tt"]["cells"],
           "k1_cells": stats["cells"],
           "bytes": 4 * (q.numel() + t.numel() + p.numel() + 6 * len(q)
                         + 25)}
    print("[3i K1-mat==plain] " + json.dumps(
        {"tolerance": 0, "matrices": {k: v.tolist() for k, v in mats.items()},
         "cases": cases, "main_shape": row, "max_abs_err": max_err,
         "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    return row, max_err


REACH_STARTS = 100      # starts a read in phase 3j (the reads' length)


def reach_alone(torch, didx, q, lens, read_idx, starts, min_intv,
                lib=None):
    """K-reach's C entry alone on preallocated buffers (``.buffers``), a
    launch not counted on the wrapper; ``lib`` as in ``ksa_alone``."""
    from tpubwa_torch.device import _build, occ
    lib = lib or _build.load("occ", occ._SIGNATURES)
    fm = didx.upload_fm()
    n = len(read_idx)
    ik = torch.empty((n, 3), dtype=didx.idt, device=q.device)
    e = torch.empty(n, dtype=didx.idt, device=q.device)
    queue = torch.empty(1, dtype=torch.int64, device=q.device)
    args = (fm["occ_blocks"].data_ptr(), fm["L2"].data_ptr(), didx.primary,
            didx.seq_len, int(didx.idt == torch.int64), q.data_ptr(),
            q.shape[1], lens.data_ptr(), read_idx.data_ptr(),
            starts.data_ptr(), min_intv.data_ptr(), ik.data_ptr(),
            e.data_ptr(), n, queue.data_ptr(), q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)

    def launch():
        if lib.tpubwa_rightmost_reach(*args):
            raise AssertionError("K-reach's launch failed")
    launch.buffers = (q, lens, read_idx, starts, min_intv, ik, e)
    return launch


def reach_rows(torch, np, didx, qd, ld, read_idx, starts, min_intv):
    """K-reach's shipped design on the host harness (csrc/occ_host.cpp,
    without the sanitizers) on these jobs: its results, its extension
    steps (one trip to memory each), the occ rows they load and the
    distinct rows, ascending."""
    from tpubwa_torch.device import warp_host
    fm = didx.upload_fm()
    one = np.zeros(1, didx.np_idt)
    arrays = {"occ_blocks": fm["occ_blocks"].cpu().numpy().view(np.uint32),
              "mark_rows": np.zeros((1, 8), np.uint32),
              "L2": fm["L2"].cpu().numpy(), "sa_marked": one,
              "sa_sample": one, "primary": didx.primary,
              "seq_len": didx.seq_len, "mark_D": 0}
    stats = {}
    ik, e = warp_host.reach_host(
        arrays, qd.cpu().numpy(), ld.cpu().numpy(),
        *(x.cpu().numpy() for x in (read_idx, starts, min_intv)),
        stats=stats, sanitize=False)
    return ik, e, stats


def reach_chains(np, q, lens, read_idx, starts, e, steps, seg):
    """The chained design's trips on these jobs, from the plain walk's
    results (e, and ``steps``, the extensions each job's own walk
    makes): a job linked to its right neighbour in its segment of
    ``seg`` (the same read, the next start; min_intv 1 throughout), whose
    neighbour matched and whose own first base is valid, makes one
    backward step, and walks forward as well where its e differs from
    the neighbour's; any other job walks forward.  Returns the trips a
    job, and of a segment (each a chain) the mean, 99th percentile and
    most, and the mean over warps (32 segments in a row) of their most,
    for which a warp's lanes wait."""
    n = len(e)
    idx = np.arange(n - 1)
    valid = (q[read_idx[:-1], np.clip(starts[:-1], 0, q.shape[1] - 1)] <= 3) \
        & (starts[:-1] < lens[read_idx[:-1]])
    back = ((read_idx[:-1] == read_idx[1:]) & (starts[:-1] + 1 == starts[1:])
            & (e[1:] > starts[1:]) & valid & ((idx + 1) % seg != 0))
    cost = steps.astype(np.int64).copy()
    cost[:-1] = np.where(back, 1 + np.where(e[:-1] != e[1:], steps[:-1], 0),
                         steps[:-1])
    per = np.add.reduceat(cost, np.arange(0, n, seg))
    warps = per[:len(per) // 32 * 32].reshape(-1, 32).max(1)
    return {"trips_a_job": round(float(cost.sum()) / n, 4),
            "segment_mean": round(float(per.mean()), 2),
            "segment_p99": float(np.percentile(per, 99)),
            "segment_max": int(per.max()),
            "warp_max_mean": round(float(warps.mean()), 2)}


def phase_reach(torch, np, megaq):
    """[3j K-reach]: (after 5c, whose first chunk it uses) K-reach ==
    rightmost_reach_plain over every start 0-99 of every read of 5c's
    first chunk on the 64 Mbp index (16,384 reads: 1,638,400 jobs,
    min_intv 1, read-major: one chain a read), int32, and int64 on its
    first 65,536 jobs; and on the same jobs shuffled with mixed min_intv
    (1, 1, 2, 3 or 8 a job: no job linked to its neighbour), and in read
    order with mixed min_intv (chains broken where it changes), int32.
    Then K-reach alone (its C entry) warm, in interleaved passes (the
    read-major jobs and the shuffled ones), and cold (after a 64 MB
    write), beside its plain version and its bound: the distinct sectors
    of the occ rows its plain version reads, or the shipped design's
    where fewer (counted on the host harness over every job), with its
    inputs and outputs.  With the steps a job of the plain walk (the
    first design's), the longest walk and the jobs that fail at once,
    and the shipped design's trips and occ rows, over the first 65,536
    jobs beside the plain walk's and over every job.  Returns (the
    row's case, its largest difference)."""
    from tpubwa_torch.device import smem
    from tpubwa_torch.scripts.exp_kernel_floor import interleaved_min
    from tpubwa_torch.scripts.exp_reach_forms import constant
    t0 = time.perf_counter()
    _, didx, qd, ld = megaq["chunk"]
    B = len(ld)
    dev = qd.device
    read_idx = torch.arange(B, dtype=torch.int32,
                            device=dev).repeat_interleave(REACH_STARTS)
    starts = torch.arange(REACH_STARTS, dtype=torch.int32,
                          device=dev).repeat(B)
    n = len(read_idx)
    facts = {"reads": B, "jobs": n, "L": qd.shape[1]}
    max_err = 0
    for dt, idx, k in (("int32", didx, n),
                       ("int64", int64_twin(torch, didx), min(n, 1 << 16))):
        mi = torch.ones(k, dtype=idx.idt, device=dev)
        args = (idx, qd, ld, read_idx[:k], starts[:k], mi)
        ik, e = smem.rightmost_reach(*args)
        torch.cuda.synchronize()
        stats = {}
        (pik, pe), plain_ms = timed_once(
            torch, lambda: smem.rightmost_reach_plain(*args, stats=stats))
        for what, got, want in (("ik", ik, pik), ("e", e, pe)):
            max_err = max(max_err, held_fm(torch, f"K-reach {what} ({dt})",
                                           got, want)[1])
        steps = stats["steps"]
        facts[dt] = {"jobs": k, "equal": True, "plain_ms": round(plain_ms, 3),
                     "steps_mean": round(float(steps.float().mean()), 3),
                     "longest_walk": stats["rounds"],
                     "fail_at_once": int((e == starts[:k]).sum())}
        # the occ rows the plain walk reads (the first 65,536 jobs' in
        # the int64 pass: the same arrays)
        facts[dt]["rows"] = torch.unique(stats["occ_rows"]).cpu().numpy()
        if dt == "int32":
            flat = (plain_ms, pik, pe, stats["steps"])
    plain_ms, pik, pe, steps = flat
    rows, first_rows = (facts[dt].pop("rows") for dt in ("int32", "int64"))
    # the shuffled jobs with mixed min_intv, and the read-major ones
    rng = np.random.default_rng(0x3A)
    perm = torch.from_numpy(rng.permutation(n)).to(dev)
    mixed = torch.from_numpy(rng.choice([1, 1, 2, 3, 8], n)).to(
        dev, didx.idt)
    other = {"shuffled_mixed_min_intv": (read_idx[perm], starts[perm],
                                          mixed[perm]),
             "mixed_min_intv": (read_idx, starts, mixed)}
    for name, (ri, st, mi) in other.items():
        ik, e = smem.rightmost_reach(didx, qd, ld, ri, st, mi)
        torch.cuda.synchronize()
        pik2, pe2 = smem.rightmost_reach_plain(didx, qd, ld, ri, st, mi)
        for what, got, want in (("ik", ik, pik2), ("e", e, pe2)):
            max_err = max(max_err, held_fm(torch, f"K-reach {what} ({name})",
                                           got, want)[1])
        facts[name] = {"jobs": n, "equal": True}
    mi = torch.ones(n, dtype=didx.idt, device=dev)
    fn = reach_alone(torch, didx, qd, ld, read_idx, starts, mi)
    shuffled = reach_alone(torch, didx, qd, ld,
                           *other["shuffled_mixed_min_intv"])
    best = interleaved_min({"reach": fn, "shuffled": shuffled}, 8, 4,
                           torch.device(DEV))
    ms = best["reach"]
    facts["shuffled_mixed_min_intv"]["ms"] = round(best["shuffled"], 4)
    cold = cold_ms(torch, fn, reps=4)
    _, _, _, _, _, ik_a, e_a = fn.buffers
    if not torch.equal(e_a, pe) or not torch.equal(ik_a, pik):
        raise AssertionError("K-reach alone wrote other results")
    # the shipped design's trips and rows on the host harness: the
    # first 65,536 jobs beside the plain walk's, then every job
    t1 = time.perf_counter()
    k = min(n, 1 << 16)
    hik, he, first = reach_rows(torch, np, didx, qd, ld, read_idx[:k],
                                starts[:k], mi[:k])
    if not (np.array_equal(hik, pik[:k].cpu().numpy())
            and np.array_equal(he, pe[:k].cpu().numpy())):
        raise AssertionError("K-reach on the host harness != plain")
    _, _, every = reach_rows(torch, np, didx, qd, ld, read_idx, starts, mi)
    facts["harness"] = {
        "first_jobs": k,
        "first": {"trips_a_job": round(first["steps"] / k, 4),
                  "row_loads": first["row_loads"],
                  "distinct_occ_rows": len(first["rows"]),
                  "plain_steps_a_job": facts["int64"]["steps_mean"],
                  "plain_distinct_occ_rows": len(first_rows)},
        "every": {"trips_a_job": round(every["steps"] / n, 4),
                  "row_loads": every["row_loads"],
                  "distinct_occ_rows": len(every["rows"])},
        # the same trips from the plain walk's results, a segment each
        "chains": reach_chains(
            np, qd.cpu().numpy(), ld.cpu().numpy(),
            *(x.cpu().numpy().astype(np.int64) for x in (
                read_idx, starts, pe, steps)), constant("kSeg")),
        "seconds": round(time.perf_counter() - t1, 1)}
    isz = 8 if didx.idt == torch.int64 else 4
    io = qd.numel() + 4 * len(ld) + 4 * 2 * n + isz * n + isz * 4 * n
    plain_bytes = fm_bytes(io, [(rows, OCC_ROW)])
    chain_bytes = fm_bytes(io, [(every["rows"], OCC_ROW)])
    case = {"n": n, "ms": round(ms, 4), "cold_ms": round(cold, 4),
            "plain_ms": round(plain_ms, 3), "distinct_occ_rows": len(rows),
            "chained_distinct_occ_rows": len(every["rows"]),
            "bytes": min(plain_bytes, chain_bytes),
            "bytes_from": ("plain walk" if plain_bytes <= chain_bytes
                           else "chained design"),
            "max_abs_err": max_err}
    facts.update(alone=case, seconds=round(time.perf_counter() - t0, 1))
    print("[3j K-reach==plain] " + json.dumps(facts), flush=True)
    return case, max_err


def kcur_checks(torch, np, label, fmi, arr, lens, opt):
    """K-cur == its plain version (on CPU copies of the index) in each
    instantiation, on ``arr``/``lens``: round-1 jobs, then the round-2
    jobs of the plain version's round-1 rows, each at 64 row slots a job
    and at one (most jobs take the second launch): rows, counts, and
    steps and chain a job.  Returns {rank type: facts}, with the plain
    versions' ms."""
    from tpubwa_torch.device import smem_cursor, smem_fused
    from tpubwa_torch.device.occ import DeviceIndex
    gpu = DeviceIndex.from_fmindex(fmi, DEV)
    cpu = DeviceIndex.from_fmindex(fmi, "cpu")
    q, ld = torch.from_numpy(arr), torch.from_numpy(lens)
    out = {}
    for dt in ("int32", "int64"):
        g, c = (gpu, cpu) if dt == "int32" else (int64_twin(torch, gpu),
                                                 int64_twin(torch, cpu))
        facts = {"reads": len(arr)}
        jobs = smem_cursor.round1_jobs(len(lens), c.idt, "cpu")
        for rnd in ("round1", "round2"):
            want_stats = {}
            t0 = time.perf_counter()
            want = smem_cursor.run_smem_jobs_plain(
                c, q, ld, jobs, opt.min_seed_len, stats=want_stats)
            plain_ms = (time.perf_counter() - t0) * 1e3
            second = 0
            for slots in (smem_fused.K2_SLOTS, 1):
                stats = {}
                got = smem_cursor.run_smem_jobs(
                    g, q.to(DEV), ld.to(DEV), tuple(x.to(DEV) for x in jobs),
                    opt.min_seed_len, slots=slots, stats=stats)
                torch.cuda.synchronize()
                for key in ("steps", "chain"):
                    if not torch.equal(stats[key].cpu(), want_stats[key]):
                        raise AssertionError(f"{label}/{dt} K-cur {rnd} "
                                             f"{key} (slots {slots}) != "
                                             "plain")
                for a, b, what in ((got[0], want[0], "rows"),
                                   (got[1], want[1], "counts")):
                    if a.shape != b.shape:
                        raise AssertionError(
                            f"{label}/{dt} K-cur {rnd} {what} (slots "
                            f"{slots}): {tuple(a.shape)}, plain "
                            f"{tuple(b.shape)}")
                    if len(a):
                        held_fm(torch, f"{label}/{dt} K-cur {rnd} {what} "
                                f"(slots {slots})",
                                a.cpu().reshape(len(a), -1),
                                b.reshape(len(b), -1))
                second = max(second, stats["second_launch_reads"])
            facts[rnd] = {"jobs": len(jobs[0]), "rows": len(want[0]),
                          "second_launch_jobs_at_1_slot": second,
                          "plain_ms": round(plain_ms, 3)}
            jobs = smem_cursor.round2_jobs(opt, *want)
        facts["mismatches"] = 0
        out[dt] = facts
    return out


def kcur_alone(torch, opt, didx, qd, ld, jobs, lib=None):
    """K-cur's C entry alone on preallocated buffers (every job of
    ``jobs``, the row slots of the first launch): a launch not counted
    on the wrapper.  The buffers live on the returned function
    (``.buffers``: the jobs, ids, queue, rows, counts, steps, chain)."""
    from tpubwa_torch.device import _build, smem_fused as sf
    lib = lib or _build.load("smem", sf._SIGNATURES)
    n, L = len(jobs[0]), qd.shape[1]
    ids = torch.arange(n, dtype=torch.int32, device=DEV)
    queue = torch.empty(1, dtype=torch.int32, device=DEV)
    rows = torch.empty((n, sf.K2_SLOTS, 5), dtype=didx.idt, device=DEV)
    counts, steps, chain = (torch.empty(n, dtype=torch.int32, device=DEV)
                            for _ in range(3))
    args = (*sf.index_args(didx), qd.data_ptr(), L, ld.data_ptr(),
            *(x.data_ptr() for x in jobs), ids.data_ptr(), n,
            opt.min_seed_len, sf.K2_SLOTS, queue.data_ptr(), rows.data_ptr(),
            counts.data_ptr(), steps.data_ptr(), chain.data_ptr(),
            qd.device.index, sf.stream_of(qd))

    def launch():
        if lib.tpubwa_smem_jobs(*args):
            raise AssertionError("K-cur's launch failed")
    launch.buffers = (jobs, ids, queue, rows, counts, steps, chain)
    return launch


def kcur_bytes(torch, np, didx, qd, ld, opt, jobs, out_rows):
    """The bytes a K-cur launch over ``jobs`` must move: the reads and
    lens, the jobs, the rows it writes (``out_rows``) and the counts,
    and the distinct sectors of the index it reads, counted by
    csrc/smem_host.cpp (built without the sanitizers) on the same
    inputs.  Returns (the bytes, the distinct occ rows)."""
    from tpubwa_torch.device import smem, smem_fused, warp_host
    fm = didx.upload_fm()
    arrays = {"occ_blocks": fm["occ_blocks"].cpu().numpy().view(np.uint32),
              "L2": fm["L2"].cpu().numpy(), "primary": didx.primary,
              "seq_len": didx.seq_len}
    B, L = qd.shape
    *_, rows = warp_host.smem_host(
        arrays, qd.cpu().numpy(), ld.cpu().numpy(), 2,
        (opt.min_seed_len, smem_fused.split_len_of(opt), opt.split_width,
         opt.max_mem_intv, smem.max_hits(L, opt.min_seed_len)),
        slots=smem_fused.K2_SLOTS, jobs=[x.cpu().numpy() for x in jobs],
        count_rows=True, sanitize=False)
    isz = 8 if didx.idt == torch.int64 else 4
    n = len(jobs[0])
    io = B * L + 4 * B + (4 + 4 + isz + 1) * n + out_rows * 5 * isz + 4 * n
    return fm_bytes(io, [(rows, OCC_ROW)]), len(rows)


def kcur_launch_facts(torch, L):
    """K-cur's launch at reads of L bases on this card, each rank type:
    the warps a block, the blocks and warps an SM the occupancy query
    allows, the bytes of a warp's stacks, the longest read it takes, and
    each instantiation's registers from ptxas."""
    from tpubwa_torch.device import _build, smem_cursor, smem_fused as sf
    lib = _build.load("smem", sf._SIGNATURES)
    launch = {}
    for dt in ("int32", "int64"):
        rc, shape = smem_cursor.kcur_shape(lib, dt == "int64", L,
                                           torch.cuda.current_device())
        if rc:
            raise AssertionError(f"K-cur refuses reads of {L} bases ({dt})")
        idt = torch.int64 if dt == "int64" else torch.int32
        if shape["max_len"] != smem_cursor.kcur_max_len(idt):
            raise AssertionError(f"K-cur's limit {shape['max_len']} != "
                                 f"kcur_max_len ({dt})")
        launch[dt] = dict(shape, warps_per_sm=shape["warps"]
                          * shape["blocks_per_sm"])
    report = _build.build_info["smem"]["ptxas"]
    return {"launch": launch,
            "ptxas": {dt: ptxas_usage(report, rf"smem_jobs_kernelI{m}E")
                      for dt, m in (("int32", "i"), ("int64", "l"))}}


def phase_kcur(torch, np, main, megaq):
    """[3k K-cur]: (after 5c, whose first chunk it uses) K-cur == its
    plain version in each instantiation, on round-1 jobs and on the
    round-2 jobs of their rows, at 64 row slots a job and at one, on the
    3,000-base genome and on 256 reads of 5c's first chunk with the edge
    reads (262 reads, as K2's plain check); then on that chunk (16,384
    reads, the launches mode cursor gives it): its rounds 1+2 merged ==
    K2's, and K-cur's round-1 and round-2 launches alone beside K2 alone
    in interleaved passes, with the steps and chain a job, the jobs that
    took a second launch, the distinct sectors of the index each launch
    reads (csrc/smem_host.cpp) and its bound, its launch shape and
    registers, and K2's and K3's SASS digests.  Returns the row's case
    (the round-1 launch)."""
    import tempfile
    from tpubwa_torch.device import smem, smem_cursor, smem_fused
    from tpubwa_torch.scripts.exp_kernel_floor import interleaved_min
    t0 = time.perf_counter()
    fmi, opt = main["fmi"], main["opt"]
    rng = np.random.default_rng(0xC0)
    with tempfile.TemporaryDirectory(dir=BUILD) as d:
        sm, _ = small_index(d)
    text = sm.bnt.doubled()
    small = [text[s:s + 100].copy()
             for s in rng.integers(0, len(text) - 100, 250)]
    for r in small[:100]:
        r[rng.integers(0, 100, 3)] = rng.integers(0, 5, 3)
    cases = {"3 kb": kcur_checks(torch, np, "3 kb", sm, *pack_reads(
        np, small + edge_reads(np, text, rng)), opt)}
    opt_, didx, qd, ld = megaq["chunk"]
    qn, lens = qd[:256].cpu().numpy(), ld[:256].cpu().numpy()
    big = [qn[i, :lens[i]] for i in range(256)]
    cases[f"{GENOME_MB} Mbp"] = kcur_checks(
        torch, np, f"{GENOME_MB} Mbp", fmi, *pack_reads(
            np, big + edge_reads(np, fmi.bnt.doubled(), rng)), opt)
    # the chunk: mode cursor's two launches, == K2's rows once merged
    r1 = smem_cursor.round1_jobs(len(ld), didx.idt, qd.device)
    s1, s2 = {}, {}
    rows1, n1 = smem_cursor.run_smem_jobs(didx, qd, ld, r1,
                                          opt_.min_seed_len, stats=s1)
    r2 = smem_cursor.round2_jobs(opt_, rows1, n1)
    rows2, n2 = smem_cursor.run_smem_jobs(didx, qd, ld, r2,
                                          opt_.min_seed_len, stats=s2)
    rows12, rids12 = smem_fused.rounds12_megaq(opt_, didx, qd, ld)
    torch.cuda.synchronize()
    cur = smem.merge_rounds(
        torch.cat([rows1, rows2]).cpu(), torch.cat([
            torch.repeat_interleave(torch.arange(len(ld), device=DEV),
                                    n1.long()),
            torch.repeat_interleave(r2[0].long(), n2.long())]).cpu())
    k2 = smem.merge_rounds(rows12.cpu(), rids12.cpu())
    if not (np.array_equal(cur[0], k2[0]) and np.array_equal(cur[1], k2[1])):
        raise AssertionError("K-cur's rounds 1+2 != K2's on 5c's first "
                             "chunk")
    alone = {"round1": kcur_alone(torch, opt_, didx, qd, ld, r1),
             "round2": kcur_alone(torch, opt_, didx, qd, ld, r2),
             "k2": k2_alone(torch, opt_, didx, qd, ld)}
    best = interleaved_min({
        **alone,
        "round1 wrapper": lambda: smem_cursor.run_smem_jobs(
            didx, qd, ld, r1, opt_.min_seed_len),
        "round2 wrapper": lambda: smem_cursor.run_smem_jobs(
            didx, qd, ld, r2, opt_.min_seed_len)}, 10, 4, torch.device(DEV))
    for name, stats, counts in (("round1", s1, n1), ("round2", s2, n2)):
        *_, got_counts, steps, chain = alone[name].buffers
        if not (torch.equal(got_counts, counts)
                and torch.equal(steps, stats["steps"])
                and torch.equal(chain, stats["chain"])):
            raise AssertionError(f"K-cur {name} alone != its wrapper's "
                                 "counts, steps and chain")
    t1 = time.perf_counter()
    launches = {}
    for name, jobs, stats, n_rows in (("round1", r1, s1, len(rows1)),
                                      ("round2", r2, s2, len(rows2))):
        steps, chain = (stats[k].cpu().numpy() for k in ("steps", "chain"))
        nbytes, n_occ = kcur_bytes(torch, np, didx, qd, ld, opt_, jobs,
                                   n_rows)
        launches[name] = {
            "jobs": len(jobs[0]), "rows": n_rows,
            "ms": round(best[name], 4),
            "wrapper_ms": round(best[f"{name} wrapper"], 4),
            "steps_mean": round(float(steps.mean()), 3),
            "steps_max": int(steps.max()),
            "chain_mean": round(float(chain.mean()), 3),
            "chain_max": int(chain.max()),
            "second_launch_jobs": stats["second_launch_reads"],
            "occ_rows_read": n_occ, "bytes": nbytes,
            "bound_ms": round(bytes_bound({"bytes": nbytes})[0], 6)}
    count_s = time.perf_counter() - t1
    plain = cases[f"{GENOME_MB} Mbp"]["int32"]
    one = launches["round1"]
    case = {"reads": len(ld), "jobs": len(r1[0]), "rows": len(rows1),
            "ms": one["ms"], "plain_ms": plain["round1"]["plain_ms"],
            "plain_reads": plain["reads"],
            "occ_rows_read": one["occ_rows_read"], "bytes": one["bytes"],
            "max_abs_err": 0, "bound_ms": one["bound_ms"]}
    print("[3k K-cur] " + json.dumps({
        "tolerance": 0, "cases": cases, "chunk": launches,
        "k2_ms": round(best["k2"], 4),
        "round1_over_k2": round(best["round1"] / best["k2"], 4),
        "rounds12_equal_k2": True, "main_launch": case,
        "count_rows_s": round(count_s, 1),
        "card": "the first chunk of 5c (16,384 reads)",
        **kcur_launch_facts(torch, qd.shape[1]),
        "sass_digest": seeding_digest(),
        "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    return case


def ksplit_checks(torch, np, label, fmi, arr, lens, opt):
    """K-fwd and K-bwd == their plain versions (on CPU copies of the
    index) in each instantiation, on ``arr``/``lens``: round-1 jobs, then
    the round-2 jobs of the plain round-1 rows; K-fwd at FWD_SLOTS stack
    intervals a job and at one (every job takes the second launch): its
    calls (job, x, m, ret), stacks, and steps and chain a job; K-bwd on
    the plain version's calls: rows, counts, and steps and chain a call;
    and forward then backward == K-cur's rows on the card.  Returns {rank
    type: facts}, with the plain versions' ms."""
    from tpubwa_torch.device import smem_cursor, smem_split
    from tpubwa_torch.device.occ import DeviceIndex
    gpu = DeviceIndex.from_fmindex(fmi, DEV)
    cpu = DeviceIndex.from_fmindex(fmi, "cpu")
    q, ld = torch.from_numpy(arr), torch.from_numpy(lens)
    qg, lg = q.to(DEV), ld.to(DEV)
    out = {}
    for dt in ("int32", "int64"):
        g, c = (gpu, cpu) if dt == "int32" else (int64_twin(torch, gpu),
                                                 int64_twin(torch, cpu))
        facts = {"reads": len(arr)}
        jobs = smem_cursor.round1_jobs(len(lens), c.idt, "cpu")
        for rnd in ("round1", "round2"):
            tag = f"{label}/{dt} {rnd}"
            fst, bst = {}, {}
            t0 = time.perf_counter()
            calls = smem_split.run_fwd_plain(c, q, ld, jobs, stats=fst)
            t1 = time.perf_counter()
            bcalls = smem_split.bwd_calls(jobs, calls)
            rows, n = smem_split.run_bwd_plain(c, q, ld, *bcalls, calls.stack,
                                               opt.min_seed_len, stats=bst)
            fwd_ms, bwd_ms = ((t1 - t0) * 1e3,
                              (time.perf_counter() - t1) * 1e3)
            gjobs = tuple(x.to(DEV) for x in jobs)
            second = 0
            for slots in (smem_split.FWD_SLOTS, 1):
                stats = {}
                got = smem_split.run_fwd(g, qg, lg, gjobs, slots=slots,
                                         stats=stats)
                torch.cuda.synchronize()
                for key in ("job", "x", "m", "ret", "stack"):
                    a, b = getattr(got, key).cpu(), getattr(calls, key)
                    if a.shape != b.shape or not torch.equal(a, b):
                        raise AssertionError(f"{tag} K-fwd {key} (slots "
                                             f"{slots}) != plain")
                for key in ("steps", "chain"):
                    if not torch.equal(stats[key].cpu(), fst[key]):
                        raise AssertionError(f"{tag} K-fwd {key} != plain")
                second = max(second, stats["second_launch_jobs"])
            stats = {}
            grows, gn = smem_split.run_bwd(
                g, qg, lg, *(x.to(DEV) for x in bcalls),
                calls.stack.to(DEV), opt.min_seed_len, stats=stats)
            torch.cuda.synchronize()
            if not (torch.equal(gn.cpu(), n)
                    and torch.equal(grows.cpu(), rows)):
                raise AssertionError(f"{tag} K-bwd rows != plain")
            for key in ("steps", "chain"):
                if not torch.equal(stats[key].cpu(), bst[key]):
                    raise AssertionError(f"{tag} K-bwd {key} != plain")
            kcur = smem_cursor.run_smem_jobs(g, qg, lg, gjobs,
                                             opt.min_seed_len)
            split = smem_split.run_split(g, qg, lg, gjobs, opt.min_seed_len)
            if not all(torch.equal(a, b) for a, b in zip(kcur, split)):
                raise AssertionError(f"{tag}: K-fwd + K-bwd != K-cur")
            counts = torch.zeros(len(jobs[0]), dtype=torch.int64).index_add_(
                0, calls.job, n.long())
            facts[rnd] = {"jobs": len(jobs[0]), "calls": len(calls.job),
                          "stack_intervals": len(calls.stack),
                          "rows": len(rows),
                          "second_launch_jobs_at_1_slot": second,
                          "fwd_plain_ms": round(fwd_ms, 3),
                          "bwd_plain_ms": round(bwd_ms, 3)}
            jobs = smem_cursor.round2_jobs(opt, rows, counts.int())
        facts["mismatches"] = 0
        out[dt] = facts
    return out


def kfwd_alone(torch, didx, qd, ld, jobs, lib=None):
    """K-fwd's C entry alone on preallocated buffers (every job of
    ``jobs``, FWD_SLOTS stack intervals a job): a launch not counted on
    the wrapper.  ``.buffers``: the jobs, ids, queue, stack, calls,
    n_calls, n_intv, steps, chain."""
    from tpubwa_torch.device import _build, smem_fused as sf, smem_split
    lib = lib or _build.load("smem", sf._SIGNATURES)
    n, L, S = len(jobs[0]), qd.shape[1], smem_split.FWD_SLOTS
    ids = torch.arange(n, dtype=torch.int32, device=DEV)
    queue = torch.empty(1, dtype=torch.int32, device=DEV)
    stack = torch.empty((n, S, 4), dtype=didx.idt, device=DEV)
    calls = torch.empty((n, S, 3), dtype=torch.int32, device=DEV)
    per_job = [torch.empty(n, dtype=torch.int32, device=DEV)
               for _ in range(4)]
    args = (*sf.index_args(didx), qd.data_ptr(), L, ld.data_ptr(),
            *(x.data_ptr() for x in jobs), ids.data_ptr(), n, S,
            queue.data_ptr(), stack.data_ptr(), calls.data_ptr(),
            *(x.data_ptr() for x in per_job), qd.device.index,
            sf.stream_of(qd))

    def launch():
        if lib.tpubwa_smem_fwd(*args):
            raise AssertionError("K-fwd's launch failed")
    launch.buffers = (jobs, ids, queue, stack, calls, *per_job)
    return launch


def kbwd_alone(torch, didx, qd, ld, calls, stack, min_seed_len, lib=None):
    """K-bwd's C entry alone on preallocated buffers, over ``calls`` =
    (read, x, m, min_intv) and their ``stack``: a launch not counted on
    the wrapper.  ``.buffers``: the calls, offsets, stack, queue, rows,
    counts, steps, chain."""
    from tpubwa_torch.device import _build, smem_fused as sf
    lib = lib or _build.load("smem", sf._SIGNATURES)
    read, x, m, mi = calls
    n, L = len(read), qd.shape[1]
    off = torch.cumsum(m.long(), 0) - m.long()
    queue = torch.empty(1, dtype=torch.int32, device=DEV)
    rows = torch.empty((len(stack), 5), dtype=didx.idt, device=DEV)
    counts, steps, chain = (torch.empty(n, dtype=torch.int32, device=DEV)
                            for _ in range(3))
    args = (*sf.index_args(didx), qd.data_ptr(), L, read.data_ptr(),
            x.data_ptr(), m.data_ptr(), off.data_ptr(), mi.data_ptr(),
            stack.data_ptr(), n, min_seed_len, queue.data_ptr(),
            rows.data_ptr(), counts.data_ptr(), steps.data_ptr(),
            chain.data_ptr(), qd.device.index, sf.stream_of(qd))

    def launch():
        if lib.tpubwa_smem_bwd(*args):
            raise AssertionError("K-bwd's launch failed")
    launch.buffers = (calls, off, stack, queue, rows, counts, steps, chain)
    return launch


def ksplit_bytes(torch, np, didx, qd, ld, opt, jobs, calls, n_rows):
    """The bytes K-fwd's launch over ``jobs`` and K-bwd's over the
    ``calls`` it records must move: each one's inputs and outputs (the
    reads, jobs or calls, stacks, calls, rows and counts), and the
    distinct sectors of the index it reads, counted by csrc/smem_host.cpp
    (built without the sanitizers) on the same inputs.  Returns {"fwd":
    (bytes, occ rows), "bwd": (bytes, occ rows)}."""
    from tpubwa_torch.device import smem_split, warp_host
    fm = didx.upload_fm()
    arrays = {"occ_blocks": fm["occ_blocks"].cpu().numpy().view(np.uint32),
              "L2": fm["L2"].cpu().numpy(), "primary": didx.primary,
              "seq_len": didx.seq_len}
    qn, lens = qd.cpu().numpy(), ld.cpu().numpy()
    B, L = qn.shape
    isz = 8 if didx.idt == torch.int64 else 4
    n, c, s = len(jobs[0]), len(calls.job), len(calls.stack)
    *_, fwd_rows = warp_host.fwd_host(
        arrays, qn, lens, [x.cpu().numpy() for x in jobs],
        smem_split.FWD_SLOTS, count_rows=True, sanitize=False)
    *_, bwd_rows = warp_host.bwd_host(
        arrays, qn, lens, [x.cpu().numpy() for x in
                           smem_split.bwd_calls(jobs, calls)],
        calls.stack.cpu().numpy(), opt.min_seed_len, count_rows=True,
        sanitize=False)
    reads = B * L + 4 * B
    fwd_io = (reads + (4 + 4 + isz + 1 + 4) * n + 4 * isz * s + 3 * 4 * c
              + 4 * 4 * n)
    bwd_io = (reads + (4 + 4 + 4 + 8 + isz) * c + 4 * isz * s
              + 5 * isz * n_rows + 4 * c)
    return {"fwd": (fm_bytes(fwd_io, [(fwd_rows, OCC_ROW)]), len(fwd_rows)),
            "bwd": (fm_bytes(bwd_io, [(bwd_rows, OCC_ROW)]), len(bwd_rows))}


def ksplit_launch_facts(torch, L, units, forms):
    """K-fwd's and K-bwd's launches at reads of L bases on this card, over
    ``units`` ({"fwd": jobs, "bwd": calls}), in each form of ``forms``
    ({form: (its library, its ptxas report, its sources)}) and rank type:
    the lanes a job or call (G) and an interval, a call's stack slots, a
    block's threads and shared bytes, the blocks, warps and units in
    flight an SM, the grid, the longest read; and each instantiation's
    registers and spills."""
    from tpubwa_torch.device import smem_split
    launch, regs = {}, {}
    for form, (lib, report, csrc) in forms.items():
        names = split_kernels(csrc)
        for kind, name in enumerate(("fwd", "bwd")):
            for dt, m in (("int32", "i"), ("int64", "l")):
                idt = torch.int64 if dt == "int64" else torch.int32
                rc, shape = smem_split.ksplit_shape(
                    lib, kind, dt == "int64", L, units[name],
                    torch.cuda.current_device())
                if rc:
                    raise AssertionError(f"K-{name} ({form}) refuses reads "
                                         f"of {L} bases ({dt})")
                if kind and shape["max_len"] != smem_split.ksplit_max_len(
                        idt):
                    raise AssertionError(f"K-bwd's limit {shape['max_len']}"
                                         f" != ksplit_max_len ({dt})")
                per_sm = shape["blocks_per_sm"] * shape["threads"]
                launch[f"{form} {name}/{dt}"] = dict(
                    shape, warps_per_sm=per_sm // 32,
                    units_per_sm=per_sm // shape["group"])
                regs[f"{form} {name}/{dt}"] = ptxas_usage(
                    report, names[f"smem_{name}"].format(m))
    return {"launch": launch, "ptxas": regs}


def phase_ksplit(torch, np, main, megaq):
    """[3l K-fwd/K-bwd]: (after 3k, on 5c's first chunk) K-fwd and K-bwd
    == their plain versions in each instantiation (``ksplit_checks``) on
    the 3,000-base genome and on 256 reads of 5c's first chunk with the
    edge reads (262 reads, as 3k); then mode split's four launches on the
    chunk (16,384 round-1 jobs, then the round-2 jobs of their rows):
    each round's rows == K-cur's on the same jobs, and each launch alone
    (K-fwd beside its g32 form, a warp a job, the first design's layout:
    ``split_form``, held to the same results) beside K-cur's two and K2's
    one, in interleaved passes;
    with the calls a job, m a call, a job's forward chain and a call's
    backward chain, the jobs that took K-fwd's second launch, the
    distinct sectors of the index each launch reads (csrc/smem_host.cpp)
    and its bound, the launch shapes (lanes a unit, units and warps an
    SM) and registers of both of K-fwd's forms, and the SASS of K2, K2-tp,
    K3 and
    K-cur held to ``KEPT_DIGEST``.  Returns {"fwd": K-fwd's row case,
    "bwd": K-bwd's}, their round-1 launches."""
    import tempfile
    from tpubwa_torch.device import _build, smem_cursor, smem_split
    from tpubwa_torch.device import smem_fused as sf
    from tpubwa_torch.scripts.exp_kernel_floor import interleaved_min
    t0 = time.perf_counter()
    fmi, opt = main["fmi"], main["opt"]
    rng = np.random.default_rng(0xC1)
    with tempfile.TemporaryDirectory(dir=BUILD) as d:
        sm, _ = small_index(d)
    text = sm.bnt.doubled()
    small = [text[s:s + 100].copy()
             for s in rng.integers(0, len(text) - 100, 250)]
    for r in small[:100]:
        r[rng.integers(0, 100, 3)] = rng.integers(0, 5, 3)
    cases = {"3 kb": ksplit_checks(torch, np, "3 kb", sm, *pack_reads(
        np, small + edge_reads(np, text, rng)), opt)}
    opt_, didx, qd, ld = megaq["chunk"]
    qn, lens = qd[:256].cpu().numpy(), ld[:256].cpu().numpy()
    big = [qn[i, :lens[i]] for i in range(256)]
    cases[f"{GENOME_MB} Mbp"] = ksplit_checks(
        torch, np, f"{GENOME_MB} Mbp", fmi, *pack_reads(
            np, big + edge_reads(np, fmi.bnt.doubled(), rng)), opt)
    # the chunk: mode split's launches, each round == K-cur's
    msl = opt_.min_seed_len
    jobs = smem_cursor.round1_jobs(len(ld), didx.idt, qd.device)
    rounds = {}
    for name in ("round1", "round2"):
        fst, bst = {}, {}
        calls = smem_split.run_fwd(didx, qd, ld, jobs, stats=fst)
        bcalls = smem_split.bwd_calls(jobs, calls)
        rows, n = smem_split.run_bwd(didx, qd, ld, *bcalls, calls.stack, msl,
                                     stats=bst)
        counts = torch.zeros(len(jobs[0]), dtype=torch.int64,
                             device=qd.device).index_add_(0, calls.job,
                                                          n.long()).int()
        kcur = smem_cursor.run_smem_jobs(didx, qd, ld, jobs, msl)
        torch.cuda.synchronize()
        if not (torch.equal(rows, kcur[0]) and torch.equal(counts, kcur[1])):
            raise AssertionError(f"K-fwd + K-bwd != K-cur on 5c's first "
                                 f"chunk, {name}")
        rounds[name] = (jobs, calls, bcalls, rows, n, fst, bst)
        jobs = smem_cursor.round2_jobs(opt_, rows, counts)
    g32, g32_src = split_form("g32")
    alone = {"k2": k2_alone(torch, opt_, didx, qd, ld)}
    for name, (jobs, calls, bcalls, *_) in rounds.items():
        for form, lib in (("", None), (" g32", g32)):
            alone[f"fwd{form} {name}"] = kfwd_alone(torch, didx, qd, ld,
                                                    jobs, lib=lib)
        alone[f"bwd {name}"] = kbwd_alone(torch, didx, qd, ld, bcalls,
                                          calls.stack, msl)
        alone[f"kcur {name}"] = kcur_alone(torch, opt_, didx, qd, ld, jobs)
    for fn in alone.values():
        fn()
    torch.cuda.synchronize()
    best = interleaved_min(alone, 10, 4, torch.device(DEV))
    t1 = time.perf_counter()
    launches = {}
    for name, (jobs, calls, bcalls, rows, n, fst, bst) in rounds.items():
        per_job = torch.bincount(calls.job, minlength=len(jobs[0])).int()
        bb = alone[f"bwd {name}"].buffers
        if not (torch.equal(bb[5], n)
                and torch.equal(smem_split.call_rows(bb[4], bb[5], calls.m),
                                rows)
                and torch.equal(bb[6], bst["steps"])
                and torch.equal(bb[7], bst["chain"])):
            raise AssertionError(f"K-bwd alone != the wrapper's ({name})")
        for form in ("", " g32"):
            fb = alone[f"fwd{form} {name}"].buffers
            if not (torch.equal(fb[5], per_job)
                    and torch.equal(fb[6], torch.bincount(
                        calls.job, weights=calls.m.double(),
                        minlength=len(jobs[0])).int())
                    and torch.equal(fb[7], fst["steps"])
                    and torch.equal(fb[8], fst["chain"])):
                raise AssertionError(f"K-fwd{form} alone != the wrapper's "
                                     f"({name})")
        got = ksplit_bytes(torch, np, didx, qd, ld, opt_, jobs, calls,
                           len(rows))
        m = calls.m.cpu().numpy()
        cj = per_job.cpu().numpy()
        fch, bch = (s["chain"].cpu().numpy() for s in (fst, bst))
        fb = {k: round(best[f"fwd{f} {name}"], 4)
              for k, f in (("fwd_ms", ""), ("fwd_g32_ms", " g32"))}
        launches[name] = {
            "jobs": len(jobs[0]), "calls": len(m), "rows": len(rows),
            **fb, "bwd_ms": round(best[f"bwd {name}"], 4),
            "kcur_ms": round(best[f"kcur {name}"], 4),
            "fwd_over_g32": round(fb["fwd_ms"] / fb["fwd_g32_ms"], 4),
            "split_over_kcur": round((best[f"fwd {name}"]
                                      + best[f"bwd {name}"])
                                     / best[f"kcur {name}"], 4),
            "calls_a_job_mean": round(float(cj.mean()), 4),
            "calls_a_job_max": int(cj.max()),
            "m_a_call_mean": round(float(m.mean()), 4),
            "m_a_call_max": int(m.max()),
            "fwd_chain_a_job_mean": round(float(fch.mean()), 3),
            "fwd_chain_a_job_max": int(fch.max()),
            "bwd_chain_a_call_mean": round(float(bch.mean()), 3),
            "bwd_chain_a_call_max": int(bch.max()),
            "second_launch_jobs": fst["second_launch_jobs"],
            "fwd_occ_rows_read": got["fwd"][1], "fwd_bytes": got["fwd"][0],
            "fwd_bound_ms": round(bytes_bound({"bytes": got["fwd"][0]})[0],
                                  6),
            "bwd_occ_rows_read": got["bwd"][1], "bwd_bytes": got["bwd"][0],
            "bwd_bound_ms": round(bytes_bound({"bytes": got["bwd"][0]})[0],
                                  6)}
    count_s = time.perf_counter() - t1
    plain = cases[f"{GENOME_MB} Mbp"]["int32"]["round1"]
    one = launches["round1"]
    rows = {k: {"reads": len(ld), "jobs": one["jobs"], "calls": one["calls"],
                "ms": one[f"{k}_ms"], "plain_ms": plain[f"{k}_plain_ms"],
                "plain_reads": cases[f"{GENOME_MB} Mbp"]["int32"]["reads"],
                "occ_rows_read": one[f"{k}_occ_rows_read"],
                "bytes": one[f"{k}_bytes"], "max_abs_err": 0,
                "bound_ms": one[f"{k}_bound_ms"]} for k in ("fwd", "bwd")}
    digest = seeding_digest(kernels=("smem_rounds12", "smem_rounds12_tp",
                                     "seed_strategy", "smem_jobs"))
    if digest != KEPT_DIGEST:
        raise AssertionError(f"K2's, K2-tp's, K3's or K-cur's SASS moved: "
                             f"{digest} != {KEPT_DIGEST}")
    forms = {"shipped": (_build.load("smem", sf._SIGNATURES),
                         _build.build_info["smem"]["ptxas"], None),
             "g32": (g32, _build.build_info[str(g32_src)]["ptxas"], g32_src)}
    print("[3l K-fwd/K-bwd] " + json.dumps({
        "tolerance": 0, "cases": cases, "chunk": launches,
        "k2_ms": round(best["k2"], 4), "rounds_equal_kcur": True,
        "g32_equal_shipped": True, "main_launches": rows,
        "count_rows_s": round(count_s, 1),
        "card": "the first chunk of 5c (16,384 reads)",
        **ksplit_launch_facts(torch, qd.shape[1],
                              {"fwd": one["jobs"], "bwd": one["calls"]},
                              forms),
        "kept_digest_equal": True,
        "sass_digest": seeding_digest(kernels=("smem_fwd", "smem_bwd")),
        "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    return rows


def mode_counts(reset=False):
    """{kernel: its wrapper's launches} of the kernels a seed mode may
    launch (set to 0 first where ``reset``)."""
    from tpubwa_torch.device import extend_kernel as ek
    from tpubwa_torch.device import (occ, smem, smem_cursor, smem_fused,
                                     smem_split)
    fns = {"rightmost_reach": smem.rightmost_reach,
           "smem_jobs": smem_cursor.run_smem_jobs,
           "smem_fwd": smem_split.run_fwd, "smem_bwd": smem_split.run_bwd,
           "seed_strategy": smem._seed_strategy_scan,
           "smem_rounds12": smem_fused.rounds12_megaq,
           "sa_lookup": occ.sa_lookup, "ksw_extend": ek.extend_batch}
    if reset:
        for fn in fns.values():
            fn.launches = 0
    return {k: fn.launches for k, fn in fns.items()}


def reach_launch_case(torch, np, didx, qd, ld, jobs):
    """One of mode reach's K-reach launches on these jobs (read_idx,
    starts, min_intv): the wrapper == rightmost_reach_plain on the same
    inputs (tolerance 0), the plain version's ms and steps a job, and on
    the host harness (csrc/occ_host.cpp) the shipped design's results
    (== plain), its trips a job and the distinct occ rows it reads; the
    chained trips a segment from the plain walk (``reach_chains``), and
    the bytes the launch must move: its inputs and outputs and the
    distinct sectors of the occ rows, the plain walk's or the chained
    design's where fewer.  Returns (the case, the plain (ik, e))."""
    from tpubwa_torch.device import smem
    from tpubwa_torch.scripts.exp_reach_forms import constant
    n = len(jobs[0])
    ik, e = smem.rightmost_reach(didx, qd, ld, *jobs)
    torch.cuda.synchronize()
    stats = {}
    (pik, pe), plain_ms = timed_once(
        torch, lambda: smem.rightmost_reach_plain(didx, qd, ld, *jobs,
                                                  stats=stats))
    err = max(held_fm(torch, f"K-reach {what} ({n:,} jobs)", got, want)[1]
              for what, got, want in (("ik", ik, pik), ("e", e, pe)))
    rows = torch.unique(stats["occ_rows"]).cpu().numpy()
    hik, he, harness = reach_rows(torch, np, didx, qd, ld, *jobs)
    if not (np.array_equal(hik, pik.cpu().numpy())
            and np.array_equal(he, pe.cpu().numpy())):
        raise AssertionError(f"K-reach on the host harness != plain ({n:,} "
                             "jobs)")
    isz = 8 if didx.idt == torch.int64 else 4
    io = qd.numel() + 4 * len(ld) + 4 * 2 * n + isz * n + isz * 4 * n
    plain_bytes = fm_bytes(io, [(rows, OCC_ROW)])
    chain_bytes = fm_bytes(io, [(harness["rows"], OCC_ROW)])
    ri, st, steps = (x.cpu().numpy().astype(np.int64)
                     for x in (jobs[0], jobs[1], stats["steps"]))
    case = {"n": n, "plain_ms": round(plain_ms, 3),
            "plain_steps_a_job": round(float(steps.mean()), 4),
            "fail_at_once": int((pe.long() == jobs[1].long()).sum()),
            "trips_a_job": round(harness["steps"] / n, 4),
            "row_loads": harness["row_loads"],
            "chains": reach_chains(np, qd.cpu().numpy(), ld.cpu().numpy(), ri,
                                   st, pe.cpu().numpy().astype(np.int64),
                                   steps, constant("kSeg")),
            "distinct_occ_rows": len(rows),
            "chained_distinct_occ_rows": len(harness["rows"]),
            "bytes": min(plain_bytes, chain_bytes),
            "bytes_from": ("plain walk" if plain_bytes <= chain_bytes
                           else "chained design"),
            "max_abs_err": err}
    return case, (pik, pe)


# each device mode of 5k: the seeding kernels of its rounds 1 and 2, each
# with its most launches a round (None: a second launch re-runs the units
# past their slots)
MODE_KERNELS = {"reach": {"rightmost_reach": 1},
                "cursor": {"smem_jobs": None}, "fused": {"smem_jobs": None},
                "mega": {"smem_rounds12": None},
                "split": {"smem_fwd": None, "smem_bwd": 1}}


def phase_seed_modes(torch, np, main, megaq):
    """[5k seed modes]: phase 5's 2 x 8,192 pairs through the port's
    aligner on cuda with TPUBWA_SEED_MODE=reach, =cursor, =mega, =fused
    and =split in turn, each after a 1,024-pair warm-up and with the
    counts at 0 just before the run: reach seeds rounds 1 and 2 on
    K-reach (two launches a chunk), cursor and fused on K-cur (two or
    more a chunk), mega on K2 (one or more a chunk), split on K-fwd (two
    or more a chunk) and K-bwd (two a chunk), all round 3 on K3 (one a
    chunk); none launches another seeding kernel (``MODE_KERNELS``), and
    the SA stage walks every row (no fused walk).  Each SAM must equal
    phase 5's byte for byte.  Reads/s and the seeding stage's wall
    beside phase 5's and 5c's, and each mode's launches.  Then mode
    reach's two K-reach launches on 5c's first chunk (the same reads and
    packing as the modes' first chunk): round 1 (every (read, column))
    and round 2 (every start 0..x of every job), each == its plain
    version on the same inputs, alone in interleaved passes, with its
    bound (``reach_launch_case``).  Returns ({mode: its launches}, the
    round-1 launch's case for the kernels line)."""
    from tpubwa_torch.device import smem
    from tpubwa_torch.host.pipeline import process_batches
    from tpubwa_torch.scripts.exp_kernel_floor import interleaved_min
    from tpubwa_torch.sim import simulate_pe
    t0 = time.perf_counter()
    fmi, opt, batches = main["fmi"], main["opt"], main["batches"]
    n_reads = sum(len(b) for b in batches)
    warm = simulate_pe(fmi.bnt, 1024, 100, np.random.default_rng(2))
    facts, launches = {}, {}
    seeding_kernels = {k for ks in MODE_KERNELS.values() for k in ks}
    for mode, own in MODE_KERNELS.items():
        aligner = seed_aligner(opt, fmi, mode)
        for _ in process_batches(opt, fmi, iter([warm]), 0,
                                 align_fn=aligner):
            pass
        mode_counts(reset=True)
        torch.cuda.synchronize()
        with SeedTimer(torch) as seeding:
            t1 = time.perf_counter()
            lines = [l for _, ls in process_batches(
                opt, fmi, iter(batches), 0, align_fn=aligner) for l in ls]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
        got = mode_counts()
        if lines != main["sam"]:
            raise AssertionError(f"5k {mode} SAM != phase 5's ({len(lines)} "
                                 f"vs {len(main['sam'])} lines, first diff "
                                 f"{sam_diff(lines, main['sam'])})")
        calls = seeding.calls
        # a launch a chunk for mega's one dispatch, else a launch a round
        # (round 2 in at least one chunk)
        rounds = 1 if mode == "mega" else 2
        least = calls if rounds == 1 else calls + 1
        if (any(got[k] < least or (cap and got[k] > cap * rounds * calls)
                for k, cap in own.items())
                or any(got[k] for k in seeding_kernels - set(own))
                or got["sa_lookup"] or got["seed_strategy"] != calls):
            raise AssertionError(f"5k {mode} launched {got} in {calls} "
                                 "chunks")
        launches[mode] = got
        facts[mode] = {"reads": n_reads, "seconds": round(dt, 3),
                       "reads_per_s": round(n_reads / dt, 1),
                       "seeding_s": round(seeding.s, 3),
                       "seeding_calls": calls, "launches": got,
                       "sam_lines": len(lines), "sam_equal_to_phase5": True}
    # mode reach's two K-reach launches on the first chunk
    opt_, didx, qd, ld = megaq["chunk"]
    B, L = qd.shape
    rows1, rids1 = smem.reach_round1(didx, qd, ld, opt_.min_seed_len)
    rid, x, mi = smem.reseed_jobs(opt_, rows1, rids1)
    jobs = {"round1": smem.reach_jobs(B, L, didx.idt, qd.device),
            "round2": smem.reseed_starts(rid, x, mi)[:3]}
    t1 = time.perf_counter()
    cases, want = {}, {}
    for name, j in jobs.items():
        cases[name], want[name] = reach_launch_case(torch, np, didx, qd, ld,
                                                    j)
    checks_s = time.perf_counter() - t1
    alone = {name: reach_alone(torch, didx, qd, ld, *j)
             for name, j in jobs.items()}
    best = interleaved_min(alone, 8, 4, torch.device(DEV))
    for name, fn in alone.items():
        if not all(torch.equal(a, b) for a, b in zip(fn.buffers[5:],
                                                     want[name])):
            raise AssertionError(f"K-reach alone on {name}'s jobs != plain")
        cases[name]["ms"] = round(best[name], 4)
        cases[name]["bound_ms"] = round(bytes_bound(cases[name])[0], 6)
    cases["round2"]["re_seeded_rows"] = len(rid)
    facts["reach_alone"] = dict(reads=B, L=L, tolerance=0,
                                checks_s=round(checks_s, 1), **cases)
    facts.update(phase5={"reads_per_s": round(main["reads_per_s"], 1),
                         "seeding_s": round(main["seeding_s"], 3)},
                 megaq_5c={"reads_per_s": megaq["reads_per_s"],
                           "seeding_s": megaq["seeding_s"]},
                 seconds=round(time.perf_counter() - t0, 1))
    print("[5k seed modes] " + json.dumps(facts), flush=True)
    return launches, cases["round1"]


def phase_entry(torch, np):
    """[6 entry]: tpubwa_torch.entry's step on the card (K-reach, K-sa and
    K1-mat under the step's matrix), with those three counts at 0 just
    before it; e, pos and score must equal the same step on the CPU (every
    kernel's plain version), and each kernel must launch.  Returns the
    launches."""
    from tpubwa_torch import entry
    from tpubwa_torch.device import extend_kernel as ek
    from tpubwa_torch.device import occ, smem
    step, args = entry.entry(DEV)
    counts = {"rightmost_reach": (smem.rightmost_reach, "launches"),
              "sa_lookup": (occ.sa_lookup, "launches"),
              "ksw_extend_mat": (ek.extend_batch, "mat_launches")}
    for fn, attr in counts.values():
        setattr(fn, attr, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = step(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counts.items()}
    if not all(launches.values()):
        raise AssertionError(f"6 entry launched {launches}")
    cpu_step, cpu_args = entry.entry("cpu")
    want = cpu_step(*cpu_args)
    for name, g, w in zip(("e", "pos", "score"), got, want):
        if not torch.equal(g.cpu(), w):
            bad = (g.cpu() != w).nonzero()[:3, 0].tolist()
            raise AssertionError(f"6 entry: {name} != plain at {bad}")
    print("[6 entry] " + json.dumps({
        "shapes": [list(g.shape) for g in got], "equal_to_plain": True,
        "launches": launches, "first_call_s": round(wall, 4),
        "step_ms": round(cuda_ms(lambda: step(*args), 10), 4)}), flush=True)
    return launches


WAVES_READS = 2048      # phase 5j: the first 1,024 pairs of phase 5


def _regs_key(regs_per_read):
    """The regions of each read, as the fields the planner computed."""
    return [[(r.rb, r.re, r.qb, r.qe, r.rid, r.score, r.truesc, r.sub,
              r.csub, r.w, r.seedcov, r.seedlen0, r.frac_rep) for r in regs]
            for regs in regs_per_read]


def phase_waves_plain(torch, np, main):
    """[5j waves-plain]: the first 2,048 reads of phase 5's first batch.
    (a) Seeded and chained by the aligner's host stages, then extended by
    ``WaveExtender.run`` (the plain waves) over ``extension_plan()``
    generators (per-side jobs, 512-job blocks through
    extend_batch_kernel_np) under
    bwa_fill_scmat's matrix (K1) and the transition/transversion one
    (K1-mat): each run's regions must equal the scalar path's
    (``host/regions.py:chain2aln``) under its matrix.  (b) `mem`'s path
    (process_batches) with the aligner on cuda under the
    transition/transversion matrix: the non-descriptor route, sequence-
    tile jobs through extend_seed_batch_np on K1-mat; its SAM must equal
    the same run with that extension through tpubwa's route for such a
    matrix, the scalar trial loops (``extend_fused.scalar_fused`` over the
    native ksw_extend).  The counts at 0 just before each run; K1-mat
    must launch in (a) under tt and in (b), and not in (b)'s scalar run.
    Returns {"ksw_extend": K1's launches, "ksw_extend_mat": K1-mat's}."""
    from tpubwa_torch.device import dispatch
    from tpubwa_torch.device import extend_kernel as ek
    from tpubwa_torch.device import pipeline as dp
    from tpubwa_torch.device.dispatch import WaveExtender
    from tpubwa_torch.device.extend_fused import scalar_fused
    from tpubwa_torch.host.native_emit import chain_batch_native
    from tpubwa_torch.host.pipeline import process_batches
    from tpubwa_torch.host.regions import chain2aln, extension_plan
    from tpubwa_torch.opts import MEM_F_PE, MemOpt
    fmi, opt = main["fmi"], main["opt"]
    reads = main["batches"][0][:WAVES_READS]
    card = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]
    facts = {"reads": len(reads), "card": card}
    aligner = dp.make_device_aligner(opt, fmi, device=DEV)
    intv, positions, _ = aligner._seed_chunk(reads)

    def chains():
        out = chain_batch_native(opt, fmi, reads, intv, positions)
        if out is None:
            raise AssertionError("5j: the native chainer is unavailable")
        return out

    total = {"ksw_extend": 0, "ksw_extend_mat": 0}
    for name, mat in (("scmat", opt.scoring_matrix()),
                      ("tt", ek.tt_matrix())):
        waves = WaveExtender(opt, mat, aligner.device)
        cs = chains()
        regs = [[] for _ in reads]
        plans = dp._serialize_per_read([
            [extension_plan(opt, fmi.bnt, r.l_seq, r.seq, c, regs[i])
             for c in cs[i]] for i, r in enumerate(reads)])
        ek.extend_batch.launches = ek.extend_batch.mat_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        waves.run(plans)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = {"ksw_extend": ek.extend_batch.launches,
               "ksw_extend_mat": ek.extend_batch.mat_launches}
        cs = chains()
        scalar = [[] for _ in reads]
        for i, r in enumerate(reads):
            for c in cs[i]:
                chain2aln(opt, fmi.bnt, r.l_seq, r.seq, c, scalar[i], mat)
        if _regs_key(regs) != _regs_key(scalar):
            bad = next(i for i, (a, b) in enumerate(zip(
                _regs_key(regs), _regs_key(scalar))) if a != b)
            raise AssertionError(f"5j (a) {name}: read {bad}'s regions != "
                                 "chain2aln's")
        need = "ksw_extend_mat" if name == "tt" else "ksw_extend"
        if got[need] <= 0:
            raise AssertionError(f"5j (a) {name} launched {got}")
        facts[f"waves_{name}"] = {
            "seconds": round(dt, 3), "reads_per_s": round(len(reads) / dt, 1),
            "launches": got, "n_waves": waves.n_waves,
            "n_jobs": waves.n_jobs, "n_fallback": waves.n_fallback,
            "regions": sum(map(len, regs)), "equal_to_chain2aln": True}
        for k in total:
            total[k] += got[k]
    # (b): `mem`'s path under the transition/transversion matrix
    tt = ek.tt_matrix()

    class TtOpt(MemOpt):
        """`mem`'s options with the transition/transversion matrix."""
        def scoring_matrix(self):
            return tt.copy()

    opt_tt = TtOpt(flag=MEM_F_PE)
    real = dispatch.extend_seed_batch_np

    def scalar_loops(jobs, mat, o_del, e_del, o_ins, e_ins, zdrop, tmax,
                     device, extend=None, dp=None):
        return np.stack([scalar_fused(j, mat, o_del, e_del, o_ins, e_ins,
                                      zdrop) for j in jobs]).astype(np.int32)

    sams = {}
    for name, fn in (("k1_mat", real), ("scalar_loops", scalar_loops)):
        dispatch.extend_seed_batch_np = fn
        try:
            al = dp.make_device_aligner(opt_tt, fmi, device=DEV)
            if al.mat_scmat:
                raise AssertionError("5j: the tt matrix read as scmat")
            ek.extend_batch.launches = ek.extend_batch.mat_launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sams[name] = [l for _, ls in process_batches(
                opt_tt, fmi, iter([reads]), 0, align_fn=al) for l in ls]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            dispatch.extend_seed_batch_np = real
        got = {"ksw_extend": ek.extend_batch.launches,
               "ksw_extend_mat": ek.extend_batch.mat_launches}
        ext = al.extender
        facts[f"mem_tt_{name}"] = {
            "seconds": round(dt, 3), "reads_per_s": round(len(reads) / dt, 1),
            "launches": got, "n_waves": ext.n_waves, "n_jobs": ext.n_jobs,
            "n_fallback": ext.n_fallback, "sam_lines": len(sams[name])}
        if (got["ksw_extend_mat"] > 0) != (name == "k1_mat") \
                or got["ksw_extend"]:
            raise AssertionError(f"5j (b) {name} launched {got}")
        if name == "k1_mat":
            total["ksw_extend_mat"] += got["ksw_extend_mat"]
    if sams["k1_mat"] != sams["scalar_loops"]:
        raise AssertionError(
            f"5j (b): the K1-mat SAM != the scalar loops' "
            f"({len(sams['k1_mat'])} vs {len(sams['scalar_loops'])} lines, "
            f"first diff {sam_diff(sams['k1_mat'], sams['scalar_loops'])})")
    facts["mem_tt_sam_equal"] = True
    facts["launches"] = total
    print("[5j waves-plain] " + json.dumps(facts), flush=True)
    return total


PHASE_S = {}            # this run's wall of each phase, by function name


def timed(fn, *args):
    """fn(*args), its wall kept in PHASE_S under fn's name."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[fn.__name__] = round(time.perf_counter() - t0, 1)
    return out


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch sees no CUDA device\n")
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import tpubwa_torch  # noqa: F401  (fails outside a checkout)
    timed(phase_toolchain, torch)
    timed(phase_build)
    main_case, max_err = timed(phase_kernel, torch, np)
    case16, err16, launches16 = timed(phase_kernel16, torch, np)
    case_real, err_real, launches_real = timed(phase_kernel_real, torch, np)
    case_floor, err_floor, launches_floor = timed(phase_kernel_floor, torch,
                                                  np)
    timed(phase_sanitizer)
    case_bd, err_bd, launches_bd = timed(phase_kernel_bd, torch, np)
    case_mat, err_mat = timed(phase_kernel_mat, torch, np)
    timed(phase_golden, torch)
    timed(phase_shard, torch)
    timed(phase_dist, torch)
    dryrun_tp = timed(phase_dryrun, torch)
    entry_launches = timed(phase_entry, torch, np)
    main_path = timed(phase_main_path, torch, np)
    launches = main_path["launches"]
    stock, sa_case, sa_launches, _ = timed(phase_stock_bwa, torch, np,
                                           main_path)
    ext_case, ext_launches, sa_err, (ext_tp_case, ext_tp_launches) = \
        timed(phase_occ, torch, np, main_path["fmi"], stock)
    sa_case["max_abs_err"] = max(sa_case["max_abs_err"], sa_err)
    megaq = timed(phase_megaq, torch, np, main_path)
    seeding = timed(phase_seeding, torch, np, main_path, megaq)
    reach_3j, _ = timed(phase_reach, torch, np, megaq)
    kcur_case = timed(phase_kcur, torch, np, main_path, megaq)
    split_cases = timed(phase_ksplit, torch, np, main_path, megaq)
    modes, reach_case = timed(phase_seed_modes, torch, np, main_path,
                              megaq)
    # K-reach's row: mode reach's round-1 launch (5k), held to plain
    # there and on 3j's jobs
    reach_case["max_abs_err"] = max(reach_case["max_abs_err"],
                                    reach_3j["max_abs_err"])
    tp_launches = timed(phase_megaq_tp, torch, np, main_path, megaq)
    d5 = timed(phase_megaq_stock, torch, np, main_path, stock)
    dp_launches = timed(phase_megaq_dp, torch, np, main_path, stock, d5)
    hybrid = timed(phase_hybrid, torch, np, main_path, megaq)
    hybrid_dp = timed(phase_hybrid_dp, torch, np, main_path, hybrid)
    no_native = timed(phase_no_native, torch, np, main_path)["launches"]
    waves = timed(phase_waves_plain, torch, np, main_path)
    bad = sorted(k for k in sys.modules if k in ("jax", "tpubwa")
                 or k.startswith(("jax.", "tpubwa.")))
    if bad:
        raise AssertionError(f"imported {bad[:5]}")
    from tpubwa_torch.device import _build
    rates = card_rates(torch)
    kernels, sass, disasm = [], {}, {}
    results = {"ksw_extend": (launches + no_native["ksw_extend"]
                              + dp_launches["ksw_extend"]
                              + hybrid_dp["ksw_extend"]
                              + waves["ksw_extend"]
                              + sum(m["ksw_extend"] for m in modes.values()),
                              max_err, main_case),
               "ksw_extend_mat": (entry_launches["ksw_extend_mat"]
                                  + waves["ksw_extend_mat"], err_mat,
                                  case_mat),
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
            ("sa_lookup", "tpubwa/device/occ.py:303",
             sa_launches + sum(x["sa_lookup"] for x in (
                 megaq["launches"], d5["launches"], hybrid["launches"],
                 hybrid_dp, no_native, dp_launches, entry_launches)),
             sa_case),
            ("bwt_extend", "tpubwa/device/occ.py:202", ext_launches,
             ext_case),
            ("rightmost_reach", "tpubwa/device/smem.py:62",
             entry_launches["rightmost_reach"]
             + modes["reach"]["rightmost_reach"], reach_case)):
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
            "launches": sum(x[name] for x in (
                megaq["launches"], d5["launches"], hybrid["launches"],
                hybrid_dp, no_native, dp_launches, *modes.values())),
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": round(bound_ms, 6),
            "bound_by": bound_by, "library_ms": None})
    # K-cur: bound by bytes alone, the distinct sectors of the index
    # its round-1 launch on 5c's first chunk reads (csrc/smem_host)
    bound_ms, bound_by, parts = bytes_bound(kcur_case)
    sass["smem_jobs"] = dict(bytes=kcur_case["bytes"],
                             jobs=kcur_case["jobs"],
                             **{k: round(v, 6) for k, v in parts.items()})
    kernels.append({
        "name": "smem_jobs", "route": "cuda",
        "source": "tpubwa_torch/csrc/smem.cu",
        "replaces": "tpubwa/device/smem_cursor.py:54",
        "launches": sum(modes[m]["smem_jobs"] for m in ("cursor", "fused")),
        "max_abs_err": kcur_case["max_abs_err"], "ms": kcur_case["ms"],
        "plain_ms": kcur_case["plain_ms"], "bound_ms": round(bound_ms, 6),
        "bound_by": bound_by, "library_ms": None})
    # K-fwd and K-bwd: likewise, their round-1 launches on that chunk
    for name, key, replaces in (
            ("smem_fwd", "fwd", "tpubwa/device/smem_split.py:61"),
            ("smem_bwd", "bwd", "tpubwa/device/smem_split.py:198")):
        case = split_cases[key]
        bound_ms, bound_by, parts = bytes_bound(case)
        sass[name] = dict(bytes=case["bytes"], jobs=case["jobs"],
                          calls=case["calls"],
                          **{k: round(v, 6) for k, v in parts.items()})
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tpubwa_torch/csrc/smem.cu", "replaces": replaces,
            "launches": modes["split"][name],
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": round(bound_ms, 6),
            "bound_by": bound_by, "library_ms": None})
    # the TP instantiations: bound by bytes alone, the distinct sectors
    # of the slabs' own rows their run reads
    for name, src, replaces, n, case in (
            ("smem_rounds12_tp", "smem", "tpubwa/dist/index_tp.py:331",
             tp_launches["smem_rounds12_tp"] + dryrun_tp["smem_rounds12_tp"],
             seeding["smem_rounds12_tp"]),
            ("sa_lookup_tp", "occ", "tpubwa/dist/index_tp.py:132",
             tp_launches["sa_lookup_tp"] + dryrun_tp["sa_lookup_tp"],
             seeding["sa_lookup_tp"]),
            ("bwt_extend_tp", "occ", "tpubwa/dist/index_tp.py:111",
             ext_tp_launches, ext_tp_case)):
        bound_ms, bound_by, parts = bytes_bound(case)
        sass[name] = dict(bytes=case["bytes"],
                          **{k: round(v, 6) for k, v in parts.items()})
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tpubwa_torch/csrc/{src}.cu", "replaces": replaces,
            "launches": n, "max_abs_err": case["max_abs_err"],
            "ms": case["ms"], "plain_ms": case["plain_ms"],
            "bound_ms": round(bound_ms, 6), "bound_by": bound_by,
            "library_ms": None})
    print("[bounds] " + json.dumps({"card": rates, "hbm_bytes_s":
                                    HBM_BYTES_S, "kernels": sass}),
          flush=True)
    print("[smoke] " + json.dumps(
        {"wall_s": round(time.perf_counter() - t_start, 1),
         "phase_s": PHASE_S}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
