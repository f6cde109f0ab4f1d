// SMEM seeding (bwamem.c:mem_collect_intv) for Hopper (sm_90a), over the
// device functions of csrc/smem.cuh and csrc/fm.cuh: rounds 1 and 2 a
// warp a read (K2), round 3 a group of 8 lanes a read (K3),
// bwt_smem1a a warp a job (K-cur, seed modes cursor and fused), and its
// forward and backward halves apart (K-fwd a warp a job, K-bwd a warp a
// recorded call: seed mode split).
//
// K2, collect12_kernel, replaces rounds 1 and 2 of
// tpubwa/device/smem_fused.py:smem_chunk_machine_q (:872, driven by
// rounds12_megaq :1336), and in seed mode mega those of
// smem_chunk_machine (:730, driven by rounds12_mega :1505); the wrapper
// is tpubwa_torch/device/smem_fused.py:rounds12_megaq.  Round 1 walks x
// across the read (bwt_smem1a at min_intv 1) and keeps the rows of at
// least min_seed_len bases; round 2 re-seeds each round-1 row of at least
// split_len bases and at most split_width occurrences from its middle,
// (qb + qe) >> 1, at min_intv = size + 1.  The read's rows, round 1 then
// round 2 in the order they are found (the order of the port's native
// seeder, tpubwa_torch/native/smem.cpp:468-507), go to its `slots` row
// slots; the count goes on past them, so the wrapper launches once more,
// for the reads whose count passed `slots`, with as many slots as the
// largest count.  The round-1 rows are kept in the warp's shared memory
// too (at most len: their qe are distinct), so round 2 never depends on
// `slots` and the first launch's counts are exact.
//
// K2 has a TP instantiation (collect12_kernel<Idx, true>, behind
// tpubwa_smem_rounds12_tp), for an index split into row slabs across
// devices (tpubwa_torch/dist/index_tp.py:TpIndex): the counterpart of
// tpubwa/dist/index_tp.py:seed_machine_tp, the same rows, each occ row
// read from the slab that holds it (fm.cuh:row_at over fm::Slabs).  K3
// has none: tpubwa scans round 3 on the whole index.
//
// K3, seed_strategy_kernel, replaces tpubwa/device/smem.py:
// _seed_strategy_scan (:199), round 3 (bwt_seed_strategy1 from x across
// the read); the wrapper is tpubwa_torch/device/smem.py:
// _seed_strategy_scan.  A hit spans at least min_len + 1 bases and the
// next starts past it, so a read has fewer than maxh = L / min_len + 1
// hits (tpubwa's bound) and none is ever dropped.  A scan from x steps
// at x + 1, x + 2, ... and the next starts past where it stopped, so a
// read's steps are one chain of at most len - 1 (95 a read on the main
// path's chunk, 99 at most).
//
// What bounds them on this card: the latency of dependent loads.  A read
// is a chain of bwt_extend steps (about 520 for a 100-base read of the
// 64 Mbp main path in K2, 95 in K3), each two 48-byte occ rows read at
// ranks the previous step computed, anywhere in an index as large as the
// 50 MB L2 or larger.  The least time for a launch is the bytes of the
// distinct 32-byte sectors of the index it reads over 3.35 TB/s
// (chip_smoke.py counts them through csrc/smem_host.cpp), far below a
// chain of trips to memory.  So the card is busy only when each SM holds
// many chains at once, and a read is short only when its chain is.
//
// What K2's design does about it:
//   * a warp a read, from a read queue: a persistent grid, as many
//     blocks as the card holds at once (the occupancy query at launch),
//     each warp taking the next read from a global counter until the
//     reads run out, so no warp waits for another read and no block for
//     its slowest warp (one read a thread, its first form, made each warp
//     wait for its longest read, 4.37 times the mean);
//   * the forward phase is one chain whatever the design; the warp makes
//     each step together (smem.cuh:bwt_extend_warp): lanes 0-15 load one
//     BWT word each of the step's two occ rows, all at once, every lane
//     the rows' checkpoint counts, and two warp sums add the words'
//     counts, so a step costs a lane a few dozen instructions where one
//     thread counting both rows from registers spends hundreds;
//   * the backward phase extends the stack a lane an interval, in strips
//     of 32, each lane fetching both occ rows of its extension at once
//     (three 16-byte loads a row, one row where both ranks share a
//     block) and counting from registers (fm.cuh:bwt_extend), with the
//     scalar loop's keep and emit rules rebuilt from ballots (smem.cuh
//     says why the two agree): a read's chain is its forward steps plus
//     its backward strips, not all its steps;
//   * the stacks (curr, prev, a call's rows and round 1's rows, L + 1
//     intervals each) live in the warp's slice of the block's dynamic
//     shared memory, 4 (L + 1) intervals: 10,320 B a warp for L = 128 in
//     int32, 20,640 B in int64.  No global scratch is allocated.  The
//     warps a block (4, 2 or 1) are chosen at launch, from L and the rank
//     type, as the count that the occupancy query lets the most warps an
//     SM hold: at L = 128 an SM's 228 KB hold 5 blocks of 4 warps (20
//     warps) in int32 (41,280 B + 1 KB a block) and 10 blocks of 1 in
//     int64 (20,640 B + 1 KB: 10 warps), if the registers allow (64 a
//     thread allow 32 warps).  A read length whose stacks do not fit one
//     warp in a block's shared memory (232,448 B: L > 2,904 in int32, L >
//     1,451 in int64) is refused: the entry returns cudaErrorInvalidValue
//     before anything runs.
// K-cur, smem_jobs_kernel, replaces tpubwa/device/smem_cursor.py:
// smem_cursor_machine (:54, its while_loop :237, driven by
// tpubwa/device/smem.py:_rounds12_cursor :275), and in seed mode fused
// tpubwa/device/smem_fused.py:smem_call_machine (:690, driven by
// rounds12_fused :1616); the wrapper is
// tpubwa_torch/device/smem_cursor.py:run_smem_jobs.  A job is (read, x0,
// min_intv, one_shot): a one-shot job makes one bwt_smem1a(x0, min_intv)
// call (round 2's re-seeding), any other restarts at each call's return,
// past N bases, until the read ends (round 1, as K2's loop).  Its rows of
// at least min_seed_len bases go to its `slots` row slots, each call's by
// query start, the count going on past them, and the wrapper launches
// once more for the jobs whose count passed `slots`, as for K2
// (smem_fused.collect12).  Bound and design are K2's, over jobs instead
// of reads: a warp a job from a job queue, its three stacks (curr, prev
// and a call's rows, L + 1 intervals each: 7,740 B a warp for L = 128 in
// int32, 15,480 B in int64) in the warp's slice of shared memory, the
// warps a block chosen at launch by the occupancy query.  It keeps no
// round-1 list (the wrapper picks round 2's jobs from round 1's rows), so
// it takes longer reads than K2: L <= 3,873 in int32, L <= 1,936 in
// int64; a longer L is refused before anything runs.  tpubwa's stack and
// row caps, its overflow flag and its host fallback have no counterpart:
// every bound comes from the read's length.
// K-fwd, smem_fwd_kernel, and K-bwd, smem_bwd_kernel (seed mode split),
// replace tpubwa/device/smem_split.py:smem_fwd_machine (:61, its
// while_loop :184) and smem_bwd_machine (:198, :318), driven by
// rounds12_split (:453); the wrappers are tpubwa_torch/device/
// smem_split.py:run_fwd and run_bwd.  They are K-cur's bwt_smem1a cut
// where the forward phase hands its stack to the backward phase
// (smem.cuh:smem1a_fwd, smem1a_bwd).  K-fwd runs a job as K-cur does, a
// warp a job from a job queue, and writes each call's stack (x0, x1,
// size, qe a pushed interval, longest match first) and the call (x, m,
// ret) to global memory in `slots` slots a job, counting on past them;
// the wrapper re-runs the jobs past their slots with exact room, as
// collect12 does for K2.  K-bwd takes a warp a recorded call from a call
// queue: it loads the call's stack into shared memory, runs the backward
// half, and writes the call's rows where its stack lay (a call emits at
// most m rows, so the wrapper's prefix sum of m is exact: no second
// launch).  The bound and the design question are K-cur's: a job's chain
// is its forward steps plus its calls' backward strips, and spreading a
// job's calls over warps takes the strips off the job's chain, at the
// price of a trip through global memory for each stack.  K-fwd keeps two
// stacks a warp in shared memory (curr, prev), K-bwd three (curr, prev
// and the call's rows, K-cur's limit: L <= 3,873 in int32, 1,936 in
// int64); both are refused past it before anything runs.
// What K3's design does about it:
//   * a group of kGroup = 8 lanes a read, 4 reads a warp: each forward
//     step's two occ rows are counted across the group
//     (fm.cuh:bwt_extend_group), each lane loading two of a row's 8
//     BWT words (one 8-byte load) and both rows' checkpoint counts, all
//     at once, so a step is one trip to memory and a few dozen
//     instructions a lane, where one thread loading and counting both
//     rows spends hundreds; two __shfl_xor_sync rounds sum a row's
//     packed counts inside its half of the group and a third swaps the
//     halves;
//   * the card filled with reads: 16,384 reads are 4,096 warps, all on
//     the card at once where the registers allow (the occupancy query
//     on an H100: 10 blocks of 4 warps an SM at 47 registers, int32), so
//     every
//     read's chain is in flight together (one read a thread, the first
//     form, ran 128 blocks: 4 warps an SM);
//   * where the card holds fewer groups than reads, a persistent grid:
//     group g takes read g, then the next from a read queue (an int32
//     counter) as its read ends, one atomicAdd a warp for all of its
//     groups that need one, and none once the queue is seen empty;
//   * the warp's groups step in lockstep, as the shuffles take every
//     lane: a group whose read ended, or that has none, joins the sums
//     with a dead flag and loads nothing; a restart past an N costs no
//     step; only a group's first lane writes (its hits, then its read's
//     count, steps, chain and longest scan);
//   * ok[c] is picked by selects (fm.cuh:pick4), so the extension stays
//     in registers (no stack frame).
// scripts/exp_k3_forms.py times the group sizes (1, 4, 8, 16 and 32
// lanes a read) side by side.
// TMA, wgmma and thread block clusters have nothing to offer here: there
// is no matrix product, and each row is read at a rank the step before
// computed, so no tile can be known, let alone fetched, ahead.
//
// With TPUBWA_WARP_HOST defined the file compiles as plain C++ against
// warp_host.h (csrc/smem_host.cpp), so the tests run it on a machine with
// no card, under the sanitizers, in both lane orders.

#include <algorithm>
#include <cstdint>
#ifdef TPUBWA_WARP_HOST
#include "warp_host.h"
using warp_host::warp_shared;
#else
#include <cuda_runtime.h>
extern __shared__ __align__(16) unsigned char smem_warps[];
// the calling warp's slice of `bytes` of the block's dynamic shared memory
__device__ __forceinline__ void* warp_shared(size_t bytes) {
    return smem_warps + (threadIdx.x >> 5) * bytes;
}
#define TPUBWA_LAUNCH(kernel, blocks, threads, bytes, stream, ...) \
    kernel<<<blocks, threads, bytes, stream>>>(__VA_ARGS__)
#endif
#include "smem.cuh"

namespace {

constexpr int kThreads = 128;  // K3: threads a block
constexpr int kGroup = 8;      // K3: lanes a read (1, 4, 8, 16 or 32)
constexpr int kMaxWarps = 4;   // K2: warps a block, at most
constexpr int kStacks = 4;     // curr, prev, a call's rows, round 1's rows
constexpr int kJobStacks = 3;  // K-cur: curr, prev, a call's rows
constexpr int kFwdStacks = 2;  // K-fwd: curr, prev
constexpr int kBwdStacks = 3;  // K-bwd: curr, prev, the call's rows

using seed::Intv;
using seed::kFull;

// K2's rows of mem (by decreasing qb, as smem1a leaves them) of at least
// min_seed_len bases, by query start, appended to the read's row slots
// (out, n_out) and, where r1 is not null, to round 1's rows (r1, n_r1):
// a lane a row, the rows' order kept by a prefix count
template <class Idx>
__device__ __forceinline__ void keep_rows(const Intv<Idx>* mem, int n_mem,
                                          int min_seed_len, Intv<Idx>* out,
                                          int slots, int& n_out,
                                          Intv<Idx>* r1, int& n_r1) {
    const int lane = threadIdx.x & 31;
    for (int s = 0; s < n_mem; s += 32) {
        const int k = s + lane;
        Intv<Idx> m{};
        bool take = false;
        if (k < n_mem) {
            m = mem[n_mem - 1 - k];
            take = m.qe - m.qb >= min_seed_len;
        }
        const unsigned takes = __ballot_sync(kFull, take);
        const int at = __popc(takes & seed::lanes_below(lane));
        if (take) {
            if (r1) r1[n_r1 + at] = m;
            if (n_out + at < slots) out[n_out + at] = m;
        }
        n_out += __popc(takes);
        if (r1) n_r1 += __popc(takes);
    }
}

// K2: a warp a read, from the read queue (*queue, zero at launch);
// warp_bytes = kStacks * (L + 1) intervals.  Tp: the TP instantiation,
// the occ rows in slabs (fm::Slabs)
template <class Idx, bool Tp>
__global__ void collect12_kernel(fm::Index<Idx, fm::Rows<uint32_t, Tp>> f,
                                 const uint8_t* __restrict__ q, int64_t L,
                                 const int32_t* __restrict__ lens,
                                 const int32_t* __restrict__ rids, int64_t n,
                                 int min_seed_len, int split_len,
                                 Idx split_width, int slots, size_t warp_bytes,
                                 int32_t* __restrict__ queue,
                                 Intv<Idx>* __restrict__ rows,
                                 int32_t* __restrict__ counts,
                                 int32_t* __restrict__ steps_out,
                                 int32_t* __restrict__ chain_out) {
    const int lane = threadIdx.x & 31;
    f = fm::with_l2(f);
    Intv<Idx>* curr = static_cast<Intv<Idx>*>(warp_shared(warp_bytes));
    Intv<Idx>* prev = curr + (L + 1);
    Intv<Idx>* mem = curr + 2 * (L + 1);
    Intv<Idx>* r1 = curr + 3 * (L + 1);
    for (;;) {
        int t = 0;
        if (lane == 0) t = atomicAdd(queue, 1);
        t = __shfl_sync(kFull, t, 0);
        if (t >= n) break;
        const int64_t r = rids[t];
        const uint8_t* qr = q + r * L;
        const int len = lens[r];
        Intv<Idx>* out = rows + (int64_t)t * slots;
        int n_out = 0, n_r1 = 0, n_mem = 0, steps = 0, chain = 0;
        for (int x = 0; x < len;) {  // round 1
            if (qr[x] > 3) {
                ++x;
                continue;
            }
            x = seed::smem1a(f, qr, len, x, (Idx)1, curr, prev, mem, n_mem,
                             steps, chain);
            keep_rows(mem, n_mem, min_seed_len, out, slots, n_out, r1, n_r1);
        }
        __syncwarp();  // round 1's rows are visible to every lane
        for (int j = 0; j < n_r1; ++j) {  // round 2
            const Intv<Idx> p = r1[j];
            if (p.qe - p.qb < split_len || p.size > split_width) continue;
            seed::smem1a(f, qr, len, (int)((p.qb + p.qe) >> 1), p.size + 1,
                         curr, prev, mem, n_mem, steps, chain);
            int none = 0;
            keep_rows(mem, n_mem, min_seed_len, out, slots, n_out,
                      (Intv<Idx>*)nullptr, none);
        }
        if (lane == 0) {
            counts[t] = n_out;
            if (steps_out) steps_out[t] = steps;
            if (chain_out) chain_out[t] = chain;
        }
        __syncwarp();  // the stacks' readers are done before the next read
    }
}

// K-cur: a warp a job, from the job queue (*queue, zero at launch); the
// t-th job taken is ids[t], its rows go to rows[t] ([n, slots]
// intervals).  warp_bytes = kJobStacks * (L + 1) intervals
template <class Idx>
__global__ void smem_jobs_kernel(fm::Index<Idx> f,
                                 const uint8_t* __restrict__ q, int64_t L,
                                 const int32_t* __restrict__ lens,
                                 const int32_t* __restrict__ read,
                                 const int32_t* __restrict__ x0,
                                 const Idx* __restrict__ min_intv,
                                 const uint8_t* __restrict__ one_shot,
                                 const int32_t* __restrict__ ids, int64_t n,
                                 int min_seed_len, int slots,
                                 size_t warp_bytes,
                                 int32_t* __restrict__ queue,
                                 Intv<Idx>* __restrict__ rows,
                                 int32_t* __restrict__ counts,
                                 int32_t* __restrict__ steps_out,
                                 int32_t* __restrict__ chain_out) {
    const int lane = threadIdx.x & 31;
    f = fm::with_l2(f);
    Intv<Idx>* curr = static_cast<Intv<Idx>*>(warp_shared(warp_bytes));
    Intv<Idx>* prev = curr + (L + 1);
    Intv<Idx>* mem = curr + 2 * (L + 1);
    for (;;) {
        int t = 0;
        if (lane == 0) t = atomicAdd(queue, 1);
        t = __shfl_sync(kFull, t, 0);
        if (t >= n) break;
        const int64_t j = ids[t];
        const uint8_t* qr = q + (int64_t)read[j] * L;
        const int len = lens[read[j]];
        const bool once = one_shot[j] != 0;
        const Idx mi = min_intv[j];
        Intv<Idx>* out = rows + (int64_t)t * slots;
        int n_out = 0, n_mem = 0, steps = 0, chain = 0, none = 0;
        for (int x = x0[j]; x < len;) {
            if (qr[x] > 3) {  // smem1a would return x + 1, with no rows
                if (once) break;
                ++x;
                continue;
            }
            x = seed::smem1a(f, qr, len, x, mi, curr, prev, mem, n_mem, steps,
                             chain);
            keep_rows(mem, n_mem, min_seed_len, out, slots, n_out,
                      (Intv<Idx>*)nullptr, none);
            if (once) break;
        }
        if (lane == 0) {
            counts[t] = n_out;
            if (steps_out) steps_out[t] = steps;
            if (chain_out) chain_out[t] = chain;
        }
        __syncwarp();  // the stacks' readers are done before the next job
    }
}

// K-fwd: a warp a job, from the job queue (*queue, zero at launch); the
// t-th job taken is ids[t].  Each of its calls' stacks goes to stack[t]
// ([n, slots] intervals of four ranks: x0, x1, size, qe), call after
// call, each longest match first, and the call itself, (x, m, ret), to
// calls[t] ([n, slots] int32 triples); n_calls[t] and n_intv[t] count on
// past the slots (a call pushes at least one interval, so n_calls <=
// n_intv).  warp_bytes = kFwdStacks * (L + 1) intervals
template <class Idx>
__global__ void smem_fwd_kernel(fm::Index<Idx> f,
                                const uint8_t* __restrict__ q, int64_t L,
                                const int32_t* __restrict__ lens,
                                const int32_t* __restrict__ read,
                                const int32_t* __restrict__ x0,
                                const Idx* __restrict__ min_intv,
                                const uint8_t* __restrict__ one_shot,
                                const int32_t* __restrict__ ids, int64_t n,
                                int slots, size_t warp_bytes,
                                int32_t* __restrict__ queue,
                                Idx* __restrict__ stack,
                                int32_t* __restrict__ calls,
                                int32_t* __restrict__ n_calls,
                                int32_t* __restrict__ n_intv,
                                int32_t* __restrict__ steps_out,
                                int32_t* __restrict__ chain_out) {
    const int lane = threadIdx.x & 31;
    f = fm::with_l2(f);
    Intv<Idx>* curr = static_cast<Intv<Idx>*>(warp_shared(warp_bytes));
    Intv<Idx>* prev = curr + (L + 1);
    for (;;) {
        int t = 0;
        if (lane == 0) t = atomicAdd(queue, 1);
        t = __shfl_sync(kFull, t, 0);
        if (t >= n) break;
        const int64_t j = ids[t];
        const uint8_t* qr = q + (int64_t)read[j] * L;
        const int len = lens[read[j]];
        const bool once = one_shot[j] != 0;
        const Idx mi = min_intv[j] < 1 ? (Idx)1 : min_intv[j];
        Idx* out = stack + (int64_t)t * slots * 4;
        int32_t* call = calls + (int64_t)t * slots * 3;
        int nc = 0, ni = 0, steps = 0, chain = 0;
        for (int x = x0[j]; x < len;) {
            if (qr[x] > 3) {  // smem1a would return x + 1, with no call
                if (once) break;
                ++x;
                continue;
            }
            __syncwarp();  // the stacks' last readers are done
            int m = 0;
            const int ret = seed::smem1a_fwd(f, qr, len, x, mi, curr, prev, m,
                                             steps, chain);
            for (int k = lane; k < m && ni + k < slots; k += 32) {
                const Intv<Idx> p = prev[k];
                Idx* o = out + (int64_t)(ni + k) * 4;
                o[0] = p.x0;
                o[1] = p.x1;
                o[2] = p.size;
                o[3] = p.qe;
            }
            if (lane == 0 && nc < slots) {
                call[3 * nc] = x;
                call[3 * nc + 1] = m;
                call[3 * nc + 2] = ret;
            }
            ni += m;
            ++nc;
            if (once) break;
            x = ret;
        }
        if (lane == 0) {
            n_calls[t] = nc;
            n_intv[t] = ni;
            if (steps_out) steps_out[t] = steps;
            if (chain_out) chain_out[t] = chain;
        }
        __syncwarp();  // the stacks' readers are done before the next job
    }
}

// K-bwd: a warp a recorded call, from the call queue (*queue, zero at
// launch).  Call t's stack, stack[off[t], off[t] + m[t]) (four ranks an
// interval, longest match first, as K-fwd writes them), goes into the
// warp's prev stack; smem1a_bwd runs from x[t] on read read[t], and the
// rows of at least min_seed_len bases go to rows[off[t], off[t] +
// counts[t]) by query start.  A call emits at most m[t] rows
// (smem1a_bwd), so a call's rows fit where its stack's slots are.
// warp_bytes = kBwdStacks * (L + 1) intervals
template <class Idx>
__global__ void smem_bwd_kernel(fm::Index<Idx> f,
                                const uint8_t* __restrict__ q, int64_t L,
                                const int32_t* __restrict__ read,
                                const int32_t* __restrict__ x,
                                const int32_t* __restrict__ m,
                                const int64_t* __restrict__ off,
                                const Idx* __restrict__ min_intv,
                                const Idx* __restrict__ stack, int64_t n,
                                int min_seed_len, size_t warp_bytes,
                                int32_t* __restrict__ queue,
                                Intv<Idx>* __restrict__ rows,
                                int32_t* __restrict__ counts,
                                int32_t* __restrict__ steps_out,
                                int32_t* __restrict__ chain_out) {
    const int lane = threadIdx.x & 31;
    f = fm::with_l2(f);
    Intv<Idx>* curr = static_cast<Intv<Idx>*>(warp_shared(warp_bytes));
    Intv<Idx>* prev = curr + (L + 1);
    Intv<Idx>* mem = curr + 2 * (L + 1);
    for (;;) {
        int t = 0;
        if (lane == 0) t = atomicAdd(queue, 1);
        t = __shfl_sync(kFull, t, 0);
        if (t >= n) break;
        const int nm = m[t];
        const int64_t o = off[t];
        for (int k = lane; k < nm; k += 32) {
            const Idx* s = stack + (o + k) * 4;
            prev[k] = Intv<Idx>{s[0], s[1], s[2], 0, s[3]};
        }
        __syncwarp();  // the stack is visible to every lane
        const Idx mi = min_intv[t] < 1 ? (Idx)1 : min_intv[t];
        int n_mem = 0, n_out = 0, steps = 0, chain = 0, none = 0;
        seed::smem1a_bwd(f, q + (int64_t)read[t] * L, x[t], mi, curr, prev,
                         nm, mem, n_mem, steps, chain);
        keep_rows(mem, n_mem, min_seed_len, rows + o, nm, n_out,
                  (Intv<Idx>*)nullptr, none);
        if (lane == 0) {
            counts[t] = n_out;
            if (steps_out) steps_out[t] = steps;
            if (chain_out) chain_out[t] = chain;
        }
        __syncwarp();  // the stacks' readers are done before the next call
    }
}

// K3's state on a group's read (every lane of the group holds the same):
// bwt_seed_strategy1 from x, scanning with ik the interval of q[x, i)
template <class Idx>
struct Round3 {
    const uint8_t* q = nullptr;
    int len = 0, x = 0, i = 0, c = 0;  // c: the base of the next step
    bool scanning = false;
    Intv<Idx> ik{};
    int nh = 0, steps = 0, chain = 0, scan = 0, longest = 0;

    // on to the read's next step, past Ns and into the next scan (no
    // bwt_extend, no warp operation): true with the step ik by c to make,
    // false where the read has ended
    __device__ __forceinline__ bool next(const fm::Index<Idx>& f) {
        for (;;) {
            if (!scanning) {
                while (x < len && q[x] > 3) ++x;
                if (x >= len) return false;
                ik = seed::set_intv_l2(f, q[x]);
                i = x + 1;
                scan = 0;
                scanning = true;
            }
            if (i >= len) {  // the scan ran to the read's end
                x = len;
                scanning = false;
                return false;
            }
            const int b = q[i];
            if (b <= 3) {
                c = 3 - b;  // forward extension reads the complement's slot
                return true;
            }
            x = i + 1;  // an N ends the scan with no hit
            scanning = false;
        }
    }
};

// K3: a group of kGroup lanes a read.  Group g (of `groups` in the grid)
// takes read g first, then reads groups, groups + 1, ... in the order the
// warps ask for them from the read queue (*queue, zeroed by the entry
// where groups < n).  The warp's groups make their steps in lockstep.
template <class Idx>
__global__ void __launch_bounds__(kThreads)
seed_strategy_kernel(fm::Index<Idx> f, const uint8_t* __restrict__ q,
                     int64_t L, const int32_t* __restrict__ lens, int n,
                     int groups, int min_len, Idx max_intv, int maxh,
                     int32_t* __restrict__ queue,
                     Intv<Idx>* __restrict__ hits,
                     int32_t* __restrict__ n_hits,
                     int32_t* __restrict__ steps_out,
                     int32_t* __restrict__ chain_out,
                     int32_t* __restrict__ longest_out) {
    constexpr int G = kGroup;
    // the groups' first lanes
    constexpr unsigned kLeads = G == 32 ? 1u : 0xffffffffu / ((1u << G) - 1u);
    const int lane = threadIdx.x & 31, lead = lane & ~(G - 1);
    const int at = blockIdx.x * blockDim.x + threadIdx.x;
    if ((at - lane) / G >= n) return;  // the warp's first group has no read
    f = fm::with_l2(f);
    bool empty = groups >= n;  // the queue has no read left
    int t = at / G;            // the group's read, -1 while it has none
    bool drained = t >= n;     // no read is left for the group
    if (drained) t = -1;
    Round3<Idx> s;
    auto start = [&](int r) {
        s = Round3<Idx>{};
        s.q = q + (int64_t)r * L;
        s.len = lens[r];
        t = r;
    };
    // the group's next step, its read's outputs written where it ends
    auto next = [&]() {
        if (t < 0) return false;
        if (s.next(f)) return true;
        if (lane == lead) {
            n_hits[t] = s.nh;
            if (steps_out) steps_out[t] = s.steps;
            if (chain_out) chain_out[t] = s.chain;
            if (longest_out) longest_out[t] = s.longest;
        }
        t = -1;
        return false;
    };
    if (t >= 0) start(t);
    for (;;) {
        bool step = next();
        unsigned needs = __ballot_sync(kFull, !drained && t < 0);
        if (needs) {
            do {  // the groups whose read ended take the next ones
                const unsigned leads = needs & kLeads;
                int first = n;
                if (!empty) {  // one atomic a warp, its reads in lane order
                    int got = 0;
                    if (lane == 0) got = atomicAdd(queue, __popc(leads));
                    first = groups + __shfl_sync(kFull, got, 0);
                    empty = first + __popc(leads) >= n;
                }
                if (!drained && t < 0) {
                    const int r =
                        first + __popc(leads & seed::lanes_below(lead));
                    if (r < n) {
                        start(r);
                        step = next();
                    } else {
                        drained = true;
                    }
                }
                needs = __ballot_sync(kFull, !drained && t < 0);
            } while (needs);
            if (!__ballot_sync(kFull, !drained)) break;
        }
        // every group that is not drained has a step; the others join the
        // group's sums (G 4 to 16) with step false
        Intv<Idx> ok{};
        if (G > 1 || step) ok = seed::extend_fwd<G>(f, s.ik, s.c, step);
        if (!step) continue;
        ++s.chain;
        ++s.steps;
        if (++s.scan > s.longest) s.longest = s.scan;
        if (ok.size < max_intv && s.i - s.x >= min_len) {
            if (ok.size > 0) {
                if (lane == lead)
                    hits[(int64_t)t * maxh + s.nh] = Intv<Idx>{
                        ok.x0, ok.x1, ok.size, (Idx)s.x, (Idx)(s.i + 1)};
                ++s.nh;
            }
            s.x = s.i + 1;
            s.scanning = false;
        } else {
            s.ik = ok;
            ++s.i;
        }
    }
}

template <class Idx>
fm::Index<Idx> index_of(const void* occ, const void* L2, int64_t primary,
                        int64_t seq_len) {
    return fm::Index<Idx>{(const uint32_t*)occ, (const Idx*)L2,
                          (Idx)primary, (Idx)seq_len};
}

// K2's launch shape for reads of L bases (see the header): the bytes of
// a warp's stacks, the warps a block and the blocks an SM the occupancy
// query allows, the card's SMs, and the longest L whose stacks fit one
// warp in a block.  A longer L is refused with cudaErrorInvalidValue.
struct Shape12 {
    int64_t warp_bytes = 0;
    int warps = 0, blocks_per_sm = 0, sms = 0;
    int64_t max_len = 0;
};

// The launch shape of a warp-a-unit kernel whose warp keeps `stacks`
// stacks of L + 1 intervals in shared memory (K2, K-cur)
template <class Idx, class Kernel>
cudaError_t warp_shape(Kernel kernel, int stacks, int64_t L, int device,
                       Shape12* s) {
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&s->sms, cudaDevAttrMultiProcessorCount,
                                     device);
    if (err != cudaSuccess) return err;
    const int64_t per = stacks * (int64_t)sizeof(Intv<Idx>);
    s->warp_bytes = per * (L + 1);
    s->max_len = optin / per - 1;
    if (L < 1 || L > s->max_len) return cudaErrorInvalidValue;
    // one opt-in covers every block size below
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) {
        cudaGetLastError();  // returned, not left for the next launch
        return err;
    }
    for (int w = kMaxWarps; w >= 1; w /= 2) {
        if (w * s->warp_bytes > optin) continue;
        int blocks = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, kernel, 32 * w, (size_t)(w * s->warp_bytes));
        if (err != cudaSuccess) return err;
        if (blocks * w > s->warps * s->blocks_per_sm) {
            s->warps = w;
            s->blocks_per_sm = blocks;
        }
    }
    return s->warps ? cudaSuccess : cudaErrorInvalidValue;
}

template <class Idx, bool Tp = false>
cudaError_t shape12(int64_t L, int device, Shape12* s) {
    return warp_shape<Idx>(collect12_kernel<Idx, Tp>, kStacks, L, device, s);
}

// K-cur's launch shape for reads of L bases: as K2's, with kJobStacks
template <class Idx>
cudaError_t shape_jobs(int64_t L, int device, Shape12* s) {
    return warp_shape<Idx>(smem_jobs_kernel<Idx>, kJobStacks, L, device, s);
}

// K-fwd's and K-bwd's launch shapes for reads of L bases: as K2's, with
// kFwdStacks and kBwdStacks
template <class Idx>
cudaError_t shape_fwd(int64_t L, int device, Shape12* s) {
    return warp_shape<Idx>(smem_fwd_kernel<Idx>, kFwdStacks, L, device, s);
}

template <class Idx>
cudaError_t shape_bwd(int64_t L, int device, Shape12* s) {
    return warp_shape<Idx>(smem_bwd_kernel<Idx>, kBwdStacks, L, device, s);
}

template <class Idx, bool Tp>
cudaError_t launch12(const fm::Index<Idx, fm::Rows<uint32_t, Tp>>& f,
                     const void* q, int64_t L, const void* lens,
                     const void* rids, int64_t n, int min_seed_len,
                     int split_len, int64_t split_width, int slots,
                     void* queue, void* rows, void* counts, void* steps,
                     void* chain, int device, cudaStream_t stream) {
    Shape12 s;
    cudaError_t err = shape12<Idx, Tp>(L, device, &s);
    if (err != cudaSuccess) return err;  // refused: no launch is made
    if (!fm::aligned16(f.occ)) return cudaErrorInvalidValue;
    if (n <= 0) return cudaSuccess;
    err = cudaMemsetAsync(queue, 0, sizeof(int32_t), stream);
    if (err != cudaSuccess) return err;
    // a persistent grid: what the card holds at once, or a warp a read
    const int64_t blocks = std::min<int64_t>(
        (int64_t)s.blocks_per_sm * s.sms, (n + s.warps - 1) / s.warps);
    // (a template-id's comma would split the launch macro's arguments)
    const auto kernel = collect12_kernel<Idx, Tp>;
    TPUBWA_LAUNCH(kernel, (int)blocks, 32 * s.warps,
                  (size_t)(s.warps * s.warp_bytes), stream, f,
                  (const uint8_t*)q, L, (const int32_t*)lens,
                  (const int32_t*)rids, n, min_seed_len, split_len,
                  (Idx)split_width, slots, (size_t)s.warp_bytes,
                  (int32_t*)queue, (Intv<Idx>*)rows, (int32_t*)counts,
                  (int32_t*)steps, (int32_t*)chain);
    return cudaGetLastError();
}

template <class Idx>
cudaError_t flat12(const void* occ, const void* L2, int64_t primary,
                   int64_t seq_len, const void* q, int64_t L,
                   const void* lens, const void* rids, int64_t n,
                   int min_seed_len, int split_len, int64_t split_width,
                   int slots, void* queue, void* rows, void* counts,
                   void* steps, void* chain, int device,
                   cudaStream_t stream) {
    return launch12<Idx, false>(index_of<Idx>(occ, L2, primary, seq_len), q,
                                L, lens, rids, n, min_seed_len, split_len,
                                split_width, slots, queue, rows, counts,
                                steps, chain, device, stream);
}

template <class Idx>
cudaError_t tp12(int n_slabs, const int64_t* occ, const void* L2,
                 int64_t primary, int64_t seq_len, const void* q, int64_t L,
                 const void* lens, const void* rids, int64_t n,
                 int min_seed_len, int split_len, int64_t split_width,
                 int slots, void* queue, void* rows, void* counts,
                 void* steps, void* chain, int device, cudaStream_t stream) {
    fm::Index<Idx, fm::Slabs<uint32_t>> f{};
    f.L2 = (const Idx*)L2;
    f.primary = (Idx)primary;
    f.seq_len = (Idx)seq_len;
    const cudaError_t err = fm::slab_table(occ, n_slabs, device, &f.occ);
    if (err != cudaSuccess) return err;
    return launch12<Idx, true>(f, q, L, lens, rids, n, min_seed_len,
                               split_len, split_width, slots, queue, rows,
                               counts, steps, chain, device, stream);
}

// A persistent grid of warp-a-unit blocks for n units (K-cur, K-fwd,
// K-bwd): what the card holds at once, or a warp a unit.  0 where the
// queue's int32 counter, which goes past n by a take a warp, cannot take
// n.
inline int64_t unit_blocks(const Shape12& s, int64_t n) {
    const int64_t blocks = std::min<int64_t>(
        (int64_t)s.blocks_per_sm * s.sms, (n + s.warps - 1) / s.warps);
    return n < 0 || n > INT32_MAX - blocks * s.warps ? 0 : blocks;
}

template <class Idx>
cudaError_t launch_jobs(const void* occ, const void* L2, int64_t primary,
                        int64_t seq_len, const void* q, int64_t L,
                        const void* lens, const void* read, const void* x0,
                        const void* min_intv, const void* one_shot,
                        const void* ids, int64_t n, int min_seed_len,
                        int slots, void* queue, void* rows, void* counts,
                        void* steps, void* chain, int device,
                        cudaStream_t stream) {
    Shape12 s;
    cudaError_t err = shape_jobs<Idx>(L, device, &s);
    if (err != cudaSuccess) return err;  // refused: no launch is made
    if ((uintptr_t)occ & 15) return cudaErrorInvalidValue;  // load16
    const int64_t blocks = unit_blocks(s, n);
    if (n == 0) return cudaSuccess;
    if (blocks == 0) return cudaErrorInvalidValue;
    err = cudaMemsetAsync(queue, 0, sizeof(int32_t), stream);
    if (err != cudaSuccess) return err;
    TPUBWA_LAUNCH(smem_jobs_kernel<Idx>, (int)blocks, 32 * s.warps,
                  (size_t)(s.warps * s.warp_bytes), stream,
                  index_of<Idx>(occ, L2, primary, seq_len), (const uint8_t*)q,
                  L, (const int32_t*)lens, (const int32_t*)read,
                  (const int32_t*)x0, (const Idx*)min_intv,
                  (const uint8_t*)one_shot, (const int32_t*)ids, n,
                  min_seed_len, slots, (size_t)s.warp_bytes, (int32_t*)queue,
                  (Intv<Idx>*)rows, (int32_t*)counts, (int32_t*)steps,
                  (int32_t*)chain);
    return cudaGetLastError();
}

template <class Idx>
cudaError_t launch_fwd(const void* occ, const void* L2, int64_t primary,
                       int64_t seq_len, const void* q, int64_t L,
                       const void* lens, const void* read, const void* x0,
                       const void* min_intv, const void* one_shot,
                       const void* ids, int64_t n, int slots, void* queue,
                       void* stack, void* calls, void* n_calls, void* n_intv,
                       void* steps, void* chain, int device,
                       cudaStream_t stream) {
    Shape12 s;
    cudaError_t err = shape_fwd<Idx>(L, device, &s);
    if (err != cudaSuccess) return err;  // refused: no launch is made
    if ((uintptr_t)occ & 15) return cudaErrorInvalidValue;  // load16
    const int64_t blocks = unit_blocks(s, n);
    if (n == 0) return cudaSuccess;
    if (blocks == 0 || slots < 1) return cudaErrorInvalidValue;
    err = cudaMemsetAsync(queue, 0, sizeof(int32_t), stream);
    if (err != cudaSuccess) return err;
    TPUBWA_LAUNCH(smem_fwd_kernel<Idx>, (int)blocks, 32 * s.warps,
                  (size_t)(s.warps * s.warp_bytes), stream,
                  index_of<Idx>(occ, L2, primary, seq_len), (const uint8_t*)q,
                  L, (const int32_t*)lens, (const int32_t*)read,
                  (const int32_t*)x0, (const Idx*)min_intv,
                  (const uint8_t*)one_shot, (const int32_t*)ids, n, slots,
                  (size_t)s.warp_bytes, (int32_t*)queue, (Idx*)stack,
                  (int32_t*)calls, (int32_t*)n_calls, (int32_t*)n_intv,
                  (int32_t*)steps, (int32_t*)chain);
    return cudaGetLastError();
}

template <class Idx>
cudaError_t launch_bwd(const void* occ, const void* L2, int64_t primary,
                       int64_t seq_len, const void* q, int64_t L,
                       const void* read, const void* x, const void* m,
                       const void* off, const void* min_intv,
                       const void* stack, int64_t n, int min_seed_len,
                       void* queue, void* rows, void* counts, void* steps,
                       void* chain, int device, cudaStream_t stream) {
    Shape12 s;
    cudaError_t err = shape_bwd<Idx>(L, device, &s);
    if (err != cudaSuccess) return err;  // refused: no launch is made
    if ((uintptr_t)occ & 15) return cudaErrorInvalidValue;  // load16
    const int64_t blocks = unit_blocks(s, n);
    if (n == 0) return cudaSuccess;
    if (blocks == 0) return cudaErrorInvalidValue;
    err = cudaMemsetAsync(queue, 0, sizeof(int32_t), stream);
    if (err != cudaSuccess) return err;
    TPUBWA_LAUNCH(smem_bwd_kernel<Idx>, (int)blocks, 32 * s.warps,
                  (size_t)(s.warps * s.warp_bytes), stream,
                  index_of<Idx>(occ, L2, primary, seq_len), (const uint8_t*)q,
                  L, (const int32_t*)read, (const int32_t*)x,
                  (const int32_t*)m, (const int64_t*)off, (const Idx*)min_intv,
                  (const Idx*)stack, n, min_seed_len, (size_t)s.warp_bytes,
                  (int32_t*)queue, (Intv<Idx>*)rows, (int32_t*)counts,
                  (int32_t*)steps, (int32_t*)chain);
    return cudaGetLastError();
}

// K3's launch for n reads (see the header): the lanes a read, the blocks
// an SM the occupancy query allows, the card's SMs, and the grid's blocks
// and groups, capped by the reads.  An n the read queue's int32 counter
// cannot take is refused with cudaErrorInvalidValue.
struct Shape3 {
    int group = kGroup, blocks_per_sm = 0, sms = 0;
    int64_t blocks = 0, groups = 0;
};

template <class Idx>
cudaError_t shape3(int64_t n, int device, Shape3* s) {
    cudaError_t err = cudaDeviceGetAttribute(
        &s->sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &s->blocks_per_sm, seed_strategy_kernel<Idx>, kThreads, 0);
    if (err != cudaSuccess) return err;
    constexpr int64_t per = kThreads / kGroup;  // groups a block
    s->blocks = std::min<int64_t>((int64_t)s->blocks_per_sm * s->sms,
                                  (n + per - 1) / per);
    s->groups = s->blocks * per;
    // the counter and a read's index stay below n + groups + 32
    if (n < 0 || n > INT32_MAX - s->groups - 32) return cudaErrorInvalidValue;
    return s->blocks_per_sm ? cudaSuccess : cudaErrorInvalidValue;
}

template <class Idx>
cudaError_t launch3(const void* occ, const void* L2, int64_t primary,
                    int64_t seq_len, const void* q, int64_t L,
                    const void* lens, int64_t n, int min_len,
                    int64_t max_intv, int maxh, void* queue, void* hits,
                    void* n_hits, void* steps, void* chain, void* longest,
                    int device, cudaStream_t stream) {
    Shape3 s;
    cudaError_t err = shape3<Idx>(n, device, &s);
    if (err != cudaSuccess) return err;  // refused: no launch is made
    if ((uintptr_t)occ & 15) return cudaErrorInvalidValue;  // load16
    if (n == 0) return cudaSuccess;
    if (s.groups < n) {  // the read queue is used
        err = cudaMemsetAsync(queue, 0, sizeof(int32_t), stream);
        if (err != cudaSuccess) return err;
    }
    const fm::Index<Idx> f = index_of<Idx>(occ, L2, primary, seq_len);
    TPUBWA_LAUNCH(seed_strategy_kernel<Idx>, (int)s.blocks, kThreads, 0,
                  stream, f, (const uint8_t*)q, L, (const int32_t*)lens,
                  (int)n, (int)s.groups, min_len, (Idx)max_intv, maxh,
                  (int32_t*)queue, (Intv<Idx>*)hits, (int32_t*)n_hits,
                  (int32_t*)steps, (int32_t*)chain, (int32_t*)longest);
    return cudaGetLastError();
}

}  // namespace

// C entry points for ctypes.  Pointers are device pointers from
// torch.Tensor.data_ptr(): occ uint32 rows (16-byte aligned), L2 and the
// intervals of the rank type (int64_t where idx64, else int32_t; an
// interval is five of them), reads uint8 [B, L] (codes, 4 = N), lens,
// rids and the counts int32; steps (bwt_extend calls a read) may be
// null.  stream is torch's
// current cudaStream_t.  Each launches on that stream without
// synchronising and returns cudaGetLastError() (0 on success).

// K2: rounds 1 and 2 of reads rids[0, n) (lens[rid] <= L each), a warp
// a read taken from the queue queue[0] (an int32 the entry zeroes on the
// stream first); read t's first `slots` rows go to rows[t] ([n, slots]
// intervals) and its count of rows to counts[t]; chain (the rounds of
// bwt_extend calls the warp made one after another) may be null.  A read
// length whose stacks do not fit a block's shared memory (see
// tpubwa_smem_rounds12_shape) is refused before anything runs.
extern "C" int tpubwa_smem_rounds12(const void* occ, const void* L2,
                                    int64_t primary, int64_t seq_len,
                                    int idx64, const void* q, int64_t L,
                                    const void* lens, const void* rids,
                                    int64_t n, int min_seed_len,
                                    int split_len, int64_t split_width,
                                    int slots, void* queue, void* rows,
                                    void* counts, void* steps, void* chain,
                                    int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return (int)(idx64 ? flat12<int64_t> : flat12<int32_t>)(
        occ, L2, primary, seq_len, q, L, lens, rids, n, min_seed_len,
        split_len, split_width, slots, queue, rows, counts, steps, chain,
        device, (cudaStream_t)stream);
}

// K2's TP instantiation, over a sharded index: occ is a slab table (3 *
// n_slabs int64: the slabs' device addresses, their first rows and their
// devices, fm.cuh:slab_table), L2 on the launch device; the rest as
// tpubwa_smem_rounds12.  A slab on another device is read through peer
// access, enabled here (an error where the two devices cannot reach each
// other).  Nothing runs where an error is returned.
extern "C" int tpubwa_smem_rounds12_tp(int n_slabs, const int64_t* occ,
                                       const void* L2, int64_t primary,
                                       int64_t seq_len, int idx64,
                                       const void* q, int64_t L,
                                       const void* lens, const void* rids,
                                       int64_t n, int min_seed_len,
                                       int split_len, int64_t split_width,
                                       int slots, void* queue, void* rows,
                                       void* counts, void* steps,
                                       void* chain, int device,
                                       void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return (int)(idx64 ? tp12<int64_t> : tp12<int32_t>)(
        n_slabs, occ, L2, primary, seq_len, q, L, lens, rids, n,
        min_seed_len, split_len, split_width, slots, queue, rows, counts,
        steps, chain, device, (cudaStream_t)stream);
}

// K2's launch shape for reads of L bases into out[5] (a host array):
// the bytes of a warp's stacks, the warps a block, the blocks an SM, the
// card's SMs and the longest read length K2 takes; returns the error a
// launch at L would return before it runs (out is filled as far as it
// is known).
extern "C" int tpubwa_smem_rounds12_shape(int idx64, int64_t L, int device,
                                          int64_t* out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    Shape12 s;
    err = idx64 ? shape12<int64_t>(L, device, &s)
                : shape12<int32_t>(L, device, &s);
    const int64_t got[5] = {s.warp_bytes, s.warps, s.blocks_per_sm, s.sms,
                            s.max_len};
    for (int i = 0; i < 5; ++i) out[i] = got[i];
    return (int)err;
}

// K-cur: the jobs ids[0, n) (indexes into read, x0, min_intv and one_shot:
// int32, int32, the rank type and uint8 0/1 arrays; lens[read[j]] <= L),
// a warp a job taken from the queue queue[0] (an int32 the entry zeroes on
// the stream first); the t-th job's first `slots` rows go to rows[t]
// ([n, slots] intervals) and its count of rows to counts[t]; steps and
// chain (as K2's, a job) may be null.  A read length whose stacks do not
// fit a block's shared memory (see tpubwa_smem_jobs_shape), or an n the
// queue's counter cannot take, is refused before anything runs.
extern "C" int tpubwa_smem_jobs(const void* occ, const void* L2,
                                int64_t primary, int64_t seq_len, int idx64,
                                const void* q, int64_t L, const void* lens,
                                const void* read, const void* x0,
                                const void* min_intv, const void* one_shot,
                                const void* ids, int64_t n, int min_seed_len,
                                int slots, void* queue, void* rows,
                                void* counts, void* steps, void* chain,
                                int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return (int)(idx64 ? launch_jobs<int64_t> : launch_jobs<int32_t>)(
        occ, L2, primary, seq_len, q, L, lens, read, x0, min_intv, one_shot,
        ids, n, min_seed_len, slots, queue, rows, counts, steps, chain,
        device, (cudaStream_t)stream);
}

// K-cur's launch shape for reads of L bases into out[5], as
// tpubwa_smem_rounds12_shape's
extern "C" int tpubwa_smem_jobs_shape(int idx64, int64_t L, int device,
                                      int64_t* out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    Shape12 s;
    err = idx64 ? shape_jobs<int64_t>(L, device, &s)
                : shape_jobs<int32_t>(L, device, &s);
    const int64_t got[5] = {s.warp_bytes, s.warps, s.blocks_per_sm, s.sms,
                            s.max_len};
    for (int i = 0; i < 5; ++i) out[i] = got[i];
    return (int)err;
}

// K-fwd: the jobs ids[0, n) (as tpubwa_smem_jobs's), a warp a job taken
// from the queue queue[0] (an int32 the entry zeroes on the stream
// first); the t-th job's first `slots` stack intervals (x0, x1, size, qe)
// go to stack[t] ([n, slots, 4] of the rank type) and its first `slots`
// calls (x, m, ret) to calls[t] ([n, slots, 3] int32), its counts of
// calls and intervals to n_calls[t] and n_intv[t]; steps and chain (the
// forward steps, a job) may be null.  A read length whose stacks do not
// fit a block's shared memory (see tpubwa_smem_fwd_shape), or an n the
// queue's counter cannot take, is refused before anything runs.
extern "C" int tpubwa_smem_fwd(const void* occ, const void* L2,
                               int64_t primary, int64_t seq_len, int idx64,
                               const void* q, int64_t L, const void* lens,
                               const void* read, const void* x0,
                               const void* min_intv, const void* one_shot,
                               const void* ids, int64_t n, int slots,
                               void* queue, void* stack, void* calls,
                               void* n_calls, void* n_intv, void* steps,
                               void* chain, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return (int)(idx64 ? launch_fwd<int64_t> : launch_fwd<int32_t>)(
        occ, L2, primary, seq_len, q, L, lens, read, x0, min_intv, one_shot,
        ids, n, slots, queue, stack, calls, n_calls, n_intv, steps, chain,
        device, (cudaStream_t)stream);
}

// K-bwd: the recorded calls [0, n): call t on read read[t] from x[t], its
// stack stack[off[t], off[t] + m[t]) (intervals of four ranks of the rank
// type, longest match first), at min_intv[t] (the rank type); off int64,
// the rest int32.  A warp a call taken from the queue queue[0] (an int32
// the entry zeroes on the stream first); the call's rows of at least
// min_seed_len bases go to rows[off[t], ...) (intervals of five ranks)
// and their count to counts[t] (at most m[t]); steps and chain (the
// backward extensions and strips, a call) may be null.  Refused as
// tpubwa_smem_fwd.
extern "C" int tpubwa_smem_bwd(const void* occ, const void* L2,
                               int64_t primary, int64_t seq_len, int idx64,
                               const void* q, int64_t L, const void* read,
                               const void* x, const void* m, const void* off,
                               const void* min_intv, const void* stack,
                               int64_t n, int min_seed_len, void* queue,
                               void* rows, void* counts, void* steps,
                               void* chain, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return (int)(idx64 ? launch_bwd<int64_t> : launch_bwd<int32_t>)(
        occ, L2, primary, seq_len, q, L, read, x, m, off, min_intv, stack, n,
        min_seed_len, queue, rows, counts, steps, chain, device,
        (cudaStream_t)stream);
}

// K-fwd's (bwd 0) or K-bwd's (bwd 1) launch shape for reads of L bases
// into out[5], as tpubwa_smem_rounds12_shape's
extern "C" int tpubwa_smem_split_shape(int bwd, int idx64, int64_t L,
                                       int device, int64_t* out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    Shape12 s;
    if (bwd)
        err = idx64 ? shape_bwd<int64_t>(L, device, &s)
                    : shape_bwd<int32_t>(L, device, &s);
    else
        err = idx64 ? shape_fwd<int64_t>(L, device, &s)
                    : shape_fwd<int32_t>(L, device, &s);
    const int64_t got[5] = {s.warp_bytes, s.warps, s.blocks_per_sm, s.sms,
                            s.max_len};
    for (int i = 0; i < 5; ++i) out[i] = got[i];
    return (int)err;
}

// K3: round 3 of reads [0, n), a group of lanes a read taking reads from
// the read queue queue[0] (an int32 the entry zeroes on the stream first,
// where the grid has fewer groups than reads): hits [n, maxh] intervals,
// n_hits [n]; steps (bwt_extend calls a read), chain (the rounds of them
// the read's group made one after another) and longest (the most steps
// of one bwt_seed_strategy1 call in the read) may be null.  An n the
// queue's counter cannot take (see tpubwa_seed_strategy_shape) is refused
// before anything runs.
extern "C" int tpubwa_seed_strategy(const void* occ, const void* L2,
                                    int64_t primary, int64_t seq_len,
                                    int idx64, const void* q, int64_t L,
                                    const void* lens, int64_t n, int min_len,
                                    int64_t max_intv, int maxh, void* queue,
                                    void* hits, void* n_hits, void* steps,
                                    void* chain, void* longest, int device,
                                    void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return (int)(idx64 ? launch3<int64_t> : launch3<int32_t>)(
        occ, L2, primary, seq_len, q, L, lens, n, min_len, max_intv, maxh,
        queue, hits, n_hits, steps, chain, longest, device,
        (cudaStream_t)stream);
}

// K3's launch for n reads into out[5] (a host array): the lanes a read,
// the blocks an SM, the card's SMs, the grid's blocks and its groups;
// returns the error a launch of n reads would return before it runs.
extern "C" int tpubwa_seed_strategy_shape(int idx64, int64_t n, int device,
                                          int64_t* out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    Shape3 s;
    err = idx64 ? shape3<int64_t>(n, device, &s) : shape3<int32_t>(n, device, &s);
    const int64_t got[5] = {s.group, s.blocks_per_sm, s.sms, s.blocks,
                            s.groups};
    for (int i = 0; i < 5; ++i) out[i] = got[i];
    return (int)err;
}
