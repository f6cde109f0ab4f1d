// SMEM seeding (bwamem.c:mem_collect_intv) for Hopper (sm_90a), one read
// a thread, over the device functions of csrc/smem.cuh and csrc/fm.cuh.
//
// K2, collect12_kernel, replaces rounds 1 and 2 of
// tpubwa/device/smem_fused.py:smem_chunk_machine_q (:872, driven by
// rounds12_megaq :1336); the wrapper is
// tpubwa_torch/device/smem_fused.py:rounds12_megaq.  Round 1 walks x
// across the read (bwt_smem1a at min_intv 1) and keeps the rows of at
// least min_seed_len bases; round 2 re-seeds each round-1 row of at least
// split_len bases and at most split_width occurrences from its middle,
// (qb + qe) >> 1, at min_intv = size + 1.  The read's rows, round 1 then
// round 2 in the order they are found (the order of the port's native
// seeder, tpubwa_torch/native/smem.cpp:468-507), go to its `slots` row
// slots; the count goes on past them, so the wrapper launches once more,
// for the reads whose count passed `slots`, with as many slots as the
// largest count.  The round-1 rows are kept in the read's scratch too (at
// most len: their qe are distinct), so round 2 never depends on `slots`
// and the first launch's counts are exact.
//
// K3, seed_strategy_kernel, replaces tpubwa/device/smem.py:
// _seed_strategy_scan (:199), round 3 (bwt_seed_strategy1 from x across
// the read); the wrapper is tpubwa_torch/device/smem.py:
// _seed_strategy_scan.  A hit spans at least min_len + 1 bases and the
// next starts past it, so a read has fewer than maxh = L / min_len + 1
// hits (tpubwa's bound) and none is ever dropped.
//
// What bounds them on this card: the latency of dependent loads.  A read
// is a chain of bwt_extend steps (a few hundred for 100 bases), each two
// 48-byte occ rows read at ranks the previous step computed, anywhere in
// an index far larger than the 50 MB L2.  The least time for a launch is
// the bytes of the distinct 32-byte sectors of the index it reads over
// 3.35 TB/s (chip_smoke.py counts them through csrc/smem_host.cpp), far
// below a chain of trips to HBM.
//
// What the design does about it: one thread a read and nothing shared,
// so every read of a chunk (16,384 on the main path) has its chain in
// flight at once; the per-read stacks (curr, prev, the call's rows and
// round 1's rows, len + 1 intervals each) live in a scratch in global
// memory that the wrapper allocates, [n, 4, L + 1] intervals, and not in
// per-thread local arrays sized for the longest read.  Threads of a warp
// seed reads of different cost (a repeat beside a unique read) and wait
// for the warp's longest; chip_smoke.py reports the mean and the warp's
// largest steps a read.
//
// With TPUBWA_WARP_HOST defined the file compiles as plain C++ against
// warp_host.h (csrc/smem_host.cpp), so the tests run it on a machine with
// no card, under the sanitizers.

// SMEM seeding (bwamem.c:mem_collect_intv) for Hopper (sm_90a), over the
// device functions of csrc/smem.cuh and csrc/fm.cuh: rounds 1 and 2 a
// warp a read (K2), round 3 one read a thread (K3).
//
// K2, collect12_kernel, replaces rounds 1 and 2 of
// tpubwa/device/smem_fused.py:smem_chunk_machine_q (:872, driven by
// rounds12_megaq :1336); the wrapper is
// tpubwa_torch/device/smem_fused.py:rounds12_megaq.  Round 1 walks x
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
// K3, seed_strategy_kernel, replaces tpubwa/device/smem.py:
// _seed_strategy_scan (:199), round 3 (bwt_seed_strategy1 from x across
// the read); the wrapper is tpubwa_torch/device/smem.py:
// _seed_strategy_scan.  A hit spans at least min_len + 1 bases and the
// next starts past it, so a read has fewer than maxh = L / min_len + 1
// hits (tpubwa's bound) and none is ever dropped.
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

constexpr int kThreads = 128;  // K3: reads a block
constexpr int kMaxWarps = 4;   // K2: warps a block, at most
constexpr int kStacks = 4;     // curr, prev, a call's rows, round 1's rows

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
// warp_bytes = kStacks * (L + 1) intervals
template <class Idx>
__global__ void collect12_kernel(fm::Index<Idx> f,
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

template <class Idx>
__global__ void __launch_bounds__(kThreads)
seed_strategy_kernel(fm::Index<Idx> f, const uint8_t* __restrict__ q,
                     int64_t L, const int32_t* __restrict__ lens, int64_t n,
                     int min_len, Idx max_intv, int maxh,
                     Intv<Idx>* __restrict__ hits,
                     int32_t* __restrict__ n_hits,
                     int32_t* __restrict__ steps_out) {
    const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n) return;
    f = fm::with_l2(f);
    const uint8_t* qr = q + r * L;
    const int len = lens[r];
    Intv<Idx>* out = hits + r * maxh;
    int nh = 0, steps = 0;
    for (int x = 0; x < len;) {
        if (qr[x] > 3) {
            ++x;
            continue;
        }
        Intv<Idx> m;
        bool got;
        x = seed::seed_strategy1(f, qr, len, x, min_len, max_intv, &m, &got,
                                 steps);
        if (got && m.size > 0) out[nh++] = m;
    }
    n_hits[r] = nh;
    if (steps_out) steps_out[r] = steps;
}

int blocks_for(int64_t n) { return (int)((n + kThreads - 1) / kThreads); }

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

template <class Idx>
cudaError_t shape12(int64_t L, int device, Shape12* s) {
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&s->sms, cudaDevAttrMultiProcessorCount,
                                     device);
    if (err != cudaSuccess) return err;
    const int64_t per = kStacks * (int64_t)sizeof(Intv<Idx>);
    s->warp_bytes = per * (L + 1);
    s->max_len = optin / per - 1;
    if (L < 1 || L > s->max_len) return cudaErrorInvalidValue;
    // one opt-in covers every block size below
    err = cudaFuncSetAttribute(collect12_kernel<Idx>,
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
            &blocks, collect12_kernel<Idx>, 32 * w,
            (size_t)(w * s->warp_bytes));
        if (err != cudaSuccess) return err;
        if (blocks * w > s->warps * s->blocks_per_sm) {
            s->warps = w;
            s->blocks_per_sm = blocks;
        }
    }
    return s->warps ? cudaSuccess : cudaErrorInvalidValue;
}

template <class Idx>
cudaError_t launch12(const void* occ, const void* L2, int64_t primary,
                     int64_t seq_len, const void* q, int64_t L,
                     const void* lens, const void* rids, int64_t n,
                     int min_seed_len, int split_len, int64_t split_width,
                     int slots, void* queue, void* rows, void* counts,
                     void* steps, void* chain, int device,
                     cudaStream_t stream) {
    Shape12 s;
    cudaError_t err = shape12<Idx>(L, device, &s);
    if (err != cudaSuccess) return err;  // refused: no launch is made
    if ((uintptr_t)occ & 15) return cudaErrorInvalidValue;  // load16
    if (n <= 0) return cudaSuccess;
    err = cudaMemsetAsync(queue, 0, sizeof(int32_t), stream);
    if (err != cudaSuccess) return err;
    // a persistent grid: what the card holds at once, or a warp a read
    const int64_t blocks = std::min<int64_t>(
        (int64_t)s.blocks_per_sm * s.sms, (n + s.warps - 1) / s.warps);
    const fm::Index<Idx> f = index_of<Idx>(occ, L2, primary, seq_len);
    TPUBWA_LAUNCH(collect12_kernel<Idx>, (int)blocks, 32 * s.warps,
                  (size_t)(s.warps * s.warp_bytes), stream, f,
                  (const uint8_t*)q, L, (const int32_t*)lens,
                  (const int32_t*)rids, n, min_seed_len, split_len,
                  (Idx)split_width, slots, (size_t)s.warp_bytes,
                  (int32_t*)queue, (Intv<Idx>*)rows, (int32_t*)counts,
                  (int32_t*)steps, (int32_t*)chain);
    return cudaGetLastError();
}

template <class Idx>
cudaError_t launch3(const void* occ, const void* L2, int64_t primary,
                    int64_t seq_len, const void* q, int64_t L,
                    const void* lens, int64_t n, int min_len,
                    int64_t max_intv, int maxh, void* hits, void* n_hits,
                    void* steps, cudaStream_t stream) {
    const fm::Index<Idx> f = index_of<Idx>(occ, L2, primary, seq_len);
    TPUBWA_LAUNCH(seed_strategy_kernel<Idx>, blocks_for(n), kThreads, 0,
                  stream, f,
                  (const uint8_t*)q, L, (const int32_t*)lens, n, min_len,
                  (Idx)max_intv, maxh, (Intv<Idx>*)hits, (int32_t*)n_hits,
                  (int32_t*)steps);
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
    return (int)(idx64 ? launch12<int64_t> : launch12<int32_t>)(
        occ, L2, primary, seq_len, q, L, lens, rids, n, min_seed_len,
        split_len, split_width, slots, queue, rows, counts, steps, chain,
        device, (cudaStream_t)stream);
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

// K3: round 3 of reads [0, n): hits [n, maxh] intervals, n_hits [n].
extern "C" int tpubwa_seed_strategy(const void* occ, const void* L2,
                                    int64_t primary, int64_t seq_len,
                                    int idx64, const void* q, int64_t L,
                                    const void* lens, int64_t n, int min_len,
                                    int64_t max_intv, int maxh, void* hits,
                                    void* n_hits, void* steps, int device,
                                    void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    return (int)(idx64 ? launch3<int64_t> : launch3<int32_t>)(
        occ, L2, primary, seq_len, q, L, lens, n, min_len, max_intv, maxh,
        hits, n_hits, steps, (cudaStream_t)stream);
}
