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

#include <cstdint>
#ifdef TPUBWA_WARP_HOST
#include "warp_host.h"
#else
#include <cuda_runtime.h>
#define TPUBWA_LAUNCH(kernel, blocks, threads, bytes, stream, ...) \
    kernel<<<blocks, threads, bytes, stream>>>(__VA_ARGS__)
#endif
#include "smem.cuh"

namespace {

constexpr int kThreads = 128;  // reads a block
constexpr int kStacks = 4;     // curr, prev, a call's rows, round 1's rows

using seed::Intv;

template <class Idx>
__global__ void __launch_bounds__(kThreads)
collect12_kernel(fm::Index<Idx> f, const uint8_t* __restrict__ q, int64_t L,
                 const int32_t* __restrict__ lens,
                 const int32_t* __restrict__ rids, int64_t n,
                 int min_seed_len, int split_len, Idx split_width, int slots,
                 Intv<Idx>* __restrict__ scratch, Intv<Idx>* __restrict__ rows,
                 int32_t* __restrict__ counts,
                 int32_t* __restrict__ steps_out) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n) return;
    const int64_t r = rids[t];
    const uint8_t* qr = q + r * L;
    const int len = lens[r];
    Intv<Idx>* stack = scratch + t * kStacks * (L + 1);
    Intv<Idx>* curr = stack;
    Intv<Idx>* prev = stack + (L + 1);
    Intv<Idx>* mem = stack + 2 * (L + 1);
    Intv<Idx>* r1 = stack + 3 * (L + 1);
    Intv<Idx>* out = rows + t * slots;
    int n_out = 0, n_r1 = 0, n_mem = 0, steps = 0;
    for (int x = 0; x < len;) {  // round 1
        if (qr[x] > 3) {
            ++x;
            continue;
        }
        x = seed::smem1a(f, qr, len, x, (Idx)1, curr, prev, mem, n_mem,
                         steps);
        for (int k = 0; k < n_mem; ++k) {
            if (mem[k].qe - mem[k].qb < min_seed_len) continue;
            r1[n_r1++] = mem[k];
            if (n_out < slots) out[n_out] = mem[k];
            ++n_out;
        }
    }
    for (int j = 0; j < n_r1; ++j) {  // round 2
        const Intv<Idx> p = r1[j];
        if (p.qe - p.qb < split_len || p.size > split_width) continue;
        seed::smem1a(f, qr, len, (int)((p.qb + p.qe) >> 1), p.size + 1,
                     curr, prev, mem, n_mem, steps);
        for (int k = 0; k < n_mem; ++k) {
            if (mem[k].qe - mem[k].qb < min_seed_len) continue;
            if (n_out < slots) out[n_out] = mem[k];
            ++n_out;
        }
    }
    counts[t] = n_out;
    if (steps_out) steps_out[t] = steps;
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

template <class Idx>
cudaError_t launch12(const void* occ, const void* L2, int64_t primary,
                     int64_t seq_len, const void* q, int64_t L,
                     const void* lens, const void* rids, int64_t n,
                     int min_seed_len, int split_len, int64_t split_width,
                     int slots, void* scratch, void* rows, void* counts,
                     void* steps, cudaStream_t stream) {
    const fm::Index<Idx> f = index_of<Idx>(occ, L2, primary, seq_len);
    TPUBWA_LAUNCH(collect12_kernel<Idx>, blocks_for(n), kThreads, 0, stream,
                  f, (const uint8_t*)q, L, (const int32_t*)lens,
                  (const int32_t*)rids, n, min_seed_len, split_len,
                  (Idx)split_width, slots, (Intv<Idx>*)scratch,
                  (Intv<Idx>*)rows, (int32_t*)counts, (int32_t*)steps);
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
// torch.Tensor.data_ptr(): occ uint32 rows, L2 and the intervals of the
// rank type (int64_t where idx64, else int32_t; an interval is five of
// them), reads uint8 [B, L] (codes, 4 = N), lens, rids and the counts
// int32; steps (bwt_extend calls a read) may be null.  stream is torch's
// current cudaStream_t.  Each launches on that stream without
// synchronising and returns cudaGetLastError() (0 on success).

// K2: rounds 1 and 2 of reads rids[0, n) (lens[rid] <= L each); thread t
// writes its read's first `slots` rows to rows[t] ([n, slots] intervals)
// and its count of rows to counts[t].  scratch: [n, 4, L + 1] intervals.
extern "C" int tpubwa_smem_rounds12(const void* occ, const void* L2,
                                    int64_t primary, int64_t seq_len,
                                    int idx64, const void* q, int64_t L,
                                    const void* lens, const void* rids,
                                    int64_t n, int min_seed_len,
                                    int split_len, int64_t split_width,
                                    int slots, void* scratch, void* rows,
                                    void* counts, void* steps, int device,
                                    void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    return (int)(idx64 ? launch12<int64_t> : launch12<int32_t>)(
        occ, L2, primary, seq_len, q, L, lens, rids, n, min_seed_len,
        split_len, split_width, slots, scratch, rows, counts, steps,
        (cudaStream_t)stream);
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
