// The SA walk (bwt_sa) and the bidirectional interval extension
// (bwt_extend) over the FM index, for Hopper (sm_90a), one query a
// thread, over the device functions of csrc/fm.cuh.
//
// K-sa replaces tpubwa/device/occ.py:sa_lookup (:303-341, a fori_loop /
// while_loop over inv_psi :226); the wrapper is
// tpubwa_torch/device/occ.py:sa_lookup.  Ranks idt [n] in [0, seq_len]
// (clamped into it) -> text positions idt [n].  With text-position marks
// (mark_D > 0) a walk takes at most mark_D - 1 LF steps, then reads
// sa_marked at the rank's mark index; without them (a stock-bwa index)
// it LF-steps until the rank is a multiple of 32, then reads
// sa_sample[k / 32]: a geometric walk, mean 32, with no bound on
// positions.  The one guard, seq_len + 1 steps, is never reached on an
// index: LF is one cycle through all seq_len + 1 ranks and rank 0 is a
// multiple of 32, so no walk is longer than seq_len steps; it keeps a
// corrupt index from hanging the card.
//
// K-ext replaces tpubwa/device/occ.py:bwt_extend (:202-223, with occ4
// :155); the wrapper is tpubwa_torch/device/occ.py:bwt_extend.  ik idt
// [n, 3] (x0, x1, size) -> idt [n, 4, 3].
//
// What bounds them on this card: bytes, and under them the latency of
// dependent loads.  An LF step is one 48-byte occ row (two 32-byte
// sectors), read at a rank that the previous step computed; the marked
// walk adds one 32-byte mark row a step.  The rows lie anywhere in an
// index of hundreds of MB, far past the 50 MB L2, so a step is a trip to
// HBM, and a walk of s steps is s such trips in a chain.  The least time
// for a launch is the bytes of the distinct sectors it touches over
// 3.35 TB/s (chip_smoke.py counts them from the plain version's reads).
// An extension is two independent rows.
//
// What the design does about it: one thread a query, and nothing shared,
// so every query of a launch is in flight at once and the card holds as
// many chains as it has ranks; each thread walks on its own and leaves
// when its walk ends (the JAX loops step every lane until the slowest
// lane ends, a lockstep of the TPU, not copied).  An LF step reads only
// the words it needs: x's word, the words below it and one count.  Lanes
// of a warp whose walks end early idle until the warp's longest walk
// ends; chip_smoke.py reports the mean and the largest steps a warp.
//
// With TPUBWA_WARP_HOST defined the file compiles as plain C++ against
// warp_host.h (csrc/occ_host.cpp), so the tests hold it to the plain
// versions, under the sanitizers, on a machine with no card.

#include <cstdint>
#ifdef TPUBWA_WARP_HOST
#include "warp_host.h"
#else
#include <cuda_runtime.h>
#define TPUBWA_LAUNCH(kernel, blocks, threads, bytes, stream, ...) \
    kernel<<<blocks, threads, bytes, stream>>>(__VA_ARGS__)
#endif
#include "fm.cuh"

namespace {

constexpr int kThreads = 128;  // queries a block

template <class Idx, bool Marked>
__global__ void __launch_bounds__(kThreads)
sa_lookup_kernel(fm::Index<Idx> f, const uint32_t* __restrict__ marks,
                 const Idx* __restrict__ sa_marked, int mark_D,
                 const Idx* __restrict__ sa_sample,
                 const Idx* __restrict__ ranks, Idx* __restrict__ out,
                 int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Idx k = ranks[i];
    k = k < 0 ? 0 : k > f.seq_len ? f.seq_len : k;
    Idx steps = 0;
    if (Marked) {
        for (; steps < mark_D - 1 && !fm::mark_bit(marks, k); ++steps)
            k = fm::inv_psi(f, k);
        out[i] = steps + __ldg(sa_marked + fm::mark_index(marks, k));
    } else {
        for (; (k & (fm::kSaIntv - 1)) != 0 && steps <= f.seq_len; ++steps)
            k = fm::inv_psi(f, k);
        out[i] = steps + __ldg(sa_sample + (k >> 5));
    }
}

template <class Idx, bool IsBack>
__global__ void __launch_bounds__(kThreads)
bwt_extend_kernel(fm::Index<Idx> f, const Idx* __restrict__ ik,
                  Idx* __restrict__ ok, int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    f = fm::with_l2(f);
    const Idx in[3] = {ik[3 * i], ik[3 * i + 1], ik[3 * i + 2]};
    Idx res[4][3];
    fm::bwt_extend<Idx, IsBack>(f, in, res);
    Idx* o = ok + 12 * i;
    for (int c = 0; c < 4; ++c)
        for (int j = 0; j < 3; ++j) o[3 * c + j] = res[c][j];
}

int blocks_for(int64_t n) { return (int)((n + kThreads - 1) / kThreads); }

template <class Idx>
fm::Index<Idx> index_of(const void* occ, const void* L2, int64_t primary,
                        int64_t seq_len) {
    return fm::Index<Idx>{(const uint32_t*)occ, (const Idx*)L2,
                          (Idx)primary, (Idx)seq_len};
}

template <class Idx>
cudaError_t launch_sa(const void* occ, const void* L2, const void* marks,
                      const void* sa_marked, const void* sa_sample,
                      int64_t primary, int64_t seq_len, int mark_D,
                      const void* ranks, void* out, int64_t n,
                      cudaStream_t stream) {
    const fm::Index<Idx> f = index_of<Idx>(occ, L2, primary, seq_len);
    // one pointer type for both walks (a template-id's comma would split
    // the launch macro's arguments)
    const auto kernel = mark_D > 0 ? sa_lookup_kernel<Idx, true>
                                   : sa_lookup_kernel<Idx, false>;
    TPUBWA_LAUNCH(kernel, blocks_for(n), kThreads, 0, stream, f,
                  (const uint32_t*)marks, (const Idx*)sa_marked, mark_D,
                  (const Idx*)sa_sample, (const Idx*)ranks, (Idx*)out, n);
    return cudaGetLastError();
}

template <class Idx>
cudaError_t launch_extend(const void* occ, const void* L2, int64_t primary,
                          int64_t seq_len, int is_back, const void* ik,
                          void* ok, int64_t n, cudaStream_t stream) {
    const fm::Index<Idx> f = index_of<Idx>(occ, L2, primary, seq_len);
    const auto kernel = is_back ? bwt_extend_kernel<Idx, true>
                                : bwt_extend_kernel<Idx, false>;
    TPUBWA_LAUNCH(kernel, blocks_for(n), kThreads, 0, stream, f,
                  (const Idx*)ik, (Idx*)ok, n);
    return cudaGetLastError();
}

}  // namespace

// C entry points for ctypes.  Pointers are device pointers from
// torch.Tensor.data_ptr() (occ and marks uint32 rows, the rest Idx:
// int64_t where idx64, else int32_t); stream is torch's current
// cudaStream_t.  Each launches on that stream without synchronising and
// returns cudaGetLastError() (0 on success).

// K-sa: positions of n ranks; the marked walk where mark_D > 0 (marks
// and sa_marked read), else the rank-sampled one (sa_sample read).
extern "C" int tpubwa_sa_lookup(const void* occ, const void* L2,
                                const void* marks, const void* sa_marked,
                                const void* sa_sample, int64_t primary,
                                int64_t seq_len, int mark_D, int idx64,
                                const void* ranks, void* out, int64_t n,
                                int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    return (int)(idx64 ? launch_sa<int64_t>
                       : launch_sa<int32_t>)(occ, L2, marks, sa_marked,
                                             sa_sample, primary, seq_len,
                                             mark_D, ranks, out, n,
                                             (cudaStream_t)stream);
}

// K-ext: the [n, 4, 3] extensions of n intervals [n, 3], backward
// (prepending a base) where is_back, else forward.
extern "C" int tpubwa_bwt_extend(const void* occ, const void* L2,
                                 int64_t primary, int64_t seq_len, int idx64,
                                 int is_back, const void* ik, void* ok,
                                 int64_t n, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    return (int)(idx64 ? launch_extend<int64_t>
                       : launch_extend<int32_t>)(occ, L2, primary, seq_len,
                                                 is_back, ik, ok, n,
                                                 (cudaStream_t)stream);
}
