// Batched banded Smith-Waterman seed extension (bwa ksw.c:ksw_extend2)
// for Hopper (sm_90a), and its timing-only ablations (K1-floor).
//
// Replaces: tpubwa/device/extend_pallas.py:_extend_kernel, launched by
// extend_batch_pallas.  Same contract at the Python wrapper
// (tpubwa_torch/device/extend_kernel.py:extend_batch): q int32 [N, W],
// t int32 [N, tmax], params int32 [N, pstride] with lanes (qlen, tlen,
// h0, w, end_bonus); out int32 [N, 6] = (score, qle, tle, gtle, gscore,
// max_off).
//
// Design: one thread per job runs the upstream row loop exactly as
// tpubwa/native/ksw.cpp:tpubwa_ksw_extend writes it (that C++ is fuzzed
// bit-equal to tpubwa/ref/ksw.py).  The TPU kernel's lane layout, roll
// trees and MXU matvec are TPU devices, not semantics, and are not
// carried over.  The score is match a / mismatch -b / N -1 arithmetic,
// with no profile table.
//
// K1-floor: the same kernel body, templated on the JAX kernel's
// `ablate` flags (extend_pallas.py:224-233, 271-286), as a bit mask.
// With every bit clear the instantiation is K1.  Each ablation swaps a
// value that feeds one of the body's gated updates, as the lane form
// does, so one thread per job still computes the whole launch:
//   kScan   no F gap scan: F = NEG past beg, so H = max(M, E) (E >= 0);
//   kPk     the row max and its argmax from lane 0 only: m = H(i, 0)
//           when beg == 0, else 0 (NEG's packed value), and mj = 0;
//   kHopen  h_open from lane 0 only: H(i, end - 1) when end == 1, else 0
//           (it feeds only the gscore test; the write-back keeps H);
//   kTrim   the band trim from lane 0 only: beg 0 and end min(2, qlen)
//           when beg == 0 and column 0 is nonzero, else beg = end and
//           end = min(end + 1, qlen).
// The JAX `trees` ablation is kPk | kHopen | kTrim.  These variants are
// wrong on purpose: they exist to time K1 less one piece.
//
// What bounds it on this card: scalar instruction throughput and warp
// divergence, not bytes.  A job touches at most ~2 * w * tlen cells of
// its 8-byte (h, e) row, and the rows stay in L1/L2.  Threads of a warp
// finish when their own job dies, so a warp costs its longest job: the
// caller sorts jobs by target length (extend_fused.extend_seed_desc_np),
// which keeps the jobs of a warp alike.  The (h, e) scratch is job-minor
// ([W + 2][N] pairs), so the lanes of a warp at the same query column
// read neighbouring addresses.
//
// Later work (ROADMAP Queue 2): a warp per job with a __shfl_up_sync
// prefix max for F, the tile gather fused in, all four band trials in
// one launch, and int16 lanes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// ablation bits (tpubwa_torch/device/extend_kernel.py:ABLATE_BITS)
constexpr int kScan = 1, kPk = 2, kHopen = 4, kTrim = 8;

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// floor division for a positive divisor (the TPU kernel's `//`; the
// C++ truncates, and both agree once the result is clamped to >= 1)
__device__ __forceinline__ int floordiv(int x, int d) {
    int q = x / d;
    return (x % d != 0 && x < 0) ? q - 1 : q;
}

template <int ABLATE>
__global__ void __launch_bounds__(kThreads)
extend_kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ t,
              const int32_t* __restrict__ params, int32_t* __restrict__ out,
              int2* __restrict__ eh, int n, int W, int tmax, int pstride,
              int a, int b, int o_del, int e_del, int o_ins, int e_ins,
              int zdrop) {
    const int job = blockIdx.x * blockDim.x + threadIdx.x;
    if (job >= n) return;
    const int32_t* p = params + (size_t)job * pstride;
    const int qlen = p[0], tlen = p[1], h0 = p[2], w_in = p[3];
    const int end_bonus = p[4];
    const int32_t* qj = q + (size_t)job * W;
    const int32_t* tj = t + (size_t)job * tmax;
    // column j of this job's (eh_h, eh_e) row: eh_h[j] = H(i-1, j-1),
    // eh_e[j] = E(i, j)
    int2* col = eh + job;
    const size_t stride = (size_t)n;
    const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;

    int best = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
    int max_off = 0;
    // empty jobs (tlen <= 0: absent sides, masked retry rows) are dead
    // from the start
    if (tlen > 0) {
        // first row: the h0 ramp, clipped at 0
        col[0] = make_int2(h0, 0);
        for (int j = 1; j <= qlen; ++j)
            col[j * stride] = make_int2(imax(h0 - oe_ins - (j - 1) * e_ins,
                                             0), 0);
        // band cap w = min(w, max_ins, max_del), each >= 1
        const int max_ins = imax(
            floordiv(qlen * a + end_bonus - o_ins, e_ins) + 1, 1);
        const int max_del = imax(
            floordiv(qlen * a + end_bonus - o_del, e_del) + 1, 1);
        const int w = imin(w_in, imin(max_ins, max_del));
        const int rows = imin(tlen, tmax);
        int beg = 0, end = qlen;
        for (int i = 0; i < rows; ++i) {
            beg = imax(beg, i - w);
            end = imin(imin(end, i + w + 1), qlen);
            int h1 = beg == 0 ? imax(h0 - (o_del + e_del * (i + 1)), 0) : 0;
            if (beg >= end) {
                // band closed: write the boundary, take gscore, die
                col[end * stride] = make_int2(h1, 0);
                if (end == qlen && h1 >= gscore) { max_ie = i; gscore = h1; }
                break;
            }
            const int tb = tj[i];
            int f = 0, mrow = 0, mj = (ABLATE & kPk) ? 0 : -1;
            for (int j = beg; j < end; ++j) {
                const int2 c = col[j * stride];
                const int qc = qj[j];
                const int sc = (tb > 3 || qc > 3) ? -1 : (tb == qc ? a : -b);
                // M = H(i-1, j-1) + score, 0 where H(i-1, j-1) == 0
                const int M = c.x ? c.x + sc : 0;
                int e = c.y;
                int h = imax(M, e);
                if constexpr (!(ABLATE & kScan)) h = imax(h, f);
                if constexpr (ABLATE & kPk) {
                    if (j == 0) mrow = h;
                } else if (h >= mrow) {
                    // last-wins argmax ties (upstream `mj = m > h1 ? mj : j`)
                    mrow = h;
                    mj = j;
                }
                e = imax(e - e_del, imax(M - oe_del, 0));
                col[j * stride] = make_int2(h1, e);  // H(i, j-1) shifted
                h1 = h;
                if constexpr (!(ABLATE & kScan))
                    f = imax(f - e_ins, imax(M - oe_ins, 0));
            }
            col[end * stride] = make_int2(h1, 0);
            const int h_open = (ABLATE & kHopen) ? (end == 1 ? h1 : 0) : h1;
            if (end == qlen && h_open >= gscore) { max_ie = i; gscore = h_open; }
            if (mrow == 0) break;
            if (mrow > best) {
                best = mrow; max_i = i; max_j = mj;
                max_off = imax(max_off, mj > i ? mj - i : i - mj);
            } else if (zdrop > 0) {
                // asymmetric: the longer gap side pays its extension
                const int di = i - max_i, dj = mj - max_j;
                const int dd = di > dj ? (di - dj) * e_del : (dj - di) * e_ins;
                if (best - mrow - dd > zdrop) break;
            }
            if constexpr (ABLATE & kTrim) {
                // the first and last nonzero columns as lane 0 sees them
                if (beg == 0 && (col[0].x != 0 || col[0].y != 0)) {
                    end = imin(2, qlen);
                } else {
                    beg = end;
                    end = imin(end + 1, qlen);
                }
                continue;
            }
            // adaptive band trim to the first and last nonzero columns
            int nb = end;
            for (int j = beg; j < end; ++j) {
                const int2 c = col[j * stride];
                if (c.x != 0 || c.y != 0) { nb = j; break; }
            }
            beg = nb;
            int j = end;
            for (; j >= beg; --j) {
                const int2 c = col[j * stride];
                if (c.x != 0 || c.y != 0) break;
            }
            end = imin(j + 2, qlen);
        }
    }
    int32_t* o = out + (size_t)job * 6;
    o[0] = best;
    o[1] = max_j + 1;
    o[2] = max_i + 1;
    o[3] = max_ie + 1;
    o[4] = gscore;
    o[5] = max_off;
}

template <int ABLATE>
cudaError_t launch(const void* q, const void* t, const void* params,
                   void* out, void* eh, int n, int W, int tmax, int pstride,
                   int a, int b, int o_del, int e_del, int o_ins, int e_ins,
                   int zdrop, cudaStream_t stream) {
    const int blocks = (n + kThreads - 1) / kThreads;
    extend_kernel<ABLATE><<<blocks, kThreads, 0, stream>>>(
        (const int32_t*)q, (const int32_t*)t, (const int32_t*)params,
        (int32_t*)out, (int2*)eh, n, W, tmax, pstride, a, b, o_del, e_del,
        o_ins, e_ins, zdrop);
    return cudaGetLastError();
}

using Launch = decltype(&launch<0>);
constexpr Launch kFloor[16] = {
    launch<0>, launch<1>, launch<2>, launch<3>, launch<4>, launch<5>,
    launch<6>, launch<7>, launch<8>, launch<9>, launch<10>, launch<11>,
    launch<12>, launch<13>, launch<14>, launch<15>};

}  // namespace

// C entry point for ctypes.  Pointers are device pointers from
// torch.Tensor.data_ptr(); stream is torch's current cudaStream_t.
// Launches on that stream without synchronising and returns
// cudaGetLastError() (0 on success).
extern "C" int tpubwa_extend_batch(const void* q, const void* t,
                                   const void* params, void* out, void* eh,
                                   int n, int W, int tmax, int pstride,
                                   int a, int b, int o_del, int e_del,
                                   int o_ins, int e_ins, int zdrop,
                                   int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    return (int)launch<0>(q, t, params, out, eh, n, W, tmax, pstride, a, b,
                          o_del, e_del, o_ins, e_ins, zdrop,
                          (cudaStream_t)stream);
}

// K1-floor: tpubwa_extend_batch with `ablate_mask` (bits kScan 1, kPk 2,
// kHopen 4, kTrim 8) choosing the instantiation; mask 0 is K1.  An
// unknown mask launches nothing and returns cudaErrorInvalidValue.
extern "C" int tpubwa_extend_floor(const void* q, const void* t,
                                   const void* params, void* out, void* eh,
                                   int n, int W, int tmax, int pstride,
                                   int a, int b, int o_del, int e_del,
                                   int o_ins, int e_ins, int zdrop,
                                   int device, void* stream,
                                   int ablate_mask) {
    if (ablate_mask < 0 || ablate_mask >= 16)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    return (int)kFloor[ablate_mask](q, t, params, out, eh, n, W, tmax,
                                    pstride, a, b, o_del, e_del, o_ins,
                                    e_ins, zdrop, (cudaStream_t)stream);
}
