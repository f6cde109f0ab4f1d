// K1-real: K1's banded seed extension with one feature stripped per
// variant, for Hopper (sm_90a).
//
// Replaces: scripts/exp_kernel_real.py:build_kernel(variant), the Pallas
// kernel body `kernel` (:87) launched at :259.  Same contract at the
// Python wrapper (tpubwa_torch/scripts/exp_kernel_real.py:extend_real):
// q int32 [N, NL], t int32 [N, tmax], params int32 [N, pstride] with
// lanes (qlen, tlen, h0, w, end_bonus); out int32 [N, ostride], lanes
// 0-5 = (best, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off).  The
// scoring is the JAX kernel's fixed one (:59).
//
// Design: one thread per job runs K1's row loop (csrc/extend.cu), as a
// template over compile-time feature flags that follow the JAX script's
// has() (:60): scan, mj, wbmask, gscore, offtrack, zdrop and trim, plus
// an unroll factor over target rows.  Each stripped feature computes
// exactly what the JAX variant computes:
//   no-scan     F = he - 1 on every lane (:145-146), which never beats
//               he, so H = max(M, E) clamped at 0;
//   no-mj       mj = 0 (:166-167);
//   no-wbmask   the write-back reaches every lane (:181-183): lane end_i
//               takes H(end_i - 1), every other lane outside the band
//               0, and each E outside the band decays as max(E - e_del,
//               0).  That needs a full-width pass over the row, which
//               K1's band-only loop does not make;
//   no-gscore   gscore and max_ie stay -1;
//   no-offtrack max_off stays 0;
//   no-zdrop    no z-drop death;
//   no-trim     beg and end never move (the band is w alone).
// Every state update of the JAX body is gated on act, upd or alive, so
// a job past its tlen or dead runs no-op rows there: one thread per job
// computes what the whole launch computes, inside the wrapper's domain
// (tlen <= tmax).  `rollred` and `fused` are TPU reduction layouts (a
// roll tree instead of a lane reduction, the row max and its argmax
// packed into one max), not semantics: rollred-fused, -u2 and -u4 run
// the full instantiation, with the unroll factor as their only change.
//
// What bounds it on this card: as for K1, scalar instruction issue and
// warp divergence (a warp costs its longest job); the (h, e) scratch is
// job-minor ([NL][N] pairs), so a warp's lanes at one query column read
// neighbouring addresses.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// exp_kernel_real.py:59
constexpr int A = 1, B = 4, O_DEL = 6, E_DEL = 1, O_INS = 6, E_INS = 1;
constexpr int ZDROP = 100;

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// floor division for a positive divisor (the TPU kernel's `//`)
__device__ __forceinline__ int floordiv(int x, int d) {
    int q = x / d;
    return (x % d != 0 && x < 0) ? q - 1 : q;
}

// One job's state; row(i) runs target row i and returns false when the
// job dies on it.
template <bool SCAN, bool MJ, bool WBMASK, bool GSCORE, bool OFFTRACK,
          bool ZD, bool TRIM>
struct Job {
    const int32_t* qj;
    const int32_t* tj;
    int2* col;             // col[j * stride] = (eh_h[j], eh_e[j])
    size_t stride;
    int NL, qlen, h0, w;
    int beg, end, best, max_i, max_j, max_ie, gscore, max_off;

    __device__ __forceinline__ bool row(int i) {
        const int beg_i = imax(beg, i - w);
        const int end_i = imin(imin(end, i + w + 1), qlen);
        const int h1_first =
            beg_i == 0 ? imax(h0 - (O_DEL + E_DEL * (i + 1)), 0) : 0;
        if (beg_i >= end_i) {
            // band closed: the boundary write (a lane that exists), the
            // gscore test, death
            if (WBMASK && end_i >= 0 && end_i < NL)
                col[end_i * stride] = make_int2(h1_first, 0);
            if (GSCORE && end_i == qlen && h1_first >= gscore) {
                max_ie = i;
                gscore = h1_first;
            }
            return false;
        }
        const int tb = tj[i];
        // h_prev: the value written to eh_h at the next lane (eh_h[j] =
        // H(i, j - 1)); at beg_i it is h1_first, or with no-wbmask the
        // rolled-in H(i, beg_i - 1) = 0
        int f = 0, h_prev = WBMASK ? h1_first : 0, m = -1, mj = -1;
        for (int j = beg_i; j < end_i; ++j) {
            const int2 c = col[j * stride];
            const int qc = qj[j];
            const int sc = (tb > 3 || qc > 3) ? -1 : (tb == qc ? A : -B);
            const int M = c.x != 0 ? c.x + sc : 0;
            int h = imax(M, c.y);
            if (SCAN) h = imax(h, f);
            h = imax(h, 0);
            // last-wins argmax (ties take the later j)
            if (h >= m) {
                m = h;
                mj = j;
            }
            col[j * stride] = make_int2(
                h_prev, imax(c.y - E_DEL, imax(M - (O_DEL + E_DEL), 0)));
            h_prev = h;
            if (SCAN) f = imax(f - E_INS, imax(M - (O_INS + E_INS), 0));
        }
        if (!MJ) mj = 0;
        if (WBMASK) {
            col[end_i * stride] = make_int2(h_prev, 0);
        } else {
            for (int j = 0; j < NL; ++j) {
                if (j >= beg_i && j < end_i) continue;
                const int2 c = col[j * stride];
                col[j * stride] = make_int2(j == end_i ? h_prev : 0,
                                            imax(c.y - E_DEL, 0));
            }
        }
        if (GSCORE && end_i == qlen && h_prev >= gscore) {
            max_ie = i;
            gscore = h_prev;
        }
        if (m == 0) return false;
        if (m > best) {
            if (OFFTRACK) max_off = imax(max_off, mj > i ? mj - i : i - mj);
            best = m;
            max_i = i;
            max_j = mj;
        } else if (ZD) {
            // asymmetric: the longer gap side pays its extension
            const int di = i - max_i, dj = mj - max_j;
            const int dd = di > dj ? (di - dj) * E_DEL : (dj - di) * E_INS;
            if (best - m - dd > ZDROP) return false;
        }
        if (TRIM) {
            // adaptive band trim to the first and last nonzero columns
            int nb = end_i;
            for (int j = beg_i; j < end_i; ++j) {
                const int2 c = col[j * stride];
                if (c.x != 0 || c.y != 0) {
                    nb = j;
                    break;
                }
            }
            int j = end_i;
            for (; j >= nb; --j) {
                const int2 c = col[j * stride];
                if (c.x != 0 || c.y != 0) break;
            }
            beg = nb;
            end = imin(j + 2, qlen);
        }
        return true;
    }
};

template <bool SCAN, bool MJ, bool WBMASK, bool GSCORE, bool OFFTRACK,
          bool ZD, bool TRIM, int UNROLL>
__global__ void __launch_bounds__(kThreads)
extend_real_kernel(const int32_t* __restrict__ q,
                   const int32_t* __restrict__ t,
                   const int32_t* __restrict__ params,
                   int32_t* __restrict__ out, int2* __restrict__ eh, int n,
                   int NL, int tmax, int pstride, int ostride) {
    const int job = blockIdx.x * blockDim.x + threadIdx.x;
    if (job >= n) return;
    const int32_t* p = params + (size_t)job * pstride;
    const int qlen = p[0], tlen = p[1], h0 = p[2], w_in = p[3];
    const int end_bonus = p[4];
    Job<SCAN, MJ, WBMASK, GSCORE, OFFTRACK, ZD, TRIM> s;
    s.qj = q + (size_t)job * NL;
    s.tj = t + (size_t)job * tmax;
    s.col = eh + job;
    s.stride = (size_t)n;
    s.NL = NL;
    s.qlen = qlen;
    s.h0 = h0;
    const int max_ins = imax(
        floordiv(qlen * A + end_bonus - O_INS, E_INS) + 1, 1);
    const int max_del = imax(
        floordiv(qlen * A + end_bonus - O_DEL, E_DEL) + 1, 1);
    s.w = imin(w_in, imin(max_ins, max_del));
    s.beg = 0;
    s.end = qlen;
    s.best = h0;
    s.max_i = s.max_j = s.max_ie = s.gscore = -1;
    s.max_off = 0;
    // a job with tlen <= 0 is never active
    const int rows = imin(tlen, tmax);
    if (rows > 0) {
        // first row: eh_h[0] = h0, the ramp clipped at 0 up to lane
        // qlen, 0 past it (every lane: no-wbmask reads them all)
        for (int j = 0; j < NL; ++j) {
            const int h = j == 0 ? h0
                : (j <= qlen ? imax(h0 - (O_INS + E_INS) - (j - 1) * E_INS,
                                    0)
                             : 0);
            s.col[j * s.stride] = make_int2(h, 0);
        }
        // -u2/-u4: the compiler unrolls the row loop by UNROLL
#pragma unroll UNROLL
        for (int i = 0; i < rows; ++i)
            if (!s.row(i)) break;
    }
    int32_t* o = out + (size_t)job * ostride;
    o[0] = s.best;
    o[1] = s.max_j + 1;
    o[2] = s.max_i + 1;
    o[3] = s.max_ie + 1;
    o[4] = s.gscore;
    o[5] = s.max_off;
}

template <bool SCAN, bool MJ, bool WBMASK, bool GSCORE, bool OFFTRACK,
          bool ZD, bool TRIM, int UNROLL>
cudaError_t launch(const void* q, const void* t, const void* params,
                   void* out, void* eh, int n, int NL, int tmax,
                   int pstride, int ostride, cudaStream_t stream) {
    const int blocks = (n + kThreads - 1) / kThreads;
    extend_real_kernel<SCAN, MJ, WBMASK, GSCORE, OFFTRACK, ZD, TRIM, UNROLL>
        <<<blocks, kThreads, 0, stream>>>(
            (const int32_t*)q, (const int32_t*)t, (const int32_t*)params,
            (int32_t*)out, (int2*)eh, n, NL, tmax, pstride, ostride);
    return cudaGetLastError();
}

}  // namespace

// C entry point for ctypes.  `variant` is the index of the variant in
// exp_kernel_real.VARIANTS: 0 full, 1 rollred-fused, 2 rollred-fused-u2,
// 3 rollred-fused-u4, 4 no-scan, 5 no-mj, 6 no-wbmask, 7 no-gscore,
// 8 no-offtrack, 9 no-zdrop, 10 no-trim.  Pointers are device pointers
// from torch.Tensor.data_ptr(); stream is torch's current cudaStream_t.
// Launches on that stream without synchronising and returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for an
// unknown variant).
extern "C" int tpubwa_extend_real(int variant, const void* q, const void* t,
                                  const void* params, void* out, void* eh,
                                  int n, int NL, int tmax, int pstride,
                                  int ostride, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const auto args = [&](auto fn) {
        return (int)fn(q, t, params, out, eh, n, NL, tmax, pstride, ostride,
                       st);
    };
    //          scan   mj     wbmask gscore offtrk zdrop  trim   unroll
    switch (variant) {
    case 0:
    case 1:  // rollred-fused: a TPU reduction layout, the full semantics
        return args(launch<true, true, true, true, true, true, true, 1>);
    case 2:
        return args(launch<true, true, true, true, true, true, true, 2>);
    case 3:
        return args(launch<true, true, true, true, true, true, true, 4>);
    case 4:
        return args(launch<false, true, true, true, true, true, true, 1>);
    case 5:
        return args(launch<true, false, true, true, true, true, true, 1>);
    case 6:
        return args(launch<true, true, false, true, true, true, true, 1>);
    case 7:
        return args(launch<true, true, true, false, true, true, true, 1>);
    case 8:
        return args(launch<true, true, true, true, false, true, true, 1>);
    case 9:
        return args(launch<true, true, true, true, true, false, true, 1>);
    case 10:
        return args(launch<true, true, true, true, true, true, false, 1>);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
