// Batched banded Smith-Waterman seed extension (bwa ksw.c:ksw_extend2)
// with int16 DP cells, for Hopper (sm_90a).
//
// Replaces: scripts/exp_int16_kernel.py:_extend_kernel16, launched by
// extend_batch_pallas16 (K1 with int16 DP rows).  Same contract at the
// Python wrapper (tpubwa_torch/scripts/exp_int16_kernel.py:
// extend_batch16) as K1's (csrc/extend.cu): q int32 [N, W], t int32
// [N, tmax], params int32 [N, pstride] with lanes (qlen, tlen, h0, w,
// end_bonus); out int32 [N, 6] = (score, qle, tle, gtle, gscore,
// max_off).
//
// Design: K1's row loop (extend.cu), one thread per job, with the
// (h, e) scratch narrowed to short2: 4 bytes a cell instead of int2's 8,
// job-minor ([W + 2][N] pairs) as in K1.  The arithmetic stays in int
// registers; only the stored cells are narrowed.  That is what int16 DP
// lanes mean on this card: half the scratch bytes per row.  The TPU
// kernel's 16-bit lane layout is not carried over.  The wrapper holds
// every call to the JAX kernel's int16 domain (check_int16): there every
// H and E cell is at most h0 + a * qlen <= 32767, so each store is exact
// and the result equals K1's.
//
// What bounds it on this card: as for K1, scalar instruction issue and
// warp divergence (a warp costs its longest job).  A job's row stays in
// L1/L2, so the halved scratch bytes only matter once L1/L2 misses do.
//
// Later work (a perf_opt): packed 16-bit SIMD (__vmax2, __vadd2, ...)
// with two jobs to a 32-bit register.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// floor division for a positive divisor (the TPU kernel's `//`)
__device__ __forceinline__ int floordiv(int x, int d) {
    int q = x / d;
    return (x % d != 0 && x < 0) ? q - 1 : q;
}

__device__ __forceinline__ short2 cell(int h, int e) {
    return make_short2((short)h, (short)e);
}

__global__ void __launch_bounds__(kThreads)
extend16_kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ t,
                const int32_t* __restrict__ params, int32_t* __restrict__ out,
                short2* __restrict__ eh, int n, int W, int tmax, int pstride,
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
    short2* col = eh + job;
    const size_t stride = (size_t)n;
    const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;

    int best = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
    int max_off = 0;
    // empty jobs (tlen <= 0) are dead from the start
    if (tlen > 0) {
        // first row: the h0 ramp, clipped at 0
        col[0] = cell(h0, 0);
        for (int j = 1; j <= qlen; ++j)
            col[j * stride] = cell(imax(h0 - oe_ins - (j - 1) * e_ins, 0), 0);
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
                col[end * stride] = cell(h1, 0);
                if (end == qlen && h1 >= gscore) { max_ie = i; gscore = h1; }
                break;
            }
            const int tb = tj[i];
            int f = 0, mrow = 0, mj = -1;
            for (int j = beg; j < end; ++j) {
                const short2 c = col[j * stride];
                const int qc = qj[j];
                const int sc = (tb > 3 || qc > 3) ? -1 : (tb == qc ? a : -b);
                // M = H(i-1, j-1) + score, 0 where H(i-1, j-1) == 0
                const int M = c.x ? c.x + sc : 0;
                int e = c.y;
                const int h = imax(imax(M, e), f);
                // last-wins argmax ties (upstream `mj = m > h1 ? mj : j`)
                if (h >= mrow) { mrow = h; mj = j; }
                e = imax(e - e_del, imax(M - oe_del, 0));
                col[j * stride] = cell(h1, e);  // H(i, j-1) shifted
                h1 = h;
                f = imax(f - e_ins, imax(M - oe_ins, 0));
            }
            col[end * stride] = cell(h1, 0);
            if (end == qlen && h1 >= gscore) { max_ie = i; gscore = h1; }
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
            // adaptive band trim to the first and last nonzero columns
            int nb = end;
            for (int j = beg; j < end; ++j) {
                const short2 c = col[j * stride];
                if (c.x != 0 || c.y != 0) { nb = j; break; }
            }
            beg = nb;
            int j = end;
            for (; j >= beg; --j) {
                const short2 c = col[j * stride];
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

}  // namespace

// C entry point for ctypes, with tpubwa_extend_batch's argument list
// (eh is [W + 2][n] short2).  Launches on torch's current stream without
// synchronising and returns cudaGetLastError() (0 on success).
extern "C" int tpubwa_extend_batch16(const void* q, const void* t,
                                     const void* params, void* out, void* eh,
                                     int n, int W, int tmax, int pstride,
                                     int a, int b, int o_del, int e_del,
                                     int o_ins, int e_ins, int zdrop,
                                     int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    const int blocks = (n + kThreads - 1) / kThreads;
    extend16_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)q, (const int32_t*)t, (const int32_t*)params,
        (int32_t*)out, (short2*)eh, n, W, tmax, pstride, a, b, o_del, e_del,
        o_ins, e_ins, zdrop);
    return (int)cudaGetLastError();
}
