// Batched banded Smith-Waterman seed extension (bwa ksw.c:ksw_extend2)
// with int16 DP cells, for Hopper (sm_90a).
//
// Replaces: scripts/exp_int16_kernel.py:_extend_kernel16, launched by
// extend_batch_pallas16 (K1 with int16 DP rows).  Same contract at the
// Python wrapper (tpubwa_torch/scripts/exp_int16_kernel.py:
// extend_batch16) as K1's (csrc/extend.cu): q int32 [N, W], t int32
// [N, tmax], params int32 [N, pstride] with lanes (qlen, tlen, h0, w,
// end_bonus); out int32 [N, 6] = (score, qle, tle, gtle, gscore,
// max_off).  The wrapper holds every call to the JAX kernel's int16
// domain (check_int16): there every H, E and F value and every offset
// sum below fits a signed 16-bit half without wrapping, so the result
// equals K1's.
//
// What bounds it on this card: as for K1, instruction issue.  A job is
// a chain of dependent rows; K1's warp per job spends 89 SASS
// instructions on a strip of 32 columns and about 65 on a row, and
// capping its registers for more resident warps made it slower.  So
// the lever left is fewer instructions a cell.
//
// What the design does about it: K1's design (a warp per job over the
// live band, the row in shared memory, F by a shuffle prefix max) with
// two columns a lane, packed as the low and high halves of 32-bit
// registers, so a strip covers 64 columns:
//   * strips of 64 from beg & ~1: lane k holds columns j0 + 2k and
//     j0 + 2k + 1.  A job's row is words of (H pair, E pair), one
//     aligned 64-bit shared load a lane, with upstream's shifted layout:
//     the H half of column j holds H(i-1, j-1);
//   * the recurrence on Hopper's 16x2 instructions, each one SASS
//     instruction on sm_90: __viaddmax_s16x2 (max(a + b, c) a half),
//     __viaddmin_s16x2, __viaddmax_s16x2_relu, __vimin_s16x2_relu,
//     __vmaxs2 and __vadd2 (VIADDMNMX, VIMNMX, VIADD.16x2), and
//     __byte_perm (PRMT) to move halves.  The emulated SIMD forms
//     (__vsub2, __vcmpeq2, the saturating __vaddss2 / __vsubss2) are not
//     used: every offset is added as a precomputed negative, and no sum
//     can wrap, so none needs saturating;
//   * the score of both columns is one 32-bit load from a query profile
//     in shared memory (ksw.c's qp): prof[c][j] = the score of target
//     code c against query column j, for c = 0-3, 4 (N) and a row built
//     on the fly for a negative target code (the JAX kernel compares
//     codes by value), 6 rows of W int16 a job;
//   * M = 0 where H(i-1, j-1) == 0 (upstream's quirk) as min(H(i-1,
//     j-1) + score, Y), Y = 32767 where H(i-1, j-1) > 0 and 0 where it
//     is 0: every use of M takes a max with 0 or with E >= 0, so a
//     negative M there reads as 0.  The one column below an odd beg
//     reads as (0, 0), which gives it v = 0 and H = 0;
//   * F by a prefix max in the strip's own frame: v(c) = max(M(c) -
//     oe_ins, 0) + (c - j0) e_ins, a lane's two halves scanned inside
//     the lane, the lane maxima across lanes by __shfl_up_sync, and the
//     running max carried from strip to strip less 64 e_ins.  The
//     offsets are constants of the lane, and F(c) = max over u < c of
//     v(u) - (c - 1 - j0) e_ins never drops below -63 e_ins;
//   * the row max and its last-wins argmax as (H << sh) | column, each
//     lane's high column winning a tie, and the trim's first and last
//     nonzero columns, each kept by the lane across the strips and
//     reduced once a row (__reduce_max_sync, __reduce_min_sync), where
//     K1 reduces and ballots every strip;
//   * the lanes step their row and profile words by a constant from
//     strip to strip and load them unguarded: a warp's row is padded by
//     32 words, so the lanes past end read inside it.
// The boundary column end gets its pair (H(i, end - 1), 0) once a row
// from the lane that holds it, which also puts back column end + 1's
// pair where its word's store overwrote it: the next row may read that
// stale pair, as upstream does.  No global scratch is kept.
//
// With TPUBWA_WARP_HOST defined the file compiles as plain C++ against
// warp_host.h, which runs a warp's lanes in lockstep on the host and
// has host versions of the 16x2 intrinsics, so that the tests can hold
// this code to the plain version, under the sanitizers, on a machine
// with no card.

#include <cstdint>
#ifdef TPUBWA_WARP_HOST
#include "warp_host.h"
#else
#include <cuda_runtime.h>
extern __shared__ int2 smem[];
#define TPUBWA_LAUNCH(kernel, blocks, threads, bytes, stream, ...) \
    kernel<<<blocks, threads, bytes, stream>>>(__VA_ARGS__)
#endif

namespace {

// warps (jobs) a block, as K1's; a job's shared memory is 6 profile rows
// of QS int16 and RW words of (H pair, E pair)
constexpr int kWarps = 4;
constexpr int kProfRows = 6;  // codes 0-3, N, a negative code
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 1 << 30;  // no nonzero column in the lane
constexpr int kSmemDefault = 48 * 1024;  // above it a kernel must opt in

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// floor division for a positive divisor (the TPU kernel's `//`)
__device__ __forceinline__ int floordiv(int x, int d) {
    int q = x / d;
    return (x % d != 0 && x < 0) ? q - 1 : q;
}

// two int16 values as the low and high halves of a word
__device__ __forceinline__ unsigned pack2(int lo, int hi) {
    return ((unsigned)lo & 0xffffu) | ((unsigned)hi << 16);
}

// a profile row's int16 (even, so each row is word-aligned), and a row's
// words: W / 2 + 1 cover columns 0..W (end + 1 included), and 31 more
// let the lanes past end in a row's last strip read without a guard
__host__ __device__ __forceinline__ int prof_stride(int W) {
    return (W + 1) & ~1;
}
__host__ __device__ __forceinline__ int row_words(int W) { return W / 2 + 32; }

// the score of target code c against query code qc (a negative code
// matches only itself)
__device__ __forceinline__ int score(int c, int qc, int a, int b) {
    return (c > 3 || qc > 3) ? -1 : (c == qc ? a : -b);
}

__global__ void __launch_bounds__(kWarps * 32)
extend16_kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ t,
                const int32_t* __restrict__ params, int32_t* __restrict__ out,
                int n, int W, int tmax, int pstride, int sh, int a, int b,
                int o_del, int e_del, int o_ins, int e_ins, int zdrop) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int kscale = 1 << sh;
    const int job = blockIdx.x * kWarps + warp;
    if (job >= n) return;
    const int32_t* p = params + (size_t)job * pstride;
    const int qlen = p[0], tlen = p[1], h0 = p[2], w_in = p[3];
    const int end_bonus = p[4];
    const int32_t* qj = q + (size_t)job * W;
    const int32_t* tj = t + (size_t)job * tmax;
    const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;

    int best = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
    int max_off = 0;
    // empty jobs (tlen <= 0: absent sides, masked retry rows) are dead
    // from the start
    if (tlen > 0) {
        // the profiles of the block's warps, then their rows; row[p] =
        // (H(i-1, 2p-1) | H(i-1, 2p) << 16, E(i, 2p) | E(i, 2p+1) << 16)
        const int QS = prof_stride(W);
        int16_t* prof = reinterpret_cast<int16_t*>(smem) +
                        warp * kProfRows * QS;
        int2* row = reinterpret_cast<int2*>(
            reinterpret_cast<int16_t*>(smem) + kWarps * kProfRows * QS) +
            warp * row_words(W);
        for (int j = lane; j < QS; j += 32) {
            const int qc = j < qlen ? qj[j] : 4;
            for (int c = 0; c < 5; ++c)
                prof[c * QS + j] = (int16_t)score(c, qc, a, b);
        }
        // the first row: the h0 ramp, clipped at 0
        for (int pw = lane; 2 * pw <= qlen; pw += 32) {
            const int j = 2 * pw;
            const int hl = j ? imax(h0 - oe_ins - (j - 1) * e_ins, 0) : h0;
            const int hh = imax(h0 - oe_ins - j * e_ins, 0);
            row[pw] = make_int2((int)pack2(hl, hh), 0);
        }
        __syncwarp();
        // band cap w = min(w, max_ins, max_del), each >= 1
        const int max_ins = imax(
            floordiv(qlen * a + end_bonus - o_ins, e_ins) + 1, 1);
        const int max_del = imax(
            floordiv(qlen * a + end_bonus - o_del, e_del) + 1, 1);
        const int w = imin(w_in, imin(max_ins, max_del));
        const int rows = imin(tlen, tmax);
        // the lane's offsets in a strip's frame (columns 2k and 2k + 1
        // of the strip): (c - j0) e_ins, the same less oe_ins, and
        // -(c - 1 - j0) e_ins; the carry's step from strip to strip
        const int k2 = 2 * lane;
        const unsigned je = pack2(k2 * e_ins, (k2 + 1) * e_ins);
        const unsigned jeo = pack2(k2 * e_ins - oe_ins,
                                   (k2 + 1) * e_ins - oe_ins);
        const unsigned nje1 = pack2((1 - k2) * e_ins, -k2 * e_ins);
        const unsigned nstep = pack2(-64 * e_ins, -64 * e_ins);
        const unsigned ned = pack2(-e_del, -e_del);
        const unsigned nod = pack2(-oe_del, -oe_del);
        const unsigned carry0 = pack2(-e_ins, -e_ins);
        int beg = 0, end = qlen, tcodes = 4;
        // target row i; false when the job dies on it
        const auto step = [&](int i) -> bool {
            // lane k holds the target code of row (i & ~31) + k
            if ((i & 31) == 0) tcodes = i + lane < rows ? tj[i + lane] : 4;
            beg = imax(beg, i - w);
            end = imin(imin(end, i + w + 1), qlen);
            const int h1 = beg == 0 ? imax(h0 - (o_del + e_del * (i + 1)), 0)
                                    : 0;
            if (beg >= end) {
                // band closed: take gscore and die (upstream also writes
                // the boundary pair, which nothing reads again)
                if (end == qlen && h1 >= gscore) {
                    max_ie = i;
                    gscore = h1;
                }
                return false;
            }
            const int tb = __shfl_sync(kFull, tcodes, i & 31);
            int prow = tb > 3 ? 4 : tb;
            if (tb < 0) {
                // a code no profile row holds: build row 5 for it
                for (int j = lane; j < QS; j += 32)
                    prof[5 * QS + j] =
                        (int16_t)score(tb, j < qlen ? qj[j] : 4, a, b);
                __syncwarp();
                prow = 5;
            }
            const int16_t* sc_row = prof + prow * QS;
            // carried from strip to strip: the F scan's running max (both
            // halves), and H(i, j0 - 1) in the high half for the first
            // lane's write-back
            unsigned carry_f = carry0, carry_h = (unsigned)h1 << 16;
            // the lane's argmax key, and its first and last column whose
            // written pair is nonzero, over the row's cells
            int pk = -1, first = kNone, last = -1, j0 = beg & ~1;
            unsigned hd, e, hp, en;
            // the lane's word of the row and of the profile
            int2* rw = row + (j0 >> 1) + lane;
            const unsigned* sw =
                reinterpret_cast<const unsigned*>(sc_row + j0) + lane;
            // strips of 64 columns over [beg & ~1, end]: the halves below
            // end compute a cell each, the half at end is the boundary.  The
            // lanes past end read words that nothing in this row writes
            // (the row's padding at most) and compute what no cell takes
            for (;; j0 += 64, rw += 32, sw += 32) {
                const int j = j0 + k2;
                const int2 c = *rw;
                hd = (unsigned)c.x;
                e = (unsigned)c.y;
                const unsigned sc = *sw;
                // the column below an odd beg is not the band's: (0, 0) in
                // place of its stale pair makes its v 0 and its H 0, which
                // the write-back takes as H(i, beg - 1) = h1 (0 for beg > 0)
                const unsigned keep = j >= beg ? ~0u : 0xffff0000u;
                hd &= keep;
                e &= keep;
                // Y: 32767 where H(i-1, c-1) > 0, else 0
                const unsigned y = __vimin_s16x2_relu(hd, 0x10001u) * 0x7fffu;
                const unsigned m = __viaddmin_s16x2(hd, sc, y);
                const unsigned he = __vmaxs2(m, e);
                // F: the scan of v = max(M - oe_ins, 0) + (c - j0) e_ins,
                // inside the lane, then across the lanes (a lane below d
                // gets its own value back from the shuffle)
                const unsigned v = __viaddmax_s16x2(m, jeo, je);
                unsigned s = __vmaxs2(v, __byte_perm(v, 0, 0x1032));
#pragma unroll
                for (int d = 1; d < 32; d <<= 1)
                    s = __vmaxs2(s, __shfl_up_sync(kFull, s, d));
                s = __vmaxs2(s, carry_f);
                unsigned x = __shfl_up_sync(kFull, s, 1);
                if (lane == 0) x = carry_f;
                carry_f = __vadd2(__shfl_sync(kFull, s, 31), nstep);
                // the max of v over the columns left of each half
                const unsigned fs = __vmaxs2(x, __byte_perm(x, v, 0x5410));
                const unsigned h = __viaddmax_s16x2(fs, nje1, he);
                // (H(i, c-1), H(i, c)) shifted into the lane's columns: the
                // low one from the lane to the left
                unsigned hl = __shfl_up_sync(kFull, h, 1);
                if (lane == 0) hl = carry_h;
                carry_h = __shfl_sync(kFull, h, 31);
                hp = __byte_perm(hl, h, 0x5432);
                en = __viaddmax_s16x2_relu(e, ned, __vadd2(m, nod));
                if (j <= end) *rw = make_int2((int)hp, (int)en);
                // the cells of [beg, end): last-wins argmax keys (H << sh) |
                // column, and the nonzero pairs just written
                const bool lo_in = j >= beg && j < end, hi_in = j + 1 < end;
                const int klo = lo_in ? (int)(h & 0xffffu) * kscale + j : -1;
                const int khi = hi_in ? (int)(h >> 16) * kscale + j + 1 : -1;
                pk = imax(pk, imax(klo, khi));
                const unsigned nz = hp | en;
                const bool lo_nz = lo_in && (nz & 0xffffu);
                const bool hi_nz = hi_in && (nz >> 16);
                first = imin(first, lo_nz ? j : hi_nz ? j + 1 : kNone);
                last = imax(last, hi_nz ? j + 1 : lo_nz ? j : -1);
                if (j0 + 64 > end) break;
            }
            // the boundary column end, in this last strip: its pair is
            // (H(i, end - 1), 0), and column end + 1 keeps what it held
            // (the next row's band may reach it, and reads upstream's
            // stale pair there)
            const int le = (end - j0) >> 1;
            const unsigned hb = __shfl_sync(kFull, hp, le);
            const int hlast = (int)(end & 1 ? hb >> 16 : hb & 0xffffu);
            // (that lane's word in the last strip is word end >> 1)
            if (lane == le)
                *rw = end & 1 ? make_int2((int)hp, (int)(en & 0xffffu))
                              : make_int2((int)__byte_perm(hp, hd, 0x7610),
                                          (int)(e & 0xffff0000u));
            pk = __reduce_max_sync(kFull, pk);
            const int mrow = pk >> sh, mj = pk & (kscale - 1);
            if (end == qlen && hlast >= gscore) {
                max_ie = i;
                gscore = hlast;
            }
            if (mrow == 0) return false;
            if (mrow > best) {
                best = mrow; max_i = i; max_j = mj;
                max_off = imax(max_off, mj > i ? mj - i : i - mj);
            } else if (zdrop > 0) {
                // asymmetric: the longer gap side pays its extension
                const int di = i - max_i, dj = mj - max_j;
                const int dd = di > dj ? (di - dj) * e_del : (dj - di) * e_ins;
                if (best - mrow - dd > zdrop) return false;
            }
            // adaptive band trim to the first nonzero column of [beg, end)
            // and the last of [beg, end] (column end's pair is (H(i,
            // end - 1), 0))
            first = __reduce_min_sync(kFull, first);
            last = __reduce_max_sync(kFull, last);
            beg = first < kNone ? first : end;
            end = imin((hlast ? end : last >= 0 ? last : beg - 1) + 2, qlen);
            // the next row's lanes read columns that other lanes wrote
            __syncwarp();
            return true;
        };
        for (int i = 0; i < rows; ++i)
            if (!step(i)) break;
    }
    if (lane == 0) {
        int32_t* o = out + (size_t)job * 6;
        o[0] = best;
        o[1] = max_j + 1;
        o[2] = max_i + 1;
        o[3] = max_ie + 1;
        o[4] = gscore;
        o[5] = max_off;
    }
}

// a block's dynamic shared memory at width W; past the default limit the
// kernel opts in, and past the card's limit for a block that fails
cudaError_t block_bytes(int W, size_t* bytes) {
    *bytes = (size_t)kWarps * (kProfRows * prof_stride(W) * sizeof(int16_t) +
                               row_words(W) * sizeof(int2));
    if (*bytes <= (size_t)kSmemDefault) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        extend16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)*bytes);
    // the refusal is returned, not left behind for the next launch's
    // cudaGetLastError
    if (err != cudaSuccess) cudaGetLastError();
    return err;
}

}  // namespace

// C entry point for ctypes, with tpubwa_extend_batch's argument list.
// Pointers are device pointers from torch.Tensor.data_ptr(); stream is
// torch's current cudaStream_t.  Launches on that stream without
// synchronising and returns cudaGetLastError() (0 on success); a W whose
// block would need more shared memory than the card allows returns an
// error and launches nothing.
extern "C" int tpubwa_extend_batch16(const void* q, const void* t,
                                     const void* params, void* out, int n,
                                     int W, int tmax, int pstride, int a,
                                     int b, int o_del, int e_del, int o_ins,
                                     int e_ins, int zdrop, int device,
                                     void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    size_t bytes;
    err = block_bytes(W, &bytes);
    if (err != cudaSuccess) return (int)err;  // refused: no launch is made
    const int blocks = (n + kWarps - 1) / kWarps;
    int sh = 0;  // the argmax's bits: 2^sh >= W
    while ((1 << sh) < W) ++sh;
    TPUBWA_LAUNCH(extend16_kernel, blocks, kWarps * 32, bytes,
                  (cudaStream_t)stream, (const int32_t*)q, (const int32_t*)t,
                  (const int32_t*)params, (int32_t*)out, n, W, tmax, pstride,
                  sh, a, b, o_del, e_del, o_ins, e_ins, zdrop);
    return (int)cudaGetLastError();
}
