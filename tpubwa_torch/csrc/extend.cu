// Batched banded Smith-Waterman seed extension (bwa ksw.c:ksw_extend2)
// for Hopper (sm_90a), under a general 5 x 5 scoring matrix (K1-mat), and
// its timing-only ablations (K1-floor, K1-real).
//
// Replaces: tpubwa/device/extend_pallas.py:_extend_kernel, launched by
// extend_batch_pallas.  Same contract at the Python wrapper
// (tpubwa_torch/device/extend_kernel.py:extend_batch): q int32 [N, W],
// t int32 [N, tmax], params int32 [N, pstride] with lanes (qlen, tlen,
// h0, w, end_bonus); out int32 [N, ostride], lanes 0-5 = (score, qle,
// tle, gtle, gscore, max_off).  Codes are 0-3 for bases and anything
// above for N (query codes are kept as bytes).  K1's score is match a /
// mismatch -b / N -1 arithmetic, with no profile table; K1-mat's (below)
// is a 5 x 5 table.
//
// What bounds it on this card: operations, and under them latency.  A
// job is a chain of dependent rows, each a chain of dependent steps, and
// its working set is one (h, e) row of W + 2 pairs, 1-4 KB.  The bytes
// are nothing (inputs once, 24 bytes out).  So the card is full only
// when every SM holds many jobs at once, and a row is short only when
// its cells are computed side by side.
//
// What the design does about it:
//   * a warp per job.  N jobs are N warps, kWarps a block, so every SM
//     has tens of rows in flight to hide each other's latency; the 32
//     lanes share one beg, end, row and death, so nothing diverges, and
//     an empty job (tlen <= 0) leaves at once;
//   * the (h, e) row and the query codes in shared memory, the target
//     codes in a register, 32 rows a load.  There is no global scratch;
//   * lanes follow the live band: row i covers [beg, end] in strips of
//     32 columns from beg, so a narrow band is one strip and the work
//     stays proportional to band cells.  A lane reads its own column's
//     pair (H(i-1, j-1), E(i, j)), upstream's shifted layout, and writes
//     back its own column's: H(i, j-1) comes from the lane to its left
//     by a shuffle, so no lane reads what another writes within a row;
//   * F by a prefix max (extend_pallas.py:_prefix_max): F(j) = max over
//     u < j of (t_ins[u] + u e_ins) - (j - 1) e_ins, an inclusive max
//     scan over the strip by __shfl_up_sync with the running max carried
//     from strip to strip.  Max is exact, so it equals upstream's chain;
//   * the row max and its last-wins argmax in one __reduce_max_sync of
//     (H << sh) | j, 2^sh >= W (H < 2^(31 - sh), the plain version's own
//     limit: the wrapper refuses jobs past it), and the band trim from one __ballot_sync per strip of the
//     pairs just written, so the row is not read a second time.
// TMA, wgmma and thread block clusters have nothing to offer here: the
// recurrence is integer max/add along a wavefront, there is no matrix
// product in it, and a job's tiles are read once, a few hundred bytes.
//
// K1-floor: the same kernel body, templated on the JAX kernel's
// `ablate` flags (extend_pallas.py:224-233, 271-286), as a bit mask.
// With every bit clear the instantiation is K1.  Each ablation swaps the
// value that feeds one of the body's gated updates for what lane 0 of
// the JAX kernel's row (column 0) would give, and leaves out the warp
// operation that computed it:
//   kScan   no F gap scan (the shuffle scan): F = NEG past beg, so
//           H = max(M, E) (E >= 0);
//   kPk     no row reduction (__reduce_max_sync): m = H(i, 0) when
//           beg == 0, else 0 (NEG's packed value), and mj = 0;
//   kHopen  no broadcast of the boundary lane: h_open = H(i, 0) when
//           end == 1 (the row max of a one-cell band), else 0 (it feeds
//           only the gscore test; the write-back keeps H);
//   kTrim   no ballots: beg 0 and end min(2, qlen) when beg == 0 and
//           column 0 is nonzero, else beg = end and end = min(end + 1,
//           qlen).
// The JAX `trees` ablation is kPk | kHopen | kTrim.  These variants are
// wrong on purpose: they exist to time K1 less one piece.
//
// K1-mat (tpubwa/device/extend.py:33 extend_batch, an XLA fori_loop over
// the target rows, :172): K1's body, instantiation kMat, whose cell score
// is mat[t][q] from a 25-int table, behind tpubwa_extend_mat.  Codes 0-3
// are bases and anything else (N, the padding) is row or column 4, on
// both sides.  The table comes by value as a kernel parameter; each warp
// copies it into its own 25 ints of shared memory once (static indices:
// a kernel parameter indexed at run time would go through local memory),
// and a cell reads its score there, from the row of the target base, so
// a score is one shared load where K1 compares and selects.  The band
// cap and the wrapper's bound on the packed row max take mmax =
// max(max(mat), 0) where K1 takes a (bwa's ksw_extend2 does the same):
// the entry passes mmax as a.  At a bwa_fill_scmat matrix it computes
// K1's rows exactly.
//
// K1-real (scripts/exp_kernel_real.py:build_kernel, body :87, launched
// at :259): K1's body with one feature stripped per variant, under the
// script's fixed scoring (:59), passed at run time, behind
// tpubwa_extend_real.  Each variant is an instantiation, and each
// stripped feature computes exactly what the JAX variant computes:
//   full, rollred-fused  K1 itself (the roll trees and the packed argmax
//                are TPU reduction layouts, not semantics);
//   -u2, -u4     K1 with the row loop unrolled 2 / 4 times (kUnroll2,
//                kUnroll4): the script unrolls its while_loop body to
//                amortise its cond, rows past death are no-ops there;
//   no-scan      kScan: the script's F = he - 1 never beats he;
//   no-zdrop     K1 with zdrop 0 (the runtime argument, no instantiation);
//   no-mj        kNoMj: the row max alone, mj = 0 (:163-167);
//   no-gscore    kNoGscore: no boundary-lane broadcast, gscore and max_ie
//                stay -1 (:184-192);
//   no-offtrack  kNoOfftrack: max_off stays 0 (:197-200);
//   no-trim      kNoTrim: no ballots, beg and end never move, so the band
//                is w alone (:214-234; K1-floor's kTrim is another thing);
//   no-wbmask    kNoWbmask: the write-back reaches every column
//                (:181-183): the first lane's carry is 0, not h1; column
//                end takes E decayed, max(E - e_del, 0), not 0; a full
//                pass over the rest of the row, one lane a column, gives
//                each column outside [beg, end] (0, max(E - e_del, 0)).
//                Columns past qlen hold (0, 0) in the script and are
//                never read, so the pass stops at qlen.
//
// With TPUBWA_WARP_HOST defined the file compiles as plain C++ against
// warp_host.h, which runs a warp's lanes in lockstep on the host, so
// that the tests can hold this code to the plain version, under the
// sanitizers, on a machine with no card.

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

// warps (jobs) a block, chosen on the card (1 to 8 read the same there,
// 16 slower); a job's shared memory is (W + 2) pairs and W bytes, so a
// block's is kWarps * (9 W + 16) bytes.  The registers a thread are left
// to the compiler: capping them for more resident warps read slower
constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = -(1 << 29);
constexpr int kSmemDefault = 48 * 1024;  // above it a kernel must opt in
// ablation bits (tpubwa_torch/device/extend_kernel.py:ABLATE_BITS)
constexpr int kScan = 1, kPk = 2, kHopen = 4, kTrim = 8;
// K1-real's bits, above K1-floor's
constexpr int kNoMj = 16, kNoGscore = 32, kNoOfftrack = 64, kNoTrim = 128,
              kNoWbmask = 256, kUnroll2 = 512, kUnroll4 = 1024;
// K1-mat: the score from a 5 x 5 table
constexpr int kMat = 2048;

// mat[t][q], row-major; only kMat reads it
struct ScoreTable {
    int s[25];
};

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// floor division for a positive divisor (the TPU kernel's `//`; the
// C++ truncates, and both agree once the result is clamped to >= 1)
__device__ __forceinline__ int floordiv(int x, int d) {
    int q = x / d;
    return (x % d != 0 && x < 0) ? q - 1 : q;
}

template <int ABLATE>
__global__ void __launch_bounds__(kWarps * 32)
extend_kernel(const int32_t* __restrict__ q, const int32_t* __restrict__ t,
              const int32_t* __restrict__ params, int32_t* __restrict__ out,
              int n, int W, int tmax, int pstride, int ostride, int sh,
              int a, int b, int o_del, int e_del, int o_ins, int e_ins,
              int zdrop, const ScoreTable tab) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int job = blockIdx.x * kWarps + warp;
    if (job >= n) return;
    // kMat: the warp's copy of the table, after the block's query codes
    int* stab = nullptr;
    if constexpr (ABLATE & kMat) {
        stab = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(
                   smem + kWarps * (W + 2)) + kWarps * W) + warp * 25;
#pragma unroll
        for (int k = 0; k < 25; ++k)
            if (lane == k) stab[k] = tab.s[k];
        __syncwarp();
    }
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
        // column j of this job's row: row[j] = (H(i-1, j-1), E(i, j))
        int2* row = smem + warp * (W + 2);
        unsigned char* qs = reinterpret_cast<unsigned char*>(
            smem + kWarps * (W + 2)) + warp * W;
        // the query codes, once, and the first row: the h0 ramp, clipped
        // at 0
        for (int j = lane; j < qlen; j += 32) {
            const int qc = qj[j];
            qs[j] = (unsigned)qc > 3u ? 4 : qc;
        }
        for (int j = lane; j <= qlen; j += 32)
            row[j] = make_int2(
                j ? imax(h0 - oe_ins - (j - 1) * e_ins, 0) : h0, 0);
        __syncwarp();
        // band cap w = min(w, max_ins, max_del), each >= 1
        const int max_ins = imax(
            floordiv(qlen * a + end_bonus - o_ins, e_ins) + 1, 1);
        const int max_del = imax(
            floordiv(qlen * a + end_bonus - o_del, e_del) + 1, 1);
        const int w = imin(w_in, imin(max_ins, max_del));
        const int rows = imin(tlen, tmax);
        int beg = 0, end = qlen, tcodes = 4;
        // target row i; false when the job dies on it
        const auto step = [&](int i) -> bool {
            // lane k holds the target code of row (i & ~31) + k
            if ((i & 31) == 0) tcodes = i + lane < rows ? tj[i + lane] : 4;
            if constexpr (ABLATE & kNoTrim) {
                beg = imax(i - w, 0);
                end = imin(i + w + 1, qlen);
            } else {
                beg = imax(beg, i - w);
                end = imin(imin(end, i + w + 1), qlen);
            }
            const int h1 = beg == 0 ? imax(h0 - (o_del + e_del * (i + 1)), 0)
                                    : 0;
            if (beg >= end) {
                // band closed: take gscore and die (upstream also writes
                // the boundary pair, which nothing reads again)
                if constexpr (!(ABLATE & kNoGscore)) {
                    if (end == qlen && h1 >= gscore) {
                        max_ie = i;
                        gscore = h1;
                    }
                }
                return false;
            }
            const int tb = __shfl_sync(kFull, tcodes, i & 31);
            // kMat: the table's row of this target base (N: row 4)
            const int* srow =
                (ABLATE & kMat) ? stab + 5 * ((unsigned)tb > 3u ? 4 : tb)
                                : nullptr;
            // carried from strip to strip: the F scan's running max, and
            // H(i, j0 - 1) for the first lane's write-back (no-wbmask
            // rolls in the 0 left of the band)
            int carry_f = kNeg, carry_h = (ABLATE & kNoWbmask) ? 0 : h1;
            int pk = -1, m0 = 0, hlast = 0, first_j0 = 0, last_j0 = 0;
            unsigned first_nz = 0, last_nz = 0;
            bool nz0 = false;
            // strips of 32 columns over [beg, end]: the lanes below end
            // compute a cell each, the lane at end writes the boundary
            for (int j0 = beg; j0 <= end; j0 += 32) {
                const int j = j0 + lane;
                const bool in = j < end;
                int hd = 0, e = 0, qc = 4;
                if (in) {
                    const int2 c = row[j];
                    hd = c.x;
                    e = c.y;
                    qc = qs[j];
                }
                const int sc = (ABLATE & kMat)
                                   ? srow[qc]
                                   : (tb > 3 || qc > 3) ? -1
                                                        : (tb == qc ? a : -b);
                // M = H(i-1, j-1) + score, 0 where H(i-1, j-1) == 0
                const int M = hd ? hd + sc : 0;
                int h = imax(M, e);
                if constexpr (!(ABLATE & kScan)) {
                    // inclusive max scan of t_ins[u] + u e_ins; lanes
                    // past the band hold NEG, and a lane below d gets
                    // its own value back from the shuffle
                    int v = in ? imax(M - oe_ins, 0) + j * e_ins : kNeg;
#pragma unroll
                    for (int d = 1; d < 32; d <<= 1)
                        v = imax(v, __shfl_up_sync(kFull, v, d));
                    v = imax(v, carry_f);
                    int f = __shfl_up_sync(kFull, v, 1);
                    if (lane == 0) f = carry_f;
                    carry_f = __shfl_sync(kFull, v, 31);
                    // F(beg) = 0 <= h; there f is NEG and changes nothing
                    h = imax(h, f - (j - 1) * e_ins);
                }
                // H(i, j-1), shifted into this lane's column
                int hp = __shfl_up_sync(kFull, h, 1);
                if (lane == 0) hp = carry_h;
                carry_h = __shfl_sync(kFull, h, 31);
                int en = in ? imax(e - e_del, imax(M - oe_del, 0)) : 0;
                if constexpr (ABLATE & kNoWbmask) {
                    // the boundary column's E decays too
                    if (j == end) en = imax(row[j].y - e_del, 0);
                }
                if (j <= end) row[j] = make_int2(hp, en);
                if constexpr (ABLATE & kPk) {
                    if (j0 == 0) m0 = __shfl_sync(kFull, h, 0);
                } else if constexpr (ABLATE & kNoMj) {
                    pk = imax(pk, __reduce_max_sync(kFull, in ? h : -1));
                } else {
                    // last-wins argmax ties (upstream `mj = m > h1 ? mj : j`)
                    pk = imax(pk, __reduce_max_sync(
                        kFull, in ? (h << sh) | j : -1));
                }
                // the boundary lane, in the row's last strip
                const int lb = end - j0;
                if constexpr (!(ABLATE & (kHopen | kNoGscore))) {
                    const int hb = __shfl_sync(kFull, hp, lb & 31);
                    if (lb < 32) hlast = hb;
                }
                if constexpr (ABLATE & kTrim) {
                    if (j0 == 0)
                        nz0 = __shfl_sync(kFull, (hp | en) != 0, 0);
                } else if constexpr (!(ABLATE & kNoTrim)) {
                    // nonzero pairs just written: the first strip that
                    // has one below end, the last that has one at all
                    const unsigned nz = __ballot_sync(
                        kFull, j <= end && (hp | en) != 0);
                    const unsigned nzb = lb < 32 ? nz & ~(1u << lb) : nz;
                    if (!first_nz && nzb) { first_nz = nzb; first_j0 = j0; }
                    if (nz) { last_nz = nz; last_j0 = j0; }
                }
            }
            int mrow, mj;
            if constexpr (ABLATE & kPk) {
                mrow = m0;
                mj = 0;
            } else if constexpr (ABLATE & kNoMj) {
                mrow = pk;
                mj = 0;
            } else {
                mrow = pk >> sh;
                mj = pk & ((1 << sh) - 1);
            }
            // lane 0's h_open: a band of the one cell (i, 0) has its max there
            if constexpr (ABLATE & kHopen) hlast = end == 1 ? mrow : 0;
            if constexpr (!(ABLATE & kNoGscore)) {
                if (end == qlen && hlast >= gscore) {
                    max_ie = i;
                    gscore = hlast;
                }
            }
            if (mrow == 0) return false;
            if (mrow > best) {
                best = mrow; max_i = i; max_j = mj;
                if constexpr (!(ABLATE & kNoOfftrack))
                    max_off = imax(max_off, mj > i ? mj - i : i - mj);
            } else if (zdrop > 0) {
                // asymmetric: the longer gap side pays its extension
                const int di = i - max_i, dj = mj - max_j;
                const int dd = di > dj ? (di - dj) * e_del : (dj - di) * e_ins;
                if (best - mrow - dd > zdrop) return false;
            }
            if constexpr (ABLATE & kNoWbmask) {
                // the rest of the row up to qlen, one lane a column: its
                // columns are not the band's, and the band pass is done
                __syncwarp();
                for (int j = lane; j <= qlen; j += 32)
                    if (j < beg || j > end)
                        row[j] = make_int2(0, imax(row[j].y - e_del, 0));
            }
            if constexpr (ABLATE & kTrim) {
                // the first and last nonzero columns as lane 0 sees them
                if (beg == 0 && nz0) {
                    end = imin(2, qlen);
                } else {
                    beg = end;
                    end = imin(end + 1, qlen);
                }
            } else if constexpr (!(ABLATE & kNoTrim)) {
                // adaptive band trim to the first nonzero column of
                // [beg, end) and the last of [beg, end]
                beg = first_nz ? first_j0 + __ffs(first_nz) - 1 : end;
                end = imin((last_nz ? last_j0 + 31 - __clz(last_nz)
                                    : beg - 1) + 2, qlen);
            }
            // the next row's lanes read columns that other lanes wrote
            __syncwarp();
            return true;
        };
        if constexpr (ABLATE & (kUnroll2 | kUnroll4)) {
            // -u2 / -u4: the compiler unrolls the row loop (the host
            // compiler ignores the pragma)
#pragma unroll ((ABLATE & kUnroll4) ? 4 : 2)
            for (int i = 0; i < rows; ++i)
                if (!step(i)) break;
        } else {
            for (int i = 0; i < rows; ++i)
                if (!step(i)) break;
        }
    }
    if (lane == 0) {
        int32_t* o = out + (size_t)job * ostride;
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
template <int ABLATE>
cudaError_t block_bytes(int W, size_t* bytes) {
    *bytes = (size_t)kWarps * ((W + 2) * sizeof(int2) + W +
                              ((ABLATE & kMat) ? 25 * sizeof(int) : 0));
    if (*bytes <= (size_t)kSmemDefault) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        extend_kernel<ABLATE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)*bytes);
    // the refusal is returned, not left behind for the next launch's
    // cudaGetLastError
    if (err != cudaSuccess) cudaGetLastError();
    return err;
}

// a launch of instantiation ABLATE; only kMat reads tab
template <int ABLATE>
cudaError_t launch_with(const void* q, const void* t, const void* params,
                        void* out, int n, int W, int tmax, int pstride,
                        int ostride, int a, int b, int o_del, int e_del,
                        int o_ins, int e_ins, int zdrop, cudaStream_t stream,
                        const ScoreTable& tab) {
    size_t bytes;
    cudaError_t err = block_bytes<ABLATE>(W, &bytes);
    if (err != cudaSuccess) return err;  // refused: no launch is made
    const int blocks = (n + kWarps - 1) / kWarps;
    int sh = 0;  // the argmax's bits: 2^sh >= W
    while ((1 << sh) < W) ++sh;
    TPUBWA_LAUNCH(extend_kernel<ABLATE>, blocks, kWarps * 32, bytes, stream,
                  (const int32_t*)q, (const int32_t*)t,
                  (const int32_t*)params, (int32_t*)out, n, W, tmax, pstride,
                  ostride, sh, a, b, o_del, e_del, o_ins, e_ins, zdrop, tab);
    return cudaGetLastError();
}

template <int ABLATE>
cudaError_t launch(const void* q, const void* t, const void* params,
                   void* out, int n, int W, int tmax, int pstride,
                   int ostride, int a, int b, int o_del, int e_del,
                   int o_ins, int e_ins, int zdrop, cudaStream_t stream) {
    return launch_with<ABLATE>(q, t, params, out, n, W, tmax, pstride,
                               ostride, a, b, o_del, e_del, o_ins, e_ins,
                               zdrop, stream, ScoreTable{});
}

#ifndef TPUBWA_WARP_HOST
// the runtime's count of blocks of one instantiation that an SM holds
template <int ABLATE>
cudaError_t occupancy(int W, int* blocks_per_sm, int* bytes_out) {
    size_t bytes;
    cudaError_t err = block_bytes<ABLATE>(W, &bytes);
    if (err != cudaSuccess) return err;
    *bytes_out = (int)bytes;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, extend_kernel<ABLATE>, kWarps * 32, bytes);
}

using Occupancy = decltype(&occupancy<0>);
constexpr Occupancy kOccupancy[16] = {
    occupancy<0>, occupancy<1>, occupancy<2>, occupancy<3>, occupancy<4>,
    occupancy<5>, occupancy<6>, occupancy<7>, occupancy<8>, occupancy<9>,
    occupancy<10>, occupancy<11>, occupancy<12>, occupancy<13>,
    occupancy<14>, occupancy<15>};
#endif

using Launch = decltype(&launch<0>);
constexpr Launch kFloor[16] = {
    launch<0>, launch<1>, launch<2>, launch<3>, launch<4>, launch<5>,
    launch<6>, launch<7>, launch<8>, launch<9>, launch<10>, launch<11>,
    launch<12>, launch<13>, launch<14>, launch<15>};

// K1-real: the instantiation of each variant, in the order of
// tpubwa_torch/scripts/exp_kernel_real.py:VARIANTS
constexpr Launch kReal[] = {
    launch<0>,              // full
    launch<0>,              // rollred-fused
    launch<kUnroll2>,       // rollred-fused-u2
    launch<kUnroll4>,       // rollred-fused-u4
    launch<kScan>,          // no-scan
    launch<kNoMj>,          // no-mj
    launch<kNoWbmask>,      // no-wbmask
    launch<kNoGscore>,      // no-gscore
    launch<kNoOfftrack>,    // no-offtrack
    launch<0>,              // no-zdrop (the caller passes zdrop 0)
    launch<kNoTrim>};       // no-trim
constexpr int kRealVariants = sizeof(kReal) / sizeof(kReal[0]);

}  // namespace

// C entry point for ctypes.  Pointers are device pointers from
// torch.Tensor.data_ptr(); stream is torch's current cudaStream_t.
// Launches on that stream without synchronising and returns
// cudaGetLastError() (0 on success); a W whose block would need more
// shared memory than the card allows returns an error and launches
// nothing.
extern "C" int tpubwa_extend_batch(const void* q, const void* t,
                                   const void* params, void* out, int n,
                                   int W, int tmax, int pstride, int a,
                                   int b, int o_del, int e_del, int o_ins,
                                   int e_ins, int zdrop, int device,
                                   void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    return (int)launch<0>(q, t, params, out, n, W, tmax, pstride, 6, a, b,
                          o_del, e_del, o_ins, e_ins, zdrop,
                          (cudaStream_t)stream);
}

// K1-floor: tpubwa_extend_batch with `ablate_mask` (bits kScan 1, kPk 2,
// kHopen 4, kTrim 8) choosing the instantiation; mask 0 is K1.  An
// unknown mask launches nothing and returns cudaErrorInvalidValue.
extern "C" int tpubwa_extend_floor(const void* q, const void* t,
                                   const void* params, void* out, int n,
                                   int W, int tmax, int pstride, int a,
                                   int b, int o_del, int e_del, int o_ins,
                                   int e_ins, int zdrop, int device,
                                   void* stream, int ablate_mask) {
    if (ablate_mask < 0 || ablate_mask >= 16)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    return (int)kFloor[ablate_mask](q, t, params, out, n, W, tmax, pstride,
                                    6, a, b, o_del, e_del, o_ins, e_ins,
                                    zdrop, (cudaStream_t)stream);
}

// K1-real: tpubwa_extend_batch with `variant`, the index of
// exp_kernel_real.VARIANTS, choosing the instantiation; the caller passes
// the script's scoring and z-drop.  out has ostride lanes a job, of which
// the kernel writes lanes 0-5.  An unknown variant launches nothing and
// returns cudaErrorInvalidValue.
extern "C" int tpubwa_extend_real(int variant, const void* q, const void* t,
                                  const void* params, void* out, int n,
                                  int W, int tmax, int pstride, int ostride,
                                  int a, int b, int o_del, int e_del,
                                  int o_ins, int e_ins, int zdrop, int device,
                                  void* stream) {
    if (variant < 0 || variant >= kRealVariants)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    return (int)kReal[variant](q, t, params, out, n, W, tmax, pstride,
                               ostride, a, b, o_del, e_del, o_ins, e_ins,
                               zdrop, (cudaStream_t)stream);
}

// K1-mat: tpubwa_extend_batch under the 5 x 5 scoring matrix mat (25
// ints, row-major mat[t][q], in host memory, read before the launch) in
// place of (a, b).  The band cap takes max(max(mat), 0) for a.
extern "C" int tpubwa_extend_mat(const void* q, const void* t,
                                 const void* params, void* out, int n, int W,
                                 int tmax, int pstride, const int* mat,
                                 int o_del, int e_del, int o_ins, int e_ins,
                                 int zdrop, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    ScoreTable tab;
    int mmax = 0;
    for (int k = 0; k < 25; ++k) {
        tab.s[k] = mat[k];
        if (mat[k] > mmax) mmax = mat[k];
    }
    return (int)launch_with<kMat>(q, t, params, out, n, W, tmax, pstride, 6,
                                  mmax, 0, o_del, e_del, o_ins, e_ins, zdrop,
                                  (cudaStream_t)stream, tab);
}

#ifndef TPUBWA_WARP_HOST
// What an SM holds of instantiation `ablate_mask` at width W, as the CUDA
// runtime counts it: info[0] = warps resident an SM, info[1] = warps a
// block, info[2] = a block's shared memory in bytes.  Returns a
// cudaError_t (0 on success).
extern "C" int tpubwa_extend_occupancy(int W, int ablate_mask, int device,
                                       int* info) {
    if (ablate_mask < 0 || ablate_mask >= 16)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = kOccupancy[ablate_mask](W, &blocks, &info[2]);
    info[0] = blocks * kWarps;
    info[1] = kWarps;
    return (int)err;
}
#endif
