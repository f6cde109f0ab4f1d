// Batched banded Smith-Waterman seed extension (bwa ksw.c:ksw_extend2)
// for Hopper (sm_90a), and its timing-only ablations (K1-floor).
//
// Replaces: tpubwa/device/extend_pallas.py:_extend_kernel, launched by
// extend_batch_pallas.  Same contract at the Python wrapper
// (tpubwa_torch/device/extend_kernel.py:extend_batch): q int32 [N, W],
// t int32 [N, tmax], params int32 [N, pstride] with lanes (qlen, tlen,
// h0, w, end_bonus); out int32 [N, 6] = (score, qle, tle, gtle, gscore,
// max_off).  Codes are 0-3 for bases and anything above for N (query
// codes are kept as bytes).  The score is match a / mismatch -b / N -1
// arithmetic, with no profile table.
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
              int n, int W, int tmax, int pstride, int sh,
              int a, int b, int o_del, int e_del, int o_ins, int e_ins,
              int zdrop) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
        for (int i = 0; i < rows; ++i) {
            // lane k holds the target code of row (i & ~31) + k
            if ((i & 31) == 0) tcodes = i + lane < rows ? tj[i + lane] : 4;
            beg = imax(beg, i - w);
            end = imin(imin(end, i + w + 1), qlen);
            const int h1 = beg == 0 ? imax(h0 - (o_del + e_del * (i + 1)), 0)
                                    : 0;
            if (beg >= end) {
                // band closed: take gscore and die (upstream also writes
                // the boundary pair, which nothing reads again)
                if (end == qlen && h1 >= gscore) { max_ie = i; gscore = h1; }
                break;
            }
            const int tb = __shfl_sync(kFull, tcodes, i & 31);
            // carried from strip to strip: the F scan's running max, and
            // H(i, j0 - 1) for the first lane's write-back
            int carry_f = kNeg, carry_h = h1;
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
                const int sc = (tb > 3 || qc > 3) ? -1 : (tb == qc ? a : -b);
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
                const int en = in ? imax(e - e_del, imax(M - oe_del, 0)) : 0;
                if (j <= end) row[j] = make_int2(hp, en);
                if constexpr (ABLATE & kPk) {
                    if (j0 == 0) m0 = __shfl_sync(kFull, h, 0);
                } else {
                    // last-wins argmax ties (upstream `mj = m > h1 ? mj : j`)
                    pk = imax(pk, __reduce_max_sync(
                        kFull, in ? (h << sh) | j : -1));
                }
                // the boundary lane, in the row's last strip
                const int lb = end - j0;
                if constexpr (!(ABLATE & kHopen)) {
                    const int hb = __shfl_sync(kFull, hp, lb & 31);
                    if (lb < 32) hlast = hb;
                }
                if constexpr (ABLATE & kTrim) {
                    if (j0 == 0)
                        nz0 = __shfl_sync(kFull, (hp | en) != 0, 0);
                } else {
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
            } else {
                mrow = pk >> sh;
                mj = pk & ((1 << sh) - 1);
            }
            // lane 0's h_open: a band of the one cell (i, 0) has its max there
            if constexpr (ABLATE & kHopen) hlast = end == 1 ? mrow : 0;
            if (end == qlen && hlast >= gscore) { max_ie = i; gscore = hlast; }
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
                if (beg == 0 && nz0) {
                    end = imin(2, qlen);
                } else {
                    beg = end;
                    end = imin(end + 1, qlen);
                }
            } else {
                // adaptive band trim to the first nonzero column of
                // [beg, end) and the last of [beg, end]
                beg = first_nz ? first_j0 + __ffs(first_nz) - 1 : end;
                end = imin((last_nz ? last_j0 + 31 - __clz(last_nz)
                                    : beg - 1) + 2, qlen);
            }
            // the next row's lanes read columns that other lanes wrote
            __syncwarp();
        }
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
template <int ABLATE>
cudaError_t block_bytes(int W, size_t* bytes) {
    *bytes = (size_t)kWarps * ((W + 2) * sizeof(int2) + W);
    if (*bytes <= (size_t)kSmemDefault) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        extend_kernel<ABLATE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)*bytes);
    // the refusal is returned, not left behind for the next launch's
    // cudaGetLastError
    if (err != cudaSuccess) cudaGetLastError();
    return err;
}

template <int ABLATE>
cudaError_t launch(const void* q, const void* t, const void* params,
                   void* out, int n, int W, int tmax, int pstride, int a,
                   int b, int o_del, int e_del, int o_ins, int e_ins,
                   int zdrop, cudaStream_t stream) {
    size_t bytes;
    cudaError_t err = block_bytes<ABLATE>(W, &bytes);
    if (err != cudaSuccess) return err;  // refused: no launch is made
    const int blocks = (n + kWarps - 1) / kWarps;
    int sh = 0;  // the argmax's bits: 2^sh >= W
    while ((1 << sh) < W) ++sh;
    TPUBWA_LAUNCH(extend_kernel<ABLATE>, blocks, kWarps * 32, bytes, stream,
                  (const int32_t*)q, (const int32_t*)t,
                  (const int32_t*)params, (int32_t*)out, n, W, tmax, pstride,
                  sh, a, b, o_del, e_del, o_ins, e_ins, zdrop);
    return cudaGetLastError();
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
    return (int)launch<0>(q, t, params, out, n, W, tmax, pstride, a, b,
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
                                    a, b, o_del, e_del, o_ins, e_ins, zdrop,
                                    (cudaStream_t)stream);
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
