// K1-bd: the kernel-breakdown experiment's reduced K1, in its nine
// timing variants, for Hopper (sm_90a).
//
// Replaces: scripts/exp_kernel_breakdown.py:build_kernel(variant, tmax),
// the Pallas kernel body `kernel` (:54) launched at :189.  Same contract
// at the Python wrapper
// (tpubwa_torch/scripts/exp_kernel_breakdown.py:extend_bd): q int32
// [N, NL], t int32 [N, tmax], params int32 [N, pstride] with lanes (qlen,
// tlen, h0, w); out int32 [N, ostride], lanes 0-3 = (best, beg, end,
// dead), the others left as the wrapper zeroed them.  The scoring is the
// JAX kernel's fixed one (:52).
//
// What makes it more than a row loop per job: the JAX kernel's results
// are coupled across the launch.  Its loop (:74-76) runs until every job
// is dead or to tile_tmax, testing that every `step` rows, and the band
// trim (:142-153) and best = max(best, m) (:154) are not gated on the job
// being active.  A job that is dead or past its tlen keeps changing
// best, beg and end, on its frozen (h, e) row, for as long as the launch
// runs.  So each job runs all the launch's rows 0 .. S-1, S found on the
// device, in two kernels on one stream with no host sync:
//
//   extend_bd_live   a warp per job runs its live rows, i < min(tlen,
//                    cap) until it dies (m == 0), with the write-back.
//                    A live job's rows depend on itself alone, so its
//                    death row is its own.  After its last live row the
//                    warp writes the job's row once, as the JAX kernel
//                    holds it, to `frozen` ([N, NL] pairs, job-major, a
//                    lane a column), its state to `aux`, and adds to the
//                    launch's three counters (zeroed before by
//                    cudaMemsetAsync): atomicMax of death row + 1,
//                    atomicOr of "a job survived", atomicMax of tlen.
//   extend_bd_frozen a warp per job computes S = roundup_step(min(D,
//                    tile_tmax)) (D = 1 + the last death row; no D when
//                    a job survived; S = 0 when tile_tmax <= 0).  A job
//                    whose next row is S or past it writes its row of
//                    `out` alone; any other loads its frozen row into
//                    shared memory once and runs rows next .. S-1 with
//                    only the ungated updates (m, best, trim), with no
//                    write-back.
// No grid-wide sync: the two kernels' boundary orders them.
//
// One template covers the nine variants: the target read (READ: the
// transposed table, the constant 1 of no-transpose, t8-slice's clipped
// 8-row strip), the rows per exit test (STEP: 2 for unroll2, 8 for
// t8-slice), the row cap (NCAP: tdot's un-transposed t makes tile_tmax
// read the job count, :72, :194; its one-hot product reads column i,
// which is the table's read, as i < tile_tmax <= tmax), and the four
// pieces the no-* variants remove (SCAN, ROLL, REDUCE, TRIM).
//
// What bounds it on this card: operations, and under them latency, as
// for K1 (csrc/extend.cu).  A job is a chain of dependent rows, each a
// chain of dependent steps, over a row of NL pairs; the bytes are
// nothing (inputs once, 16 bytes out, the frozen row once each way).
// The frozen pass is latency's alone: few jobs freeze, each for up to a
// launch of rows, so few warps an SM overlap their rows' chains.
//
// What the design does about it, in csrc/extend.cu's order:
//   * a warp per job, kWarps a block, so every SM has tens of rows in
//     flight to hide each other's latency; the 32 lanes share one beg,
//     end, row and death, so nothing diverges, and a job costs its own
//     rows, not its warp's longest job's;
//   * the (h, e) row and the query codes in dynamic shared memory, the
//     target codes in a register, 32 rows a load (the clipped column of
//     each row, so t8-slice's strip and the table's clip read right);
//   * lanes follow the live band [beg_i, end_i) in strips of 32 columns
//     from beg_i; the live pass's last strip reaches end_i, whose lane
//     writes the boundary.  A lane reads and writes its own column's
//     pair; H(i, j-1), the rolled H, comes from the lane to its left by
//     a shuffle, so no lane reads what another writes within a row, and
//     one __syncwarp a row orders the rows;
//   * F by a prefix max, as the JAX kernel's _prefix_max: an inclusive
//     max scan of max(M - oe_ins, 0) + j e_ins over the strip by
//     __shfl_up_sync, the running max carried from strip to strip.  The
//     live pass alone needs it: F never raises a row's maximum, and a
//     frozen row's H is read only through that maximum;
//   * m as one __reduce_max_sync a strip (K1-bd keeps no argmax), or
//     no-reduce's H at column 0 (0 when beg_i > 0) by one shuffle.  One
//     reduction a row, of each lane's running maximum, read slower on
//     the card: it puts its latency before the death test;
//   * the trim from one __ballot_sync a strip of the pairs just written
//     over [beg_i, end_i) alone: K1-bd's window (:146), where K1's also
//     takes column end.  The frozen pass ballots its unchanging row the
//     same way (a mask built once at load would save the ballots; the
//     two share the strip loop instead).
// TMA, wgmma and thread block clusters have nothing to offer here: the
// recurrence is integer max/add along a wavefront, there is no matrix
// product in it, and a job's tiles are read once, a few hundred bytes.
//
// The live pass's write-back, lazily.  The JAX write-back reaches every
// lane each live row: the rolled H (0 outside the band) into eh_h, and E
// decayed, max(E - 1, 0), outside the band.  Here a live row writes only
// its band [beg_i, end_i) and lane end_i's h, because
//   * lanes below beg_i are never read again: beg_i never decreases while
//     the band is open, and once it is empty it stays empty;
//   * the next row's band lies inside [beg_i, end_i]: the trim leaves end
//     <= end_i + 1, and no-trim's window grows by one column a row;
//   * E is stored as K = E + row, so a lane whose E was last written at
//     row r holds, after row i, E = max(K - i, 0): every skipped decay
//     at once.  A live row reads K - (i - 1) unclamped: below 0 only on
//     a lane last written before the row before (the boundary, whose h
//     alone is written), and every use of E in a live row (max with M
//     and 0, max with the gap score) clamps it.
// Lazily kept, the row differs from the JAX kernel's outside [beg_i,
// end_i].  The frozen pass reads lanes the live rows did not reach: its
// trim may take lane end_i (nonzero on the last live row) and then move
// end above it, to lanes the JAX kernel holds at h 0 (the roll at :139,
// or no-roll's plain H, puts H = 0, set outside the band at :128, into
// every lane above end_i) and E decayed.  So the handoff writes the row
// as the JAX kernel holds it: h where the last live row wrote it ([lo,
// hi] = [beg_i, end_i], none when its band was empty, lanes 0 .. qlen
// for the initial row) and 0 elsewhere, and E clamped, max(K - last, 0).
// The frozen pass then reads its row as it is.
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

// warps (jobs) a block, as K1's; a job's shared memory is NL pairs and
// NL int32 query codes (the JAX kernel compares codes by value, so any
// int32 code is kept), so a block's is kWarps * 12 NL bytes
constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemDefault = 48 * 1024;  // above it a kernel must opt in
// exp_kernel_breakdown.py:52
constexpr int A = 1, B = 4, O_DEL = 6, E_DEL = 1, O_INS = 6, E_INS = 1;
constexpr int NEG = -(1 << 29);         // :33
// aux: the launch's counters, then each job's state between the passes
// (kJobInts ints a job, job-major)
constexpr int kDiedEnd = 0, kSurvived = 1, kTlenMax = 2, kLaunchInts = 3;
constexpr int kNext = 0, kBeg = 1, kEnd = 2, kBest = 3, kDead = 4,
              kJobInts = 5;

enum Read { kTable, kConst, kT8 };

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// the tile column of target row r >= 0 (the reads of :83-108)
template <int READ>
__device__ __forceinline__ int target_col(int r, int tmax) {
    if (READ == kT8) return imin(r - (r & 7), tmax - 8) + (r & 7);
    return imin(r, tmax - 1);
}

// One job's band state, the same in every lane of its warp.  step<LIVE>
// runs row i and returns m.  LIVE: the job is active; the row reads e as
// K - (i - 1) and writes (h, K) back.  Else the row reads the frozen row
// as it is and writes nothing.
template <int READ, bool SCAN, bool ROLL, bool REDUCE, bool TRIM>
struct Job {
    int2* row;             // shared: column j's (h, e), or (h, K) if live
    const int* qs;         // shared: the query codes
    const int32_t* tj;
    int lane, qlen, w, tmax;
    int beg, end, best;
    int lo, hi;            // live: the columns whose h the last row wrote
    int wbase, tcodes;     // lane k: the code of target row wbase + k

    template <bool LIVE>
    __device__ __forceinline__ int step(int i) {
        const int beg_i = imax(beg, i - w);
        const int end_i = imin(imin(end, i + w + 1), qlen);
        if (beg_i >= end_i) {
            // an empty band stays empty, and nothing reads the lanes the
            // JAX write-back would clear
            const int m = REDUCE ? NEG : 0;
            if (TRIM) {
                beg = end_i;                  // min(NL + 2, end_i)
                end = imin(NEG + 2, qlen);
            }
            if (LIVE) {
                lo = 0;
                hi = -1;
            }
            best = imax(best, m);
            return m;
        }
        int tb = 1;
        if (READ != kConst) {
            if ((i & ~31) != wbase) {
                wbase = i & ~31;
                tcodes = tj[target_col<READ>(wbase + lane, tmax)];
            }
            tb = __shfl_sync(kFull, tcodes, i & 31);
        }
        // carried from strip to strip: the F scan's running max and
        // H(i, j0 - 1) for the first lane's roll (0 at beg_i)
        int carry_f = NEG, carry_h = 0, m = REDUCE ? NEG : 0;
        int first_j0 = 0, last_j0 = 0;
        unsigned first_nz = 0, last_nz = 0;
        for (int j0 = beg_i; j0 <= (LIVE ? end_i : end_i - 1); j0 += 32) {
            const int j = j0 + lane;
            const bool in = j < end_i;
            int h = 0, e = 0, qc = 4;
            if (in) {
                const int2 c = row[j];
                h = c.x;
                e = LIVE ? c.y - (i - 1) : c.y;
                qc = qs[j];
            }
            const int sc = (tb > 3 || qc > 3) ? -1 : (tb == qc ? A : -B);
            const int M = h != 0 ? h + sc : 0;
            int H = imax(M, e);
            // a frozen row writes nothing back, so its H is read only
            // through m, and F never raises a row's maximum: F(j) is
            // max(M(u) - oe_ins, 0) - (j - 1 - u) e_ins for some u < j in
            // the band, at most max(M(u), 0) <= H(u).  So the frozen pass
            // leaves F out
            if (SCAN && LIVE) {
                // inclusive max scan of t_ins[u] + u e_ins; lanes past the
                // band hold NEG, and a lane below d gets its own value
                // back from the shuffle
                int v = in ? imax(M - (O_INS + E_INS), 0) + j * E_INS : NEG;
#pragma unroll
                for (int d = 1; d < 32; d <<= 1)
                    v = imax(v, __shfl_up_sync(kFull, v, d));
                v = imax(v, carry_f);
                int f = __shfl_up_sync(kFull, v, 1);
                if (lane == 0) f = carry_f;
                carry_f = __shfl_sync(kFull, v, 31);
                // at beg_i f is NEG, below H's E >= 0, and changes nothing
                H = imax(H, f - (j - 1) * E_INS);
            }
            H = imax(H, 0);
            if (REDUCE)
                m = imax(m, __reduce_max_sync(kFull, in ? H : NEG));
            else if (j0 == 0)
                m = __shfl_sync(kFull, H, 0);   // H at column 0
            unsigned nz = 0;
            if (LIVE) {
                // H(i, j-1), shifted into this lane's column
                int hp = __shfl_up_sync(kFull, H, 1);
                if (lane == 0) hp = carry_h;
                carry_h = __shfl_sync(kFull, H, 31);
                const int en = imax(e - E_DEL, imax(M - (O_DEL + E_DEL), 0));
                const int hn = ROLL ? hp : H;
                if (in)
                    row[j] = make_int2(hn, en + i);
                else if (j == end_i)
                    // the boundary: the rolled-in H(i, end_i - 1) (0
                    // with no-roll); its K stays, which decays its E
                    row[j].x = ROLL ? hp : 0;
                if (TRIM) nz = __ballot_sync(kFull, in && (hn | en) != 0);
            } else if (TRIM) {
                nz = __ballot_sync(kFull, in && (h | e) != 0);
            }
            if (TRIM && nz) {
                if (!first_nz) {
                    first_nz = nz;
                    first_j0 = j0;
                }
                last_nz = nz;
                last_j0 = j0;
            }
        }
        if (TRIM) {
            // the first and last nonzero columns of [beg_i, end_i)
            beg = first_nz ? first_j0 + __ffs(first_nz) - 1 : end_i;
            end = imin((last_nz ? last_j0 + 31 - __clz(last_nz) : NEG) + 2,
                       qlen);
        }
        if (LIVE) {
            lo = beg_i;
            hi = end_i;
            // the next row's lanes read columns that other lanes wrote
            __syncwarp();
        }
        best = imax(best, m);
        return m;
    }
};

template <int READ, bool SCAN, bool ROLL, bool REDUCE, bool TRIM>
__device__ __forceinline__ Job<READ, SCAN, ROLL, REDUCE, TRIM> job_at(
        const int32_t* q, const int32_t* t, const int32_t* p, int job,
        int NL, int tmax) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    Job<READ, SCAN, ROLL, REDUCE, TRIM> s;
    s.row = smem + warp * NL;
    int* qs = reinterpret_cast<int*>(smem + kWarps * NL) + warp * NL;
    s.qs = qs;
    s.tj = t + (size_t)job * tmax;
    s.lane = lane;
    s.qlen = p[0];
    s.w = p[3];
    s.tmax = tmax;
    s.wbase = -1;
    s.tcodes = 4;
    const int32_t* qj = q + (size_t)job * NL;
    for (int j = lane; j < s.qlen; j += 32) qs[j] = qj[j];
    return s;
}

template <int READ, bool NCAP, bool SCAN, bool ROLL, bool REDUCE, bool TRIM>
__global__ void __launch_bounds__(kWarps * 32)
extend_bd_live(const int32_t* __restrict__ q, const int32_t* __restrict__ t,
               const int32_t* __restrict__ params,
               int2* __restrict__ frozen, int* __restrict__ aux, int n,
               int NL, int tmax, int pstride) {
    const int job = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (job >= n) return;
    const int32_t* p = params + (size_t)job * pstride;
    const int tlen = p[1], h0 = p[2];
    auto s = job_at<READ, SCAN, ROLL, REDUCE, TRIM>(q, t, p, job, NL, tmax);
    s.beg = 0;
    s.end = s.qlen;
    s.best = h0;
    s.lo = 0;
    s.hi = s.qlen;
    // the initial row on lanes 0 .. qlen (qlen < NL): h0, then the ramp
    // clipped at 0; E = 0, stored as K = 0 + (-1)
    for (int j = s.lane; j <= s.qlen; j += 32)
        s.row[j] = make_int2(
            j ? imax(h0 - (O_INS + E_INS) - (j - 1) * E_INS, 0) : h0, -1);
    __syncwarp();
    const int rows = imin(tlen, NCAP ? n : tmax);
    int i = 0;
    bool dead = false;
    for (; i < rows && !dead; ++i) dead = s.template step<true>(i) == 0;
    // the handoff: the row as the JAX kernel holds it after row i - 1,
    // on the lanes a band can reach (< qlen), a lane a column
    int2* fj = frozen + (size_t)job * NL;
    for (int j = s.lane; j < s.qlen; j += 32) {
        const int2 c = s.row[j];
        fj[j] = make_int2(s.lo <= j && j <= s.hi ? c.x : 0,
                          imax(c.y - (i - 1), 0));
    }
    if (s.lane == 0) {
        int* st = aux + kLaunchInts + (size_t)job * kJobInts;
        st[kNext] = i;
        st[kBeg] = s.beg;
        st[kEnd] = s.end;
        st[kBest] = s.best;
        st[kDead] = dead;
        if (dead)
            atomicMax(aux + kDiedEnd, i);
        else
            atomicOr(aux + kSurvived, 1);
        atomicMax(aux + kTlenMax, tlen);
    }
}

template <int READ, int STEP, bool NCAP, bool SCAN, bool ROLL, bool REDUCE,
          bool TRIM>
__global__ void __launch_bounds__(kWarps * 32)
extend_bd_frozen(const int32_t* __restrict__ q,
                 const int32_t* __restrict__ t,
                 const int32_t* __restrict__ params,
                 int32_t* __restrict__ out, const int2* __restrict__ frozen,
                 const int* __restrict__ aux, int n, int NL, int tmax,
                 int pstride, int ostride) {
    const int job = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (job >= n) return;
    // the launch's stop row: the JAX loop tests its condition at rows
    // 0, STEP, 2 * STEP, ...
    const int tile_tmax = imin(aux[kTlenMax], NCAP ? n : tmax);
    int stop = 0;
    if (tile_tmax > 0) {
        const int until = aux[kSurvived] ? tile_tmax
                                         : imin(aux[kDiedEnd], tile_tmax);
        stop = (until + STEP - 1) / STEP * STEP;
    }
    const int* st = aux + kLaunchInts + (size_t)job * kJobInts;
    const int next = st[kNext];
    int best = st[kBest], beg = st[kBeg], end = st[kEnd];
    if (next < stop) {
        const int32_t* p = params + (size_t)job * pstride;
        auto s = job_at<READ, SCAN, ROLL, REDUCE, TRIM>(q, t, p, job, NL,
                                                        tmax);
        const int2* fj = frozen + (size_t)job * NL;
        for (int j = s.lane; j < s.qlen; j += 32) s.row[j] = fj[j];
        __syncwarp();
        s.beg = beg;
        s.end = end;
        s.best = best;
        for (int i = next; i < stop; ++i) s.template step<false>(i);
        best = s.best;
        beg = s.beg;
        end = s.end;
    }
    if ((threadIdx.x & 31) == 0) {
        int32_t* o = out + (size_t)job * ostride;
        o[0] = best;
        o[1] = beg;
        o[2] = end;
        o[3] = st[kDead];
    }
}

// a kernel that needs more than the default shared memory opts in; past
// the card's limit for a block that fails, and the refusal is returned,
// not left behind for the next launch's cudaGetLastError
template <class Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes) {
    if (bytes <= (size_t)kSmemDefault) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) cudaGetLastError();
    return err;
}

// the live pass, then the frozen pass, in order on one stream
template <int READ, int STEP, bool NCAP, bool SCAN, bool ROLL, bool REDUCE,
          bool TRIM>
cudaError_t launch(const void* q, const void* t,
                   const void* params, void* out, void* frozen, void* aux,
                   int n, int NL, int tmax, int pstride, int ostride,
                   cudaStream_t stream) {
    const auto live = extend_bd_live<READ, NCAP, SCAN, ROLL, REDUCE, TRIM>;
    const auto frz =
        extend_bd_frozen<READ, STEP, NCAP, SCAN, ROLL, REDUCE, TRIM>;
    const size_t bytes = (size_t)kWarps * NL * (sizeof(int2) + sizeof(int));
    // refused: nothing runs
    cudaError_t err = opt_in(live, bytes);
    if (err == cudaSuccess) err = opt_in(frz, bytes);
    if (err != cudaSuccess) return err;
    const int blocks = (n + kWarps - 1) / kWarps;
    err = cudaMemsetAsync(aux, 0, kLaunchInts * sizeof(int), stream);
    if (err != cudaSuccess) return err;
    TPUBWA_LAUNCH(live, blocks, kWarps * 32, bytes, stream,
                  (const int32_t*)q, (const int32_t*)t,
                  (const int32_t*)params, (int2*)frozen, (int*)aux, n, NL,
                  tmax, pstride);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    TPUBWA_LAUNCH(frz, blocks, kWarps * 32, bytes, stream,
                  (const int32_t*)q, (const int32_t*)t,
                  (const int32_t*)params, (int32_t*)out,
                  (const int2*)frozen, (const int*)aux, n, NL, tmax,
                  pstride, ostride);
    return cudaGetLastError();
}

}  // namespace

// C entry point for ctypes.  `variant` is the index of the variant in
// exp_kernel_breakdown.VARIANTS: 0 baseline, 1 no-transpose, 2 t8-slice,
// 3 tdot, 4 no-scan, 5 no-roll, 6 no-reduce, 7 no-trim, 8 unroll2.
// Pointers are device pointers from torch.Tensor.data_ptr(): frozen holds
// n x NL int2 (the handoff row, job-major), aux 3 + 5 n ints; stream is
// torch's current cudaStream_t.  Launches the passes on that stream
// without synchronising and returns the first CUDA error (0 on success;
// before anything runs, cudaErrorInvalidValue for an unknown variant,
// and the error of a tile whose block would need more shared
// memory than the card allows).
extern "C" int tpubwa_extend_bd(int variant, const void* q, const void* t,
                                const void* params, void* out, void* frozen,
                                void* aux, int n, int NL, int tmax,
                                int pstride, int ostride, int device,
                                void* stream) {
    if (variant < 0 || variant > 8) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const auto args = [&](auto fn) {
        return (int)fn(q, t, params, out, frozen, aux, n, NL, tmax, pstride,
                       ostride, st);
    };
    //                   read    step ncap   scan   roll   reduce trim
    switch (variant) {
    case 0:
        return args(launch<kTable, 1, false, true, true, true, true>);
    case 1:
        return args(launch<kConst, 1, false, true, true, true, true>);
    case 2:
        return args(launch<kT8, 8, false, true, true, true, true>);
    case 3:
        return args(launch<kTable, 1, true, true, true, true, true>);
    case 4:
        return args(launch<kTable, 1, false, false, true, true, true>);
    case 5:
        return args(launch<kTable, 1, false, true, false, true, true>);
    case 6:
        return args(launch<kTable, 1, false, true, true, false, true>);
    case 7:
        return args(launch<kTable, 1, false, true, true, true, false>);
    default:
        return args(launch<kTable, 2, false, true, true, true, true>);
    }
}
