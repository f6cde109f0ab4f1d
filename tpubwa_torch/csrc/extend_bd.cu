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
//   extend_bd_live   one thread per job runs its live rows, i <
//                    min(tlen, cap) until it dies (m == 0), with the
//                    write-back.  A live job's rows depend on itself
//                    alone, so its death row is its own.  It saves its
//                    state between the passes and adds to the launch's
//                    three counters (zeroed before by cudaMemsetAsync):
//                    atomicMax of death row + 1, atomicOr of "a job
//                    survived", atomicMax of tlen.
//   extend_bd_frozen one thread per job computes S = roundup_step(min(D,
//                    tile_tmax)) (D = 1 + the last death row; no D when
//                    a job survived; S = 0 when tile_tmax <= 0), then
//                    runs its rows from its next row to S with only the
//                    ungated updates (m, best, trim) on its frozen row,
//                    and writes its row of `out`.
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
// The band's write-back, lazily.  The JAX write-back reaches every lane
// each live row: the rolled H (0 outside the band) into eh_h, and E
// decayed, max(E - 1, 0), outside the band.  Here a live row writes only
// its band [beg_i, end_i) and lane end_i, because
//   * lanes below beg_i are never read again: beg_i never decreases while
//     the band is open, and once it is empty it stays empty;
//   * the next row's band lies inside [beg_i, end_i]: the trim leaves end
//     <= end_i + 1;
//   * E is stored as K = E + row, so a lane whose E was last written at
//     row r holds, after row i, E = max(K - i, 0): every skipped decay
//     at once.  A live row reads K - (i - 1) unclamped: below 0 only on
//     the lane that was the row before's end_i, and every use of E in a
//     live row (max with M and 0, max with the gap score) clamps it.
// The frozen pass clamps E, and reads lanes above its last live row's
// end_i as h 0.
//
// What bounds it on this card: as for K1, scalar instruction issue and
// warp divergence (a warp costs its longest job, in both passes); the
// (h, K) scratch is job-minor ([NL][N] pairs), so a warp's lanes at one
// query column read neighbouring addresses.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// exp_kernel_breakdown.py:52
constexpr int A = 1, B = 4, O_DEL = 6, E_DEL = 1, O_INS = 6, E_INS = 1;
constexpr int NEG = -(1 << 29);         // :33
// aux: the launch's counters, then each job's state between the passes
// (kNext .. kHi, [k][n], job-minor)
constexpr int kDiedEnd = 0, kSurvived = 1, kTlenMax = 2, kLaunchInts = 3;
constexpr int kNext = 0, kBeg = 1, kEnd = 2, kBest = 3, kDead = 4, kHi = 5;

enum Read { kTable, kConst, kT8 };

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// the target base of row i (the table of :83-108); i >= 0
template <int READ>
__device__ __forceinline__ int target(const int32_t* tj, int i, int tmax) {
    if (READ == kConst) return 1;
    if (READ == kT8) return tj[imin(i - (i & 7), tmax - 8) + (i & 7)];
    return tj[imin(i, tmax - 1)];
}

// One job's band state.  row<LIVE>(i) runs row i and returns m.  LIVE:
// the job is active, and the row writes (h, K) back.  Else the row
// reads the row frozen at its last live row `last`, whose end_i was
// `hi` (qlen when it had none: the initial row).
template <int READ, bool SCAN, bool ROLL, bool REDUCE, bool TRIM>
struct Job {
    const int32_t* qj;
    const int32_t* tj;
    int2* col;             // col[j * stride] = (eh_h[j], eh_e[j] + row)
    size_t stride;
    int qlen, w, tmax;
    int beg, end, best;
    int wrote_end;         // end_i of the last live row

    template <bool LIVE>
    __device__ __forceinline__ int row(int i, int hi, int last) {
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
            best = imax(best, m);
            return m;
        }
        const int tb = target<READ>(tj, i, tmax);
        // f: the F scan (its value at beg_i is below the band's E >= 0,
        // so 0 gives the same H); h_prev: H(i, j - 1), the rolled-in
        // eh_h (0 at beg_i); first/lastnz: the trim's nonzero lanes
        int f = 0, h_prev = 0, m = NEG, h_lane0 = 0, first = -1,
            lastnz = -1;
        for (int j = beg_i; j < end_i; ++j) {
            const int2 c = col[j * stride];
            int h, e;
            if (LIVE) {
                // h written at row i - 1 (or the initial row)
                h = c.x;
                e = c.y - (i - 1);
            } else {
                h = j <= hi ? c.x : 0;
                e = imax(c.y - last, 0);
            }
            const int qc = qj[j];
            const int sc = (tb > 3 || qc > 3) ? -1 : (tb == qc ? A : -B);
            const int M = h != 0 ? h + sc : 0;
            int H = imax(M, e);
            if (SCAN) H = imax(H, f);
            H = imax(H, 0);
            m = imax(m, H);
            if (!REDUCE && j == 0) h_lane0 = H;
            const int gap = imax(M - (O_DEL + E_DEL), 0);
            if (LIVE) {
                const int en = imax(e - E_DEL, gap);
                const int hn = ROLL ? h_prev : H;
                col[j * stride] = make_int2(hn, en + i);
                if (TRIM && (hn != 0 || en != 0)) {
                    if (first < 0) first = j;
                    lastnz = j;
                }
            } else if (TRIM && (h != 0 || e != 0)) {
                if (first < 0) first = j;
                lastnz = j;
            }
            h_prev = H;
            if (SCAN) f = imax(f - E_INS, imax(M - (O_INS + E_INS), 0));
        }
        if (LIVE) {
            // lane end_i (< NL): the rolled-in H(i, end_i - 1) (0 with
            // no-roll); its K stays, which decays its E
            col[end_i * stride].x = ROLL ? h_prev : 0;
            wrote_end = end_i;
        }
        if (!REDUCE) m = h_lane0;     // H at lane 0 (0 outside the band)
        if (TRIM) {
            beg = first >= 0 ? first : end_i;
            end = imin((first >= 0 ? lastnz : NEG) + 2, qlen);
        }
        best = imax(best, m);
        return m;
    }
};

template <int READ, bool SCAN, bool ROLL, bool REDUCE, bool TRIM>
__device__ __forceinline__ Job<READ, SCAN, ROLL, REDUCE, TRIM> job_at(
        const int32_t* q, const int32_t* t, const int32_t* p, int2* eh,
        int job, int n, int NL, int tmax) {
    Job<READ, SCAN, ROLL, REDUCE, TRIM> s;
    s.qj = q + (size_t)job * NL;
    s.tj = t + (size_t)job * tmax;
    s.col = eh + job;
    s.stride = (size_t)n;
    s.qlen = p[0];
    s.w = p[3];
    s.tmax = tmax;
    return s;
}

template <int READ, bool NCAP, bool SCAN, bool ROLL, bool REDUCE, bool TRIM>
__global__ void __launch_bounds__(kThreads)
extend_bd_live(const int32_t* __restrict__ q, const int32_t* __restrict__ t,
               const int32_t* __restrict__ params, int2* __restrict__ eh,
               int* __restrict__ aux, int n, int NL, int tmax,
               int pstride) {
    const int job = blockIdx.x * blockDim.x + threadIdx.x;
    if (job >= n) return;
    const int32_t* p = params + (size_t)job * pstride;
    const int tlen = p[1], h0 = p[2];
    auto s = job_at<READ, SCAN, ROLL, REDUCE, TRIM>(q, t, p, eh, job, n, NL,
                                                    tmax);
    s.beg = 0;
    s.end = s.qlen;
    s.best = h0;
    s.wrote_end = s.qlen;
    // the initial row on lanes 0 .. qlen (qlen < NL): h0, then the ramp
    // clipped at 0; E = 0, stored as K = 0 + (-1)
    for (int j = 0; j <= s.qlen; ++j) {
        const int h = j == 0 ? h0
            : imax(h0 - (O_INS + E_INS) - (j - 1) * E_INS, 0);
        s.col[j * s.stride] = make_int2(h, -1);
    }
    const int rows = imin(tlen, NCAP ? n : tmax);
    int i = 0, dead = 0;
    for (; i < rows && !dead; ++i) dead = s.template row<true>(i, 0, 0) == 0;
    int* st = aux + kLaunchInts + job;
    st[kNext * n] = i;
    st[kBeg * n] = s.beg;
    st[kEnd * n] = s.end;
    st[kBest * n] = s.best;
    st[kDead * n] = dead;
    st[kHi * n] = s.wrote_end;
    if (dead)
        atomicMax(aux + kDiedEnd, i);
    else
        atomicOr(aux + kSurvived, 1);
    atomicMax(aux + kTlenMax, tlen);
}

template <int READ, int STEP, bool NCAP, bool SCAN, bool ROLL, bool REDUCE,
          bool TRIM>
__global__ void __launch_bounds__(kThreads)
extend_bd_frozen(const int32_t* __restrict__ q,
                 const int32_t* __restrict__ t,
                 const int32_t* __restrict__ params,
                 int32_t* __restrict__ out, int2* __restrict__ eh,
                 const int* __restrict__ aux, int n, int NL, int tmax,
                 int pstride, int ostride) {
    const int job = blockIdx.x * blockDim.x + threadIdx.x;
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
    const int32_t* p = params + (size_t)job * pstride;
    auto s = job_at<READ, SCAN, ROLL, REDUCE, TRIM>(q, t, p, eh, job, n, NL,
                                                    tmax);
    const int* st = aux + kLaunchInts + job;
    const int next = st[kNext * n], hi = st[kHi * n];
    s.beg = st[kBeg * n];
    s.end = st[kEnd * n];
    s.best = st[kBest * n];
    for (int i = next; i < stop; ++i) s.template row<false>(i, hi, next - 1);
    int32_t* o = out + (size_t)job * ostride;
    o[0] = s.best;
    o[1] = s.beg;
    o[2] = s.end;
    o[3] = st[kDead * n];
}

template <int READ, int STEP, bool NCAP, bool SCAN, bool ROLL, bool REDUCE,
          bool TRIM>
cudaError_t launch(const void* q, const void* t, const void* params,
                   void* out, void* eh, void* aux, int n, int NL, int tmax,
                   int pstride, int ostride, cudaStream_t stream) {
    const int blocks = (n + kThreads - 1) / kThreads;
    cudaError_t err = cudaMemsetAsync(aux, 0, kLaunchInts * sizeof(int),
                                      stream);
    if (err != cudaSuccess) return err;
    extend_bd_live<READ, NCAP, SCAN, ROLL, REDUCE, TRIM>
        <<<blocks, kThreads, 0, stream>>>(
            (const int32_t*)q, (const int32_t*)t, (const int32_t*)params,
            (int2*)eh, (int*)aux, n, NL, tmax, pstride);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    extend_bd_frozen<READ, STEP, NCAP, SCAN, ROLL, REDUCE, TRIM>
        <<<blocks, kThreads, 0, stream>>>(
            (const int32_t*)q, (const int32_t*)t, (const int32_t*)params,
            (int32_t*)out, (int2*)eh, (const int*)aux, n, NL, tmax, pstride,
            ostride);
    return cudaGetLastError();
}

}  // namespace

// C entry point for ctypes.  `variant` is the index of the variant in
// exp_kernel_breakdown.VARIANTS: 0 baseline, 1 no-transpose, 2 t8-slice,
// 3 tdot, 4 no-scan, 5 no-roll, 6 no-reduce, 7 no-trim, 8 unroll2.
// Pointers are device pointers from torch.Tensor.data_ptr(): eh holds
// NL x n int2, aux 3 + 6 n ints; stream is torch's current cudaStream_t.
// Launches both passes on that stream without synchronising and returns
// the first CUDA error (0 on success; cudaErrorInvalidValue for an
// unknown variant, before anything runs).
extern "C" int tpubwa_extend_bd(int variant, const void* q, const void* t,
                                const void* params, void* out, void* eh,
                                void* aux, int n, int NL, int tmax,
                                int pstride, int ostride, int device,
                                void* stream) {
    if (variant < 0 || variant > 8) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const auto args = [&](auto fn) {
        return (int)fn(q, t, params, out, eh, aux, n, NL, tmax, pstride,
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
