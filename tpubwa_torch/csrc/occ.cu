// The SA walk (bwt_sa) and the bidirectional interval extension
// (bwt_extend) over the FM index, for Hopper (sm_90a), over the device
// functions of csrc/fm.cuh: K-sa on a persistent grid whose lanes take
// ranks from a rank queue, K-ext one query a thread.
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
// K-reach replaces tpubwa/device/smem.py:_rightmost_reach (:62, a
// while_loop over bwt_extend :108); the wrapper is
// tpubwa_torch/device/smem.py:rightmost_reach.  A job (read, start,
// min_intv) extends forward from q[read, start:] one base a step, as far
// as the interval of the matched text keeps size >= min_intv: ik idt [n,
// 3], the last interval taken, and e idt [n], the end of the match (e ==
// start where the first base fails).  One thread a job, each step K-ext's
// device function (fm.cuh:bwt_extend, two occ rows) and the complement's
// interval taken from its four; the XLA loop steps every job until the
// last stops (an any() a step), the kernel each job to its own end.
//
// Each kernel has a TP instantiation (Tp true), for an index split into
// row slabs across devices (tpubwa_torch/dist/index_tp.py:TpIndex, the
// counterpart of tpubwa/dist/index_tp.py): K-sa's marked walk (tpubwa's
// TpIndex.sa_lookup, :132, the only walk it shards) and K-ext (its
// TpIndex.bwt_extend, :111), behind tpubwa_sa_lookup_tp and
// tpubwa_bwt_extend_tp.  They compute what the flat ones compute; only
// a row's address differs (fm.cuh:row_at over fm::Slabs), and the flat
// instantiations compile as before.
//
// What bounds K-sa on this card is not the distinct bytes it reads.  An
// LF step reads one 48-byte occ row at a rank the step before computed;
// the marked walk adds a 32-byte mark row.  The distinct sectors a
// launch reads over 3.35 TB/s (chip_smoke.py counts them from the plain
// version's reads) is a bound no walk can reach, for two reasons:
//   * the chain: a rank-sampled walk is geometric with mean 32, so the
//     longest of a launch's n walks takes about 32 ln n steps (348 of
//     77,830 random ranks on the 64 Mbp index), and the launch cannot
//     end before that walk's chain of dependent trips has; a launch
//     with fewer ranks than the grid has lanes ends with it (smoke 3g:
//     0.73 us a step of the longest walk);
//   * the traffic: every step reads its row again, anywhere in an index
//     far larger than what L2 keeps of it (a warm launch reads as long
//     as one after a 64 MB write), so a launch moves its steps' rows,
//     one or two 64-byte units of HBM each (a 48-byte row spans two in
//     half the blocks), not its distinct sectors: 5b's first launch,
//     506,727 ranks and 15.6M steps, needs ~1.5 GB, ~0.45 ms at HBM's
//     peak rate, and takes ~0.51 ms.
// K-ext is two independent rows a query, bound by the latency of one
// trip.
//
// What K-sa's design does about it:
//   * a step is one trip to memory: inv_psi loads its row as three
//     16-byte loads issued together and picks the base, its count and
//     L2 from registers (fm.cuh:lf_row); the marked walk loads the mark
//     row and the occ row of the same rank together, and takes the mark
//     bit and index from the mark row's registers, so at most one row is
//     loaded in vain, on the step that ends the walk;
//   * no lane idles while ranks are left: a persistent grid, as many
//     blocks as the card holds at once (the occupancy query at launch,
//     capped by the ranks, or by the caller's max_blocks), each lane
//     walking one rank, writing its position when the walk ends and
//     taking the next rank at once.  Lane 0 of a warp takes a tile of
//     kTile ranks from the rank queue (an int32 counter the entry
//     zeroes) with one atomicAdd, and the warp's idle lanes share it out
//     by __ballot_sync/__popc, so a launch makes about n / 32 atomics,
//     not one a walk.  A long walk no longer holds its warp's other 31
//     lanes, nor its block's other warps (one rank a thread, the first
//     form, made a warp wait for its longest walk, 4.1 times the mean,
//     and a block for its slowest warp).
// The queue is what a traffic-bound launch gains from: the rows of all
// its steps are in flight at once until the ranks run out.  The one-trip
// step is what a chain-bound launch gains from.  Neither cuts the
// traffic (tpubwa_torch/scripts/exp_ksa_forms.py times each alone).
// The counter must not pass 2^31 - 1: each warp takes at most one tile
// past n, so the entry refuses an n above 2^31 - 1 - kTile * (warps + 1)
// (cudaErrorInvalidValue, before anything runs).
//
// With TPUBWA_WARP_HOST defined the file compiles as plain C++ against
// warp_host.h (csrc/occ_host.cpp), so the tests hold it to the plain
// versions, under the sanitizers, in both lane orders, on a machine with
// no card.

#include <algorithm>
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

constexpr int kThreads = 128;  // threads a block
constexpr int kTile = 32;      // ranks a warp takes from the queue at once
constexpr unsigned kFull = 0xffffffffu;

using fm::Rows;

// one step of a lane's walk of rank i, now at k after `steps` LF steps:
// the rows of k loaded together, then the walk ends (its position
// written, i set to -1) or takes an LF step.  Tp: the index's rows in
// slabs (fm::Slabs)
template <class Idx, bool Marked, bool Tp>
__device__ __forceinline__ void walk_step(
    const fm::Index<Idx, Rows<uint32_t, Tp>>& f,
    const Rows<uint32_t, Tp>& marks, const Rows<Idx, Tp>& sa_marked,
    int mark_D, const Idx* __restrict__ sa_sample, Idx* __restrict__ out,
    int& i, Idx& k, Idx& steps) {
    if (Marked) {
        const fm::MarkRow m = fm::load_mark_row(marks, k);
        const Idx x = fm::lf_x(f, k);
        const fm::Row row = fm::load_row(f, x);
        const bool ends = steps >= mark_D - 1 || fm::mark_bit(m, k);
        // LF is taken whether or not the walk ends and then kept or not
        // by a select, and waits for the mark row too (lf_row's gate),
        // so the step's five loads are issued together
        const Idx lf = fm::lf_row(f, row, k, x, m.a.x ^ m.b.x);
        if (ends) {
            out[i] = steps +
                     __ldg(fm::row_at<1>(sa_marked, fm::mark_index(m, k)));
            i = -1;
        }
        k = ends ? k : lf;
        steps += ends ? 0 : 1;
    } else if ((k & (fm::kSaIntv - 1)) == 0 || steps > f.seq_len) {
        out[i] = steps + __ldg(sa_sample + (k >> 5));
        i = -1;
    } else {
        k = fm::inv_psi(f, k);
        ++steps;
    }
}

// K-sa: each lane walks one rank at a time, from the rank queue (*queue,
// zero at launch); lanes[i] (where not null) gets the global index of
// the thread that walked rank i.  Tp: the TP instantiation, the index's
// rows in slabs
template <class Idx, bool Marked, bool Tp>
__global__ void __launch_bounds__(kThreads)
sa_lookup_kernel(fm::Index<Idx, Rows<uint32_t, Tp>> f,
                 Rows<uint32_t, Tp> marks, Rows<Idx, Tp> sa_marked,
                 int mark_D, const Idx* __restrict__ sa_sample,
                 const Idx* __restrict__ ranks, Idx* __restrict__ out,
                 int n, int32_t* __restrict__ queue,
                 int32_t* __restrict__ lanes) {
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    f = fm::with_l2(f);
    int i = -1;              // the lane's rank, -1: none
    Idx k = 0, steps = 0;    // where its walk is, and its LF steps so far
    int next = 0, end = 0;   // the warp's tile: ranks [next, end) untaken
    bool drained = false;    // the queue has no rank left for the warp
    for (;;) {
        // the idle lanes take ranks: what is left of the warp's tile,
        // then a new tile where lanes are still idle (32 serve them all)
        unsigned idle = __ballot_sync(kFull, i < 0);
#pragma unroll
        for (int round = 0; round < 2; ++round) {
            if (!idle || drained) break;
            if (next == end) {
                int t = 0;
                if (lane == 0) t = atomicAdd(queue, kTile);
                t = __shfl_sync(kFull, t, 0);
                if (t >= n) {
                    drained = true;
                    break;
                }
                next = t;
                end = n - t < kTile ? n : t + kTile;
            }
            const int at = __popc(idle & below), left = end - next;
            if (i < 0 && at < left) {
                i = next + at;
                const Idx r = ranks[i];
                k = r < 0 ? 0 : r > f.seq_len ? f.seq_len : r;
                steps = 0;
                if (lanes) lanes[i] = (int32_t)(blockIdx.x * blockDim.x +
                                                threadIdx.x);
            }
            next += __popc(idle) < left ? __popc(idle) : left;
            idle = __ballot_sync(kFull, i < 0);
        }
        if (drained && idle == kFull) break;  // every walk written
        if (i >= 0)
            walk_step<Idx, Marked, Tp>(f, marks, sa_marked, mark_D,
                                       sa_sample, out, i, k, steps);
    }
}

template <class Idx, bool IsBack, bool Tp>
__global__ void __launch_bounds__(kThreads)
bwt_extend_kernel(fm::Index<Idx, Rows<uint32_t, Tp>> f,
                  const Idx* __restrict__ ik,
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

// K-reach: the rightmost forward reach of each job (_rightmost_reach's
// semantics: a base past 3 or the read's end stops it, a read position
// is clipped into [0, L - 1] as the XLA gather clips it, and the first
// base's interval is kept, whatever its size, as the job's ik)
template <class Idx>
__global__ void __launch_bounds__(kThreads)
reach_kernel(fm::Index<Idx> f, const uint8_t* __restrict__ q, int L,
             const int32_t* __restrict__ lens,
             const int32_t* __restrict__ read_idx,
             const int32_t* __restrict__ starts,
             const Idx* __restrict__ min_intv, Idx* __restrict__ ik_out,
             Idx* __restrict__ e_out, int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    f = fm::with_l2(f);
    const uint8_t* qr = q + (int64_t)read_idx[i] * L;
    const Idx b = starts[i], jl = lens[read_idx[i]], mi = min_intv[i];
    const auto base_at = [&](Idx pos) -> int {
        return qr[pos < 0 ? 0 : pos > L - 1 ? L - 1 : pos];
    };
    const int c0 = base_at(b);
    const bool valid0 = c0 <= 3 && b < jl;
    Idx ik[3];
    fm::set_intv(f, valid0 ? c0 : 0, ik);
    bool live = valid0 && ik[2] >= mi;
    Idx e = live ? b + 1 : b;
    for (Idx pos = b + 1; live; ++pos) {
        const int c = base_at(pos);
        if (pos >= jl || c > 3) break;
        Idx ok[4][3];
        fm::bwt_extend<Idx, false>(f, ik, ok);
        // the complement's interval, picked by selects (fm::pick4: an
        // index by c would put ok in local memory)
        Idx nik[3];
#pragma unroll
        for (int j = 0; j < 3; ++j)
            nik[j] = fm::pick4(ok[0][j], ok[1][j], ok[2][j], ok[3][j], 3 - c);
        live = nik[2] >= mi;
        if (live) {
#pragma unroll
            for (int j = 0; j < 3; ++j) ik[j] = nik[j];
            e = pos + 1;
        }
    }
    for (int j = 0; j < 3; ++j) ik_out[3 * i + j] = ik[j];
    e_out[i] = e;
}

int blocks_for(int64_t n) { return (int)((n + kThreads - 1) / kThreads); }

template <class Idx>
fm::Index<Idx> index_of(const void* occ, const void* L2, int64_t primary,
                        int64_t seq_len) {
    return fm::Index<Idx>{(const uint32_t*)occ, (const Idx*)L2,
                          (Idx)primary, (Idx)seq_len};
}

// K-sa's launch for n ranks: the blocks an SM holds (the occupancy
// query), the card's SMs, and the grid: what the card holds at once,
// capped by the ranks (a thread a rank at most) and, where max_blocks >
// 0, by max_blocks
struct ShapeSa {
    int blocks_per_sm = 0, sms = 0;
    int64_t blocks = 0;
};

template <class Idx, bool Marked, bool Tp = false>
cudaError_t shape_sa(int64_t n, int max_blocks, int device, ShapeSa* s) {
    cudaError_t err = cudaDeviceGetAttribute(
        &s->sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &s->blocks_per_sm, sa_lookup_kernel<Idx, Marked, Tp>, kThreads,
            0);
    if (err != cudaSuccess) return err;
    int64_t blocks = (int64_t)s->blocks_per_sm * s->sms;
    if (max_blocks > 0 && max_blocks < blocks) blocks = max_blocks;
    s->blocks = std::min<int64_t>(blocks, blocks_for(n));
    // the queue's counter ends below n + kTile * (warps + 1)
    const int64_t warps = s->blocks * (kThreads / 32);
    if (n > INT32_MAX - kTile * (warps + 1)) return cudaErrorInvalidValue;
    return s->blocks > 0 || n == 0 ? cudaSuccess : cudaErrorInvalidValue;
}

template <class Idx, bool Marked, bool Tp>
cudaError_t launch_sa(const fm::Index<Idx, Rows<uint32_t, Tp>>& f,
                      const Rows<uint32_t, Tp>& marks,
                      const Rows<Idx, Tp>& sa_marked, const void* sa_sample,
                      int mark_D, const void* ranks, void* out, int64_t n,
                      void* queue, void* lanes, int max_blocks, int device,
                      cudaStream_t stream) {
    ShapeSa s;
    cudaError_t err = shape_sa<Idx, Marked, Tp>(n, max_blocks, device, &s);
    if (err != cudaSuccess) return err;  // refused: no launch is made
    if (!fm::aligned16(f.occ) || (Marked && !fm::aligned16(marks)))
        return cudaErrorInvalidValue;
    if (n <= 0) return cudaSuccess;
    err = cudaMemsetAsync(queue, 0, sizeof(int32_t), stream);
    if (err != cudaSuccess) return err;
    // (a template-id's comma would split the launch macro's arguments)
    const auto kernel = sa_lookup_kernel<Idx, Marked, Tp>;
    TPUBWA_LAUNCH(kernel, (int)s.blocks, kThreads, 0, stream, f, marks,
                  sa_marked, mark_D, (const Idx*)sa_sample, (const Idx*)ranks,
                  (Idx*)out, (int)n, (int32_t*)queue, (int32_t*)lanes);
    return cudaGetLastError();
}

template <class Idx, bool Tp>
cudaError_t launch_extend(const fm::Index<Idx, Rows<uint32_t, Tp>>& f,
                          int is_back, const void* ik, void* ok, int64_t n,
                          cudaStream_t stream) {
    const auto kernel = is_back ? bwt_extend_kernel<Idx, true, Tp>
                                : bwt_extend_kernel<Idx, false, Tp>;
    TPUBWA_LAUNCH(kernel, blocks_for(n), kThreads, 0, stream, f,
                  (const Idx*)ik, (Idx*)ok, n);
    return cudaGetLastError();
}

template <class Idx>
cudaError_t extend_flat(const void* occ, const void* L2, int64_t primary,
                        int64_t seq_len, int is_back, const void* ik, void* ok,
                        int64_t n, cudaStream_t stream) {
    return launch_extend<Idx, false>(index_of<Idx>(occ, L2, primary, seq_len),
                                     is_back, ik, ok, n, stream);
}

template <class Idx>
cudaError_t reach_flat(const void* occ, const void* L2, int64_t primary,
                       int64_t seq_len, const void* q, int L,
                       const void* lens, const void* read_idx,
                       const void* starts, const void* min_intv, void* ik,
                       void* e, int64_t n, cudaStream_t stream) {
    const auto f = index_of<Idx>(occ, L2, primary, seq_len);
    if (!fm::aligned16(f.occ)) return cudaErrorInvalidValue;
    TPUBWA_LAUNCH(reach_kernel<Idx>, blocks_for(n), kThreads, 0, stream, f,
                  (const uint8_t*)q, L, (const int32_t*)lens,
                  (const int32_t*)read_idx, (const int32_t*)starts,
                  (const Idx*)min_intv, (Idx*)ik, (Idx*)e, n);
    return cudaGetLastError();
}

template <class Idx>
cudaError_t sa_flat(const void* occ, const void* L2, const void* marks,
                    const void* sa_marked, const void* sa_sample,
                    int64_t primary, int64_t seq_len, int mark_D,
                    const void* ranks, void* out, int64_t n, void* queue,
                    void* lanes, int max_blocks, int device,
                    cudaStream_t stream) {
    const auto launch = mark_D > 0 ? launch_sa<Idx, true, false>
                                   : launch_sa<Idx, false, false>;
    return launch(index_of<Idx>(occ, L2, primary, seq_len),
                  (const uint32_t*)marks, (const Idx*)sa_marked, sa_sample,
                  mark_D, ranks, out, n, queue, lanes, max_blocks, device,
                  stream);
}

// the TP instantiations' index: the occ slabs of table occ (3 * n_slabs
// int64, fm::slab_table), L2 on the launch device
template <class Idx>
cudaError_t index_tp(int n_slabs, const int64_t* occ, const void* L2,
                     int64_t primary, int64_t seq_len, int device,
                     fm::Index<Idx, fm::Slabs<uint32_t>>* f) {
    f->L2 = (const Idx*)L2;
    f->primary = (Idx)primary;
    f->seq_len = (Idx)seq_len;
    return fm::slab_table(occ, n_slabs, device, &f->occ);
}

template <class Idx>
cudaError_t sa_tp(int n_slabs, const int64_t* occ, const int64_t* marks,
                  const int64_t* sa_marked, const void* L2, int64_t primary,
                  int64_t seq_len, int mark_D, const void* ranks, void* out,
                  int64_t n, void* queue, void* lanes, int max_blocks,
                  int device, cudaStream_t stream) {
    fm::Index<Idx, fm::Slabs<uint32_t>> f{};
    fm::Slabs<uint32_t> m{};
    fm::Slabs<Idx> sm{};
    cudaError_t err = index_tp(n_slabs, occ, L2, primary, seq_len, device,
                               &f);
    if (err == cudaSuccess) err = fm::slab_table(marks, n_slabs, device, &m);
    if (err == cudaSuccess)
        err = fm::slab_table(sa_marked, n_slabs, device, &sm);
    if (err != cudaSuccess) return err;
    return launch_sa<Idx, true, true>(f, m, sm, nullptr, mark_D, ranks, out,
                                      n, queue, lanes, max_blocks, device,
                                      stream);
}

template <class Idx>
cudaError_t extend_tp(int n_slabs, const int64_t* occ, const void* L2,
                      int64_t primary, int64_t seq_len, int is_back,
                      const void* ik, void* ok, int64_t n, int device,
                      cudaStream_t stream) {
    fm::Index<Idx, fm::Slabs<uint32_t>> f{};
    const cudaError_t err =
        index_tp(n_slabs, occ, L2, primary, seq_len, device, &f);
    if (err != cudaSuccess) return err;
    return launch_extend<Idx, true>(f, is_back, ik, ok, n, stream);
}

}  // namespace

// C entry points for ctypes.  Pointers are device pointers from
// torch.Tensor.data_ptr() (occ and marks uint32 rows, 16-byte aligned,
// the rest Idx: int64_t where idx64, else int32_t); stream is torch's
// current cudaStream_t.  Each launches on that stream without
// synchronising and returns cudaGetLastError() (0 on success).

// K-sa: positions of n ranks; the marked walk where mark_D > 0 (marks
// and sa_marked read), else the rank-sampled one (sa_sample read).
// queue is an int32 the entry zeroes on the stream first (the rank
// queue); lanes (int32 [n], the thread that walked each rank) may be
// null.  max_blocks > 0 caps the grid below what the card holds.  An n
// past the queue's range (see the header) is refused before anything
// runs.
extern "C" int tpubwa_sa_lookup(const void* occ, const void* L2,
                                const void* marks, const void* sa_marked,
                                const void* sa_sample, int64_t primary,
                                int64_t seq_len, int mark_D, int idx64,
                                const void* ranks, void* out, int64_t n,
                                void* queue, void* lanes, int max_blocks,
                                int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return (int)(idx64 ? sa_flat<int64_t> : sa_flat<int32_t>)(
        occ, L2, marks, sa_marked, sa_sample, primary, seq_len, mark_D, ranks,
        out, n, queue, lanes, max_blocks, device, (cudaStream_t)stream);
}

// K-sa's TP instantiation, the marked walk over a sharded index (the
// only walk tpubwa shards): occ, marks and sa_marked are slab tables, 3 *
// n_slabs int64 each (the slabs' device addresses, first rows and
// devices, fm.cuh:slab_table), L2 is on the launch device; the rest as
// tpubwa_sa_lookup.  A slab on another device is read through peer
// access, enabled here (an error where the two devices cannot reach each
// other); mark_D <= 0 is refused (cudaErrorInvalidValue).  Nothing runs
// where an error is returned.
extern "C" int tpubwa_sa_lookup_tp(int n_slabs, const int64_t* occ,
                                   const int64_t* marks,
                                   const int64_t* sa_marked, const void* L2,
                                   int64_t primary, int64_t seq_len,
                                   int mark_D, int idx64, const void* ranks,
                                   void* out, int64_t n, void* queue,
                                   void* lanes, int max_blocks, int device,
                                   void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (mark_D <= 0) return (int)cudaErrorInvalidValue;
    return (int)(idx64 ? sa_tp<int64_t> : sa_tp<int32_t>)(
        n_slabs, occ, marks, sa_marked, L2, primary, seq_len, mark_D, ranks,
        out, n, queue, lanes, max_blocks, device, (cudaStream_t)stream);
}

// K-sa's launch for n ranks into out[3] (a host array): the blocks an SM
// holds, the card's SMs and the grid's blocks (max_blocks as in
// tpubwa_sa_lookup); returns the error a launch of n ranks would return
// before it runs.
extern "C" int tpubwa_sa_lookup_shape(int idx64, int marked, int64_t n,
                                      int max_blocks, int device,
                                      int64_t* out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    ShapeSa s;
    const auto shape = idx64 ? (marked ? shape_sa<int64_t, true>
                                       : shape_sa<int64_t, false>)
                             : (marked ? shape_sa<int32_t, true>
                                       : shape_sa<int32_t, false>);
    err = shape(n, max_blocks, device, &s);
    out[0] = s.blocks_per_sm;
    out[1] = s.sms;
    out[2] = s.blocks;
    return (int)err;
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
    return (int)(idx64 ? extend_flat<int64_t> : extend_flat<int32_t>)(
        occ, L2, primary, seq_len, is_back, ik, ok, n, (cudaStream_t)stream);
}

// K-reach: the rightmost forward reach of n jobs (read_idx, starts int32
// [n], min_intv Idx [n]) over the reads q (uint8 [B, L], codes 0-4) of
// lengths lens (int32 [B]) -> ik Idx [n, 3] and e Idx [n].  L must be at
// least 1.
extern "C" int tpubwa_rightmost_reach(const void* occ, const void* L2,
                                      int64_t primary, int64_t seq_len,
                                      int idx64, const void* q, int L,
                                      const void* lens, const void* read_idx,
                                      const void* starts,
                                      const void* min_intv, void* ik, void* e,
                                      int64_t n, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (L < 1) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    return (int)(idx64 ? reach_flat<int64_t> : reach_flat<int32_t>)(
        occ, L2, primary, seq_len, q, L, lens, read_idx, starts, min_intv, ik,
        e, n, (cudaStream_t)stream);
}

// K-ext's TP instantiation: occ is a slab table (3 * n_slabs int64, as
// tpubwa_sa_lookup_tp's), L2 on the launch device; the rest as
// tpubwa_bwt_extend.
extern "C" int tpubwa_bwt_extend_tp(int n_slabs, const int64_t* occ,
                                    const void* L2, int64_t primary,
                                    int64_t seq_len, int idx64, int is_back,
                                    const void* ik, void* ok, int64_t n,
                                    int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    return (int)(idx64 ? extend_tp<int64_t> : extend_tp<int32_t>)(
        n_slabs, occ, L2, primary, seq_len, is_back, ik, ok, n, device,
        (cudaStream_t)stream);
}
