// The SA walk (bwt_sa), the bidirectional interval extension
// (bwt_extend) and the rightmost forward reach over the FM index, for
// Hopper (sm_90a), over the device functions of csrc/fm.cuh: K-sa on a
// persistent grid whose lanes take ranks from a rank queue, K-ext one
// interval on a group of lanes, K-reach a lane a segment of jobs, which
// it runs right to left.
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
// start where the first base fails).  The XLA loop steps every job until
// the last stops (an any() a step); its first port walked each job
// forward on its own thread, ~39 steps a job on 100-base reads.
//
// Why a backward step gives the forward walk's answer: for the jobs of
// one read at starts s and s + 1 with one min_intv, let job s + 1 end at
// e with the interval of q[s + 1, e) (its size >= min_intv).  Extending
// that interval backward by q[s] gives the interval of q[s, e).  If its
// size is still >= min_intv (and >= 1, so that it is the canonical
// interval of a string that occurs, as the forward walk's is), every
// prefix of q[s, e) occurs as often or more, so job s's walk takes every
// base up to e; and it stops there, since q[s, e + 1) occurs no more
// often than q[s + 1, e + 1), and an N or the read's end at e stops both.
// So job s ends at e with that interval, and only where the step fails,
// or job s + 1 matched nothing, does job s walk forward itself.  A read's
// jobs then take ~1.5 trips each as one chain, and 2.86 in segments of
// 32, against ~39 (smoke 3j: a forward walk a segment, a backward step a
// job, and a walk again where a backward step fails).
//
// What bounds K-reach now is the chain, not the bytes: the jobs of a
// segment are one chain of dependent trips, the forward walk at its
// right end and then a step a job, with a forward walk again wherever a
// backward step fails (past a SNP, a walk as long as the distance to
// it), so the launch lasts as long as its longest segment's chain, and a
// warp as long as its slowest lane's.  On 3j's jobs a segment of 32
// takes ~92 trips, its warp's slowest ~219 and the longest 355, each
// turn of the loop ~1.6 us (a trip to the rows, then the counts and the
// job's bookkeeping, at a few warps a scheduler); a trip costs the
// launch ~4 times what it cost the first form, whose 1.6M lanes kept
// every SM busy.  kSeg sets the trade: short segments are more chains
// side by side but more forward walks (one a segment) and more warps to
// share an SM; scripts/exp_reach_forms.py times the lengths, and a
// segment on a group of lanes (fm.cuh:bwt_extend_group, whose bookkeeping
// then runs on every lane of the group), side by side.
//
// TMA, wgmma and thread block clusters offer nothing to either: there is
// no matrix product, and each row is read at a rank the step before
// computed, so no tile can be known, let alone fetched, ahead.
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
// trip and the launch: its design spreads a query over a group of lanes
// (fm.cuh:bwt_extend_group, K3's forward step), a few BWT words a lane,
// so that a trip's counting is a few instructions a lane, and writes a
// warp's results as 16-byte stores of neighbouring chunks, where one
// thread a query made twelve 4-byte stores at a 48-byte stride.
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
constexpr int kTile = 32;      // ranks (K-sa) or segments (K-reach) a warp
                               // takes from the queue at once
constexpr int kExtGroup = 4;   // K-ext: lanes an interval (4 or 8)
constexpr int kSeg = 32;       // K-reach: jobs a segment
constexpr int kReachGroup = 1; // K-reach: lanes a segment (1, 4 or 8)
constexpr unsigned kFull = 0xffffffffu;

using fm::Rows;

#ifdef TPUBWA_WARP_HOST
// where not null, K-reach adds each of its extension steps here, and the
// occ rows (block indices) each step loads to reach_rows (one where both
// of its queries fall in one block): the host harness counts a launch's
// trips and rows with them
int64_t* reach_steps = nullptr;
std::vector<int64_t>* reach_rows = nullptr;
#endif

// the 16 bytes of v (16 / sizeof(T) values) at p (16-byte aligned), one
// store
template <class T>
__device__ __forceinline__ void store16(T* p, const T* v) {
    static_assert(sizeof(T) == 4 || sizeof(T) == 8, "int32 or int64");
    uint4 w;
    if constexpr (sizeof(T) == 4) {
        w = uint4{(unsigned)v[0], (unsigned)v[1], (unsigned)v[2],
                  (unsigned)v[3]};
    } else {
        w = uint4{(unsigned)v[0], (unsigned)((uint64_t)v[0] >> 32),
                  (unsigned)v[1], (unsigned)((uint64_t)v[1] >> 32)};
    }
#ifdef TPUBWA_WARP_HOST
    if ((uintptr_t)p & 15) {
        std::fprintf(stderr, "occ: a 16-byte store at a misaligned address\n");
        std::abort();
    }
    std::memcpy(p, &w, sizeof w);
#else
    *reinterpret_cast<uint4*>(p) = w;
#endif
}

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

// K-ext: one interval on a group of kExtGroup lanes, 32 / kExtGroup
// intervals a warp.  The group counts both occ rows of its interval
// together (fm::bwt_extend_group: a few BWT words a lane, all the rows'
// loads issued at once) and every lane of it leaves with the [4, 3]
// result; lane k of the group then stores the result's k-th 16 bytes, so
// a warp writes its intervals' results, contiguous in ok, with 16-byte
// stores of neighbouring chunks.  A lane whose group has no interval
// joins the group's shuffles (live false) and stores nothing.
template <class Idx, bool IsBack, bool Tp>
__global__ void __launch_bounds__(kThreads)
bwt_extend_kernel(fm::Index<Idx, Rows<uint32_t, Tp>> f,
                  const Idx* __restrict__ ik,
                  Idx* __restrict__ ok, int64_t n) {
    constexpr int G = kExtGroup;
    constexpr int kPer = 16 / (int)sizeof(Idx);  // values a 16-byte chunk
    constexpr int kChunks = 12 / kPer;           // chunks an interval
    const int64_t at = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if ((at - (threadIdx.x & 31)) / G >= n) return;  // the warp has none
    f = fm::with_l2(f);
    const int64_t i = at / G;
    const bool live = i < n;
    Idx in[3] = {0, 0, 0};
    if (live)
        for (int j = 0; j < 3; ++j) in[j] = ik[3 * i + j];
    Idx res[4][3];
    fm::bwt_extend_group<G, Idx, IsBack>(f, in, live, res);
    if (!live) return;
    const int gl = threadIdx.x & (G - 1);
#pragma unroll
    for (int r = 0; r < (kChunks + G - 1) / G; ++r) {
        const int k = gl + r * G;  // the lane's chunk
        if (k >= kChunks) break;
        // its values picked by selects (an index by k would put res in
        // local memory)
        Idx v[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
            v[j] = res[0][0];
#pragma unroll
            for (int m = 0; m < kChunks; ++m) {
                const int x = m * kPer + j;
                v[j] = m == k ? res[x / 3][x % 3] : v[j];
            }
        }
        store16(ok + 12 * i + k * kPer, v);
    }
}

// K-reach: the rightmost forward reach of each job, with
// _rightmost_reach's semantics: a base past 3 or the read's end stops a
// job, a read position is clipped into [0, L - 1] as the XLA gather
// clips it, and the first base's interval is kept, whatever its size, as
// the job's ik (e == start).  The jobs are cut into segments of kSeg
// (jobs [s * kSeg, (s + 1) * kSeg)); a lane takes a segment from the
// segment queue (*queue, zero at launch; one atomicAdd a warp for a tile
// of kTile segments, shared out to its idle lanes as K-sa shares ranks)
// and runs its jobs from the right end leftwards.  A job walks forward
// from its start unless it is linked to its right neighbour (the same
// read, the next start, the same min_intv) and that neighbour matched
// (its e past its start): then one backward extension of the
// neighbour's interval by the job's own base gives the job's interval,
// and where its size stays >= min_intv (and >= 1) the job ends at the
// neighbour's e.  Otherwise, and where the job's own first base fails,
// it walks forward as the first form did.  Each turn of the loop is one
// trip to memory a lane: a backward step, or a forward one, which is
// fm::bwt_extend<Idx, true> of the interval with x0 and x1 swapped (the
// bidirectional interval's symmetry: appending c to (x0, x1) is
// prepending c to (x1, x0), the result's x0 and x1 swapped back), so the
// warp's lanes take their trips together whichever step each makes.
// Around the trip, the rest of a job's memory work is cut down, since
// every lane's access is its own (see the header):
//   * the transitions that make no trip (a job's result written, the
//     next job's fields, a walk from its start) have one place in the
//     loop (resolve), so lanes on the same transition run the same code;
//   * the next two jobs' fields and first bases are fetched while the
//     steps before them are in flight, and a forward walk's next base
//     beside its step.
template <class Idx>
__global__ void __launch_bounds__(kThreads)
reach_kernel(fm::Index<Idx> f, const uint8_t* __restrict__ q, int L,
             const int32_t* __restrict__ lens,
             const int32_t* __restrict__ read_idx,
             const int32_t* __restrict__ starts,
             const Idx* __restrict__ min_intv, Idx* __restrict__ ik_out,
             Idx* __restrict__ e_out, int64_t n,
             unsigned long long* __restrict__ queue) {
    constexpr int G = kReachGroup;
    // the groups' first lanes
    constexpr unsigned kLeads = 0xffffffffu / ((1u << G) - 1u);
    const int lane = threadIdx.x & 31, lead = lane & ~(G - 1);
    const unsigned below = (1u << lead) - 1u;  // the lanes before the group
    f = fm::with_l2(f);
    const int64_t segs = (n + kSeg - 1) / kSeg;
    int64_t job = -1;  // the lane's job, -1: none
    int64_t lo = 0;    // its segment's first job
    int32_t r = -1;    // the job's read
    const uint8_t* qr = q;
    Idx jl = 0, b = 0, mi = 0;  // the read's length, the job's start, min_intv
    // forward: the last interval taken, the match's end so far and the
    // next position; backward: the neighbour's interval and e
    Idx ik[3] = {0, 0, 0}, e = 0, pos = 0;
    int c = 0;          // the pending step's base (q[pos], or q[b] back)
    int c1 = 0;         // q[b + 1]
    bool back = false;  // the pending step is the backward one
    // a read position clipped into [0, L - 1]
    const auto clip = [&](int64_t p) -> int64_t {
        return p < 0 ? 0 : p > L - 1 ? L - 1 : p;
    };
    const auto base_at = [&](Idx p) -> int { return qr[clip(p)]; };
    // the next two jobs to the left, fetched ahead in two stages while
    // the lane's steps are in flight, so that no job waits for a load of
    // its own: job ja's fields (its start, min_intv and read), then job
    // jb's bases (its first two and its read's length), loaded from its
    // fields once they have come (-1: none)
    int64_t ja = -1, jb = -1;
    int32_t ra = 0, rb = 0;
    Idx ba = 0, mia = 0, bb = 0, mib = 0, lb = 0;
    int cb0 = 0, cb1 = 0;
    const auto fields = [&](int64_t j) {
        ja = j;
        ba = starts[j];
        mia = min_intv[j];
        ra = read_idx[j];
    };
    const auto bases = [&]() {
        jb = ja;
        bb = ba;
        mib = mia;
        rb = ra;
        const uint8_t* p = q + (int64_t)rb * L;
        cb0 = p[clip(bb)];
        cb1 = p[clip((int64_t)bb + 1)];
        lb = lens[rb];
    };
    // job j's start, min_intv and read, and its first two bases; then
    // the next two are fetched
    const auto load = [&](int64_t j) {
        if (jb != j) {  // a segment's first job
            if (ja != j) fields(j);
            bases();
        }
        b = bb;
        mi = mib;
        c = cb0;
        c1 = cb1;
        if (rb != r) {
            r = rb;
            qr = q + (int64_t)r * L;
            jl = lb;
        }
        job = j;
        if (j > lo) {
            if (ja != j - 1) fields(j - 1);
            bases();
            if (j - 1 > lo) fields(j - 2);
        }
    };
    // the one-base interval of code cb, from f.l2
    const auto one_base = [&](int cb) {
        const Idx x = fm::pick4(f.l2[0], f.l2[1], f.l2[2], f.l2[3], cb);
        ik[0] = x + 1;
        ik[1] = fm::pick4(f.l2[3], f.l2[2], f.l2[1], f.l2[0], cb) + 1;
        ik[2] = fm::pick4(f.l2[1], f.l2[2], f.l2[3], f.l2[4], cb) - x;
    };
    // what the lane's job needs before its next step: its fields loaded
    // (then a backward step where linked to its finished neighbour, else
    // kStart), a walk from its own start, or its result written and the
    // job to its left taken (kStep: a step is pending)
    enum { kStep, kLoad, kStart, kDone };
    int need = kStep;
    bool linked = false;  // kLoad: the job to the right matched, and ...
    int32_t r0 = 0;       // ... its read, start and min_intv
    Idx b0 = 0, mi0 = 0;
    // the transitions that make no trip, until the lane has a step to
    // make or its segment is done (job -1): each has one place in the
    // kernel, so that lanes on the same transition run the same code
    const auto resolve = [&]() {
        while (job >= 0 && need != kStep) {
            if (need == kLoad) {
                load(job);
                need = linked && r == r0 && (int64_t)b + 1 == (int64_t)b0 &&
                               mi == mi0 && c <= 3 && b < jl
                           ? kStep : kStart;
                back = need == kStep;  // ik and e: the neighbour's
            } else if (need == kStart) {  // a walk from its own start
                const bool valid = c <= 3 && b < jl;  // its first base
                one_base(valid ? c : 0);
                e = b;
                need = kDone;
                if (valid && ik[2] >= mi) {
                    e = pos = b + 1;
                    c = c1;
                    back = false;
                    if (pos < jl && c <= 3) need = kStep;
                }
            } else {  // kDone: the job's (ik, e) written, then the next
                if (lane == lead) {
#pragma unroll
                    for (int j = 0; j < 3; ++j) ik_out[3 * job + j] = ik[j];
                    e_out[job] = e;
                }
                linked = e > b;
                r0 = r;
                b0 = b;
                mi0 = mi;
                job = job == lo ? -1 : job - 1;
                need = kLoad;
            }
        }
    };
    long long next = 0, end = 0;  // the warp's tile: segments [next, end)
    bool drained = false;         // the queue has no segment left for it
    for (;;) {
        // the idle groups take segments: what is left of the warp's
        // tile, then a new tile where groups are still idle
        unsigned idle = __ballot_sync(kFull, job < 0) & kLeads;
#pragma unroll
        for (int round = 0; round < 2; ++round) {
            if (!idle || drained) break;
            if (next == end) {
                long long t = 0;
                if (lane == 0)
                    t = (long long)atomicAdd(queue, (unsigned long long)kTile);
                t = __shfl_sync(kFull, t, 0);
                if (t >= segs) {
                    drained = true;
                    break;
                }
                next = t;
                end = segs - next < kTile ? segs : next + kTile;
            }
            const int at = __popc(idle & below);
            const long long left = end - next;
            if (job < 0 && at < left) {  // from the segment's right end
                lo = (next + at) * kSeg;
                job = (lo + kSeg < n ? lo + kSeg : n) - 1;
                need = kLoad;
                linked = false;
            }
            next += __popc(idle) < left ? __popc(idle) : left;
            idle = __ballot_sync(kFull, job < 0) & kLeads;
        }
        if (drained && idle == kLeads) break;  // every job written
        resolve();
        // the pending step: one trip, on the group (its shuffles take
        // every lane of the warp: a group with no job joins them idle)
        const bool live = job >= 0;
        const Idx in[3] = {back ? ik[0] : ik[1], back ? ik[1] : ik[0], ik[2]};
        const int cc = back ? c : 3 - c;
        // a forward walk's next base, loaded beside the step
        const int cn = live && !back ? base_at(pos + 1) : 0;
        Idx ok[4][3];
        if constexpr (G == 1) {
            if (!live) continue;
            fm::bwt_extend<Idx, true>(f, in, ok);
        } else {
            fm::bwt_extend_group<G, Idx, true>(f, in, live, ok);
            if (!live) continue;
        }
#ifdef TPUBWA_WARP_HOST
        if (reach_steps && lane == lead) {
            ++*reach_steps;
            Idx kk, ll;
            const bool rk = fm::occ4_kk(f, in[0] - 1, &kk),
                       rl = fm::occ4_kk(f, in[0] - 1 + in[2], &ll);
            if (rk) reach_rows->push_back((int64_t)(kk >> 7));
            if (rl && !(rk && (kk >> 7) == (ll >> 7)))
                reach_rows->push_back((int64_t)(ll >> 7));
        }
#endif
        const Idx x0 = fm::pick4(ok[0][0], ok[1][0], ok[2][0], ok[3][0], cc),
                  x1 = fm::pick4(ok[0][1], ok[1][1], ok[2][1], ok[3][1], cc),
                  sz = fm::pick4(ok[0][2], ok[1][2], ok[2][2], ok[3][2], cc);
        if (back) {
            // the job ends at the neighbour's e, or walks from its start
            need = sz >= mi && sz > 0 ? kDone : kStart;
            if (need == kDone) {
                ik[0] = x0;
                ik[1] = x1;
                ik[2] = sz;
            }
        } else if (sz >= mi) {
            ik[0] = x1;
            ik[1] = x0;
            ik[2] = sz;
            e = ++pos;
            c = cn;
            need = pos >= jl || c > 3 ? kDone : kStep;
        } else {
            need = kDone;
        }
    }
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
    if (!fm::aligned16((const uint32_t*)ok)) return cudaErrorInvalidValue;
    const auto kernel = is_back ? bwt_extend_kernel<Idx, true, Tp>
                                : bwt_extend_kernel<Idx, false, Tp>;
    TPUBWA_LAUNCH(kernel, blocks_for(n * kExtGroup), kThreads, 0, stream, f,
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

// K-reach's grid for n jobs: as many blocks as the card holds at once
// (the occupancy query), capped by the segments (a thread a segment at
// most)
template <class Idx>
cudaError_t shape_reach(int64_t n, int device, int64_t* blocks) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, reach_kernel<Idx>, kThreads, 0);
    if (err != cudaSuccess) return err;
    const int64_t segs = (n + kSeg - 1) / kSeg;
    *blocks = std::min<int64_t>((int64_t)per_sm * sms,
                                blocks_for(segs * kReachGroup));
    return *blocks > 0 ? cudaSuccess : cudaErrorInvalidValue;
}

template <class Idx>
cudaError_t reach_flat(const void* occ, const void* L2, int64_t primary,
                       int64_t seq_len, const void* q, int L,
                       const void* lens, const void* read_idx,
                       const void* starts, const void* min_intv, void* ik,
                       void* e, int64_t n, void* queue, int device,
                       cudaStream_t stream) {
    const auto f = index_of<Idx>(occ, L2, primary, seq_len);
    if (!fm::aligned16(f.occ)) return cudaErrorInvalidValue;
    int64_t blocks = 0;
    cudaError_t err = shape_reach<Idx>(n, device, &blocks);
    if (err == cudaSuccess)
        err = cudaMemsetAsync(queue, 0, sizeof(unsigned long long), stream);
    if (err != cudaSuccess) return err;
    TPUBWA_LAUNCH(reach_kernel<Idx>, (int)blocks, kThreads, 0, stream, f,
                  (const uint8_t*)q, L, (const int32_t*)lens,
                  (const int32_t*)read_idx, (const int32_t*)starts,
                  (const Idx*)min_intv, (Idx*)ik, (Idx*)e, n,
                  (unsigned long long*)queue);
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
// least 1.  queue is an 8-byte word the entry zeroes on the stream first
// (the segment queue).
extern "C" int tpubwa_rightmost_reach(const void* occ, const void* L2,
                                      int64_t primary, int64_t seq_len,
                                      int idx64, const void* q, int L,
                                      const void* lens, const void* read_idx,
                                      const void* starts,
                                      const void* min_intv, void* ik, void* e,
                                      int64_t n, void* queue, int device,
                                      void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (L < 1) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    return (int)(idx64 ? reach_flat<int64_t> : reach_flat<int32_t>)(
        occ, L2, primary, seq_len, q, L, lens, read_idx, starts, min_intv, ik,
        e, n, queue, device, (cudaStream_t)stream);
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
