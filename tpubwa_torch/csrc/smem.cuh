// SMEM seeding device functions (bwt.c:bwt_smem1a and
// bwt_seed_strategy1) over the FM-index functions of csrc/fm.cuh
// (set_intv, bwt_extend, bwt_extend_group), for the seeding kernels of
// csrc/smem.cu: smem1a runs one read on a warp (K2); round 3 (K3) runs a
// read on a group of G lanes, each forward step counted across the group
// (fm.cuh:bwt_extend_group), the scan itself in csrc/smem.cu.
// They follow the port's native scalar seeder step for step
// (tpubwa_torch/native/smem.cpp smem1a :235-318, seed_strategy1
// :321-344), and so bwa's scalar protocol, not the lockstep machines of
// tpubwa/device/smem_fused.py: smem1a makes exactly the bwt_extend calls
// of the scalar loop, only some of them side by side.
//
// An interval is five Idx: (x0, x1, size, qb, qe), the layout of a seeding
// row.  smem1a keeps its three stacks (curr, prev and the call's output)
// in the warp's shared memory: a call on a read of len bases pushes at
// most len - x intervals forward, never more than it had onto a backward
// stack, and emits rows of distinct qb in [0, x], so len + 1 intervals a
// stack always suffice and no bound can be passed.
//
// Like fm.cuh, the file compiles as plain C++ with TPUBWA_WARP_HOST
// defined (csrc/smem_host.cpp), after warp_host.h.

#pragma once

#include <cstdint>

#include "fm.cuh"

namespace seed {

constexpr unsigned kFull = 0xffffffffu;

using fm::bwt_extend_group;
using fm::word_bits;

template <class Idx>
struct Intv {
    Idx x0, x1, size, qb, qe;
};

// the one-base interval of code c, qb = qe = 0
template <class Idx, class Occ>
__device__ __forceinline__ Intv<Idx> set_intv(const fm::Index<Idx, Occ>& f,
                                              int c) {
    Idx ik[3];
    fm::set_intv(f, c, ik);
    return Intv<Idx>{ik[0], ik[1], ik[2], 0, 0};
}

// ik extended by base c (the base in the extension's direction), qb and qe
// kept
template <class Idx, bool IsBack, class Occ>
__device__ __forceinline__ Intv<Idx> extend(const fm::Index<Idx, Occ>& f,
                                            const Intv<Idx>& ik, int c) {
    const Idx in[3] = {ik.x0, ik.x1, ik.size};
    Idx ok[4][3];
    fm::bwt_extend<Idx, IsBack>(f, in, ok);
    return Intv<Idx>{ok[c][0], ok[c][1], ok[c][2], ik.qb, ik.qe};
}

// bwt_extend of ik on one warp: every lane gives the same ik and gets
// the same ok.  Lanes 0-7 count one BWT word each of piv - 1's row, lanes
// 8-15 one of piv - 1 + size's (a 32-bit load each, all issued at once,
// with every lane's broadcast loads of both rows' checkpoint counts);
// each packs its word's low, high and both bits under the cover mask
// into bytes (at most 16 each, 128 a row: no carry), and two warp sums
// (__reduce_add_sync) add them up, one row each.  The same counts as
// fm::bwt_extend, which counts all 16 words in each lane.
template <class Idx, bool IsBack, class Occ>
__device__ __forceinline__ void bwt_extend_warp(const fm::Index<Idx, Occ>& f,
                                                const Idx ik[3],
                                                Idx ok[4][3]) {
    const int lane = threadIdx.x & 31;
    const Idx piv = IsBack ? ik[0] : ik[1];
    const Idx k = piv - 1, l = piv - 1 + ik[2];
    Idx kk, ll, tk[4], tl[4];
    const bool rk = fm::occ4_kk(f, k, &kk), rl = fm::occ4_kk(f, l, &ll);
    const bool of_l = lane & 8;  // this lane's word is of l's row
    const Idx x = of_l ? ll : kk;
    uint32_t w = 0;
    uint4 ck{}, cl{};
    if (lane < 16 && (of_l ? rl : rk))
        w = __ldg(fm::occ_row(f, x) + 4 + (lane & 7));
    if (rk) ck = fm::load16(fm::occ_block(f, (int64_t)(kk >> 7)));
    if (rl) cl = fm::load16(fm::occ_block(f, (int64_t)(ll >> 7)));
    const uint32_t bits =
        lane < 16 ? word_bits(w, (int)(x & 127) + 1, lane & 7) : 0u;
    const uint32_t sk = __reduce_add_sync(kFull, of_l ? 0u : bits);
    const uint32_t sl = __reduce_add_sync(kFull, of_l ? bits : 0u);
    if (rk)
        fm::bit_counts(ck, (int)(kk & 127) + 1, sk & 255u, sk >> 8 & 255u,
                       sk >> 16, tk);
    else
        fm::occ4_edge(f, k, tk);
    if (rl)
        fm::bit_counts(cl, (int)(ll & 127) + 1, sl & 255u, sl >> 8 & 255u,
                       sl >> 16, tl);
    else
        fm::occ4_edge(f, l, tl);
    fm::extend_counts<Idx, IsBack>(f, ik, tk, tl, ok);
}

// ik extended by base c on one warp (bwt_extend_warp), qb and qe kept
template <class Idx, bool IsBack, class Occ>
__device__ __forceinline__ Intv<Idx> extend_warp(const fm::Index<Idx, Occ>& f,
                                                 const Intv<Idx>& ik,
                                                 int c) {
    const Idx in[3] = {ik.x0, ik.x1, ik.size};
    Idx ok[4][3];
    bwt_extend_warp<Idx, IsBack>(f, in, ok);
    return Intv<Idx>{ok[c][0], ok[c][1], ok[c][2], ik.qb, ik.qe};
}

// the one-base interval of code c (0-3, known at run time) from f.l2
// (with_l2), picked by selects: no load
template <class Idx, class Occ>
__device__ __forceinline__ Intv<Idx> set_intv_l2(const fm::Index<Idx, Occ>& f,
                                                 int c) {
    const Idx* v = f.l2;
    const Idx lo = fm::pick4(v[0], v[1], v[2], v[3], c);
    return Intv<Idx>{lo + 1, fm::pick4(v[3], v[2], v[1], v[0], c) + 1,
                     fm::pick4(v[1], v[2], v[3], v[4], c) - lo, 0, 0};
}

// ik extended forward by base c (0-3, known at run time) on a group of G
// lanes: one read a thread (G 1, fm::bwt_extend; a lane with live false
// must not call it), a group of 4, 8 or 16 (bwt_extend_group) or the warp
// (G 32, bwt_extend_warp); ok[c] is picked by selects, so ok stays in
// registers.  qb and qe are kept.
template <int G, class Idx, class Occ>
__device__ __forceinline__ Intv<Idx> extend_fwd(const fm::Index<Idx, Occ>& f,
                                                const Intv<Idx>& ik, int c,
                                                bool live) {
    const Idx in[3] = {ik.x0, ik.x1, ik.size};
    Idx ok[4][3];
    if constexpr (G == 1)
        fm::bwt_extend<Idx, false>(f, in, ok);
    else if constexpr (G == 32)
        bwt_extend_warp<Idx, false>(f, in, ok);
    else
        bwt_extend_group<G, Idx, false>(f, in, live, ok);
    return Intv<Idx>{fm::pick4(ok[0][0], ok[1][0], ok[2][0], ok[3][0], c),
                     fm::pick4(ok[0][1], ok[1][1], ok[2][1], ok[3][1], c),
                     fm::pick4(ok[0][2], ok[1][2], ok[2][2], ok[3][2], c),
                     ik.qb, ik.qe};
}

// the lanes below `lane`
__device__ __forceinline__ unsigned lanes_below(int lane) {
    return (1u << lane) - 1u;
}

// the highest lane of a non-empty lane mask
__device__ __forceinline__ int top_lane(unsigned mask) {
    return 31 - __clz(mask);
}

// smem1a's forward phase alone (the split's K-fwd): from x (q[x] <= 3,
// min_intv >= 1, the stacks' last readers done) the warp extends the
// match forward one base a step, pushing the interval each time the next
// base shrinks it, and leaves the n_prev pushed intervals flipped into
// prev, longest match (smallest interval) first, qb 0 and qe their end.
// Returns the next x (prev[0].qe, the call's return: the backward half
// never changes it).
template <class Idx, class Occ>
__device__ __forceinline__ int smem1a_fwd(const fm::Index<Idx, Occ>& f,
                                          const uint8_t* q, int len, int x,
                                          Idx min_intv, Intv<Idx>* curr,
                                          Intv<Idx>* prev, int& n_prev,
                                          int& steps, int& chain) {
    const int lane = threadIdx.x & 31;
    Intv<Idx> ik = set_intv(f, q[x]);
    ik.qe = x + 1;
    // forward: push the interval each time the next base shrinks it
    int n_curr = 0, i = x + 1;
    for (; i < len; ++i) {
        const int c = q[i];
        if (c > 3) break;
        // forward extension reads the complement's slot
        const Intv<Idx> ok = extend_warp<Idx, false>(f, ik, 3 - c);
        ++steps;
        ++chain;
        if (ok.size != ik.size) {
            if (lane == 0) curr[n_curr] = ik;
            ++n_curr;
            if (ok.size < min_intv) break;
        }
        ik = ok;
        ik.qe = i + 1;
    }
    // an N, or the read's end, ends the match with ik on the stack
    if (i == len || q[i] > 3) {
        if (lane == 0) curr[n_curr] = ik;
        ++n_curr;
    }
    __syncwarp();
    // longest matches (smallest intervals) first
    for (int j = lane; j < n_curr; j += 32) prev[j] = curr[n_curr - 1 - j];
    __syncwarp();
    n_prev = n_curr;
    return (int)prev[0].qe;
}

// smem1a's backward phase alone (the split's K-bwd): from the stack
// prev[0, n_prev) that smem1a_fwd left for a call at x (every lane
// holding the same n_prev, prev visible to all of them), the SMEMs into
// mem[0, n_mem) by DEcreasing query start.  curr and prev are swapped as
// the rounds go (the caller's pointers are not).  A round that emits
// drops the interval it emits from the stack, so a call emits at most
// n_prev rows.
template <class Idx, class Occ>
__device__ __forceinline__ void smem1a_bwd(const fm::Index<Idx, Occ>& f,
                                           const uint8_t* q, int x,
                                           Idx min_intv, Intv<Idx>* curr,
                                           Intv<Idx>* prev, int n_prev,
                                           Intv<Idx>* mem, int& n_mem,
                                           int& steps, int& chain) {
    const int lane = threadIdx.x & 31;
    n_mem = 0;
    // backward: extend every interval of the stack by q[i]; one that can
    // go no further is an SMEM unless a longer one already ended here
    Idx last_qb = 0;  // mem[n_mem - 1].qb where n_mem > 0
    for (int i = x - 1; i >= -1; --i) {
        const int c = (i < 0 || q[i] > 3) ? -1 : q[i];
        int n_next = 0;
        bool settled = false;   // the round's first failure was seen
        bool survived = false;  // a survivor was seen
        Idx carry = 0;          // the last survivor's size
        for (int s = 0; s < n_prev; s += 32) {
            const int j = s + lane;
            const bool live = j < n_prev;
            Intv<Idx> p{}, ok{};
            if (live) p = prev[j];
            if (live && c >= 0) ok = extend<Idx, true>(f, p, c);
            if (c >= 0) {
                steps += n_prev - s < 32 ? n_prev - s : 32;
                ++chain;
            }
            const bool fail = live && (c < 0 || ok.size < min_intv);
            const bool good = live && !fail;
            const unsigned fails = __ballot_sync(kFull, fail);
            const unsigned goods = __ballot_sync(kFull, good);
            if (!settled && fails) {
                settled = true;
                const int first = __ffs(fails) - 1;
                if (!survived && !(goods & lanes_below(first)) &&
                    (n_mem == 0 || i + 1 < last_qb)) {
                    if (lane == first) {
                        Intv<Idx> m = p;
                        m.qb = i + 1;
                        mem[n_mem] = m;
                    }
                    ++n_mem;
                    last_qb = i + 1;
                }
            }
            const unsigned below = goods & lanes_below(lane);
            const Idx before = __shfl_sync(
                kFull, ok.size, below ? top_lane(below) : lane);
            const bool keep =
                good && (below ? ok.size != before
                               : !survived || ok.size != carry);
            const unsigned keeps = __ballot_sync(kFull, keep);
            if (keep)  // qb and qe kept from p
                curr[n_next + __popc(keeps & lanes_below(lane))] =
                    Intv<Idx>{ok.x0, ok.x1, ok.size, p.qb, p.qe};
            n_next += __popc(keeps);
            if (goods) {
                carry = __shfl_sync(kFull, ok.size, top_lane(goods));
                survived = true;
            }
            if (c < 0) break;  // settled, and nothing survives
        }
        if (n_next == 0) break;
        Intv<Idx>* t = prev;
        prev = curr;
        curr = t;
        n_prev = n_next;
        __syncwarp();
    }
    __syncwarp();  // mem's rows are visible to every lane
}

// bwt_smem1a with max_intv = 0, as mem_collect_intv calls it in rounds 1
// and 2 (bwa's max_intv branches never run there), on one warp: the
// SMEMs of q[0, len) that cover x, of at least min_intv occurrences, into
// mem[0, n_mem) by DEcreasing query start (the caller reads them
// backwards).  Every lane calls it with the same arguments and leaves
// with the same n_mem, steps, chain and return value (the next x); curr,
// prev and mem are the warp's stacks of len + 1 intervals in shared
// memory.  steps counts the bwt_extend calls (the scalar loop's), chain
// the rounds of them the warp makes one after another: a forward step,
// or a strip of up to 32 backward extensions.
//
// The forward phase is one chain: the warp makes each extension
// together (bwt_extend_warp) and lane 0 pushes.  The backward phase
// extends the stack by q[i] a lane an interval, in strips of 32.  The
// scalar loop (native/smem.cpp:286-309) visits prev in order and (a)
// keeps a surviving extension unless its size equals that of the last
// one it kept, and (b) emits the first failing interval that comes before
// any survivor, unless a row already starts at or before i + 1.  The
// extensions themselves are independent; the warp gets the same result:
//   (a) a survivor that is not kept has the size of the last kept one, so
//       "the last kept" and "the last survivor" have the same size: a lane
//       compares with the nearest survivor below it in its strip (a
//       ballot and a shuffle) or, for the strip's first, with the last
//       survivor of the strips before (carried across strips), and the
//       kept lanes take their slots in order by a prefix count;
//   (b) once the round's first failing interval is seen the question is
//       settled: if it emits, the row it writes starts at i + 1 and stops
//       every later one; if it does not, whatever stopped it (a survivor
//       before it, or a row starting at or before i + 1) stops every
//       later one too.  So the warp tests that one interval alone.
// On an index the sizes grow along the stack (a shorter match's
// interval holds a longer one's), so failures come before survivors; the
// rule above does not lean on that.
//
// Seed mode split's two kernels (K-fwd, K-bwd) run its two phases apart:
// smem1a_fwd and smem1a_bwd (above) repeat its forward and backward
// phases line for line.  smem1a keeps its own body, so that K2's, K2-tp's
// and K-cur's code is the same as before the split (one body calling the
// halves changed their SASS); tests/test_torch_split_host.py holds the
// halves, run one after the other, to smem1a (K-cur) on every job.
template <class Idx, class Occ>
__device__ int smem1a(const fm::Index<Idx, Occ>& f, const uint8_t* q, int len,
                      int x, Idx min_intv, Intv<Idx>* curr, Intv<Idx>* prev,
                      Intv<Idx>* mem, int& n_mem, int& steps, int& chain) {
    const int lane = threadIdx.x & 31;
    n_mem = 0;
    __syncwarp();  // the stacks' last readers are done
    if (q[x] > 3) return x + 1;
    if (min_intv < 1) min_intv = 1;
    Intv<Idx> ik = set_intv(f, q[x]);
    ik.qe = x + 1;
    // forward: push the interval each time the next base shrinks it
    int n_curr = 0, i = x + 1;
    for (; i < len; ++i) {
        const int c = q[i];
        if (c > 3) break;
        // forward extension reads the complement's slot
        const Intv<Idx> ok = extend_warp<Idx, false>(f, ik, 3 - c);
        ++steps;
        ++chain;
        if (ok.size != ik.size) {
            if (lane == 0) curr[n_curr] = ik;
            ++n_curr;
            if (ok.size < min_intv) break;
        }
        ik = ok;
        ik.qe = i + 1;
    }
    // an N, or the read's end, ends the match with ik on the stack
    if (i == len || q[i] > 3) {
        if (lane == 0) curr[n_curr] = ik;
        ++n_curr;
    }
    __syncwarp();
    // longest matches (smallest intervals) first
    for (int j = lane; j < n_curr; j += 32) prev[j] = curr[n_curr - 1 - j];
    __syncwarp();
    const int ret = (int)prev[0].qe;
    // backward: extend every interval of the stack by q[i]; one that can
    // go no further is an SMEM unless a longer one already ended here
    int n_prev = n_curr;
    Idx last_qb = 0;  // mem[n_mem - 1].qb where n_mem > 0
    for (i = x - 1; i >= -1; --i) {
        const int c = (i < 0 || q[i] > 3) ? -1 : q[i];
        int n_next = 0;
        bool settled = false;   // the round's first failure was seen
        bool survived = false;  // a survivor was seen
        Idx carry = 0;          // the last survivor's size
        for (int s = 0; s < n_prev; s += 32) {
            const int j = s + lane;
            const bool live = j < n_prev;
            Intv<Idx> p{}, ok{};
            if (live) p = prev[j];
            if (live && c >= 0) ok = extend<Idx, true>(f, p, c);
            if (c >= 0) {
                steps += n_prev - s < 32 ? n_prev - s : 32;
                ++chain;
            }
            const bool fail = live && (c < 0 || ok.size < min_intv);
            const bool good = live && !fail;
            const unsigned fails = __ballot_sync(kFull, fail);
            const unsigned goods = __ballot_sync(kFull, good);
            if (!settled && fails) {
                settled = true;
                const int first = __ffs(fails) - 1;
                if (!survived && !(goods & lanes_below(first)) &&
                    (n_mem == 0 || i + 1 < last_qb)) {
                    if (lane == first) {
                        Intv<Idx> m = p;
                        m.qb = i + 1;
                        mem[n_mem] = m;
                    }
                    ++n_mem;
                    last_qb = i + 1;
                }
            }
            const unsigned below = goods & lanes_below(lane);
            const Idx before = __shfl_sync(
                kFull, ok.size, below ? top_lane(below) : lane);
            const bool keep =
                good && (below ? ok.size != before
                               : !survived || ok.size != carry);
            const unsigned keeps = __ballot_sync(kFull, keep);
            if (keep)  // qb and qe kept from p
                curr[n_next + __popc(keeps & lanes_below(lane))] =
                    Intv<Idx>{ok.x0, ok.x1, ok.size, p.qb, p.qe};
            n_next += __popc(keeps);
            if (goods) {
                carry = __shfl_sync(kFull, ok.size, top_lane(goods));
                survived = true;
            }
            if (c < 0) break;  // settled, and nothing survives
        }
        if (n_next == 0) break;
        Intv<Idx>* t = prev;
        prev = curr;
        curr = t;
        n_prev = n_next;
        __syncwarp();
    }
    __syncwarp();  // mem's rows are visible to every lane
    return ret;
}

}  // namespace seed
