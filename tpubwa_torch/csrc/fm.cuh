// FM-index device functions (bwt.c:bwt_occ4 / bwt_invPsi / bwt_extend /
// bwt_set_intv and the text-position marks of tpubwa's SA walk), one
// query a thread, and bwt_extend on a group of 4, 8 or 16 lanes
// (bwt_extend_group), for the kernels that walk the index: csrc/occ.cu
// and the seeding kernels of csrc/smem.cu (through csrc/smem.cuh).  The
// counterparts of the plain functions of
// tpubwa_torch/device/occ.py, which hold them to tpubwa/device/occ.py.
//
// Layout (tpubwa_torch/device/occ.py:DeviceIndex): occ rows of 12 uint32,
// 4 checkpoint counts (of each base in the stored BWT before the 128-base
// block) then the block's 8 words, 16 bases a word, base k at bit shift
// (15 - (k & 15)) << 1; mark rows of 8 uint32, the count of marked ranks
// before the 128-rank block, then 4 bit words (rank r at word
// (r & 127) >> 5, bit 31 - (r & 31)), then 3 pad words.
//
// Everything is templated on the rank type Idx: int32_t where the
// ranks fit (tpubwa_torch/device/occ.py:_fits_i32), else int64_t.  The
// counts are uint32_t and are widened, never read as signed int32: at
// GRCh38 scale (doubled length 6.2e9) they pass 2^31.
//
// Rows are read through __ldg: the index is read-only for a kernel's
// life.  A count query reads its whole row as three 16-byte loads
// (load_row), issued together before any is used, and counts from
// registers, where a loop over the row's words, its trip count the
// rank's, would load them one at a time; bwt_extend loads the rows of
// both its queries before it counts either, and one row where both fall
// in the same 128-base block (bwa's bwt_2occ4).  An LF step (inv_psi) is
// one such row: its base, its checkpoint count and L2 are picked from
// registers, so a step is one trip to memory, not a word load and then
// the loads that its base selects; a mark row is two 16-byte loads
// (load_mark_row), which the marked walk issues beside the occ row of
// the same rank (csrc/occ.cu).
//
// Where a row lives is a compile-time choice (Index's Occ, and the mark
// rows' and sa_marked's own forms): the flat array, row b at
// p + b * words, or an index sharded into slabs of rows, each its own
// allocation, maybe on another card (Slabs, the TP instantiations of
// csrc/occ.cu and csrc/smem.cu): the row's slab is picked by comparing b
// with the slabs' first rows, and the rest of the step is unchanged.
// The row's address is the only thing that differs.
//
// With TPUBWA_WARP_HOST
// defined (the host harness of csrc/warp_host.h) __popc, __ldg and the
// 16-byte load are their host equivalents (the last checks its
// alignment), and a harness may set fm::read_rows to collect the occ row
// of every query.

#pragma once

#include <cstdint>
#include <mutex>
#include <set>
#include <type_traits>
#include <utility>

#ifdef TPUBWA_WARP_HOST
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
inline int __popc(unsigned x) { return __builtin_popcount(x); }
template <class T>
inline T __ldg(const T* p) { return *p; }
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
#endif

namespace fm {

#ifdef TPUBWA_WARP_HOST
// where not null, the occ row (block index) of every occ_row query is
// appended here: the host harness counts a launch's index reads with it
inline std::vector<int64_t>* read_rows = nullptr;
#endif

constexpr int kRowWords = 12;   // occ row: 4 counts + 8 BWT words
constexpr int kMarkWords = 8;   // mark row: count + 4 bit words + 3 pad
constexpr int kSaIntv = 32;     // rank sampling of sa_sample

constexpr int kMaxSlabs = 8;    // slabs of a sharded index, at most

// An index array split into slabs of rows, each its own allocation (the
// sharded index of tpubwa_torch/dist/index_tp.py): slab s, at p[s],
// holds rows [first[s], first[s + 1]), first[0] = 0; a slot past the
// slabs has first INT64_MAX, so no row selects it.  A kernel takes it
// by value, in its parameters.
template <class T>
struct Slabs {
    const T* p[kMaxSlabs];
    int64_t first[kMaxSlabs];
};

// a kernel's rows of an index array: the flat array, or its slabs
template <class T, bool Slabbed>
using Rows = typename std::conditional<Slabbed, Slabs<T>, const T*>::type;

// the W elements of row b of a flat array
template <int W, class T>
__device__ __forceinline__ const T* row_at(const T* p, int64_t b) {
    return p + b * W;
}

// the W elements of row b of a slabbed array: its slab picked by an
// unrolled select on the slabs' first rows, so the row's address takes
// no division
template <int W, class T>
__device__ __forceinline__ const T* row_at(const Slabs<T>& s, int64_t b) {
    const T* p = s.p[0];
    int64_t lo = 0;
#pragma unroll
    for (int i = 1; i < kMaxSlabs; ++i) {
        const bool in = b >= s.first[i];
        p = in ? s.p[i] : p;
        lo = in ? s.first[i] : lo;
    }
    return p + (b - lo) * W;
}

// Occ: the occ rows' form, a pointer to the flat array or its Slabs
template <class Idx, class Occ = const uint32_t*>
struct Index {
    Occ occ;              // [n_blocks, kRowWords]
    const Idx* L2;        // [5]: 0, #A, #A+#C, #A+#C+#G, seq_len
    Idx primary;          // conceptual row of the sentinel
    Idx seq_len;          // doubled text length
    // L2's values, which a kernel loads once (with_l2) and reads where
    // the base is a constant after unrolling, or picks among by selects
    // (lf_row's base, known only at run time), so that they stay in
    // registers; set_intv still reads L2
    Idx l2[5];
};

// f with L2's values loaded into f.l2: a kernel's first step
template <class Idx, class Occ>
__device__ __forceinline__ Index<Idx, Occ> with_l2(Index<Idx, Occ> f) {
#pragma unroll
    for (int i = 0; i < 5; ++i) f.l2[i] = __ldg(f.L2 + i);
    return f;
}

// one bit (the low bit of the pair) per base of w equal to c
__device__ __forceinline__ uint32_t match(uint32_t w, int c) {
    const uint32_t x = ~(w ^ (uint32_t)c * 0x55555555u);
    return x & (x >> 1) & 0x55555555u;
}

// the occ row of block b
template <class Idx, class Occ>
__device__ __forceinline__ const uint32_t* occ_block(const Index<Idx, Occ>& f,
                                                     int64_t b) {
    return row_at<kRowWords>(f.occ, b);
}

// the occ row of stored BWT index x
template <class Idx, class Occ>
__device__ __forceinline__ const uint32_t* occ_row(const Index<Idx, Occ>& f,
                                                   Idx x) {
#ifdef TPUBWA_WARP_HOST
    if (read_rows) read_rows->push_back((int64_t)(x >> 7));
#endif
    return occ_block(f, (int64_t)(x >> 7));
}

// stored BWT[x], x in [0, seq_len)
template <class Idx, class Occ>
__device__ __forceinline__ int bwt_code(const Index<Idx, Occ>& f, Idx x) {
    const int within = (int)(x & 127);
    const uint32_t w = __ldg(occ_row(f, x) + 4 + (within >> 4));
    return (int)(w >> ((15 - (within & 15)) << 1)) & 3;
}

// the 16 bytes at p (16-byte aligned: an occ row is 48 bytes, the
// array's start aligned), one load
__device__ __forceinline__ uint4 load16(const uint32_t* p) {
#ifdef TPUBWA_WARP_HOST
    if ((uintptr_t)p & 15) {
        std::fprintf(stderr, "fm: a 16-byte load at a misaligned address\n");
        std::abort();
    }
    uint4 v;
    std::memcpy(&v, p, sizeof v);
    return v;
#else
    return __ldg(reinterpret_cast<const uint4*>(p));
#endif
}

// an occ row: the 4 checkpoint counts and the block's 8 BWT words
struct Row {
    uint4 cnt, lo, hi;  // counts; words 0-3; words 4-7
};

// the occ row of stored BWT index x, its three loads issued together
template <class Idx, class Occ>
__device__ __forceinline__ Row load_row(const Index<Idx, Occ>& f, Idx x) {
    const uint32_t* row = occ_row(f, x);
    return Row{load16(row), load16(row + 4), load16(row + 8)};
}

// the pairs of a word's first cov bases (none where cov <= 0), low bits
__device__ __forceinline__ uint32_t low_cover(int cov) {
    return cov >= 16 ? 0x55555555u
           : cov <= 0 ? 0u
                      : 0x55555555u << (2 * (16 - cov));
}

// occ of each base from a row's checkpoint counts ck and, over its
// block's first nb bases, the pairs' low bits set (lo), high bits set
// (hi) and both (both): a base of code c has low bit c & 1 and high bit
// c >> 1, so T = both, G = high - both, C = low - both, A = the rest
template <class Idx>
__device__ __forceinline__ void bit_counts(const uint4& ck, int nb,
                                           uint32_t lo, uint32_t hi,
                                           uint32_t both, Idx cnt[4]) {
    cnt[0] = (Idx)ck.x + (Idx)(nb - hi - lo + both);
    cnt[1] = (Idx)ck.y + (Idx)(lo - both);
    cnt[2] = (Idx)ck.z + (Idx)(hi - both);
    cnt[3] = (Idx)ck.w + (Idx)both;
}

// occ of each base among the row's checkpoint and its block's first nb
// bases (nb in [1, 128]), from registers: per word, the pairs' low and
// high bits under the cover mask (bit_counts).
template <class Idx>
__device__ __forceinline__ void row_occ4(const Row& r, int nb, Idx cnt[4]) {
    const uint32_t w[8] = {r.lo.x, r.lo.y, r.lo.z, r.lo.w,
                           r.hi.x, r.hi.y, r.hi.z, r.hi.w};
    uint32_t lo = 0, hi = 0, both = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const uint32_t m = low_cover(nb - 16 * i);
        const uint32_t l = w[i] & m, h = (w[i] >> 1) & m;
        lo += __popc(l);
        hi += __popc(h);
        both += __popc(l & h);
    }
    bit_counts(r.cnt, nb, lo, hi, both, cnt);
}

// occ4's stored row for conceptual row k (kk = k - (k >= primary),
// clamped into the stored rows); false where occ4 reads no row: k < 0
// (all zero) and k == seq_len (the totals, from L2)
template <class Idx, class Occ>
__device__ __forceinline__ bool occ4_kk(const Index<Idx, Occ>& f, Idx k,
                                        Idx* kk) {
    Idx x = k >= f.primary ? k - 1 : k;
    *kk = x < 0 ? 0 : x > f.seq_len - 1 ? f.seq_len - 1 : x;
    return k >= 0 && k != f.seq_len;
}

// occ4 where it reads no row (see occ4_kk)
template <class Idx, class Occ>
__device__ __forceinline__ void occ4_edge(const Index<Idx, Occ>& f, Idx k,
                                          Idx cnt[4]) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
        cnt[c] = k < 0 ? (Idx)0 : f.l2[c + 1] - f.l2[c];
}

// occ(k, c) for all four bases; k a conceptual row in [-1, seq_len]
template <class Idx, class Occ>
__device__ __forceinline__ void occ4(const Index<Idx, Occ>& f, Idx k,
                                     Idx cnt[4]) {
    Idx kk;
    if (!occ4_kk(f, k, &kk)) {
        occ4_edge(f, k, cnt);
        return;
    }
    row_occ4(load_row(f, kk), (int)(kk & 127) + 1, cnt);
}

// occ(k, c) for one base
template <class Idx, class Occ>
__device__ __forceinline__ Idx occ1(const Index<Idx, Occ>& f, Idx k, int c) {
    Idx cnt[4];
    occ4(f, k, cnt);
    return cnt[c];
}

// inv_psi's stored row for conceptual row k: x = k - (k > primary),
// clamped into the stored rows.  It equals occ4's kk except at k ==
// primary (whose LF is 0), so one row serves the BWT code and its count.
template <class Idx, class Occ>
__device__ __forceinline__ Idx lf_x(const Index<Idx, Occ>& f, Idx k) {
    const Idx x = k > f.primary ? k - 1 : k;
    return x < 0 ? 0 : x > f.seq_len - 1 ? f.seq_len - 1 : x;
}

// lane c (0-3, known at run time) of v, by selects: an index into a
// register array by a run-time value would put the array in local memory
template <class T>
__device__ __forceinline__ T pick4(T a, T b, T c, T d, int i) {
    return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

// LF of conceptual row k (bwt.h:bwt_invPsi) from registers: r is the occ
// row of x = lf_x(f, k).  x's base c is read from its word (picked by
// selects), its count is c's checkpoint count plus the matches of c
// among the block's first within + 1 bases (a run-time cover over the
// eight words, as row_occ4 counts), and L2[c] comes from f.l2 (with_l2).
//
// gate holds a word of each other row the step loaded (0 where none).
// L2[0] is 0 (no base sorts before A), so the word XOR (gate ^ the
// counts' first word) & L2[0] is the word itself; but the compiler
// cannot know it, so the word's first use waits for every row of the
// step and all their loads are issued before any is used.  Without it
// ptxas loaded the counts (and the marked walk's mark row) only after
// the words were counted: two trips a step.
template <class Idx, class Occ>
__device__ __forceinline__ Idx lf_row(const Index<Idx, Occ>& f, const Row& r,
                                      Idx k, Idx x, uint32_t gate = 0) {
    const uint32_t w[8] = {r.lo.x, r.lo.y, r.lo.z, r.lo.w,
                           r.hi.x, r.hi.y, r.hi.z, r.hi.w};
    const int within = (int)(x & 127), wi = within >> 4;
    uint32_t word = w[0];
#pragma unroll
    for (int i = 1; i < 8; ++i) word = i == wi ? w[i] : word;
    word ^= (gate ^ r.cnt.x) & (uint32_t)f.l2[0];
    const int c = (int)(word >> ((15 - (within & 15)) << 1)) & 3;
    uint32_t n = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
        n += __popc(match(w[i], c) & low_cover(within + 1 - 16 * i));
    const Idx lf = pick4(f.l2[0], f.l2[1], f.l2[2], f.l2[3], c) +
                   (Idx)pick4(r.cnt.x, r.cnt.y, r.cnt.z, r.cnt.w, c) +
                   (Idx)n;
    return k == f.primary ? (Idx)0 : lf;
}

// LF mapping on conceptual rows k in [0, seq_len]: one trip to memory,
// x's whole row as three 16-byte loads issued together (load_row), then
// everything from registers (lf_row).  f.l2 must be loaded (with_l2).
template <class Idx, class Occ>
__device__ __forceinline__ Idx inv_psi(const Index<Idx, Occ>& f, Idx k) {
    const Idx x = lf_x(f, k);
    return lf_row(f, load_row(f, x), k, x);
}

// a mark row: the count of marked ranks before its block and the first
// three bit words (a), the fourth bit word and the pad (b)
struct MarkRow {
    uint4 a, b;
};

// the mark row of conceptual rank k, as two 16-byte loads issued
// together (a mark row is 32 bytes, the array's start 16-byte aligned);
// marks: the flat array or its Slabs
template <class Idx, class Marks>
__device__ __forceinline__ MarkRow load_mark_row(const Marks& marks, Idx k) {
    const uint32_t* row = row_at<kMarkWords>(marks, (int64_t)(k >> 7));
    return MarkRow{load16(row), load16(row + 4)};
}

// k's text-position mark, from its mark row m: rank r at word
// (r & 127) >> 5, bit 31 - (r & 31)
template <class Idx>
__device__ __forceinline__ bool mark_bit(const MarkRow& m, Idx k) {
    const int within = (int)(k & 127);
    const uint32_t w = pick4(m.a.y, m.a.z, m.a.w, m.b.x, within >> 5);
    return (w >> (31 - (within & 31))) & 1u;
}

// # of marked ranks before k (k itself marked), from its mark row m: k's
// index in sa_marked.  The words below k's count whole, k's own word its
// bits above k's (marked ranks earlier in the word).
template <class Idx>
__device__ __forceinline__ int64_t mark_index(const MarkRow& m, Idx k) {
    const int within = (int)(k & 127), wi = within >> 5,
              bp = 31 - (within & 31);
    const uint32_t w[4] = {m.a.y, m.a.z, m.a.w, m.b.x};
    const uint32_t own = bp == 31 ? 0u : 0xffffffffu << (bp + 1);
    int64_t idx = m.a.x;
#pragma unroll
    for (int j = 0; j < 4; ++j)
        idx += __popc(w[j] & (j < wi ? 0xffffffffu : j == wi ? own : 0u));
    return idx;
}

// the interval of the one-base pattern c (bwt.h:bwt_set_intv): x0 from
// c's bucket, x1 from its complement's, size = the count of c
template <class Idx, class Occ>
__device__ __forceinline__ void set_intv(const Index<Idx, Occ>& f, int c,
                                         Idx ik[3]) {
    ik[0] = __ldg(f.L2 + c) + 1;
    ik[1] = __ldg(f.L2 + 3 - c) + 1;
    ik[2] = __ldg(f.L2 + c + 1) - __ldg(f.L2 + c);
}

// bwt_extend's result from its two occ4 queries: tk = occ4(piv - 1),
// tl = occ4(piv - 1 + size)
template <class Idx, bool IsBack, class Occ>
__device__ __forceinline__ void extend_counts(const Index<Idx, Occ>& f,
                                              const Idx ik[3],
                                              const Idx tk[4],
                                              const Idx tl[4],
                                              Idx ok[4][3]) {
    const Idx piv = IsBack ? ik[0] : ik[1];
    const Idx oth = IsBack ? ik[1] : ik[0];
    const Idx sz = ik[2];
    const Idx sent = piv <= f.primary && piv + sz - 1 >= f.primary;
    Idx acc = oth + sent;
#pragma unroll
    for (int c = 3; c >= 0; --c) {
        const Idx size = tl[c] - tk[c];
        const Idx npiv = f.l2[c] + 1 + tk[c];
        ok[c][IsBack ? 0 : 1] = npiv;
        ok[c][IsBack ? 1 : 0] = acc;
        ok[c][2] = size;
        acc += size;
    }
}

// bidirectional extension of ik = (x0, x1, size) by each base
// (bwt.c:bwt_extend): ok[c] = the interval of c prepended (IsBack) or
// appended, as (x0, x1, size) in tpubwa's order.  Two occ4 queries, at
// piv - 1 and piv - 1 + size: both rows are loaded before either is
// counted, and once where the two fall in one block.
template <class Idx, bool IsBack, class Occ>
__device__ __forceinline__ void bwt_extend(const Index<Idx, Occ>& f,
                                           const Idx ik[3], Idx ok[4][3]) {
    const Idx piv = IsBack ? ik[0] : ik[1];
    const Idx k = piv - 1, l = piv - 1 + ik[2];
    Idx kk, ll, tk[4], tl[4];
    const bool rk = occ4_kk(f, k, &kk), rl = occ4_kk(f, l, &ll);
    Row a{}, b{};
    if (rk) a = load_row(f, kk);
    if (rl) b = rk && (kk >> 7) == (ll >> 7) ? a : load_row(f, ll);
    if (rk) row_occ4(a, (int)(kk & 127) + 1, tk);
    else occ4_edge(f, k, tk);
    if (rl) row_occ4(b, (int)(ll & 127) + 1, tl);
    else occ4_edge(f, l, tl);
    extend_counts<Idx, IsBack>(f, ik, tk, tl, ok);
}

constexpr unsigned kFull = 0xffffffffu;

// the packed counts (low, high and both bits of the pairs under the cover
// of nb bases, a byte each) of BWT word wi (0-7) of a row
__device__ __forceinline__ uint32_t word_bits(uint32_t w, int nb, int wi) {
    const uint32_t m = fm::low_cover(nb - 16 * wi);
    const uint32_t lo = w & m, hi = (w >> 1) & m;
    return __popc(lo) | __popc(hi) << 8 | __popc(lo & hi) << 16;
}

// the 8 bytes at p (8-byte aligned: two BWT words from an even word of a
// row), one load
__device__ __forceinline__ uint2 load8(const uint32_t* p) {
#ifdef TPUBWA_WARP_HOST
    if ((uintptr_t)p & 7) {
        std::fprintf(stderr, "fm: an 8-byte load at a misaligned address\n");
        std::abort();
    }
    uint2 v;
    std::memcpy(&v, p, sizeof v);
    return v;
#else
    return __ldg(reinterpret_cast<const uint2*>(p));
#endif
}

// bwt_extend of ik on a group of G (4, 8 or 16) consecutive lanes,
// aligned to G: every lane of the group gives the same ik and gets the
// same ok.  The group's first G / 2 lanes count piv - 1's row, the others
// piv - 1 + size's, 16 / G of the row's 8 BWT words a lane (one 16-, 8-
// or 4-byte load, all issued at once, with every lane's broadcast loads
// of both rows' checkpoint counts).  Each lane packs its words' counts
// into bytes (word_bits: at most 16 each, 128 a row, no carry);
// log2(G / 2) __shfl_xor_sync rounds sum a row's inside its half of the
// group and one more swaps the halves.  The shuffles take every lane of
// the warp: a lane whose group has no step to make calls it with live
// false, loads nothing, and its ok is not to be used.  The same counts as
// fm::bwt_extend.
template <int G, class Idx, bool IsBack, class Occ>
__device__ __forceinline__ void bwt_extend_group(const fm::Index<Idx, Occ>& f,
                                                 const Idx ik[3], bool live,
                                                 Idx ok[4][3]) {
    static_assert(G == 4 || G == 8 || G == 16, "a group of 4, 8 or 16");
    constexpr int kHalf = G / 2, kPer = 16 / G;  // lanes a row, words a lane
    const int gl = threadIdx.x & (G - 1);
    const Idx piv = IsBack ? ik[0] : ik[1];
    const Idx k = piv - 1, l = piv - 1 + ik[2];
    Idx kk, ll, tk[4], tl[4];
    const bool rk = fm::occ4_kk(f, k, &kk), rl = fm::occ4_kk(f, l, &ll);
    const bool of_l = gl >= kHalf;  // this lane's words are of l's row
    const Idx x = of_l ? ll : kk;
    const int wi = (gl & (kHalf - 1)) * kPer;  // its first word
    const int nb = (int)(x & 127) + 1;
    uint4 ck{}, cl{};
    uint32_t bits = 0;
    if (live && (of_l ? rl : rk)) {
        const uint32_t* w = fm::occ_row(f, x) + 4 + wi;
        if constexpr (kPer == 4) {
            const uint4 v = fm::load16(w);
            bits = word_bits(v.x, nb, wi) + word_bits(v.y, nb, wi + 1) +
                   word_bits(v.z, nb, wi + 2) + word_bits(v.w, nb, wi + 3);
        } else if constexpr (kPer == 2) {
            const uint2 v = load8(w);
            bits = word_bits(v.x, nb, wi) + word_bits(v.y, nb, wi + 1);
        } else {
            bits = word_bits(__ldg(w), nb, wi);
        }
    }
    if (live && rk) ck = fm::load16(fm::occ_block(f, (int64_t)(kk >> 7)));
    if (live && rl) cl = fm::load16(fm::occ_block(f, (int64_t)(ll >> 7)));
#pragma unroll
    for (int o = 1; o < kHalf; o <<= 1) bits += __shfl_xor_sync(kFull, bits, o);
    const uint32_t other = __shfl_xor_sync(kFull, bits, kHalf);
    const uint32_t sk = of_l ? other : bits, sl = of_l ? bits : other;
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

// Host side: the checks and slab tables of a launch.

// rows whose 16-byte loads (load16) are aligned: the array's start, or
// every slab's
inline bool aligned16(const uint32_t* p) { return !((uintptr_t)p & 15); }

inline bool aligned16(const Slabs<uint32_t>& s) {
    for (const uint32_t* p : s.p)
        if (!aligned16(p)) return false;
    return true;
}

// Peer access from `device` (the current device) to `peer`'s memory,
// enabled once a pair (an enable already made elsewhere,
// cudaErrorPeerAccessAlreadyEnabled, counts as made); an error where the
// pair cannot reach each other.
inline cudaError_t enable_peer(int device, int peer) {
    static std::mutex lock;
    static std::set<std::pair<int, int>> done;
    std::lock_guard<std::mutex> hold(lock);
    if (done.count({device, peer})) return cudaSuccess;
    int can = 0;
    cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
    if (err != cudaSuccess) return err;
    if (!can) return cudaErrorPeerAccessUnsupported;
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();  // returned, not left for the next launch
        err = cudaSuccess;
    }
    if (err == cudaSuccess) done.insert({device, peer});
    return err;
}

// The slab table of an array from the caller's host array t of 3 * n
// int64: the slabs' device addresses, their first rows (ascending from
// 0) and their devices.  A slab on another device than `device` (the
// launch's, current) is read through peer access (enable_peer), never
// copied.  cudaErrorInvalidValue for n outside [1, kMaxSlabs], a null
// slab, or first rows that do not ascend from 0.
template <class T>
inline cudaError_t slab_table(const int64_t* t, int n, int device,
                              Slabs<T>* s) {
    if (n < 1 || n > kMaxSlabs || t[n] != 0) return cudaErrorInvalidValue;
    for (int i = 0; i < kMaxSlabs; ++i) {
        s->p[i] = i < n ? reinterpret_cast<const T*>((uintptr_t)t[i])
                        : nullptr;
        s->first[i] = i < n ? t[n + i] : INT64_MAX;
    }
    for (int i = 0; i < n; ++i) {
        if (!s->p[i] || (i && s->first[i] <= s->first[i - 1]))
            return cudaErrorInvalidValue;
        if (t[2 * n + i] != device) {
            const cudaError_t err = enable_peer(device, (int)t[2 * n + i]);
            if (err != cudaSuccess) return err;
        }
    }
    return cudaSuccess;
}

}  // namespace fm
