// FM-index device functions (bwt.c:bwt_occ4 / bwt_invPsi / bwt_extend /
// bwt_set_intv and the text-position marks of tpubwa's SA walk), one
// query a thread, for the kernels that walk the index: csrc/occ.cu and
// the seeding kernels of csrc/smem.cu (through csrc/smem.cuh).  The
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
// in the same 128-base block (bwa's bwt_2occ4).  With TPUBWA_WARP_HOST
// defined (the host harness of csrc/warp_host.h) __popc, __ldg and the
// 16-byte load are their host equivalents (the last checks its
// alignment), and a harness may set fm::read_rows to collect the occ row
// of every query.

#pragma once

#include <cstdint>

#ifdef TPUBWA_WARP_HOST
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
inline int __popc(unsigned x) { return __builtin_popcount(x); }
template <class T>
inline T __ldg(const T* p) { return *p; }
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

template <class Idx>
struct Index {
    const uint32_t* occ;  // [n_blocks, kRowWords]
    const Idx* L2;        // [5]: 0, #A, #A+#C, #A+#C+#G, seq_len
    Idx primary;          // conceptual row of the sentinel
    Idx seq_len;          // doubled text length
    // L2's values, which a kernel loads once (with_l2) and reads where
    // the base is a constant after unrolling, so that they stay in
    // registers; a base known only at run time reads L2
    Idx l2[5];
};

// f with L2's values loaded into f.l2: a kernel's first step
template <class Idx>
__device__ __forceinline__ Index<Idx> with_l2(Index<Idx> f) {
#pragma unroll
    for (int i = 0; i < 5; ++i) f.l2[i] = __ldg(f.L2 + i);
    return f;
}

// one bit (the low bit of the pair) per base of w equal to c
__device__ __forceinline__ uint32_t match(uint32_t w, int c) {
    const uint32_t x = ~(w ^ (uint32_t)c * 0x55555555u);
    return x & (x >> 1) & 0x55555555u;
}

// the pairs of the first cov bases of a word (cov in [1, 16])
__device__ __forceinline__ uint32_t cover(int cov) {
    return cov >= 16 ? 0xffffffffu : 0xffffffffu << (2 * (16 - cov));
}

// the occ row of stored BWT index x
template <class Idx>
__device__ __forceinline__ const uint32_t* occ_row(const Index<Idx>& f,
                                                   Idx x) {
#ifdef TPUBWA_WARP_HOST
    if (read_rows) read_rows->push_back((int64_t)(x >> 7));
#endif
    return f.occ + (int64_t)(x >> 7) * kRowWords;
}

// stored BWT[x], x in [0, seq_len)
template <class Idx>
__device__ __forceinline__ int bwt_code(const Index<Idx>& f, Idx x) {
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
template <class Idx>
__device__ __forceinline__ Row load_row(const Index<Idx>& f, Idx x) {
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
template <class Idx>
__device__ __forceinline__ bool occ4_kk(const Index<Idx>& f, Idx k, Idx* kk) {
    Idx x = k >= f.primary ? k - 1 : k;
    *kk = x < 0 ? 0 : x > f.seq_len - 1 ? f.seq_len - 1 : x;
    return k >= 0 && k != f.seq_len;
}

// occ4 where it reads no row (see occ4_kk)
template <class Idx>
__device__ __forceinline__ void occ4_edge(const Index<Idx>& f, Idx k,
                                          Idx cnt[4]) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
        cnt[c] = k < 0 ? (Idx)0 : f.l2[c + 1] - f.l2[c];
}

// occ(k, c) for all four bases; k a conceptual row in [-1, seq_len]
template <class Idx>
__device__ __forceinline__ void occ4(const Index<Idx>& f, Idx k,
                                     Idx cnt[4]) {
    Idx kk;
    if (!occ4_kk(f, k, &kk)) {
        occ4_edge(f, k, cnt);
        return;
    }
    row_occ4(load_row(f, kk), (int)(kk & 127) + 1, cnt);
}

// occ(k, c) for one base
template <class Idx>
__device__ __forceinline__ Idx occ1(const Index<Idx>& f, Idx k, int c) {
    Idx cnt[4];
    occ4(f, k, cnt);
    return cnt[c];
}

// LF mapping on conceptual rows k in [0, seq_len] (bwt.h:bwt_invPsi):
// x = k - (k > primary) equals occ4's kk except at k == primary (whose
// result is 0), so one row serves the BWT code and its count.  The
// words below x's base are read once each.
template <class Idx>
__device__ __forceinline__ Idx inv_psi(const Index<Idx>& f, Idx k) {
    if (k == f.primary) return 0;
    Idx x = k > f.primary ? k - 1 : k;
    x = x < 0 ? 0 : x > f.seq_len - 1 ? f.seq_len - 1 : x;
    const uint32_t* row = occ_row(f, x);
    const int within = (int)(x & 127), wi = within >> 4;
    const uint32_t w = __ldg(row + 4 + wi);
    const int c = (int)(w >> ((15 - (within & 15)) << 1)) & 3;
    uint32_t n = __popc(match(w, c) & cover((within & 15) + 1));
    for (int i = 0; i < wi; ++i) n += __popc(match(__ldg(row + 4 + i), c));
    return __ldg(f.L2 + c) + (Idx)__ldg(row + c) + (Idx)n;
}

// the mark row of conceptual rank k
template <class Idx>
__device__ __forceinline__ const uint32_t* mark_row(const uint32_t* marks,
                                                    Idx k) {
    return marks + (int64_t)(k >> 7) * kMarkWords;
}

// k's text-position mark
template <class Idx>
__device__ __forceinline__ bool mark_bit(const uint32_t* marks, Idx k) {
    const int within = (int)(k & 127);
    const uint32_t w = __ldg(mark_row(marks, k) + 1 + (within >> 5));
    return (w >> (31 - (within & 31))) & 1u;
}

// # of marked ranks before k (k itself marked): k's index in sa_marked
template <class Idx>
__device__ __forceinline__ int64_t mark_index(const uint32_t* marks, Idx k) {
    const uint32_t* row = mark_row(marks, k);
    const int within = (int)(k & 127), wi = within >> 5,
              bp = 31 - (within & 31);
    int64_t idx = __ldg(row);
    for (int i = 0; i < wi; ++i) idx += __popc(__ldg(row + 1 + i));
    // bits above bp in k's own word: marked ranks earlier in the word
    if (bp < 31) idx += __popc(__ldg(row + 1 + wi) >> (bp + 1));
    return idx;
}

// the interval of the one-base pattern c (bwt.h:bwt_set_intv): x0 from
// c's bucket, x1 from its complement's, size = the count of c
template <class Idx>
__device__ __forceinline__ void set_intv(const Index<Idx>& f, int c,
                                         Idx ik[3]) {
    ik[0] = __ldg(f.L2 + c) + 1;
    ik[1] = __ldg(f.L2 + 3 - c) + 1;
    ik[2] = __ldg(f.L2 + c + 1) - __ldg(f.L2 + c);
}

// bwt_extend's result from its two occ4 queries: tk = occ4(piv - 1),
// tl = occ4(piv - 1 + size)
template <class Idx, bool IsBack>
__device__ __forceinline__ void extend_counts(const Index<Idx>& f,
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
template <class Idx, bool IsBack>
__device__ __forceinline__ void bwt_extend(const Index<Idx>& f,
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

}  // namespace fm
