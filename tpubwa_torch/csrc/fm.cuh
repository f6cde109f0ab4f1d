// FM-index device functions (bwt.c:bwt_occ4 / bwt_invPsi / bwt_extend
// and the text-position marks of tpubwa's SA walk), one query a thread,
// for the kernels that walk the index: csrc/occ.cu now, the seeding
// kernels later.  The counterparts of the plain functions of
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
// life.  With TPUBWA_WARP_HOST defined (the host harness of
// csrc/warp_host.h) __popc and __ldg are their host equivalents.

#pragma once

#include <cstdint>

#ifdef TPUBWA_WARP_HOST
inline int __popc(unsigned x) { return __builtin_popcount(x); }
template <class T>
inline T __ldg(const T* p) { return *p; }
#endif

namespace fm {

constexpr int kRowWords = 12;   // occ row: 4 counts + 8 BWT words
constexpr int kMarkWords = 8;   // mark row: count + 4 bit words + 3 pad
constexpr int kSaIntv = 32;     // rank sampling of sa_sample

template <class Idx>
struct Index {
    const uint32_t* occ;  // [n_blocks, kRowWords]
    const Idx* L2;        // [5]: 0, #A, #A+#C, #A+#C+#G, seq_len
    Idx primary;          // conceptual row of the sentinel
    Idx seq_len;          // doubled text length
};

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
    return f.occ + (int64_t)(x >> 7) * kRowWords;
}

// stored BWT[x], x in [0, seq_len)
template <class Idx>
__device__ __forceinline__ int bwt_code(const Index<Idx>& f, Idx x) {
    const int within = (int)(x & 127);
    const uint32_t w = __ldg(occ_row(f, x) + 4 + (within >> 4));
    return (int)(w >> ((15 - (within & 15)) << 1)) & 3;
}

// occ(k, c) for all four bases; k a conceptual row in [-1, seq_len]
// (occ4's kk = k - (k >= primary), clamped into the stored rows)
template <class Idx>
__device__ __forceinline__ void occ4(const Index<Idx>& f, Idx k,
                                     Idx cnt[4]) {
    if (k < 0) {
        for (int c = 0; c < 4; ++c) cnt[c] = 0;
        return;
    }
    if (k == f.seq_len) {
        for (int c = 0; c < 4; ++c) cnt[c] = __ldg(f.L2 + c + 1) - __ldg(f.L2 + c);
        return;
    }
    Idx kk = k >= f.primary ? k - 1 : k;
    kk = kk < 0 ? 0 : kk > f.seq_len - 1 ? f.seq_len - 1 : kk;
    const uint32_t* row = occ_row(f, kk);
    const int nb = (int)(kk & 127) + 1;
    uint32_t n[4] = {0, 0, 0, 0};
    for (int i = 0; i < 8 && 16 * i < nb; ++i) {
        const uint32_t w = __ldg(row + 4 + i), m = cover(nb - 16 * i);
        for (int c = 0; c < 4; ++c) n[c] += __popc(match(w, c) & m);
    }
    for (int c = 0; c < 4; ++c) cnt[c] = (Idx)__ldg(row + c) + (Idx)n[c];
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

// bidirectional extension of ik = (x0, x1, size) by each base
// (bwt.c:bwt_extend): ok[c] = the interval of c prepended (IsBack) or
// appended, as (x0, x1, size) in tpubwa's order.  Two occ4 queries, at
// piv - 1 and piv - 1 + size.
template <class Idx, bool IsBack>
__device__ __forceinline__ void bwt_extend(const Index<Idx>& f,
                                           const Idx ik[3], Idx ok[4][3]) {
    const Idx piv = IsBack ? ik[0] : ik[1];
    const Idx oth = IsBack ? ik[1] : ik[0];
    const Idx sz = ik[2];
    Idx tk[4], tl[4];
    occ4(f, piv - 1, tk);
    occ4(f, piv - 1 + sz, tl);
    const Idx sent = piv <= f.primary && piv + sz - 1 >= f.primary;
    Idx acc = oth + sent;
    for (int c = 3; c >= 0; --c) {
        const Idx size = tl[c] - tk[c];
        const Idx npiv = __ldg(f.L2 + c) + 1 + tk[c];
        ok[c][IsBack ? 0 : 1] = npiv;
        ok[c][IsBack ? 1 : 0] = acc;
        ok[c][2] = size;
        acc += size;
    }
}

}  // namespace fm
