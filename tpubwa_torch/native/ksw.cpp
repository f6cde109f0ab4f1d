// Scalar banded affine-gap SW kernels — native fast path for the host
// pipeline (semantics are pinned 1:1 to tpubwa/ref/ksw.py, which is the
// bit-faithful reference of upstream ksw.c:ksw_extend2/ksw_global2/
// ksw_align2; fuzz-tested against it in tests/test_ksw_native.py).
//
// These run on the HOST: ksw_global produces the CIGAR for each final
// alignment (1-2 calls/read), ksw_extend/ksw_align back the oversize /
// non-scmat fallbacks and mate rescue.  The NumPy versions cost
// milliseconds per call; these cost microseconds.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#if defined(__AVX512F__) || defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

inline int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }
inline int32_t imin(int32_t a, int32_t b) { return a < b ? a : b; }

const int32_t MINUS_INF = -0x40000000;

void push_cigar(int32_t* cig, int32_t cap, int32_t* n, int32_t op,
                int32_t len) {
    if (*n > 0 && cig[(*n - 1) * 2] == op) {
        cig[(*n - 1) * 2 + 1] += len;
    } else if (*n < cap) {
        cig[*n * 2] = op;
        cig[*n * 2 + 1] = len;
        ++*n;
    }
}

#if defined(__AVX512F__)
// ---- vectorized global-DP forward pass (ksw.c:ksw_global2:~420).
// The row recurrence's two serial chains — h1 (previous column's H)
// and f (the running gap-open max) — both vectorize: h1 is just the
// H vector shifted one lane (the shifted eh_h storage already
// encodes it), and f is an exclusive prefix max in the biased space
// w_k = mm_k - oe_ins + k*e_ins, seeded with MINUS_INF + beg*e_ins
// so the scalar loop's decaying never-opened f (MINUS_INF minus
// (j-beg)*e_ins) is reproduced EXACTLY — every direction bit of the
// traceback matrix z is arithmetically identical to the scalar
// loop's.  Same lazy-F-free scheme as local_forward_simd; ~VL
// cells per cycle group instead of 1.

constexpr int GVL = 16;

inline __m512i gprefix_max_epi32(__m512i v, __m512i ninf) {
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 16 - 1));
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 16 - 2));
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 16 - 4));
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 16 - 8));
    return v;
}

// fills z (when want_cigar) and *score_out; caller guarantees
// qlen > 0, tlen > 0, e_ins > 0, e_del > 0 and band reach
// (tlen + w >= qlen: the last row's band touches column qlen, so the
// double-buffered H rows never need cells older than one row).
void global_forward_simd(int32_t qlen, const uint8_t* query,
                         int32_t tlen, const uint8_t* target,
                         int32_t m, const int32_t* mat, int32_t o_del,
                         int32_t e_del, int32_t o_ins, int32_t e_ins,
                         int32_t w, int32_t want_cigar, uint8_t* z,
                         int64_t n_col, int32_t* score_out) {
    const int32_t oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
    const int32_t NB = (qlen + GVL - 1) / GVL;
    const int32_t Q = NB * GVL;
    // per-symbol query profiles (row i loads prof[target[i]]
    // contiguously: the mat[...][query[j]] gather becomes one load)
    std::vector<int32_t> prof((size_t)m * Q, 0);
    for (int32_t c = 0; c < m; ++c)
        for (int32_t j = 0; j < qlen; ++j)
            prof[(size_t)c * Q + j] = mat[c * m + (int32_t)query[j]];
    // shifted-H double buffer: Hprev[j] = H(i-1, j-1); row i's reads
    // are covered by row i-1's writes (band moves <= 1 per row)
    std::vector<int32_t> Hb0(Q + GVL, MINUS_INF),
        Hb1(Q + GVL, MINUS_INF), Ebuf(Q + GVL, MINUS_INF);
    int32_t* Hprev = Hb0.data();
    int32_t* Hnext = Hb1.data();
    Hprev[0] = 0;
    for (int32_t j = 1; j <= imin(qlen, w); ++j)
        Hprev[j] = -(o_ins + e_ins * j);
    const __m512i ninf = _mm512_set1_epi32(MINUS_INF);
    const __m512i lane = _mm512_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7, 8,
                                           9, 10, 11, 12, 13, 14, 15);
    const __m512i vei = _mm512_set1_epi32(e_ins);
    const __m512i lane_ei = _mm512_mullo_epi32(lane, vei);
    const __m512i ved = _mm512_set1_epi32(e_del);
    const __m512i voed = _mm512_set1_epi32(oe_del);
    const __m512i voei = _mm512_set1_epi32(oe_ins);
    const __m512i v1 = _mm512_set1_epi32(1);
    const __m512i v2 = _mm512_set1_epi32(2);
    const __m512i v4 = _mm512_set1_epi32(4);
    const __m512i v32 = _mm512_set1_epi32(0x20);
    const __m512i idx15 = _mm512_set1_epi32(15);
    for (int32_t i = 0; i < tlen; ++i) {
        const int32_t beg = imax(i - w, 0);
        const int32_t end = imin(i + w + 1, qlen);
        const int32_t* pc = prof.data() + (size_t)target[i] * Q;
        uint8_t* zi = want_cigar ? z + (size_t)i * n_col : nullptr;
        Hnext[beg] = beg == 0 ? -(o_del + e_del * (i + 1)) : MINUS_INF;
        if (beg < end) {
            const int32_t b0 = beg / GVL, b1 = (end + GVL - 1) / GVL;
            // f carry in w-space: f_beg == MINUS_INF exactly, and the
            // never-opened decay MINUS_INF - (j-beg)*e_ins follows
            __m512i carry = _mm512_set1_epi32(MINUS_INF + beg * e_ins);
            __m512i jb = _mm512_set1_epi32(b0 * GVL * e_ins);
            const __m512i jbstep = _mm512_set1_epi32(GVL * e_ins);
            for (int32_t b = b0; b < b1; ++b) {
                const int32_t j0 = b * GVL;
                // band mask: beg <= j < end
                __mmask16 bm = 0xFFFFu;
                if (j0 < beg)
                    bm &= (__mmask16)(0xFFFFu << (beg - j0));
                if (j0 + GVL > end)
                    bm &= (__mmask16)(0xFFFFu >> (j0 + GVL - end));
                __m512i diag = _mm512_loadu_si512(
                    (const void*)(Hprev + j0));
                __m512i pv = _mm512_loadu_si512((const void*)(pc + j0));
                __m512i mm = _mm512_add_epi32(diag, pv);
                __m512i E = _mm512_loadu_si512(
                    (const void*)(Ebuf.data() + j0));
                // d = mm >= e ? 0 : 1
                __mmask16 lt01 = _mm512_cmplt_epi32_mask(mm, E);
                __m512i he = _mm512_max_epi32(mm, E);
                // f via exclusive prefix max in the biased space
                // w_k = mm_k - oe_ins + (k+1)*e_ins: an open at
                // column k starts decaying at column k+1, so the
                // bias carries the +1 (same as local_forward's
                // vbias0)
                __m512i wv = _mm512_mask_mov_epi32(
                    ninf, bm,
                    _mm512_add_epi32(
                        _mm512_sub_epi32(mm, voei),
                        _mm512_add_epi32(_mm512_add_epi32(lane_ei,
                                                          vei), jb)));
                __m512i p = gprefix_max_epi32(wv, ninf);
                __m512i pex = _mm512_alignr_epi32(p, ninf, 15);
                __m512i u = _mm512_max_epi32(carry, pex);
                __m512i f = _mm512_sub_epi32(
                    u, _mm512_add_epi32(lane_ei, jb));
                // d = he >= f ? d : 2 ; h = max(he, f)
                __mmask16 ltf = _mm512_cmplt_epi32_mask(he, f);
                __m512i h = _mm512_max_epi32(he, f);
                // E' = max(e - e_del, mm - oe_del); bit2 iff e-ed wins
                __m512i ed = _mm512_sub_epi32(E, ved);
                __m512i td = _mm512_sub_epi32(mm, voed);
                __mmask16 b2 = _mm512_cmpgt_epi32_mask(ed, td);
                _mm512_mask_storeu_epi32(
                    (void*)(Ebuf.data() + j0), bm,
                    _mm512_max_epi32(ed, td));
                // bit4 iff (f - e_ins) > (mm - oe_ins)
                __mmask16 b4 = _mm512_cmpgt_epi32_mask(
                    _mm512_sub_epi32(f, vei),
                    _mm512_sub_epi32(mm, voei));
                // shifted H store: Hnext[j + 1] = h_j
                _mm512_mask_storeu_epi32((void*)(Hnext + j0 + 1), bm,
                                         h);
                if (want_cigar) {
                    __m512i d = _mm512_maskz_mov_epi32(lt01, v1);
                    d = _mm512_mask_mov_epi32(d, ltf, v2);
                    d = _mm512_mask_or_epi32(d, b2, d, v4);
                    d = _mm512_mask_or_epi32(d, b4, d, v32);
                    _mm512_mask_cvtepi32_storeu_epi8(
                        (void*)(zi + (int64_t)j0 - beg), bm, d);
                }
                carry = _mm512_max_epi32(
                    carry, _mm512_permutexvar_epi32(idx15, p));
                jb = _mm512_add_epi32(jb, jbstep);
            }
        }
        Ebuf[end] = MINUS_INF;
        int32_t* t = Hprev; Hprev = Hnext; Hnext = t;
    }
    *score_out = Hprev[qlen];
}
#elif defined(__AVX2__)
// ---- AVX2 flavor of the vectorized global-DP forward pass: same
// biased-prefix-F formulation as the AVX-512 version above (see that
// comment block), 8 lanes, blendv masks instead of mask registers,
// and the traceback bytes staged through a stack buffer (AVX2 has no
// vpmovdb).  Exactness argument identical.

constexpr int GVL = 8;

inline __m256i g2_shiftl(__m256i v, int k, __m256i fill) {
    alignas(32) int32_t tmp[16];
    _mm256_store_si256((__m256i*)tmp, fill);
    _mm256_store_si256((__m256i*)(tmp + 8), v);
    return _mm256_loadu_si256((const __m256i*)(tmp + 8 - k));
}

inline __m256i g2_prefix_max(__m256i v, __m256i ninf) {
    v = _mm256_max_epi32(v, g2_shiftl(v, 1, ninf));
    v = _mm256_max_epi32(v, g2_shiftl(v, 2, ninf));
    v = _mm256_max_epi32(v, g2_shiftl(v, 4, ninf));
    return v;
}

void global_forward_simd(int32_t qlen, const uint8_t* query,
                         int32_t tlen, const uint8_t* target,
                         int32_t m, const int32_t* mat, int32_t o_del,
                         int32_t e_del, int32_t o_ins, int32_t e_ins,
                         int32_t w, int32_t want_cigar, uint8_t* z,
                         int64_t n_col, int32_t* score_out) {
    const int32_t oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
    const int32_t NB = (qlen + GVL - 1) / GVL;
    const int32_t Q = NB * GVL;
    std::vector<int32_t> prof((size_t)m * Q, 0);
    for (int32_t c = 0; c < m; ++c)
        for (int32_t j = 0; j < qlen; ++j)
            prof[(size_t)c * Q + j] = mat[c * m + (int32_t)query[j]];
    std::vector<int32_t> Hb0(Q + GVL, MINUS_INF),
        Hb1(Q + GVL, MINUS_INF), Ebuf(Q + GVL, MINUS_INF);
    int32_t* Hprev = Hb0.data();
    int32_t* Hnext = Hb1.data();
    Hprev[0] = 0;
    for (int32_t j = 1; j <= imin(qlen, w); ++j)
        Hprev[j] = -(o_ins + e_ins * j);
    const __m256i ninf = _mm256_set1_epi32(MINUS_INF);
    const __m256i lane = _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7);
    const __m256i vei = _mm256_set1_epi32(e_ins);
    const __m256i lane_ei = _mm256_mullo_epi32(lane, vei);
    const __m256i ved = _mm256_set1_epi32(e_del);
    const __m256i voed = _mm256_set1_epi32(oe_del);
    const __m256i voei = _mm256_set1_epi32(oe_ins);
    for (int32_t i = 0; i < tlen; ++i) {
        const int32_t beg = imax(i - w, 0);
        const int32_t end = imin(i + w + 1, qlen);
        const int32_t* pc = prof.data() + (size_t)target[i] * Q;
        uint8_t* zi = want_cigar ? z + (size_t)i * n_col : nullptr;
        Hnext[beg] = beg == 0 ? -(o_del + e_del * (i + 1)) : MINUS_INF;
        if (beg < end) {
            const int32_t b0 = beg / GVL, b1 = (end + GVL - 1) / GVL;
            __m256i carry = _mm256_set1_epi32(MINUS_INF + beg * e_ins);
            __m256i jb = _mm256_set1_epi32(b0 * GVL * e_ins);
            const __m256i jbstep = _mm256_set1_epi32(GVL * e_ins);
            for (int32_t b = b0; b < b1; ++b) {
                const int32_t j0 = b * GVL;
                const __m256i jv = _mm256_add_epi32(
                    _mm256_set1_epi32(j0), lane);
                // band mask: beg <= j < end (all-ones where in band)
                __m256i bm = _mm256_andnot_si256(
                    _mm256_cmpgt_epi32(_mm256_set1_epi32(beg), jv),
                    _mm256_cmpgt_epi32(_mm256_set1_epi32(end), jv));
                __m256i diag = _mm256_loadu_si256(
                    (const __m256i*)(Hprev + j0));
                __m256i pv = _mm256_loadu_si256(
                    (const __m256i*)(pc + j0));
                __m256i mm = _mm256_add_epi32(diag, pv);
                __m256i E = _mm256_loadu_si256(
                    (const __m256i*)(Ebuf.data() + j0));
                __m256i lt01 = _mm256_cmpgt_epi32(E, mm);  // mm < e
                __m256i he = _mm256_max_epi32(mm, E);
                __m256i wraw = _mm256_add_epi32(
                    _mm256_sub_epi32(mm, voei),
                    _mm256_add_epi32(_mm256_add_epi32(lane_ei, vei),
                                     jb));
                __m256i wv = _mm256_blendv_epi8(ninf, wraw, bm);
                __m256i p = g2_prefix_max(wv, ninf);
                __m256i pex = g2_shiftl(p, 1, ninf);
                __m256i u = _mm256_max_epi32(carry, pex);
                __m256i f = _mm256_sub_epi32(
                    u, _mm256_add_epi32(lane_ei, jb));
                __m256i ltf = _mm256_cmpgt_epi32(f, he);   // he < f
                __m256i h = _mm256_max_epi32(he, f);
                __m256i ed = _mm256_sub_epi32(E, ved);
                __m256i td = _mm256_sub_epi32(mm, voed);
                __m256i b2 = _mm256_cmpgt_epi32(ed, td);
                _mm256_maskstore_epi32(Ebuf.data() + j0, bm,
                                       _mm256_max_epi32(ed, td));
                __m256i b4 = _mm256_cmpgt_epi32(
                    _mm256_sub_epi32(f, vei),
                    _mm256_sub_epi32(mm, voei));
                _mm256_maskstore_epi32(Hnext + j0 + 1, bm, h);
                if (want_cigar) {
                    // d = (mm<e ? 1 : 0); he<f -> 2; |4 if b2; |32 b4
                    __m256i d = _mm256_and_si256(
                        lt01, _mm256_set1_epi32(1));
                    d = _mm256_blendv_epi8(d, _mm256_set1_epi32(2),
                                           ltf);
                    d = _mm256_or_si256(d, _mm256_and_si256(
                        b2, _mm256_set1_epi32(4)));
                    d = _mm256_or_si256(d, _mm256_and_si256(
                        b4, _mm256_set1_epi32(0x20)));
                    alignas(32) int32_t dd[8];
                    _mm256_store_si256((__m256i*)dd, d);
                    const int32_t lo = imax(beg, j0);
                    const int32_t hi = imin(end, j0 + GVL);
                    for (int32_t j = lo; j < hi; ++j)
                        zi[j - beg] = (uint8_t)dd[j - j0];
                }
                // carry = max(carry, lane-7 broadcast of p)
                __m256i hi128 = _mm256_permute2x128_si256(p, p, 0x11);
                carry = _mm256_max_epi32(
                    carry, _mm256_shuffle_epi32(hi128, 0xFF));
                jb = _mm256_add_epi32(jb, jbstep);
            }
        }
        Ebuf[end] = MINUS_INF;
        int32_t* t = Hprev; Hprev = Hnext; Hnext = t;
    }
    *score_out = Hprev[qlen];
}
#endif  // __AVX512F__ / __AVX2__

}  // namespace

extern "C" {

// returns 0 on success; -1 if the cigar buffer is too small
int tpubwa_ksw_global(int32_t qlen, const uint8_t* query, int32_t tlen,
                      const uint8_t* target, int32_t m,
                      const int32_t* mat, int32_t o_del, int32_t e_del,
                      int32_t o_ins, int32_t e_ins, int32_t w,
                      int32_t want_cigar, int32_t* score_out,
                      int32_t* cigar_out, int32_t cigar_cap,
                      int32_t* n_cigar_out) {
    int32_t n_cig = 0;
    if (qlen == 0 || tlen == 0) {
        int32_t score = 0;
        if (tlen) {
            push_cigar(cigar_out, cigar_cap, &n_cig, 2, tlen);
            score = -(o_del + e_del * tlen);
        }
        if (qlen) {
            push_cigar(cigar_out, cigar_cap, &n_cig, 1, qlen);
            score = -(o_ins + e_ins * qlen);
        }
        *score_out = score;
        *n_cigar_out = n_cig;
        return 0;
    }
    const int32_t oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
    const int64_t n_col = imin(qlen, 2 * w + 1);
    std::vector<uint8_t> z;
    if (want_cigar) z.resize((size_t)tlen * n_col);
    bool done = false;
#if defined(__AVX512F__) || defined(__AVX2__)
    // TPUBWA_KSW_SCALAR=1 forces the scalar path (A/B + fuzz harness)
    static const bool g_force_scalar = [] {
        const char* e = getenv("TPUBWA_KSW_SCALAR");
        return e && *e && *e != '0';
    }();
    // band-reach condition (tlen + w >= qlen): the SIMD pass
    // double-buffers H rows, so the final score cell must be written
    // by the LAST row's band (always true for bwa_gen_cigar2's band)
    if (!g_force_scalar && e_ins > 0 && e_del > 0 && w >= 0
            && tlen + w >= qlen && qlen >= GVL) {
        global_forward_simd(qlen, query, tlen, target, m, mat, o_del,
                            e_del, o_ins, e_ins, w, want_cigar,
                            z.data(), n_col, score_out);
        done = true;
    }
#endif
    if (!done) {
        std::vector<int32_t> eh_h(qlen + 1, MINUS_INF),
            eh_e(qlen + 1, MINUS_INF);
        eh_h[0] = 0;
        for (int32_t j = 1; j <= imin(qlen, w); ++j)
            eh_h[j] = -(o_ins + e_ins * j);
        for (int32_t i = 0; i < tlen; ++i) {
            int32_t f = MINUS_INF;
            const int32_t beg = imax(i - w, 0);
            const int32_t end = imin(i + w + 1, qlen);
            int32_t h1 = beg == 0 ? -(o_del + e_del * (i + 1))
                                  : MINUS_INF;
            const int32_t* q = mat + (int32_t)target[i] * m;
            uint8_t* zi = want_cigar ? z.data() + (size_t)i * n_col
                                     : nullptr;
            for (int32_t j = beg; j < end; ++j) {
                int32_t mm = eh_h[j];
                int32_t e = eh_e[j];
                eh_h[j] = h1;
                mm += q[query[j]];
                uint8_t d = mm >= e ? 0 : 1;
                int32_t h = mm >= e ? mm : e;
                d = h >= f ? d : 2;
                h = h >= f ? h : f;
                h1 = h;
                int32_t t = mm - oe_del;
                e -= e_del;
                if (e > t) d |= 1 << 2; else e = t;
                eh_e[j] = e;
                t = mm - oe_ins;
                f -= e_ins;
                if (f > t) d |= 2 << 4; else f = t;
                if (want_cigar) zi[j - beg] = d;
            }
            eh_h[end] = h1;
            eh_e[end] = MINUS_INF;
        }
        *score_out = eh_h[qlen];
    }
    if (want_cigar) {
        // traceback (reversed run-length pushes, flipped at the end)
        std::vector<int32_t> rev((size_t)(qlen + tlen + 2) * 2);
        int32_t nr = 0;
        int32_t which = 0, i = tlen - 1, k = imin(i + w + 1, qlen) - 1;
        while (i >= 0 && k >= 0) {
            const uint8_t d = z[(size_t)i * n_col + (k - imax(i - w, 0))];
            which = (d >> (which << 1)) & 3;
            if (which == 0) {
                push_cigar(rev.data(), qlen + tlen + 2, &nr, 0, 1);
                --i; --k;
            } else if (which == 1) {
                push_cigar(rev.data(), qlen + tlen + 2, &nr, 2, 1);
                --i;
            } else {
                push_cigar(rev.data(), qlen + tlen + 2, &nr, 1, 1);
                --k;
            }
        }
        if (i >= 0) push_cigar(rev.data(), qlen + tlen + 2, &nr, 2, i + 1);
        if (k >= 0) push_cigar(rev.data(), qlen + tlen + 2, &nr, 1, k + 1);
        if (nr > cigar_cap) return -1;
        for (int32_t r = 0; r < nr; ++r) {
            cigar_out[r * 2] = rev[(nr - 1 - r) * 2];
            cigar_out[r * 2 + 1] = rev[(nr - 1 - r) * 2 + 1];
        }
        n_cig = nr;
    }
    *n_cigar_out = n_cig;
    return 0;
}

// out6 = {score, qle, tle, gtle, gscore, max_off}
void tpubwa_ksw_extend(int32_t qlen, const uint8_t* query, int32_t tlen,
                       const uint8_t* target, int32_t m,
                       const int32_t* mat, int32_t o_del, int32_t e_del,
                       int32_t o_ins, int32_t e_ins, int32_t w,
                       int32_t end_bonus, int32_t zdrop, int32_t h0,
                       int32_t* out6) {
    const int32_t oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
    std::vector<int32_t> eh_h(qlen + 2, 0), eh_e(qlen + 2, 0);
    eh_h[0] = h0;
    if (qlen >= 1) {
        eh_h[1] = h0 > oe_ins ? h0 - oe_ins : 0;
        for (int32_t j = 2; j <= qlen && eh_h[j - 1] > e_ins; ++j)
            eh_h[j] = eh_h[j - 1] - e_ins;
    }
    int32_t mmax = 0;
    for (int32_t i = 0; i < m * m; ++i) mmax = imax(mmax, mat[i]);
    int32_t max_ins = (int32_t)(((double)qlen * mmax + end_bonus - o_ins)
                                / e_ins + 1.0);
    w = imin(w, imax(max_ins, 1));
    int32_t max_del = (int32_t)(((double)qlen * mmax + end_bonus - o_del)
                                / e_del + 1.0);
    w = imin(w, imax(max_del, 1));

    int32_t best = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1,
            max_off = 0, beg = 0, end = qlen;
    for (int32_t i = 0; i < tlen; ++i) {
        beg = imax(beg, i - w);
        end = imin(imin(end, i + w + 1), qlen);
        int32_t h1;
        if (beg == 0) {
            h1 = h0 - (o_del + e_del * (i + 1));
            if (h1 < 0) h1 = 0;
        } else {
            h1 = 0;
        }
        if (beg >= end) {
            eh_h[end] = h1;
            eh_e[end] = 0;
            if (end == qlen && h1 >= gscore) { max_ie = i; gscore = h1; }
            break;
        }
        const int32_t* q = mat + (int32_t)target[i] * m;
        int32_t f = 0, mrow = 0, mj = -1;
        for (int32_t j = beg; j < end; ++j) {
            // M = H(i-1,j-1) + score, 0 if H(i-1,j-1) == 0
            int32_t Hd = eh_h[j];
            int32_t M = Hd ? Hd + q[query[j]] : 0;
            int32_t e = eh_e[j];
            int32_t h = imax(M, e);
            h = imax(h, f);       // f = F(i, j)
            eh_h[j] = h1;         // H(i-1, j) for the next row's diag
            h1 = h;
            if (h >= mrow) { mrow = h; mj = j; }
            int32_t t = imax(M - oe_del, 0);
            e = imax(e - e_del, t);
            eh_e[j] = e;
            t = imax(M - oe_ins, 0);
            f = imax(f - e_ins, t);
        }
        eh_h[end] = h1;
        eh_e[end] = 0;
        if (end == qlen && h1 >= gscore) { max_ie = i; gscore = h1; }
        if (mrow == 0) break;
        if (mrow > best) {
            best = mrow; max_i = i; max_j = mj;
            max_off = imax(max_off, mj > i ? mj - i : i - mj);
        } else if (zdrop > 0) {
            if (i - max_i > mj - max_j) {
                if (best - mrow - ((i - max_i) - (mj - max_j)) * e_del
                        > zdrop)
                    break;
            } else {
                if (best - mrow - ((mj - max_j) - (i - max_i)) * e_ins
                        > zdrop)
                    break;
            }
        }
        // adaptive band trim on the shifted arrays
        int32_t nb = end;
        for (int32_t j = beg; j < end; ++j)
            if (eh_h[j] != 0 || eh_e[j] != 0) { nb = j; break; }
        beg = nb;
        int32_t j = end;
        while (j >= beg && eh_h[j] == 0 && eh_e[j] == 0) --j;
        end = imin(j + 2, qlen);
    }
    out6[0] = best; out6[1] = max_j + 1; out6[2] = max_i + 1;
    out6[3] = max_ie + 1; out6[4] = gscore; out6[5] = max_off;
}

namespace {

// ---- vectorized local SW forward pass ---------------------------------
// Bit-identical to the scalar loop below: all arithmetic stays int32
// (no 8/16-bit saturation shortcuts), and the row's F chain
//   f(0) = 0;  f(j+1) = max(f(j) - e_ins, he(j) - oe_ins)
// is rewritten as a biased prefix max (the same algebra as the Pallas
// extension kernel's F-scan, device/extend_pallas.py:_prefix_max):
//   v(j) = he(j) - oe_ins + (j+1)*e_ins
//   u(j) = max(0, max_{k<j} v(k));   f(j) = u(j) - j*e_ins
// u(0)=0 reproduces the f(j) >= -j*e_ins decay floor exactly.
// The mate-rescue path (bwamem_pair.c:mem_matesw:~60 upstream) calls
// this twice per ksw_align; on repeat-realistic corpora it was ~85% of
// the emit phase (round-4 attribution), hence the SIMD port.  Upstream
// ksw.c vectorizes with SSE2 saturating u8/u16 lanes; this version is
// structurally different (exact i32 lanes, prefix-max F) on purpose.
constexpr int32_t PROF_PAD = -(1 << 28);  // tail lanes: he clamps to 0

#if defined(__AVX512F__)
constexpr int VLANES = 16;

inline __m512i prefix_max_epi32(__m512i v, __m512i ninf) {
    // inclusive prefix max over 16 lanes (log-shift, lane 0 lowest)
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 16 - 1));
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 16 - 2));
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 16 - 4));
    v = _mm512_max_epi32(v, _mm512_alignr_epi32(v, ninf, 16 - 8));
    return v;
}

void local_forward_simd(int32_t qlen, const uint8_t* query, int32_t tlen,
                        const uint8_t* target, int32_t m,
                        const int32_t* mat, int32_t o_del, int32_t e_del,
                        int32_t o_ins, int32_t e_ins, int32_t* best_out,
                        int32_t* te_out, int32_t* qe_out,
                        int32_t* col_max) {
    const int32_t oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
    const int32_t NB = (qlen + VLANES - 1) / VLANES;
    const int32_t Q = NB * VLANES;
    // per-symbol query profiles, tail-padded so tail he == 0
    std::vector<int32_t> prof((size_t)m * Q, PROF_PAD);
    for (int32_t c = 0; c < m; ++c)
        for (int32_t j = 0; j < qlen; ++j)
            prof[(size_t)c * Q + j] = mat[c * m + (int32_t)query[j]];
    // H(i-1, j-1) reads Hprev[j]: slot 0 stays 0 (the H(i,-1)=0
    // column); rows double-buffer instead of copying
    std::vector<int32_t> Hb0(Q + 1, 0), Hb1(Q + 1, 0), Ebuf(Q, 0);
    int32_t* Hprev = Hb0.data();
    int32_t* Hnext = Hb1.data();
    // h values in the last block past qlen are masked to 0 in-register
    // (the biased-prefix f can leak positive into tail lanes)
    const __mmask16 tailmask =
        (__mmask16)((qlen % VLANES) ? ((1u << (qlen % VLANES)) - 1u)
                                    : 0xFFFFu);
    const __m512i zero = _mm512_setzero_si512();
    const __m512i ninf = _mm512_set1_epi32(MINUS_INF);
    const __m512i lane = _mm512_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7, 8, 9,
                                           10, 11, 12, 13, 14, 15);
    const __m512i vei = _mm512_set1_epi32(e_ins);
    const __m512i lane_ei = _mm512_mullo_epi32(lane, vei);
    // v-bias per lane: -oe_ins + (lane+1)*e_ins (block base added below)
    const __m512i vbias0 = _mm512_add_epi32(
        _mm512_set1_epi32(e_ins - oe_ins), lane_ei);
    const __m512i ved = _mm512_set1_epi32(e_del);
    const __m512i voed = _mm512_set1_epi32(oe_del);
    const __m512i idx15 = _mm512_set1_epi32(15);
    int32_t best = 0, te = -1, qe = -1;
    for (int32_t i = 0; i < tlen; ++i) {
        const int32_t* pc = prof.data() + (size_t)target[i] * Q;
        __m512i carry = zero;              // u-space running max (u0=0)
        __m512i cmv = zero;
        __m512i jb = zero;                 // j0 * e_ins, accumulated
        const __m512i jbstep = _mm512_set1_epi32(VLANES * e_ins);
        for (int32_t b = 0; b < NB; ++b) {
            const int32_t j0 = b * VLANES;
            __m512i diag = _mm512_loadu_si512((const void*)(Hprev + j0));
            __m512i pv = _mm512_loadu_si512((const void*)(pc + j0));
            __m512i M = _mm512_add_epi32(diag, pv);
            __m512i E = _mm512_loadu_si512(
                (const void*)(Ebuf.data() + j0));
            __m512i he = _mm512_max_epi32(_mm512_max_epi32(M, E), zero);
            __m512i v = _mm512_add_epi32(he,
                                         _mm512_add_epi32(vbias0, jb));
            __m512i p = prefix_max_epi32(v, ninf);
            // exclusive prefix (shift left one lane, -inf fill)
            __m512i pex = _mm512_alignr_epi32(p, ninf, 15);
            __m512i u = _mm512_max_epi32(carry, pex);
            __m512i f = _mm512_sub_epi32(
                u, _mm512_add_epi32(lane_ei, jb));
            __m512i h = _mm512_max_epi32(he, f);
            if (b == NB - 1)               // mask tail lanes to 0
                h = _mm512_maskz_mov_epi32(tailmask, h);
            __m512i En = _mm512_max_epi32(
                _mm512_max_epi32(_mm512_sub_epi32(E, ved),
                                 _mm512_sub_epi32(h, voed)), zero);
            _mm512_storeu_si512((void*)(Ebuf.data() + j0), En);
            _mm512_storeu_si512((void*)(Hnext + 1 + j0), h);
            cmv = _mm512_max_epi32(cmv, h);
            // carry_u for the next block: max over ALL v so far
            carry = _mm512_max_epi32(
                carry, _mm512_permutexvar_epi32(idx15, p));
            jb = _mm512_add_epi32(jb, jbstep);
        }
        const int32_t cm = _mm512_reduce_max_epi32(cmv);
        col_max[i] = cm;
        if (cm > best) {
            // first column attaining cm (scalar semantics: h > cm)
            int32_t cj = -1;
            const __m512i cmb = _mm512_set1_epi32(cm);
            for (int32_t b = 0; b < NB && cj < 0; ++b) {
                __m512i h = _mm512_loadu_si512(
                    (const void*)(Hnext + 1 + b * VLANES));
                __mmask16 eq = _mm512_cmpeq_epi32_mask(h, cmb);
                if (eq) cj = b * VLANES + __builtin_ctz((uint32_t)eq);
            }
            best = cm; te = i; qe = cj;
        }
        int32_t* t = Hprev; Hprev = Hnext; Hnext = t;
    }
    *best_out = best; *te_out = te; *qe_out = qe;
}

#elif defined(__AVX2__)
constexpr int VLANES = 8;

inline __m256i shiftl_lanes(__m256i v, int k, __m256i fill) {
    // shift v left by k 32-bit lanes (lane 0 lowest), fill with `fill`
    alignas(32) int32_t tmp[16];
    _mm256_store_si256((__m256i*)tmp, fill);
    _mm256_store_si256((__m256i*)(tmp + 8), v);
    return _mm256_loadu_si256((const __m256i*)(tmp + 8 - k));
}

inline __m256i prefix_max_epi32(__m256i v, __m256i ninf) {
    v = _mm256_max_epi32(v, shiftl_lanes(v, 1, ninf));
    v = _mm256_max_epi32(v, shiftl_lanes(v, 2, ninf));
    v = _mm256_max_epi32(v, shiftl_lanes(v, 4, ninf));
    return v;
}

void local_forward_simd(int32_t qlen, const uint8_t* query, int32_t tlen,
                        const uint8_t* target, int32_t m,
                        const int32_t* mat, int32_t o_del, int32_t e_del,
                        int32_t o_ins, int32_t e_ins, int32_t* best_out,
                        int32_t* te_out, int32_t* qe_out,
                        int32_t* col_max) {
    const int32_t oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
    const int32_t NB = (qlen + VLANES - 1) / VLANES;
    const int32_t Q = NB * VLANES;
    std::vector<int32_t> prof((size_t)m * Q, PROF_PAD);
    for (int32_t c = 0; c < m; ++c)
        for (int32_t j = 0; j < qlen; ++j)
            prof[(size_t)c * Q + j] = mat[c * m + (int32_t)query[j]];
    std::vector<int32_t> Hb0(Q + 1, 0), Hb1(Q + 1, 0), Ebuf(Q, 0);
    int32_t* Hprev = Hb0.data();
    int32_t* Hnext = Hb1.data();
    const __m256i zero = _mm256_setzero_si256();
    const __m256i ninf = _mm256_set1_epi32(MINUS_INF);
    const __m256i lane = _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7);
    const __m256i vei = _mm256_set1_epi32(e_ins);
    const __m256i lane_ei = _mm256_mullo_epi32(lane, vei);
    const __m256i vbias0 = _mm256_add_epi32(
        _mm256_set1_epi32(e_ins - oe_ins), lane_ei);
    const __m256i ved = _mm256_set1_epi32(e_del);
    const __m256i voed = _mm256_set1_epi32(oe_del);
    // tail lanes of the last block mask h to 0 (biased-prefix f leak)
    const int32_t tail = qlen % VLANES;
    alignas(32) int32_t tm[8];
    for (int t = 0; t < 8; ++t)
        tm[t] = (tail == 0 || t < tail) ? -1 : 0;
    const __m256i tailmask = _mm256_load_si256((const __m256i*)tm);
    int32_t best = 0, te = -1, qe = -1;
    for (int32_t i = 0; i < tlen; ++i) {
        const int32_t* pc = prof.data() + (size_t)target[i] * Q;
        __m256i carry = zero;
        __m256i cmv = zero;
        __m256i jb = zero;
        const __m256i jbstep = _mm256_set1_epi32(VLANES * e_ins);
        for (int32_t b = 0; b < NB; ++b) {
            const int32_t j0 = b * VLANES;
            __m256i diag = _mm256_loadu_si256(
                (const __m256i*)(Hprev + j0));
            __m256i pv = _mm256_loadu_si256((const __m256i*)(pc + j0));
            __m256i M = _mm256_add_epi32(diag, pv);
            __m256i E = _mm256_loadu_si256(
                (const __m256i*)(Ebuf.data() + j0));
            __m256i he = _mm256_max_epi32(_mm256_max_epi32(M, E), zero);
            __m256i v = _mm256_add_epi32(he,
                                         _mm256_add_epi32(vbias0, jb));
            __m256i p = prefix_max_epi32(v, ninf);
            __m256i pex = shiftl_lanes(p, 1, ninf);
            __m256i u = _mm256_max_epi32(carry, pex);
            __m256i f = _mm256_sub_epi32(
                u, _mm256_add_epi32(lane_ei, jb));
            __m256i h = _mm256_max_epi32(he, f);
            if (b == NB - 1)
                h = _mm256_and_si256(h, tailmask);
            __m256i En = _mm256_max_epi32(
                _mm256_max_epi32(_mm256_sub_epi32(E, ved),
                                 _mm256_sub_epi32(h, voed)), zero);
            _mm256_storeu_si256((__m256i*)(Ebuf.data() + j0), En);
            _mm256_storeu_si256((__m256i*)(Hnext + 1 + j0), h);
            cmv = _mm256_max_epi32(cmv, h);
            // broadcast lane 7 of p (cross-lane): permute + shuffle
            __m256i hi = _mm256_permute2x128_si256(p, p, 0x11);
            carry = _mm256_max_epi32(
                carry, _mm256_shuffle_epi32(hi, 0xFF));
            jb = _mm256_add_epi32(jb, jbstep);
        }
        alignas(32) int32_t ct[8];
        _mm256_store_si256((__m256i*)ct, cmv);
        int32_t cm = 0;
        for (int t = 0; t < 8; ++t) cm = imax(cm, ct[t]);
        col_max[i] = cm;
        if (cm > best) {
            int32_t cj = -1;
            const int32_t* hr = Hnext + 1;
            for (int32_t j = 0; j < qlen && cj < 0; ++j)
                if (hr[j] == cm) cj = j;
            best = cm; te = i; qe = cj;
        }
        int32_t* t2 = Hprev; Hprev = Hnext; Hnext = t2;
    }
    *best_out = best; *te_out = te; *qe_out = qe;
}
#endif

// local SW forward pass; col_max must hold tlen entries.
void local_forward_scalar(int32_t qlen, const uint8_t* query,
                          int32_t tlen, const uint8_t* target, int32_t m,
                          const int32_t* mat, int32_t o_del,
                          int32_t e_del, int32_t o_ins, int32_t e_ins,
                          int32_t* best_out, int32_t* te_out,
                          int32_t* qe_out, int32_t* col_max) {
    const int32_t oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
    std::vector<int32_t> H(qlen + 1, 0), E(qlen, 0);
    int32_t best = 0, te = -1, qe = -1;
    for (int32_t i = 0; i < tlen; ++i) {
        const int32_t* q = mat + (int32_t)target[i] * m;
        int32_t f = 0, diag = 0, cm = 0, cj = -1;
        // H[j] holds H(i-1, j); diag tracks H(i-1, j-1)
        for (int32_t j = 0; j < qlen; ++j) {
            int32_t M = diag + q[query[j]];
            diag = H[j];
            int32_t he = imax(imax(M, E[j]), 0);
            // f here = F(i, j) computed from he (the scan closes over
            // he exactly; see ref/ksw.py:_local_forward)
            int32_t h = imax(he, f);
            E[j] = imax(imax(E[j] - e_del, h - oe_del), 0);
            H[j] = h;
            f = imax(f - e_ins, he - oe_ins);
            if (h > cm) { cm = h; cj = j; }
        }
        col_max[i] = cm;
        if (cm > best) { best = cm; te = i; qe = cj; }
    }
    *best_out = best; *te_out = te; *qe_out = qe;
}

inline void local_forward(int32_t qlen, const uint8_t* query,
                          int32_t tlen, const uint8_t* target, int32_t m,
                          const int32_t* mat, int32_t o_del,
                          int32_t e_del, int32_t o_ins, int32_t e_ins,
                          int32_t* best_out, int32_t* te_out,
                          int32_t* qe_out, int32_t* col_max) {
#if defined(__AVX512F__) || defined(__AVX2__)
    // TPUBWA_KSW_SCALAR=1 forces the scalar path (A/B + fuzz harness)
    static const bool force_scalar = [] {
        const char* e = getenv("TPUBWA_KSW_SCALAR");
        return e && *e && *e != '0';
    }();
    if (!force_scalar && qlen >= VLANES && e_ins > 0 && e_del > 0) {
        local_forward_simd(qlen, query, tlen, target, m, mat, o_del,
                           e_del, o_ins, e_ins, best_out, te_out,
                           qe_out, col_max);
        return;
    }
#endif
    local_forward_scalar(qlen, query, tlen, target, m, mat, o_del,
                         e_del, o_ins, e_ins, best_out, te_out, qe_out,
                         col_max);
}

}  // namespace

// out7 = {score, te, qe, score2, te2, tb, qb}
void tpubwa_ksw_align(int32_t qlen, const uint8_t* query, int32_t tlen,
                      const uint8_t* target, int32_t m,
                      const int32_t* mat, int32_t o_del, int32_t e_del,
                      int32_t o_ins, int32_t e_ins, int32_t minsc,
                      int32_t want_start, int32_t* out7) {
    std::vector<int32_t> col_max(tlen, 0);
    int32_t score, te, qe;
    local_forward(qlen, query, tlen, target, m, mat, o_del, e_del,
                  o_ins, e_ins, &score, &te, &qe, col_max.data());
    int32_t score2 = -1, te2 = -1;
    if (te >= 0) {
        const int32_t lo = te - qlen, hi = te + qlen;
        const int32_t floor2 = imax(minsc, 1);
        for (int32_t e = 0; e < tlen; ++e)
            if ((e < lo || e > hi) && col_max[e] >= floor2
                    && col_max[e] > score2) {
                score2 = col_max[e];
                te2 = e;
            }
    }
    out7[0] = score; out7[1] = te; out7[2] = qe;
    out7[3] = score2; out7[4] = te2; out7[5] = -1; out7[6] = -1;
    if (!want_start || score <= 0 || (minsc && score < minsc)) return;
    std::vector<uint8_t> rq(qe + 1), rt(te + 1);
    for (int32_t j = 0; j <= qe; ++j) rq[j] = query[qe - j];
    for (int32_t i = 0; i <= te; ++i) rt[i] = target[te - i];
    std::vector<int32_t> cm2(te + 1, 0);
    int32_t s2, rte, rqe;
    local_forward(qe + 1, rq.data(), te + 1, rt.data(), m, mat, o_del,
                  e_del, o_ins, e_ins, &s2, &rte, &rqe, cm2.data());
    out7[5] = te - rte;
    out7[6] = qe - rqe;
}

}  // extern "C"
