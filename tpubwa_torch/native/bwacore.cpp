// Native emit phase: regions -> SAM text for a whole batch
// (bwamem.c:mem_mark_primary_se/mem_approx_mapq_se/mem_reg2aln/
// mem_aln2sam/mem_reg2sam, bwamem_pair.c:mem_matesw/mem_pair/mem_sam_pe,
// bwamem_extra.c:mem_gen_alt, bwa.c:bwa_gen_cigar2).
//
// This is a 1:1 port of tpubwa/host/{regions,sam,pair}.py — the Python
// stays the reference; byte-equality of the emitted SAM is pinned by
// tests/test_native_emit.py.  The host here has ONE core, so the emit
// phase's Python interpreter time directly gates throughput; this port
// removes it (GIL released during the call).

#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>
#include <algorithm>

#include "ksw.cpp"   // tpubwa_ksw_global / tpubwa_ksw_align

namespace {

typedef int64_t i64;
typedef uint64_t u64;
typedef uint8_t u8;

// ---- emit-phase attribution counters ---------------------------------
// Cheap always-on per-stage walls + call counts for the emit phase
// (the round-3 verdict's "unattributed realistic-corpus penalty").
// Exposed via tpubwa_emit_stats(); profile_scale.py prints them.
struct EmitStats {
    std::atomic<i64> matesw_calls{0}, matesw_ns{0}, kswa_calls{0};
    std::atomic<i64> gen_alt_ns{0}, gen_alt_calls{0};
    std::atomic<i64> reg2aln_calls{0}, reg2aln_ns{0};
    std::atomic<i64> mempair_ns{0}, markpri_ns{0};
    std::atomic<i64> aln2sam_calls{0}, aln2sam_ns{0};
};
EmitStats g_es;

struct ScopedNs {
    std::atomic<i64>& acc;
    std::chrono::steady_clock::time_point t0;
    explicit ScopedNs(std::atomic<i64>& a)
        : acc(a), t0(std::chrono::steady_clock::now()) {}
    ~ScopedNs() {
        acc.fetch_add(std::chrono::duration_cast<
                          std::chrono::nanoseconds>(
                          std::chrono::steady_clock::now() - t0)
                          .count(),
                      std::memory_order_relaxed);
    }
};

inline i64 mx(i64 a, i64 b) { return a > b ? a : b; }
inline i64 mn(i64 a, i64 b) { return a < b ? a : b; }

// ---- option block (layout shared with host/native_emit.py) ----------
struct Opt {
    i64 a, b, o_del, e_del, o_ins, e_ins, w, T, flag, min_seed_len,
        max_matesw, max_XA_hits, max_XA_hits_alt, pen_unpaired,
        mapQ_coef_len;
    double mapQ_coef_fac, drop_ratio, XA_drop_ratio, mask_level;
    int32_t mat[25];
};
const i64 MEM_F_NOPAIRING = 0x4, MEM_F_ALL = 0x8, MEM_F_NO_MULTI = 0x10,
          MEM_F_NO_RESCUE = 0x20, MEM_F_SOFTCLIP = 0x200,
          MEM_F_PRIMARY5 = 0x800, MEM_F_KEEP_SUPP_MAPQ = 0x1000;

// ---- reference metadata ---------------------------------------------
struct Bnt {
    const u8* codes;        // unpacked forward codes [l_pac]
    i64 l_pac;
    int32_t n_anns;
    const i64* ann_off;
    const i64* ann_len;
    const u8* ann_alt;
    const char* name_blob;
    const i64* name_off;    // [n_anns + 1]

    std::string name(int rid) const {
        return std::string(name_blob + name_off[rid],
                           name_blob + name_off[rid + 1]);
    }
    void depos(i64 pos, i64* fpos, int* is_rev) const {
        *is_rev = pos >= l_pac;
        *fpos = *is_rev ? (l_pac << 1) - 1 - pos : pos;
    }
    int pos2rid(i64 pos) const {
        if (pos >= l_pac) return -1;
        int lo = 0, hi = n_anns - 1;
        while (lo <= hi) {
            int mid = (lo + hi) >> 1;
            if (ann_off[mid] <= pos && pos < ann_off[mid] + ann_len[mid])
                return mid;
            if (pos < ann_off[mid]) hi = mid - 1; else lo = mid + 1;
        }
        return -1;
    }
    // codes for doubled-coordinate interval [beg, end)
    std::vector<u8> get_seq(i64 beg, i64 end) const {
        std::vector<u8> out;
        if (end <= beg) return out;
        out.reserve(end - beg);
        if (beg >= l_pac) {
            for (i64 p = beg; p < end; ++p)
                out.push_back(3 - codes[(l_pac << 1) - 1 - p]);
        } else if (end <= l_pac) {
            out.assign(codes + beg, codes + end);
        } else {
            out.assign(codes + beg, codes + l_pac);
            for (i64 p = l_pac; p < end; ++p)
                out.push_back(3 - codes[(l_pac << 1) - 1 - p]);
        }
        return out;
    }
    // bns_fetch_seq clipping
    void fetch_bounds(i64 beg, i64 mid, i64 end, int* rid, i64* b,
                      i64* e) const {
        if (end < beg) std::swap(beg, end);
        i64 fm; int is_rev;
        depos(mid, &fm, &is_rev);
        *rid = pos2rid(fm);
        i64 lo, hi;
        if (is_rev) {
            lo = (l_pac << 1) - (ann_off[*rid] + ann_len[*rid]);
            hi = (l_pac << 1) - ann_off[*rid];
        } else {
            lo = ann_off[*rid];
            hi = ann_off[*rid] + ann_len[*rid];
        }
        *b = mx(beg, lo);
        *e = mn(end, hi);
    }
};

// ---- regions ---------------------------------------------------------
const int NF = 18;  // int fields per region row (order below)
struct Reg {
    i64 rb, re, qb, qe;
    i64 rid, score, truesc, sub, alt_sc, csub, sub_n, w, seedcov,
        secondary, secondary_all, seedlen0, n_comp, is_alt;
    double frac_rep;
    u64 hash;
};

u64 hash_64(u64 key) {
    key = key + ~(key << 32);
    key ^= key >> 22;
    key = key + ~(key << 13);
    key ^= key >> 8;
    key = key + (key << 3);
    key ^= key >> 15;
    key = key + ~(key << 27);
    key ^= key >> 31;
    return key;
}

void mark_primary_core(const Opt& o, std::vector<Reg>& regs, size_t n) {
    i64 tmp = mx(o.a + o.b, mx(o.o_del + o.e_del, o.o_ins + o.e_ins));
    std::vector<size_t> z{0};
    for (size_t i = 1; i < n; ++i) {
        bool placed = false;
        for (size_t j : z) {
            i64 b_max = mx(regs[j].qb, regs[i].qb);
            i64 e_min = mn(regs[j].qe, regs[i].qe);
            if (e_min > b_max) {
                i64 min_l = mn(regs[i].qe - regs[i].qb,
                               regs[j].qe - regs[j].qb);
                if ((double)(e_min - b_max) >= min_l * o.mask_level) {
                    if (regs[j].sub == 0) regs[j].sub = regs[i].score;
                    if (regs[j].score - regs[i].score <= tmp
                            && (regs[j].is_alt || !regs[i].is_alt)) {
                        regs[i].secondary = (i64)j;
                        placed = true;
                        break;
                    }
                }
            }
        }
        if (!placed) z.push_back(i);
    }
}

i64 mark_primary(const Opt& o, std::vector<Reg>& regs, i64 read_id) {
    ScopedNs _t(g_es.markpri_ns);
    size_t n = regs.size();
    if (n == 0) return 0;
    i64 n_pri = 0;
    for (size_t i = 0; i < n; ++i) {
        Reg& r = regs[i];
        r.sub = 0; r.alt_sc = 0;
        r.secondary = -1; r.secondary_all = -1;
        r.hash = hash_64((u64)(read_id + (i64)i));
        if (!r.is_alt) ++n_pri;
    }
    std::stable_sort(regs.begin(), regs.end(),
        [](const Reg& a, const Reg& b) {
            if (a.score != b.score) return a.score > b.score;
            if (a.is_alt != b.is_alt) return a.is_alt < b.is_alt;
            return a.hash < b.hash;
        });
    mark_primary_core(o, regs, n);
    for (size_t i = 0; i < n; ++i) {
        regs[i].secondary_all = (i64)i;
        if (!regs[i].is_alt && regs[i].secondary >= 0
                && regs[regs[i].secondary].is_alt)
            regs[i].alt_sc = regs[regs[i].secondary].score;
    }
    if (n_pri >= 0 && (size_t)n_pri < n) {
        if (n_pri > 0) {
            std::stable_sort(regs.begin(), regs.end(),
                [](const Reg& a, const Reg& b) {
                    if (a.is_alt != b.is_alt) return a.is_alt < b.is_alt;
                    if (a.score != b.score) return a.score > b.score;
                    return a.hash < b.hash;
                });
        }
        std::vector<i64> z(n);
        for (size_t i = 0; i < n; ++i) z[regs[i].secondary_all] = (i64)i;
        for (size_t i = 0; i < n; ++i) {
            if (regs[i].secondary >= 0) {
                regs[i].secondary_all = z[regs[i].secondary];
                if (regs[i].is_alt) regs[i].secondary = 0x7FFFFFFF;
            } else {
                regs[i].secondary_all = -1;
            }
        }
        if (n_pri > 0) {
            for (i64 i = 0; i < n_pri; ++i) {
                regs[i].sub = 0;
                regs[i].secondary = -1;
            }
            mark_primary_core(o, regs, (size_t)n_pri);
        }
    } else {
        for (size_t i = 0; i < n; ++i)
            regs[i].secondary_all = regs[i].secondary;
    }
    if (o.flag & MEM_F_PRIMARY5) {
        // mem_reorder_primary5 (-5): leftmost-on-query primary first
        i64 npri5 = 0;
        for (size_t k = 0; k < n; ++k)
            if (regs[k].secondary < 0 && !regs[k].is_alt
                    && regs[k].score >= o.T) ++npri5;
        if (npri5 > 1) {
            i64 left_st = INT64_MAX, left_k = -1;
            for (size_t k = 0; k < n; ++k) {
                const Reg& p = regs[k];
                if (p.secondary >= 0 || p.is_alt || p.score < o.T)
                    continue;
                if (p.qb < left_st) { left_st = p.qb; left_k = (i64)k; }
            }
            if (left_k > 0) {
                std::swap(regs[0], regs[(size_t)left_k]);
                for (size_t k = 1; k < n; ++k) {
                    Reg& p = regs[k];
                    if (p.secondary == 0) p.secondary = left_k;
                    else if (p.secondary == left_k) p.secondary = 0;
                    if (p.secondary_all == 0) p.secondary_all = left_k;
                    else if (p.secondary_all == left_k)
                        p.secondary_all = 0;
                }
            }
        }
    }
    return n_pri;
}

const double MEM_MAPQ_COEF = 30.0;

int approx_mapq(const Opt& o, const Reg& a) {
    i64 sub = a.sub ? a.sub : o.min_seed_len * o.a;
    sub = mx(sub, a.csub);
    if (sub >= a.score) return 0;
    i64 l = mx(a.qe - a.qb, a.re - a.rb);
    double identity =
        1.0 - (double)(l * o.a - a.score) / (double)(o.a + o.b) / (double)l;
    i64 mapq;
    if (a.score == 0) {
        mapq = 0;
    } else if (o.mapQ_coef_len > 0) {
        double tmp = (double)l < (double)o.mapQ_coef_len
                         ? 1.0 : o.mapQ_coef_fac / std::log((double)l);
        tmp *= identity * identity;
        mapq = (i64)(6.02 * (double)(a.score - sub) / (double)o.a * tmp
                     * tmp + 0.499);
    } else {
        mapq = (i64)(MEM_MAPQ_COEF * (1.0 - (double)sub / (double)a.score)
                     * std::log((double)a.seedcov) + 0.499);
        if (identity < 0.95)
            mapq = (i64)((double)mapq * identity * identity + 0.499);
    }
    if (a.sub_n > 0)
        mapq -= (i64)(4.343 * std::log((double)a.sub_n + 1) + 0.499);
    mapq = mn(mapq, 60);
    mapq = mx(mapq, (i64)0);
    mapq = (i64)((double)mapq * (1.0 - a.frac_rep) + 0.499);
    return (int)mapq;
}

// ---- CIGAR / MD ------------------------------------------------------
typedef std::vector<std::pair<int, int>> Cigar;
const char* OPS = "MIDSH";
const char* FWDB = "ACGTN";
const char* REVB = "TGCAN";

i64 infer_bw(i64 l1, i64 l2, i64 score, i64 a, i64 q, i64 r) {
    if (l1 == l2 && l1 * a - score < ((q + r - a) << 1)) return 0;
    i64 w = (i64)(((double)(mn(l1, l2) * a - score - q)) / (double)r + 2.0);
    return mx(w, l1 > l2 ? l1 - l2 : l2 - l1);
}

// bwa_gen_cigar2: query is a SLICE [qb, qe) of the read, rb/re doubled
void gen_cigar(const Opt& o, const Bnt& bnt, const u8* query, i64 l_query,
               i64 rb, i64 re, i64 w, i64* score_out, Cigar* cig,
               i64* NM, std::string* MD) {
    cig->clear();
    *MD = "";
    *NM = -1;
    *score_out = 0;
    if (l_query <= 0 || rb >= re || (rb < bnt.l_pac && re > bnt.l_pac))
        return;
    std::vector<u8> rseq = bnt.get_seq(rb, re);
    i64 rlen = (i64)rseq.size();
    std::vector<u8> q(query, query + l_query);
    if (rb >= bnt.l_pac) {  // reverse both for leftmost indels
        std::reverse(q.begin(), q.end());
        std::reverse(rseq.begin(), rseq.end());
    }
    if (l_query == re - rb && w == 0) {
        cig->push_back({0, (int)l_query});
        i64 sc = 0;
        for (i64 i = 0; i < l_query; ++i)
            sc += o.mat[rseq[i] * 5 + q[i]];
        *score_out = sc;
    } else {
        i64 max_ins = (i64)((((l_query + 1) >> 1) * (double)o.mat[0]
                             - o.o_ins) / (double)o.e_ins + 1.0);
        i64 max_del = (i64)((((l_query + 1) >> 1) * (double)o.mat[0]
                             - o.o_del) / (double)o.e_del + 1.0);
        i64 max_gap = mx(mx(max_ins, max_del), (i64)1);
        i64 ww = (max_gap + (rlen > l_query ? rlen - l_query
                                            : l_query - rlen) + 1) >> 1;
        ww = mn(ww, w);
        i64 min_w = (rlen > l_query ? rlen - l_query : l_query - rlen) + 3;
        ww = mx(ww, min_w);
        int32_t sc, ncig;
        std::vector<int32_t> cbuf(2 * (l_query + rlen + 2));
        int rc = tpubwa_ksw_global(
            (int32_t)l_query, q.data(), (int32_t)rlen, rseq.data(), 5,
            o.mat, (int32_t)o.o_del, (int32_t)o.e_del, (int32_t)o.o_ins,
            (int32_t)o.e_ins, (int32_t)ww, 1, &sc, cbuf.data(),
            (int32_t)(l_query + rlen + 2), &ncig);
        (void)rc;
        *score_out = sc;
        for (int32_t k = 0; k < ncig; ++k)
            cig->push_back({cbuf[2 * k], cbuf[2 * k + 1]});
    }
    const char* i2b = rb < bnt.l_pac ? FWDB : REVB;
    std::string md;
    char tmp[32];
    i64 x = 0, y = 0, u = 0, n_mm = 0, n_gap = 0;
    for (size_t k = 0; k < cig->size(); ++k) {
        int op = (*cig)[k].first, ln = (*cig)[k].second;
        if (op == 0) {
            for (int i = 0; i < ln; ++i) {
                if (q[x + i] != rseq[y + i]) {
                    snprintf(tmp, sizeof tmp, "%lld", (long long)u);
                    md += tmp;
                    md += i2b[rseq[y + i]];
                    ++n_mm;
                    u = 0;
                } else {
                    ++u;
                }
            }
            x += ln; y += ln;
        } else if (op == 2) {
            if (k > 0 && k < cig->size() - 1) {
                snprintf(tmp, sizeof tmp, "%lld", (long long)u);
                md += tmp;
                md += '^';
                for (int i = 0; i < ln; ++i) md += i2b[rseq[y + i]];
                u = 0;
                n_gap += ln;
            }
            y += ln;
        } else if (op == 1) {
            x += ln;
            n_gap += ln;
        }
    }
    snprintf(tmp, sizeof tmp, "%lld", (long long)u);
    md += tmp;
    *NM = n_mm + n_gap;
    *MD = md;
}

// ---- region -> positioned alignment ----------------------------------
struct Aln {
    i64 pos = -1;
    int rid = -1;
    i64 flag = 0;
    int is_rev = 0, is_alt = 0, mapq = 0;
    i64 NM = -1;
    Cigar cigar;
    std::string MD;
    i64 score = -1, sub = -1, alt_sc = 0;
    std::string XA;
    bool has_XA = false;
};

Aln reg2aln(const Opt& o, const Bnt& bnt, i64 l_query, const u8* query,
            const Reg* ar) {
    g_es.reg2aln_calls.fetch_add(1, std::memory_order_relaxed);
    ScopedNs _t(g_es.reg2aln_ns);
    Aln a;
    if (ar == nullptr || ar->rb < 0 || ar->re < 0) {
        a.rid = -1;
        a.pos = -1;
        a.flag |= 0x4;
        return a;
    }
    i64 qb = ar->qb, qe = ar->qe, rb = ar->rb, re = ar->re;
    a.mapq = ar->secondary < 0 ? approx_mapq(o, *ar) : 0;
    if (ar->secondary >= 0) a.flag |= 0x100;
    i64 tmp = infer_bw(qe - qb, re - rb, ar->truesc, o.a, o.o_del,
                       o.e_del);
    i64 w2 = infer_bw(qe - qb, re - rb, ar->truesc, o.a, o.o_ins,
                      o.e_ins);
    w2 = mx(w2, tmp);
    if (w2 > o.w) w2 = mn(w2, ar->w);
    i64 last_sc = -(1LL << 30);
    int i = 0;
    i64 score = 0, NM = -1;
    Cigar cigar;
    std::string MD;
    while (true) {
        w2 = mn(w2, o.w << 2);
        gen_cigar(o, bnt, query + qb, qe - qb, rb, re, w2, &score,
                  &cigar, &NM, &MD);
        if (score == last_sc || w2 == (o.w << 2)) break;
        last_sc = score;
        w2 <<= 1;
        ++i;
        if (i >= 3 || score >= ar->truesc - o.a) break;
    }
    a.NM = NM;
    a.MD = MD;
    i64 pos; int is_rev;
    bnt.depos(rb < bnt.l_pac ? rb : re - 1, &pos, &is_rev);
    a.is_rev = is_rev;
    if (!cigar.empty()) {  // squeeze leading/trailing deletions
        if (cigar.front().first == 2) {
            pos += cigar.front().second;
            cigar.erase(cigar.begin());
        } else if (cigar.back().first == 2) {
            cigar.pop_back();
        }
    }
    if (qb != 0 || qe != l_query) {
        i64 clip5 = is_rev ? l_query - qe : qb;
        i64 clip3 = is_rev ? qb : l_query - qe;
        if (clip5) cigar.insert(cigar.begin(), {3, (int)clip5});
        if (clip3) cigar.push_back({3, (int)clip3});
    }
    a.cigar = cigar;
    a.rid = bnt.pos2rid(pos);
    a.pos = pos - bnt.ann_off[a.rid];
    a.score = ar->score;
    a.sub = mx(ar->sub, ar->csub);
    a.is_alt = (int)ar->is_alt;
    a.alt_sc = ar->alt_sc;
    return a;
}

i64 cigar_rlen(const Cigar& c) {
    i64 n = 0;
    for (auto& oc : c)
        if (oc.first == 0 || oc.first == 2) n += oc.second;
    return n;
}

// ---- SAM line --------------------------------------------------------
struct ReadView {
    const char* name; i64 name_len;
    const u8* seq; i64 l_seq;
    const char* qual; i64 qual_len;   // 0 => absent
    const char* comment; i64 comm_len;
};

void aln2sam(const Opt& o, const Bnt& bnt, const ReadView& rd, int n,
             const std::vector<Aln>& alns, int which, const Aln* mate,
             const char* rg_id, std::string* out) {
    g_es.aln2sam_calls.fetch_add(1, std::memory_order_relaxed);
    ScopedNs _t(g_es.aln2sam_ns);
    const Aln& p = alns[which];
    i64 flag = p.flag;
    int is_rev = p.is_rev;
    int rid = p.rid;
    i64 pos = p.pos;
    const Cigar* cigar = &p.cigar;
    Cigar empty_cig;
    int m_rid = -1, m_rev = 0;
    i64 m_pos = -1;
    const Cigar* m_cigar = &empty_cig;
    if (mate) {
        flag |= 0x1;
        m_rid = mate->rid; m_pos = mate->pos; m_rev = mate->is_rev;
        m_cigar = &mate->cigar;
    }
    if (rid < 0) flag |= 0x4;
    if (mate && m_rid < 0) flag |= 0x8;
    if (rid < 0 && mate && m_rid >= 0) {
        rid = m_rid; pos = m_pos; is_rev = m_rev;
        cigar = &empty_cig;
    }
    if (mate && m_rid < 0 && rid >= 0) {
        m_rid = rid; m_pos = pos; m_rev = is_rev;
        m_cigar = &empty_cig;
    }
    if (is_rev) flag |= 0x10;
    if (mate && m_rev) flag |= 0x20;
    char buf[64];
    out->append(rd.name, rd.name_len);
    snprintf(buf, sizeof buf, "\t%lld",
             (long long)((flag & 0xFFFF) | ((flag & 0x10000) ? 0x100 : 0)));
    out->append(buf);
    if (rid >= 0) {
        out->push_back('\t');
        out->append(bnt.name(rid));
        snprintf(buf, sizeof buf, "\t%lld\t%d", (long long)(pos + 1),
                 p.mapq);
        out->append(buf);
        if (!cigar->empty()) {
            out->push_back('\t');
            for (auto& oc : *cigar) {
                int c = oc.first;
                if (!(o.flag & MEM_F_SOFTCLIP) && !p.is_alt
                        && (c == 3 || c == 4))
                    c = which ? 4 : 3;
                snprintf(buf, sizeof buf, "%d%c", oc.second, OPS[c]);
                out->append(buf);
            }
        } else {
            out->append("\t*");
        }
    } else {
        out->append("\t*\t0\t0\t*");
    }
    if (mate && m_rid >= 0) {
        if (rid == m_rid) out->append("\t=");
        else { out->push_back('\t'); out->append(bnt.name(m_rid)); }
        snprintf(buf, sizeof buf, "\t%lld", (long long)(m_pos + 1));
        out->append(buf);
        if (rid == m_rid) {
            i64 p0 = pos + (is_rev ? cigar_rlen(*cigar) - 1 : 0);
            i64 p1 = m_pos + (m_rev ? cigar_rlen(*m_cigar) - 1 : 0);
            if (m_cigar->empty() || cigar->empty()) {
                out->append("\t0");
            } else {
                i64 sign = p0 > p1 ? 1 : (p0 < p1 ? -1 : 0);
                snprintf(buf, sizeof buf, "\t%lld",
                         (long long)(-(p0 - p1 + sign)));
                out->append(buf);
            }
        } else {
            out->append("\t0");
        }
    } else {
        out->append("\t*\t0\t0");
    }
    // SEQ / QUAL
    if (flag & 0x100) {
        out->append("\t*\t*");
    } else {
        i64 qb = 0, qe = rd.l_seq;
        if (!cigar->empty() && which && !(o.flag & MEM_F_SOFTCLIP)
                && !p.is_alt) {
            int f0 = cigar->front().first, fl = cigar->back().first;
            if (!is_rev) {
                if (f0 == 3 || f0 == 4) qb += cigar->front().second;
                if (fl == 3 || fl == 4) qe -= cigar->back().second;
            } else {
                if (f0 == 3 || f0 == 4) qe -= cigar->front().second;
                if (fl == 3 || fl == 4) qb += cigar->back().second;
            }
        }
        out->push_back('\t');
        if (!is_rev) {
            for (i64 i = qb; i < qe; ++i) out->push_back(FWDB[rd.seq[i]]);
            out->push_back('\t');
            if (rd.qual_len) out->append(rd.qual + qb, qe - qb);
            else out->push_back('*');
        } else {
            for (i64 i = qe - 1; i >= qb; --i)
                out->push_back(REVB[rd.seq[i]]);
            out->push_back('\t');
            if (rd.qual_len) {
                for (i64 i = qe - 1; i >= qb; --i)
                    out->push_back(rd.qual[i]);
            } else {
                out->push_back('*');
            }
        }
    }
    // tags
    if (!cigar->empty()) {
        snprintf(buf, sizeof buf, "\tNM:i:%lld", (long long)p.NM);
        out->append(buf);
        out->append("\tMD:Z:");
        out->append(p.MD);
    }
    if (p.score >= 0) {
        snprintf(buf, sizeof buf, "\tAS:i:%lld", (long long)p.score);
        out->append(buf);
    }
    if (p.sub >= 0) {
        snprintf(buf, sizeof buf, "\tXS:i:%lld",
                 (long long)mx(p.sub, p.alt_sc));
        out->append(buf);
    }
    if (rg_id && rg_id[0]) {
        out->append("\tRG:Z:");
        out->append(rg_id);
    }
    if (!(flag & 0x100)) {
        bool others = false;
        for (int i = 0; i < n; ++i)
            if (i != which && !(alns[i].flag & 0x100)) others = true;
        if (others) {
            out->append("\tSA:Z:");
            for (int i = 0; i < n; ++i) {
                const Aln& r = alns[i];
                if (i == which || (r.flag & 0x100)) continue;
                out->append(bnt.name(r.rid));
                snprintf(buf, sizeof buf, ",%lld,%c,",
                         (long long)(r.pos + 1), "+-"[r.is_rev]);
                out->append(buf);
                for (auto& oc : r.cigar) {
                    snprintf(buf, sizeof buf, "%d%c", oc.second,
                             OPS[oc.first]);
                    out->append(buf);
                }
                snprintf(buf, sizeof buf, ",%d,%lld;", r.mapq,
                         (long long)r.NM);
                out->append(buf);
            }
        }
        if (p.alt_sc > 0) {
            snprintf(buf, sizeof buf, "\tpa:f:%.3f",
                     (double)p.score / (double)p.alt_sc);
            out->append(buf);
        }
    }
    if (p.has_XA) {
        out->append("\tXA:Z:");
        out->append(p.XA);
    }
    if (rd.comm_len) {
        out->push_back('\t');
        out->append(rd.comment, rd.comm_len);
    }
    out->push_back('\n');
}

// ---- XA --------------------------------------------------------------
i64 get_pri_idx(double xa_drop_ratio, const std::vector<Reg>& regs,
                size_t i) {
    i64 k = regs[i].secondary_all;
    if (k >= 0 && (double)regs[i].score >= regs[k].score * xa_drop_ratio)
        return k;
    return -1;
}

// XA strings per region (index-aligned); has[i] false when none
void gen_alt(const Opt& o, const Bnt& bnt, const std::vector<Reg>& regs,
             i64 l_query, const u8* query, std::vector<std::string>* XA,
             std::vector<bool>* has) {
    g_es.gen_alt_calls.fetch_add(1, std::memory_order_relaxed);
    ScopedNs _t(g_es.gen_alt_ns);
    size_t n = regs.size();
    XA->assign(n, "");
    has->assign(n, false);
    std::vector<i64> cnt(n, 0);
    std::vector<bool> has_alt(n, false);
    i64 tot = 0;
    for (size_t i = 0; i < n; ++i) {
        i64 r = get_pri_idx(o.XA_drop_ratio, regs, i);
        if (r >= 0) {
            ++cnt[r];
            ++tot;
            if (regs[i].is_alt) has_alt[r] = true;
        }
    }
    if (tot == 0) return;
    std::vector<std::string> aln(n);
    char buf[64];
    for (size_t i = 0; i < n; ++i) {
        i64 r = get_pri_idx(o.XA_drop_ratio, regs, i);
        if (r < 0) continue;
        if (cnt[r] > (has_alt[r] ? o.max_XA_hits_alt : o.max_XA_hits))
            continue;
        Aln t = reg2aln(o, bnt, l_query, query, &regs[i]);
        std::string& s = aln[r];
        s.append(bnt.name(t.rid));
        snprintf(buf, sizeof buf, ",%c%lld,", "+-"[t.is_rev],
                 (long long)(t.pos + 1));
        s.append(buf);
        for (auto& oc : t.cigar) {
            snprintf(buf, sizeof buf, "%d%c", oc.second, OPS[oc.first]);
            s.append(buf);
        }
        snprintf(buf, sizeof buf, ",%lld;", (long long)t.NM);
        s.append(buf);
    }
    for (size_t k = 0; k < n; ++k) {
        if (!aln[k].empty()) {
            (*XA)[k] = aln[k];
            (*has)[k] = true;
        }
    }
}

// ---- SE emission -----------------------------------------------------
void reg2sam(const Opt& o, const Bnt& bnt, const ReadView& rd,
             std::vector<Reg>& regs, i64 extra_flag, const Aln* mate,
             const char* rg_id, std::string* out) {
    std::vector<std::string> XA;
    std::vector<bool> hasXA;
    bool use_xa = !(o.flag & MEM_F_ALL);
    if (use_xa) gen_alt(o, bnt, regs, rd.l_seq, rd.seq, &XA, &hasXA);
    std::vector<Aln> alns;
    int l = 0;
    for (size_t k = 0; k < regs.size(); ++k) {
        const Reg& p = regs[k];
        if (p.score < o.T) continue;
        if (p.secondary >= 0 && (p.is_alt || !(o.flag & MEM_F_ALL)))
            continue;
        if (p.secondary >= 0 && p.secondary < 0x7FFFFFFF
                && (double)p.score
                       < regs[p.secondary].score * o.drop_ratio)
            continue;
        Aln q = reg2aln(o, bnt, rd.l_seq, rd.seq, &p);
        if (use_xa && hasXA[k]) { q.XA = XA[k]; q.has_XA = true; }
        q.flag |= extra_flag;
        if (p.secondary >= 0) q.sub = -1;
        if (l && p.secondary < 0)
            q.flag |= (o.flag & MEM_F_NO_MULTI) ? 0x10000 : 0x800;
        if (!(o.flag & MEM_F_KEEP_SUPP_MAPQ) && l && !p.is_alt
                && q.mapq > alns[0].mapq)
            q.mapq = alns[0].mapq;
        ++l;
        alns.push_back(std::move(q));
    }
    if (alns.empty()) {
        Aln t = reg2aln(o, bnt, rd.l_seq, rd.seq, nullptr);
        t.flag |= extra_flag;
        std::vector<Aln> one{t};
        aln2sam(o, bnt, rd, 1, one, 0, mate, rg_id, out);
        return;
    }
    for (size_t k = 0; k < alns.size(); ++k)
        aln2sam(o, bnt, rd, (int)alns.size(), alns, (int)k, mate, rg_id,
                out);
}

// ---- paired-end ------------------------------------------------------
struct PES { i64 failed, low, high; double avg, std; };

void infer_dir(i64 l_pac, i64 b1, i64 b2, int* d, i64* dist) {
    bool r1 = b1 >= l_pac, r2 = b2 >= l_pac;
    i64 p2 = (r1 == r2) ? b2 : (l_pac << 1) - 1 - b2;
    *dist = p2 > b1 ? p2 - b1 : b1 - p2;
    *d = ((r1 == r2) ? 0 : 1) ^ ((p2 > b1) ? 0 : 3);
}

int raw_mapq(i64 diff, i64 a) {
    return (int)mn((i64)(6.02 * (double)diff / (double)a + 0.499),
                   (i64)60);
}

// mem_matesw: may insert rescued regions into ma (sorted by score desc)
int matesw(const Opt& o, const Bnt& bnt, const PES* pes, const Reg& a,
           const ReadView& mate, std::vector<Reg>* ma) {
    g_es.matesw_calls.fetch_add(1, std::memory_order_relaxed);
    ScopedNs _t(g_es.matesw_ns);
    i64 l_pac = bnt.l_pac;
    i64 l_ms = mate.l_seq;
    const u8* ms = mate.seq;
    int skip[4];
    for (int r = 0; r < 4; ++r) skip[r] = pes[r].failed ? 1 : 0;
    for (auto& m : *ma) {
        int r; i64 dist;
        infer_dir(l_pac, a.rb, m.rb, &r, &dist);
        if (!pes[r].failed && pes[r].low <= dist && dist <= pes[r].high)
            skip[r] = 1;
    }
    if (skip[0] + skip[1] + skip[2] + skip[3] == 4) return 0;
    int n = 0;
    for (int r = 0; r < 4; ++r) {
        if (skip[r]) continue;
        bool is_rev = ((r >> 1) != (r & 1));
        bool is_larger = !(r >> 1);
        std::vector<u8> seq;
        if (is_rev) {
            seq.resize(l_ms);
            for (i64 i = 0; i < l_ms; ++i) {
                u8 c = ms[l_ms - 1 - i];
                seq[i] = c < 4 ? 3 - c : 4;
            }
        } else {
            seq.assign(ms, ms + l_ms);
        }
        i64 rb, re;
        if (!is_rev) {
            rb = is_larger ? a.rb + pes[r].low : a.rb - pes[r].high;
            re = (is_larger ? a.rb + pes[r].high : a.rb - pes[r].low)
                 + l_ms;
        } else {
            rb = (is_larger ? a.rb + pes[r].low : a.rb - pes[r].high)
                 - l_ms;
            re = is_larger ? a.rb + pes[r].high : a.rb - pes[r].low;
        }
        rb = mx(rb, (i64)0);
        re = mn(re, l_pac << 1);
        int rid = -1;
        std::vector<u8> ref;
        if (rb < re) {
            i64 b2, e2;
            bnt.fetch_bounds(rb, (rb + re) >> 1, re, &rid, &b2, &e2);
            rb = b2; re = e2;
            ref = bnt.get_seq(rb, re);
        }
        if (rid >= 0 && re - rb >= o.min_seed_len) {
            int32_t out7[7];
            g_es.kswa_calls.fetch_add(1, std::memory_order_relaxed);
            tpubwa_ksw_align((int32_t)l_ms, seq.data(),
                             (int32_t)(re - rb), ref.data(), 5, o.mat,
                             (int32_t)o.o_del, (int32_t)o.e_del,
                             (int32_t)o.o_ins, (int32_t)o.e_ins,
                             (int32_t)(o.min_seed_len * o.a), 1, out7);
            i64 score = out7[0], te = out7[1], qe = out7[2],
                score2 = out7[3], tb = out7[5], qb = out7[6];
            if (score >= o.min_seed_len && qb >= 0) {
                Reg b{};
                b.rid = a.rid;
                b.is_alt = a.is_alt;
                b.qb = is_rev ? l_ms - (qe + 1) : qb;
                b.qe = is_rev ? l_ms - qb : qe + 1;
                b.rb = is_rev ? (l_pac << 1) - (rb + te + 1) : rb + tb;
                b.re = is_rev ? (l_pac << 1) - (rb + tb) : rb + te + 1;
                b.score = score;
                b.truesc = score;
                b.csub = score2;
                b.sub = 0; b.alt_sc = 0; b.sub_n = 0; b.w = 0;
                b.secondary = -1;
                b.secondary_all = -1;
                b.seedlen0 = 0;
                b.n_comp = 1;
                b.frac_rep = 0.0;
                b.seedcov = mn(b.re - b.rb, b.qe - b.qb) >> 1;
                size_t ins = 0;
                while (ins < ma->size()
                       && (*ma)[ins].score >= b.score)
                    ++ins;
                ma->insert(ma->begin() + ins, b);
            }
            ++n;
        }
        if (n) break;
    }
    return n;
}

// mem_pair
void mem_pair(const Opt& o, const Bnt& bnt, const PES* pes,
              const std::vector<Reg>* a, i64 pair_id, const i64* n_pri,
              i64* o_out, i64* sub_out, i64* n_sub_out, i64* z) {
    ScopedNs _t(g_es.mempair_ns);
    i64 l_pac = bnt.l_pac;
    std::vector<std::pair<u64, u64>> v;
    for (int r = 0; r < 2; ++r) {
        for (i64 i = 0; i < n_pri[r]; ++i) {
            const Reg& e = a[r][i];
            i64 fx = e.rb < l_pac ? e.rb : (l_pac << 1) - 1 - e.rb;
            u64 x = ((u64)e.rid << 32) | (u64)(fx - bnt.ann_off[e.rid]);
            u64 y = ((u64)e.score << 32) | ((u64)i << 2)
                    | ((e.rb >= l_pac) ? 2u : 0u) | (u64)r;
            v.push_back({x, y});
        }
    }
    std::sort(v.begin(), v.end());
    i64 y_last[4] = {-1, -1, -1, -1};
    std::vector<std::pair<u64, u64>> u;
    for (size_t i = 0; i < v.size(); ++i) {
        for (int rr = 0; rr < 2; ++rr) {
            int dire = (rr << 1) | (int)((v[i].second >> 1) & 1);
            if (pes[dire].failed) continue;
            int which = (rr << 1) | (int)((v[i].second & 1) ^ 1);
            if (y_last[which] < 0) continue;
            for (i64 k = y_last[which]; k >= 0; --k) {
                if ((int)(v[k].second & 3) != which) continue;
                i64 dist = (i64)(v[i].first - v[k].first);
                if (dist > pes[dire].high) break;
                if (dist < pes[dire].low) continue;
                double p = 0.0;
                if (pes[dire].std > 0) {
                    double ns = ((double)dist - pes[dire].avg)
                                / pes[dire].std;
                    p = 2.0 * std::erfc(std::fabs(ns) * M_SQRT1_2);
                }
                i64 q;
                if (p > 0) {
                    q = (i64)((double)((v[i].second >> 32)
                                       + (v[k].second >> 32))
                              + 0.721 * std::log(p) * (double)o.a
                              + 0.499);
                    q = mx(q, (i64)0);
                } else {
                    q = 0;
                }
                u64 y = ((u64)k << 32) | (u64)i;
                u64 x = ((u64)q << 32)
                        | (hash_64((y ^ ((u64)pair_id << 8)))
                           & 0xFFFFFFFFu);
                u.push_back({x, y});
            }
        }
        y_last[v[i].second & 3] = (i64)i;
    }
    z[0] = z[1] = -1;
    if (u.empty()) {
        *o_out = 0; *sub_out = 0; *n_sub_out = 0;
        return;
    }
    i64 tmp = mx(o.a + o.b, mx(o.o_del + o.e_del, o.o_ins + o.e_ins));
    std::sort(u.begin(), u.end());
    u64 bi = u.back().second >> 32;
    u64 bk = u.back().second & 0xFFFFFFFFu;
    z[v[bk].second & 1] = (i64)((v[bk].second & 0xFFFFFFFFu) >> 2);
    z[v[bi].second & 1] = (i64)((v[bi].second & 0xFFFFFFFFu) >> 2);
    *o_out = (i64)(u.back().first >> 32);
    *sub_out = u.size() > 1 ? (i64)(u[u.size() - 2].first >> 32) : 0;
    i64 n_sub = 0;
    for (i64 i = (i64)u.size() - 2; i >= 0; --i)
        if (*sub_out - (i64)(u[i].first >> 32) <= tmp) ++n_sub;
    *n_sub_out = n_sub;
}

// mem_sam_pe
void sam_pe(const Opt& o, const Bnt& bnt, const PES* pes, i64 pair_id,
            const ReadView* rd, std::vector<Reg>* a, const char* rg_id,
            std::string* out) {
    if (!(o.flag & MEM_F_NO_RESCUE)) {
        for (int i = 0; i < 2; ++i) {
            std::vector<Reg> b;
            if (!a[i].empty())
                for (auto& r : a[i])
                    if (r.score >= a[i][0].score - o.pen_unpaired)
                        b.push_back(r);
            for (size_t j = 0; j < b.size(); ++j) {
                if ((i64)j >= o.max_matesw) break;
                matesw(o, bnt, pes, b[j], rd[1 - i], &a[1 - i]);
            }
        }
    }
    i64 n_pri[2] = {mark_primary(o, a[0], (pair_id << 1) | 0),
                    mark_primary(o, a[1], (pair_id << 1) | 1)};
    i64 extra_flag = 1;
    if (!(o.flag & MEM_F_NOPAIRING) && n_pri[0] && n_pri[1]) {
        i64 oo, subo, n_sub, z[2];
        mem_pair(o, bnt, pes, a, pair_id, n_pri, &oo, &subo, &n_sub, z);
        if (oo > 0) {
            bool is_multi[2] = {false, false};
            for (int i = 0; i < 2; ++i)
                for (i64 j = 1; j < n_pri[i]; ++j)
                    if (a[i][j].secondary < 0 && a[i][j].score >= o.T)
                        is_multi[i] = true;
            if (!is_multi[0] && !is_multi[1]) {
                int q_se[2] = {approx_mapq(o, a[0][0]),
                               approx_mapq(o, a[1][0])};
                i64 score_un = a[0][0].score + a[1][0].score
                               - o.pen_unpaired;
                subo = mx(subo, score_un);
                i64 q_pe = raw_mapq(oo - subo, o.a);
                if (n_sub > 0)
                    q_pe -= (i64)(4.343 * std::log((double)n_sub + 1)
                                  + 0.499);
                q_pe = mn(mx(q_pe, (i64)0), (i64)60);
                q_pe = (i64)((double)q_pe
                             * (1.0 - 0.5 * (a[0][0].frac_rep
                                             + a[1][0].frac_rep))
                             + 0.499);
                if (oo > score_un) {
                    Reg* c[2] = {&a[0][z[0]], &a[1][z[1]]};
                    for (int i = 0; i < 2; ++i) {
                        if (c[i]->secondary >= 0) {
                            c[i]->sub = a[i][c[i]->secondary].score;
                            c[i]->secondary = -2;
                        }
                        q_se[i] = approx_mapq(o, *c[i]);
                    }
                    for (int i = 0; i < 2; ++i) {
                        q_se[i] = (int)mx((i64)q_se[i],
                                          mn(q_pe, (i64)q_se[i] + 40));
                        q_se[i] = (int)mn(
                            (i64)q_se[i],
                            (i64)raw_mapq(c[i]->score - c[i]->csub,
                                          o.a));
                    }
                    extra_flag |= 2;
                } else {
                    z[0] = z[1] = 0;
                    q_se[0] = approx_mapq(o, a[0][0]);
                    q_se[1] = approx_mapq(o, a[1][0]);
                }
                std::vector<std::string> XA[2];
                std::vector<bool> hasXA[2];
                bool use_xa = !(o.flag & MEM_F_ALL);
                if (use_xa)
                    for (int i = 0; i < 2; ++i)
                        gen_alt(o, bnt, a[i], rd[i].l_seq, rd[i].seq,
                                &XA[i], &hasXA[i]);
                std::vector<Aln> aa[2];
                Aln h[2];
                for (int i = 0; i < 2; ++i) {
                    Aln hi = reg2aln(o, bnt, rd[i].l_seq, rd[i].seq,
                                     &a[i][z[i]]);
                    hi.mapq = q_se[i];
                    hi.flag |= (0x40LL << i) | extra_flag;
                    if (use_xa && hasXA[i][z[i]]) {
                        hi.XA = XA[i][z[i]];
                        hi.has_XA = true;
                    }
                    h[i] = hi;
                    aa[i].push_back(hi);
                    if (n_pri[i] < (i64)a[i].size()) {
                        const Reg& p = a[i][n_pri[i]];
                        if (p.score >= o.T && p.secondary < 0
                                && p.is_alt) {
                            Aln gi = reg2aln(o, bnt, rd[i].l_seq,
                                             rd[i].seq, &p);
                            gi.flag |= 0x800 | (0x40LL << i)
                                       | extra_flag;
                            if (use_xa && hasXA[i][n_pri[i]]) {
                                gi.XA = XA[i][n_pri[i]];
                                gi.has_XA = true;
                            }
                            aa[i].push_back(gi);
                        }
                    }
                }
                for (size_t i = 0; i < aa[0].size(); ++i)
                    aln2sam(o, bnt, rd[0], (int)aa[0].size(), aa[0],
                            (int)i, &h[1], rg_id, out);
                for (size_t i = 0; i < aa[1].size(); ++i)
                    aln2sam(o, bnt, rd[1], (int)aa[1].size(), aa[1],
                            (int)i, &h[0], rg_id, out);
                return;
            }
        }
    }
    // no_pairing path
    Aln h[2];
    for (int i = 0; i < 2; ++i) {
        i64 which = -1;
        if (!a[i].empty()) {
            if (a[i][0].score >= o.T) which = 0;
            else if (n_pri[i] < (i64)a[i].size()
                     && a[i][n_pri[i]].score >= o.T)
                which = n_pri[i];
        }
        h[i] = reg2aln(o, bnt, rd[i].l_seq, rd[i].seq,
                       which >= 0 ? &a[i][which] : nullptr);
    }
    if (!(o.flag & MEM_F_NOPAIRING) && h[0].rid == h[1].rid
            && h[0].rid >= 0 && !a[0].empty() && !a[1].empty()) {
        int d; i64 dist;
        infer_dir(bnt.l_pac, a[0][0].rb, a[1][0].rb, &d, &dist);
        if (!pes[d].failed && pes[d].low <= dist && dist <= pes[d].high)
            extra_flag |= 2;
    }
    reg2sam(o, bnt, rd[0], a[0], 0x41 | extra_flag, &h[1], rg_id, out);
    reg2sam(o, bnt, rd[1], a[1], 0x81 | extra_flag, &h[0], rg_id, out);
}

}  // namespace

// ---- batch entry ------------------------------------------------------
extern "C" {

// Returns bytes written, or -(bytes needed) if out_cap is too small.
// iv layout: a,b,o_del,e_del,o_ins,e_ins,w,T,flag,min_seed_len,
//            max_matesw,max_XA_hits,max_XA_hits_alt,pen_unpaired,
//            mapQ_coef_len, is_pe, n_processed
// dv layout: mapQ_coef_fac, drop_ratio, XA_drop_ratio, mask_level
// pes_iv: [4][3] failed,low,high ; pes_dv: [4][2] avg,std
i64 tpubwa_emit_batch(
    const i64* iv, const double* dv, const int32_t* mat,
    const u8* codes, i64 l_pac, int32_t n_anns, const i64* ann_off,
    const i64* ann_len, const u8* ann_alt, const char* name_blob,
    const i64* name_off,
    i64 n_reads, const char* rname_blob, const i64* rname_off,
    const u8* seq_blob, const i64* seq_off, const char* qual_blob,
    const i64* qual_off, const char* comm_blob, const i64* comm_off,
    const int32_t* reg_cnt, const i64* reg_iv, const double* reg_fr,
    const i64* pes_iv, const double* pes_dv, const char* rg_id,
    char* out, i64 out_cap) {
    Opt o;
    o.a = iv[0]; o.b = iv[1]; o.o_del = iv[2]; o.e_del = iv[3];
    o.o_ins = iv[4]; o.e_ins = iv[5]; o.w = iv[6]; o.T = iv[7];
    o.flag = iv[8]; o.min_seed_len = iv[9]; o.max_matesw = iv[10];
    o.max_XA_hits = iv[11]; o.max_XA_hits_alt = iv[12];
    o.pen_unpaired = iv[13]; o.mapQ_coef_len = iv[14];
    const i64 is_pe = iv[15];
    const i64 n_processed = iv[16];
    o.mapQ_coef_fac = dv[0]; o.drop_ratio = dv[1];
    o.XA_drop_ratio = dv[2]; o.mask_level = dv[3];
    memcpy(o.mat, mat, 25 * sizeof(int32_t));

    Bnt bnt{codes, l_pac, n_anns, ann_off, ann_len, ann_alt,
            name_blob, name_off};
    PES pes[4];
    for (int d = 0; d < 4; ++d) {
        pes[d].failed = pes_iv[d * 3];
        pes[d].low = pes_iv[d * 3 + 1];
        pes[d].high = pes_iv[d * 3 + 2];
        pes[d].avg = pes_dv[d * 2];
        pes[d].std = pes_dv[d * 2 + 1];
    }
    auto rview = [&](i64 i) {
        ReadView r;
        r.name = rname_blob + rname_off[i];
        r.name_len = rname_off[i + 1] - rname_off[i];
        r.seq = seq_blob + seq_off[i];
        r.l_seq = seq_off[i + 1] - seq_off[i];
        r.qual = qual_blob + qual_off[i];
        r.qual_len = qual_off[i + 1] - qual_off[i];
        r.comment = comm_blob + comm_off[i];
        r.comm_len = comm_off[i + 1] - comm_off[i];
        return r;
    };
    auto load_regs = [&](i64 i, i64 base) {
        std::vector<Reg> rs((size_t)reg_cnt[i]);
        for (i64 k = 0; k < reg_cnt[i]; ++k) {
            const i64* p = reg_iv + (base + k) * NF;
            Reg& r = rs[k];
            r.rb = p[0]; r.re = p[1]; r.qb = p[2]; r.qe = p[3];
            r.rid = p[4]; r.score = p[5]; r.truesc = p[6]; r.sub = p[7];
            r.alt_sc = p[8]; r.csub = p[9]; r.sub_n = p[10]; r.w = p[11];
            r.seedcov = p[12]; r.secondary = p[13];
            r.secondary_all = p[14]; r.seedlen0 = p[15];
            r.n_comp = p[16]; r.is_alt = p[17];
            r.frac_rep = reg_fr[base + k];
            r.hash = 0;
        }
        return rs;
    };
    std::string text;
    text.reserve((size_t)mn(out_cap, n_reads * 512 + 4096));
    i64 base = 0;
    if (is_pe) {
        for (i64 i = 0; i < n_reads; i += 2) {
            i64 pair_id = (n_processed >> 1) + (i >> 1);
            ReadView rd[2] = {rview(i), rview(i + 1)};
            std::vector<Reg> a[2] = {load_regs(i, base),
                                     load_regs(i + 1,
                                               base + reg_cnt[i])};
            base += reg_cnt[i] + reg_cnt[i + 1];
            sam_pe(o, bnt, pes, pair_id, rd, a, rg_id, &text);
        }
    } else {
        for (i64 i = 0; i < n_reads; ++i) {
            ReadView rd = rview(i);
            std::vector<Reg> regs = load_regs(i, base);
            base += reg_cnt[i];
            mark_primary(o, regs, n_processed + i);
            reg2sam(o, bnt, rd, regs, 0, nullptr, rg_id, &text);
        }
    }
    if ((i64)text.size() > out_cap) return -(i64)text.size();
    memcpy(out, text.data(), text.size());
    return (i64)text.size();
}

// Emit-phase attribution: fills out[0..10] with
// [matesw_calls, matesw_ns, ksw_align_calls, gen_alt_calls, gen_alt_ns,
//  reg2aln_calls, reg2aln_ns, mempair_ns, markpri_ns, aln2sam_calls,
//  aln2sam_ns]; reset != 0 zeroes the counters afterwards.
void tpubwa_emit_stats(i64* out, int32_t reset) {
    std::atomic<i64>* fields[] = {
        &g_es.matesw_calls, &g_es.matesw_ns, &g_es.kswa_calls,
        &g_es.gen_alt_calls, &g_es.gen_alt_ns,
        &g_es.reg2aln_calls, &g_es.reg2aln_ns,
        &g_es.mempair_ns, &g_es.markpri_ns,
        &g_es.aln2sam_calls, &g_es.aln2sam_ns};
    for (int i = 0; i < 11; ++i) {
        out[i] = fields[i]->load(std::memory_order_relaxed);
        if (reset) fields[i]->store(0, std::memory_order_relaxed);
    }
}

}  // extern "C"

// ---- seed chaining (bwamem.c:mem_chain/~330, mem_chain_flt/~470,
// mem_flt_chained_seeds/~640; port of host/chain.py) -------------------
namespace {

struct Seed { i64 rbeg, qbeg, len, score; };
struct Chain {
    int rid;
    i64 pos;
    std::vector<Seed> seeds;
    int is_alt = 0;
    i64 w = 0;
    int kept = 0;
    i64 first = -1;
    double frac_rep = 0.0;
    i64 qbeg() const { return seeds.front().qbeg; }
    i64 qend() const {
        const Seed& s = seeds.back();
        return s.qbeg + s.len;
    }
};

struct ChainOpt {
    i64 a, o_del, e_del, o_ins, e_ins, w, max_chain_gap, min_seed_len,
        min_chain_weight, max_chain_extend, max_occ;
    double mask_level, drop_ratio;
    const int32_t* mat;
};

int intv2rid(const Bnt& bnt, i64 rb, i64 re) {
    if (rb < bnt.l_pac && re > bnt.l_pac) return -2;
    i64 fb, fe; int rev;
    bnt.depos(rb < bnt.l_pac ? rb : re - 1, &fb, &rev);
    bnt.depos(rb < bnt.l_pac ? re - 1 : rb, &fe, &rev);
    if (fb > fe) std::swap(fb, fe);
    int rid_b = bnt.pos2rid(fb);
    int rid_e = bnt.pos2rid(fe);
    return rid_b == rid_e ? rid_b : -1;
}

bool test_and_merge(const ChainOpt& o, i64 l_pac, Chain& c,
                    const Seed& p, int seed_rid) {
    const Seed& last = c.seeds.back();
    const Seed& first = c.seeds.front();
    i64 qend = last.qbeg + last.len;
    i64 rend = last.rbeg + last.len;
    if (seed_rid != c.rid) return false;
    if (p.qbeg >= first.qbeg && p.qbeg + p.len <= qend
            && p.rbeg >= first.rbeg && p.rbeg + p.len <= rend)
        return true;  // contained
    if ((last.rbeg < l_pac || first.rbeg < l_pac) && p.rbeg >= l_pac)
        return false;
    i64 x = p.qbeg - last.qbeg;
    i64 y = p.rbeg - last.rbeg;
    if (y >= 0 && x - y <= o.w && y - x <= o.w
            && x - last.len < o.max_chain_gap
            && y - last.len < o.max_chain_gap) {
        c.seeds.push_back(p);
        return true;
    }
    return false;
}

i64 chain_weight(const Chain& c) {
    i64 w = 0, end = 0;
    for (const Seed& s : c.seeds) {
        if (s.qbeg >= end) w += s.len;
        else if (s.qbeg + s.len > end) w += s.qbeg + s.len - end;
        end = mx(end, s.qbeg + s.len);
    }
    i64 tmp = w;
    w = 0; end = 0;
    for (const Seed& s : c.seeds) {
        if (s.rbeg >= end) w += s.len;
        else if (s.rbeg + s.len > end) w += s.rbeg + s.len - end;
        end = mx(end, s.rbeg + s.len);
    }
    w = mn(w, tmp);
    return mn(w, (i64)((1LL << 30) - 1));
}

void chain_flt(const ChainOpt& o, std::vector<Chain>& chains) {
    if (chains.empty()) return;
    std::vector<Chain> a;
    for (Chain& c : chains) {
        c.first = -1;
        c.kept = 0;
        c.w = chain_weight(c);
        if (c.w >= o.min_chain_weight) a.push_back(std::move(c));
    }
    chains.clear();
    if (a.empty()) return;
    std::stable_sort(a.begin(), a.end(),
        [](const Chain& x, const Chain& y) {
            if (x.w != y.w) return x.w > y.w;
            if (x.pos != y.pos) return x.pos < y.pos;
            return x.qbeg() < y.qbeg();
        });
    a[0].kept = 3;
    std::vector<size_t> kept_idx{0};
    for (size_t i = 1; i < a.size(); ++i) {
        bool large_ovlp = false, broke = false;
        for (size_t j : kept_idx) {
            i64 b_max = mx(a[j].qbeg(), a[i].qbeg());
            i64 e_min = mn(a[j].qend(), a[i].qend());
            if (e_min > b_max && (!a[j].is_alt || a[i].is_alt)) {
                i64 li = a[i].qend() - a[i].qbeg();
                i64 lj = a[j].qend() - a[j].qbeg();
                i64 min_l = mn(li, lj);
                if ((double)(e_min - b_max) >= min_l * o.mask_level
                        && min_l < o.max_chain_gap) {
                    large_ovlp = true;
                    if (a[j].first < 0) a[j].first = (i64)i;
                    if ((double)a[i].w < a[j].w * o.drop_ratio
                            && a[j].w - a[i].w >= o.min_seed_len * 2) {
                        broke = true;
                        break;
                    }
                }
            }
        }
        if (!broke) {
            kept_idx.push_back(i);
            a[i].kept = large_ovlp ? 2 : 3;
        }
    }
    for (size_t j : kept_idx)
        if (a[j].first >= 0) a[a[j].first].kept = 1;
    i64 k = 0;
    size_t cut = a.size();
    for (size_t i = 0; i < a.size(); ++i) {
        if (a[i].kept == 0 || a[i].kept == 3) continue;
        ++k;
        if (k >= o.max_chain_extend) { cut = i; break; }
    }
    for (size_t i = cut; i < a.size(); ++i)
        if (a[i].kept < 3) a[i].kept = 0;
    for (Chain& c : a)
        if (c.kept != 0) chains.push_back(std::move(c));
}

const i64 MEM_SHORT_EXT = 50, MEM_SHORT_LEN = 200;
const double MEM_SEEDSW_COEF = 0.05, MEM_MINSC_COEF = 5.5,
             MEM_HSP_COEF = 1.1;

i64 mem_seed_sw(const ChainOpt& o, const Bnt& bnt, i64 l_query,
                const u8* query, const Seed& s) {
    if (s.len >= MEM_SHORT_LEN) return -1;
    i64 qb = s.qbeg, qe = s.qbeg + s.len;
    i64 rb = s.rbeg, re = s.rbeg + s.len;
    i64 mid = (rb + re) >> 1;
    qb = mx(qb - MEM_SHORT_EXT, (i64)0);
    qe = mn(qe + MEM_SHORT_EXT, l_query);
    rb = mx(rb - MEM_SHORT_EXT, (i64)0);
    re = mn(re + MEM_SHORT_EXT, bnt.l_pac << 1);
    if (rb < bnt.l_pac && bnt.l_pac < re) {
        if (mid < bnt.l_pac) re = bnt.l_pac; else rb = bnt.l_pac;
    }
    if (qe - qb >= MEM_SHORT_LEN || re - rb >= MEM_SHORT_LEN) return -1;
    int rid; i64 b2, e2;
    bnt.fetch_bounds(rb, mid, re, &rid, &b2, &e2);
    std::vector<u8> rseq = bnt.get_seq(b2, e2);
    int32_t out7[7];
    tpubwa_ksw_align((int32_t)(qe - qb), query + qb,
                     (int32_t)(e2 - b2), rseq.data(), 5, o.mat,
                     (int32_t)o.o_del, (int32_t)o.e_del,
                     (int32_t)o.o_ins, (int32_t)o.e_ins, 0, 1, out7);
    return out7[0];
}

void flt_chained_seeds(const ChainOpt& o, const Bnt& bnt, i64 l_query,
                       const u8* query, std::vector<Chain>& chains) {
    double min_l = o.min_chain_weight
                       ? MEM_HSP_COEF * (double)o.min_chain_weight
                       : MEM_MINSC_COEF * std::log((double)l_query);
    if (min_l > MEM_SEEDSW_COEF * (double)l_query) return;
    i64 min_hsp_score = (i64)((double)o.a * min_l + 0.499);
    for (Chain& c : chains) {
        std::vector<Seed> kept;
        for (Seed s : c.seeds) {
            i64 score = mem_seed_sw(o, bnt, l_query, query, s);
            if (score < 0 || score >= min_hsp_score) {
                s.score = score < 0 ? s.len * o.a : score;
                kept.push_back(s);
            }
        }
        c.seeds = kept;
    }
}

}  // namespace

extern "C" {

// mem_chain + mem_chain_flt + mem_flt_chained_seeds for a whole chunk.
// civ: a,o_del,e_del,o_ins,e_ins,w,max_chain_gap,min_seed_len,
//      min_chain_weight,max_chain_extend,max_occ
// cdv: mask_level, drop_ratio
// per read i: intervals rows [intv_off[i], intv_off[i+1]) of intv[n,5];
// per interval k: positions [pos_off[k], pos_off[k+1]) of pos[].
// outputs (caller-allocated):
//   chain_cnt[n_reads]; chain_meta[mc,3] (rid,is_alt,n_seeds);
//   chain_fr[mc]; seeds[ms,4] (rbeg,qbeg,len,score)
// returns 0, or -1 if mc/ms too small.
int tpubwa_chain_batch(
    const i64* civ, const double* cdv, const int32_t* mat,
    const u8* codes, i64 l_pac, int32_t n_anns, const i64* ann_off,
    const i64* ann_len, const u8* ann_alt, const char* name_blob,
    const i64* name_off,
    i64 n_reads, const u8* seq_blob, const i64* seq_off,
    const i64* intv, const i64* intv_off, const i64* pos,
    const i64* pos_off,
    int32_t* chain_cnt, i64* chain_meta, double* chain_fr, i64 mc,
    i64* seeds_out, i64 ms) {
    ChainOpt o;
    o.a = civ[0]; o.o_del = civ[1]; o.e_del = civ[2]; o.o_ins = civ[3];
    o.e_ins = civ[4]; o.w = civ[5]; o.max_chain_gap = civ[6];
    o.min_seed_len = civ[7]; o.min_chain_weight = civ[8];
    o.max_chain_extend = civ[9]; o.max_occ = civ[10];
    o.mask_level = cdv[0]; o.drop_ratio = cdv[1];
    o.mat = mat;
    Bnt bnt{codes, l_pac, n_anns, ann_off, ann_len, ann_alt,
            name_blob, name_off};
    i64 nc = 0, nsd = 0;
    for (i64 ri = 0; ri < n_reads; ++ri) {
        const u8* q = seq_blob + seq_off[ri];
        i64 l_query = seq_off[ri + 1] - seq_off[ri];
        std::vector<Chain> chains;
        if (l_query >= o.min_seed_len) {
            // frac_rep over this read's intervals
            i64 l_rep = 0, b = 0, e = 0;
            for (i64 k = intv_off[ri]; k < intv_off[ri + 1]; ++k) {
                const i64* p = intv + k * 5;
                if (p[2] <= o.max_occ) continue;
                if (p[3] > e) { l_rep += e - b; b = p[3]; e = p[4]; }
                else e = mx(e, p[4]);
            }
            l_rep += e - b;
            // chaining over sampled positions (lower-bound merge)
            std::vector<i64> keys;
            for (i64 k = intv_off[ri]; k < intv_off[ri + 1]; ++k) {
                const i64* p = intv + k * 5;
                i64 slen = p[4] - p[3];
                for (i64 t = pos_off[k]; t < pos_off[k + 1]; ++t) {
                    Seed s{pos[t], p[3], slen, slen};
                    int rid = intv2rid(bnt, s.rbeg, s.rbeg + s.len);
                    if (rid < 0) continue;
                    bool to_add = true;
                    if (!chains.empty()) {
                        // lower bound: largest anchor <= s.rbeg
                        size_t idx = std::upper_bound(
                            keys.begin(), keys.end(), s.rbeg)
                            - keys.begin();
                        if (idx > 0 && test_and_merge(
                                o, l_pac, chains[idx - 1], s, rid))
                            to_add = false;
                    }
                    if (to_add) {
                        Chain c;
                        c.rid = rid;
                        c.pos = s.rbeg;
                        c.seeds.push_back(s);
                        c.is_alt = ann_alt[rid] ? 1 : 0;
                        size_t idx = std::upper_bound(
                            keys.begin(), keys.end(), s.rbeg)
                            - keys.begin();
                        keys.insert(keys.begin() + idx, s.rbeg);
                        chains.insert(chains.begin() + idx,
                                      std::move(c));
                    }
                }
            }
            for (Chain& c : chains)
                c.frac_rep = (double)l_rep / (double)l_query;
            chain_flt(o, chains);
            flt_chained_seeds(o, bnt, l_query, q, chains);
        }
        chain_cnt[ri] = (int32_t)chains.size();
        for (Chain& c : chains) {
            if (nc >= mc) return -1;
            chain_meta[nc * 3] = c.rid;
            chain_meta[nc * 3 + 1] = c.is_alt;
            chain_meta[nc * 3 + 2] = (i64)c.seeds.size();
            chain_fr[nc] = c.frac_rep;
            ++nc;
            for (const Seed& s : c.seeds) {
                if (nsd >= ms) return -1;
                seeds_out[nsd * 4] = s.rbeg;
                seeds_out[nsd * 4 + 1] = s.qbeg;
                seeds_out[nsd * 4 + 2] = s.len;
                seeds_out[nsd * 4 + 3] = s.score;
                ++nsd;
            }
        }
    }
    return 0;
}

}  // extern "C"

// ---- native extension planner (bwamem.c:mem_chain2aln/~700 +
// mem_sort_dedup_patch/~560; port of host/regions.py:extension_plan /
// sort_dedup_patch) ----------------------------------------------------
//
// The Python wave dispatcher advanced one generator per read, paying
// interpreter time per seed per wave; this context does the chaining
// (reusing the code above), the per-seed skip test, the fused-row
// consumption, the oversize scalar fallback (native ksw_extend), and
// the region dedup/patch — Python only shuttles the descriptor arrays
// to the device and the result rows back.

namespace {

struct PlanOpt {
    i64 a, o_del, e_del, o_ins, e_ins, w, pen_clip5, pen_clip3, zdrop,
        max_chain_gap, min_seed_len, min_chain_weight, max_chain_extend,
        max_occ, qmax, tmax;
    double mask_level, drop_ratio, mask_level_redun;
    const int32_t* mat;

    i64 max_gap(i64 qlen) const {  // cal_max_gap (bwamem.c:~650)
        i64 l_del = (i64)((double)(qlen * a - o_del) / (double)e_del
                          + 1.0);
        i64 l_ins = (i64)((double)(qlen * a - o_ins) / (double)e_ins
                          + 1.0);
        i64 l = mx(mx(l_del, l_ins), (i64)1);
        return mn(l, w << 1);
    }
};

struct ChainState {
    Chain ch;
    i64 rmax0 = 0, rmax1 = 0;
    std::vector<int> srt;       // seed indexes by (score, idx) asc
    std::vector<char> alive;
    int k = -1;                 // current srt position (descending)
    std::vector<int> rowidx;    // speculative mode: seed -> device row
};

struct ReadState {
    std::vector<ChainState> chains;
    size_t ci = 0;
    std::vector<Reg> av;
    bool done = false;
};

struct PlanCtx {
    PlanOpt o;
    Bnt bnt;
    std::vector<const u8*> qs;
    std::vector<i64> ql;
    std::vector<ReadState> reads;
    // jobs of the outstanding wave: (read, seed_idx)
    std::vector<std::pair<int, int>> wave;
    bool error = false;
};

// mirrors regions.py:extension_plan's fused-row consumption: row is
// the packed [16] int32 result (extend_fused.py layout)
void consume_row(const PlanOpt& o, ChainState& cs, const Seed& s,
                 i64 l_query, const int32_t* row,
                 std::vector<Reg>& av) {
    Reg a{};
    a.rid = cs.ch.rid;
    a.w = o.w;
    a.score = -1; a.truesc = -1;
    a.secondary = -1; a.secondary_all = -1;
    a.n_comp = 1;
    a.frac_rep = cs.ch.frac_rep;
    i64 aw0 = o.w, aw1 = o.w;
    i64 qe = s.qbeg + s.len;
    i64 re_off = s.rbeg + s.len - cs.rmax0;
    i64 qlen_r = l_query - qe;
    if (s.qbeg) {
        a.score = row[0];
        i64 qle = row[1], tle = row[2], gtle = row[3], gscore = row[4];
        aw0 = row[12];
        if (gscore <= 0 || gscore <= a.score - o.pen_clip5) {
            a.qb = s.qbeg - qle;
            a.rb = s.rbeg - tle;
            a.truesc = a.score;
        } else {
            a.qb = 0;
            a.rb = s.rbeg - gtle;
            a.truesc = gscore;
        }
    } else {
        a.score = a.truesc = s.len * o.a;
        a.qb = 0;
        a.rb = s.rbeg;
    }
    if (qlen_r) {
        i64 sc0 = a.score;
        a.score = row[6];
        i64 qle = row[7], tle = row[8], gtle = row[9], gscore = row[10];
        aw1 = row[13];
        if (gscore <= 0 || gscore <= a.score - o.pen_clip3) {
            a.qe = qe + qle;
            a.re = cs.rmax0 + re_off + tle;
            a.truesc += a.score - sc0;
        } else {
            a.qe = l_query;
            a.re = cs.rmax0 + re_off + gtle;
            a.truesc += gscore - sc0;
        }
    } else {
        a.qe = l_query;
        a.re = s.rbeg + s.len;
    }
    a.seedcov = 0;
    for (const Seed& t : cs.ch.seeds)
        if (t.qbeg >= a.qb && t.qbeg + t.len <= a.qe
                && t.rbeg >= a.rb && t.rbeg + t.len <= a.re)
            a.seedcov += t.len;
    a.w = mx(aw0, aw1);
    a.seedlen0 = s.len;
    av.push_back(a);
}

// native scalar_fused (extend_fused.py:scalar_fused): the oversize
// fallback — upstream trial loops with the native ksw_extend
void scalar_fused_row(const PlanCtx* ctx, const ChainState& cs,
                      const Seed& s, const u8* query, i64 l_query,
                      int32_t* row) {
    const PlanOpt& o = ctx->o;
    for (int i = 0; i < 16; ++i) row[i] = 0;
    i64 qe = s.qbeg + s.len;
    i64 qlen_r = l_query - qe;
    int32_t score = -1;
    i64 aw0 = o.w, aw1 = o.w;
    int32_t out6[6];
    if (s.qbeg) {
        std::vector<u8> qsv(query, query + s.qbeg);
        std::reverse(qsv.begin(), qsv.end());
        i64 tlen_l = s.rbeg - cs.rmax0;
        std::vector<u8> tsv = ctx->bnt.get_seq(cs.rmax0, s.rbeg);
        std::reverse(tsv.begin(), tsv.end());
        (void)tlen_l;
        for (int trial = 0; trial < 2; ++trial) {
            int32_t prev = score;
            aw0 = o.w << trial;
            tpubwa_ksw_extend((int32_t)s.qbeg, qsv.data(),
                              (int32_t)tsv.size(), tsv.data(), 5,
                              o.mat, (int32_t)o.o_del, (int32_t)o.e_del,
                              (int32_t)o.o_ins, (int32_t)o.e_ins,
                              (int32_t)aw0, (int32_t)o.pen_clip5,
                              (int32_t)o.zdrop,
                              (int32_t)(s.len * o.a), out6);
            score = out6[0];
            for (int i = 0; i < 6; ++i) row[i] = out6[i];
            if (score == prev
                    || out6[5] < (aw0 >> 1) + (aw0 >> 2)) break;
        }
    }
    int32_t sc0 = s.qbeg ? score : (int32_t)(s.len * o.a);
    score = sc0;
    if (qlen_r) {
        std::vector<u8> tsv = ctx->bnt.get_seq(s.rbeg + s.len,
                                               cs.rmax1);
        for (int trial = 0; trial < 2; ++trial) {
            int32_t prev = score;
            aw1 = o.w << trial;
            tpubwa_ksw_extend((int32_t)qlen_r, query + qe,
                              (int32_t)tsv.size(), tsv.data(), 5,
                              o.mat, (int32_t)o.o_del, (int32_t)o.e_del,
                              (int32_t)o.o_ins, (int32_t)o.e_ins,
                              (int32_t)aw1, (int32_t)o.pen_clip3,
                              (int32_t)o.zdrop, sc0, out6);
            score = out6[0];
            for (int i = 0; i < 6; ++i) row[6 + i] = out6[i];
            if (score == prev
                    || out6[5] < (aw1 >> 1) + (aw1 >> 2)) break;
        }
    }
    row[12] = (int32_t)aw0;
    row[13] = (int32_t)aw1;
    row[14] = sc0;
    row[15] = score;
}

// mem_patch_reg (regions.py:patch_reg)
void patch_reg_n(const PlanCtx* ctx, const u8* query, const Reg& a,
                 const Reg& b, i64* score_out, i64* w_out) {
    const PlanOpt& o = ctx->o;
    *score_out = 0; *w_out = 0;
    i64 l_pac = ctx->bnt.l_pac;
    if (a.rb < l_pac && b.rb >= l_pac) return;
    if (a.qb >= b.qb || a.qe >= b.qe || a.re >= b.re) return;
    i64 w = (a.re - b.rb) - (a.qe - b.qb);
    if (w < 0) w = -w;
    double r = (double)(a.re - b.rb) / (double)(b.re - a.rb)
             - (double)(a.qe - b.qb) / (double)(b.qe - a.qb);
    if (r < 0) r = -r;
    if (a.re < b.rb || a.qe < b.qb) {
        if (w > (o.w << 1) || r >= 0.05) return;
    } else if (w > (o.w << 2) || r >= 0.10) {
        return;
    }
    w += mx(a.w, b.w);
    w = mn(w, o.w << 2);
    i64 rb = a.rb, re = b.re;
    int rid; i64 cb, ce;
    ctx->bnt.fetch_bounds(rb, (rb + re) >> 1, re, &rid, &cb, &ce);
    if (ce - cb != b.re - a.rb) return;
    std::vector<u8> rseq = ctx->bnt.get_seq(cb, ce);
    std::vector<u8> qv(query + a.qb, query + b.qe);
    int32_t sc = 0;
    int32_t n_cig = 0;
    tpubwa_ksw_global(
        (int32_t)(b.qe - a.qb), qv.data(), (int32_t)(ce - cb),
        rseq.data(), 5, o.mat, (int32_t)o.o_del, (int32_t)o.e_del,
        (int32_t)o.o_ins, (int32_t)o.e_ins, (int32_t)w,
        /*want_cigar=*/0, &sc, nullptr, 0, &n_cig);
    i64 q_s = (i64)((double)(b.qe - a.qb)
                    / (double)((b.qe - b.qb) + (a.qe - a.qb))
                    * (double)(b.score + a.score) + 0.499);
    i64 r_s = (i64)((double)(b.re - a.rb)
                    / (double)((b.re - b.rb) + (a.re - a.rb))
                    * (double)(b.score + a.score) + 0.499);
    if ((double)sc / (double)mx(q_s, r_s) < 0.90) return;
    *score_out = sc;
    *w_out = w;
}

// mem_sort_dedup_patch (regions.py:sort_dedup_patch)
void sort_dedup_patch_n(const PlanCtx* ctx, const u8* query,
                        std::vector<Reg>& regs) {
    const PlanOpt& o = ctx->o;
    size_t n = regs.size();
    if (n <= 1) return;
    std::stable_sort(regs.begin(), regs.end(),
                     [](const Reg& x, const Reg& y) {
                         return x.re < y.re;
                     });
    for (Reg& p : regs) p.n_comp = 1;
    for (size_t i = 1; i < n; ++i) {
        Reg& p = regs[i];
        if (p.rid != regs[i - 1].rid
                || p.rb >= regs[i - 1].re + o.max_chain_gap)
            continue;
        for (i64 j = (i64)i - 1; j >= 0; --j) {
            Reg& q = regs[(size_t)j];
            if (p.rid != q.rid || p.rb >= q.re + o.max_chain_gap)
                break;
            if (q.qe == q.qb) continue;  // excluded
            i64 or_ = q.re - p.rb;
            i64 oq = (q.qb < p.qb) ? (q.qe - p.qb) : (p.qe - q.qb);
            i64 mr = mn(q.re - q.rb, p.re - p.rb);
            i64 mq = mn(q.qe - q.qb, p.qe - p.qb);
            if ((double)or_ > o.mask_level_redun * (double)mr
                    && (double)oq > o.mask_level_redun * (double)mq) {
                if (p.score < q.score) { p.qe = p.qb; break; }
                q.qe = q.qb;
            } else if (q.rb < p.rb) {
                i64 sc, w;
                patch_reg_n(ctx, query, q, p, &sc, &w);
                if (sc > 0) {
                    p.n_comp += q.n_comp + 1;
                    p.seedcov = mx(p.seedcov, q.seedcov);
                    p.sub = mx(p.sub, q.sub);
                    p.csub = mx(p.csub, q.csub);
                    p.qb = q.qb; p.rb = q.rb;
                    p.truesc = p.score = sc;
                    p.w = w;
                    q.qe = q.qb;
                }
            }
        }
    }
    regs.erase(std::remove_if(regs.begin(), regs.end(),
                              [](const Reg& r) {
                                  return r.qe <= r.qb;
                              }), regs.end());
    std::stable_sort(regs.begin(), regs.end(),
                     [](const Reg& x, const Reg& y) {
                         if (x.score != y.score)
                             return x.score > y.score;
                         if (x.rb != y.rb) return x.rb < y.rb;
                         return x.qb < y.qb;
                     });
    for (size_t i = 1; i < regs.size(); ++i)
        if (regs[i].score == regs[i - 1].score
                && regs[i].rb == regs[i - 1].rb
                && regs[i].qb == regs[i - 1].qb)
            regs[i].qe = regs[i].qb;
    regs.erase(std::remove_if(regs.begin(), regs.end(),
                              [](const Reg& r) {
                                  return r.qe <= r.qb;
                              }), regs.end());
}

// skip test of mem_chain2aln (regions.py:extension_plan head)
bool seed_skippable(const PlanOpt& o, const ChainState& cs,
                    const Seed& s, i64 l_query,
                    const std::vector<Reg>& av, int k) {
    int hit = -1;
    for (size_t i = 0; i < av.size(); ++i) {
        const Reg& p = av[i];
        if (s.rbeg < p.rb || s.rbeg + s.len > p.re || s.qbeg < p.qb
                || s.qbeg + s.len > p.qe)
            continue;
        if ((double)(s.len - p.seedlen0) > 0.1 * (double)l_query)
            continue;
        i64 qd = s.qbeg - p.qb, rd = s.rbeg - p.rb;
        i64 w = mn(o.max_gap(mn(qd, rd)), p.w);
        if (qd - rd < w && rd - qd < w) { hit = (int)i; break; }
        qd = p.qe - (s.qbeg + s.len);
        rd = p.re - (s.rbeg + s.len);
        w = mn(o.max_gap(mn(qd, rd)), p.w);
        if (qd - rd < w && rd - qd < w) { hit = (int)i; break; }
    }
    if (hit < 0) return false;
    // contained: extend only if a long-enough overlapping seed in this
    // chain disagrees on the diagonal
    for (size_t i2 = (size_t)k + 1; i2 < cs.srt.size(); ++i2) {
        if (!cs.alive[(size_t)cs.srt[i2]]) continue;
        const Seed& t = cs.ch.seeds[(size_t)cs.srt[i2]];
        if ((double)t.len < (double)s.len * 0.95) continue;
        if (s.qbeg <= t.qbeg
                && s.qbeg + s.len - t.qbeg >= (s.len >> 2)
                && t.qbeg - s.qbeg != t.rbeg - s.rbeg)
            return false;
        if (t.qbeg <= s.qbeg
                && t.qbeg + t.len - s.qbeg >= (s.len >> 2)
                && s.qbeg - t.qbeg != s.rbeg - t.rbeg)
            return false;
    }
    return true;
}

}  // namespace

extern "C" {

// civ2: a,o_del,e_del,o_ins,e_ins,w,pen_clip5,pen_clip3,zdrop,
//       max_chain_gap,min_seed_len,min_chain_weight,max_chain_extend,
//       max_occ,qmax,tmax
// cdv2: mask_level, drop_ratio, mask_level_redun
void* tpubwa_plan_init(
    const i64* civ2, const double* cdv2, const int32_t* mat,
    const u8* codes, i64 l_pac, int32_t n_anns, const i64* ann_off,
    const i64* ann_len, const u8* ann_alt, const char* name_blob,
    const i64* name_off,
    i64 n_reads, const u8* seq_blob, const i64* seq_off,
    const i64* intv, const i64* intv_off, const i64* pos,
    const i64* pos_off) {
    PlanCtx* ctx = new PlanCtx();
    PlanOpt& o = ctx->o;
    o.a = civ2[0]; o.o_del = civ2[1]; o.e_del = civ2[2];
    o.o_ins = civ2[3]; o.e_ins = civ2[4]; o.w = civ2[5];
    o.pen_clip5 = civ2[6]; o.pen_clip3 = civ2[7]; o.zdrop = civ2[8];
    o.max_chain_gap = civ2[9]; o.min_seed_len = civ2[10];
    o.min_chain_weight = civ2[11]; o.max_chain_extend = civ2[12];
    o.max_occ = civ2[13]; o.qmax = civ2[14]; o.tmax = civ2[15];
    o.mask_level = cdv2[0]; o.drop_ratio = cdv2[1];
    o.mask_level_redun = cdv2[2];
    o.mat = mat;
    ctx->bnt = Bnt{codes, l_pac, n_anns, ann_off, ann_len, ann_alt,
                   name_blob, name_off};
    ctx->reads.resize((size_t)n_reads);
    ctx->qs.resize((size_t)n_reads);
    ctx->ql.resize((size_t)n_reads);

    // run the existing chain stage (same code path as
    // tpubwa_chain_batch, but keeping the Chain objects in C++)
    i64 civ[11] = {o.a, o.o_del, o.e_del, o.o_ins, o.e_ins, o.w,
                   o.max_chain_gap, o.min_seed_len, o.min_chain_weight,
                   o.max_chain_extend, o.max_occ};
    double cdv[2] = {o.mask_level, o.drop_ratio};
    i64 n_pos = pos_off[intv_off[n_reads]];
    i64 mc = mx(n_pos + 8, (i64)64), ms = mx(n_pos + 8, (i64)64);
    std::vector<int32_t> chain_cnt((size_t)n_reads);
    std::vector<i64> chain_meta((size_t)(mc * 3));
    std::vector<double> chain_fr((size_t)mc);
    std::vector<i64> seeds_flat((size_t)(ms * 4));
    int rc = tpubwa_chain_batch(
        civ, cdv, mat, codes, l_pac, n_anns, ann_off, ann_len, ann_alt,
        name_blob, name_off, n_reads, seq_blob, seq_off, intv,
        intv_off, pos, pos_off, chain_cnt.data(), chain_meta.data(),
        chain_fr.data(), mc, seeds_flat.data(), ms);
    if (rc != 0) { delete ctx; return nullptr; }

    i64 l_pac2 = l_pac << 1;
    i64 nc = 0, nsd = 0;
    for (i64 ri = 0; ri < n_reads; ++ri) {
        ReadState& rs = ctx->reads[(size_t)ri];
        const u8* q = seq_blob + seq_off[ri];
        i64 l_query = seq_off[ri + 1] - seq_off[ri];
        ctx->qs[(size_t)ri] = q;
        ctx->ql[(size_t)ri] = l_query;
        for (int c = 0; c < chain_cnt[(size_t)ri]; ++c) {
            ChainState cs;
            cs.ch.rid = (int)chain_meta[(size_t)(nc * 3)];
            cs.ch.is_alt = (int)chain_meta[(size_t)(nc * 3 + 1)];
            i64 n_seeds = chain_meta[(size_t)(nc * 3 + 2)];
            cs.ch.frac_rep = chain_fr[(size_t)nc];
            ++nc;
            for (i64 t = 0; t < n_seeds; ++t) {
                const i64* sp = seeds_flat.data() + nsd * 4;
                cs.ch.seeds.push_back(
                    Seed{sp[0], sp[1], sp[2], sp[3]});
                ++nsd;
            }
            if (cs.ch.seeds.empty()) continue;
            // rmax window (extension_plan head)
            i64 rmax0 = l_pac2, rmax1 = 0;
            for (const Seed& t : cs.ch.seeds) {
                i64 b = t.rbeg - (t.qbeg + o.max_gap(t.qbeg));
                i64 e = t.rbeg + t.len + (l_query - t.qbeg - t.len)
                        + o.max_gap(l_query - t.qbeg - t.len);
                rmax0 = mn(rmax0, b);
                rmax1 = mx(rmax1, e);
            }
            rmax0 = mx(rmax0, (i64)0);
            rmax1 = mn(rmax1, l_pac2);
            if (rmax0 < l_pac && l_pac < rmax1) {
                if (cs.ch.seeds[0].rbeg < l_pac) rmax1 = l_pac;
                else rmax0 = l_pac;
            }
            int rid; i64 cb, ce;
            ctx->bnt.fetch_bounds(rmax0, cs.ch.seeds[0].rbeg, rmax1,
                                  &rid, &cb, &ce);
            if (rid != cs.ch.rid) ctx->error = true;
            cs.rmax0 = cb;
            cs.rmax1 = ce;
            cs.srt.resize(cs.ch.seeds.size());
            for (size_t i = 0; i < cs.srt.size(); ++i)
                cs.srt[i] = (int)i;
            std::stable_sort(cs.srt.begin(), cs.srt.end(),
                             [&cs](int x, int y) {
                                 return cs.ch.seeds[(size_t)x].score
                                      < cs.ch.seeds[(size_t)y].score;
                             });
            cs.alive.assign(cs.ch.seeds.size(), 1);
            cs.k = (int)cs.srt.size() - 1;
            rs.chains.push_back(std::move(cs));
        }
    }
    if (ctx->error) { delete ctx; return nullptr; }
    return ctx;
}

// Emit up to one descriptor per read: desc_out rows of 11 i64
// (read_row, qbeg, slen, l_query, rbeg, rmax0, rmax1, w, h0, pen5,
// pen3).  Oversize and both-sides-empty seeds are resolved inline
// (native scalar / direct).  Returns the wave size (0 = all done),
// or -1 when cap is too small.
i64 tpubwa_plan_next_wave(void* h, i64* desc_out, i64 cap) {
    PlanCtx* ctx = (PlanCtx*)h;
    const PlanOpt& o = ctx->o;
    ctx->wave.clear();
    i64 n = 0;
    for (size_t ri = 0; ri < ctx->reads.size(); ++ri) {
        ReadState& rs = ctx->reads[ri];
        if (rs.done) continue;
        const u8* query = ctx->qs[ri];
        i64 l_query = ctx->ql[ri];
        bool emitted = false;
        while (!emitted) {
            if (rs.ci >= rs.chains.size()) {
                rs.done = true;
                break;
            }
            ChainState& cs = rs.chains[rs.ci];
            if (cs.k < 0) { ++rs.ci; continue; }
            int si = cs.srt[(size_t)cs.k];
            const Seed& s = cs.ch.seeds[(size_t)si];
            if (seed_skippable(o, cs, s, l_query, rs.av, cs.k)) {
                cs.alive[(size_t)si] = 0;
                --cs.k;
                continue;
            }
            i64 qe = s.qbeg + s.len;
            i64 qlen_r = l_query - qe;
            i64 tlen_l = s.qbeg ? (s.rbeg - cs.rmax0) : 0;
            i64 tlen_r = qlen_r ? (cs.rmax1 - s.rbeg - s.len) : 0;
            if (s.qbeg == 0 && qlen_r == 0) {
                // both sides empty: no DP needed
                int32_t row[16] = {0};
                consume_row(o, cs, s, l_query, row, rs.av);
                --cs.k;
                continue;
            }
            if (s.qbeg > o.qmax || qlen_r > o.qmax || tlen_l > o.tmax
                    || tlen_r > o.tmax) {
                int32_t row[16];
                scalar_fused_row(ctx, cs, s, query, l_query, row);
                consume_row(o, cs, s, l_query, row, rs.av);
                --cs.k;
                continue;
            }
            if (n >= cap) return -1;  // caller re-sizes
            i64* d = desc_out + n * 11;
            d[0] = (i64)ri; d[1] = s.qbeg; d[2] = s.len;
            d[3] = l_query; d[4] = s.rbeg; d[5] = cs.rmax0;
            d[6] = cs.rmax1; d[7] = o.w; d[8] = s.len * o.a;
            d[9] = o.pen_clip5; d[10] = o.pen_clip3;
            ++n;
            ctx->wave.emplace_back((int)ri, si);
            emitted = true;
        }
    }
    return n;
}

// Speculative mode (regions.py:extension_plan invariant): a seed's
// fused-extension result depends only on (seed, chain window) — the
// wave-order dependency through av only gates which results are
// CONSUMED.  After the exact first wave, emit every remaining
// device-eligible seed that is not skippable against the CURRENT av
// in one batch, then replay the exact plan order against the
// precomputed rows in tpubwa_plan_feed_spec.
//
// Safety: skippability is monotone in av (regions are only appended,
// so "contained in an existing region" only grows) and monotone in
// seed deaths (the disagreeing-seed rescue only needs alive seeds,
// which only die) — a seed NOT skippable at replay time was not
// skippable here either, so the emitted set is a superset of what the
// replay consumes.  Skipped seeds' rows are discarded; oversize /
// no-DP seeds resolve at replay time in plan order, exactly as the
// wave loop would.  Speculating from the START instead (empty av)
// emitted ~3x the consumed jobs (measured) — the first wave's regions
// are what make the skip filter selective.
i64 tpubwa_plan_spec_jobs(void* h, i64* desc_out, i64 cap) {
    PlanCtx* ctx = (PlanCtx*)h;
    const PlanOpt& o = ctx->o;
    i64 n = 0;
    for (size_t ri = 0; ri < ctx->reads.size(); ++ri) {
        ReadState& rs = ctx->reads[ri];
        i64 l_query = ctx->ql[ri];
        for (size_t ci = rs.ci; ci < rs.chains.size(); ++ci) {
            ChainState& cs = rs.chains[ci];
            cs.rowidx.assign(cs.ch.seeds.size(), -1);
            for (int k = cs.k; k >= 0; --k) {
                int si = cs.srt[(size_t)k];
                const Seed& s = cs.ch.seeds[(size_t)si];
                // filter only — do NOT mutate alive/k/ci (the replay
                // re-runs the tests with the true evolving state)
                if (seed_skippable(o, cs, s, l_query, rs.av, k))
                    continue;
                i64 qe = s.qbeg + s.len;
                i64 qlen_r = l_query - qe;
                i64 tlen_l = s.qbeg ? (s.rbeg - cs.rmax0) : 0;
                i64 tlen_r = qlen_r ? (cs.rmax1 - s.rbeg - s.len) : 0;
                if (s.qbeg == 0 && qlen_r == 0) continue;
                if (s.qbeg > o.qmax || qlen_r > o.qmax
                        || tlen_l > o.tmax || tlen_r > o.tmax)
                    continue;
                if (n >= cap) return -1;  // caller re-sizes
                i64* d = desc_out + n * 11;
                d[0] = (i64)ri; d[1] = s.qbeg; d[2] = s.len;
                d[3] = l_query; d[4] = s.rbeg; d[5] = cs.rmax0;
                d[6] = cs.rmax1; d[7] = o.w; d[8] = s.len * o.a;
                d[9] = o.pen_clip5; d[10] = o.pen_clip3;
                cs.rowidx[si] = (int)n;
                ++n;
            }
        }
    }
    return n;
}

// rows: int32 [n, 16] in tpubwa_plan_spec_jobs order; runs the whole
// plan (skip tests, consumption, scalar fallbacks) to completion
void tpubwa_plan_feed_spec(void* h, const int32_t* rows) {
    PlanCtx* ctx = (PlanCtx*)h;
    const PlanOpt& o = ctx->o;
    for (size_t ri = 0; ri < ctx->reads.size(); ++ri) {
        ReadState& rs = ctx->reads[ri];
        if (rs.done) continue;
        const u8* query = ctx->qs[ri];
        i64 l_query = ctx->ql[ri];
        for (; rs.ci < rs.chains.size(); ++rs.ci) {
            ChainState& cs = rs.chains[rs.ci];
            for (; cs.k >= 0; --cs.k) {
                int si = cs.srt[(size_t)cs.k];
                const Seed& s = cs.ch.seeds[(size_t)si];
                if (seed_skippable(o, cs, s, l_query, rs.av, cs.k)) {
                    cs.alive[(size_t)si] = 0;
                    continue;
                }
                i64 qe = s.qbeg + s.len;
                i64 qlen_r = l_query - qe;
                if (s.qbeg == 0 && qlen_r == 0) {
                    int32_t row[16] = {0};
                    consume_row(o, cs, s, l_query, row, rs.av);
                    continue;
                }
                int idx = cs.rowidx[(size_t)si];
                if (idx >= 0) {
                    consume_row(o, cs, s, l_query,
                                rows + (i64)idx * 16, rs.av);
                } else {
                    int32_t row[16];
                    scalar_fused_row(ctx, cs, s, query, l_query, row);
                    consume_row(o, cs, s, l_query, row, rs.av);
                }
            }
        }
        rs.done = true;
    }
}

// rows: int32 [wave_n, 16] device results, in wave order
void tpubwa_plan_feed(void* h, const int32_t* rows) {
    PlanCtx* ctx = (PlanCtx*)h;
    for (size_t j = 0; j < ctx->wave.size(); ++j) {
        int ri = ctx->wave[j].first;
        int si = ctx->wave[j].second;
        ReadState& rs = ctx->reads[(size_t)ri];
        ChainState& cs = rs.chains[rs.ci];
        consume_row(ctx->o, cs, cs.ch.seeds[(size_t)si],
                    ctx->ql[(size_t)ri], rows + j * 16, rs.av);
        --cs.k;
    }
    ctx->wave.clear();
}

// finalize: per-read sort_dedup_patch + ALT flag; writes reg_cnt
// [n_reads], reg_iv [cap, 18] (native_emit._REG_FIELDS order) and
// reg_fr [cap].  Returns total rows, or -total if cap is too small.
i64 tpubwa_plan_regions(void* h, int32_t* reg_cnt, i64* reg_iv,
                        double* reg_fr, i64 cap) {
    PlanCtx* ctx = (PlanCtx*)h;
    i64 total = 0;
    for (size_t ri = 0; ri < ctx->reads.size(); ++ri) {
        ReadState& rs = ctx->reads[ri];
        sort_dedup_patch_n(ctx, ctx->qs[ri], rs.av);
        for (Reg& r : rs.av)
            if (r.rid >= 0 && ctx->bnt.ann_alt[r.rid]) r.is_alt = 1;
        total += (i64)rs.av.size();
    }
    if (total > cap) return -total;
    i64 k = 0;
    for (size_t ri = 0; ri < ctx->reads.size(); ++ri) {
        ReadState& rs = ctx->reads[ri];
        reg_cnt[ri] = (int32_t)rs.av.size();
        for (const Reg& r : rs.av) {
            i64* p = reg_iv + k * 18;
            p[0] = r.rb; p[1] = r.re; p[2] = r.qb; p[3] = r.qe;
            p[4] = r.rid; p[5] = r.score; p[6] = r.truesc;
            p[7] = r.sub; p[8] = r.alt_sc; p[9] = r.csub;
            p[10] = r.sub_n; p[11] = r.w; p[12] = r.seedcov;
            p[13] = r.secondary; p[14] = r.secondary_all;
            p[15] = r.seedlen0; p[16] = r.n_comp; p[17] = r.is_alt;
            reg_fr[k] = r.frac_rep;
            ++k;
        }
    }
    return total;
}

void tpubwa_plan_free(void* h) {
    delete (PlanCtx*)h;
}

}  // extern "C"
