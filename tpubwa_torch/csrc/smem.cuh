// SMEM seeding device functions (bwt.c:bwt_smem1a and
// bwt_seed_strategy1), one read a thread, over the FM-index functions of
// csrc/fm.cuh (set_intv, bwt_extend), for the seeding kernels of
// csrc/smem.cu.  They follow the port's native scalar seeder step for
// step (tpubwa_torch/native/smem.cpp smem1a :235-318, seed_strategy1
// :321-344), and so bwa's scalar protocol, not the lockstep machines of
// tpubwa/device/smem_fused.py.
//
// An interval is five Idx: (x0, x1, size, qb, qe), the layout of a seeding
// row.  smem1a keeps its three stacks (curr, prev and the call's output)
// in memory the caller gives it: a call on a read of len bases pushes at
// most len - x intervals forward, never more than it had onto a backward
// stack, and emits rows of distinct qe in (x, len], so len + 1 intervals
// a stack always suffice and no bound can be passed.
//
// Like fm.cuh, the file compiles as plain C++ with TPUBWA_WARP_HOST
// defined (csrc/smem_host.cpp).

#pragma once

#include <cstdint>

#include "fm.cuh"

namespace seed {

template <class Idx>
struct Intv {
    Idx x0, x1, size, qb, qe;
};

// the one-base interval of code c, qb = qe = 0
template <class Idx>
__device__ __forceinline__ Intv<Idx> set_intv(const fm::Index<Idx>& f,
                                              int c) {
    Idx ik[3];
    fm::set_intv(f, c, ik);
    return Intv<Idx>{ik[0], ik[1], ik[2], 0, 0};
}

// ik extended by base c (the base in the extension's direction), qb and qe
// kept; counts the bwt_extend calls in steps
template <class Idx, bool IsBack>
__device__ __forceinline__ Intv<Idx> extend(const fm::Index<Idx>& f,
                                            const Intv<Idx>& ik, int c,
                                            int& steps) {
    const Idx in[3] = {ik.x0, ik.x1, ik.size};
    Idx ok[4][3];
    fm::bwt_extend<Idx, IsBack>(f, in, ok);
    ++steps;
    return Intv<Idx>{ok[c][0], ok[c][1], ok[c][2], ik.qb, ik.qe};
}

template <class Idx>
__device__ __forceinline__ void reverse(Intv<Idx>* a, int n) {
    for (int i = 0, j = n - 1; i < j; ++i, --j) {
        const Intv<Idx> t = a[i];
        a[i] = a[j];
        a[j] = t;
    }
}

// bwt_smem1a with max_intv = 0, as mem_collect_intv calls it in rounds 1
// and 2 (bwa's max_intv branches never run there): the SMEMs of q[0, len)
// that cover x, of at least min_intv occurrences, into mem[0, n_mem) by
// query start.  curr and prev are stacks of len + 1 intervals, mem holds
// len + 1.  Returns the next x.
template <class Idx>
__device__ int smem1a(const fm::Index<Idx>& f, const uint8_t* q, int len,
                      int x, Idx min_intv, Intv<Idx>* curr, Intv<Idx>* prev,
                      Intv<Idx>* mem, int& n_mem, int& steps) {
    n_mem = 0;
    if (q[x] > 3) return x + 1;
    if (min_intv < 1) min_intv = 1;
    Intv<Idx> ik = set_intv(f, q[x]);
    ik.qe = x + 1;
    // forward: push the interval each time the next base shrinks it
    int n_curr = 0, i = x + 1;
    for (; i < len; ++i) {
        if (q[i] > 3) {
            curr[n_curr++] = ik;
            break;
        }
        // forward extension reads the complement's slot
        const Intv<Idx> ok = extend<Idx, false>(f, ik, 3 - q[i], steps);
        if (ok.size != ik.size) {
            curr[n_curr++] = ik;
            if (ok.size < min_intv) break;
        }
        ik = ok;
        ik.qe = i + 1;
    }
    if (i == len) curr[n_curr++] = ik;
    reverse(curr, n_curr);  // longest matches (smallest intervals) first
    const int ret = (int)curr[0].qe;
    // backward: extend every interval of the stack by q[i]; one that can
    // go no further is an SMEM unless a longer one already ended here
    Intv<Idx>* t = prev;
    prev = curr;
    curr = t;
    int n_prev = n_curr;
    for (i = x - 1; i >= -1; --i) {
        const int c = (i < 0 || q[i] > 3) ? -1 : q[i];
        n_curr = 0;
        for (int j = 0; j < n_prev; ++j) {
            const Intv<Idx> p = prev[j];
            Intv<Idx> ok{};
            if (c >= 0) ok = extend<Idx, true>(f, p, c, steps);
            if (c < 0 || ok.size < min_intv) {
                if (n_curr == 0 && (n_mem == 0 || i + 1 < mem[n_mem - 1].qb)) {
                    Intv<Idx> m = p;
                    m.qb = i + 1;
                    mem[n_mem++] = m;
                }
            } else if (n_curr == 0 || ok.size != curr[n_curr - 1].size) {
                curr[n_curr++] = ok;  // qb and qe kept from p
            }
        }
        if (n_curr == 0) break;
        t = prev;
        prev = curr;
        curr = t;
        n_prev = n_curr;
    }
    reverse(mem, n_mem);  // by query start
    return ret;
}

// bwt_seed_strategy1: from x forward until the interval falls below
// max_intv with at least min_len + 1 bases matched; that interval is *m
// (qb = x) and *got set.  Returns the next x.
template <class Idx>
__device__ int seed_strategy1(const fm::Index<Idx>& f, const uint8_t* q,
                              int len, int x, int min_len, Idx max_intv,
                              Intv<Idx>* m, bool* got, int& steps) {
    *got = false;
    if (q[x] > 3) return x + 1;
    Intv<Idx> ik = set_intv(f, q[x]);
    for (int i = x + 1; i < len; ++i) {
        if (q[i] > 3) return i + 1;
        const Intv<Idx> ok = extend<Idx, false>(f, ik, 3 - q[i], steps);
        if (ok.size < max_intv && i - x >= min_len) {
            *m = ok;
            m->qb = x;
            m->qe = i + 1;
            *got = true;
            return i + 1;
        }
        ik = ok;
    }
    return len;
}

}  // namespace seed
