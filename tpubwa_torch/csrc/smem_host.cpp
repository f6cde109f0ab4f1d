// csrc/smem.cu's kernels run on the host (warp_host.h), for tests, and to
// count the index rows a launch reads (chip_smoke.py's bound).
//
//   g++ -std=c++17 -O1 -g -fsanitize=address,undefined
//       -o smem_host smem_host.cpp    (one command)
//   smem_host IN OUT
//
// IN: int64 header (kernel: 0 for K2, tpubwa_smem_rounds12, 1 for K3,
// tpubwa_seed_strategy, 2 for K-cur, tpubwa_smem_jobs, 3 for K-fwd,
// tpubwa_smem_fwd, 4 for K-bwd, tpubwa_smem_bwd; n_blocks,
// primary, seq_len, idx64, B, L, n, min_seed_len, split_len,
// split_width, slots, max_intv, maxh, count_rows, reverse, sms,
// blocks_per_sm, n_slabs, peers, m), then occ uint32 [n_blocks, 12], L2
// of the rank type (int64 where idx64, else int32) [5], reads uint8 [B,
// L], lens int32 [B], for K2, rids int32 [n], and where n_slabs > 0 the
// slabs' first rows and devices, int64 [n_slabs] each; for K-cur, the m
// jobs' read int32, x0 int32, min_intv (the rank type) and one_shot
// uint8, [m] each, then ids int32 [n] (K-fwd likewise); for K-bwd, the n
// calls' read, x and m int32, off int64 and min_intv (the rank type),
// [n] each, then their stacks (the rank type) [m, 4].  OUT gets int64
// values: K2's or K-cur's rows [n, slots, 5], counts [n], steps [n] and
// chain [n]; K-fwd's stack [n, slots, 4], calls [n, slots, 3], n_calls
// [n], n_intv [n], steps [n] and chain [n]; K-bwd's rows [m, 5], counts
// [n], steps [n] and chain [n]; or K3's hits [B, maxh, 5], n_hits [B],
// steps [B], chain [B] and longest [B]; then,
// where count_rows, the number of distinct occ rows the launch read and
// those rows, ascending.  reverse runs each warp's lanes 31..0; sms and
// blocks_per_sm, where > 0, make the attribute and occupancy queries
// answer for a card of that many SMs holding that many blocks each (a
// capped grid, whose groups take several reads).  Every array is a heap
// block of
// its exact size (each warp's shared slice too, warp_host.h), and the
// outputs and the read queue start as -77 (K3's hits as zeros, as the
// wrapper allocates them), so a read past an array is the sanitizer's
// and a slot never written shows in the result.  A launch that returns
// an error (K2 refuses a read length whose stacks do not fit a block's
// shared memory) exits with 3.  n_slabs > 0 launches K2's TP
// instantiation (tpubwa_smem_rounds12_tp) on the occ rows cut into
// slabs at those first rows, each its own heap block, so a row read past
// a slab's end is the sanitizer's; peers 0 makes the peer-access query
// answer that no two devices reach each other.

#define TPUBWA_WARP_HOST
#include "smem.cu"

#include <algorithm>
#include <vector>

template <class T>
static std::vector<T> read_array(FILE* f, int64_t count) {
    std::vector<T> v((size_t)count);
    if (count && std::fread(v.data(), sizeof(T), (size_t)count, f) !=
                     (size_t)count)
        warp_host::die("short input");
    return v;
}

template <class T>
static void write_int64(FILE* o, const std::vector<T>& v) {
    const std::vector<int64_t> w(v.begin(), v.end());
    if (!w.empty()) std::fwrite(w.data(), sizeof(int64_t), w.size(), o);
}

template <class Idx>
static int run(FILE* f, FILE* o, const std::vector<int64_t>& h) {
    const int64_t kernel = h[0], n_blocks = h[1], primary = h[2],
                  seq_len = h[3], B = h[5], L = h[6], n = h[7],
                  split_width = h[10], max_intv = h[12];
    const int min_seed_len = (int)h[8], split_len = (int)h[9],
              slots = (int)h[11], maxh = (int)h[13];
    const auto occ = read_array<uint32_t>(f, n_blocks * 12);
    const auto L2 = read_array<Idx>(f, 5);
    const auto q = read_array<uint8_t>(f, B * L);
    const auto lens = read_array<int32_t>(f, B);
    std::vector<int64_t> rows_read;
    if (h[14]) fm::read_rows = &rows_read;
    warp_host::reverse = h[15] != 0;
    if (h[16] > 0) warp_host::sms = (int)h[16];
    if (h[17] > 0) warp_host::blocks_per_sm = (int)h[17];
    int rc;
    if (kernel == 2) {
        const int64_t m = h[20];
        const auto read = read_array<int32_t>(f, m);
        const auto x0 = read_array<int32_t>(f, m);
        const auto min_intv = read_array<Idx>(f, m);
        const auto one_shot = read_array<uint8_t>(f, m);
        const auto ids = read_array<int32_t>(f, n);
        std::vector<int32_t> queue(1, -77);
        std::vector<Idx> rows((size_t)(n * slots * 5), (Idx)-77);
        std::vector<int32_t> counts((size_t)n, -77), steps((size_t)n, -77),
            chain((size_t)n, -77);
        rc = tpubwa_smem_jobs(occ.data(), L2.data(), primary, seq_len,
                              sizeof(Idx) == 8, q.data(), L, lens.data(),
                              read.data(), x0.data(), min_intv.data(),
                              one_shot.data(), ids.data(), n, min_seed_len,
                              slots, queue.data(), rows.data(), counts.data(),
                              steps.data(), chain.data(), 0, nullptr);
        write_int64(o, rows);
        write_int64(o, counts);
        write_int64(o, steps);
        write_int64(o, chain);
    } else if (kernel == 3) {
        const int64_t m = h[20];
        const auto read = read_array<int32_t>(f, m);
        const auto x0 = read_array<int32_t>(f, m);
        const auto min_intv = read_array<Idx>(f, m);
        const auto one_shot = read_array<uint8_t>(f, m);
        const auto ids = read_array<int32_t>(f, n);
        std::vector<int32_t> queue(1, -77);
        std::vector<Idx> stack((size_t)(n * slots * 4), (Idx)-77);
        std::vector<int32_t> calls((size_t)(n * slots * 3), -77),
            n_calls((size_t)n, -77), n_intv((size_t)n, -77),
            steps((size_t)n, -77), chain((size_t)n, -77);
        rc = tpubwa_smem_fwd(occ.data(), L2.data(), primary, seq_len,
                             sizeof(Idx) == 8, q.data(), L, lens.data(),
                             read.data(), x0.data(), min_intv.data(),
                             one_shot.data(), ids.data(), n, slots,
                             queue.data(), stack.data(), calls.data(),
                             n_calls.data(), n_intv.data(), steps.data(),
                             chain.data(), 0, nullptr);
        write_int64(o, stack);
        write_int64(o, calls);
        write_int64(o, n_calls);
        write_int64(o, n_intv);
        write_int64(o, steps);
        write_int64(o, chain);
    } else if (kernel == 4) {
        const int64_t m = h[20];
        const auto read = read_array<int32_t>(f, n);
        const auto x = read_array<int32_t>(f, n);
        const auto call_m = read_array<int32_t>(f, n);
        const auto off = read_array<int64_t>(f, n);
        const auto min_intv = read_array<Idx>(f, n);
        const auto stack = read_array<Idx>(f, m * 4);
        std::vector<int32_t> queue(1, -77);
        std::vector<Idx> rows((size_t)(m * 5), (Idx)-77);
        std::vector<int32_t> counts((size_t)n, -77), steps((size_t)n, -77),
            chain((size_t)n, -77);
        rc = tpubwa_smem_bwd(occ.data(), L2.data(), primary, seq_len,
                             sizeof(Idx) == 8, q.data(), L, read.data(),
                             x.data(), call_m.data(), off.data(),
                             min_intv.data(), stack.data(), n, min_seed_len,
                             queue.data(), rows.data(), counts.data(),
                             steps.data(), chain.data(), 0, nullptr);
        write_int64(o, rows);
        write_int64(o, counts);
        write_int64(o, steps);
        write_int64(o, chain);
    } else if (kernel == 0) {
        const auto rids = read_array<int32_t>(f, n);
        const int n_slabs = (int)h[18];
        warp_host::peers = h[19] != 0;
        const auto first = read_array<int64_t>(f, n_slabs);
        const auto devices = read_array<int64_t>(f, n_slabs);
        const warp_host::Cut<uint32_t> occ_tp(occ, 12, first, devices);
        std::vector<int32_t> queue(1, -77);
        std::vector<Idx> rows((size_t)(n * slots * 5), (Idx)-77);
        std::vector<int32_t> counts((size_t)n, -77), steps((size_t)n, -77),
            chain((size_t)n, -77);
        rc = n_slabs
            ? tpubwa_smem_rounds12_tp(
                  n_slabs, occ_tp.table.data(), L2.data(), primary, seq_len,
                  sizeof(Idx) == 8, q.data(), L, lens.data(), rids.data(), n,
                  min_seed_len, split_len, split_width, slots, queue.data(),
                  rows.data(), counts.data(), steps.data(), chain.data(), 0,
                  nullptr)
            : tpubwa_smem_rounds12(occ.data(), L2.data(), primary, seq_len,
                                   sizeof(Idx) == 8, q.data(), L, lens.data(),
                                   rids.data(), n, min_seed_len, split_len,
                                   split_width, slots, queue.data(),
                                   rows.data(), counts.data(), steps.data(),
                                   chain.data(), 0, nullptr);
        write_int64(o, rows);
        write_int64(o, counts);
        write_int64(o, steps);
        write_int64(o, chain);
    } else {
        // zeros, as the wrapper allocates them
        std::vector<Idx> hits((size_t)(B * maxh * 5), (Idx)0);
        std::vector<int32_t> queue(1, -77), n_hits((size_t)B, -77),
            steps((size_t)B, -77), chain((size_t)B, -77),
            longest((size_t)B, -77);
        rc = tpubwa_seed_strategy(occ.data(), L2.data(), primary, seq_len,
                                  sizeof(Idx) == 8, q.data(), L, lens.data(),
                                  B, min_seed_len, max_intv, maxh,
                                  queue.data(), hits.data(), n_hits.data(),
                                  steps.data(), chain.data(), longest.data(),
                                  0, nullptr);
        write_int64(o, hits);
        write_int64(o, n_hits);
        write_int64(o, steps);
        write_int64(o, chain);
        write_int64(o, longest);
    }
    fm::read_rows = nullptr;
    if (rc != 0) {
        std::fprintf(stderr, "smem_host: kernel %ld returned %d\n",
                     (long)kernel, rc);
        return 3;
    }
    if (h[14]) {
        std::sort(rows_read.begin(), rows_read.end());
        rows_read.erase(std::unique(rows_read.begin(), rows_read.end()),
                        rows_read.end());
        const std::vector<int64_t> count{(int64_t)rows_read.size()};
        write_int64(o, count);
        write_int64(o, rows_read);
    }
    return 0;
}

int main(int argc, char** argv) {
    if (argc != 3) warp_host::die("usage: smem_host IN OUT");
    FILE* f = std::fopen(argv[1], "rb");
    if (!f) warp_host::die("cannot open IN");
    const std::vector<int64_t> h = read_array<int64_t>(f, 21);
    FILE* o = std::fopen(argv[2], "wb");
    if (!o) warp_host::die("cannot open OUT");
    const int rc = h[4] ? run<int64_t>(f, o, h) : run<int32_t>(f, o, h);
    std::fclose(f);
    std::fclose(o);
    return rc;
}
