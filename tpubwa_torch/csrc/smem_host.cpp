// csrc/smem.cu's kernels run on the host (warp_host.h), for tests, and to
// count the index rows a launch reads (chip_smoke.py's bound).
//
//   g++ -std=c++17 -O1 -g -fsanitize=address,undefined
//       -o smem_host smem_host.cpp    (one command)
//   smem_host IN OUT
//
// IN: int64 header (kernel: 0 for K2, tpubwa_smem_rounds12, 1 for K3,
// tpubwa_seed_strategy; n_blocks, primary, seq_len, idx64, B, L, n,
// min_seed_len, split_len, split_width, slots, max_intv, maxh,
// count_rows, reverse), then occ uint32 [n_blocks, 12], L2 of the rank
// type (int64 where idx64, else int32) [5], reads uint8 [B, L], lens
// int32 [B] and, for K2, rids int32 [n].  OUT gets int64 values: K2's
// rows [n, slots, 5], counts [n], steps [n] and chain [n]; or K3's hits
// [B, maxh, 5], n_hits [B] and steps [B]; then, where count_rows, the
// number of distinct occ rows the launch read and those rows, ascending.
// reverse runs each warp's lanes 31..0.  Every array is a heap block of
// its exact size (each warp's shared slice too, warp_host.h), and the
// outputs and the read queue start as -77 (K3's hits as zeros, as the
// wrapper allocates them), so a read past an array is the sanitizer's
// and a slot never written shows in the result.  A launch that returns
// an error (K2 refuses a read length whose stacks do not fit a block's
// shared memory) exits with 3.

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
    int rc;
    if (kernel == 0) {
        const auto rids = read_array<int32_t>(f, n);
        std::vector<int32_t> queue(1, -77);
        std::vector<Idx> rows((size_t)(n * slots * 5), (Idx)-77);
        std::vector<int32_t> counts((size_t)n, -77), steps((size_t)n, -77),
            chain((size_t)n, -77);
        rc = tpubwa_smem_rounds12(occ.data(), L2.data(), primary, seq_len,
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
        std::vector<int32_t> n_hits((size_t)B, -77), steps((size_t)B, -77);
        rc = tpubwa_seed_strategy(occ.data(), L2.data(), primary, seq_len,
                                  sizeof(Idx) == 8, q.data(), L, lens.data(),
                                  B, min_seed_len, max_intv, maxh, hits.data(),
                                  n_hits.data(), steps.data(), 0, nullptr);
        write_int64(o, hits);
        write_int64(o, n_hits);
        write_int64(o, steps);
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
    const std::vector<int64_t> h = read_array<int64_t>(f, 16);
    FILE* o = std::fopen(argv[2], "wb");
    if (!o) warp_host::die("cannot open OUT");
    const int rc = h[4] ? run<int64_t>(f, o, h) : run<int32_t>(f, o, h);
    std::fclose(f);
    std::fclose(o);
    return rc;
}
