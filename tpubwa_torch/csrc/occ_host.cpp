// csrc/occ.cu's kernels run on the host (warp_host.h), for tests.
//
//   g++ -std=c++17 -O1 -g -fsanitize=address,undefined
//       -o occ_host occ_host.cpp    (one command)
//   occ_host INDEX OUT
//
// INDEX: int64 header (n_blocks, n_mark_blocks, n_marked, n_sample,
// primary, seq_len, mark_D, idx64, n_ranks, n_ik), then occ uint32
// [n_blocks, 12], mark rows uint32 [n_mark_blocks, 8], then, of the rank
// type (int64 where idx64, else int32): L2 [5], sa_marked [n_marked],
// sa_sample [n_sample], ranks [n_ranks] and ik [n_ik, 3].  OUT gets, of
// the rank type, the positions of the ranks (tpubwa_sa_lookup: the marked
// walk where mark_D > 0, else the rank-sampled one), then the backward
// and then the forward extensions of ik, [n_ik, 4, 3] each
// (tpubwa_bwt_extend).  Each input is a heap block of its exact size,
// and each output starts as -77, so a read past an array is the
// sanitizer's and an output never written shows in the result.  A
// launch that returns an error exits with 3.

#define TPUBWA_WARP_HOST
#include "occ.cu"

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
static void write_array(FILE* o, const std::vector<T>& v) {
    if (!v.empty()) std::fwrite(v.data(), sizeof(T), v.size(), o);
}

template <class Idx>
static int run(FILE* f, FILE* o, const std::vector<int64_t>& h) {
    const int64_t n_blocks = h[0], n_mark_blocks = h[1], n_marked = h[2],
                  n_sample = h[3], primary = h[4], seq_len = h[5],
                  n_ranks = h[8], n_ik = h[9];
    const int mark_D = (int)h[6];
    const auto occ = read_array<uint32_t>(f, n_blocks * 12);
    const auto marks = read_array<uint32_t>(f, n_mark_blocks * 8);
    const auto L2 = read_array<Idx>(f, 5);
    const auto sa_marked = read_array<Idx>(f, n_marked);
    const auto sa_sample = read_array<Idx>(f, n_sample);
    const auto ranks = read_array<Idx>(f, n_ranks);
    const auto ik = read_array<Idx>(f, n_ik * 3);
    std::vector<Idx> pos((size_t)n_ranks, (Idx)-77);
    int rc = tpubwa_sa_lookup(occ.data(), L2.data(), marks.data(),
                              sa_marked.data(), sa_sample.data(), primary,
                              seq_len, mark_D, sizeof(Idx) == 8,
                              ranks.data(), pos.data(), n_ranks, 0, nullptr);
    if (rc != 0) {
        std::fprintf(stderr, "occ_host: tpubwa_sa_lookup returned %d\n", rc);
        return 3;
    }
    write_array(o, pos);
    for (int is_back : {1, 0}) {
        std::vector<Idx> ok((size_t)n_ik * 12, (Idx)-77);
        rc = tpubwa_bwt_extend(occ.data(), L2.data(), primary, seq_len,
                               sizeof(Idx) == 8, is_back, ik.data(),
                               ok.data(), n_ik, 0, nullptr);
        if (rc != 0) {
            std::fprintf(stderr, "occ_host: tpubwa_bwt_extend returned %d\n",
                         rc);
            return 3;
        }
        write_array(o, ok);
    }
    return 0;
}

int main(int argc, char** argv) {
    if (argc != 3) warp_host::die("usage: occ_host INDEX OUT");
    FILE* f = std::fopen(argv[1], "rb");
    if (!f) warp_host::die("cannot open INDEX");
    const std::vector<int64_t> h = read_array<int64_t>(f, 10);
    FILE* o = std::fopen(argv[2], "wb");
    if (!o) warp_host::die("cannot open OUT");
    const int rc = h[7] ? run<int64_t>(f, o, h) : run<int32_t>(f, o, h);
    std::fclose(f);
    std::fclose(o);
    return rc;
}
