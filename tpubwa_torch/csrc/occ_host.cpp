// csrc/occ.cu's kernels run on the host (warp_host.h), for tests.
//
//   g++ -std=c++17 -O1 -g -fsanitize=address,undefined
//       -o occ_host occ_host.cpp    (one command)
//   occ_host INDEX OUT
//
// INDEX: int64 header (n_blocks, n_mark_blocks, n_marked, n_sample,
// primary, seq_len, mark_D, idx64, n_ranks, n_ik, max_blocks, reverse,
// n_call, n_slabs, peers, n_reach, B, L, count, sms, blocks_per_sm),
// then occ uint32 [n_blocks, 12],
// mark rows uint32
// [n_mark_blocks, 8], then, of the rank type (int64 where idx64, else
// int32): L2 [5], sa_marked [n_marked], sa_sample [n_sample], ranks
// [n_ranks] and ik [n_ik, 3].  OUT gets, of the rank type, the positions
// of the ranks (tpubwa_sa_lookup: the marked walk where mark_D > 0, else
// the rank-sampled one, on a grid capped at max_blocks where > 0, each
// warp's lanes run 31..0 where reverse), the thread that walked each
// rank, then the backward and then the forward extensions of ik,
// [n_ik, 4, 3] each (tpubwa_bwt_extend).  Each input is a heap block of
// its exact size, and each output starts as -77, so a read past an array
// is the sanitizer's and an output never written shows in the result.
// n_call >= 0 calls tpubwa_sa_lookup with that n in place of n_ranks
// (the refusal case: an n past the rank queue's range, which the entry
// must refuse before it touches anything) and writes only its return
// code, the queue word (-77 before the call) and the positions.  A
// launch that returns an error exits with 3.
//
// n_reach > 0 (flat entries only) also runs K-reach
// (tpubwa_rightmost_reach): after the arrays (and the slab cuts) come
// the reads q uint8 [B, L], lens int32 [B], read_idx and starts int32
// [n_reach] and min_intv [n_reach] of the rank type, and OUT gets, after
// the extensions, ik [n_reach, 3] and e [n_reach] of the rank type.
// count 1 adds, of the rank type, K-reach's extension steps (its trips),
// the occ rows they loaded, and the m distinct rows (block indices) in
// ascending order after m.  sms and blocks_per_sm, where > 0, make the
// attribute and occupancy queries answer for a card of that many SMs
// holding that many blocks each, so that the grid holds fewer lanes than
// K-reach has segments.
//
// n_slabs > 0 runs the TP instantiations instead (tpubwa_sa_lookup_tp
// and tpubwa_bwt_extend_tp), on the index cut into slabs: after the
// arrays come int64 [n_slabs] each, the first rows of the occ, the mark
// and the sa_marked slabs, then each slab's device (the launch is on
// device 0); every slab is a heap block of its exact rows, so a row read
// past a slab's end is the sanitizer's.  peers 0 makes the peer-access
// query answer that no two devices reach each other.

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
    const int mark_D = (int)h[6], max_blocks = (int)h[10];
    warp_host::reverse = h[11] != 0;
    const auto occ = read_array<uint32_t>(f, n_blocks * 12);
    const auto marks = read_array<uint32_t>(f, n_mark_blocks * 8);
    const auto L2 = read_array<Idx>(f, 5);
    const auto sa_marked = read_array<Idx>(f, n_marked);
    const auto sa_sample = read_array<Idx>(f, n_sample);
    const auto ranks = read_array<Idx>(f, n_ranks);
    const auto ik = read_array<Idx>(f, n_ik * 3);
    std::vector<Idx> pos((size_t)n_ranks, (Idx)-77);
    std::vector<int32_t> lanes((size_t)n_ranks, -77);
    int32_t queue = -77;
    const int n_slabs = (int)h[13];
    warp_host::peers = h[14] != 0;
    std::vector<std::vector<int64_t>> first;
    for (int j = 0; j < 4; ++j)
        first.push_back(read_array<int64_t>(f, n_slabs));
    const warp_host::Cut<uint32_t> occ_tp(occ, 12, first[0], first[3]),
        marks_tp(marks, 8, first[1], first[3]);
    const warp_host::Cut<Idx> sam_tp(sa_marked, 1, first[2], first[3]);
    const int64_t n_reach = h[15], B = h[16], L = h[17];
    const auto q = read_array<uint8_t>(f, B * L);
    const auto lens = read_array<int32_t>(f, B);
    const auto read_idx = read_array<int32_t>(f, n_reach);
    const auto starts = read_array<int32_t>(f, n_reach);
    const auto min_intv = read_array<Idx>(f, n_reach);
    int rc = n_slabs
        ? tpubwa_sa_lookup_tp(n_slabs, occ_tp.table.data(),
                              marks_tp.table.data(), sam_tp.table.data(),
                              L2.data(), primary, seq_len, mark_D,
                              sizeof(Idx) == 8, ranks.data(), pos.data(),
                              n_ranks, &queue, lanes.data(), max_blocks, 0,
                              nullptr)
        : tpubwa_sa_lookup(occ.data(), L2.data(), marks.data(),
                           sa_marked.data(), sa_sample.data(), primary,
                           seq_len, mark_D, sizeof(Idx) == 8, ranks.data(),
                           pos.data(), h[12] >= 0 ? h[12] : n_ranks, &queue,
                           lanes.data(), max_blocks, 0, nullptr);
    if (h[12] >= 0) {  // the refusal case: rc, the queue, the positions
        write_array(o, std::vector<Idx>{(Idx)rc, (Idx)queue});
        write_array(o, pos);
        return 0;
    }
    if (rc != 0) {
        std::fprintf(stderr, "occ_host: tpubwa_sa_lookup returned %d\n", rc);
        return 3;
    }
    write_array(o, pos);
    write_array(o, std::vector<Idx>(lanes.begin(), lanes.end()));
    for (int is_back : {1, 0}) {
        std::vector<Idx> ok((size_t)n_ik * 12, (Idx)-77);
        rc = n_slabs
            ? tpubwa_bwt_extend_tp(n_slabs, occ_tp.table.data(), L2.data(),
                                   primary, seq_len, sizeof(Idx) == 8,
                                   is_back, ik.data(), ok.data(), n_ik, 0,
                                   nullptr)
            : tpubwa_bwt_extend(occ.data(), L2.data(), primary, seq_len,
                                sizeof(Idx) == 8, is_back, ik.data(),
                                ok.data(), n_ik, 0, nullptr);
        if (rc != 0) {
            std::fprintf(stderr, "occ_host: tpubwa_bwt_extend returned %d\n",
                         rc);
            return 3;
        }
        write_array(o, ok);
    }
    if (n_reach > 0) {
        std::vector<Idx> ik((size_t)n_reach * 3, (Idx)-77),
            e((size_t)n_reach, (Idx)-77);
        unsigned long long reach_queue = 77;
        int64_t steps = 0;
        std::vector<int64_t> rows;
        if (h[18]) {
            reach_steps = &steps;
            reach_rows = &rows;
        }
        if (h[19] > 0) warp_host::sms = (int)h[19];
        if (h[20] > 0) warp_host::blocks_per_sm = (int)h[20];
        rc = tpubwa_rightmost_reach(occ.data(), L2.data(), primary, seq_len,
                                    sizeof(Idx) == 8, q.data(), (int)L,
                                    lens.data(), read_idx.data(),
                                    starts.data(), min_intv.data(), ik.data(),
                                    e.data(), n_reach, &reach_queue, 0,
                                    nullptr);
        reach_steps = nullptr;
        reach_rows = nullptr;
        if (rc != 0) {
            std::fprintf(stderr, "occ_host: tpubwa_rightmost_reach returned "
                         "%d\n", rc);
            return 3;
        }
        write_array(o, ik);
        write_array(o, e);
        if (h[18]) {
            const int64_t loads = (int64_t)rows.size();
            std::sort(rows.begin(), rows.end());
            rows.erase(std::unique(rows.begin(), rows.end()), rows.end());
            std::vector<Idx> out{(Idx)steps, (Idx)loads, (Idx)rows.size()};
            out.insert(out.end(), rows.begin(), rows.end());
            write_array(o, out);
        }
    }
    return 0;
}

int main(int argc, char** argv) {
    if (argc != 3) warp_host::die("usage: occ_host INDEX OUT");
    FILE* f = std::fopen(argv[1], "rb");
    if (!f) warp_host::die("cannot open INDEX");
    const std::vector<int64_t> h = read_array<int64_t>(f, 21);
    FILE* o = std::fopen(argv[2], "wb");
    if (!o) warp_host::die("cannot open OUT");
    const int rc = h[7] ? run<int64_t>(f, o, h) : run<int32_t>(f, o, h);
    std::fclose(f);
    std::fclose(o);
    return rc;
}
