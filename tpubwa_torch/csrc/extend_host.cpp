// csrc/extend.cu's kernels run on the host (warp_host.h), for tests.
//
//   g++ -std=c++17 -O1 -g -fsanitize=address,undefined
//       -o extend_host extend_host.cpp    (one command)
//   extend_host JOBS OUT
//
// JOBS: int32 header (n, W, tmax, pstride, a, b, o_del, e_del, o_ins,
// e_ins, zdrop, reverse, n_masks, n_variants, n_mats), then n_masks
// ablation masks, then n_variants K1-real variants, then n_mats scoring
// matrices of 25 ints each, then q [n, W], t [n, tmax] and params [n,
// pstride], all int32.  OUT gets one int32 [n, 6] per
// mask, in order: mask 0 through K1's entry (tpubwa_extend_batch),
// every other mask through the floor entry; a mask of -1 is mask 0
// through the floor entry.  Then one int32 [n, 128] per variant, through
// the K1-real entry (tpubwa_extend_real) with the header's scoring, with
// lanes 6-127 as the kernel left them.  Then one int32 [n, 6] per matrix,
// through the K1-mat entry (tpubwa_extend_mat) with the header's gap
// penalties and z-drop.  Every output starts as
// -77.  `reverse` runs the lanes of each warp 31..0.  The inputs are
// copied into heap blocks of their exact sizes, so a read past a tile is
// the sanitizer's.

#define TPUBWA_WARP_HOST
#include "extend.cu"

static std::vector<int32_t> read_ints(FILE* f, size_t count) {
    std::vector<int32_t> v(count);
    if (count && std::fread(v.data(), sizeof(int32_t), count, f) != count)
        warp_host::die("short input");
    return v;
}

int main(int argc, char** argv) {
    if (argc != 3) warp_host::die("usage: extend_host JOBS OUT");
    FILE* f = std::fopen(argv[1], "rb");
    if (!f) warp_host::die("cannot open JOBS");
    const std::vector<int32_t> h = read_ints(f, 15);
    const int n = h[0], W = h[1], tmax = h[2], pstride = h[3];
    warp_host::reverse = h[11] != 0;
    const std::vector<int32_t> masks = read_ints(f, h[12]);
    const std::vector<int32_t> variants = read_ints(f, h[13]);
    const std::vector<int32_t> mats = read_ints(f, (size_t)h[14] * 25);
    const std::vector<int32_t> q = read_ints(f, (size_t)n * W);
    const std::vector<int32_t> t = read_ints(f, (size_t)n * tmax);
    const std::vector<int32_t> p = read_ints(f, (size_t)n * pstride);
    std::fclose(f);
    FILE* o = std::fopen(argv[2], "wb");
    if (!o) warp_host::die("cannot open OUT");
    const auto failed = [](const char* what, int which, int rc, int before) {
        std::fprintf(stderr, "extend_host: %s %d returned %d after %d "
                     "launches\n", what, which, rc,
                     warp_host::launches - before);
        return 3;
    };
    for (int mask : masks) {
        std::vector<int32_t> out((size_t)n * 6, -77);
        const int before = warp_host::launches;
        const int rc = mask == 0
            ? tpubwa_extend_batch(q.data(), t.data(), p.data(), out.data(), n,
                                  W, tmax, pstride, h[4], h[5], h[6], h[7],
                                  h[8], h[9], h[10], 0, nullptr)
            : tpubwa_extend_floor(q.data(), t.data(), p.data(), out.data(), n,
                                  W, tmax, pstride, h[4], h[5], h[6], h[7],
                                  h[8], h[9], h[10], 0, nullptr,
                                  mask < 0 ? 0 : mask);
        if (rc != 0) return failed("mask", mask, rc, before);
        std::fwrite(out.data(), sizeof(int32_t), out.size(), o);
    }
    for (int variant : variants) {
        std::vector<int32_t> out((size_t)n * 128, -77);
        const int before = warp_host::launches;
        const int rc = tpubwa_extend_real(variant, q.data(), t.data(),
                                          p.data(), out.data(), n, W, tmax,
                                          pstride, 128, h[4], h[5], h[6],
                                          h[7], h[8], h[9], h[10], 0,
                                          nullptr);
        if (rc != 0) return failed("variant", variant, rc, before);
        std::fwrite(out.data(), sizeof(int32_t), out.size(), o);
    }
    for (int m = 0; m < h[14]; ++m) {
        // the matrix, a heap block of its exact 25 ints
        const std::vector<int32_t> mat(mats.begin() + 25 * m,
                                       mats.begin() + 25 * (m + 1));
        std::vector<int32_t> out((size_t)n * 6, -77);
        const int before = warp_host::launches;
        const int rc = tpubwa_extend_mat(q.data(), t.data(), p.data(),
                                         out.data(), n, W, tmax, pstride,
                                         mat.data(), h[6], h[7], h[8], h[9],
                                         h[10], 0, nullptr);
        if (rc != 0) return failed("matrix", m, rc, before);
        std::fwrite(out.data(), sizeof(int32_t), out.size(), o);
    }
    std::fclose(o);
    return 0;
}
