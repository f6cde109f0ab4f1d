// csrc/extend.cu's kernels run on the host (warp_host.h), for tests.
//
//   g++ -std=c++17 -O1 -g -fsanitize=address,undefined
//       -o extend_host extend_host.cpp    (one command)
//   extend_host JOBS OUT
//
// JOBS: int32 header (n, W, tmax, pstride, a, b, o_del, e_del, o_ins,
// e_ins, zdrop, reverse, n_masks), then n_masks ablation masks, then
// q [n, W], t [n, tmax] and params [n, pstride], all int32.  OUT gets
// one int32 [n, 6] per mask, in order: mask 0 through K1's entry
// (tpubwa_extend_batch), every other mask through the floor entry; a
// mask of -1 is mask 0 through the floor entry.  `reverse` runs the
// lanes of each warp 31..0.  The inputs are copied into heap blocks of
// their exact sizes, so a read past a tile is the sanitizer's.

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
    const std::vector<int32_t> h = read_ints(f, 13);
    const int n = h[0], W = h[1], tmax = h[2], pstride = h[3];
    warp_host::reverse = h[11] != 0;
    const std::vector<int32_t> masks = read_ints(f, h[12]);
    const std::vector<int32_t> q = read_ints(f, (size_t)n * W);
    const std::vector<int32_t> t = read_ints(f, (size_t)n * tmax);
    const std::vector<int32_t> p = read_ints(f, (size_t)n * pstride);
    std::fclose(f);
    FILE* o = std::fopen(argv[2], "wb");
    if (!o) warp_host::die("cannot open OUT");
    for (int mask : masks) {
        std::vector<int32_t> out((size_t)n * 6, -77);
        const int rc = mask == 0
            ? tpubwa_extend_batch(q.data(), t.data(), p.data(), out.data(), n,
                                  W, tmax, pstride, h[4], h[5], h[6], h[7],
                                  h[8], h[9], h[10], 0, nullptr)
            : tpubwa_extend_floor(q.data(), t.data(), p.data(), out.data(), n,
                                  W, tmax, pstride, h[4], h[5], h[6], h[7],
                                  h[8], h[9], h[10], 0, nullptr,
                                  mask < 0 ? 0 : mask);
        if (rc != 0) {
            std::fprintf(stderr, "extend_host: mask %d returned %d\n", mask,
                         rc);
            return 3;
        }
        std::fwrite(out.data(), sizeof(int32_t), out.size(), o);
    }
    std::fclose(o);
    return 0;
}
