// csrc/extend_bd.cu's kernels run on the host (warp_host.h), for tests.
//
//   g++ -std=c++17 -O1 -g -fsanitize=address,undefined
//       -o extend_bd_host extend_bd_host.cpp    (one command)
//   extend_bd_host JOBS OUT
//
// JOBS: int32 header (n, NL, tmax, pstride, reverse, n_variants), then
// n_variants variant indices (exp_kernel_breakdown.VARIANTS), then q
// [n, NL], t [n, tmax] and params [n, pstride], all int32.  OUT gets one
// int32 [n, 128] per variant, in order, through the C entry
// tpubwa_extend_bd: both passes, the live kernel's launches before the
// frozen kernel's.  Every output starts as -77, so lanes 4-127 show
// what the kernel left.  The inputs, the frozen row and aux are heap
// blocks of their exact sizes, the last two filled with a poison
// pattern, so a read past a tile is the sanitizer's and a read of a
// pair never written shows in the result.  `reverse` runs the lanes of
// each warp 31..0.  A refused launch exits with 3 and says how many
// launches were made.

#define TPUBWA_WARP_HOST
#include "extend_bd.cu"

static std::vector<int32_t> read_ints(FILE* f, size_t count) {
    std::vector<int32_t> v(count);
    if (count && std::fread(v.data(), sizeof(int32_t), count, f) != count)
        warp_host::die("short input");
    return v;
}

int main(int argc, char** argv) {
    if (argc != 3) warp_host::die("usage: extend_bd_host JOBS OUT");
    FILE* f = std::fopen(argv[1], "rb");
    if (!f) warp_host::die("cannot open JOBS");
    const std::vector<int32_t> h = read_ints(f, 6);
    const int n = h[0], NL = h[1], tmax = h[2], pstride = h[3];
    warp_host::reverse = h[4] != 0;
    const std::vector<int32_t> variants = read_ints(f, h[5]);
    const std::vector<int32_t> q = read_ints(f, (size_t)n * NL);
    const std::vector<int32_t> t = read_ints(f, (size_t)n * tmax);
    const std::vector<int32_t> p = read_ints(f, (size_t)n * pstride);
    std::fclose(f);
    FILE* o = std::fopen(argv[2], "wb");
    if (!o) warp_host::die("cannot open OUT");
    for (int variant : variants) {
        std::vector<int32_t> out((size_t)n * 128, -77);
        std::vector<int2> frozen((size_t)n * NL);
        std::vector<int32_t> aux(3 + 5 * (size_t)n);
        std::memset(frozen.data(), 0x5b, frozen.size() * sizeof(int2));
        std::memset(aux.data(), 0x5b, aux.size() * sizeof(int32_t));
        const int before = warp_host::launches;
        const int rc = tpubwa_extend_bd(variant, q.data(), t.data(), p.data(),
                                        out.data(), frozen.data(), aux.data(),
                                        n, NL, tmax, pstride, 128, 0,
                                        nullptr);
        if (rc != 0) {
            std::fprintf(stderr, "extend_bd_host: variant %d returned %d "
                         "after %d launches\n", variant, rc,
                         warp_host::launches - before);
            return 3;
        }
        std::fwrite(out.data(), sizeof(int32_t), out.size(), o);
    }
    std::fclose(o);
    return 0;
}
