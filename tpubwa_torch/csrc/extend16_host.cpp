// csrc/extend16.cu's kernel runs on the host (warp_host.h), for tests.
//
//   g++ -std=c++17 -O1 -g -fsanitize=address,undefined
//       -o extend16_host extend16_host.cpp    (one command)
//   extend16_host JOBS OUT
//   extend16_host --ops IN OUT
//
// JOBS: int32 header (n, W, tmax, pstride, a, b, o_del, e_del, o_ins,
// e_ins, zdrop, reverse), then q [n, W], t [n, tmax] and params
// [n, pstride], all int32.  OUT gets the int32 [n, 6] that the C entry
// tpubwa_extend_batch16 writes into a buffer that starts as -77.
// `reverse` runs the lanes of each warp 31..0.  The inputs are copied
// into heap blocks of their exact sizes, so a read past a tile is the
// sanitizer's.  A refused launch exits with 3 and says how many
// launches were made.
//
// --ops: IN is int32 n, then uint32 a [n], b [n], c [n]; OUT gets, for
// each intrinsic of kOps in order, uint32 [n] of its results on (a, b,
// c) (a two-operand intrinsic takes a and b).

#define TPUBWA_WARP_HOST
#include "extend16.cu"

static std::vector<int32_t> read_ints(FILE* f, size_t count) {
    std::vector<int32_t> v(count);
    if (count && std::fread(v.data(), sizeof(int32_t), count, f) != count)
        warp_host::die("short input");
    return v;
}

// the intrinsics, in the order of warp_host.py:INTRINSICS16
static unsigned op(int k, unsigned a, unsigned b, unsigned c) {
    switch (k) {
        case 0: return __vadd2(a, b);
        case 1: return __vmaxs2(a, b);
        case 2: return __vimin_s16x2_relu(a, b);
        case 3: return __viaddmin_s16x2(a, b, c);
        case 4: return __viaddmax_s16x2(a, b, c);
        case 5: return __viaddmax_s16x2_relu(a, b, c);
        default: return __byte_perm(a, b, c);
    }
}
constexpr int kOps = 7;

static int run_ops(FILE* f, FILE* o) {
    const int n = read_ints(f, 1)[0];
    const std::vector<int32_t> in = read_ints(f, 3 * (size_t)n);
    std::vector<uint32_t> out(n);
    for (int k = 0; k < kOps; ++k) {
        for (int i = 0; i < n; ++i)
            out[i] = op(k, in[i], in[n + i], in[2 * n + i]);
        std::fwrite(out.data(), sizeof(uint32_t), out.size(), o);
    }
    return 0;
}

int main(int argc, char** argv) {
    const bool ops = argc == 4 && std::strcmp(argv[1], "--ops") == 0;
    if (argc != 3 && !ops)
        warp_host::die("usage: extend16_host JOBS OUT | --ops IN OUT");
    FILE* f = std::fopen(argv[argc - 2], "rb");
    if (!f) warp_host::die("cannot open the input");
    FILE* o = std::fopen(argv[argc - 1], "wb");
    if (!o) warp_host::die("cannot open OUT");
    if (ops) {
        run_ops(f, o);
        std::fclose(f);
        std::fclose(o);
        return 0;
    }
    const std::vector<int32_t> h = read_ints(f, 12);
    const int n = h[0], W = h[1], tmax = h[2], pstride = h[3];
    warp_host::reverse = h[11] != 0;
    const std::vector<int32_t> q = read_ints(f, (size_t)n * W);
    const std::vector<int32_t> t = read_ints(f, (size_t)n * tmax);
    const std::vector<int32_t> p = read_ints(f, (size_t)n * pstride);
    std::fclose(f);
    std::vector<int32_t> out((size_t)n * 6, -77);
    const int rc = tpubwa_extend_batch16(
        q.data(), t.data(), p.data(), out.data(), n, W, tmax, pstride, h[4],
        h[5], h[6], h[7], h[8], h[9], h[10], 0, nullptr);
    if (rc != 0) {
        std::fprintf(stderr, "extend16_host: returned %d after %d "
                     "launches\n", rc, warp_host::launches);
        return 3;
    }
    std::fwrite(out.data(), sizeof(int32_t), out.size(), o);
    std::fclose(o);
    return 0;
}
