// A host stand-in for the CUDA device runtime, for tests: enough of it
// to compile a warp-per-job kernel (csrc/extend.cu, csrc/extend16.cu,
// csrc/extend_bd.cu or csrc/smem.cu with TPUBWA_WARP_HOST defined) as
// plain C++ and run it on a machine with no card, under
// -fsanitize=address,undefined.
//
// A launch runs its blocks and warps one after another, so launches on
// one stream run in order, and an atomic is a plain read-modify-write.
// The 32 lanes of a warp are 32 fibers (ucontext) that run the kernel in
// lockstep: a lane runs until it reaches a warp operation (__shfl_sync,
// __shfl_up_sync, __reduce_max_sync, __reduce_min_sync,
// __reduce_add_sync, __ballot_sync, __syncwarp), leaves its operand in
// an exchange array and yields; when all 32 have arrived the operation
// is computed by a loop over that array and the lanes go on (a 64-bit
// shuffle is two of 32 bits, as on the card).  Every lane must reach the
// same operation, or leave the kernel, in the same round: anything else
// is a divergent full-mask operation, undefined on the card, and aborts
// here.  Dynamic shared memory is a heap block of exactly the launch's
// size, filled with a poison pattern before each block, so a read past
// it is the sanitizer's and a read of a pair never written shows in the
// result; a kernel that cuts it into one slice a warp asks for its own
// slice with warp_shared(bytes), a heap block of exactly those bytes for
// the warp's life, poisoned the same way (its warps times bytes must fit
// the launch's), so a read past the slice is caught too.  The device
// attributes and the occupancy query answer for an H100 (132 SMs, 227 KB
// a block, 228 KB and 2,048 threads an SM; registers not counted).
// Lanes run in order 0..31, or 31..0 with warp_host::reverse set: a
// kernel whose result changes with the order is missing a __syncwarp.
// There is no __syncthreads: warps of a block never meet.  The 16x2
// SIMD and DPX intrinsics that csrc/extend16.cu uses are written from
// their documented meaning: each 16-bit half is a signed value, sums
// wrap modulo 2^16 (none saturates), max and min compare signed halves.

#pragma once

#include <setjmp.h>
#include <ucontext.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>

#define __global__
#define __host__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct int2 { int x, y; };
inline int2 make_int2(int x, int y) { return int2{x, y}; }
struct uint3h { unsigned x, y, z; };
inline uint3h threadIdx, blockIdx, blockDim;
inline int2* smem;  // the running block's dynamic shared memory

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0, cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaMemsetAsync(void* p, int value, size_t bytes,
                                   cudaStream_t) {
    std::memset(p, value, bytes);
    return cudaSuccess;
}
inline int atomicMax(int* p, int v) {
    const int old = *p;
    *p = old > v ? old : v;
    return old;
}
inline int atomicAdd(int* p, int v) {
    const int old = *p;
    *p = old + v;
    return old;
}
inline int atomicOr(int* p, int v) {
    const int old = *p;
    *p = old | v;
    return old;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
    // an H100 block's limit
    return bytes <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16,
                      cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr attr,
                                          int) {
    *value = attr == cudaDevAttrMultiProcessorCount ? 132 : 232448;
    return cudaSuccess;
}
// blocks of `threads` and `bytes` of dynamic shared memory an SM holds:
// 228 KB of shared memory (1 KB of it reserved a block), 2,048 threads
// and 32 blocks an SM
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F,
                                                          int threads,
                                                          size_t bytes) {
    int n = (int)(233472 / (bytes + 1024));
    if (n > 2048 / threads) n = 2048 / threads;
    *blocks = n > 32 ? 32 : n;
    return cudaSuccess;
}

namespace warp_host {

constexpr int kLanes = 32;
constexpr size_t kStack = 256 * 1024;
enum Op { kNone, kShfl, kShflUp, kReduceMax, kReduceMin, kReduceAdd,
          kBallot, kSync, kDone };

inline bool reverse = false;  // run the lanes 31..0
inline int launches = 0;      // kernel launches made

// Built with AddressSanitizer a lane switch is swapcontext, which ASan
// follows from stack to stack.  Without it (a fast build for large
// counts) a lane starts on its stack with setcontext once and then
// switches by _setjmp/_longjmp, which unlike swapcontext makes no system
// call (the build must not fortify longjmp: -U_FORTIFY_SOURCE).
#if defined(__SANITIZE_ADDRESS__)
#define TPUBWA_WARP_HOST_UCONTEXT 1
#endif

struct Warp {
    ucontext_t sched, ctx[kLanes];
    jmp_buf sched_jb, lane_jb[kLanes];
    bool started[kLanes];
    std::vector<char> stack[kLanes];
    int at[kLanes];        // the operation a lane waits at, kDone once out
    int count[kLanes];     // operations a lane has passed
    int xch[2][kLanes];    // operands, double-buffered by count parity
    int cur = 0;
    const std::function<void()>* kernel = nullptr;
    size_t launch_bytes = 0;      // the launch's dynamic shared memory
    char* shared = nullptr;       // the warp's slice (warp_shared)
    size_t shared_bytes = 0;
};
inline Warp g;

[[noreturn]] inline void die(const char* what) {
    std::fprintf(stderr, "warp_host: %s\n", what);
    std::abort();
}

inline void entry() {
    (*g.kernel)();
    g.at[g.cur] = kDone;
#ifndef TPUBWA_WARP_HOST_UCONTEXT
    _longjmp(g.sched_jb, 1);
#endif
    // uc_link returns to the scheduler
}

// from the running lane back to the scheduler
inline void yield() {
#ifdef TPUBWA_WARP_HOST_UCONTEXT
    if (swapcontext(&g.ctx[g.cur], &g.sched) != 0) die("swapcontext");
#else
    if (!_setjmp(g.lane_jb[g.cur])) _longjmp(g.sched_jb, 1);
#endif
}

// from the scheduler into lane l, until it yields or leaves the kernel
inline void resume(int l) {
#ifdef TPUBWA_WARP_HOST_UCONTEXT
    if (swapcontext(&g.sched, &g.ctx[l]) != 0) die("swapcontext");
#else
    if (_setjmp(g.sched_jb)) return;
    if (g.started[l]) _longjmp(g.lane_jb[l], 1);
    g.started[l] = true;
    setcontext(&g.ctx[l]);  // the lane's first entry, on its own stack
    die("setcontext");
#endif
}

// leave `value` for the others and wait for all 32; returns the buffer
inline const int* arrive(int op, int value) {
    const int me = g.cur;
    int* buf = g.xch[g.count[me] & 1];
    buf[me] = value;
    g.count[me]++;
    g.at[me] = op;
    yield();
    return buf;
}

inline void run_warp(const std::function<void()>& kernel, unsigned warp) {
    g.kernel = &kernel;
    for (int l = 0; l < kLanes; ++l) {
        g.stack[l].resize(kStack);
        if (getcontext(&g.ctx[l]) != 0) die("getcontext");
        g.ctx[l].uc_stack.ss_sp = g.stack[l].data();
        g.ctx[l].uc_stack.ss_size = kStack;
        g.ctx[l].uc_link = &g.sched;
        makecontext(&g.ctx[l], entry, 0);
        g.at[l] = kNone;
        g.count[l] = 0;
        g.started[l] = false;
    }
    struct Slice {  // the warp's shared slice lives as long as the warp
        ~Slice() {
            std::free(g.shared);
            g.shared = nullptr;
        }
    } slice;
    for (;;) {
        for (int k = 0; k < kLanes; ++k) {
            const int l = reverse ? kLanes - 1 - k : k;
            g.cur = l;
            threadIdx.x = warp * kLanes + l;
            resume(l);
        }
        for (int l = 1; l < kLanes; ++l)
            if (g.at[l] != g.at[0] || g.count[l] != g.count[0])
                die("the lanes of a warp diverge at a full-mask operation");
        if (g.at[0] == kDone) return;
    }
}

// kernel(): the kernel call with its arguments bound
inline void launch(int blocks, int threads, size_t bytes,
                   const std::function<void()>& kernel) {
    if (threads % kLanes) die("block size must be a multiple of 32");
    ++launches;
    blockDim.x = threads;
    g.launch_bytes = bytes;
    for (int b = 0; b < blocks; ++b) {
        // exactly the launch's bytes, so a read past them is caught
        char* mem = static_cast<char*>(std::malloc(bytes ? bytes : 1));
        std::memset(mem, 0x5b, bytes);
        smem = reinterpret_cast<int2*>(mem);
        blockIdx.x = b;
        for (int w = 0; w < threads / kLanes; ++w) run_warp(kernel, w);
        std::free(mem);
    }
}

inline void full(unsigned mask) {
    if (mask != 0xffffffffu) die("only full-mask warp operations");
}

// the running warp's slice of `bytes` of the block's dynamic shared
// memory: a heap block of exactly that size, poisoned, the same for all
// its lanes and for the warp's life
inline void* warp_shared(size_t bytes) {
    if (!g.shared) {
        if (bytes * (blockDim.x / kLanes) > g.launch_bytes)
            die("the warps' shared slices exceed the launch's bytes");
        g.shared = static_cast<char*>(std::malloc(bytes ? bytes : 1));
        std::memset(g.shared, 0x5b, bytes);
        g.shared_bytes = bytes;
    } else if (bytes != g.shared_bytes) {
        die("a warp asked for shared slices of two sizes");
    }
    return g.shared;
}

}  // namespace warp_host

#define TPUBWA_LAUNCH(kernel, blocks, threads, bytes, stream, ...) \
    ((void)(stream),                                               \
     warp_host::launch(blocks, threads, bytes, [&] { kernel(__VA_ARGS__); }))

inline int __shfl_sync(unsigned mask, int v, int src) {
    warp_host::full(mask);
    return warp_host::arrive(warp_host::kShfl, v)[src & 31];
}

inline int __shfl_up_sync(unsigned mask, int v, unsigned d) {
    warp_host::full(mask);
    const int me = warp_host::g.cur;
    const int* buf = warp_host::arrive(warp_host::kShflUp, v);
    return me >= (int)d ? buf[me - d] : buf[me];
}

inline int __reduce_max_sync(unsigned mask, int v) {
    warp_host::full(mask);
    const int* buf = warp_host::arrive(warp_host::kReduceMax, v);
    int m = buf[0];
    for (int l = 1; l < warp_host::kLanes; ++l) m = buf[l] > m ? buf[l] : m;
    return m;
}

inline unsigned __reduce_add_sync(unsigned mask, unsigned v) {
    warp_host::full(mask);
    const int* buf = warp_host::arrive(warp_host::kReduceAdd, (int)v);
    unsigned sum = 0;
    for (int l = 0; l < warp_host::kLanes; ++l) sum += (unsigned)buf[l];
    return sum;
}

inline int __reduce_min_sync(unsigned mask, int v) {
    warp_host::full(mask);
    const int* buf = warp_host::arrive(warp_host::kReduceMin, v);
    int m = buf[0];
    for (int l = 1; l < warp_host::kLanes; ++l) m = buf[l] < m ? buf[l] : m;
    return m;
}

inline unsigned __ballot_sync(unsigned mask, bool pred) {
    warp_host::full(mask);
    const int* buf = warp_host::arrive(warp_host::kBallot, pred);
    unsigned bits = 0;
    for (int l = 0; l < warp_host::kLanes; ++l) bits |= (unsigned)(buf[l] != 0) << l;
    return bits;
}

inline void __syncwarp() { warp_host::arrive(warp_host::kSync, 0); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }

// unsigned operands, as the CUDA headers' overloads take them
inline unsigned __shfl_sync(unsigned mask, unsigned v, int src) {
    return (unsigned)__shfl_sync(mask, (int)v, src);
}

// 64-bit operands: two 32-bit shuffles, low half first
inline long long __shfl_sync(unsigned mask, long long v, int src) {
    const unsigned lo = __shfl_sync(mask, (unsigned)v, src);
    const unsigned hi =
        __shfl_sync(mask, (unsigned)((unsigned long long)v >> 32), src);
    return (long long)((unsigned long long)hi << 32 | lo);
}

inline long __shfl_sync(unsigned mask, long v, int src) {
    return (long)__shfl_sync(mask, (long long)v, src);
}

inline unsigned __shfl_up_sync(unsigned mask, unsigned v, unsigned d) {
    return (unsigned)__shfl_up_sync(mask, (int)v, d);
}

namespace warp_host {

// the signed value of the half of x at bit k (0 or 16)
inline int half(unsigned x, int k) {
    return (int)((x >> k & 0xffffu) ^ 0x8000u) - 0x8000;
}

// f on each pair of halves, the result's halves wrapped to 16 bits
template <class F>
unsigned per_half(unsigned a, unsigned b, unsigned c, F f) {
    unsigned out = 0;
    for (int k = 0; k < 32; k += 16)
        out |= ((unsigned)f(half(a, k), half(b, k), half(c, k)) & 0xffffu)
               << k;
    return out;
}

inline int max2(int x, int y) { return x > y ? x : y; }
inline int min2(int x, int y) { return x < y ? x : y; }
inline int wrap16(int x) { return half((unsigned)x, 0); }

}  // namespace warp_host

inline unsigned __vadd2(unsigned a, unsigned b) {
    return warp_host::per_half(a, b, 0, [](int x, int y, int) {
        return warp_host::wrap16(x + y); });
}

inline unsigned __vmaxs2(unsigned a, unsigned b) {
    return warp_host::per_half(a, b, 0, [](int x, int y, int) {
        return warp_host::max2(x, y); });
}

// max(min(a, b), 0)
inline unsigned __vimin_s16x2_relu(unsigned a, unsigned b) {
    return warp_host::per_half(a, b, 0, [](int x, int y, int) {
        return warp_host::max2(warp_host::min2(x, y), 0); });
}

// min(a + b, c), the sum wrapped to 16 bits
inline unsigned __viaddmin_s16x2(unsigned a, unsigned b, unsigned c) {
    return warp_host::per_half(a, b, c, [](int x, int y, int z) {
        return warp_host::min2(warp_host::wrap16(x + y), z); });
}

// max(a + b, c), the sum wrapped to 16 bits
inline unsigned __viaddmax_s16x2(unsigned a, unsigned b, unsigned c) {
    return warp_host::per_half(a, b, c, [](int x, int y, int z) {
        return warp_host::max2(warp_host::wrap16(x + y), z); });
}

// max(a + b, c, 0), the sum wrapped to 16 bits
inline unsigned __viaddmax_s16x2_relu(unsigned a, unsigned b, unsigned c) {
    return warp_host::per_half(a, b, c, [](int x, int y, int z) {
        return warp_host::max2(warp_host::max2(warp_host::wrap16(x + y), z),
                               0); });
}

// byte n of the result is byte (s >> 4n) & 7 of the eight bytes y:x
// (x's bytes 0-3, y's 4-7)
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
    const unsigned long long in = (unsigned long long)y << 32 | x;
    unsigned out = 0;
    for (int n = 0; n < 4; ++n)
        out |= (unsigned)(in >> 8 * (s >> 4 * n & 7) & 0xffu) << 8 * n;
    return out;
}
