// A host stand-in for the CUDA device runtime, for tests: enough of it
// to compile a warp-per-job kernel (csrc/extend.cu with
// TPUBWA_WARP_HOST defined) as plain C++ and run it on a machine with no
// card, under -fsanitize=address,undefined.
//
// A launch runs its blocks and warps one after another.  The 32 lanes
// of a warp are 32 fibers (ucontext) that run the kernel in lockstep: a
// lane runs until it reaches a warp operation (__shfl_sync,
// __shfl_up_sync, __reduce_max_sync, __ballot_sync, __syncwarp), leaves
// its operand in an exchange array and yields; when all 32 have
// arrived the operation is computed by a loop over that array and the
// lanes go on.  Every lane must reach the same operation, or leave the
// kernel, in the same round: anything else is a divergent full-mask
// operation, undefined on the card, and aborts here.  Dynamic shared
// memory is a heap block of exactly the launch's size, filled with a
// poison pattern before each block, so a read past it is the
// sanitizer's and a read of a pair never written shows in the result.
// Lanes run in order 0..31, or 31..0 with warp_host::reverse set: a
// kernel whose result changes with the order is missing a __syncwarp.
// There is no __syncthreads: warps of a block never meet.

#pragma once

#include <ucontext.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>

#define __global__
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
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
    // an H100 block's limit
    return bytes <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}

namespace warp_host {

constexpr int kLanes = 32;
constexpr size_t kStack = 256 * 1024;
enum Op { kNone, kShfl, kShflUp, kReduceMax, kBallot, kSync, kDone };

inline bool reverse = false;  // run the lanes 31..0

struct Warp {
    ucontext_t sched, ctx[kLanes];
    std::vector<char> stack[kLanes];
    int at[kLanes];        // the operation a lane waits at, kDone once out
    int count[kLanes];     // operations a lane has passed
    int xch[2][kLanes];    // operands, double-buffered by count parity
    int cur = 0;
    const std::function<void()>* kernel = nullptr;
};
inline Warp g;

[[noreturn]] inline void die(const char* what) {
    std::fprintf(stderr, "warp_host: %s\n", what);
    std::abort();
}

inline void entry() {
    (*g.kernel)();
    g.at[g.cur] = kDone;
    // uc_link returns to the scheduler
}

// leave `value` for the others and wait for all 32; returns the buffer
inline const int* arrive(int op, int value) {
    const int me = g.cur;
    int* buf = g.xch[g.count[me] & 1];
    buf[me] = value;
    g.count[me]++;
    g.at[me] = op;
    if (swapcontext(&g.ctx[me], &g.sched) != 0) die("swapcontext");
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
    }
    for (;;) {
        for (int k = 0; k < kLanes; ++k) {
            const int l = reverse ? kLanes - 1 - k : k;
            g.cur = l;
            threadIdx.x = warp * kLanes + l;
            if (swapcontext(&g.sched, &g.ctx[l]) != 0) die("swapcontext");
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
    blockDim.x = threads;
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
