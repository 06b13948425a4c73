// Host emulation of the CUDA built-ins that the port's kernels use: one
// std::thread per CUDA thread, a pthread barrier per block and per warp,
// shuffles through a per-warp exchange buffer. Blocks run one at a time.
#pragma once
#include <math.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <climits>
#include <cmath>
#include <functional>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __grid_constant__
#define __align__(n) alignas(n)
#define __shared__ static
#define __restrict__

struct emu_dim3 { unsigned x = 0, y = 0, z = 0; };
extern thread_local emu_dim3 threadIdx, blockIdx;
extern emu_dim3 blockDim, gridDim;

struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct alignas(16) double2 { double x, y; };
struct alignas(8) int2 { int x, y; };
inline int2 make_int2(int a, int b) { return {a, b}; }

struct EmuBlock {
    pthread_barrier_t bar;
    pthread_barrier_t wbar[32];
    unsigned long long xchg[32][32];
    int orbuf[1024];
    unsigned long long site[1024];
    char* smem;
};
extern EmuBlock* emu_blk;

#ifdef EMU_SITES
// Every thread of a block barrier, and every lane of a warp collective, must
// arrive from the same call path (on the GPU a collective reached from two
// branches is undefined, and shuffles of a full mask hang): the path is a
// hash of the return addresses (build with -O0 -fno-omit-frame-pointer).
#include <execinfo.h>
#include <cstdio>
#include <cstdlib>
inline unsigned long long emu_site() {
    void* fr[12];
    const int n = backtrace(fr, 12);
    unsigned long long h = 1469598103934665603ull;
    for (int i = 2; i < n; ++i) h = (h ^ (unsigned long long)fr[i]) * 1099511628211ull;
    return h;
}
inline void emu_check_sites(int lo, int cnt, const char* what) {
    for (int i = lo + 1; i < lo + cnt; ++i)
        if (emu_blk->site[i] != emu_blk->site[lo]) {
            fprintf(stderr, "%s reached from different call paths (threads %d and %d)\n",
                    what, lo, i);
            abort();
        }
}
#endif

inline void emu_block_barrier() { pthread_barrier_wait(&emu_blk->bar); }
inline void __syncthreads() {
#ifdef EMU_SITES
    emu_blk->site[threadIdx.x] = emu_site();
    emu_block_barrier();
    emu_check_sites(0, blockDim.x, "__syncthreads");
    emu_block_barrier();
#else
    emu_block_barrier();
#endif
}
inline int __syncthreads_or(int p) {
    emu_blk->orbuf[threadIdx.x] = p != 0;
    __syncthreads();
    int r = 0;
    for (unsigned i = 0; i < blockDim.x; ++i) r |= emu_blk->orbuf[i];
    emu_block_barrier();
    return r;
}
inline int emu_wid() { return threadIdx.x >> 5; }
inline int emu_lane() { return threadIdx.x & 31; }
inline void emu_warp_barrier() { pthread_barrier_wait(&emu_blk->wbar[emu_wid()]); }
inline void __syncwarp(unsigned = 0xffffffffu) {
#ifdef EMU_SITES
    emu_blk->site[threadIdx.x] = emu_site();
    emu_warp_barrier();
    emu_check_sites(threadIdx.x & ~31, 32, "a warp collective");
    emu_warp_barrier();
#else
    emu_warp_barrier();
#endif
}
template <class T>
inline T emu_from(int src, T v) {
    unsigned long long b = 0;
    memcpy(&b, &v, sizeof(T));
    emu_blk->xchg[emu_wid()][emu_lane()] = b;
    __syncwarp();
    b = emu_blk->xchg[emu_wid()][src];
    __syncwarp();
    T r;
    memcpy(&r, &b, sizeof(T));
    return r;
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src) { return emu_from(src & 31, v); }
template <class T>
inline T __shfl_down_sync(unsigned, T v, int o) {
    const int l = emu_lane();
    return emu_from(l + o < 32 ? l + o : l, v);
}
template <class T>
inline T __shfl_up_sync(unsigned, T v, int o) {
    const int l = emu_lane();
    return emu_from(l >= o ? l - o : l, v);
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int m) { return emu_from(emu_lane() ^ m, v); }
inline unsigned __ballot_sync(unsigned, int p) {
    const int w = emu_wid();
    emu_blk->xchg[w][emu_lane()] = p != 0;
    __syncwarp();
    unsigned r = 0;
    for (int l = 0; l < 32; ++l) r |= (unsigned)emu_blk->xchg[w][l] << l;
    __syncwarp();
    return r;
}
inline int __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
inline int __all_sync(unsigned m, int p) { return __ballot_sync(m, p) == 0xffffffffu; }
inline int __reduce_min_sync(unsigned, int v) {
    const int w = emu_wid();
    emu_blk->xchg[w][emu_lane()] = (unsigned long long)(long long)v;
    __syncwarp();
    int r = INT_MAX;
    for (int l = 0; l < 32; ++l) r = std::min(r, (int)(long long)emu_blk->xchg[w][l]);
    __syncwarp();
    return r;
}
inline int __reduce_max_sync(unsigned, int v) {
    const int w = emu_wid();
    emu_blk->xchg[w][emu_lane()] = (unsigned long long)(long long)v;
    __syncwarp();
    int r = INT_MIN;
    for (int l = 0; l < 32; ++l) r = std::max(r, (int)(long long)emu_blk->xchg[w][l]);
    __syncwarp();
    return r;
}
inline int __reduce_add_sync(unsigned, int v) {
    const int w = emu_wid();
    emu_blk->xchg[w][emu_lane()] = (unsigned long long)(long long)v;
    __syncwarp();
    int r = 0;
    for (int l = 0; l < 32; ++l) r += (int)(long long)emu_blk->xchg[w][l];
    __syncwarp();
    return r;
}
inline int atomicOr(int* p, int v) { return __atomic_fetch_or(p, v, __ATOMIC_RELAXED); }

template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcs(const T* p) { return *p; }
template <class T> inline void __stcs(T* p, T v) { *p = v; }
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
inline unsigned __float_as_uint(float f) { unsigned i; memcpy(&i, &f, 4); return i; }
inline double __longlong_as_double(long long i) { double f; memcpy(&f, &i, 8); return f; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline unsigned __umulhi(unsigned a, unsigned b) {
    return (unsigned)(((unsigned long long)a * b) >> 32);
}
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
using std::isfinite;
using std::isinf;
using std::isnan;

typedef int cudaError_t;
typedef void* cudaStream_t;
#define cudaSuccess 0

// Run `kernel` as block b of `threads` threads with `smem` bytes of dynamic
// shared memory (a heap buffer of exactly that size).
inline void emu_run_block(unsigned b, unsigned threads, size_t smem,
                          const std::function<void()>& kernel,
                          unsigned char fill) {
    EmuBlock* blk = new EmuBlock();
    pthread_barrier_init(&blk->bar, nullptr, threads);
    for (int w = 0; w < 32; ++w) pthread_barrier_init(&blk->wbar[w], nullptr, 32);
    blk->smem = (char*)malloc(smem ? smem : 1);
    memset(blk->smem, fill, smem);
    emu_blk = blk;
    blockDim.x = threads;
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < threads; ++t)
        ts.emplace_back([&, t] {
            threadIdx.x = t;
            blockIdx.x = b;
            kernel();
        });
    for (auto& t : ts) t.join();
    free(blk->smem);
    pthread_barrier_destroy(&blk->bar);
    for (int w = 0; w < 32; ++w) pthread_barrier_destroy(&blk->wbar[w]);
    delete blk;
}
inline double __drcp_rn(double x) { return 1.0 / x; }
inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
inline float __fmaf_rn(float a, float b, float c) { return ::fmaf(a, b, c); }
// cp.async: the copy lands at issue (EMU_CP_EAGER) or at the wait; the
// inline asm of the kernels is rewritten into these calls by the runner.
#include <vector>
struct EmuCp { void* dst; const void* src; int bytes; };
extern thread_local std::vector<EmuCp> emu_cp_queue;
inline void emu_cp_async(void* dst, const void* src, int bytes) {
#ifdef EMU_CP_EAGER
    memcpy(dst, src, bytes);
#else
    emu_cp_queue.push_back({dst, src, bytes});
#endif
}
inline void emu_cp_wait_all() {
    for (auto& c : emu_cp_queue) memcpy(c.dst, c.src, c.bytes);
    emu_cp_queue.clear();
}
inline unsigned long long __cvta_generic_to_shared(const void* p) { return (unsigned long long)p; }
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
    const int w = emu_wid();
    emu_blk->xchg[w][emu_lane()] = v;
    __syncwarp();
    unsigned r = 0;
    for (int l = 0; l < 32; ++l) r |= (unsigned)emu_blk->xchg[w][l];
    __syncwarp();
    return r;
}
