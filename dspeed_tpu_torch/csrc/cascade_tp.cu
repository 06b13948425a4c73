// Rise-time cascade (K2) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_cascade_kernel` / `_cascade_call`
// (dspeed_tpu/processors/_pallas.py:1528, :1621; entry `cascade_tp` :1650).
// Per event row w it runs m threshold searches in order. Link k has the
// threshold factor_k * base[row] (factor 1: the base itself; else
// __fmul_rn of the factor rounded to float and the base, the bits of the
// Pallas kernel's `jnp.float32(factor) * base` and of a python float times
// a float32 tensor) and starts from t[row] (starts[k] < 0) or from the
// result of link starts[k]:
//   forward  (dirs[k] == 1): the smallest i >= s with a crossing between
//            w[i] and w[i+1];
//   backward (dirs[k] != 1): the largest i <= s with a crossing between
//            w[i-1] and w[i];
// with time_point_thresh's predicates (block_reduce.cuh `cross_fwd`,
// `cross_bwd`). The root start is bad on a row with a NaN, a NaN start, a
// start that is not integral or lies outside [0, n) (_pallas.py:1536-1540).
// A link is NaN where its start is bad, its threshold is NaN, or nothing is
// found. The kernel only compares floats, so it is bit-identical to the
// plain version (processors/_cuda.py `cascade_tp_plain`).
//
// What bounds it on this card: bytes. A NaN anywhere makes the whole row
// bad, so every sample is read once (16 KB of a 4096-sample row, 268 MB per
// 16384 rows: 0.08 ms at 3.35 TB/s); the links compare a few hundred
// samples.
//
// How the design meets it: one warp per row and no block barrier. Each warp
// copies its row into its own buffer in shared memory with 16-byte
// cp.async (4-byte where the row does not start on 16 bytes: n % 4 != 0 or
// an offset pointer), so the copy holds no registers and a block's warps
// keep whole rows in flight; rows per block are as many as the shared
// memory holds, up to CT_MAX_ROWS. The grid is persistent: each warp walks
// rows gridDim.x * rows-per-block apart. The warp tests the staged row for
// a NaN (16-byte shared loads, __any_sync), then runs the links: a link
// tests CT_WIN windows of 32 consecutive positions with the crossing
// predicate, one __ballot_sync each, and takes the lowest set bit of the
// first window that holds one (forward) or the highest (backward). The
// result is the same in every lane, so the next link starts with no
// exchange; lane k keeps link k's index, a later link reads its start with
// one shuffle, and lanes 0..m-1 store the m outputs. The TPU kernel's rank
// planes and per-direction bit planes (_pallas.py:1549-1572) fed its
// vector unit; direct float compares need neither. Up to CT_MAX_LINKS
// links; the TPU's n % 128 and n >= 256 gates do not apply.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_reduce.cuh"

#define CT_MAX_LINKS 16
#define CT_MAX_ROWS 16       // rows (warps) a block at most
#define CT_WIN 4             // 32-position windows a search step tests
#define CT_SMEM_MAX 232448   // shared bytes one block may use

// Mirrored field for field by ctypes in processors/_cuda.py.
struct CascadeParams {
    const float* w;    // (B, n)
    const float* base; // (B,)
    const float* t;    // (B,)
    float* out;        // (m, B)
    int B;
    int n;
    int m;
    float factors[CT_MAX_LINKS];
    int dirs[CT_MAX_LINKS];
    int starts[CT_MAX_LINKS];
};

__device__ __forceinline__ void ct_cp_async16(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void ct_cp_async4(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void ct_cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Floats a row's buffer takes: n rounded up to 16 bytes.
static __host__ __device__ __forceinline__ int ct_stride(int n) {
    return (n + 3) & ~3;
}

// Copy row wr (n samples) into buf, each lane a share; returns at once.
__device__ __forceinline__ void ct_stage(float* buf, const float* wr, int n,
                                         bool vec, int lane) {
    if (vec) {
        for (int j = lane; j < (n >> 2); j += 32)
            ct_cp_async16(buf + 4 * j, wr + 4 * j);
    } else {
        for (int i = lane; i < n; i += 32) ct_cp_async4(buf + i, wr + i);
    }
}

// Whether the staged row holds a NaN, in every lane.
__device__ __forceinline__ bool ct_row_nan(const float* x, int n, bool vec,
                                           int lane) {
    bool nan = false;
    if (vec) {
        const float4* x4 = reinterpret_cast<const float4*>(x);
        for (int j = lane; j < (n >> 2); j += 32) {
            const float4 v = x4[j];
            nan |= isnan(v.x) | isnan(v.y) | isnan(v.z) | isnan(v.w);
        }
    } else {
        for (int i = lane; i < n; i += 32) nan |= isnan(x[i]);
    }
    return __any_sync(FULL_MASK, nan) != 0;
}

// First forward crossing at or after s (i in [s, n-2]) or -1, the same in
// every lane: windows [b + 32u, b + 32u + 31] from b = s up.
__device__ __forceinline__ int ct_search_fwd(const float* x, int n, int s,
                                             float a, int lane) {
    for (int b = s; b <= n - 2; b += 32 * CT_WIN) {
        unsigned hit[CT_WIN];
#pragma unroll
        for (int u = 0; u < CT_WIN; ++u) {
            const int i = b + 32 * u + lane;
            hit[u] = __ballot_sync(FULL_MASK, i <= n - 2 && cross_fwd(x, i, a));
        }
#pragma unroll
        for (int u = 0; u < CT_WIN; ++u)
            if (hit[u]) return b + 32 * u + __ffs(hit[u]) - 1;
    }
    return -1;
}

// Last backward crossing at or before s (i in [1, s]) or -1, the same in
// every lane: windows [top - 32u - 31, top - 32u] from top = s down, lane
// order ascending within a window.
__device__ __forceinline__ int ct_search_bwd(const float* x, int s, float a,
                                             int lane) {
    for (int top = s; top >= 1; top -= 32 * CT_WIN) {
        unsigned hit[CT_WIN];
#pragma unroll
        for (int u = 0; u < CT_WIN; ++u) {
            const int i = top - 32 * u - 31 + lane;
            hit[u] = __ballot_sync(FULL_MASK, i >= 1 && cross_bwd(x, i, a));
        }
#pragma unroll
        for (int u = 0; u < CT_WIN; ++u)
            if (hit[u]) return top - 32 * u - __clz(hit[u]);
    }
    return -1;
}

// The m links of one staged row x with its start t and base; lanes
// 0..m-1 store the outputs.
__device__ __forceinline__ void ct_row(const CascadeParams& P, const float* x,
                                       long long row, float t, float base,
                                       bool vec, int lane) {
    const int n = P.n, m = P.m;
    const bool row_bad = ct_row_nan(x, n, vec, lane);
    const float tt = truncf(t);
    const bool root_bad = row_bad || !(tt == t && tt >= 0.f && tt < (float)n);
    const int root_s = root_bad ? -1 : (int)tt;  // -1: a bad start

    int mine = -1;  // lane k: link k's index, -1 where the link is bad
    for (int k = 0; k < m; ++k) {
        const int from = P.starts[k];
        const int s = from < 0 ? root_s : __shfl_sync(FULL_MASK, mine, from);
        const float f = P.factors[k];
        const float a = f == 1.f ? base : __fmul_rn(f, base);
        int idx = -1;
        if (s >= 0 && !isnan(a))
            idx = P.dirs[k] == 1 ? ct_search_fwd(x, n, s, a, lane)
                                 : ct_search_bwd(x, s, a, lane);
        if (lane == k) mine = idx;
    }
    if (lane < m)
        P.out[(long long)lane * P.B + row] =
            mine < 0 ? __int_as_float(0x7fc00000) : (float)mine;
}

__global__ void __launch_bounds__(32 * CT_MAX_ROWS)
cascade_tp_kernel(const __grid_constant__ CascadeParams P) {
    extern __shared__ __align__(16) float ct_smem[];
    const int lane = threadIdx.x & 31;
    const int rows = blockDim.x >> 5;
    const int n = P.n;
    float* buf = ct_smem + (size_t)(threadIdx.x >> 5) * ct_stride(n);
    const bool vec = ((reinterpret_cast<uintptr_t>(P.w) | (uintptr_t)n * 4) & 15) == 0;
    const long long step = (long long)gridDim.x * rows;
    for (long long row = (long long)blockIdx.x * rows + (threadIdx.x >> 5);
         row < P.B; row += step) {
        ct_stage(buf, P.w + row * n, n, vec, lane);
        const float t = P.t[row], base = P.base[row];  // loaded during the copy
        ct_cp_async_wait_all();
        __syncwarp();
        ct_row(P, buf, row, t, base, vec, lane);
        __syncwarp();  // every lane is done with buf before the next copy
    }
}

// Rows a block for rows of n samples (0 where one row does not fit), its
// shared bytes, and its blocks per SM.
static cudaError_t ct_launch(int n, int* rows, int* smem, int* per_sm) {
    const int row_bytes = 4 * ct_stride(n);
    *rows = CT_SMEM_MAX / row_bytes < CT_MAX_ROWS ? CT_SMEM_MAX / row_bytes
                                                  : CT_MAX_ROWS;
    if (*rows < 1) return cudaErrorInvalidValue;
    *smem = *rows * row_bytes;
    cudaError_t err = cudaFuncSetAttribute(
        cascade_tp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, cascade_tp_kernel, 32 * *rows, *smem);
}

extern "C" int dspeed_cascade_tp(const CascadeParams* p, void* stream) {
    if (p->m < 1 || p->m > CT_MAX_LINKS) return (int)cudaErrorInvalidValue;
    int rows, smem, per_sm, dev, sms;
    cudaError_t err = ct_launch(p->n, &rows, &smem, &per_sm);
    if (err != cudaSuccess) return (int)err;
    if (p->B == 0) return 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const long long need = ((long long)p->B + rows - 1) / rows;
    const long long full = (long long)per_sm * sms;
    const int blocks = (int)(need < full ? need : full);
    cascade_tp_kernel<<<blocks, 32 * rows, smem, (cudaStream_t)stream>>>(*p);
    return (int)cudaGetLastError();
}

// How rows of n samples launch: rows (one a warp) and threads a block,
// shared bytes a block, blocks per SM, registers and local bytes a thread.
extern "C" int dspeed_cascade_tp_config(int n, int* out) {
    int rows, smem, per_sm;
    cudaError_t err = ct_launch(n, &rows, &smem, &per_sm);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, cascade_tp_kernel)) != cudaSuccess)
        return (int)err;
    const int vals[] = {rows,   32 * rows,    smem,
                        per_sm, attr.numRegs, (int)attr.localSizeBytes};
    for (int i = 0; i < 6; ++i) out[i] = vals[i];
    return 0;
}

extern "C" const char* dspeed_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
