// Rise-time cascade (K2) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_cascade_kernel` / `_cascade_call`
// (dspeed_tpu/processors/_pallas.py:1528, :1621; entry `cascade_tp` :1650).
// Per event row w it runs m threshold searches in order. Link k has the
// threshold thr[row, k] (computed by the wrapper, factor_k * base, with the
// engine's arithmetic) and starts from t[row] (starts[k] < 0) or from the
// result of link starts[k]:
//   forward  (dirs[k] == 1): the smallest i >= s with a crossing between
//            w[i] and w[i+1];
//   backward (dirs[k] == 0): the largest i <= s with a crossing between
//            w[i-1] and w[i];
// with time_point_thresh's predicates (block_reduce.cuh `cross_fwd`,
// `cross_bwd`). The root start is bad on a row with a NaN, a NaN start, a
// start that is not integral or lies outside [0, n) (_pallas.py:1536-1540).
// A link is NaN where its start is bad, its threshold is NaN, or nothing is
// found. The kernel only compares floats, so it is bit-identical to the
// plain version (processors/_cuda.py `cascade_tp_plain`).
//
// What bounds it on this card: bytes. Each row is read once (16 KB of a
// 4096-sample row, 268 MB per 16384 rows: 0.08 ms at 3.35 TB/s); the links
// compare a few samples each.
//
// How the design meets it: one thread block per row, with the row in shared
// memory. Each link is a block-wide search that walks from its start a
// block-width chunk at a time and stops at the first chunk holding a
// crossing; the hit is reduced to the first (forward) or last (backward)
// index and every thread gets it, so it starts the next link with no trip
// to device memory. The TPU kernel's rank planes and per-direction bit
// planes (_pallas.py:1549-1572) fed its vector unit; direct float compares
// on shared memory need neither. Up to CT_MAX_LINKS links; the TPU's
// n % 128 and n >= 256 gates do not apply.

#include <cuda_runtime.h>
#include <math.h>

#include "block_reduce.cuh"

#define CT_THREADS 256
#define CT_MAX_LINKS 16

// Mirrored field for field by ctypes in processors/_cuda.py.
struct CascadeParams {
    const float* w;
    const float* thr;  // (B, m)
    const float* t;    // (B,)
    float* out;        // (m, B)
    int B;
    int n;
    int m;
    int dirs[CT_MAX_LINKS];
    int starts[CT_MAX_LINKS];
};

__global__ void __launch_bounds__(CT_THREADS)
cascade_tp_kernel(const CascadeParams P) {
    extern __shared__ float ws[];
    __shared__ int redi[32];

    const int n = P.n, m = P.m;
    const long long row = blockIdx.x;
    const float* wr = P.w + row * (long long)n;
    const float qnan = __int_as_float(0x7fc00000);

    int has_nan = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float v = wr[i];
        has_nan |= isnan(v);
        ws[i] = v;
    }
    const bool row_bad = __syncthreads_or(has_nan) != 0;

    const float t = P.t[row];
    const float tt = truncf(t);
    const bool root_bad = row_bad || !(tt == t && tt >= 0.f && tt < (float)n);
    const int root_s = root_bad ? 0 : (int)tt;

    float res[CT_MAX_LINKS];
    bool bad[CT_MAX_LINKS];
    for (int k = 0; k < m; ++k) {
        const int from = P.starts[k];
        const bool sbad = from < 0 ? root_bad : bad[from];
        const int s = from < 0 ? root_s : (sbad ? 0 : (int)res[from]);
        const float a = P.thr[row * m + k];
        int idx = -1;
        if (!sbad && !isnan(a))
            idx = P.dirs[k] == 1 ? search_fwd(ws, n, s, a, redi)
                                 : search_bwd(ws, s, a, redi);
        bad[k] = idx < 0;
        res[k] = bad[k] ? qnan : (float)idx;
        if (threadIdx.x == 0) P.out[(long long)k * P.B + row] = res[k];
    }
}

extern "C" int dspeed_cascade_tp(const CascadeParams* p, void* stream) {
    const int smem = p->n * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        cascade_tp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (p->B == 0) return 0;
    if (p->m < 1 || p->m > CT_MAX_LINKS) return (int)cudaErrorInvalidValue;
    cascade_tp_kernel<<<p->B, CT_THREADS, smem, (cudaStream_t)stream>>>(*p);
    return (int)cudaGetLastError();
}

extern "C" const char* dspeed_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
