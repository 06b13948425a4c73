// The A/E current front for Hopper (sm_90a): upsample the current c by
// replication (x[j] = c[(j + half) / ratio], j < n_up), run `num`
// alternating moving averages of L samples over x, and reduce to the
// first-occurrence t_min, t_max, a_min, a_max. Two routes, chosen by the
// wrapper from the geometry alone (processors/_poly_plan.py):
//
// K6, `fused_current_kernel`, the up-domain route, replaces
// `_fused_current_kernel` / `_fused_current_call`
// (dspeed_tpu/processors/_pallas.py:572, :637). It runs the cascade at full
// upsampled width.
//
// K5, `fused_current_poly_kernel`, the polyphase route, replaces
// `_fused_current_poly_kernel` / `_fused_current_poly_call` (:804, :910;
// plan `_poly_plan` :705). Away from the edges the cascade is a linear
// filter, and on a replicated row it collapses to one short filter per
// phase: y[ratio*t + p] = sum_k H[p][k] c[t + q_min + k] (11 taps at the
// flagship geometry). Only the two W-sample windows at the true edges run
// the staged cascade; the plan proves which outputs each method owns.
//
// Both: a row of c holding a NaN gives NaN in all four outputs. With need
// clearing both t_min and a_min (or t_max and a_max) that extremum is not
// reduced, and an output nothing needs holds 0.
//
// What bounds them on this card: at the flagship geometry (n_curr 300, ratio
// 16, n_up 4784, L 48, 3 stages) a row is 1.2 KB read and 16 bytes written:
// 19.7 MB per 16384 rows, 6 us at 3.35 TB/s. K5's work is 4640 x 11 FMAs in
// the interior plus 2 x 3 float64 prefix stages over 256 samples at the
// edges, about 0.12 MFLOP a row; K6's is 3 float64 prefix stages over 4784
// samples, with a handful of float64 operations per sample. Both are bound
// by operations, and in practice by the barriers of their block scans.
//
// How the design meets it: one block of 256 threads per row, everything in
// shared memory. The TPU's triangular-matmul cumsums (`tri`, `sup`,
// `triL`), the dense banded interior matmuls (`A`, `A_last`), the one-hot
// window matrices (`RL`, `RR`) and the row tilings exist for its matrix
// unit and are gone. The cascade is mw_cascade.cuh (a float64 block scan
// per stage, rounding to float32 per stage, as the plain version does); the
// replication is plain indexing; K5's interior is float32 FMAs in ascending
// tap order, thread by thread. Each route writes its whole upsampled curve
// y[0, n_up) to shared memory in ascending j, region by region, and one
// first-occurrence reduction (lower index on ties) takes the extrema: the
// same result as the TPU kernel's ordered fold of the regions with strict
// comparisons.

#include <cuda_runtime.h>
#include <math.h>

#include "block_reduce.cuh"
#include "mw_cascade.cuh"

#define CUR_THREADS 256

// Mirrored field for field by ctypes in processors/_cuda.py.
struct CurrentParams {
    const float* c;  // (B, n_curr)
    const float* H;  // K5: (ratio, nq) per-phase filters
    float* out[4];   // t_min, t_max, a_min, a_max, each (B,)
    int B;
    int n_curr;
    int ratio;
    int half;
    int n_up;
    int L;
    int num;
    int mtype;
    int need[4];
    // K5's plan (processors/_poly_plan.py)
    int W;
    int EL;
    int ERW;
    int nq;
    int q_min;
};

// Reads row `row` of c into cs (when not null) and returns, to every
// thread, whether it holds a NaN; ends with a barrier.
__device__ bool load_current(const CurrentParams& P, long long row, float* cs) {
    const float* cr = P.c + row * (long long)P.n_curr;
    int has_nan = 0;
    for (int i = threadIdx.x; i < P.n_curr; i += blockDim.x) {
        const float v = cr[i];
        has_nan |= isnan(v);
        if (cs) cs[i] = v;
    }
    return __syncthreads_or(has_nan) != 0;
}

// First-occurrence extrema of y[0, n) into the row's four outputs.
__device__ void store_extrema(const CurrentParams& P, const float* y, int n,
                              bool bad, long long row, float* redf,
                              int* redi) {
    const bool nmin = P.need[0] || P.need[2], nmax = P.need[1] || P.need[3];
    float vmin = 0.f, vmax = 0.f;
    int imin = n, imax = n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float v = y[i];
        if (nmin && (imin == n || v < vmin)) { vmin = v; imin = i; }
        if (nmax && (imax == n || v > vmax)) { vmax = v; imax = i; }
    }
    if (nmin) block_argext(vmin, imin, false, n, redf, redi);
    if (nmax) block_argext(vmax, imax, true, n, redf, redi);
    if (threadIdx.x == 0) {
        const float qnan = __int_as_float(0x7fc00000);
        P.out[0][row] = bad ? qnan : (P.need[0] ? (float)imin : 0.f);
        P.out[1][row] = bad ? qnan : (P.need[1] ? (float)imax : 0.f);
        P.out[2][row] = bad ? qnan : (nmin ? vmin : 0.f);
        P.out[3][row] = bad ? qnan : (nmax ? vmax : 0.f);
    }
}

// ---------------------------------------------------------------------------
// K6: the up-domain route

extern "C" int dspeed_fused_current_smem_bytes(int n_up) {
    return 8 * n_up + 4 * n_up;  // f64 prefix, the upsampled row
}

__global__ void __launch_bounds__(CUR_THREADS)
fused_current_kernel(const CurrentParams P) {
    extern __shared__ double smem[];
    __shared__ double red[32];
    __shared__ float redf[32];
    __shared__ int redi[32];

    const int n_up = P.n_up;
    double* ps = smem;
    float* x = (float*)(ps + n_up);
    const long long row = blockIdx.x;
    const float* cr = P.c + row * (long long)P.n_curr;
    for (int j = threadIdx.x; j < n_up; j += blockDim.x)
        x[j] = cr[(j + P.half) / P.ratio];
    const bool bad = load_current(P, row, nullptr);
    mw_cascade(x, n_up, P.L, P.num, P.mtype, ps, red);
    store_extrema(P, x, n_up, bad, row, redf, redi);
}

extern "C" int dspeed_fused_current(const CurrentParams* p, void* stream) {
    const int smem = dspeed_fused_current_smem_bytes(p->n_up);
    cudaError_t err = cudaFuncSetAttribute(
        fused_current_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (p->B == 0) return 0;
    fused_current_kernel<<<p->B, CUR_THREADS, smem, (cudaStream_t)stream>>>(*p);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5: the polyphase route

extern "C" int dspeed_fused_current_poly_smem_bytes(int n_curr, int n_up,
                                                    int n_h, int W) {
    // f64 prefix of a window; c, the filters, the right window, the curve
    return 8 * W + 4 * (n_curr + n_h + W + n_up);
}

__global__ void __launch_bounds__(CUR_THREADS)
fused_current_poly_kernel(const CurrentParams P) {
    extern __shared__ double smem[];
    __shared__ double red[32];
    __shared__ float redf[32];
    __shared__ int redi[32];

    const int n_up = P.n_up, W = P.W, ratio = P.ratio, nq = P.nq;
    const int tid = threadIdx.x, bd = blockDim.x;
    double* ps = smem;
    float* cs = (float*)(ps + W);
    float* hs = cs + P.n_curr;
    float* win = hs + ratio * nq;
    float* y = win + W;
    const long long row = blockIdx.x;
    for (int k = tid; k < ratio * nq; k += bd) hs[k] = P.H[k];
    const bool bad = load_current(P, row, cs);

    // left edge: the window [0, W) cascaded in place in y; [0, EL) is kept
    for (int j = tid; j < W; j += bd) y[j] = cs[(j + P.half) / ratio];
    __syncthreads();
    mw_cascade(y, W, P.L, P.num, P.mtype, ps, red);

    // right edge: the window [n_up - W, n_up); its last ERW samples are kept
    const int j0 = n_up - W;
    for (int k = tid; k < W; k += bd) win[k] = cs[(j0 + k + P.half) / ratio];
    __syncthreads();
    mw_cascade(win, W, P.L, P.num, P.mtype, ps, red);
    const int j_end = n_up - P.ERW;
    for (int k = tid; k < P.ERW; k += bd) y[j_end + k] = win[W - P.ERW + k];

    // interior [EL, j_end): per-phase filters on the current itself
    for (int j = P.EL + tid; j < j_end; j += bd) {
        const int t = j / ratio, p = j - t * ratio;
        const float* cc = cs + t + P.q_min;
        const float* hp = hs + p * nq;
        float acc = 0.f;
        for (int k = 0; k < nq; ++k) acc = fmaf(hp[k], cc[k], acc);
        y[j] = acc;
    }
    __syncthreads();
    store_extrema(P, y, n_up, bad, row, redf, redi);
}

extern "C" int dspeed_fused_current_poly(const CurrentParams* p, void* stream) {
    const int smem = dspeed_fused_current_poly_smem_bytes(
        p->n_curr, p->n_up, p->ratio * p->nq, p->W);
    cudaError_t err = cudaFuncSetAttribute(
        fused_current_poly_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    if (p->B == 0) return 0;
    fused_current_poly_kernel<<<p->B, CUR_THREADS, smem, (cudaStream_t)stream>>>(
        *p);
    return (int)cudaGetLastError();
}

extern "C" const char* dspeed_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
