// Block-wide reductions of the port's one-row-per-block kernels: fused_t0.cu
// (K3), and mw_cascade.cuh's reference order; cascade_tp.cu (K2),
// generic_rows.cu (K7) and fused_current.cu (K5, K6) take only the
// warp-level pieces (FULL_MASK, warp_sum, ext_better, the crossing
// predicates). Every block function is
// called by all threads of the block (blockDim.x a multiple of 32, at most
// 1024) and hands every thread the result; the scratch arrays hold 32
// entries.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

#define FULL_MASK 0xffffffffu

__device__ __forceinline__ double warp_sum(double v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL_MASK, v, o);
    return v;
}

// Sum over the block.
__device__ double block_sum(double v, double* red) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    v = warp_sum(v);
    __syncthreads();
    if (lane == 0) red[wid] = v;
    __syncthreads();
    if (wid == 0) {
        double t = lane < nw ? red[lane] : 0.0;
        t = warp_sum(t);
        if (lane == 0) red[0] = t;
    }
    __syncthreads();
    return red[0];
}

__device__ float block_max(float v, float* red) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_down_sync(FULL_MASK, v, o));
    __syncthreads();
    if (lane == 0) red[wid] = v;
    __syncthreads();
    if (wid == 0) {
        float t = lane < nw ? red[lane] : -INFINITY;
        for (int o = 16; o > 0; o >>= 1)
            t = fmaxf(t, __shfl_down_sync(FULL_MASK, t, o));
        if (lane == 0) red[0] = t;
    }
    __syncthreads();
    return red[0];
}

// Smallest / largest int over the block (a search's first / last hit).
__device__ int block_min_int(int v, int* red) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    v = __reduce_min_sync(FULL_MASK, v);
    __syncthreads();
    if (lane == 0) red[wid] = v;
    __syncthreads();
    if (wid == 0) {
        int t = lane < nw ? red[lane] : INT_MAX;
        t = __reduce_min_sync(FULL_MASK, t);
        if (lane == 0) red[0] = t;
    }
    __syncthreads();
    return red[0];
}

__device__ int block_max_int(int v, int* red) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    v = __reduce_max_sync(FULL_MASK, v);
    __syncthreads();
    if (lane == 0) red[wid] = v;
    __syncthreads();
    if (wid == 0) {
        int t = lane < nw ? red[lane] : INT_MIN;
        t = __reduce_max_sync(FULL_MASK, t);
        if (lane == 0) red[0] = t;
    }
    __syncthreads();
    return red[0];
}

// First-occurrence extremum: (v, i) beats (v2, i2) when v is strictly more
// extreme, or equal with a smaller index. i == n marks "no candidate".
__device__ __forceinline__ bool ext_better(float v, int i, float v2, int i2,
                                           bool is_max, int n) {
    if (i2 == n) return i != n;
    if (i == n) return false;
    if (is_max ? (v > v2) : (v < v2)) return true;
    return v == v2 && i < i2;
}

// (value, index) of the block's extremum, the lower index on ties.
__device__ void block_argext(float& v, int& i, bool is_max, int n, float* redf,
                             int* redi) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    for (int o = 16; o > 0; o >>= 1) {
        float v2 = __shfl_down_sync(FULL_MASK, v, o);
        int i2 = __shfl_down_sync(FULL_MASK, i, o);
        if (ext_better(v2, i2, v, i, is_max, n)) { v = v2; i = i2; }
    }
    __syncthreads();
    if (lane == 0) { redf[wid] = v; redi[wid] = i; }
    __syncthreads();
    if (wid == 0) {
        float t = lane < nw ? redf[lane] : 0.f;
        int ti = lane < nw ? redi[lane] : n;
        for (int o = 16; o > 0; o >>= 1) {
            float v2 = __shfl_down_sync(FULL_MASK, t, o);
            int i2 = __shfl_down_sync(FULL_MASK, ti, o);
            if (ext_better(v2, i2, t, ti, is_max, n)) { t = v2; ti = i2; }
        }
        if (lane == 0) { redf[0] = t; redi[0] = ti; }
    }
    __syncthreads();
    v = redf[0];
    i = redi[0];
}

// linear_slope_fit over x[a0:b0]: (mean, sample stdev, slope, intercept).
__device__ void slope_fit(const float* x, int a0, int b0, double* red,
                          float* q) {
    const int L = b0 - a0;
    double sy = 0.0, sxy = 0.0;
    for (int j = threadIdx.x; j < L; j += blockDim.x) {
        const double v = (double)x[a0 + j];
        sy += v;
        sxy += v * (double)j;
    }
    sy = block_sum(sy, red);
    sxy = block_sum(sxy, red);
    const double mean = sy / L;
    double ss = 0.0;
    for (int j = threadIdx.x; j < L; j += blockDim.x) {
        const double d = (double)x[a0 + j] - mean;
        ss += d * d;
    }
    ss = block_sum(ss, red);
    const double var = L > 1 ? ss / (double)(L - 1) : 0.0;
    const double Ld = (double)L;
    const double sum_x = Ld * (Ld - 1.0) / 2.0;
    const double sum_x2 = (Ld - 1.0) * Ld * (2.0 * Ld - 1.0) / 6.0;
    const double slope = (Ld * sxy - sum_x * sy) / (Ld * sum_x2 - sum_x * sum_x);
    q[0] = (float)mean;
    q[1] = (float)sqrt(var);
    q[2] = (float)slope;
    q[3] = (float)((sy - sum_x * slope) / Ld);
}

// The threshold-crossing predicates of time_point_thresh
// (processors/time_point_thresh.py `_crossing_masks`): a forward crossing
// between samples i and i+1, reported at i, and a backward crossing between
// i-1 and i, reported at i. A NaN threshold crosses nowhere.
__device__ __forceinline__ bool cross_fwd(const float* x, int i, float a) {
    const float x0 = x[i], x1 = x[i + 1];
    return (x0 <= a && a < x1) || (x0 >= a && a > x1);
}

__device__ __forceinline__ bool cross_bwd(const float* x, int i, float a) {
    const float x0 = x[i - 1], x1 = x[i];
    return (x0 < a && a <= x1) || (x0 > a && a >= x1);
}

// First forward crossing at or after s (i in [s, n-2]) over the row x in
// shared memory, or -1: the block walks up in chunks of blockDim.x samples
// and stops at the first chunk that holds a hit. s must be the same in
// every thread.
__device__ int search_fwd(const float* x, int n, int s, float a, int* red) {
    for (int base = s; base <= n - 2; base += blockDim.x) {
        const int i = base + (int)threadIdx.x;
        const bool hit = i <= n - 2 && cross_fwd(x, i, a);
        if (__syncthreads_or(hit)) return block_min_int(hit ? i : INT_MAX, red);
    }
    return -1;
}

// Last backward crossing at or before s (i in [1, s]), or -1; chunks walk
// down from s.
__device__ int search_bwd(const float* x, int s, float a, int* red) {
    for (int base = s; base >= 1; base -= blockDim.x) {
        const int i = base - (int)threadIdx.x;
        const bool hit = i >= 1 && cross_bwd(x, i, a);
        if (__syncthreads_or(hit)) return block_max_int(hit ? i : -1, red);
    }
    return -1;
}
