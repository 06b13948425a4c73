// Float64 prefix sums of one row in shared memory and the trapezoid windows
// read off them, used by fused_t0.cu (K3) and by mw_cascade.cuh's reference
// order; the up-domain kernel K6 (fused_current.cu) keeps the block scan's
// runs and scan tree with each run in registers, and generic_rows.cu (K7)
// in a conflict-free layout of its own.
//
// The TPU kernels fight float32 cancellation in long prefix sums with
// split-bf16 matmul prefixes (dspeed_tpu/processors/_pallas.py `_split3_k`
// :125, `_blocked_prefix` :137). Here the prefix is a float64 block scan:
// each thread sums a contiguous run serially and the warps scan the run
// totals with shuffles. Trapezoid windows of <= 32 samples are summed
// directly from the float32 samples, as on the TPU (`_trap_windows`
// :159-166).
#pragma once

#include <cuda_runtime.h>

#include "block_reduce.cuh"

struct TrapSpec {
    int kind;  // 0 = norm (rise, flat), 1 = asym (rise, flat, fall)
    int rise;
    int flat;
    int fall;
};

// Exclusive scan of one double per thread, in thread order.
__device__ double block_excl_scan(double v, double* red) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    double x = v;
    for (int o = 1; o < 32; o <<= 1) {
        double y = __shfl_up_sync(FULL_MASK, x, o);
        if (lane >= o) x += y;
    }
    double excl = __shfl_up_sync(FULL_MASK, x, 1);
    if (lane == 0) excl = 0.0;
    __syncthreads();
    if (lane == 31) red[wid] = x;
    __syncthreads();
    if (wid == 0) {
        double t = lane < nw ? red[lane] : 0.0;
        for (int o = 1; o < 32; o <<= 1) {
            double y = __shfl_up_sync(FULL_MASK, t, o);
            if (lane >= o) t += y;
        }
        if (lane < nw) red[lane] = t;
    }
    __syncthreads();
    return (wid > 0 ? red[wid - 1] : 0.0) + excl;
}

// The contiguous run [j0, j1) of a row of n samples that this thread scans.
__device__ __forceinline__ void scan_run(int n, int& j0, int& j1) {
    const int per = (n + blockDim.x - 1) / blockDim.x;
    j0 = min(n, (int)threadIdx.x * per);
    j1 = min(n, j0 + per);
}

// ps[i] = sum of xs[0..i] in float64; ends with a barrier.
__device__ void block_inclusive_prefix(const float* xs, double* ps, int n,
                                       double* red) {
    int j0, j1;
    scan_run(n, j0, j1);
    double run = 0.0;
    for (int j = j0; j < j1; ++j) run += (double)xs[j];
    double s = block_excl_scan(run, red);
    for (int j = j0; j < j1; ++j) {
        s += (double)xs[j];
        ps[j] = s;
    }
    __syncthreads();
}

// Sum of x over [i - off - len + 1, i - off], zero outside the row. Windows
// of <= 32 samples add the samples directly; longer ones difference the
// inclusive prefix ps.
__device__ __forceinline__ double win_sum(const float* xs, const double* ps,
                                          int i, int len, int off) {
    const int hi = i - off;
    const int lo = hi - len + 1;
    if (hi < 0) return 0.0;
    if (len <= 32) {
        double acc = 0.0;
        for (int k = lo < 0 ? 0 : lo; k <= hi; ++k) acc += (double)xs[k];
        return acc;
    }
    return ps[hi] - (lo >= 1 ? ps[lo - 1] : 0.0);
}

// trap_norm (rise, flat) or asym_trap_filter (rise, flat, fall) at sample i.
__device__ __forceinline__ float trap_at(const TrapSpec& t, const float* xs,
                                         const double* ps, int i) {
    if (t.kind == 0) {
        const double d1 = win_sum(xs, ps, i, t.rise, 0);
        const double d2 = win_sum(xs, ps, i, t.rise, t.rise + t.flat);
        return (float)((d1 - d2) / (double)t.rise);
    }
    const double d1 = win_sum(xs, ps, i, t.rise, 0);
    const double d2 = win_sum(xs, ps, i, t.fall, t.rise + t.flat);
    return (float)(d1 / (double)t.rise - d2 / (double)t.fall);
}
