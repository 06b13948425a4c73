// The moving-window cascade of the A/E current front in its reference
// order. No kernel includes it: the up-domain kernel (K6), the polyphase
// kernel (K5, both in fused_current.cu) and generic_rows.cu (K7) carry its
// arithmetic in code of their own, bit for bit; tools/k6_emu runs it as the
// reference that holds K6.
//
// Replaces `_mw_apply` (dspeed_tpu/processors/_pallas.py:497), which takes
// each window sum from 128-wide triangular-matmul cumsums plus the previous
// block's sum: a layout for the TPU's matrix unit. Here each stage takes the
// row's inclusive prefix in float64 with the block scan of row_prefix.cuh
// and applies the moving-window formulas of
// dspeed_tpu_torch/processors/moving_windows.py (`_mwl`, `_mwr`, ramps
// included) in float64, rounding to float32 once per stage, as the plain
// version does. The products, differences and quotients are spelled with
// the _rn intrinsics so that the compiler contracts none of them into an
// FMA: each rounds where the plain version's does.
#pragma once

#include <cuda_runtime.h>

#include "row_prefix.cuh"

// One moving average of L (>= 1) samples over the row x[0, n) in shared
// memory, in place: the left window, or with `right` the right window. ps
// (n doubles) and red (32 doubles) are scratch. Called by every thread of the
// block; ends with a barrier.
__device__ void mw_stage(float* x, int n, int L, bool right, double* ps,
                         double* red) {
    block_inclusive_prefix(x, ps, n, red);
    const double w0 = (double)x[0], wl = (double)x[n - 1];
    const double lf = (double)L;
    __syncthreads();  // x[0] and x[n-1] are read before any slot is written
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        double v;
        if (!right) {
            // i < L: w0 + (S[i] - (i+1) w0) / L; else (S[i] - S[i-L]) / L
            if (i < L)
                v = __dadd_rn(w0, __ddiv_rn(__dsub_rn(ps[i],
                        __dmul_rn((double)(i + 1), w0)), lf));
            else
                v = __ddiv_rn(__dsub_rn(ps[i], ps[i - L]), lf);
        } else {
            // i > n-1-L: wl + ((S[n-1] - S[i-1]) - (n-i) wl) / L;
            // else (S[i+L-1] - S[i-1]) / L
            const double se = i > 0 ? ps[i - 1] : 0.0;
            if (i > n - 1 - L)
                v = __dadd_rn(wl, __ddiv_rn(__dsub_rn(__dsub_rn(ps[n - 1], se),
                        __dmul_rn((double)(n - i), wl)), lf));
            else
                v = __ddiv_rn(__dsub_rn(ps[i + L - 1], se), lf);
        }
        x[i] = (float)v;
    }
    __syncthreads();
}

// `num` alternating moving averages of L samples on x[0, n), in place:
// mtype 0 alternates starting left, 1 is only left, 2 only right
// (moving_window_multi). Ends with a barrier.
__device__ void mw_cascade(float* x, int n, int L, int num, int mtype,
                           double* ps, double* red) {
    for (int it = 0; it < num; ++it) {
        const bool right = ((it % 2 == 1) && mtype == 0) || mtype == 2;
        mw_stage(x, n, L, right, ps, red);
    }
    __syncthreads();
}
