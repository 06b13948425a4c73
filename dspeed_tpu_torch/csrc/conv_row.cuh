// The reference f32 FMA convolution loop, and the order of summation that
// conv_tile.cuh's register-tiled loop (K3, K4, K7) keeps, so that the
// port's convolutions equal each other bit for bit. The kernels take only
// CONV_CHUNK from here.
#pragma once

#include <cuda_runtime.h>

#define CONV_CHUNK 32

// acc[r][j] = sum_t wb[r * stride - t] * ks[j * m + t] over the m taps, for
// R outputs strided by `stride` (the block width, so neighbouring threads
// read neighbouring window samples) and NK kernels. wb points at the
// window sample of this thread's first output for tap 0: for outputs
// out[o] = sum_t x[lo + o - t] * k[t] over a shared window win[s] =
// x[lo + o0 - (m - 1) + s], wb = win + (o - o0) + (m - 1).
// Two-level f32 sum: CONV_CHUNK taps into a partial, partials into acc, so
// rounding grows with m / CONV_CHUNK + CONV_CHUNK terms instead of m.
template <int R, int NK>
__device__ __forceinline__ void conv_row_accumulate(const float* wb,
                                                    const float* ks, int m,
                                                    int stride,
                                                    float (&acc)[R][NK]) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < NK; ++j) acc[r][j] = 0.f;
    for (int c0 = 0; c0 < m; c0 += CONV_CHUNK) {
        const int c1 = min(m, c0 + CONV_CHUNK);
        float part[R][NK];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
            for (int j = 0; j < NK; ++j) part[r][j] = 0.f;
        for (int t = c0; t < c1; ++t) {
            float kv[NK];
#pragma unroll
            for (int j = 0; j < NK; ++j) kv[j] = ks[j * m + t];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const float x = wb[r * stride - t];
#pragma unroll
                for (int j = 0; j < NK; ++j)
                    part[r][j] = fmaf(x, kv[j], part[r][j]);
            }
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
            for (int j = 0; j < NK; ++j) acc[r][j] += part[r][j];
    }
}
