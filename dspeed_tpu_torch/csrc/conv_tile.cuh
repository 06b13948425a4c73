// The register-tiled f32 FMA convolution loop of banded_conv.cu (K4),
// fused_t0.cu (K3) and generic_rows.cu (K7).
//
// Each thread owns R consecutive outputs for NK kernels. Every output is
// summed in exactly the order of conv_row.cuh's conv_row_accumulate: per
// chunk of CONV_CHUNK taps a partial starts at 0.f and takes one fmaf per
// tap in increasing tap order, then acc += partial, chunks in increasing
// order. So the outputs equal, bit for bit, those of conv_row.cuh's
// reference loop, whatever R; only which thread sums
// which output, and how the operands reach the registers, differ.
//
// Per chunk a thread loads the R + CONV_CHUNK - 1 window samples its
// outputs read once, as 16-byte shared loads, and each group of 4 taps of
// each kernel as one 16-byte broadcast load; then it runs the chunk's
// CONV_CHUNK * R * NK FMAs from registers. Neighbouring threads' windows
// start R samples apart; for R = 4 (mod 8) a quarter warp's 16-byte loads
// hit 8 distinct groups of 4 banks, so the window loads are conflict-free.
#pragma once

#include <cuda_runtime.h>

#include "conv_row.cuh"

// One chunk: acc[r][j] += (sum over taps t = c0 .. c0 + nt - 1, in
// increasing order, of x[o_r - t] * k_j[t], from a partial of 0.f), where
// o_r is this thread's output r. wx points at the sample x[o_0 - c0 -
// CONV_CHUNK + 1] in shared memory (the sample of output 0 and the chunk's
// last tap slot); kc at k_0[c0], kernel j at kc + j * kstride. Both are
// 16-byte aligned. The thread reads wx[0, 4 * L) and kc[j * kstride + 0,
// CONV_CHUNK); without FULL only the first nt < CONV_CHUNK taps are summed.
template <int R, int NK, bool FULL>
__device__ __forceinline__ void conv_tile_chunk(const float* __restrict__ wx,
                                                const float* __restrict__ kc,
                                                int kstride, int nt,
                                                float (&acc)[R][NK]) {
    static_assert(R % 4 == 0, "a thread's outputs start 16-byte aligned");
    constexpr int L = (R + CONV_CHUNK - 1 + 3) / 4;
    float x[4 * L];
#pragma unroll
    for (int q = 0; q < L; ++q) {
        const float4 v = reinterpret_cast<const float4*>(wx)[q];
        x[4 * q] = v.x;
        x[4 * q + 1] = v.y;
        x[4 * q + 2] = v.z;
        x[4 * q + 3] = v.w;
    }
    float part[R][NK];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < NK; ++j) part[r][j] = 0.f;
#pragma unroll
    for (int t4 = 0; t4 < CONV_CHUNK; t4 += 4) {
        if (!FULL && t4 >= nt) break;
        float kv[NK][4];
#pragma unroll
        for (int j = 0; j < NK; ++j) {
            const float4 v =
                *reinterpret_cast<const float4*>(kc + j * kstride + t4);
            kv[j][0] = v.x;
            kv[j][1] = v.y;
            kv[j][2] = v.z;
            kv[j][3] = v.w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int t = t4 + u;
            if (FULL || t < nt) {
#pragma unroll
                for (int r = 0; r < R; ++r)
#pragma unroll
                    for (int j = 0; j < NK; ++j)
                        part[r][j] = fmaf(x[r + CONV_CHUNK - 1 - t], kv[j][u],
                                          part[r][j]);
            }
        }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < NK; ++j) acc[r][j] += part[r][j];
}

// acc[r][j] = sum over the m taps of kernel j of x[o_r - t] * k_j[t], for
// this thread's R consecutive outputs o_0 .. o_0 + R - 1. w31 points at the
// sample x[o_0 - CONV_CHUNK + 1] in a shared window that holds every sample
// from x[o_0 - mc + 1], mc = m rounded up to CONV_CHUNK (those past tap
// m - 1 are read, never summed), to x[o_0 + 4L - CONV_CHUNK], L = the
// 16-byte loads of R + CONV_CHUNK - 1 samples. ks holds kernel j at ks + j
// * kstride, kstride a multiple of 4 and at least m. w31 and ks are
// 16-byte aligned.
template <int R, int NK>
__device__ __forceinline__ void conv_tile_accumulate(const float* w31,
                                                     const float* ks,
                                                     int kstride, int m,
                                                     float (&acc)[R][NK]) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < NK; ++j) acc[r][j] = 0.f;
    int c0 = 0;
#pragma unroll 1
    for (; c0 + CONV_CHUNK <= m; c0 += CONV_CHUNK)
        conv_tile_chunk<R, NK, true>(w31 - c0, ks + c0, kstride, CONV_CHUNK,
                                     acc);
    if (c0 < m)
        conv_tile_chunk<R, NK, false>(w31 - c0, ks + c0, kstride, m - c0, acc);
}
