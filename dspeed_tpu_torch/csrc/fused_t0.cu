// Fused t0 front (K3) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_t0_kernel` / `_fused_t0_call`
// (dspeed_tpu/processors/_pallas.py:1140, :1255; entry `fused_t0` :1315).
// Per event row w (the pole-zero waveform) it computes, in one pass:
//   c     = convolve(w, taps, 'same')          (numpy's window, lo = (m-1)//2)
//   t_min, t_max, a_min, a_max = min_max(c)    (first occurrence on ties)
//   tp_0  = last i <= t_max with a crossing of a = a_std[row] between
//           c[i-1] and c[i]                    (time_point_thresh, walk 0)
// and, with an absorbed trapezoid (atrap), the same backward search from the
// same t_max over trap(w). With an absorbed A/E current (curr_spec: n_curr
// > 0) it also writes the row
//   curr[i] = (wle[i + avg_len] - wle[i]) / avg_len,  i < n_curr,
// of the window wle[k] = w[tp_0 + k], k < win_m: windower(w, tp_0, win_m)
// -> avg_current(., avg_len), NaN past win_m - avg_len, and all NaN where
// tp_0 is NaN or the window runs past the row (a window slot outside the row
// is NaN, and one NaN poisons the current's row).
// The filtered row c never leaves shared memory. A row with a NaN poisons
// every output; a NaN threshold or a search that finds nothing gives NaN.
// With need_min == 0 the minimum is not computed and t_min, a_min hold 0
// (nothing reads them).
//
// What bounds it on this card: operations. The flagship's t0 kernel has 133
// taps, so the convolution is 2 * 133 * 4096 flops per row: 17.9 GFLOP per
// 16384 rows, 0.27 ms at 67 TFLOP/s in f32 outside the tensor cores, against
// 16 KB read per row (0.08 ms at 3.35 TB/s). The reductions and the search
// are a few passes over shared memory.
//
// How the design meets it: one thread block per row. The row is staged in
// shared memory with a zero halo (lo samples on the left, m-1-lo on the
// right) beside the taps, and each thread accumulates four outputs per tile
// with f32 FMAs in the fixed order of conv_row.cuh, the loop of the
// convolution bank (banded_conv.cu), so c is K4's 's' window bit for bit.
// The extrema reduce (value, index) pairs with the lower index on ties
// (block_reduce.cuh); t_max is broadcast through shared memory and the
// search walks down from it a block-width chunk at a time, stopping at the
// first chunk with a crossing. The trapezoid comes from a float64 prefix of
// the row (row_prefix.cuh, K1's rule: windows of <= 32 samples are summed
// directly). No band matrix is built and no n % 128 gate applies: those
// belong to the TPU's matrix unit. Any geometry that fits one block's shared
// memory is taken. The current reads the row already staged for the
// convolution once tp_0 is settled: a gather and one float32 subtraction and
// division per sample, so it equals the plain version bit for bit wherever
// tp_0 does. The TPU kernel's log-shift window (`_window_rows`) is a
// workaround for its row-serial gathers and is not carried over; the window
// needs no shared memory of its own.

#include <cuda_runtime.h>
#include <math.h>

#include "block_reduce.cuh"
#include "conv_row.cuh"
#include "row_prefix.cuh"

#define T0_THREADS 256
#define T0_R 4

// Mirrored field for field by ctypes in processors/_cuda.py.
struct T0Params {
    const float* w;
    const float* taps;
    const float* a;   // threshold per row
    float* out[6];    // t_min, t_max, a_min, a_max, tp_0, tp_atrap
    float* curr;      // (B, n_curr) with curr_spec
    int B;
    int n;
    int m;
    int lo;
    int need_min;
    int has_atrap;
    TrapSpec atrap;
    int win_m;        // curr_spec = (win_m, avg_len, n_curr); n_curr 0: none
    int avg_len;
    int n_curr;
};

// Padded row length: whole tiles of T0_THREADS * T0_R outputs plus the halo.
static __host__ __device__ int t0_span(int n, int m) {
    const int tile_w = T0_THREADS * T0_R;
    return (n + tile_w - 1) / tile_w * tile_w + m - 1;
}

extern "C" int dspeed_fused_t0_smem_bytes(int n, int m, int has_atrap) {
    // [f64 prefix of the row] padded row, taps, filtered row [trap row]
    const int floats = t0_span(n, m) + m + n + (has_atrap ? n : 0);
    return (has_atrap ? 8 * n : 0) + 4 * floats;
}

__global__ void __launch_bounds__(T0_THREADS)
fused_t0_kernel(const T0Params P) {
    extern __shared__ double smem[];
    __shared__ double red[32];
    __shared__ float redf[32];
    __shared__ int redi[32];

    const int n = P.n, m = P.m, bd = blockDim.x, tid = threadIdx.x;
    const int span = t0_span(n, m);
    const int pad_l = m - 1 - P.lo;
    double* ps = smem;  // only with atrap
    float* xs = (float*)(smem + (P.has_atrap ? n : 0));  // xs[q] = w[q - pad_l]
    float* ks = xs + span;
    float* c = ks + m;
    float* at = c + n;  // only with atrap
    const long long row = blockIdx.x;
    const float* wr = P.w + row * (long long)n;
    const float a = P.a[row];
    const float qnan = __int_as_float(0x7fc00000);

    int has_nan = 0;
    for (int q = tid; q < span; q += bd) {
        const int g = q - pad_l;
        const float v = (g >= 0 && g < n) ? wr[g] : 0.f;
        has_nan |= isnan(v);
        xs[q] = v;
    }
    for (int t = tid; t < m; t += bd) ks[t] = P.taps[t];
    const bool bad = __syncthreads_or(has_nan) != 0;

    // 'same' convolution, tile by tile: window of tile o0 starts at xs + o0
    const int tile_w = bd * T0_R;
    for (int o0 = 0; o0 < n; o0 += tile_w) {
        float acc[T0_R][1];
        conv_row_accumulate<T0_R, 1>(xs + o0 + tid + (m - 1), ks, m, bd, acc);
#pragma unroll
        for (int r = 0; r < T0_R; ++r) {
            const int o = o0 + tid + r * bd;
            if (o < n) c[o] = acc[r][0];
        }
    }
    __syncthreads();

    // first-occurrence extrema of c
    float vmin = 0.f, vmax = 0.f;
    int imin = n, imax = n;
    for (int i = tid; i < n; i += bd) {
        const float v = c[i];
        if (P.need_min && (imin == n || v < vmin)) { vmin = v; imin = i; }
        if (imax == n || v > vmax) { vmax = v; imax = i; }
    }
    if (P.need_min) block_argext(vmin, imin, false, n, redf, redi);
    block_argext(vmax, imax, true, n, redf, redi);

    // backward crossing search from t_max against a
    const int i0 = isnan(a) || bad ? -1 : search_bwd(c, imax, a, redi);

    if (tid == 0) {
        P.out[0][row] = bad ? qnan : (P.need_min ? (float)imin : 0.f);
        P.out[1][row] = bad ? qnan : (float)imax;
        P.out[2][row] = bad ? qnan : (P.need_min ? vmin : 0.f);
        P.out[3][row] = bad ? qnan : vmax;
        P.out[4][row] = i0 < 0 ? qnan : (float)i0;
    }
    const float* x = xs + pad_l;

    // absorbed A/E current: the window of win_m samples from tp_0 = i0
    // (1 <= i0 < n when found), differenced at avg_len
    if (P.n_curr > 0) {
        float* cr = P.curr + row * (long long)P.n_curr;
        const int L = P.avg_len;
        const bool dead = i0 < 0 || i0 + P.win_m > n;
        const float lf = (float)L;
        for (int i = tid; i < P.n_curr; i += bd)
            cr[i] = dead || i >= P.win_m - L
                ? qnan : __fdiv_rn(x[i0 + i + L] - x[i0 + i], lf);
    }
    if (!P.has_atrap) return;

    // absorbed trapezoid of the row and its own search from the same t_max
    block_inclusive_prefix(x, ps, n, red);
    for (int i = tid; i < n; i += bd) at[i] = trap_at(P.atrap, x, ps, i);
    __syncthreads();
    const int i1 = isnan(a) || bad ? -1 : search_bwd(at, imax, a, redi);
    if (tid == 0) P.out[5][row] = i1 < 0 ? qnan : (float)i1;
}

extern "C" int dspeed_fused_t0(const T0Params* p, void* stream) {
    const int smem = dspeed_fused_t0_smem_bytes(p->n, p->m, p->has_atrap);
    cudaError_t err = cudaFuncSetAttribute(
        fused_t0_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (p->B == 0) return 0;
    fused_t0_kernel<<<p->B, T0_THREADS, smem, (cudaStream_t)stream>>>(*p);
    return (int)cudaGetLastError();
}

extern "C" const char* dspeed_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
