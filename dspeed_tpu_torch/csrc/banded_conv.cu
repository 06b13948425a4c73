// Banded convolution bank (K4) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_banded_conv_kernel` / `_banded_conv_call`
// (dspeed_tpu/processors/_pallas.py:999, :1020; entry `banded_conv_multi`
// :1063). For each row of w and each of nk same-length constant kernels k_j:
//   out_j[o] = sum_t w[lo + o - t] * k_j[t],   o in [0, p), t in [0, m),
// reading only w[:, :n_in] and treating samples outside [0, n_in) as zero:
// the mode window [lo, lo + p) of the full convolution of the leading n_in
// samples (the band `_band_matrix` describes, convolutions.py:136). Rows with
// a NaN in w[:, :n_in] are poisoned.
//
// What bounds it on this card: operations. 2 * nk * p * m flops per row (the
// flagship CUSP + ZAC bank, nk=2, p=301, m=1696: 2.04 MFLOP per row, 33.5 GFLOP
// per 16384 rows, 0.5 ms at the H100's 67 TFLOP/s in f32 outside the tensor
// cores) against 8 KB read per row. The sums must stay in full f32: TF32
// tensor cores keep about three digits, far from the f32 `HIGHEST` matmul
// the TPU kernel uses.
//
// How the design meets it: one thread block per (row, tile of outputs); the
// input window of the tile (tile + m - 1 samples) and all nk kernels sit in
// shared memory, and each thread accumulates R outputs (strided by the block
// width, so neighbouring threads read neighbouring window samples) for every
// kernel with f32 FMAs, summed in chunks of BC_CHUNK taps. Each window load
// feeds nk FMAs and each kernel tap R.
// No band matrix is built: that layout exists to feed the TPU's matrix unit.

#include <cuda_runtime.h>
#include <math.h>

#define BC_R 4
#define BC_MAX_THREADS 256
#define BC_MAX_NK 4
#define BC_CHUNK 32

template <int NK>
__global__ void __launch_bounds__(BC_MAX_THREADS)
banded_conv_kernel(const float* __restrict__ w, const float* __restrict__ taps,
                   float* __restrict__ out, int n_full, int n_in, int m, int lo,
                   int p, int ntiles) {
    extern __shared__ float sm[];
    const int bd = blockDim.x;
    const int tid = threadIdx.x;
    const int tile_w = bd * BC_R;
    float* ks = sm;            // NK * m taps
    float* win = sm + NK * m;  // tile_w + m - 1 window samples
    const long long row = blockIdx.x / ntiles;
    const int tile = blockIdx.x % ntiles;
    const int o0 = tile * tile_w;
    const float* wr = w + row * (long long)n_full;

    int has_nan = 0;
    for (int i = tid; i < n_in; i += bd) has_nan |= isnan(wr[i]);
    const bool bad = __syncthreads_or(has_nan) != 0;

    for (int i = tid; i < NK * m; i += bd) ks[i] = taps[i];
    const int span = tile_w + m - 1;
    const int g0 = lo + o0 - (m - 1);
    for (int s = tid; s < span; s += bd) {
        const int g = g0 + s;
        win[s] = (g >= 0 && g < n_in) ? wr[g] : 0.f;
    }
    __syncthreads();

    // two-level f32 sum: BC_CHUNK taps into a partial, partials into acc,
    // so rounding grows with m / BC_CHUNK + BC_CHUNK terms instead of m
    float acc[BC_R][NK];
#pragma unroll
    for (int r = 0; r < BC_R; ++r)
#pragma unroll
        for (int j = 0; j < NK; ++j) acc[r][j] = 0.f;

    const float* wb = win + tid + (m - 1);
    for (int c0 = 0; c0 < m; c0 += BC_CHUNK) {
        const int c1 = min(m, c0 + BC_CHUNK);
        float part[BC_R][NK];
#pragma unroll
        for (int r = 0; r < BC_R; ++r)
#pragma unroll
            for (int j = 0; j < NK; ++j) part[r][j] = 0.f;
        for (int t = c0; t < c1; ++t) {
            float kv[NK];
#pragma unroll
            for (int j = 0; j < NK; ++j) kv[j] = ks[j * m + t];
#pragma unroll
            for (int r = 0; r < BC_R; ++r) {
                const float x = wb[r * bd - t];
#pragma unroll
                for (int j = 0; j < NK; ++j)
                    part[r][j] = fmaf(x, kv[j], part[r][j]);
            }
        }
#pragma unroll
        for (int r = 0; r < BC_R; ++r)
#pragma unroll
            for (int j = 0; j < NK; ++j) acc[r][j] += part[r][j];
    }

    const float qnan = __int_as_float(0x7fc00000);
#pragma unroll
    for (int r = 0; r < BC_R; ++r) {
        const int o = o0 + tid + r * bd;
        if (o < p) {
#pragma unroll
            for (int j = 0; j < NK; ++j)
                out[(row * NK + j) * (long long)p + o] = bad ? qnan : acc[r][j];
        }
    }
}

// Threads per block for p outputs: enough for one tile where p is short,
// capped at BC_MAX_THREADS.
static int bc_threads(int p) {
    int t = (p + BC_R - 1) / BC_R;
    t = (t + 31) / 32 * 32;
    if (t < 32) t = 32;
    if (t > BC_MAX_THREADS) t = BC_MAX_THREADS;
    return t;
}

extern "C" int dspeed_banded_conv_smem_bytes(int m, int nk, int p) {
    const int tile_w = bc_threads(p) * BC_R;
    return (nk * m + tile_w + m - 1) * (int)sizeof(float);
}

template <int NK>
static int launch(const float* w, const float* taps, float* out, int B,
                  int n_full, int n_in, int m, int lo, int p,
                  cudaStream_t stream) {
    const int threads = bc_threads(p);
    const int tile_w = threads * BC_R;
    const int ntiles = (p + tile_w - 1) / tile_w;
    const int smem = dspeed_banded_conv_smem_bytes(m, NK, p);
    cudaError_t err = cudaFuncSetAttribute(
        banded_conv_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    if (B == 0 || p == 0) return 0;
    const long long blocks = (long long)B * ntiles;
    banded_conv_kernel<NK><<<(unsigned int)blocks, threads, smem, stream>>>(
        w, taps, out, n_full, n_in, m, lo, p, ntiles);
    return (int)cudaGetLastError();
}

extern "C" int dspeed_banded_conv(const float* w, const float* taps, float* out,
                                  int B, int n_full, int n_in, int m, int nk,
                                  int lo, int p, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (nk) {
        case 1: return launch<1>(w, taps, out, B, n_full, n_in, m, lo, p, s);
        case 2: return launch<2>(w, taps, out, B, n_full, n_in, m, lo, p, s);
        case 3: return launch<3>(w, taps, out, B, n_full, n_in, m, lo, p, s);
        case 4: return launch<4>(w, taps, out, B, n_full, n_in, m, lo, p, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* dspeed_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
