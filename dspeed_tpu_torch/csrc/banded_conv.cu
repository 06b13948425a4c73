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
// How the design meets it: the FMAs run from registers (conv_tile.cuh).
// Each thread owns R consecutive outputs of one row for all nk kernels and,
// per chunk of 32 taps, loads its R + 31 window samples and the chunk's
// taps with 16-byte shared loads, then runs 32 * R * nk FMAs: a few shared
// loads feed a thousand FMAs, so the shared-memory pipe no longer bounds the
// loop. A block holds several rows (the count that leaves fewest lanes
// idle), so the taps are staged once per block and every lane has outputs;
// rows of more than BC_MAX_THREADS * R outputs are cut into segments, one
// block each. The window and taps arrive by cp.async (zero-filled outside
// [0, n_in)), and the NaN flag is taken from the staged window, so a row is
// read from device memory once. The results go back through shared memory,
// so that the stores to device memory are coalesced. Each output is summed
// in conv_row.cuh's order, so K4 equals K3 (fused_t0.cu) and K7
// (generic_rows.cu) bit for bit. A persistent grid that stages the next
// rows while the current ones are summed was measured slower on the H100:
// its second window buffer costs blocks per SM. No band matrix is built:
// that layout exists to feed the TPU's matrix unit.

#include <cuda_runtime.h>
#include <math.h>

#include "conv_tile.cuh"

#define BC_MAX_THREADS 256  // threads of a block, for one row's outputs
#define BC_PACK_THREADS 128  // threads of a block that holds several rows
#define BC_MAX_SMEM 232448  // bytes of shared memory one H100 block may use

// Outputs per thread for nk kernels, measured on the H100 among R = 4 to
// 28: few enough that the accumulators, the partials and the window stay
// in registers without spills. R = 20 (4 mod 8) keeps a quarter warp's
// window loads on distinct banks; R = 8 costs a two-way conflict there
// but more blocks per SM, which paid more.
__host__ __device__ constexpr int bc_outputs(int nk) { return nk == 1 ? 20 : 8; }

// The window samples one thread loads per chunk (16-byte loads).
__host__ __device__ constexpr int bc_loaded(int r) {
    return (r + CONV_CHUNK - 1 + 3) / 4 * 4;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Block b computes outputs [o0, o0 + tpr * R) of segment b % nseg for rows
// [row0, row0 + rpb) of the row group b / nseg. Shared memory: nk kernels
// of mp taps (m rounded up to 4, zero past m), then rpb windows of `span`
// samples, window sample s being w[row, s0 + s] with s0 = lo + o0 - mc + 1
// (mc = m rounded up to 32), then rpb NaN flags.
template <int NK>
__global__ void __launch_bounds__(BC_MAX_THREADS)
banded_conv_kernel(const float* __restrict__ w, const float* __restrict__ taps,
                   float* __restrict__ out, int B, int n_full, int n_in, int m,
                   int lo, int p, int tpr, int nseg, int rpb, int mp,
                   int span) {
    constexpr int R = bc_outputs(NK);
    extern __shared__ float4 sm4[];
    float* ks = reinterpret_cast<float*>(sm4);
    float* win = ks + NK * mp;
    int* bad = reinterpret_cast<int*>(
        ks + max(NK * mp + rpb * span, rpb * NK * tpr * R));
    const int tid = threadIdx.x;
    const int bd = blockDim.x;
    const long long row0 = (long long)(blockIdx.x / nseg) * rpb;
    const int rows = (int)min((long long)rpb, B - row0);
    const int o0 = (int)(blockIdx.x % nseg) * tpr * R;
    const int mc = (m + CONV_CHUNK - 1) / CONV_CHUNK * CONV_CHUNK;
    const int s0 = lo + o0 - mc + 1;

    if (tid < rows) bad[tid] = 0;
    for (int j = 0; j < NK; ++j)
        for (int t = tid; t < mp; t += bd)
            cp_async4(ks + j * mp + t, taps + j * m + min(t, m - 1),
                      t < m ? 4 : 0);
    for (int r = 0; r < rows; ++r) {
        const float* wr = w + (row0 + r) * (long long)n_full;
        for (int s = tid; s < span; s += bd) {
            const int g = s0 + s;
            const bool in = g >= 0 && g < n_in;
            cp_async4(win + r * span + s, in ? wr + g : wr, in ? 4 : 0);
        }
    }
    cp_async_wait_all();
    __syncthreads();

    // NaN flags: the staged window, then the samples of [0, n_in) it leaves
    // out (none for the flagship's windows)
    const int a = min(max(s0, 0), n_in);
    const int b = min(max(s0 + span, 0), n_in);
    for (int r = 0; r < rows; ++r) {
        const float* wr = w + (row0 + r) * (long long)n_full;
        int nan = 0;
        for (int s = tid; s < span; s += bd) nan |= isnan(win[r * span + s]);
        for (int g = tid; g < a; g += bd) nan |= isnan(wr[g]);
        for (int g = b + tid; g < n_in; g += bd) nan |= isnan(wr[g]);
        if (nan) bad[r] = 1;
    }
    __syncthreads();

    // each thread sums R consecutive outputs; they are written back through
    // shared memory (over the taps and windows), so that a warp's stores to
    // device memory are coalesced
    const int rr = tid / tpr;
    const int k = tid - rr * tpr;
    const int seg_w = tpr * R;
    const bool live = rr < rows && o0 + k * R < p;
    float acc[R][NK];
    if (live && !bad[rr])
        conv_tile_accumulate<R, NK>(win + rr * span + k * R + mc - CONV_CHUNK,
                                    ks, mp, m, acc);
    __syncthreads();
    float* res = ks;  // rows * NK rows of seg_w outputs
    if (live) {
        const float qnan = __int_as_float(0x7fc00000);
#pragma unroll
        for (int j = 0; j < NK; ++j) {
            float4* dst = reinterpret_cast<float4*>(
                res + (rr * NK + j) * seg_w + k * R);
#pragma unroll
            for (int q = 0; q < R / 4; ++q)
                dst[q] = bad[rr] ? make_float4(qnan, qnan, qnan, qnan)
                                 : make_float4(acc[4 * q][j], acc[4 * q + 1][j],
                                               acc[4 * q + 2][j],
                                               acc[4 * q + 3][j]);
        }
    }
    __syncthreads();
    const int n_out = min(seg_w, p - o0);
    for (int q = 0; q < rows * NK; ++q) {
        float* orow = out + (row0 * NK + q) * (long long)p + o0;
        for (int o = tid; o < n_out; o += bd) orow[o] = res[q * seg_w + o];
    }
}

struct Plan {
    int tpr;    // threads per row segment
    int nseg;   // segments per row
    int rpb;    // rows per block
    int threads;
    int mp;     // taps per kernel in shared memory
    int span;   // window samples per row
    int smem;   // bytes
};

static int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The launch for B rows: segments as few as BC_MAX_THREADS threads a
// segment allow, so that a block reads a row once; where a row takes no
// more than BC_PACK_THREADS threads, the rows per block in blocks of up to
// BC_PACK_THREADS threads that leave the fewest lanes idle (the larger
// count on a tie), no more than B: small blocks, several to an SM, were
// measured faster than large ones. Where shared memory runs out: fewer
// rows, then more segments. A geometry that does not fit one row of one
// output group is returned with smem over the limit.
static Plan plan_for(int B, int m, int nk, int p) {
    const int R = bc_outputs(nk);
    const int mc = ceil_div(m, CONV_CHUNK) * CONV_CHUNK;
    const int groups = ceil_div(p > 0 ? p : 1, R);
    Plan pl;
    pl.mp = ceil_div(m, 4) * 4;
    pl.nseg = ceil_div(groups, BC_MAX_THREADS);
    pl.tpr = ceil_div(groups, pl.nseg);
    pl.rpb = 1;
    if (pl.nseg == 1) {
        int best_used = 0, best_lanes = 1;
        for (int q = 1; q * pl.tpr <= BC_PACK_THREADS && q <= B; ++q) {
            const int used = q * pl.tpr;
            const int lanes = ceil_div(used, 32) * 32;
            if ((long long)used * best_lanes >= (long long)best_used * lanes) {
                best_used = used;
                best_lanes = lanes;
                pl.rpb = q;
            }
        }
    }
    for (;;) {
        pl.span = (pl.tpr - 1) * R + mc - CONV_CHUNK + bc_loaded(R);
        // the results, rpb * nk rows of tpr * R outputs, reuse the taps and
        // windows
        const int staged = nk * pl.mp + pl.rpb * pl.span;
        const int results = pl.rpb * nk * pl.tpr * R;
        pl.smem = (staged > results ? staged : results) * (int)sizeof(float) +
                  pl.rpb * (int)sizeof(int);
        if (pl.smem <= BC_MAX_SMEM) break;
        if (pl.rpb > 1) {
            --pl.rpb;
        } else if (pl.tpr > 1) {
            ++pl.nseg;
            pl.tpr = ceil_div(groups, pl.nseg);
        } else {
            break;
        }
    }
    pl.threads = ceil_div(pl.rpb * pl.tpr, 32) * 32;
    return pl;
}

// Shared memory a block of this geometry takes at most, with as many rows
// as a block takes (more than a block may use only where no plan fits).
extern "C" int dspeed_banded_conv_smem_bytes(int m, int nk, int p) {
    return plan_for(BC_PACK_THREADS, m, nk, p).smem;
}

template <int NK>
static int launch(const float* w, const float* taps, float* out, int B,
                  int n_full, int n_in, int m, int lo, int p,
                  cudaStream_t stream) {
    const Plan pl = plan_for(B, m, NK, p);
    cudaError_t err = cudaFuncSetAttribute(
        banded_conv_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        pl.smem);
    if (err != cudaSuccess) return (int)err;
    if (B == 0 || p == 0) return 0;
    const long long blocks = (long long)pl.nseg * ceil_div(B, pl.rpb);
    banded_conv_kernel<NK><<<(unsigned int)blocks, pl.threads, pl.smem,
                             stream>>>(w, taps, out, B, n_full, n_in, m, lo, p,
                                       pl.tpr, pl.nseg, pl.rpb, pl.mp,
                                       pl.span);
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

template <int NK>
static int config(int B, int m, int p, int* out) {
    const Plan pl = plan_for(B, m, NK, p);
    cudaError_t err = cudaFuncSetAttribute(
        banded_conv_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        pl.smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, banded_conv_kernel<NK>, pl.threads, pl.smem);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, banded_conv_kernel<NK>);
    if (err != cudaSuccess) return (int)err;
    const int blocks = pl.nseg * ceil_div(B, pl.rpb);
    const int vals[] = {bc_outputs(NK), pl.threads, pl.rpb,       pl.nseg,
                        pl.smem,        per_sm,     blocks,       attr.numRegs,
                        (int)attr.localSizeBytes};
    for (int i = 0; i < 9; ++i) out[i] = vals[i];
    return 0;
}

// How a launch of B rows runs: outputs per thread, threads, rows per block,
// segments per row, shared memory bytes, blocks per SM, blocks, registers
// and local bytes per thread.
extern "C" int dspeed_banded_conv_config(int B, int m, int nk, int p, int* out) {
    switch (nk) {
        case 1: return config<1>(B, m, p, out);
        case 2: return config<2>(B, m, p, out);
        case 3: return config<3>(B, m, p, out);
        case 4: return config<4>(B, m, p, out);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* dspeed_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
