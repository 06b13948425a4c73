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
// How the design meets it: one small thread block per row, several blocks
// to an SM, the convolution's FMAs from registers (conv_tile.cuh, the loop
// of the convolution bank banded_conv.cu). The row arrives once by cp.async
// into a shared window that starts at w[lo - mc + 1] (mc = m rounded up to
// 32), zero outside the row, beside the taps padded with zeros to a
// multiple of 4; the NaN flag is read from the staged window, and a NaN row
// skips the FMAs. Each thread owns T0_R consecutive outputs of each tile:
// per chunk of 32 taps it loads its window samples and the taps with
// 16-byte shared loads and runs 32 * T0_R FMAs. Each output is summed in
// conv_row.cuh's order, so c is K4's 's' window bit for bit. Each thread
// reduces its own outputs to first-occurrence (value, index) extrema, its
// last tile from registers; the warps' candidates meet in one shuffle step
// and one cross-warp step behind a single barrier, the lower index winning
// ties. The search walks down from t_max a block-width chunk at a time and
// stops at the first chunk with a crossing (block_reduce.cuh). The current
// reads the staged window once tp_0 is settled: a gather and one float32
// subtraction and division per sample, so it equals the plain version bit
// for bit wherever tp_0 does. The trapezoid comes from a float64 prefix of
// the row (row_prefix.cuh, K1's rule: windows of <= 32 samples are summed
// directly) into the space of c, which its search no longer needs. No band
// matrix is built and no n % 128 gate applies: those belong to the TPU's
// matrix unit. Any geometry that fits one block's shared memory is taken.
// The TPU kernel's log-shift window (`_window_rows`) is a workaround for its
// row-serial gathers and is not carried over.

#include <cuda_runtime.h>
#include <math.h>

#include "block_reduce.cuh"
#include "conv_tile.cuh"
#include "row_prefix.cuh"

// The tiling, measured on the H100 over 4 to 20 outputs a thread, blocks of
// 64 to 512 threads and 1 to 6 blocks an SM: small blocks, several to an
// SM, so that one block's staging, reductions and search overlap the
// others' FMAs. T0_R = 4 (mod 8) keeps a quarter warp's window loads on
// distinct banks; 5 blocks of 128 threads allow up to 96 registers a
// thread, enough for 12 outputs without spills (6 blocks allow 80, and
// spill). A 4096-sample row is 3 tiles.
#define T0_R 12
#define T0_MAX_THREADS 128  // threads of a block at most
#define T0_MIN_BLOCKS 5     // blocks an SM that the registers must allow
#define T0_WARPS (T0_MAX_THREADS / 32)

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

// A row's launch: threads, tap counts, window length and the shared-memory
// layout (byte offsets). Shared memory holds the reduction scratch, the f64
// prefix of the row (with atrap), the window of `span` samples w[lo - mc +
// 1 + s], the taps and the filtered row c (later the trapezoid).
struct T0Layout {
    int threads;  // a multiple of 32: one T0_R group of outputs a thread
    int mc;       // m rounded up to CONV_CHUNK
    int mp;       // m rounded up to 4
    int span;
    int ps, win, ks, c;
    int smem;
};

__host__ __device__ inline T0Layout t0_layout(int n, int m, int has_atrap) {
    T0Layout L;
    const int groups = (n + T0_R - 1) / T0_R;
    const int warps = (groups + 31) / 32;
    L.threads = 32 * (warps < T0_WARPS ? warps : T0_WARPS);
    L.mc = (m + CONV_CHUNK - 1) / CONV_CHUNK * CONV_CHUNK;
    L.mp = (m + 3) / 4 * 4;
    // the last group's thread reads from window sample (groups - 1) * T0_R
    // the 16-byte loads of T0_R + CONV_CHUNK - 1 samples, mc - 32 further on
    const int loaded = (T0_R + CONV_CHUNK - 1 + 3) / 4 * 4;
    L.span = (groups - 1) * T0_R + L.mc - CONV_CHUNK + loaded;
    // scratch: f64 scan partials, max and min (value, index) per warp, the
    // search's per-warp hits
    int off = (T0_WARPS * (8 + 4 * 4 + 4) + 15) / 16 * 16;
    L.ps = off;
    off += has_atrap ? 8 * ((n + 1) / 2 * 2) : 0;
    L.win = off;
    off += 4 * L.span;
    L.ks = off;
    off += 4 * L.mp;
    L.c = off;
    off += 4 * n;
    L.smem = off;
    return L;
}

extern "C" int dspeed_fused_t0_smem_bytes(int n, int m, int has_atrap) {
    return t0_layout(n, m, has_atrap).smem;
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

// Keep (v2, i2) in (v, i) where it is the better first-occurrence extremum.
__device__ __forceinline__ void ext_take(float& v, int& i, float v2, int i2,
                                         bool is_max, int n) {
    if (ext_better(v2, i2, v, i, is_max, n)) {
        v = v2;
        i = i2;
    }
}

__global__ void __launch_bounds__(T0_MAX_THREADS, T0_MIN_BLOCKS)
fused_t0_kernel(const T0Params P) {
    extern __shared__ float4 smem4[];
    char* const sm = reinterpret_cast<char*>(smem4);
    const int n = P.n, m = P.m, bd = blockDim.x, tid = threadIdx.x;
    const T0Layout L = t0_layout(n, m, P.has_atrap);
    double* red = reinterpret_cast<double*>(sm);
    float* extv = reinterpret_cast<float*>(red + T0_WARPS);  // max, then min
    int* exti = reinterpret_cast<int*>(extv + 2 * T0_WARPS);
    int* redi = exti + 2 * T0_WARPS;
    double* ps = reinterpret_cast<double*>(sm + L.ps);  // only with atrap
    float* win = reinterpret_cast<float*>(sm + L.win);
    float* ks = reinterpret_cast<float*>(sm + L.ks);
    float* c = reinterpret_cast<float*>(sm + L.c);
    const long long row = blockIdx.x;
    const float* wr = P.w + row * (long long)n;
    const float a = P.a[row];
    const float qnan = __int_as_float(0x7fc00000);
    const int s0 = P.lo - L.mc + 1;  // win[s] = w[s0 + s]

    for (int t = tid; t < L.mp; t += bd)
        cp_async4(ks + t, P.taps + min(t, m - 1), t < m ? 4 : 0);
    for (int s = tid; s < L.span; s += bd) {
        const int g = s0 + s;
        const bool in = g >= 0 && g < n;
        cp_async4(win + s, in ? wr + g : wr, in ? 4 : 0);
    }
    cp_async_wait_all();
    // each thread scans the samples it staged itself
    int has_nan = 0;
    for (int s = tid; s < L.span; s += bd) has_nan |= isnan(win[s]);
    const bool bad = __syncthreads_or(has_nan) != 0;

    // 'same' convolution, T0_R consecutive outputs a thread, tile by tile;
    // the last tile's sums stay in registers
    float acc[T0_R][1];
    const int tile_w = bd * T0_R;
    for (int o = tid * T0_R; o < n && !bad; o += tile_w) {
        conv_tile_accumulate<T0_R, 1>(win + o + L.mc - CONV_CHUNK, ks, L.mp, m,
                                      acc);
        if (o + T0_R <= n) {
            float4* dst = reinterpret_cast<float4*>(c + o);
#pragma unroll
            for (int q = 0; q < T0_R / 4; ++q)
                dst[q] = make_float4(acc[4 * q][0], acc[4 * q + 1][0],
                                     acc[4 * q + 2][0], acc[4 * q + 3][0]);
        } else {
#pragma unroll
            for (int r = 0; r < T0_R; ++r)
                if (o + r < n) c[o + r] = acc[r][0];
        }
    }

    // this thread's first-occurrence extrema: its earlier tiles read back
    // from c (its own stores), then its last tile from registers, so that
    // nothing but the sums is live across a tile's convolution
    const int o_first = tid * T0_R;  // this thread's first output
    const int o_last =                // and the first of its last tile
        bad || o_first >= n ? -1 : o_first + (n - 1 - o_first) / tile_w * tile_w;
    float vmax = 0.f, vmin = 0.f;
    int imax = n, imin = n;
    for (int o = o_first; o < o_last; o += tile_w)
        for (int r = 0; r < T0_R; ++r) {
            const float v = c[o + r];
            if (imax == n || v > vmax) { vmax = v; imax = o + r; }
            if (P.need_min && (imin == n || v < vmin)) { vmin = v; imin = o + r; }
        }
    if (o_last >= 0) {
#pragma unroll
        for (int r = 0; r < T0_R; ++r) {
            const float v = acc[r][0];
            if (o_last + r < n) {
                if (imax == n || v > vmax) { vmax = v; imax = o_last + r; }
                if (P.need_min && (imin == n || v < vmin)) {
                    vmin = v;
                    imin = o_last + r;
                }
            }
        }
    }

    // the block's extrema: a shuffle step within each warp, then every
    // thread takes the warps' candidates in warp order; the barrier between
    // also publishes c
    const int lane = tid & 31, wid = tid >> 5, nw = bd >> 5;
    for (int off = 16; off > 0; off >>= 1) {
        ext_take(vmax, imax, __shfl_down_sync(FULL_MASK, vmax, off),
                 __shfl_down_sync(FULL_MASK, imax, off), true, n);
        if (P.need_min)
            ext_take(vmin, imin, __shfl_down_sync(FULL_MASK, vmin, off),
                     __shfl_down_sync(FULL_MASK, imin, off), false, n);
    }
    if (lane == 0) {
        extv[wid] = vmax;
        exti[wid] = imax;
        extv[T0_WARPS + wid] = vmin;
        exti[T0_WARPS + wid] = imin;
    }
    __syncthreads();
    vmax = extv[0];
    imax = exti[0];
    vmin = extv[T0_WARPS];
    imin = exti[T0_WARPS];
    for (int q = 1; q < nw; ++q) {
        ext_take(vmax, imax, extv[q], exti[q], true, n);
        if (P.need_min)
            ext_take(vmin, imin, extv[T0_WARPS + q], exti[T0_WARPS + q], false, n);
    }

    // backward crossing search from t_max against a
    const int i0 = isnan(a) || bad ? -1 : search_bwd(c, imax, a, redi);

    if (tid == 0) {
        P.out[0][row] = bad ? qnan : (P.need_min ? (float)imin : 0.f);
        P.out[1][row] = bad ? qnan : (float)imax;
        P.out[2][row] = bad ? qnan : (P.need_min ? vmin : 0.f);
        P.out[3][row] = bad ? qnan : vmax;
        P.out[4][row] = i0 < 0 ? qnan : (float)i0;
    }
    const float* x = win - s0;  // x[g] = w[g], g in [0, n)

    // absorbed A/E current: the window of win_m samples from tp_0 = i0
    // (1 <= i0 < n when found), differenced at avg_len
    if (P.n_curr > 0) {
        float* cr = P.curr + row * (long long)P.n_curr;
        const int Lc = P.avg_len;
        const bool dead = i0 < 0 || i0 + P.win_m > n;
        const float lf = (float)Lc;
        for (int i = tid; i < P.n_curr; i += bd)
            cr[i] = dead || i >= P.win_m - Lc
                ? qnan : __fdiv_rn(x[i0 + i + Lc] - x[i0 + i], lf);
    }
    if (!P.has_atrap) return;
    if (bad || isnan(a)) {  // the search would find nothing
        if (tid == 0) P.out[5][row] = qnan;
        return;
    }

    // absorbed trapezoid of the row, over c, and its own search from the
    // same t_max; every thread has left the search over c before the
    // prefix's barriers
    block_inclusive_prefix(x, ps, n, red);
    for (int i = tid; i < n; i += bd) c[i] = trap_at(P.atrap, x, ps, i);
    __syncthreads();
    const int i1 = search_bwd(c, imax, a, redi);
    if (tid == 0) P.out[5][row] = i1 < 0 ? qnan : (float)i1;
}

extern "C" int dspeed_fused_t0(const T0Params* p, void* stream) {
    const T0Layout L = t0_layout(p->n, p->m, p->has_atrap);
    cudaError_t err = cudaFuncSetAttribute(
        fused_t0_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem);
    if (err != cudaSuccess) return (int)err;
    if (p->B == 0) return 0;
    fused_t0_kernel<<<p->B, L.threads, L.smem, (cudaStream_t)stream>>>(*p);
    return (int)cudaGetLastError();
}

// How a row of n samples with m taps launches: outputs per thread, threads
// and shared memory bytes a block, blocks per SM, registers and local bytes
// per thread.
extern "C" int dspeed_fused_t0_config(int n, int m, int has_atrap, int* out) {
    const T0Layout L = t0_layout(n, m, has_atrap);
    cudaError_t err = cudaFuncSetAttribute(
        fused_t0_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_t0_kernel, L.threads, L.smem);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fused_t0_kernel);
    if (err != cudaSuccess) return (int)err;
    const int vals[] = {T0_R,   L.threads,    L.smem,
                        per_sm, attr.numRegs, (int)attr.localSizeBytes};
    for (int i = 0; i < 6; ++i) out[i] = vals[i];
    return 0;
}

extern "C" const char* dspeed_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
