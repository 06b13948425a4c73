// Fused HPGe energy front (K1) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_energy_kernel` / `_fused_energy_call`
// (dspeed_tpu/processors/_pallas.py:287, :420; entry `fused_energy` :1451).
// Per event row it computes, in one pass over the raw waveform:
//   w    = raw - baseline                          (blsub plane, optional)
//   pz   = w + omc * S_excl(w)                     (pole-zero, omc = -expm1(-1/tau))
//   trap = every "norm"/"asym" trapezoid of pz     (4-term prefix differences)
//   emax = max of the requested traps
// plus optional outputs: the raw waveform's min_max quadruple (NaN mask from
// the waveform only), linear_slope_fit quadruples over static slices of w or
// pz, and uint8 threshold-crossing bitmasks of a trap against a slope output.
// Rows with a NaN in w (raw or baseline) are poisoned.
//
// What bounds it on this card: memory. At the flagship specs it reads one
// f32 plane and writes three (pz, trap, blsub), about 64 KB per 4096-sample
// row, so 16384 rows move about 1.07 GB: 0.32 ms at 3.35 TB/s. The arithmetic
// (two prefix sums and a few adds per sample) is far below the f64 rate.
//
// How the design meets it: one thread block per row keeps the row resident in
// shared memory (f32 values, then f32 pz in place) beside one f64 prefix
// array, so the waveform is read from device memory once and every output is
// written once. The prefix sums and the trapezoid windows are the f64 block
// scans of row_prefix.cuh (shared with the t0 front, fused_t0.cu); the
// block reductions and the slope fit are those of block_reduce.cuh.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_reduce.cuh"
#include "row_prefix.cuh"

#define EN_THREADS 256
#define EN_MAX_TRAPS 8
#define EN_MAX_EMAX 8
#define EN_MAX_SLOPES 4
#define EN_MAX_MASKS 4

// Mirrored field for field by ctypes in processors/_cuda.py.
struct EnergyParams {
    const float* w;
    const float* bl;
    float* pz;
    float* blsub;  // null: not emitted
    float* mm[4];  // t_min, t_max, a_min, a_max; null: not emitted
    int B;
    int n;
    double omc;
    int ntrap;
    TrapSpec trap[EN_MAX_TRAPS];
    float* trap_out[EN_MAX_TRAPS];
    int nemax;
    int emax_idx[EN_MAX_EMAX];
    float* emax_out[EN_MAX_EMAX];
    int nslope;
    int slope_src[EN_MAX_SLOPES];  // 0 = blsub, 1 = pz
    int slope_a0[EN_MAX_SLOPES];
    int slope_b0[EN_MAX_SLOPES];
    float* slope_out[EN_MAX_SLOPES * 4];
    int nmask;
    TrapSpec mask_trap[EN_MAX_MASKS];
    int mask_si[EN_MAX_MASKS];
    int mask_oi[EN_MAX_MASKS];
    int mask_fwd[EN_MAX_MASKS];
    int mask_bwd[EN_MAX_MASKS];
    uint8_t* mask_out[EN_MAX_MASKS];
};

__global__ void __launch_bounds__(EN_THREADS)
fused_energy_kernel(const EnergyParams P) {
    extern __shared__ double smem[];
    __shared__ double red[32];
    __shared__ float redf[32];
    __shared__ int redi[32];
    __shared__ float slope_vals[EN_MAX_SLOPES * 4];

    const int n = P.n;
    double* ps = smem;                // f64 prefix of pz
    float* xs = (float*)(smem + n);   // w, then pz in place
    const long long row = blockIdx.x;
    const float* wr = P.w + row * (long long)n;
    const float blv = P.bl[row];
    const float qnan = __int_as_float(0x7fc00000);

    // pass 1: load the row, baseline-subtract, raw extrema and NaN flags
    int raw_nan = 0, w_nan = 0;
    float vmin = 0.f, vmax = 0.f;
    int imin = n, imax = n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float v = wr[i];
        raw_nan |= isnan(v);
        const float x = v - blv;
        w_nan |= isnan(x);
        xs[i] = x;
        if (imin == n || v < vmin) { vmin = v; imin = i; }
        if (imax == n || v > vmax) { vmax = v; imax = i; }
    }
    const bool bad = __syncthreads_or(w_nan) != 0;
    const bool bad_raw = __syncthreads_or(raw_nan) != 0;
    if (P.mm[0] != nullptr) {
        block_argext(vmin, imin, false, n, redf, redi);
        block_argext(vmax, imax, true, n, redf, redi);
        if (threadIdx.x == 0) {
            P.mm[0][row] = bad_raw ? qnan : (float)imin;
            P.mm[1][row] = bad_raw ? qnan : (float)imax;
            P.mm[2][row] = bad_raw ? qnan : vmin;
            P.mm[3][row] = bad_raw ? qnan : vmax;
        }
    }
    if (P.blsub != nullptr) {
        float* o = P.blsub + row * (long long)n;
        for (int i = threadIdx.x; i < n; i += blockDim.x)
            o[i] = bad ? qnan : xs[i];
    }
    for (int s = 0; s < P.nslope; ++s) {
        if (P.slope_src[s] != 0) continue;
        float q[4];
        slope_fit(xs, P.slope_a0[s], P.slope_b0[s], red, q);
        if (threadIdx.x == 0)
            for (int k = 0; k < 4; ++k) {
                slope_vals[4 * s + k] = q[k];
                P.slope_out[4 * s + k][row] = bad ? qnan : q[k];
            }
    }

    // pass 2: pole-zero in place, pz = w + omc * (exclusive prefix of w)
    int j0, j1;
    scan_run(n, j0, j1);
    double run = 0.0;
    for (int j = j0; j < j1; ++j) run += (double)xs[j];
    double s = block_excl_scan(run, red);
    for (int j = j0; j < j1; ++j) {
        const float x = xs[j];
        xs[j] = x + (float)(P.omc * s);
        s += (double)x;
    }
    __syncthreads();
    {
        float* o = P.pz + row * (long long)n;
        for (int i = threadIdx.x; i < n; i += blockDim.x)
            o[i] = bad ? qnan : xs[i];
    }
    for (int t = 0; t < P.nslope; ++t) {
        if (P.slope_src[t] != 1) continue;
        float q[4];
        slope_fit(xs, P.slope_a0[t], P.slope_b0[t], red, q);
        if (threadIdx.x == 0)
            for (int k = 0; k < 4; ++k) {
                slope_vals[4 * t + k] = q[k];
                P.slope_out[4 * t + k][row] = bad ? qnan : q[k];
            }
    }

    // pass 3: inclusive f64 prefix of pz
    block_inclusive_prefix(xs, ps, n, red);

    // pass 4: trapezoids and their maxima
    for (int t = 0; t < P.ntrap; ++t) {
        const TrapSpec spec = P.trap[t];
        float* o = P.trap_out[t] ? P.trap_out[t] + row * (long long)n : nullptr;
        bool need_max = false;
        for (int e = 0; e < P.nemax; ++e) need_max |= P.emax_idx[e] == t;
        float mx = -INFINITY;
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const float v = trap_at(spec, xs, ps, i);
            if (o != nullptr) o[i] = bad ? qnan : v;
            mx = fmaxf(mx, v);
        }
        if (need_max) {
            mx = block_max(mx, redf);
            if (threadIdx.x == 0)
                for (int e = 0; e < P.nemax; ++e)
                    if (P.emax_idx[e] == t) P.emax_out[e][row] = bad ? qnan : mx;
        }
    }

    // pass 5: crossing bitmasks (bit 0: forward crossing between i and i+1,
    // bit 1: backward crossing between i-1 and i), zero on bad rows
    __syncthreads();
    for (int k = 0; k < P.nmask; ++k) {
        const TrapSpec spec = P.mask_trap[k];
        const float a = slope_vals[4 * P.mask_si[k] + P.mask_oi[k]];
        uint8_t* o = P.mask_out[k] + row * (long long)n;
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            uint8_t bits = 0;
            if (!bad) {
                const float ti = trap_at(spec, xs, ps, i);
                if (P.mask_fwd[k] && i <= n - 2) {
                    const float t1 = trap_at(spec, xs, ps, i + 1);
                    if ((ti <= a && a < t1) || (ti >= a && a > t1)) bits |= 1;
                }
                if (P.mask_bwd[k] && i >= 1) {
                    const float tm = trap_at(spec, xs, ps, i - 1);
                    if ((tm < a && a <= ti) || (tm > a && a >= ti)) bits |= 2;
                }
            }
            o[i] = bits;
        }
    }
}

extern "C" int dspeed_fused_energy_smem_bytes(int n) { return n * 12; }

extern "C" int dspeed_fused_energy(const EnergyParams* p, void* stream) {
    const int smem = p->n * 12;
    cudaError_t err = cudaFuncSetAttribute(
        fused_energy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (p->B == 0) return 0;
    fused_energy_kernel<<<p->B, EN_THREADS, smem, (cudaStream_t)stream>>>(*p);
    return (int)cudaGetLastError();
}

extern "C" const char* dspeed_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
