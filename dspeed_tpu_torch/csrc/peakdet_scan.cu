// The Billauer peak finder's sweep for Hopper (sm_90a): one thread per event.
//
// Replaces the `lax.scan` of dspeed_tpu/processors/peak_finding.py:49
// (`_peakdet_scan`), which is not a Pallas kernel: the hysteresis state
// machine is sequential along the row, so the JAX package scans it with a
// small carry, batched over the events. Here each thread carries that state
// in registers for one row and walks its samples in order (forward, or
// n-1 ... 0 with `reverse`), recording true sample indices:
//   running maximum and minimum (value and index), strict > and < updates;
//   decl_max = find_max && w < vx - dmax && nmx < m_max && vx > amax
//   decl_min = !find_max && w > vn + dmin && nmn < m_min && vn < amin
// with the subtraction and the addition in the row's type (__fsub_rn /
// __fadd_rn: no contraction), and a declaration restarting the opposite
// tracker at the current sample. A NaN amax makes `vx > amax` false on
// every step, so such a row declares nothing; once nmx reaches m_max no
// further maximum is declared, and so find_max stays set and no minimum
// either. The slots are written in declaration order, the rest NaN.
//
// What bounds it on this card: the bytes. The SiPM path's sweep reads 16384
// rows of 1019 float32 samples once (66.8 MB, 0.020 ms at 3.35 TB/s) and
// writes 20 + 20 slots and two counts a row. Each thread reads its own row
// (a warp touches 32 rows' cache lines a step, which stay in L1 for the
// next 31 steps), eight samples ahead of the state machine. Staging the
// rows through shared memory is a later design.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PK_THREADS 64
#define PK_AHEAD 8

__device__ __forceinline__ float pk_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double pk_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float pk_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double pk_add(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(PK_THREADS)
peakdet_scan_kernel(const T* __restrict__ w, long long stride, int B, int n,
                    const T* __restrict__ dmax, const T* __restrict__ dmin,
                    const T* __restrict__ amax, const T* __restrict__ amin,
                    int m_max, int m_min, int reverse, T* __restrict__ smax,
                    T* __restrict__ smin, int* __restrict__ nmax,
                    int* __restrict__ nmin) {
    const long long row = (long long)blockIdx.x * PK_THREADS + threadIdx.x;
    if (row >= B) return;
    const T* x = w + row * stride;
    const T dM = dmax[row], dm = dmin[row], aM = amax[row], am = amin[row];
    T* omax = smax + row * (long long)m_max;
    T* omin = smin + row * (long long)m_min;
    T vx = -INFINITY, vn = INFINITY;
    int ix = 0, im = 0, nmx = 0, nmn = 0;
    bool find_max = true;
    for (int s0 = 0; s0 < n; s0 += PK_AHEAD) {
        T v[PK_AHEAD];
#pragma unroll
        for (int u = 0; u < PK_AHEAD; ++u) {
            const int s = s0 + u;
            const int i = reverse ? n - 1 - s : s;
            v[u] = s < n ? x[i] : (T)0;
        }
#pragma unroll
        for (int u = 0; u < PK_AHEAD; ++u) {
            const int s = s0 + u;
            if (s >= n) break;
            const int i = reverse ? n - 1 - s : s;
            const T wi = v[u];
            if (wi > vx) { vx = wi; ix = i; }
            if (wi < vn) { vn = wi; im = i; }
            if (find_max) {
                if (wi < pk_sub(vx, dM) && nmx < m_max && vx > aM) {
                    omax[nmx++] = (T)ix;
                    vn = wi;
                    im = i;
                    find_max = false;
                }
            } else if (wi > pk_add(vn, dm) && nmn < m_min && vn < am) {
                omin[nmn++] = (T)im;
                vx = wi;
                ix = i;
                find_max = true;
            }
        }
    }
    const T qnan = (T)NAN;
    for (int k = nmx; k < m_max; ++k) omax[k] = qnan;
    for (int k = nmn; k < m_min; ++k) omin[k] = qnan;
    nmax[row] = nmx;
    nmin[row] = nmn;
}

// Mirrored field for field by ctypes in processors/_cuda.py.
struct PeakdetParams {
    const void* w;
    long long stride;  // row stride of w, in samples
    const void* dmax;  // (B,) each, in the row's type
    const void* dmin;
    const void* amax;
    const void* amin;
    void* smax;        // (B, m_max) and (B, m_min), in the row's type
    void* smin;
    void* nmax;        // (B,) int32 each
    void* nmin;
    int B, n, m_max, m_min, reverse, f64;
};

template <typename T>
static cudaError_t pk_launch(const PeakdetParams* p, cudaStream_t st) {
    const int blocks = (p->B + PK_THREADS - 1) / PK_THREADS;
    peakdet_scan_kernel<T><<<blocks, PK_THREADS, 0, st>>>(
        (const T*)p->w, p->stride, p->B, p->n, (const T*)p->dmax,
        (const T*)p->dmin, (const T*)p->amax, (const T*)p->amin, p->m_max,
        p->m_min, p->reverse, (T*)p->smax, (T*)p->smin, (int*)p->nmax,
        (int*)p->nmin);
    return cudaGetLastError();
}

extern "C" int dspeed_peakdet_scan(const PeakdetParams* p, void* stream) {
    if (p->B == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    return (int)(p->f64 ? pk_launch<double>(p, st) : pk_launch<float>(p, st));
}

// How the float32 instance launches: threads a block, blocks per SM,
// registers and local (spill) bytes a thread.
extern "C" int dspeed_peakdet_scan_config(int* out) {
    int per_sm;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, peakdet_scan_kernel<float>, PK_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, peakdet_scan_kernel<float>)) != cudaSuccess)
        return (int)err;
    const int vals[] = {PK_THREADS, per_sm, attr.numRegs, (int)attr.localSizeBytes};
    for (int i = 0; i < 4; ++i) out[i] = vals[i];
    return 0;
}

extern "C" const char* dspeed_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
