// The Billauer peak finder's sweep for Hopper (sm_90a): one warp per event.
//
// Replaces the `lax.scan` of dspeed_tpu/processors/peak_finding.py:49
// (`_peakdet_scan`), which is not a Pallas kernel: the hysteresis state
// machine is sequential along the row, so the JAX package scans it with a
// small carry, batched over the events. Its step, which the plain version
// (_cuda.peakdet_scan_plain) runs over the samples in order (forward, or
// n-1 ... 0 with `reverse`), recording true sample indices:
//   running maximum and minimum (value and index), strict > and < updates;
//   decl_max = find_max && w < vx - dmax && nmx < m_max && vx > amax
//   decl_min = !find_max && w > vn + dmin && nmn < m_min && vn < amin
// with the subtraction and the addition in the row's type (__fsub_rn /
// __fadd_rn: no contraction), and a declaration restarting the opposite
// tracker at the current sample. The slots are written in declaration
// order, the rest NaN.
//
// The design: a warp walks one row in sweep order, PK_STEP samples a step,
// lane k holding the step's samples 4k .. 4k+3. Only one tracker is live at
// a time: the maximum while find_max, else the minimum; the other is read by
// no test until a declaration flips the mode, and that declaration restarts
// it. Between two declarations the live tracker is a prefix extremum of
// (value, index) pairs under "the later pair if strictly greater (less),
// else the earlier one": the first occurrence of the extremum, an
// associative combine (the minimum is kept as the maximum of the negated
// samples, negation being exact). So a lane's own four samples walked in
// order, an inclusive warp scan of the lanes' results (shuffles), and the
// carried tracker as the seed give every sample the tracker the sequential
// walk has there. A NaN sample (and a sample past the row, loaded as NaN)
// wins no comparison, so it leaves a tracker as it finds it, as in the
// walk; the identity (-inf) wins none either. Each lane then tests its
// samples' declaration with the walk's own arithmetic; a ballot and __ffs
// find the first one in sweep order. Its lane writes the slot, the mode
// flips, and the new live tracker restarts at that sample: the same scan
// over the samples after it, seeded with that sample. Repeat from the
// sample after the declaration until none declares: a step costs one scan
// and one more a declaration. A row that can declare nothing more (its
// mode's slots full, or a NaN amax or amin in that mode: `vx > NaN` is
// never true) stops.
//
// What bounds it on this card: the bytes. The SiPM path's sweep reads 16384
// rows of 1019 float64 samples once (133.6 MB, 0.040 ms at 3.35 TB/s) and
// writes 20 + 20 slots and two counts a row. A warp's load of a step reads
// 32 consecutive runs of four samples, the next step's in flight while the
// warp scans the current one. Measured, the warp's chain of dependent
// shuffles (a scan a step and one a declaration) sets its time, not the
// bytes: float32 rows take about as long as float64 ones. Eight samples a
// lane (half the scans) took longer still, at 88 registers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PK_WARPS 4  // rows a block, one warp each
#define PK_THREADS (32 * PK_WARPS)
#define PK_E 4  // samples a lane a step, consecutive in sweep order
#define PK_STEP (32 * PK_E)
#define PK_FULL 0xffffffffu

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

__device__ __forceinline__ float pk_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double pk_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float pk_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double pk_add(double a, double b) { return __dadd_rn(a, b); }

// The lane's samples of the step at sweep position s0 (NaN past the row).
template <typename T>
__device__ __forceinline__ void pk_load(const T* x, int n, int reverse, int s0,
                                        int lane, T (&v)[PK_E]) {
#pragma unroll
    for (int u = 0; u < PK_E; ++u) {
        const int s = s0 + lane * PK_E + u;
        v[u] = s < n ? x[reverse ? n - 1 - s : s] : (T)NAN;
    }
}

// The live tracker after each of the lane's samples: the first-occurrence
// running maximum of sg x (sg = +1, the maximum; -1, the minimum as the
// maximum of -x: negation is exact, and b < a is -b > -a) over the step's
// positions from `from` on, started from (sv, si) before them (sv in the
// same sign). Position p (lane * PK_E + u) is true index i0 + di p.
template <typename T>
__device__ __forceinline__ void pk_scan(const T (&x)[PK_E], T sg, int lane, int i0,
                                        int di, int from, T sv, int si, T (&rv)[PK_E],
                                        int (&ri)[PK_E]) {
    T av = (T)-INFINITY;  // the identity
    int ai = 0;
#pragma unroll
    for (int u = 0; u < PK_E; ++u) {
        const int p = lane * PK_E + u;
        if (p >= from && sg * x[u] > av) {
            av = sg * x[u];
            ai = i0 + di * p;
        }
    }
    // (a lane under d gets its own pair back, and a pair combined with
    // itself is that pair: no lane test)
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const T ov = __shfl_up_sync(PK_FULL, av, d);
        const int oi = __shfl_up_sync(PK_FULL, ai, d);
        if (!(av > ov)) {
            av = ov;
            ai = oi;
        }
    }
    // the lanes before this one, after the seed
    T pv = __shfl_up_sync(PK_FULL, av, 1);
    int pi = __shfl_up_sync(PK_FULL, ai, 1);
    if (lane == 0 || !(pv > sv)) {
        pv = sv;
        pi = si;
    }
#pragma unroll
    for (int u = 0; u < PK_E; ++u) {
        const int p = lane * PK_E + u;
        if (p >= from && sg * x[u] > pv) {
            pv = sg * x[u];
            pi = i0 + di * p;
        }
        rv[u] = pv;
        ri[u] = pi;
    }
}

template <typename T>
__global__ void __launch_bounds__(PK_THREADS) peakdet_scan_kernel(const PeakdetParams P) {
    const int lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * PK_WARPS + (threadIdx.x >> 5);
    if (row >= P.B) return;  // the whole warp
    const int n = P.n, m_max = P.m_max, m_min = P.m_min, reverse = P.reverse;
    const T* x = (const T*)P.w + row * P.stride;
    const T dM = ((const T*)P.dmax)[row], dm = ((const T*)P.dmin)[row];
    const T aM = ((const T*)P.amax)[row], am = ((const T*)P.amin)[row];
    T* omax = (T*)P.smax + row * (long long)m_max;
    T* omin = (T*)P.smin + row * (long long)m_min;
    const int di = reverse ? -1 : 1;
    // Only one tracker is live: the maximum while find_max, else the
    // minimum. The other is read by no test until a declaration flips the
    // mode, and that declaration restarts it. tv, ti: the live one, in its
    // sign (the minimum negated).
    T tv = (T)-INFINITY;
    int ti = 0, nmx = 0, nmn = 0;
    bool find_max = true;
    T cur[PK_E], nxt[PK_E];
    pk_load(x, n, reverse, 0, lane, cur);
    for (int s0 = 0; s0 < n; s0 += PK_STEP) {
        // a row whose mode can declare nothing more is done
        if (find_max ? !(nmx < m_max && !isnan(aM)) : !(nmn < m_min && !isnan(am)))
            break;
        pk_load(x, n, reverse, s0 + PK_STEP, lane, nxt);
        const int i0 = reverse ? n - 1 - s0 : s0;
        T rv[PK_E];
        int ri[PK_E];
        pk_scan(cur, find_max ? (T)1 : (T)-1, lane, i0, di, 0, tv, ti, rv, ri);
        int last = -1;  // the step's last declaration, by position
        while (find_max ? nmx < m_max && !isnan(aM) : nmn < m_min && !isnan(am)) {
            unsigned bits = 0;
#pragma unroll
            for (int u = 0; u < PK_E; ++u) {
                const bool d = find_max ? cur[u] < pk_sub(rv[u], dM) && rv[u] > aM
                                        : cur[u] > pk_add(-rv[u], dm) && -rv[u] < am;
                bits |= (unsigned)(d && lane * PK_E + u > last) << u;
            }
            const unsigned who = __ballot_sync(PK_FULL, bits != 0);
            if (!who) break;
            const int j = __ffs((int)who) - 1;
            const int u = __ffs((int)__shfl_sync(PK_FULL, bits, j)) - 1;
            const int p = j * PK_E + u;
            T wj = cur[0];
            int slot = ri[0];
#pragma unroll
            for (int q = 1; q < PK_E; ++q)
                if (q == u) {
                    wj = cur[q];
                    slot = ri[q];
                }
            wj = __shfl_sync(PK_FULL, wj, j);
            if (lane == j) {
                if (find_max) omax[nmx] = (T)slot;
                else omin[nmn] = (T)slot;
            }
            if (find_max) ++nmx;
            else ++nmn;
            // the opposite tracker, live from here, restarts at this sample
            find_max = !find_max;
            const T sg = find_max ? (T)1 : (T)-1;
            pk_scan(cur, sg, lane, i0, di, p + 1, sg * wj, i0 + di * p, rv, ri);
            last = p;
        }
        // the live tracker after the step's last position
        tv = __shfl_sync(PK_FULL, rv[PK_E - 1], 31);
        ti = __shfl_sync(PK_FULL, ri[PK_E - 1], 31);
#pragma unroll
        for (int u = 0; u < PK_E; ++u) cur[u] = nxt[u];
    }
    const T qnan = (T)NAN;
    for (int k = nmx + lane; k < m_max; k += 32) omax[k] = qnan;
    for (int k = nmn + lane; k < m_min; k += 32) omin[k] = qnan;
    if (lane == 0) {
        ((int*)P.nmax)[row] = nmx;
        ((int*)P.nmin)[row] = nmn;
    }
}

template <typename T>
static cudaError_t pk_launch(const PeakdetParams* p, cudaStream_t st) {
    const int blocks = (p->B + PK_WARPS - 1) / PK_WARPS;
    peakdet_scan_kernel<T><<<blocks, PK_THREADS, 0, st>>>(*p);
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
