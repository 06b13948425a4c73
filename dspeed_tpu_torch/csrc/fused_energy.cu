// Fused HPGe energy front (K1) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_energy_kernel` / `_fused_energy_call`
// (dspeed_tpu/processors/_pallas.py:287, :420; entry `fused_energy` :1451).
// Per event row it computes, reading the raw waveform from device memory once:
//   w    = raw - baseline                          (blsub plane, optional)
//   pz   = w + omc * S_excl(w)                     (pole-zero, omc = -expm1(-1/tau))
//   trap = every "norm"/"asym" trapezoid of pz     (4-term prefix differences)
//   emax = max of the requested traps
// plus optional outputs: the raw waveform's min_max quadruple (NaN mask from
// the waveform only), linear_slope_fit quadruples over static slices of w or
// pz, and uint8 threshold-crossing bitmasks of a trap against a slope output.
// Rows with a NaN in w (raw or baseline) are poisoned.
//
// What bounds it on this card: memory. At the flagship's spec set it reads
// one f32 plane and writes four (pz, two traps, blsub) and one u8 mask, about
// 84 KB per 4096-sample row, so 16384 rows move 1.41 GB: 0.42 ms at
// 3.35 TB/s. The arithmetic (two f64 prefix sums and a few f64 adds per trap
// sample) is well under the f64 rate.
//
// How the design meets it:
// - A persistent grid: a few blocks on each SM walk the rows, so one
//   block's loads overlap the others' compute.
// - Warp w owns the span [128Cw, 128C(w+1)) of a row; in step c, lane l
//   owns the four samples 128(Cw + c) + 4l .. +3 (a "chunk"). Loads and
//   stores are 16 bytes a lane, lanes on neighbouring addresses. No row is
//   held in registers across a barrier: the second pass reads the raw row
//   again, from L2.
// - Both prefixes (of w for the pole-zero, of pz for the traps) stay in
//   float64: a chunk's sum, a warp shuffle scan per step, one cross-warp
//   exchange. The f64 prefix of pz is the block's only row-sized shared
//   memory (8n bytes): each lane first parks its chunks' partial sums there,
//   then adds its offset in place; linear, so the trap reads at i, i-r,
//   i-r-f, i-2r-f by neighbouring lanes hit neighbouring banks. A zero
//   before the row lets those reads clamp their index instead of branching.
// - Short of that bound, what limits the kernel is the instructions it
//   issues (not the f64 units), so each sample gets few: chunk-level
//   extrema, NaN flags taken from the chunk sums (an exact check only where
//   a sum is NaN), slope moments from the chunk sums where a chunk lies
//   inside the slice, and an instance for rows of whole warp spans that
//   does no bounds checks.
// - Four block barriers per row, each one exchange of per-warp partials: the
//   NaN flags, arg-extrema, w-scan and every w-slope's sums; the pz-scan, the
//   pz-slopes' sums and the w-slopes' second-pass variances; the pz-slopes'
//   variances (and the prefix's visibility); the trap maxima (and the mask
//   thresholds). The variance stays two-pass, as in the plain version. One
//   lane finishes each slope fit, with the reciprocals of its length
//   computed once per block.
// - Each trap value is computed once per sample, lanes on consecutive
//   samples; a crossing mask takes its neighbours by shuffle.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define EN_MAX_TRAPS 8
#define EN_MAX_EMAX 8
#define EN_MAX_SLOPES 4
#define EN_MAX_MASKS 4
#define EN_FULL 0xffffffffu

struct TrapSpec {
    int kind;  // 0 = norm (rise, flat), 1 = asym (rise, flat, fall)
    int rise;
    int flat;
    int fall;
};

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

// Per-warp partials of the four exchanges of a row.
struct Ex1 {  // raw flags and extrema, w-scan, w-slopes' sums
    double scan;
    double sy[EN_MAX_SLOPES];
    double sxy[EN_MAX_SLOPES];
    float vmin, vmax;
    int imin, imax, flags, pad;
};
struct Ex2 {  // pz-scan, pz-slopes' sums, w-slopes' variances
    double scan;
    double sy[EN_MAX_SLOPES];
    double sxy[EN_MAX_SLOPES];
    double ss[EN_MAX_SLOPES];
};
struct Ex3 {  // pz-slopes' variances
    double ss[EN_MAX_SLOPES];
};
struct Ex4 {  // trap maxima
    float mx[EN_MAX_TRAPS];
};

// Shared memory of one block: two zeros, the f64 prefix of pz (n rounded up
// to 4 samples), then the four exchange arrays.
struct Layout {
    size_t ex1, ex2, ex3, ex4, total;
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

__host__ __device__ inline Layout layout(int n, int W) {
    Layout L;
    L.ex1 = align16(16 + (size_t)((n + 3) & ~3) * 8);
    L.ex2 = align16(L.ex1 + W * sizeof(Ex1));
    L.ex3 = align16(L.ex2 + W * sizeof(Ex2));
    L.ex4 = align16(L.ex3 + W * sizeof(Ex3));
    L.total = align16(L.ex4 + W * sizeof(Ex4));
    return L;
}

// Lane-steps per warp: a warp spans 128*C samples, a block at most 32 warps.
__host__ inline int chunks_for(int n) { return n <= 4096 ? 4 : 8; }
__host__ inline int warps_for(int n, int C) {
    return n > 128 * C ? (n + 128 * C - 1) / (128 * C) : 1;
}

__device__ __forceinline__ double warp_sum(double v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(EN_FULL, v, o);
    return v;
}

// Exclusive scan of one double per lane; adds the warp's total to tot.
__device__ __forceinline__ double warp_excl_scan(double v, int lane, double& tot) {
    double inc = v;
    for (int o = 1; o < 32; o <<= 1) {
        const double y = __shfl_up_sync(EN_FULL, inc, o);
        if (lane >= o) inc += y;
    }
    const double base = tot;
    tot += __shfl_sync(EN_FULL, inc, 31);
    return base + (inc - v);
}

// First-occurrence extremum: (v, i) beats (v2, i2) when v is strictly more
// extreme, or equal with a smaller index. i == n marks "no candidate".
__device__ __forceinline__ bool ext_better(float v, int i, float v2, int i2,
                                           bool is_max, int n) {
    if (i2 == n) return i != n;
    if (i == n) return false;
    if (is_max ? (v > v2) : (v < v2)) return true;
    return v == v2 && i < i2;
}

__device__ __forceinline__ void warp_argext(float& v, int& i, bool is_max, int n) {
    for (int o = 16; o > 0; o >>= 1) {
        const float v2 = __shfl_xor_sync(EN_FULL, v, o);
        const int i2 = __shfl_xor_sync(EN_FULL, i, o);
        if (ext_better(v2, i2, v, i, is_max, n)) { v = v2; i = i2; }
    }
}

// The chunk at i of a row (zero past its end n).
template <bool FULL>
__device__ __forceinline__ float4 load4(const float* row, int i, int n, int vec) {
    if (FULL || (vec && i + 3 < n)) return *(const float4*)(row + i);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < n) v.x = row[i];
    if (i + 1 < n) v.y = row[i + 1];
    if (i + 2 < n) v.z = row[i + 2];
    if (i + 3 < n) v.w = row[i + 3];
    return v;
}

template <bool FULL>
__device__ __forceinline__ void store4(float* row, int i, int n, int vec, float4 v) {
    if (FULL || (vec && i + 3 < n)) {
        *(float4*)(row + i) = v;
        return;
    }
    if (i < n) row[i] = v.x;
    if (i + 1 < n) row[i + 1] = v.y;
    if (i + 2 < n) row[i + 2] = v.z;
    if (i + 3 < n) row[i + 3] = v.w;
}

// A chunk's four values in f64, zero past the row's end.
struct D4 {
    double d0, d1, d2, d3;
};

template <bool FULL>
__device__ __forceinline__ D4 widen(float4 v, int i, int n) {
    D4 d = {(double)v.x, (double)v.y, (double)v.z, (double)v.w};
    if (!FULL) {
        if (i >= n) d.d0 = 0.0;
        if (i + 1 >= n) d.d1 = 0.0;
        if (i + 2 >= n) d.d2 = 0.0;
        if (i + 3 >= n) d.d3 = 0.0;
    }
    return d;
}

__device__ __forceinline__ double sum4(const D4& d) { return (d.d0 + d.d1) + (d.d2 + d.d3); }

__device__ __forceinline__ double at4(const D4& d, int j) {
    return j == 0 ? d.d0 : j == 1 ? d.d1 : j == 2 ? d.d2 : d.d3;
}

// Add a chunk at i (sum cs) to the moments of the slice [a0, b0): y and
// y*(i - a0). A chunk inside the slice takes them from its sum.
__device__ __forceinline__ void chunk_moments(const D4& d, double cs, int i, int a0,
                                              int b0, double& sy, double& sxy) {
    if (i + 4 <= a0 || i >= b0) return;
    if (i >= a0 && i + 4 <= b0) {
        sy += cs;
        sxy += (double)(i - a0) * cs + (d.d1 + 2.0 * d.d2 + 3.0 * d.d3);
        return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
        if (i + j >= a0 && i + j < b0) {
            sy += at4(d, j);
            sxy += at4(d, j) * (double)(i + j - a0);
        }
}

// A chunk's sum of squared deviations from mean over the slice [a0, b0).
__device__ __forceinline__ double chunk_ss(const D4& d, int i, int a0, int b0,
                                           double mean) {
    if (i + 4 <= a0 || i >= b0) return 0.0;
    double ss = 0.0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
        if (i + j >= a0 && i + j < b0) {
            const double e = at4(d, j) - mean;
            ss += e * e;
        }
    return ss;
}

// A chunk's pz values, exactly, from the running sums of pz that its lane
// parked at ps[i .. i+3] (f64 sums of four f32 values are exact).
__device__ __forceinline__ D4 parked(const double* ps, int i) {
    const double2 ra = *(const double2*)(ps + i);
    const double2 rb = *(const double2*)(ps + i + 2);
    return {ra.x, ra.y - ra.x, rb.x - ra.y, rb.y - rb.x};
}

// Whether this warp's span [wb, wb + span) misses the slice [a0, b0); such a
// warp adds zeros for the slice and skips its samples.
__device__ __forceinline__ bool misses(int wb, int span, int a0, int b0) {
    return wb + span <= a0 || wb >= b0;
}

// Per slope, computed once per block: 1/L, 1/(L-1) (0 for L = 1), the sum
// of the abscissae 0..L-1 and 1/(L*sum x^2 - (sum x)^2).
struct SlopeConst {
    double inv_l, inv_lm1, sum_x, inv_den;
};

__device__ __forceinline__ double sum_over(const double* first, size_t stride, int W) {
    double t = 0.0;
    for (int w = 0; w < W; ++w) t += *(const double*)((const char*)first + w * stride);
    return t;
}

struct TrapEval {
    int kind, r, rf, rff;
    double inv_r, inv_fl;
    __device__ TrapEval(const TrapSpec& t)
        : kind(t.kind), r(t.rise), rf(t.rise + t.flat),
          rff(t.rise + t.flat + (t.kind == 0 ? t.rise : t.fall)),
          inv_r(1.0 / (double)t.rise),
          inv_fl(1.0 / (double)(t.kind == 0 ? t.rise : t.fall)) {}
    // trap_norm (rise, flat) or asym_trap_filter (rise, flat, fall) at i,
    // from the f64 prefix ps, which holds zeros at -1 and -2
    __device__ __forceinline__ float at(const double* ps, int i) const {
        const double d1 = ps[i] - ps[max(i - r, -1)];
        const double d2 = ps[max(i - rf, -1)] - ps[max(i - rff, -1)];
        if (kind == 0) return (float)((d1 - d2) * inv_r);
        return (float)(d1 * inv_r - d2 * inv_fl);
    }
};

// C: lane-steps per warp; MAXT: the most threads a block of this instance
// has (256 for rows of up to 4096 samples); FULL: every chunk of every warp
// lies inside the row, and rows are 16-byte aligned.
template <int C, int MAXT, bool FULL>
__global__ void __launch_bounds__(MAXT, MAXT <= 256 ? 4 : 1)
fused_energy_kernel(const __grid_constant__ EnergyParams P, int vec) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ SlopeConst sc[EN_MAX_SLOPES];
    __shared__ float quad[4 * EN_MAX_SLOPES];
    const int n = P.n;
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int W = blockDim.x >> 5;
    const Layout Lo = layout(n, W);
    double* ps = (double*)(smem + 16);
    Ex1* e1 = (Ex1*)(smem + Lo.ex1);
    Ex2* e2 = (Ex2*)(smem + Lo.ex2);
    Ex3* e3 = (Ex3*)(smem + Lo.ex3);
    Ex4* e4 = (Ex4*)(smem + Lo.ex4);
    const float qnan = __int_as_float(0x7fc00000);
    const float4 nan4 = make_float4(qnan, qnan, qnan, qnan);
    // this warp's first sample, and this lane's in step 0; step c adds 128*c
    const int wb = wid * 128 * C;
    const int s0 = wb + 4 * lane;
    if ((int)threadIdx.x < P.nslope) {
        const int k = threadIdx.x;
        const double L = (double)(P.slope_b0[k] - P.slope_a0[k]);
        const double sum_x = L * (L - 1.0) / 2.0;
        const double sum_x2 = (L - 1.0) * L * (2.0 * L - 1.0) / 6.0;
        sc[k] = {1.0 / L, L > 1.0 ? 1.0 / (L - 1.0) : 0.0, sum_x,
                 1.0 / (L * sum_x2 - sum_x * sum_x)};
    }
    if (threadIdx.x == 0) ps[-1] = ps[-2] = 0.0;
    __syncthreads();

    for (long long row = blockIdx.x; row < P.B; row += gridDim.x) {
        const float blv = P.bl[row];
        const float* wr = P.w + row * (long long)n;

        // -- exchange 1: flags, raw extrema, w-scan, w-slopes' sums --------
        int raw_nan = 0, w_nan = 0;
        float vmin = 0.f, vmax = 0.f;
        int imin = n, imax = n;
        double excl[C];
        double tot = 0.0;
        {
            float4 v[C];
#pragma unroll
            for (int c = 0; c < C; ++c) v[c] = load4<FULL>(wr, s0 + 128 * c, n, vec);
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const int i = s0 + 128 * c;
                const float4 x = v[c];
                const D4 d = widen<FULL>(
                    make_float4(x.x - blv, x.y - blv, x.z - blv, x.w - blv), i, n);
                const double cs = sum4(d);
                if (isnan(cs)) {  // a NaN in w, or infinities of both signs
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const float xj = j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
                        if (FULL || i + j < n) {
                            raw_nan |= isnan(xj);
                            w_nan |= isnan(xj - blv);
                        }
                    }
                }
                if (P.mm[0] != nullptr && (FULL || i < n)) {
                    const float x1 = FULL || i + 1 < n ? x.y : x.x;
                    const float x2 = FULL || i + 2 < n ? x.z : x1;
                    const float x3 = FULL || i + 3 < n ? x.w : x2;
                    const float lo = fminf(fminf(x.x, x1), fminf(x2, x3));
                    const float hi = fmaxf(fmaxf(x.x, x1), fmaxf(x2, x3));
                    if (imin == n || lo < vmin) {
                        vmin = lo;
                        imin = i + (x.x == lo ? 0 : x1 == lo ? 1 : x2 == lo ? 2 : 3);
                    }
                    if (imax == n || hi > vmax) {
                        vmax = hi;
                        imax = i + (x.x == hi ? 0 : x1 == hi ? 1 : x2 == hi ? 2 : 3);
                    }
                }
                excl[c] = warp_excl_scan(cs, lane, tot);
            }
#pragma unroll
            for (int s = 0; s < EN_MAX_SLOPES; ++s) {
                if (s >= P.nslope || P.slope_src[s] != 0) continue;
                const int a0 = P.slope_a0[s], b0 = P.slope_b0[s];
                double sy = 0.0, sxy = 0.0;
                if (!misses(wb, 128 * C, a0, b0)) {
#pragma unroll
                    for (int c = 0; c < C; ++c) {
                        const int i = s0 + 128 * c;
                        const float4 x = v[c];
                        const D4 d = widen<FULL>(
                            make_float4(x.x - blv, x.y - blv, x.z - blv, x.w - blv), i, n);
                        chunk_moments(d, sum4(d), i, a0, b0, sy, sxy);
                    }
                    sy = warp_sum(sy);
                    sxy = warp_sum(sxy);
                }
                if (lane == 0) { e1[wid].sy[s] = sy; e1[wid].sxy[s] = sxy; }
            }
        }
        if (P.mm[0] != nullptr) {
            warp_argext(vmin, imin, false, n);
            warp_argext(vmax, imax, true, n);
        }
        const int flags = __any_sync(EN_FULL, raw_nan) | (__any_sync(EN_FULL, w_nan) << 1);
        if (lane == 0) {
            e1[wid].scan = tot;
            e1[wid].vmin = vmin; e1[wid].imin = imin;
            e1[wid].vmax = vmax; e1[wid].imax = imax;
            e1[wid].flags = flags;
        }
        __syncthreads();

        int all_flags = 0;
        double woff = 0.0;
        for (int v = 0; v < W; ++v) {
            all_flags |= e1[v].flags;
            if (v < wid) woff += e1[v].scan;
        }
        const bool bad_raw = all_flags & 1;
        const bool bad = (all_flags >> 1) & 1;
        if (wid == 0 && P.mm[0] != nullptr) {
            float bmin = 0.f, bmax = 0.f;
            int jmin = n, jmax = n;
            if (lane < W) {
                bmin = e1[lane].vmin; jmin = e1[lane].imin;
                bmax = e1[lane].vmax; jmax = e1[lane].imax;
            }
            warp_argext(bmin, jmin, false, n);
            warp_argext(bmax, jmax, true, n);
            if (lane == 0) {
                P.mm[0][row] = bad_raw ? qnan : (float)jmin;
                P.mm[1][row] = bad_raw ? qnan : (float)jmax;
                P.mm[2][row] = bad_raw ? qnan : bmin;
                P.mm[3][row] = bad_raw ? qnan : bmax;
            }
        }

        // -- pole-zero; exchange 2: pz-scan, pz-slopes' sums, w-slopes'
        //    variances (the raw row again, from L2). Each chunk's running
        //    sums of pz are parked in the prefix array -----------------------
        float* blo = P.blsub ? P.blsub + row * (long long)n : nullptr;
        float* pzo = P.pz + row * (long long)n;
        {
            float4 v[C];
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const float4 x = load4<FULL>(wr, s0 + 128 * c, n, vec);
                v[c] = make_float4(x.x - blv, x.y - blv, x.z - blv, x.w - blv);
            }
#pragma unroll
            for (int s = 0; s < EN_MAX_SLOPES; ++s) {
                if (s >= P.nslope || P.slope_src[s] != 0) continue;
                const int a0 = P.slope_a0[s], b0 = P.slope_b0[s];
                double ss = 0.0;
                if (!misses(wb, 128 * C, a0, b0)) {
                    const double mean = sum_over(&e1[0].sy[s], sizeof(Ex1), W) * sc[s].inv_l;
#pragma unroll
                    for (int c = 0; c < C; ++c) {
                        const int i = s0 + 128 * c;
                        ss += chunk_ss(widen<FULL>(v[c], i, n), i, a0, b0, mean);
                    }
                    ss = warp_sum(ss);
                }
                if (lane == 0) e2[wid].ss[s] = ss;
            }
            tot = 0.0;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const int i = s0 + 128 * c;
                const D4 d = widen<FULL>(v[c], i, n);
                // pz = w + omc * (exclusive prefix of w)
                const double s_0 = woff + excl[c];
                const double s_1 = s_0 + d.d0, s_2 = s_1 + d.d1, s_3 = s_2 + d.d2;
                float4 pz = make_float4(v[c].x + (float)(P.omc * s_0),
                                        v[c].y + (float)(P.omc * s_1),
                                        v[c].z + (float)(P.omc * s_2),
                                        v[c].w + (float)(P.omc * s_3));
                const D4 q = widen<FULL>(pz, i, n);
                const double r0 = q.d0, r1 = r0 + q.d1, r2 = r1 + q.d2, r3 = r2 + q.d3;
                if (FULL || i < n) {
                    *(double2*)(ps + i) = make_double2(r0, r1);
                    *(double2*)(ps + i + 2) = make_double2(r2, r3);
                }
                if (blo) store4<FULL>(blo, i, n, vec, bad ? nan4 : v[c]);
                store4<FULL>(pzo, i, n, vec, bad ? nan4 : pz);
                excl[c] = warp_excl_scan(r3, lane, tot);
            }
        }
#pragma unroll
        for (int s = 0; s < EN_MAX_SLOPES; ++s) {
            if (s >= P.nslope || P.slope_src[s] != 1) continue;
            const int a0 = P.slope_a0[s], b0 = P.slope_b0[s];
            double sy = 0.0, sxy = 0.0;
            if (!misses(wb, 128 * C, a0, b0)) {
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    const int i = s0 + 128 * c;
                    if (!FULL && i >= n) continue;
                    const D4 q = parked(ps, i);
                    chunk_moments(q, ps[i + 3], i, a0, b0, sy, sxy);
                }
                sy = warp_sum(sy);
                sxy = warp_sum(sxy);
            }
            if (lane == 0) { e2[wid].sy[s] = sy; e2[wid].sxy[s] = sxy; }
        }
        if (lane == 0) e2[wid].scan = tot;
        __syncthreads();

        // -- exchange 3: pz-slopes' variances; the f64 prefix of pz in place
        //    (the barrier also publishes it) ---------------------------------
#pragma unroll
        for (int s = 0; s < EN_MAX_SLOPES; ++s) {
            if (s >= P.nslope || P.slope_src[s] != 1) continue;
            const int a0 = P.slope_a0[s], b0 = P.slope_b0[s];
            double ss = 0.0;
            if (!misses(wb, 128 * C, a0, b0)) {
                const double mean = sum_over(&e2[0].sy[s], sizeof(Ex2), W) * sc[s].inv_l;
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    const int i = s0 + 128 * c;
                    if (!FULL && i >= n) continue;
                    ss += chunk_ss(parked(ps, i), i, a0, b0, mean);
                }
                ss = warp_sum(ss);
            }
            if (lane == 0) e3[wid].ss[s] = ss;
        }
        {
            double poff = 0.0;
            for (int v = 0; v < wid; ++v) poff += e2[v].scan;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const int i = s0 + 128 * c;
                if (!FULL && i >= n) continue;
                const double2 ra = *(const double2*)(ps + i);
                const double2 rb = *(const double2*)(ps + i + 2);
                const double base = poff + excl[c];
                *(double2*)(ps + i) = make_double2(base + ra.x, base + ra.y);
                *(double2*)(ps + i + 2) = make_double2(base + rb.x, base + rb.y);
            }
        }
        __syncthreads();

        // each slope fit finished by one lane of warp 0: its four outputs,
        // and its quadruple in shared memory for the masks' thresholds
        if (wid == 0 && lane < P.nslope) {
            const int s = lane;
            const bool src0 = P.slope_src[s] == 0;
            const double sy = src0 ? sum_over(&e1[0].sy[s], sizeof(Ex1), W)
                                   : sum_over(&e2[0].sy[s], sizeof(Ex2), W);
            const double sxy = src0 ? sum_over(&e1[0].sxy[s], sizeof(Ex1), W)
                                    : sum_over(&e2[0].sxy[s], sizeof(Ex2), W);
            const double ss = src0 ? sum_over(&e2[0].ss[s], sizeof(Ex2), W)
                                   : sum_over(&e3[0].ss[s], sizeof(Ex3), W);
            const SlopeConst k = sc[s];
            const double L = (double)(P.slope_b0[s] - P.slope_a0[s]);
            const double slope = (L * sxy - k.sum_x * sy) * k.inv_den;
            const float q[4] = {(float)(sy * k.inv_l), (float)sqrt(ss * k.inv_lm1),
                                (float)slope, (float)((sy - k.sum_x * slope) * k.inv_l)};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                quad[4 * s + j] = q[j];
                P.slope_out[4 * s + j][row] = bad ? qnan : q[j];
            }
        }

        // -- traps: lane l of warp w at sample 128*C*w + 32*m + l -----------
        for (int t = 0; t < P.ntrap; ++t) {
            const TrapEval te(P.trap[t]);
            float* o = P.trap_out[t] + row * (long long)n;
            float mx = -INFINITY;
#pragma unroll 4
            for (int m = 0; m < 4 * C; ++m) {
                const int i = wb + 32 * m + lane;
                if (FULL || i < n) {
                    const float v = te.at(ps, i);
                    o[i] = bad ? qnan : v;
                    mx = fmaxf(mx, v);
                }
            }
            for (int k = 16; k > 0; k >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(EN_FULL, mx, k));
            if (lane == 0) e4[wid].mx[t] = mx;
        }
        __syncthreads();

        // -- exchange 4: the trap maxima; then the crossing masks ------------
        if (wid == 0 && lane < P.nemax) {
            const int t = P.emax_idx[lane];
            float mx = e4[0].mx[t];
            for (int v = 1; v < W; ++v) mx = fmaxf(mx, e4[v].mx[t]);
            P.emax_out[lane][row] = bad ? qnan : mx;
        }
        // bit 0: forward crossing between i and i+1, bit 1: backward crossing
        // between i-1 and i; zero on bad rows
        for (int k = 0; k < P.nmask; ++k) {
            const TrapEval te(P.mask_trap[k]);
            const float a = quad[4 * P.mask_si[k] + P.mask_oi[k]];
            const bool fwd = P.mask_fwd[k] != 0, bwd = P.mask_bwd[k] != 0;
            uint8_t* o = P.mask_out[k] + row * (long long)n;
            // the trap just before this warp's span, for lane 0's first step
            float carry = 0.f;
            if (lane == 0 && wb >= 1 && (FULL || wb - 1 < n)) carry = te.at(ps, wb - 1);
#pragma unroll 4
            for (int m = 0; m < 4 * C; ++m) {
                const int i = wb + 32 * m + lane;
                const float ti = FULL || i < n ? te.at(ps, i) : 0.f;
                float tm = __shfl_up_sync(EN_FULL, ti, 1);
                if (lane == 0) tm = carry;
                carry = __shfl_sync(EN_FULL, ti, 31);
                float tp = 0.f;
                if (fwd) {
                    tp = __shfl_down_sync(EN_FULL, ti, 1);
                    if (lane == 31 && i + 1 < n) tp = te.at(ps, i + 1);
                }
                if (FULL || i < n) {
                    uint8_t bits = 0;
                    if (!bad) {
                        if (fwd && i <= n - 2 && ((ti <= a && a < tp) || (ti >= a && a > tp)))
                            bits |= 1;
                        if (bwd && i >= 1 && ((tm < a && a <= ti) || (tm > a && a >= ti)))
                            bits |= 2;
                    }
                    o[i] = bits;
                }
            }
        }
    }
}

// The instance for rows of n samples (vec: rows 16-byte aligned) and its
// lane-steps per warp.
static const void* instance(int n, int vec, int& C) {
    C = chunks_for(n);
    if (n <= 4096) {
        if (vec && n % (128 * C) == 0) return (const void*)fused_energy_kernel<4, 256, true>;
        return (const void*)fused_energy_kernel<4, 256, false>;
    }
    return (const void*)fused_energy_kernel<8, 1024, false>;
}

// How rows of n samples launch: the instance, its block, its shared memory
// and how many of its blocks an SM holds.
struct Plan {
    const void* fn;
    int threads, per_sm;
    size_t smem;
};

static cudaError_t plan_for(int n, int vec, Plan& pl) {
    int C;
    pl.fn = instance(n, vec, C);
    const int W = warps_for(n, C);
    if (W > 32) return cudaErrorInvalidValue;
    pl.threads = 32 * W;
    pl.smem = layout(n, W).total;
    cudaError_t err = cudaFuncSetAttribute(
        pl.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&pl.per_sm, pl.fn,
                                                            pl.threads, pl.smem);
    if (err != cudaSuccess) return err;
    return pl.per_sm > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// The shared memory a block takes for rows of n samples.
extern "C" int dspeed_fused_energy_smem_bytes(int n) {
    return (int)layout(n, warps_for(n, chunks_for(n))).total;
}

extern "C" int dspeed_fused_energy(const EnergyParams* p, void* stream) {
    int vec = (p->n % 4 == 0) && ((uintptr_t)p->w % 16 == 0) &&
              ((uintptr_t)p->pz % 16 == 0) &&
              (p->blsub == nullptr || (uintptr_t)p->blsub % 16 == 0);
    Plan pl;
    cudaError_t err = plan_for(p->n, vec, pl);
    if (err != cudaSuccess) return (int)err;
    if (p->B == 0) return 0;
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const long long want = (long long)pl.per_sm * sms;
    const int grid = (int)(p->B < want ? p->B : want);
    void* args[] = {(void*)p, &vec};
    return (int)cudaLaunchKernel(pl.fn, dim3(grid), dim3(pl.threads), args,
                                 pl.smem, (cudaStream_t)stream);
}

// How K1 launches for aligned rows of n samples: threads per block, shared
// memory per block, blocks per SM, and the kernel's registers and local
// (spill) bytes per thread; returns a CUDA error code.
extern "C" int dspeed_fused_energy_config(int n, int* out) {
    Plan pl;
    cudaError_t err = plan_for(n, n % 4 == 0, pl);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, pl.fn);
    if (err != cudaSuccess) return (int)err;
    out[0] = pl.threads;
    out[1] = (int)pl.smem;
    out[2] = pl.per_sm;
    out[3] = attr.numRegs;
    out[4] = (int)attr.localSizeBytes;
    return 0;
}

extern "C" const char* dspeed_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
