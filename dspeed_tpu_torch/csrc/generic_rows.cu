// Generic row-tile fusion (K7) for Hopper (sm_90a): a row-tape interpreter.
//
// Replaces the TPU kernel `generic_rows` (dspeed_tpu/processors/_pallas.py
// :1782, its pallas_call at :2009), which traces a fusion group's member
// bodies into one Pallas program over row tiles. Here the host lowers the
// group into a tape (processors/_tile_program.py): per-row slots (planes in
// shared memory, scalars), and ops, each an opcode with operand and output
// slots and static parameters. One block runs the whole tape for one event
// row: it loads each external plane once (just before its first reader),
// keeps every internal plane in shared memory, and writes each escaping
// output to device memory as soon as its op has produced it. Each op is the
// member kernel's arithmetic, block-cooperatively, on the device code K1-K6
// share:
//   min_max, amax, linear_slope_fit  first-occurrence block reductions and
//                                    K1's slope fit (block_reduce.cuh)
//   pole_zero                        K1's f64 exclusive block scan
//   trap_norm, asym_trap_filter      K1's windows (row_prefix.cuh): <= 32
//                                    samples summed directly, else f64
//                                    prefix differences
//   convolve_wf (banded route)       K4's loop (conv_row.cuh), so the plane
//                                    is the unfused K4 route's bit for bit
//   time_point_thresh                the block searches of K2 and K3
//   windower, avg_current            K3's gather and __fdiv_rn
//   moving_window_multi              K5/K6's cascade (mw_cascade.cuh)
//   fixed_time_pickoff 'l' / 'i'     a per-row gather
//   add, multiply, divide, convert,  per-row scalar arithmetic with _rn
//   convert_round                    intrinsics, rounded to the slot's type
// A row with a NaN poisons what each member poisons, op by op; every op
// computes its input plane's NaN flag once and caches it per slot. The
// switch on the opcode is one uniform branch per op per block.
//
// What bounds it on this card: bytes for most groups. The flagship's first
// generic group reads one 4096-sample f32 row and writes three planes (16 KB
// each) plus a 300-sample current and scalars: about 66 KB per row, 1.09 GB
// per 16384 rows, 0.33 ms at 3.35 TB/s; its 133-tap convolution is 0.27 ms of
// f32 FMAs. The second reads three planes (4784 + 2 x 4096 samples) and
// writes scalars: 0.25 ms.
//
// How the design meets it, in this first version: each external plane is read
// once with coalesced loads and each escape written once; nothing internal
// touches device memory. One row per block and 256 threads; the liveness plan
// reuses dead planes' shared memory, so the flagship's groups need 60-100 KB
// and two blocks fit an SM. Several rows per block, TMA loads and warp-level
// scans are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_reduce.cuh"
#include "conv_row.cuh"
#include "mw_cascade.cuh"
#include "row_prefix.cuh"

#define GEN_THREADS 256
#define GEN_R 4
#define GEN_MAX_EXT 32
#define GEN_MAX_ESC 64

// The tape's record layout, as processors/_tile_program.py writes it.
#define OP_IN 6
#define OP_OUT 4
#define OP_IP 8
#define OP_DP 4
#define OP_INTS (1 + OP_IN + OP_OUT + OP_IP)
#define SLOT_INTS 8
enum { S_KIND, S_F64, S_OFF, S_LEN, S_SIDX, S_EXT, S_ESC, S_ROOT };
enum {
    OP_LOAD = 1, OP_MIN_MAX, OP_BL_SUB, OP_SLOPE_FIT, OP_POLE_ZERO, OP_TRAP,
    OP_AMAX, OP_CONV, OP_TPT, OP_WINDOWER, OP_AVG_CURRENT, OP_MW_MULTI,
    OP_FTP, OP_UFUNC, OP_CONVERT
};

// Mirrored field for field by ctypes in processors/_cuda.py.
struct GenParams {
    const int* code;     // ops (OP_INTS each), then slots (SLOT_INTS each)
    const double* dpar;  // OP_DP per op: static parameters, then constants
    const float* taps;   // every convolution's taps, concatenated
    int B;
    int n_ops;
    int n_slots;
    int n_scal;
    int scratch_dbl;
    int arena_floats;
    const void* ext[GEN_MAX_EXT];  // external inputs: (B, n) f32 or (B,)
    long long ext_stride[GEN_MAX_EXT];  // row stride of an external plane
    void* esc[GEN_MAX_ESC];  // stored roots: (B, n) f32 or (B,) f32/f64
};

// One row's view of the tape.
struct Row {
    const int* slots;
    double* scal;
    double* scratch;
    float* arena;
    int* nanf;  // per slot: -1 unknown, else whether the plane holds a NaN
};

__device__ __forceinline__ const int* slot(const Row& R, int s) {
    return R.slots + s * SLOT_INTS;
}

__device__ __forceinline__ float* plane(const Row& R, int s) {
    return R.arena + slot(R, s)[S_OFF];
}

__device__ __forceinline__ int plen(const Row& R, int s) {
    return slot(R, s)[S_LEN];
}

// Scalar operand k of an op: a slot, or a constant of the op's dp (in[k] =
// -1 - j); bit k of `cast` rounds it to float32, its argument type.
__device__ __forceinline__ double operand(const Row& R, const int* in, int k,
                                          const double* dp, int cast) {
    const int s = in[k];
    double v = s >= 0 ? R.scal[slot(R, s)[S_SIDX]] : dp[-1 - s];
    if ((cast >> k) & 1) v = (double)(float)v;
    return v;
}

// Every thread computes v; thread 0 stores it, rounded to the slot's type.
__device__ __forceinline__ void put(const Row& R, int s, double v) {
    const int* S = slot(R, s);
    if (threadIdx.x == 0) R.scal[S[S_SIDX]] = S[S_F64] ? v : (double)(float)v;
}

// Whether plane slot s holds a NaN (the member's isnan_any row mask); the
// flag is computed once per slot. Called by every thread; a barrier follows.
__device__ bool plane_nan(const Row& R, int s) {
    const int f = R.nanf[s];
    if (f >= 0) return f != 0;
    const float* x = plane(R, s);
    const int n = plen(R, s);
    int h = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) h |= isnan(x[i]);
    const int bad = __syncthreads_or(h) != 0;
    if (threadIdx.x == 0) R.nanf[s] = bad;
    __syncthreads();
    return bad;
}

__global__ void __launch_bounds__(GEN_THREADS)
generic_rows_kernel(const GenParams P) {
    extern __shared__ double smem[];
    __shared__ double red[32];
    __shared__ float redf[32];
    __shared__ int redi[32];

    Row R;
    R.slots = P.code + P.n_ops * OP_INTS;
    R.scal = smem;
    R.scratch = smem + P.n_scal;
    R.arena = (float*)(R.scratch + P.scratch_dbl);
    R.nanf = (int*)(R.arena + P.arena_floats);
    const long long row = blockIdx.x;
    const int tid = threadIdx.x, bd = blockDim.x;
    const float qnan = __int_as_float(0x7fc00000);
    const double dnan = __longlong_as_double(0x7ff8000000000000LL);

    // NaN flags unknown; external scalars into their places
    for (int s = tid; s < P.n_slots; s += bd) {
        R.nanf[s] = -1;
        const int* S = slot(R, s);
        if (S[S_KIND] == 1 && S[S_EXT] >= 0) {
            const void* g = P.ext[S[S_EXT]];
            R.scal[S[S_SIDX]] = S[S_F64] ? ((const double*)g)[row]
                                         : (double)((const float*)g)[row];
        }
    }
    __syncthreads();

    for (int k = 0; k < P.n_ops; ++k) {
        const int* op = P.code + k * OP_INTS;
        const int* in = op + 1;
        const int* out = in + OP_IN;
        const int* ip = out + OP_OUT;
        const double* dp = P.dpar + k * OP_DP;
        switch (op[0]) {
        case OP_LOAD: {
            const int* S = slot(R, in[0]);
            float* x = R.arena + S[S_OFF];
            const float* g = (const float*)P.ext[S[S_EXT]] + row * P.ext_stride[S[S_EXT]];
            for (int i = tid; i < S[S_LEN]; i += bd) x[i] = g[i];
            break;
        }
        case OP_MIN_MAX: {
            const float* x = plane(R, in[0]);
            const int n = plen(R, in[0]);
            const bool bad = plane_nan(R, in[0]);
            float vmin = 0.f, vmax = 0.f;
            int imin = n, imax = n;
            for (int i = tid; i < n; i += bd) {
                const float v = x[i];
                if (imin == n || v < vmin) { vmin = v; imin = i; }
                if (imax == n || v > vmax) { vmax = v; imax = i; }
            }
            block_argext(vmin, imin, false, n, redf, redi);
            block_argext(vmax, imax, true, n, redf, redi);
            put(R, out[0], bad ? dnan : (double)imin);
            put(R, out[1], bad ? dnan : (double)imax);
            put(R, out[2], bad ? dnan : (double)vmin);
            put(R, out[3], bad ? dnan : (double)vmax);
            break;
        }
        case OP_BL_SUB: {
            const float* x = plane(R, in[0]);
            float* o = plane(R, out[0]);
            const int n = plen(R, in[0]);
            const double bl = operand(R, in, 1, dp, ip[7]);
            const bool bad = plane_nan(R, in[0]) || isnan(bl);
            const float b = (float)bl;
            for (int i = tid; i < n; i += bd) o[i] = bad ? qnan : __fsub_rn(x[i], b);
            break;
        }
        case OP_SLOPE_FIT: {
            const float* x = plane(R, in[0]);
            const bool bad = plane_nan(R, in[0]);
            float q[4];
            slope_fit(x, 0, plen(R, in[0]), red, q);
            for (int j = 0; j < 4; ++j) put(R, out[j], bad ? dnan : (double)q[j]);
            break;
        }
        case OP_POLE_ZERO: {
            // pz = w + omc * (exclusive prefix of w): K1's pass 2
            const float* x = plane(R, in[0]);
            float* o = plane(R, out[0]);
            const int n = plen(R, in[0]);
            const bool bad = plane_nan(R, in[0]) || ip[0];
            int j0, j1;
            scan_run(n, j0, j1);
            double run = 0.0;
            for (int j = j0; j < j1; ++j) run += (double)x[j];
            double s = block_excl_scan(run, red);
            for (int j = j0; j < j1; ++j) {
                const float v = x[j];
                o[j] = bad ? qnan : __fadd_rn(v, (float)(dp[0] * s));
                s += (double)v;
            }
            break;
        }
        case OP_TRAP: {
            const float* x = plane(R, in[0]);
            float* o = plane(R, out[0]);
            const int n = plen(R, in[0]);
            const bool bad = plane_nan(R, in[0]);
            block_inclusive_prefix(x, R.scratch, n, red);
            const TrapSpec t = {ip[0], ip[1], ip[2], ip[3]};
            for (int i = tid; i < n; i += bd)
                o[i] = bad ? qnan : trap_at(t, x, R.scratch, i);
            break;
        }
        case OP_AMAX: {
            const float* x = plane(R, in[0]);
            const int n = plen(R, in[0]);
            const bool bad = plane_nan(R, in[0]);
            float mx = -INFINITY;
            for (int i = tid; i < n; i += bd) mx = fmaxf(mx, x[i]);
            mx = block_max(mx, redf);
            put(R, out[0], bad ? dnan : (double)mx);
            break;
        }
        case OP_CONV: {
            // out[o] = sum_t x[lo + o - t] * taps[t]: the row staged with a
            // zero halo, tiles of bd * GEN_R outputs (K4's loop)
            const float* x = plane(R, in[0]);
            float* o = plane(R, out[0]);
            const int n = plen(R, in[0]), p = plen(R, out[0]);
            const int m = ip[1], lo = ip[2];
            const int tile_w = bd * GEN_R;
            const int span = (p + tile_w - 1) / tile_w * tile_w + m - 1;
            const int pad_l = m - 1 - lo;
            float* xs = (float*)R.scratch;
            float* ks = xs + span;
            for (int q = tid; q < span; q += bd) {
                const int g = q - pad_l;
                xs[q] = (g >= 0 && g < n) ? x[g] : 0.f;
            }
            for (int t = tid; t < m; t += bd) ks[t] = P.taps[ip[0] + t];
            __syncthreads();
            const bool bad = plane_nan(R, in[0]);
            for (int o0 = 0; o0 < p; o0 += tile_w) {
                float acc[GEN_R][1];
                conv_row_accumulate<GEN_R, 1>(xs + o0 + tid + (m - 1), ks, m, bd, acc);
#pragma unroll
                for (int r = 0; r < GEN_R; ++r) {
                    const int oi = o0 + tid + r * bd;
                    if (oi < p) o[oi] = bad ? qnan : acc[r][0];
                }
            }
            break;
        }
        case OP_TPT: {
            // first forward (ip[0] = 1) or last backward crossing of a from
            // the integral start t inside the row
            const float* x = plane(R, in[0]);
            const int n = plen(R, in[0]);
            const double a = operand(R, in, 1, dp, ip[7]);
            const double t = operand(R, in, 2, dp, ip[7]);
            const bool bad = plane_nan(R, in[0]);
            const double tt = trunc(t);
            const bool ok = tt >= 0.0 && tt < (double)n && tt == t;
            int idx = -1;
            if (!bad && ok && !isnan(a)) {
                const int s = (int)tt;
                idx = ip[0] ? search_fwd(x, n, s, (float)a, redi)
                            : search_bwd(x, s, (float)a, redi);
            }
            put(R, out[0], idx < 0 ? dnan : (double)idx);
            break;
        }
        case OP_WINDOWER: {
            const float* x = plane(R, in[0]);
            float* o = plane(R, out[0]);
            const int n = plen(R, in[0]), m = plen(R, out[0]);
            const double t0 = operand(R, in, 1, dp, ip[7]);
            const bool bad = plane_nan(R, in[0]) || isnan(t0);
            double t = trunc(t0);
            t = isnan(t) ? 0.0 : fmin(fmax(t, -(m + 1.0)), (double)n);
            const int ti = (int)t;
            for (int j = tid; j < m; j += bd) {
                const int g = ti + j;
                o[j] = (bad || g < 0 || g >= n) ? qnan : x[g];
            }
            break;
        }
        case OP_AVG_CURRENT: {
            const float* x = plane(R, in[0]);
            float* o = plane(R, out[0]);
            const int nw = plen(R, in[0]), m = plen(R, out[0]);
            const int L = ip[0];
            const float lf = (float)dp[0];
            const bool bad = plane_nan(R, in[0]);
            for (int i = tid; i < m; i += bd)
                o[i] = (bad || i >= nw - L) ? qnan
                       : __fdiv_rn(__fsub_rn(x[i + L], x[i]), lf);
            break;
        }
        case OP_MW_MULTI: {
            const float* x = plane(R, in[0]);
            float* o = plane(R, out[0]);
            const int n = plen(R, in[0]);
            for (int i = tid; i < n; i += bd) o[i] = x[i];
            __syncthreads();
            const bool bad = plane_nan(R, in[0]);
            mw_cascade(o, n, ip[0], ip[1], ip[2], R.scratch, red);
            if (bad)
                for (int i = tid; i < n; i += bd) o[i] = qnan;
            break;
        }
        case OP_FTP: {
            const float* x = plane(R, in[0]);
            const int n = plen(R, in[0]);
            const double t = operand(R, in, 1, dp, ip[7]);
            const bool bad = plane_nan(R, in[0]) || isnan(t)
                             || !(t >= 0.0 && t <= (double)(n - 1));
            double v = dnan;
            if (!bad) {
                const int i0 = (int)floor(t);
                const float f = __fsub_rn((float)t, (float)i0);
                const float wi = x[min(max(i0, 0), n - 1)];
                const float wi1 = x[min(max(i0 + 1, 0), n - 1)];
                if (ip[0] == 'i') {
                    v = f == 0.f ? (double)wi : dnan;
                } else {  // 'l'
                    const float t1 = __fsub_rn(1.f, f);
                    v = f == 0.f ? wi
                        : __fadd_rn(__fmul_rn(t1, wi), __fmul_rn(f, wi1));
                }
            }
            put(R, out[0], v);
            break;
        }
        case OP_UFUNC: {
            // float32 operands round once in float64 and once more to
            // float32: the float32 result (53 >= 2 * 24 + 2 bits)
            const double a = operand(R, in, 0, dp, ip[7]);
            const double b = operand(R, in, 1, dp, ip[7]);
            double r = ip[0] == 0 ? __dadd_rn(a, b)
                     : ip[0] == 1 ? __dmul_rn(a, b) : __ddiv_rn(a, b);
            if (ip[1]) r = (double)(float)r;
            put(R, out[0], r);
            break;
        }
        case OP_CONVERT: {
            // (x + offset_in) * ratio - offset_out in float64, rounded half
            // to even for convert_round, in the input's type
            const double x = operand(R, in, 0, dp, 0);
            const double a = operand(R, in, 1, dp, 0);
            const double b = operand(R, in, 2, dp, 0);
            double v = __dsub_rn(__dmul_rn(__dadd_rn(x, a), dp[0]), b);
            if (ip[0]) v = rint(v);
            if (ip[1]) v = (double)(float)v;
            put(R, out[0], v);
            break;
        }
        default:
            break;
        }
        __syncthreads();
        // store the op's escaping outputs
        for (int q = 0; q < OP_OUT && out[q] >= 0; ++q) {
            const int* S = slot(R, out[q]);
            if (S[S_ESC] < 0) continue;
            void* dst = P.esc[S[S_ESC]];
            if (S[S_KIND] == 0) {
                const float* x = R.arena + S[S_OFF];
                float* g = (float*)dst + row * (long long)S[S_LEN];
                for (int i = tid; i < S[S_LEN]; i += bd) g[i] = x[i];
            } else if (tid == 0) {
                const double v = R.scal[S[S_SIDX]];
                if (S[S_F64]) ((double*)dst)[row] = v;
                else ((float*)dst)[row] = (float)v;
            }
        }
        // a plane stored here may be dead: the next op may reuse its space
        __syncthreads();
    }
}

extern "C" int dspeed_generic_rows(const GenParams* p, int smem, void* stream) {
    cudaError_t err = cudaFuncSetAttribute(
        generic_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (p->B == 0) return 0;
    generic_rows_kernel<<<p->B, GEN_THREADS, smem, (cudaStream_t)stream>>>(*p);
    return (int)cudaGetLastError();
}

extern "C" const char* dspeed_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
