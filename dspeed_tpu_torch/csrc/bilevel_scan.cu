// The bi-level zero-crossing trigger's sweep for Hopper (sm_90a): one warp
// per event.
//
// Replaces the `lax.scan` of dspeed_tpu/processors/time_point_thresh.py:400
// (`bi_level_zero_crossing_time_points`, unroll 8), which is not a Pallas
// kernel: the trigger is a five-flag state machine along the row (the
// threshold crossings' activation samples `above` and `below`, the
// zero-crossed flag, the two zero-crossing candidates and the count), so the
// JAX package scans it over sample pairs, batched over the events. Its step
// on the pair (w[i], w[i+1]), which the plain version
// (_cuda.bilevel_scan_plain) runs in order from i = 0, each update in the
// JAX step's order:
//   from t_start on (i >= start):
//   a rise through 0 after a negative-threshold crossing (below >= 0) sets
//     crossed and the negative candidate i;
//   a rise through the positive threshold (w0 <= pos < w1): with crossed
//     and below >= 0, a crossing within the gate (i - below < gate) emits
//     (polarity 0, the negative candidate), one outside it re-arms above =
//     i; below = -1; without them, above = i; crossed is cleared where
//     below >= 0;
//   then a fall through 0 after a positive-threshold crossing (above >= 0,
//     read after the branch above) sets crossed and the positive candidate;
//   a fall through the negative threshold mirrors the rise (polarity 1,
//     the positive candidate).
// The count keeps going past the m slots; the slots stop at m. Comparisons
// are in the row's type, the gate test in int32 after the wrapper's trunc,
// and the candidates are written as the row's type, so the outputs (a count,
// 0/1 and sample indices) equal the plain version bit for bit. A row's NaN,
// its start's rule and the uint32 count are the processor's
// (processors/time_point_thresh.py), around the sweep.
//
// The design: a warp walks one row, BL_STEP sample pairs a step, lane k
// holding the pairs 8k .. 8k+7 of the step (its own eight samples, the next
// lane's first for the last pair). The four predicates of a pair (0 crossed
// upward, the positive threshold crossed upward, 0 crossed downward, the
// negative threshold crossed downward; each false before `start`) read only
// the two samples and the thresholds, so every lane computes its pairs'
// at once, and a ballot a kind gives the lanes that hold one. The state is
// the warp's, the same in every lane. It changes at a threshold crossing (a
// few a row), walked one pair at a time in order with the step above; and
// between two such lanes above and below hold, so there a zero crossing
// only sets crossed and its candidate (the last one in the run): mask
// arithmetic on the ballots. An emit's slot is written by lane 0 straight to
// device memory, and the slots left are set NaN at the end of the row.
//
// What bounds it on this card: the bytes. 16384 rows of 4096 float32 samples
// are 268 MB read once, 0.080 ms at 3.35 TB/s; the slots and counts written
// are 1 MB at m = 8. A lane reads its eight samples by 16-byte loads where
// the row allows them, the next step's in flight while the warp walks the
// current one (four pairs a lane, half the bytes in flight, was slower).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BL_WARPS 4  // rows a block, one warp each
#define BL_THREADS (32 * BL_WARPS)
#define BL_E 8  // sample pairs a lane a step
#define BL_STEP (32 * BL_E)
#define BL_FULL 0xffffffffu

// Mirrored field for field by ctypes in processors/_cuda.py.
struct BilevelParams {
    const void* w;     // (B, n) rows, float32 or float64
    long long stride;  // row stride of w, in samples
    const void* pos;   // (B,) thresholds in the row's type
    const void* neg;
    const int* gate;   // (B,) gate lengths and first samples, int32
    const int* start;
    int* nc;           // (B,) int32
    void* pol;         // (B, m) each, in the row's type
    void* trig;
    int B, n, m, f64;
};

template <typename T>
__host__ __device__ constexpr int bl_vec() {
    return 16 / (int)sizeof(T);
}

__device__ __forceinline__ void bl_ld16(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
}

__device__ __forceinline__ void bl_ld16(const double* p, double* v) {
    const double2 q = *reinterpret_cast<const double2*>(p);
    v[0] = q.x;
    v[1] = q.y;
}

// The lane's samples w[s0 + BL_E lane + u] of the step at s0: 16 bytes a
// load with `vec` (the row 16-byte aligned), else one sample; 0 past the row.
template <typename T>
__device__ __forceinline__ void bl_load(const T* x, int n, int s0, int lane, bool vec,
                                        T (&v)[BL_E]) {
    constexpr int V = bl_vec<T>();
    const int a = s0 + lane * BL_E;
    if (vec && a + BL_E <= n) {
#pragma unroll
        for (int q = 0; q < BL_E; q += V) bl_ld16(x + a + q, v + q);
    } else {
#pragma unroll
        for (int u = 0; u < BL_E; ++u) v[u] = a + u < n ? x[a + u] : (T)0;
    }
}

// Lanes c .. 31 of a mask.
__device__ __forceinline__ unsigned bl_from(int c) {
    return c < 32 ? BL_FULL << c : 0u;
}

// The warp's trigger state (the same in every lane) and the row's slots.
template <typename T>
struct Trigger {
    int gate, m;
    int above, below, pos_cand, neg_cand, nc;
    bool crossed;
    T* pol;
    T* trig;

    __device__ __forceinline__ void emit(int lane, T polarity, int cand) {
        if (nc < m && lane == 0) {
            pol[nc] = polarity;
            trig[nc] = (T)cand;
        }
        ++nc;
    }

    // The lanes `seg` of a step, none of which crosses a threshold: above
    // and below hold, so a zero crossing sets crossed and its candidate, the
    // last one in the run. zn, zp: the lanes with a zero crossing upward
    // (downward); zn_b, zp_b: this lane's pairs that have one, a bit each.
    __device__ __forceinline__ void run(unsigned seg, unsigned zn, unsigned zp,
                                        unsigned zn_b, unsigned zp_b, int s0) {
        if (below >= 0 && (zn & seg)) {
            const int l = 31 - __clz((int)(zn & seg));
            const unsigned b = __shfl_sync(BL_FULL, zn_b, l);
            crossed = true;
            neg_cand = s0 + l * BL_E + 31 - __clz((int)b);
        }
        if (above >= 0 && (zp & seg)) {
            const int l = 31 - __clz((int)(zp & seg));
            const unsigned b = __shfl_sync(BL_FULL, zp_b, l);
            crossed = true;
            pos_cand = s0 + l * BL_E + 31 - __clz((int)b);
        }
    }

    // The pairs of lane t, one at a time: its predicates' bits (zn, pc, zp,
    // nc: bit u of each byte of `b` for pair u), pair u at sample i0 + u.
    __device__ __forceinline__ void walk(int lane, unsigned b, int i0) {
#pragma unroll
        for (int u = 0; u < BL_E; ++u) {
            const int i = i0 + u;
            const bool below_on = below >= 0;
            if (below_on && (b >> u & 1)) {
                crossed = true;
                neg_cand = i;
            }
            if (b >> (BL_E + u) & 1) {
                if (crossed && below_on) {
                    if (i - below < gate) emit(lane, (T)0, neg_cand);
                    else above = i;
                    below = -1;
                } else {
                    above = i;
                }
                if (below_on) crossed = false;
            }
            const bool above_on = above >= 0;
            if (above_on && (b >> (2 * BL_E + u) & 1)) {
                crossed = true;
                pos_cand = i;
            }
            if (b >> (3 * BL_E + u) & 1) {
                if (crossed && above_on) {
                    if (i - above < gate) emit(lane, (T)1, pos_cand);
                    else below = i;
                    above = -1;
                } else {
                    below = i;
                }
                if (above_on) crossed = false;
            }
        }
    }
};

template <typename T>
__global__ void __launch_bounds__(BL_THREADS)
bilevel_scan_kernel(const BilevelParams P, int vec) {
    const int lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * BL_WARPS + (threadIdx.x >> 5);
    if (row >= P.B) return;  // the whole warp
    const int n = P.n, start = P.start[row];
    const T* x = (const T*)P.w + row * P.stride;
    const T pos = ((const T*)P.pos)[row], neg = ((const T*)P.neg)[row], zero = (T)0;
    Trigger<T> s;
    s.gate = P.gate[row];
    s.m = P.m;
    s.above = s.below = -1;
    s.pos_cand = s.neg_cand = s.nc = 0;
    s.crossed = false;
    s.pol = (T*)P.pol + row * (long long)P.m;
    s.trig = (T*)P.trig + row * (long long)P.m;

    // the pairs before start change nothing: begin at the step that holds it
    const int first = start > 0 ? min(start, n) / BL_STEP * BL_STEP : 0;
    T cur[BL_E], nxt[BL_E];
    bl_load(x, n, first, lane, vec, cur);
    for (int s0 = first; s0 < n - 1; s0 += BL_STEP) {
        bl_load(x, n, s0 + BL_STEP, lane, vec, nxt);
        // w[i + 1] of the lane's last pair: the next lane's first sample,
        // lane 31's from the next step
        const T right = __shfl_sync(BL_FULL, cur[0], (lane + 1) & 31);
        const T ahead = __shfl_sync(BL_FULL, nxt[0], 0);
        const T last = lane == 31 ? ahead : right;
        unsigned zn_b = 0, pc_b = 0, zp_b = 0, nc_b = 0;
#pragma unroll
        for (int u = 0; u < BL_E; ++u) {
            const int i = s0 + lane * BL_E + u;
            const T w0 = cur[u], w1 = u + 1 < BL_E ? cur[u + 1] : last;
            const bool act = i >= start && i < n - 1;
            zn_b |= (unsigned)(act && w0 <= zero && zero < w1) << u;
            pc_b |= (unsigned)(act && w0 <= pos && pos < w1) << u;
            zp_b |= (unsigned)(act && w0 >= zero && zero > w1) << u;
            nc_b |= (unsigned)(act && w0 >= neg && neg > w1) << u;
        }
        const unsigned zn = __ballot_sync(BL_FULL, zn_b != 0);
        const unsigned zp = __ballot_sync(BL_FULL, zp_b != 0);
        unsigned th = __ballot_sync(BL_FULL, (pc_b | nc_b) != 0);
        const unsigned bits = zn_b | pc_b << BL_E | zp_b << 2 * BL_E | nc_b << 3 * BL_E;
        int c = 0;  // the first lane not yet walked
        while (th) {
            const int t = __ffs((int)th) - 1;
            th &= th - 1;
            s.run(bl_from(c) & ~bl_from(t), zn, zp, zn_b, zp_b, s0);
            s.walk(lane, __shfl_sync(BL_FULL, bits, t), s0 + t * BL_E);
            c = t + 1;
        }
        s.run(bl_from(c), zn, zp, zn_b, zp_b, s0);
#pragma unroll
        for (int u = 0; u < BL_E; ++u) cur[u] = nxt[u];
    }
    const T qnan = (T)NAN;
    for (int k = min(s.nc, P.m) + lane; k < P.m; k += 32) {
        s.pol[k] = qnan;
        s.trig[k] = qnan;
    }
    if (lane == 0) P.nc[row] = s.nc;
}

// 16-byte loads where every row and the pointer allow them.
template <typename T>
static int bl_vec_ok(const BilevelParams* p) {
    const int V = bl_vec<T>();
    return p->stride % V == 0 && ((uintptr_t)p->w & 15) == 0;
}

template <typename T>
static cudaError_t bl_launch(const BilevelParams* p, cudaStream_t st) {
    const int blocks = (p->B + BL_WARPS - 1) / BL_WARPS;
    bilevel_scan_kernel<T><<<blocks, BL_THREADS, 0, st>>>(*p, bl_vec_ok<T>(p));
    return cudaGetLastError();
}

extern "C" int dspeed_bilevel_scan(const BilevelParams* p, void* stream) {
    if (p->B == 0 || p->n == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    return (int)(p->f64 ? bl_launch<double>(p, st) : bl_launch<float>(p, st));
}

// The most slots a row: the slots go straight to device memory, so any
// count an int holds (f64 as before, for float64 rows).
extern "C" int dspeed_bilevel_scan_max_slots(int f64) {
    (void)f64;
    return 0x7fffffff;
}

// How the float32 instance launches at m slots: rows and threads a block,
// blocks per SM, registers and local (spill) bytes a thread, shared bytes.
extern "C" int dspeed_bilevel_scan_config(int m, int* out) {
    (void)m;
    const auto fn = bilevel_scan_kernel<float>;
    int per_sm;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, BL_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, fn)) != cudaSuccess) return (int)err;
    const int vals[] = {BL_WARPS, BL_THREADS, per_sm, attr.numRegs,
                        (int)attr.localSizeBytes, (int)attr.sharedSizeBytes};
    for (int i = 0; i < 6; ++i) out[i] = vals[i];
    return 0;
}

extern "C" const char* dspeed_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
