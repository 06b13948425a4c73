// The bi-level zero-crossing trigger's sweep for Hopper (sm_90a): one thread
// per event.
//
// Replaces the `lax.scan` of dspeed_tpu/processors/time_point_thresh.py:400
// (`bi_level_zero_crossing_time_points`, unroll 8), which is not a Pallas
// kernel: the trigger is a five-flag state machine along the row (the
// threshold crossings' activation samples `above` and `below`, the
// zero-crossed flag, the two zero-crossing candidates and the count), so the
// JAX package scans it over sample pairs, batched over the events. Here one
// thread carries that state in registers for one row and walks its sample
// pairs (w[i], w[i+1]) in order from i = 0, with each update in the JAX
// step's order:
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
// 0/1 and sample indices) equal the plain version (_cuda.bilevel_scan_plain)
// bit for bit. A row's NaN, its start's rule and the uint32 count are the
// processor's (processors/time_point_thresh.py), around the sweep.
//
// What bounds it on this card: the bytes. 16384 rows of 4096 float32 samples
// are 268 MB read once, 0.080 ms at 3.35 TB/s; the slots and counts written
// are 1 MB at m = 8. A row's chain of compares is some 4096 steps, and every
// row is in flight at once. A block holds 32 rows: lane r of warp 0 walks row
// r, while all four warps stage the rows through shared memory in tiles of
// BL_TILE samples, 16 bytes a copy (cp.async) where the rows allow it, the
// next tile in flight while warp 0 walks the current one, as recurrence.cu
// stages its rows. A staged row's pitch puts 8 lanes' 16-byte reads on
// distinct banks. The m slots of each row live in shared memory (NaN until
// written) and are stored once, by the whole block, at the end.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BL_ROWS 32
#define BL_THREADS 128
#define BL_TILE 64
#define BL_MAX_SMEM 232448

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
__host__ __device__ constexpr int bl_pitch() {
    return sizeof(T) == 4 ? BL_TILE + 4 : BL_TILE + 2;
}

template <typename T>
__host__ __device__ constexpr int bl_vec() {
    return 16 / (int)sizeof(T);
}

__device__ __forceinline__ void bl_cp_async16(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
                 : "memory");
}

template <typename T>
__device__ __forceinline__ void bl_cp_async(T* dst, const T* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if (sizeof(T) == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
                     : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
                     : "memory");
}

__device__ __forceinline__ void bl_cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies tile t of the block's rows into buf (row r at buf[r * pitch]): 16
// bytes a copy with `vec`, else one sample.
template <typename T>
__device__ __forceinline__ void bl_load_tile(const BilevelParams& P, T* buf,
                                             long long r0, int rows, int t,
                                             bool vec) {
    constexpr int PITCH = bl_pitch<T>(), V = bl_vec<T>();
    const int a = t * BL_TILE, len = min(BL_TILE, P.n - a);
    const T* w = (const T*)P.w + r0 * P.stride + a;
    if (vec) {
        const int cpr = len / V;
        for (int q = threadIdx.x; q < rows * cpr; q += BL_THREADS) {
            const int r = q / cpr, c = q - r * cpr;
            bl_cp_async16(buf + r * PITCH + c * V, w + r * P.stride + c * V);
        }
    } else {
        for (int q = threadIdx.x; q < rows * BL_TILE; q += BL_THREADS) {
            const int r = q / BL_TILE, j = q % BL_TILE;
            if (j < len) bl_cp_async(buf + r * PITCH + j, w + r * P.stride + j);
        }
    }
}

// One row's trigger state and its slots (spol, strig: m each, in shared
// memory).
template <typename T>
struct Trigger {
    T pos, neg;
    int gate, start, m;
    int above, below, pos_cand, neg_cand, nc;
    bool crossed;
    T* spol;
    T* strig;

    __device__ __forceinline__ void emit(T polarity, int cand) {
        if (nc < m) {
            spol[nc] = polarity;
            strig[nc] = (T)cand;
        }
        ++nc;
    }

    // The step of the sample pair (w0, w1) = (w[i], w[i+1]).
    __device__ __forceinline__ void step(int i, T w0, T w1) {
        if (i < start) return;
        const T zero = (T)0;
        const bool below_on = below >= 0;
        if (below_on && w0 <= zero && zero < w1) {
            crossed = true;
            neg_cand = i;
        }
        if (w0 <= pos && pos < w1) {
            if (crossed && below_on) {
                if (i - below < gate) emit((T)0, neg_cand);
                else above = i;
                below = -1;
            } else {
                above = i;
            }
            if (below_on) crossed = false;
        }
        const bool above_on = above >= 0;
        if (above_on && w0 >= zero && zero > w1) {
            crossed = true;
            pos_cand = i;
        }
        if (w0 >= neg && neg > w1) {
            if (crossed && above_on) {
                if (i - above < gate) emit((T)1, pos_cand);
                else below = i;
                above = -1;
            } else {
                below = i;
            }
            if (above_on) crossed = false;
        }
    }
};

__device__ __forceinline__ void bl_ld16(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
}

__device__ __forceinline__ void bl_ld16(const double* p, double (&v)[2]) {
    const double2 q = *reinterpret_cast<const double2*>(p);
    v[0] = q.x;
    v[1] = q.y;
}

// Shared memory: the two tile buffers, then each row's m polarity slots and
// m trigger slots.
template <typename T>
__host__ __device__ inline size_t bl_smem(int m) {
    return (size_t)(2 * BL_ROWS * bl_pitch<T>() + 2 * BL_ROWS * m) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(BL_THREADS)
bilevel_scan_kernel(const BilevelParams P, int vec) {
    constexpr int PITCH = bl_pitch<T>(), V = bl_vec<T>();
    extern __shared__ __align__(16) unsigned char bl_smem_raw[];
    T* bufs = reinterpret_cast<T*>(bl_smem_raw);
    T* spol = bufs + 2 * BL_ROWS * PITCH;
    T* strig = spol + BL_ROWS * P.m;
    const long long r0 = (long long)blockIdx.x * BL_ROWS;
    const int rows = (int)min((long long)BL_ROWS, (long long)P.B - r0);
    const int tid = threadIdx.x;
    const bool live = tid < rows;  // lanes of warp 0 only
    const long long row = r0 + tid;

    const T qnan = (T)NAN;
    for (int q = tid; q < rows * P.m; q += BL_THREADS) {
        spol[q] = qnan;
        strig[q] = qnan;
    }
    Trigger<T> s;
    s.m = P.m;
    s.above = s.below = -1;
    s.pos_cand = s.neg_cand = s.nc = 0;
    s.crossed = false;
    s.spol = spol + tid * P.m;
    s.strig = strig + tid * P.m;
    if (live) {
        s.pos = ((const T*)P.pos)[row];
        s.neg = ((const T*)P.neg)[row];
        s.gate = P.gate[row];
        s.start = P.start[row];
    }

    const int n_tiles = (P.n + BL_TILE - 1) / BL_TILE;
    T prev = (T)0;  // w[i] of the next pair
    bl_load_tile<T>(P, bufs, r0, rows, 0, vec);
    for (int t = 0; t < n_tiles; ++t) {
        const T* buf = bufs + (t & 1) * BL_ROWS * PITCH;
        bl_cp_async_wait_all();
        __syncthreads();
        if (t + 1 < n_tiles)
            bl_load_tile<T>(P, bufs + ((t + 1) & 1) * BL_ROWS * PITCH, r0, rows,
                            t + 1, vec);
        if (live) {
            const int a = t * BL_TILE, len = min(BL_TILE, P.n - a);
            const T* x = buf + tid * PITCH;
            if (len % V == 0) {
                for (int q0 = 0; q0 < len; q0 += V) {
                    T v[V];
                    bl_ld16(x + q0, v);
#pragma unroll
                    for (int k = 0; k < V; ++k) {
                        const int j = a + q0 + k;
                        if (j > 0) s.step(j - 1, prev, v[k]);
                        prev = v[k];
                    }
                }
            } else {
                for (int q = 0; q < len; ++q) {
                    const int j = a + q;
                    const T cur = x[q];
                    if (j > 0) s.step(j - 1, prev, cur);
                    prev = cur;
                }
            }
        }
        // tile t + 2 refills this buffer only after the next tile's barrier,
        // which warp 0 reaches when it has walked this one
    }
    if (live) P.nc[row] = s.nc;
    __syncthreads();
    T* gpol = (T*)P.pol + r0 * P.m;
    T* gtrig = (T*)P.trig + r0 * P.m;
    for (int q = tid; q < rows * P.m; q += BL_THREADS) {
        gpol[q] = spol[q];
        gtrig[q] = strig[q];
    }
}

// 16-byte copies where every row and the pointer allow them.
template <typename T>
static int bl_vec_ok(const BilevelParams* p) {
    const int V = bl_vec<T>();
    return p->n % V == 0 && p->stride % V == 0 && ((uintptr_t)p->w & 15) == 0;
}

template <typename T>
static cudaError_t bl_launch(const BilevelParams* p, cudaStream_t st) {
    const size_t smem = bl_smem<T>(p->m);
    const auto fn = bilevel_scan_kernel<T>;
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int blocks = (p->B + BL_ROWS - 1) / BL_ROWS;
    fn<<<blocks, BL_THREADS, smem, st>>>(*p, bl_vec_ok<T>(p));
    return cudaGetLastError();
}

extern "C" int dspeed_bilevel_scan(const BilevelParams* p, void* stream) {
    if (p->B == 0 || p->n == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    return (int)(p->f64 ? bl_launch<double>(p, st) : bl_launch<float>(p, st));
}

// The most slots a row that a block's shared memory holds (float64 rows
// with f64).
extern "C" int dspeed_bilevel_scan_max_slots(int f64) {
    const size_t tiles = f64 ? bl_smem<double>(0) : bl_smem<float>(0);
    const size_t per = 2 * BL_ROWS * (f64 ? sizeof(double) : sizeof(float));
    return (int)((BL_MAX_SMEM - tiles) / per);
}

// How the float32 instance launches at m slots: rows and threads a block,
// blocks per SM, registers and local (spill) bytes a thread, shared bytes.
extern "C" int dspeed_bilevel_scan_config(int m, int* out) {
    const auto fn = bilevel_scan_kernel<float>;
    const int smem = (int)bl_smem<float>(m);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, BL_THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, fn)) != cudaSuccess) return (int)err;
    const int vals[] = {BL_ROWS, BL_THREADS, per_sm, attr.numRegs,
                        (int)attr.localSizeBytes, smem};
    for (int i = 0; i < 6; ++i) out[i] = vals[i];
    return 0;
}

extern "C" const char* dspeed_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
