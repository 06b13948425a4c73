// Linear recurrences along a row for Hopper (sm_90a): one thread per row.
//
// Replaces four scans of the JAX package, none of them a Pallas kernel:
// `_numerics.iir_first_order` (dspeed_tpu/processors/_numerics.py:250, a
// blocked triangular matmul), `rc_cr2._one_pole_scan` (rc_cr2.py:39),
// `recursive_filter.iir_companion` (recursive_filter.py:41, an
// associative_scan of companion matrices) and `_spline.affine_recurrence`
// (_spline.py:27). Each row's state is carried in float64 by one thread,
// which walks the row's samples in order, as the reference's loops do:
//   order 1:  y[i] = m * y[i-1] + u[i]      m a constant, per row, or per
//                                           position; forward or reverse
//   order d:  y[i] = u[i] - sum_k c[k] * y[i-1-k]   c shared or per row
// with y[-1 .. -d] per row (zero without). Each product and each sum is
// rounded once in float64 (__dmul_rn, __dadd_rn, __dsub_rn: no
// contraction), in the order of the plain version (_cuda.recurrence_plain),
// which this kernel equals bit for bit; the row is read in float32 or
// float64 and written in its own type.
//
// What bounds it on this card: the bytes. 16384 rows of 4096 float32
// samples in and out are 537 MB, 0.160 ms at 3.35 TB/s; a row's serial
// chain (a product and a sum a sample) is some 65,000 cycles, and every
// row is in flight at once. A block holds 32 rows: lane r of warp 0 walks
// row r, while all four warps stage the rows through shared memory in tiles
// of RC_TILE samples, 16 bytes a copy (cp.async in, vector stores out) where
// the rows allow it, the next tile in flight while warp 0 walks the
// current one. A staged row's pitch puts 8 lanes' 16-byte accesses on
// distinct banks, so warp 0 reads and writes its samples 16 bytes at a time.
// Order d <= RC_REG_D keeps its history in registers; a longer one keeps a
// ring of d doubles a row in shared memory, or (past RC_SMEM_D) in the
// scratch the caller passes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define RC_ROWS 32
#define RC_THREADS 128
#define RC_TILE 64
#define RC_REG_D 8
#define RC_SMEM_D 512

// Mirrored field for field by ctypes in processors/_cuda.py.
struct RecParams {
    const void* u;        // (B, n) rows, float32 or float64
    long long u_stride;   // in samples
    void* y;              // (B, n) contiguous, u's type
    const double* m;      // order 1: (B,) or (n,) multipliers, or null
    double m_const;       // order 1 without m
    const double* c;      // order d: (d,) or (B, d) coefficients
    const double* y0;     // (B, d): y[-1], ..., y[-d]; null for zeros
    double* ring;         // order d > RC_SMEM_D: (B, d) scratch
    int B, n, order, m_kind, c_per_row, reverse, f64;
};

enum { M_CONST = 0, M_ROW = 1, M_POS = 2 };

// A staged row's pitch in elements: 8 lanes' 16-byte accesses at row
// offsets r * pitch fall on distinct banks (pitch * size = 16 mod 128).
template <typename T>
__host__ __device__ constexpr int rc_pitch() {
    return sizeof(T) == 4 ? RC_TILE + 4 : RC_TILE + 2;
}

// Elements a 16-byte vector holds.
template <typename T>
__host__ __device__ constexpr int rc_vec() {
    return 16 / (int)sizeof(T);
}

template <typename T>
__device__ __forceinline__ void rc_cp_async(T* dst, const T* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if (sizeof(T) == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
                     : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
                     : "memory");
}

__device__ __forceinline__ void rc_cp_async16(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void rc_cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The samples [a, a + len) of tile t: tiles run from the row's start, or
// with `reverse` from its end.
__device__ __forceinline__ void tile_span(int n, int t, int reverse, int& a,
                                          int& len) {
    if (reverse) {
        const int hi = n - t * RC_TILE;
        a = max(0, hi - RC_TILE);
        len = hi - a;
    } else {
        a = t * RC_TILE;
        len = min(RC_TILE, n - a);
    }
}

// 16 bytes of staged samples into registers and back, as float4 or double2
// (a vector of the samples' own type keeps v out of local memory).
__device__ __forceinline__ void rc_ld16(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
}

__device__ __forceinline__ void rc_ld16(const double* p, double (&v)[2]) {
    const double2 q = *reinterpret_cast<const double2*>(p);
    v[0] = q.x;
    v[1] = q.y;
}

__device__ __forceinline__ void rc_st16(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void rc_st16(double* p, const double (&v)[2]) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// Copies tile t of the block's rows into buf (row r at buf[r * pitch]): 16
// bytes a copy with `vec`, else one sample.
template <typename T>
__device__ __forceinline__ void load_tile(const RecParams& P, T* buf, long long r0,
                                          int rows, int t, bool vec) {
    constexpr int PITCH = rc_pitch<T>(), V = rc_vec<T>();
    int a, len;
    tile_span(P.n, t, P.reverse, a, len);
    const T* u = (const T*)P.u + r0 * P.u_stride + a;
    if (vec) {
        const int cpr = len / V;
        for (int q = threadIdx.x; q < rows * cpr; q += RC_THREADS) {
            const int r = q / cpr, c = q - r * cpr;
            rc_cp_async16(buf + r * PITCH + c * V, u + r * P.u_stride + c * V);
        }
    } else {
        for (int q = threadIdx.x; q < rows * RC_TILE; q += RC_THREADS) {
            const int r = q / RC_TILE, j = q % RC_TILE;
            if (j < len) rc_cp_async(buf + r * PITCH + j, u + r * P.u_stride + j);
        }
    }
}

template <typename T>
__device__ __forceinline__ void store_tile(const RecParams& P, const T* buf,
                                           long long r0, int rows, int t, bool vec) {
    constexpr int PITCH = rc_pitch<T>(), V = rc_vec<T>();
    int a, len;
    tile_span(P.n, t, P.reverse, a, len);
    T* y = (T*)P.y + r0 * (long long)P.n + a;
    if (vec) {
        const int cpr = len / V;
        for (int q = threadIdx.x; q < rows * cpr; q += RC_THREADS) {
            const int r = q / cpr, c = q - r * cpr;
            *reinterpret_cast<float4*>(y + r * (long long)P.n + c * V) =
                *reinterpret_cast<const float4*>(buf + r * PITCH + c * V);
        }
    } else {
        for (int q = threadIdx.x; q < rows * RC_TILE; q += RC_THREADS) {
            const int r = q / RC_TILE, j = q % RC_TILE;
            if (j < len) y[r * (long long)P.n + j] = buf[r * PITCH + j];
        }
    }
}

// One row's state: order 1 (D = 1, `first`), order D in registers (D <=
// RC_REG_D), or (D = 0) order d in a ring of doubles.
template <int D>
struct State {
    double h[D > 0 ? D : 1];  // h[k] = y[i-1-k]
    double c[D > 0 ? D : 1];
};

template <int D, bool first>
struct Walker {
    State<D> s;
    double m;
    double* ring;
    const double* cr;
    int head, d;

    // y at position i (of the row) from input u.
    __device__ __forceinline__ double step(const RecParams& P, int i, double u) {
        double v;
        if (first) {
            const double mi = P.m_kind == M_POS ? P.m[i] : m;
            v = __dadd_rn(__dmul_rn(mi, s.h[0]), u);
            s.h[0] = v;
        } else if (D > 0) {
            v = u;
#pragma unroll
            for (int k = 0; k < (D > 0 ? D : 1); ++k)
                v = __dsub_rn(v, __dmul_rn(s.c[k], s.h[k]));
#pragma unroll
            for (int k = (D > 0 ? D : 1) - 1; k > 0; --k) s.h[k] = s.h[k - 1];
            s.h[0] = v;
        } else {
            v = u;
            for (int k = 0; k < d; ++k) {
                const int e = head + k < d ? head + k : head + k - d;
                v = __dsub_rn(v, __dmul_rn(cr[k], ring[e]));
            }
            head = head == 0 ? d - 1 : head - 1;
            ring[head] = v;
        }
        return v;
    }
};

// The block's rows, tile by tile; lane r of warp 0 walks row r0 + r. D =
// 1 with `first`: order 1; D >= 1: order D in registers; D = 0: order
// P.order through a ring.
template <typename T, int D, bool first>
__global__ void __launch_bounds__(RC_THREADS)
recurrence_kernel(const RecParams P, int vec) {
    constexpr int PITCH = rc_pitch<T>(), V = rc_vec<T>();
    extern __shared__ __align__(16) unsigned char rc_smem[];
    T* bufs = reinterpret_cast<T*>(rc_smem);
    const long long r0 = (long long)blockIdx.x * RC_ROWS;
    const int rows = (int)min((long long)RC_ROWS, P.B - r0);
    const int tid = threadIdx.x;
    const bool live = tid < rows;  // lanes of warp 0 only
    const long long row = r0 + tid;

    Walker<D, first> w;
    w.d = first ? 1 : (D > 0 ? D : P.order);
    w.m = P.m_const;
    w.ring = nullptr;
    w.cr = nullptr;
    w.head = 0;
    if (live) {
        const int d = w.d;
        if (first && P.m_kind == M_ROW) w.m = P.m[row];
        if (D == 0 && !first) {
            w.ring = P.ring ? P.ring + row * d
                            : reinterpret_cast<double*>(
                                  rc_smem + 2 * RC_ROWS * PITCH * sizeof(T)) +
                                  tid * d;
            for (int k = 0; k < d; ++k) w.ring[k] = P.y0 ? P.y0[row * d + k] : 0.0;
            w.cr = P.c + (P.c_per_row ? row * d : 0);
        } else {
#pragma unroll
            for (int k = 0; k < (D > 0 ? D : 1); ++k) {
                w.s.h[k] = P.y0 ? P.y0[row * d + k] : 0.0;
                if (!first) w.s.c[k] = P.c[(P.c_per_row ? row * d : 0) + k];
            }
        }
    }

    const int n_tiles = (P.n + RC_TILE - 1) / RC_TILE;
    load_tile<T>(P, bufs, r0, rows, 0, vec);
    for (int t = 0; t < n_tiles; ++t) {
        T* buf = bufs + (t & 1) * RC_ROWS * PITCH;
        rc_cp_async_wait_all();
        __syncthreads();
        if (t + 1 < n_tiles)
            load_tile<T>(P, bufs + ((t + 1) & 1) * RC_ROWS * PITCH, r0, rows, t + 1, vec);
        if (live) {
            int a, len;
            tile_span(P.n, t, P.reverse, a, len);
            T* x = buf + tid * PITCH;
            if (len % V == 0) {
                // 16 bytes at a time, each vector's samples in the walk's order
                // (constant indices into v, which keeps it in registers)
                for (int q0 = 0; q0 < len; q0 += V) {
                    const int j0 = P.reverse ? len - V - q0 : q0;
                    T v[V];
                    rc_ld16(x + j0, v);
                    if (P.reverse) {
#pragma unroll
                        for (int k = V - 1; k >= 0; --k)
                            v[k] = (T)w.step(P, a + j0 + k, (double)v[k]);
                    } else {
#pragma unroll
                        for (int k = 0; k < V; ++k)
                            v[k] = (T)w.step(P, a + j0 + k, (double)v[k]);
                    }
                    rc_st16(x + j0, v);
                }
            } else {
                for (int q = 0; q < len; ++q) {
                    const int j = P.reverse ? len - 1 - q : q;
                    x[j] = (T)w.step(P, a + j, (double)x[j]);
                }
            }
        }
        __syncthreads();
        store_tile<T>(P, buf, r0, rows, t, vec);
    }
}

template <typename T>
static size_t rc_smem(const RecParams* p) {
    size_t b = 2 * RC_ROWS * rc_pitch<T>() * sizeof(T);
    if (p->c && p->order > RC_REG_D && !p->ring) b += (size_t)RC_ROWS * p->order * sizeof(double);
    return b;
}

// 16-byte copies where every row, tile and pointer allows them.
template <typename T>
static int rc_vec_ok(const RecParams* p) {
    const int V = rc_vec<T>();
    return p->n % V == 0 && p->u_stride % V == 0 &&
           ((uintptr_t)p->u & 15) == 0 && ((uintptr_t)p->y & 15) == 0;
}

template <typename T, int D, bool first>
static cudaError_t rc_go(const RecParams* p, cudaStream_t st) {
    const size_t smem = rc_smem<T>(p);
    const auto fn = recurrence_kernel<T, D, first>;
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int blocks = (p->B + RC_ROWS - 1) / RC_ROWS;
    fn<<<blocks, RC_THREADS, smem, st>>>(*p, rc_vec_ok<T>(p));
    return cudaGetLastError();
}

template <typename T>
static cudaError_t rc_launch(const RecParams* p, cudaStream_t st) {
    if (p->c == nullptr) return rc_go<T, 1, true>(p, st);
    switch (p->order) {
    case 1: return rc_go<T, 1, false>(p, st);
    case 2: return rc_go<T, 2, false>(p, st);
    case 3: return rc_go<T, 3, false>(p, st);
    case 4: return rc_go<T, 4, false>(p, st);
    case 5: return rc_go<T, 5, false>(p, st);
    case 6: return rc_go<T, 6, false>(p, st);
    case 7: return rc_go<T, 7, false>(p, st);
    case 8: return rc_go<T, 8, false>(p, st);
    default: return rc_go<T, 0, false>(p, st);
    }
}

// Without c the first-order mode (order 1); with c the order-d mode.
extern "C" int dspeed_recurrence(const RecParams* p, void* stream) {
    if (p->B == 0 || p->n == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    return (int)(p->f64 ? rc_launch<double>(p, st) : rc_launch<float>(p, st));
}

// The order beyond which the ring lives in the caller's scratch.
extern "C" int dspeed_recurrence_smem_order() { return RC_SMEM_D; }

// How the float32 first-order instance launches: rows a block, blocks per
// SM, registers and local (spill) bytes a thread, shared bytes, threads a
// block.
extern "C" int dspeed_recurrence_config(int* out) {
    const auto fn = recurrence_kernel<float, 1, true>;
    const int smem = 2 * RC_ROWS * rc_pitch<float>() * (int)sizeof(float);
    int per_sm;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                                    RC_THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, fn)) != cudaSuccess) return (int)err;
    const int vals[] = {RC_ROWS, per_sm, attr.numRegs, (int)attr.localSizeBytes, smem,
                        RC_THREADS};
    for (int i = 0; i < 6; ++i) out[i] = vals[i];
    return 0;
}

extern "C" const char* dspeed_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
