// Generic row-tile fusion (K7) for Hopper (sm_90a): a row-tape interpreter.
//
// Replaces the TPU kernel `generic_rows` (dspeed_tpu/processors/_pallas.py
// :1782, its pallas_call at :2009), which traces a fusion group's member
// bodies into one Pallas program over row tiles. Here the host lowers the
// group into a tape (processors/_tile_program.py): per-row slots (planes in
// shared memory, scalars), and ops, each an opcode with operand and output
// slots and static parameters. One block of 256 threads runs the whole tape
// for one event row: each external plane is loaded once (just before its
// first reader), every internal plane stays in shared memory, and each
// escaping output goes to device memory from the registers that computed
// it. Each op is its member kernel's arithmetic, in the same order as the
// block-per-op kernel this one replaced, so every output is that kernel's
// bit for bit (on a row with an infinite sample the trapezoids follow the
// plain version instead, see below):
//   min_max, amax, linear_slope_fit  first-occurrence extrema and float64
//                                    sums with the same shuffle trees
//   pole_zero, trap_norm,            float64 prefixes with row_prefix.cuh's
//   asym_trap_filter,                runs (scan_run) and scan tree; windows
//   moving_window_multi              of <= 32 samples summed directly
//   convolve_wf (banded route)       conv_tile.cuh's register-tiled loop, in
//                                    conv_row.cuh's order (K3's and K4's)
//   reflected_convolve_wf (m <= 32)  each output from the row's own samples
//                                    through the reflect index map, summed in
//                                    the plain version's order, unfused, in
//                                    float32 or (float64 taps) float64
//   time_point_thresh                K2's warp search: 32 positions a
//                                    ballot, GEN_WIN ballots a step
//   windower, avg_current            a gather, __fsub_rn and __fdiv_rn
//   fixed_time_pickoff 'l' / 'i'     a per-row gather
//   add, multiply, divide, convert,  per-row scalar arithmetic with _rn
//   convert_round                    intrinsics, rounded to the slot's type
// A row with a NaN poisons what each member poisons, op by op.
//
// What bounds it on this card: bytes for most groups. The flagship's first
// generic group reads one 4096-sample f32 row and writes three planes (16 KB
// each) plus a 300-sample current and scalars: about 66 KB per row, 1.09 GB
// per 16384 rows, 0.33 ms at 3.35 TB/s; its 133-tap convolution is 0.27 ms of
// f32 FMAs. The second reads three planes (4784 + 2 x 4096 samples) and
// writes scalars: 0.25 ms.
//
// How the design meets it:
// - Barriers where the host's plan asks for them. `_tile_program._plan`
//   sets bit 0 of ip[4] on an op that reads a slot, or overwrites arena or
//   scratch space, that other threads wrote or read since the last barrier
//   (an op's own internal barriers count). The searches and the scalar ops
//   (time_point_thresh, fixed_time_pickoff, ufunc, convert) run on warp 0
//   alone, back to back with a __syncwarp between them; the other warps go
//   on to the next op or wait at the next planned barrier.
// - NaN and infinity flags set where a plane is written: every op that
//   writes a plane ORs a warp's __reduce_or_sync of its samples' bits into
//   its root slot's flag word. A slice of a plane whose root holds one is
//   scanned by its reader (rare: NaN rows). A trapezoid over a plane that
//   holds an infinity takes its short windows from the prefix, as the plain
//   version does.
// - Float64 prefixes without bank conflicts: each thread keeps its run of
//   scan_run's samples in registers (16-byte loads where the run is 16
//   samples, a quarter warp's lanes rotated onto distinct banks; the moving
//   window, whose stages would spill them, reads its runs twice), the runs
//   are scanned with block_excl_scan's tree behind one barrier (every thread
//   replays warp 0's steps over the 8 warp totals), and the prefix is
//   stored with one pad double after every 16 where the runs are of an even
//   length (ps index p at p + p / 16), so that a half warp's stores of its
//   runs fall on distinct banks (odd runs do without the pad).
// - Reductions behind one barrier: warps reduce with the shuffle trees of
//   block_reduce.cuh, their results meet in one of two alternating buffers,
//   and the threads that need the block's value replay warp 0's tree.
// - The convolution on conv_tile.cuh: 8 consecutive outputs a thread while
//   a whole tile of them fits, then 4, from a zero-padded window in the
//   scratch (12 a thread needed more than the 80 registers that three
//   blocks an SM allow, and was slower).
// - Divisions by a window length from its reciprocal and one exact FMA
//   correction (div_by), three float64 operations instead of a division.
// - Loads by cp.async, 16 bytes a lane, every copy of a row in flight at
//   once; the escapes stored with 16-byte stores where the row allows.
// One row per block, up to 3 blocks an SM (the plan's shared memory decides).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_reduce.cuh"
#include "conv_tile.cuh"
#include "row_prefix.cuh"

#define GEN_THREADS 256
#define GEN_WARPS (GEN_THREADS / 32)
#define GEN_MIN_BLOCKS 3  // blocks an SM that the registers must allow
#define GEN_R 8           // convolution outputs a thread in a whole tile
#define GEN_R_TAIL 4      // and in the tiles after the whole ones
#define GEN_RUN 16        // prefix runs kept in registers up to this length
#define GEN_WIN 4         // a search step's 32-position windows
#define GEN_MAX_EXT 32
#define GEN_MAX_ESC 64
#define GEN_MAX_CODE 3072  // tape ints the kernel's parameters hold
#define GEN_MAX_DP 512     // and tape doubles

// The tape's record layout, as processors/_tile_program.py writes it.
#define OP_IN 6
#define OP_OUT 4
#define OP_IP 8
#define OP_DP 4
#define OP_INTS (1 + OP_IN + OP_OUT + OP_IP)
#define SLOT_INTS 8
#define IP_PLAN 4  // ip[4]: bit 0, a block barrier before the op
enum { S_KIND, S_F64, S_OFF, S_LEN, S_SIDX, S_EXT, S_ESC, S_ROOT };
enum {
    OP_LOAD = 1, OP_MIN_MAX, OP_BL_SUB, OP_SLOPE_FIT, OP_POLE_ZERO, OP_TRAP,
    OP_AMAX, OP_CONV, OP_TPT, OP_WINDOWER, OP_AVG_CURRENT, OP_MW_MULTI,
    OP_FTP, OP_UFUNC, OP_CONVERT, OP_REFL_CONV
};

// Mirrored field for field by ctypes in processors/_cuda.py. The tape rides
// in the kernel's parameters; each block copies it into its shared memory
// first, so that the chain of reads that decodes an op (its record, then
// its slots' records) waits on shared memory, not on the constant cache.
struct GenParams {
    const float* taps;   // every convolution's taps, concatenated
    int B;
    int n_ops;
    int n_slots;
    int n_scal;
    int scratch_dbl;
    int arena_floats;
    int tape_dbl;  // where the tape's copy starts in shared memory (doubles)
    int n_dpar;    // the tape's doubles
    int n_code;    // and ints
    const void* ext[GEN_MAX_EXT];  // external inputs: (B, n) f32 or (B,)
    long long ext_stride[GEN_MAX_EXT];  // row stride of an external plane
    void* esc[GEN_MAX_ESC];  // stored roots: (B, n) f32 or (B,) f32/f64
    double dpar[GEN_MAX_DP];  // OP_DP per op: static parameters, constants
    int code[GEN_MAX_CODE];   // ops (OP_INTS each), then slots (SLOT_INTS each)
};

// Shared memory: the per-row scalars, the scratch, the arena of planes, the
// planes' NaN flags and the tape's copy (the host's plan sizes each); two
// alternating buffers for the block reductions. A reduction writes its
// buffer before its barrier and reads it after; after its last barrier an
// op reads only the buffer it took last (_tile_program's
// LATE_REDUCTION_READS). The next reduction takes the other buffer, and
// the one after it writes this one only past the next one's barrier, so
// the plan needs no barrier for them.
extern __shared__ __align__(16) double gen_smem[];
__shared__ double gen_red[2][2 * GEN_WARPS];
__shared__ float gen_redf[2][2 * GEN_WARPS];
__shared__ int gen_redi[2][2 * GEN_WARPS];

// One row's state: the row, and the reduction buffer the next reduction
// takes (the same in every thread: every thread runs every block-wide op).
struct Row {
    long long row;
    int rb;
};

// The tape's copy in shared memory: its doubles, then its ints.
__device__ __forceinline__ const double* tape_dp(const GenParams& P) {
    return gen_smem + P.tape_dbl;
}

__device__ __forceinline__ const int* tape(const GenParams& P) {
    return reinterpret_cast<const int*>(gen_smem + P.tape_dbl + P.n_dpar);
}

// Field f of slot s.
__device__ __forceinline__ int sf(const GenParams& P, int s, int f) {
    return tape(P)[P.n_ops * OP_INTS + s * SLOT_INTS + f];
}

__device__ __forceinline__ double* scratch_of(const GenParams& P) {
    return gen_smem + P.n_scal;
}

__device__ __forceinline__ float* arena_of(const GenParams& P) {
    return reinterpret_cast<float*>(gen_smem + P.n_scal + P.scratch_dbl);
}

__device__ __forceinline__ int* nanf_of(const GenParams& P) {
    return reinterpret_cast<int*>(arena_of(P) + P.arena_floats);
}

__device__ __forceinline__ float* plane(const GenParams& P, int s) {
    return arena_of(P) + sf(P, s, S_OFF);
}

__device__ __forceinline__ int plen(const GenParams& P, int s) {
    return sf(P, s, S_LEN);
}

// Where the stored copy of output slot s's row starts, or null.
__device__ __forceinline__ float* esc_plane(const GenParams& P, const Row& R,
                                            int s) {
    const int e = sf(P, s, S_ESC);
    if (e < 0) return nullptr;
    return (float*)P.esc[e] + R.row * (long long)sf(P, s, S_LEN);
}

// The same for a float64 plane (S_F64 set: reflected_convolve_wf with
// float64 taps, avg_current over its output), which spans two words a
// sample of the arena and has no slices.
__device__ __forceinline__ double* plane64(const GenParams& P, int s) {
    return reinterpret_cast<double*>(plane(P, s));
}

__device__ __forceinline__ double* esc_plane64(const GenParams& P, const Row& R,
                                               int s) {
    const int e = sf(P, s, S_ESC);
    if (e < 0) return nullptr;
    return (double*)P.esc[e] + R.row * (long long)sf(P, s, S_LEN);
}

// Scalar operand k of op `o`: a slot, or a constant of the op's dp (in[k]
// = -1 - j); bit k of `cast` rounds it to float32, its argument type.
__device__ __forceinline__ double operand(const GenParams& P, int o, int k,
                                          int cast) {
    const int s = tape(P)[o * OP_INTS + 1 + k];
    double v = s >= 0 ? gen_smem[sf(P, s, S_SIDX)] : tape_dp(P)[o * OP_DP - 1 - s];
    if ((cast >> k) & 1) v = (double)(float)v;
    return v;
}

// Thread 0 stores v, rounded to the slot's type, and its escape.
__device__ __forceinline__ void put(const GenParams& P, const Row& R, int s,
                                    double v) {
    const int f64 = sf(P, s, S_F64), e = sf(P, s, S_ESC);
    if (!f64) v = (double)(float)v;
    gen_smem[sf(P, s, S_SIDX)] = v;
    if (e >= 0) {
        if (f64) ((double*)P.esc[e])[R.row] = v;
        else ((float*)P.esc[e])[R.row] = (float)v;
    }
}

// A sample's bits of a plane's flag word: 1 for a NaN, 2 for an infinity.
#define GEN_NAN 1
#define GEN_INF 2
__device__ __forceinline__ int nan_inf(float v) {
    return isnan(v) ? GEN_NAN : isinf(v) ? GEN_INF : 0;
}

__device__ __forceinline__ int nan_inf(double v) {
    return isnan(v) ? GEN_NAN : isinf(v) ? GEN_INF : 0;
}

__device__ __forceinline__ int nan_inf4(float4 v) {
    return nan_inf(v.x) | nan_inf(v.y) | nan_inf(v.z) | nan_inf(v.w);
}

// A writer's flag word: called by every thread of the writing warps with
// the bits of its own stores.
__device__ __forceinline__ void flag_plane(const GenParams& P, int s, int h) {
    const unsigned w = __reduce_or_sync(FULL_MASK, (unsigned)h);
    if (w && (threadIdx.x & 31) == 0)
        atomicOr(nanf_of(P) + sf(P, s, S_ROOT), (int)w);
}

// Whether plane slot s holds a sample of `bit` (GEN_NAN: the member's
// isnan_any row mask; GEN_INF). A slot that covers its root reads its
// root's flag word; a slice of a root that holds one is scanned, by the
// block (called by every thread) or by warp 0 alone (`warp`).
__device__ __forceinline__ bool plane_has(const GenParams& P, int s, int bit,
                                          bool warp) {
    const int r = sf(P, s, S_ROOT);
    if (!(nanf_of(P)[r] & bit)) return false;
    if (sf(P, s, S_OFF) == sf(P, r, S_OFF) && sf(P, s, S_LEN) == sf(P, r, S_LEN))
        return true;
    const float* x = plane(P, s);
    const int n = plen(P, s);
    int h = 0;
    if (warp) {
        for (int i = threadIdx.x; i < n; i += 32) h |= nan_inf(x[i]) & bit;
        return __any_sync(FULL_MASK, h) != 0;
    }
    for (int i = threadIdx.x; i < n; i += blockDim.x) h |= nan_inf(x[i]) & bit;
    return __syncthreads_or(h) != 0;
}

__device__ __forceinline__ bool plane_nan(const GenParams& P, int s,
                                          bool warp) {
    return plane_has(P, s, GEN_NAN, warp);
}

// ---------------------------------------------------------------------------
// reductions: block_reduce.cuh's trees, behind one barrier

// Warp 0's step of block_sum over the 8 warp totals v (lanes 8..31 hold
// 0.0), replayed by one thread: the block's sum with block_sum's bits.
__device__ __forceinline__ double replay_sum(const double* v) {
    double w[GEN_WARPS];
#pragma unroll
    for (int l = 0; l < GEN_WARPS; ++l) w[l] = (v[l] + 0.0) + 0.0;  // o = 16, 8
#pragma unroll
    for (int o = GEN_WARPS / 2; o > 0; o >>= 1)
#pragma unroll
        for (int l = 0; l < o; ++l) w[l] = w[l] + w[l + o];
    return w[0];
}

// block_max's step over the warp maxima (lanes 8..31 hold -inf, which
// fmaxf drops).
__device__ __forceinline__ float replay_max(const float* v) {
    float w[GEN_WARPS];
#pragma unroll
    for (int l = 0; l < GEN_WARPS; ++l) w[l] = v[l];
#pragma unroll
    for (int o = GEN_WARPS / 2; o > 0; o >>= 1)
#pragma unroll
        for (int l = 0; l < o; ++l) w[l] = fmaxf(w[l], w[l + o]);
    return w[0];
}

// block_excl_scan: the exclusive scan of one double per thread, in thread
// order, with its bits; one barrier. Called by every thread.
__device__ __forceinline__ double gen_excl_scan(Row& R, double v) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    double x = v;
    for (int o = 1; o < 32; o <<= 1) {
        const double y = __shfl_up_sync(FULL_MASK, x, o);
        if (lane >= o) x += y;
    }
    double excl = __shfl_up_sync(FULL_MASK, x, 1);
    if (lane == 0) excl = 0.0;
    double* red = gen_red[R.rb];
    R.rb ^= 1;
    if (lane == 31) red[wid] = x;
    __syncthreads();
    // warp 0's inclusive scan of the totals (lanes >= 8 do not reach 0..7)
    double t[GEN_WARPS];
#pragma unroll
    for (int l = 0; l < GEN_WARPS; ++l) t[l] = red[l];
#pragma unroll
    for (int o = 1; o < GEN_WARPS; o <<= 1)
#pragma unroll
        for (int l = GEN_WARPS - 1; l >= o; --l) t[l] += t[l - o];
    double before = 0.0;
#pragma unroll
    for (int l = 0; l < GEN_WARPS - 1; ++l)
        if (wid == l + 1) before = t[l];
    return (wid > 0 ? before : 0.0) + excl;
}

// ---------------------------------------------------------------------------
// float64 prefixes

// ps index of prefix sample p: one pad double after every 16 where the
// runs are of an even length (`pad` all ones), else p. A half warp's
// stores of its runs then fall on distinct bank pairs.
__device__ __forceinline__ int pidx(int p, int pad) {
    return p + ((p >> 4) & pad);
}

// The pad mask of a row of n samples (_tile_program._plan mirrors it).
__device__ __forceinline__ int prefix_pad(int n) {
    const int per = (n + blockDim.x - 1) / blockDim.x;
    return (per & 1) ? 0 : -1;
}

// This thread's run [j0, j1) of x (scan_run's), in registers: r[k] =
// x[j0 + k]. Runs of 16 samples starting on 16 bytes come as four 16-byte
// loads, lane t of a quarter warp starting at chunk (t / 2) % 4, so that
// the quarter warp's loads fall on 8 distinct groups of banks.
__device__ __forceinline__ void load_run(const float* x, int j0, int cnt,
                                         float (&r)[GEN_RUN]) {
    if (cnt == GEN_RUN && ((reinterpret_cast<uintptr_t>(x + j0) & 15) == 0)) {
        const float4* x4 = reinterpret_cast<const float4*>(x + j0);
        const int rot = (threadIdx.x >> 1) & 3;
        float4 v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = x4[(q + rot) & 3];
        // chunk c was loaded at step (c - rot) & 3
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const float4 a = rot == 0 ? v[c]
                           : rot == 1 ? v[(c + 3) & 3]
                           : rot == 2 ? v[(c + 2) & 3]
                                      : v[(c + 1) & 3];
            r[4 * c] = a.x;
            r[4 * c + 1] = a.y;
            r[4 * c + 2] = a.z;
            r[4 * c + 3] = a.w;
        }
        return;
    }
#pragma unroll
    for (int k = 0; k < GEN_RUN; ++k) r[k] = k < cnt ? x[j0 + k] : 0.f;
}

// The inclusive float64 prefix of x[0, n) into ps (padded), every value
// with block_inclusive_prefix's bits, each run read from shared memory
// twice; ends with a barrier, after which ps may be read.
__device__ __forceinline__ void gen_prefix_shared(Row& R, const float* x,
                                                  int n, double* ps, int pad) {
    int j0, j1;
    scan_run(n, j0, j1);
    double run = 0.0;
#pragma unroll 4
    for (int j = j0; j < j1; ++j) run += (double)x[j];
    double s = gen_excl_scan(R, run);
#pragma unroll 4
    for (int j = j0; j < j1; ++j) {
        s += (double)x[j];
        ps[pidx(j, pad)] = s;
    }
    __syncthreads();
}

// The same prefix, each run of up to GEN_RUN samples held in registers.
__device__ __forceinline__ void gen_prefix(Row& R, const float* x, int n,
                                           double* ps, int pad) {
    int j0, j1;
    scan_run(n, j0, j1);
    const int cnt = j1 - j0;
    // the same branch in every thread: the scan's shuffles need whole warps
    if ((n + GEN_THREADS - 1) / GEN_THREADS <= GEN_RUN) {
        float r[GEN_RUN];
        load_run(x, j0, cnt, r);
        double run = 0.0;
#pragma unroll
        for (int k = 0; k < GEN_RUN; ++k)
            if (k < cnt) run += (double)r[k];
        double s = gen_excl_scan(R, run);
#pragma unroll
        for (int k = 0; k < GEN_RUN; ++k)
            if (k < cnt) {
                s += (double)r[k];
                ps[pidx(j0 + k, pad)] = s;
            }
        __syncthreads();
    } else {
        gen_prefix_shared(R, x, n, ps, pad);
    }
}

// a / b, correctly rounded, from y = RN(1/b) (__drcp_rn): q = RN(a y) is
// within an ulp of a / b, the residual a - b q is exact by FMA, and
// RN(q + (a - b q) y) is then RN(a / b) (Markstein's theorem), wherever no
// step under- or overflows. Here b >= 1 is a window length and a a sum of
// float32 samples (zero, or at least 2^-149 in magnitude), so none does;
// a zero, infinite or NaN quotient is a y itself. Three float64 operations
// where a division takes about ten and a reciprocal.
__device__ __forceinline__ double div_by(double a, double b, double y) {
    const double q = __dmul_rn(a, y);
    if (q == 0.0 || !isfinite(q)) return q;
    return __fma_rn(__fma_rn(-b, q, a), y, q);
}

// row_prefix.cuh's win_sum and trap_at over the padded prefix, each
// division by a window length through div_by (yr, yf: the reciprocals of
// rise and fall). With `direct` a window of <= 32 samples is summed from
// the samples (K1's rule); without, every window is a prefix difference, as
// in the plain version, which a row holding an infinity takes: there a
// prefix difference beyond the infinity is inf - inf = NaN where a direct
// sum is finite.
__device__ __forceinline__ double gen_win_sum(const float* xs, const double* ps,
                                              int pad, bool direct, int i,
                                              int len, int off) {
    const int hi = i - off;
    const int lo = hi - len + 1;
    if (hi < 0) return 0.0;
    if (direct && len <= 32) {
        double acc = 0.0;
#pragma unroll 4
        for (int k = lo < 0 ? 0 : lo; k <= hi; ++k) acc += (double)xs[k];
        return acc;
    }
    return ps[pidx(hi, pad)] - (lo >= 1 ? ps[pidx(lo - 1, pad)] : 0.0);
}

__device__ __forceinline__ float gen_trap_at(const TrapSpec& t, const float* xs,
                                             const double* ps, int pad,
                                             bool direct, double yr, double yf,
                                             int i) {
    if (t.kind == 0) {
        const double d1 = gen_win_sum(xs, ps, pad, direct, i, t.rise, 0);
        const double d2 = gen_win_sum(xs, ps, pad, direct, i, t.rise,
                                      t.rise + t.flat);
        return (float)div_by(d1 - d2, (double)t.rise, yr);
    }
    const double d1 = gen_win_sum(xs, ps, pad, direct, i, t.rise, 0);
    const double d2 = gen_win_sum(xs, ps, pad, direct, i, t.fall,
                                  t.rise + t.flat);
    return (float)(div_by(d1, (double)t.rise, yr) - div_by(d2, (double)t.fall, yf));
}

// mw_cascade.cuh's moving-window value at i from the padded prefix, its
// divisions by L through div_by (yl: the reciprocal of L).
__device__ __forceinline__ float mw_at(const double* ps, int pad, int n,
                                       int L, bool right, double w0, double wl,
                                       double yl, int i) {
    const double lf = (double)L;
    double v;
    if (!right) {
        if (i < L)
            v = __dadd_rn(w0, div_by(__dsub_rn(ps[pidx(i, pad)],
                    __dmul_rn((double)(i + 1), w0)), lf, yl));
        else
            v = div_by(__dsub_rn(ps[pidx(i, pad)], ps[pidx(i - L, pad)]), lf, yl);
    } else {
        const double se = i > 0 ? ps[pidx(i - 1, pad)] : 0.0;
        if (i > n - 1 - L)
            v = __dadd_rn(wl, div_by(__dsub_rn(__dsub_rn(ps[pidx(n - 1, pad)], se),
                    __dmul_rn((double)(n - i), wl)), lf, yl));
        else
            v = div_by(__dsub_rn(ps[pidx(i + L - 1, pad)], se), lf, yl);
    }
    return (float)v;
}

// ---------------------------------------------------------------------------
// K2's warp searches (cascade_tp.cu), the same index in every lane

__device__ __forceinline__ int gen_search_fwd(const float* x, int n, int s,
                                              float a, int lane) {
    for (int b = s; b <= n - 2; b += 32 * GEN_WIN) {
        unsigned hit[GEN_WIN];
#pragma unroll
        for (int u = 0; u < GEN_WIN; ++u) {
            const int i = b + 32 * u + lane;
            hit[u] = __ballot_sync(FULL_MASK, i <= n - 2 && cross_fwd(x, i, a));
        }
#pragma unroll
        for (int u = 0; u < GEN_WIN; ++u)
            if (hit[u]) return b + 32 * u + __ffs(hit[u]) - 1;
    }
    return -1;
}

__device__ __forceinline__ int gen_search_bwd(const float* x, int s, float a,
                                              int lane) {
    for (int top = s; top >= 1; top -= 32 * GEN_WIN) {
        unsigned hit[GEN_WIN];
#pragma unroll
        for (int u = 0; u < GEN_WIN; ++u) {
            const int i = top - 32 * u - 31 + lane;
            hit[u] = __ballot_sync(FULL_MASK, i >= 1 && cross_bwd(x, i, a));
        }
#pragma unroll
        for (int u = 0; u < GEN_WIN; ++u)
            if (hit[u]) return top - 32 * u - __clz(hit[u]);
    }
    return -1;
}

// ---------------------------------------------------------------------------
// the convolution's geometry (mirrored by _tile_program._plan's scratch)

__device__ __forceinline__ int round_up(int v, int q) {
    return (v + q - 1) / q * q;
}

// One tile of R consecutive outputs a thread from output o0 on: out[o] =
// sum_t x[lo + o - t] * k[t] from the window win[s] = x[lo - mc + 1 + s],
// into the plane o and its stored copy g (16-byte stores where `vec`).
// Returns the flag bits of this thread's outputs.
template <int R>
__device__ __forceinline__ int conv_tile(const float* win, const float* ks,
                                          int m, int mc, int mp, int o0, int p,
                                          bool bad, float* o, float* g,
                                          bool vec) {
    const int oi = o0 + (int)threadIdx.x * R;
    if (oi >= p) return 0;
    float acc[R][1];
    if (!bad) {
        conv_tile_accumulate<R, 1>(win + oi + mc - CONV_CHUNK, ks, mp, m, acc);
    } else {
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][0] = __int_as_float(0x7fc00000);
    }
    int h = 0;
    if (oi + R <= p) {
#pragma unroll
        for (int q = 0; q < R / 4; ++q) {
            const float4 v = make_float4(acc[4 * q][0], acc[4 * q + 1][0],
                                         acc[4 * q + 2][0], acc[4 * q + 3][0]);
            reinterpret_cast<float4*>(o + oi)[q] = v;
            if (g && vec) __stcs(reinterpret_cast<float4*>(g + oi) + q, v);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
            h |= nan_inf(acc[r][0]);
            if (g && !vec) g[oi + r] = acc[r][0];
        }
    } else {
#pragma unroll
        for (int r = 0; r < R; ++r)
            if (oi + r < p) {
                o[oi + r] = acc[r][0];
                if (g) g[oi + r] = acc[r][0];
                h |= nan_inf(acc[r][0]);
            }
    }
    return h;
}

// ---------------------------------------------------------------------------

// The ops that warp 0 runs alone, lane 0 storing the result: the searches
// and the per-row scalar arithmetic.
__device__ __forceinline__ void warp_op(const GenParams& P, const Row& R,
                                        int k, int code) {
    const int* op = tape(P) + k * OP_INTS;
    const int* in = op + 1;
    const int* ip = in + OP_IN + OP_OUT;
    const int lane = threadIdx.x & 31;
    const int cast = ip[7];
    const double dnan = __longlong_as_double(0x7ff8000000000000LL);
    double v = dnan;
    if (code == OP_TPT) {
        // first forward (ip[0] = 1) or last backward crossing of a from the
        // integral start t inside the row
        const float* x = plane(P, in[0]);
        const int n = plen(P, in[0]);
        const double a = operand(P, k, 1, cast);
        const double t = operand(P, k, 2, cast);
        const bool bad = plane_nan(P, in[0], true);
        const double tt = trunc(t);
        const bool ok = tt >= 0.0 && tt < (double)n && tt == t;
        int idx = -1;
        if (!bad && ok && !isnan(a)) {
            const int s = (int)tt;
            idx = ip[0] ? gen_search_fwd(x, n, s, (float)a, lane)
                        : gen_search_bwd(x, s, (float)a, lane);
        }
        if (idx >= 0) v = (double)idx;
    } else if (code == OP_FTP) {
        const float* x = plane(P, in[0]);
        const int n = plen(P, in[0]);
        const double t = operand(P, k, 1, cast);
        const bool bad = plane_nan(P, in[0], true) || isnan(t)
                         || !(t >= 0.0 && t <= (double)(n - 1));
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
    } else if (code == OP_UFUNC) {
        // float32 operands round once in float64 and once more to float32:
        // the float32 result (53 >= 2 * 24 + 2 bits)
        const double a = operand(P, k, 0, cast);
        const double b = operand(P, k, 1, cast);
        v = ip[0] == 0 ? __dadd_rn(a, b)
          : ip[0] == 1 ? __dmul_rn(a, b) : __ddiv_rn(a, b);
        if (ip[1]) v = (double)(float)v;
    } else {  // OP_CONVERT
        // (x + offset_in) * ratio - offset_out in float64, rounded half to
        // even for convert_round, in the input's type
        const double x = operand(P, k, 0, 0);
        const double a = operand(P, k, 1, 0);
        const double b = operand(P, k, 2, 0);
        v = __dsub_rn(__dmul_rn(__dadd_rn(x, a), tape_dp(P)[k * OP_DP]), b);
        if (ip[0]) v = rint(v);
        if (ip[1]) v = (double)(float)v;
    }
    if (lane == 0) put(P, R, in[OP_IN], v);
}

__device__ __forceinline__ void gen_cp_async16(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void gen_cp_async4(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void gen_cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// An external plane into its place in the arena by cp.async: 16 bytes a
// lane where the row starts on 16 bytes (4 where it does not), every copy
// in flight before the first wait and none holding registers; then each
// thread tests the chunks it copied itself for a NaN.
__device__ __forceinline__ void op_load(const GenParams& P, const Row& R,
                                        int s) {
    float* x = plane(P, s);
    const int n = plen(P, s), e = sf(P, s, S_EXT);
    const float* g = (const float*)P.ext[e] + R.row * P.ext_stride[e];
    const int tid = threadIdx.x;
    const bool vec = (reinterpret_cast<uintptr_t>(g) & 15) == 0;
    const int i0 = vec ? (n >> 2) << 2 : 0;
    for (int j = tid; 4 * j < i0; j += GEN_THREADS)
        gen_cp_async16(x + 4 * j, g + 4 * j);
    for (int i = i0 + tid; i < n; i += GEN_THREADS) gen_cp_async4(x + i, g + i);
    gen_cp_async_wait_all();
    int h = 0;
    for (int j = tid; 4 * j < i0; j += GEN_THREADS) {
        const float4 v = reinterpret_cast<const float4*>(x)[j];
        h |= nan_inf4(v);
    }
    for (int i = i0 + tid; i < n; i += GEN_THREADS) h |= nan_inf(x[i]);
    flag_plane(P, s, h);
}

// min_max: first-occurrence extrema, the warps' candidates behind one
// barrier; warp 0 meets them with shuffles (the extremum is one (value,
// index) in whatever order its candidates meet), lanes 0-3 store.
__device__ __forceinline__ void op_min_max(const GenParams& P, Row& R,
                                           const int* in, const int* out) {
    const float* x = plane(P, in[0]);
    const int n = plen(P, in[0]);
    const bool bad = plane_nan(P, in[0], false);
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    float vmin = 0.f, vmax = 0.f;
    int imin = n, imax = n;
#pragma unroll 4
    for (int i = tid; i < n; i += GEN_THREADS) {
        const float v = x[i];
        if (imin == n || v < vmin) { vmin = v; imin = i; }
        if (imax == n || v > vmax) { vmax = v; imax = i; }
    }
    for (int o = 16; o > 0; o >>= 1) {
        const float v2 = __shfl_down_sync(FULL_MASK, vmin, o);
        const int i2 = __shfl_down_sync(FULL_MASK, imin, o);
        if (ext_better(v2, i2, vmin, imin, false, n)) { vmin = v2; imin = i2; }
        const float u2 = __shfl_down_sync(FULL_MASK, vmax, o);
        const int j2 = __shfl_down_sync(FULL_MASK, imax, o);
        if (ext_better(u2, j2, vmax, imax, true, n)) { vmax = u2; imax = j2; }
    }
    float* rf = gen_redf[R.rb];
    int* ri = gen_redi[R.rb];
    R.rb ^= 1;
    if (lane == 0) {
        rf[wid] = vmin;
        ri[wid] = imin;
        rf[GEN_WARPS + wid] = vmax;
        ri[GEN_WARPS + wid] = imax;
    }
    __syncthreads();
    if (wid != 0) return;
    const bool own = lane < GEN_WARPS;
    vmin = own ? rf[lane] : 0.f;
    imin = own ? ri[lane] : n;
    vmax = own ? rf[GEN_WARPS + lane] : 0.f;
    imax = own ? ri[GEN_WARPS + lane] : n;
    for (int o = GEN_WARPS / 2; o > 0; o >>= 1) {
        const float v2 = __shfl_down_sync(FULL_MASK, vmin, o);
        const int i2 = __shfl_down_sync(FULL_MASK, imin, o);
        if (ext_better(v2, i2, vmin, imin, false, n)) { vmin = v2; imin = i2; }
        const float u2 = __shfl_down_sync(FULL_MASK, vmax, o);
        const int j2 = __shfl_down_sync(FULL_MASK, imax, o);
        if (ext_better(u2, j2, vmax, imax, true, n)) { vmax = u2; imax = j2; }
    }
    const double q[4] = {(double)__shfl_sync(FULL_MASK, imin, 0),
                         (double)__shfl_sync(FULL_MASK, imax, 0),
                         (double)__shfl_sync(FULL_MASK, vmin, 0),
                         (double)__shfl_sync(FULL_MASK, vmax, 0)};
    if (lane < 4)
        put(P, R, out[lane],
            bad ? __longlong_as_double(0x7ff8000000000000LL)
                : lane == 0 ? q[0] : lane == 1 ? q[1] : lane == 2 ? q[2] : q[3]);
}

// linear_slope_fit: block_reduce.cuh's slope_fit, its three block sums
// replayed from two barriers.
__device__ __forceinline__ void op_slope_fit(const GenParams& P, Row& R,
                                             const int* in, const int* out) {
    const float* x = plane(P, in[0]);
    const bool bad = plane_nan(P, in[0], false);
    const int L = plen(P, in[0]);
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    double sy = 0.0, sxy = 0.0;
#pragma unroll 4
    for (int j = tid; j < L; j += GEN_THREADS) {
        const double v = (double)x[j];
        sy += v;
        sxy += v * (double)j;
    }
    sy = warp_sum(sy);
    sxy = warp_sum(sxy);
    double* r1 = gen_red[R.rb];
    R.rb ^= 1;
    if (lane == 0) {
        r1[wid] = sy;
        r1[GEN_WARPS + wid] = sxy;
    }
    __syncthreads();
    sy = replay_sum(r1);
    // r1 is read here, before the second barrier: after it the next
    // reduction may take r1 again
    sxy = replay_sum(r1 + GEN_WARPS);
    const double mean = sy / L;
    double ss = 0.0;
#pragma unroll 4
    for (int j = tid; j < L; j += GEN_THREADS) {
        const double d = (double)x[j] - mean;
        ss += d * d;
    }
    ss = warp_sum(ss);
    double* r2 = gen_red[R.rb];
    R.rb ^= 1;
    if (lane == 0) r2[wid] = ss;
    __syncthreads();
    if (tid != 0) return;
    ss = replay_sum(r2);
    const double var = L > 1 ? ss / (double)(L - 1) : 0.0;
    const double Ld = (double)L;
    const double sum_x = Ld * (Ld - 1.0) / 2.0;
    const double sum_x2 = (Ld - 1.0) * Ld * (2.0 * Ld - 1.0) / 6.0;
    const double slope = (Ld * sxy - sum_x * sy) / (Ld * sum_x2 - sum_x * sum_x);
    const double dnan = __longlong_as_double(0x7ff8000000000000LL);
    put(P, R, out[0], bad ? dnan : (double)(float)mean);
    put(P, R, out[1], bad ? dnan : (double)(float)sqrt(var));
    put(P, R, out[2], bad ? dnan : (double)(float)slope);
    put(P, R, out[3], bad ? dnan : (double)(float)((sy - sum_x * slope) / Ld));
}

// pole_zero: pz = w + omc * (exclusive prefix of w), K1's pass 2; each
// thread's run from registers.
__device__ __forceinline__ void op_pole_zero(const GenParams& P, Row& R,
                                             int k, const int* in,
                                             const int* out, const int* ip) {
    const float* x = plane(P, in[0]);
    float* o = plane(P, out[0]);
    float* g = esc_plane(P, R, out[0]);
    const int n = plen(P, in[0]);
    const double omc = tape_dp(P)[k * OP_DP];
    const bool bad = plane_nan(P, in[0], false) || ip[0];
    const float qnan = __int_as_float(0x7fc00000);
    int j0, j1;
    scan_run(n, j0, j1);
    const int cnt = j1 - j0;
    int h = 0;
    if ((n + GEN_THREADS - 1) / GEN_THREADS <= GEN_RUN) {
        float r[GEN_RUN];
        load_run(x, j0, cnt, r);
        double run = 0.0;
#pragma unroll
        for (int q = 0; q < GEN_RUN; ++q)
            if (q < cnt) run += (double)r[q];
        double s = gen_excl_scan(R, run);
        const bool vec = cnt == GEN_RUN &&
            ((reinterpret_cast<uintptr_t>(o + j0) |
              reinterpret_cast<uintptr_t>(g)) & 15) == 0;
#pragma unroll
        for (int c = 0; c < GEN_RUN / 4; ++c) {
            float y[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int q = 4 * c + u;
                y[u] = bad ? qnan : __fadd_rn(r[q], (float)(omc * s));
                if (q < cnt) {
                    s += (double)r[q];
                    h |= nan_inf(y[u]);
                }
            }
            if (vec) {
                const float4 v = make_float4(y[0], y[1], y[2], y[3]);
                reinterpret_cast<float4*>(o + j0)[c] = v;
                if (g) __stcs(reinterpret_cast<float4*>(g + j0) + c, v);
            } else {
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    if (4 * c + u < cnt) {
                        o[j0 + 4 * c + u] = y[u];
                        if (g) g[j0 + 4 * c + u] = y[u];
                    }
            }
        }
    } else {
        double run = 0.0;
        for (int j = j0; j < j1; ++j) run += (double)x[j];
        double s = gen_excl_scan(R, run);
        for (int j = j0; j < j1; ++j) {
            const float v = x[j];
            const float y = bad ? qnan : __fadd_rn(v, (float)(omc * s));
            o[j] = y;
            if (g) g[j] = y;
            h |= nan_inf(y);
            s += (double)v;
        }
    }
    flag_plane(P, out[0], h);
}

// trap_norm / asym_trap_filter from the padded float64 prefix.
__device__ __forceinline__ void op_trap(const GenParams& P, Row& R,
                                        const int* in, const int* out,
                                        const int* ip) {
    const float* x = plane(P, in[0]);
    float* o = plane(P, out[0]);
    float* g = esc_plane(P, R, out[0]);
    const int n = plen(P, in[0]);
    const bool bad = plane_nan(P, in[0], false);
    const bool direct = !plane_has(P, in[0], GEN_INF, false);
    const int pad = prefix_pad(n);
    double* ps = scratch_of(P);
    gen_prefix(R, x, n, ps, pad);
    const TrapSpec t = {ip[0], ip[1], ip[2], ip[3]};
    const double yr = __drcp_rn((double)t.rise), yf = __drcp_rn((double)t.fall);
    const float qnan = __int_as_float(0x7fc00000);
    int h = 0;
#pragma unroll 2
    for (int i = threadIdx.x; i < n; i += GEN_THREADS) {
        const float v = bad ? qnan : gen_trap_at(t, x, ps, pad, direct, yr, yf, i);
        o[i] = v;
        if (g) g[i] = v;
        h |= nan_inf(v);
    }
    flag_plane(P, out[0], h);
}

// amax: block_max's tree, behind one barrier.
__device__ __forceinline__ void op_amax(const GenParams& P, Row& R,
                                        const int* in, const int* out) {
    const float* x = plane(P, in[0]);
    const int n = plen(P, in[0]);
    const bool bad = plane_nan(P, in[0], false);
    const int tid = threadIdx.x;
    float mx = -INFINITY;
#pragma unroll 4
    for (int i = tid; i < n; i += GEN_THREADS) mx = fmaxf(mx, x[i]);
    for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_down_sync(FULL_MASK, mx, o));
    float* rf = gen_redf[R.rb];
    R.rb ^= 1;
    if ((tid & 31) == 0) rf[tid >> 5] = mx;
    __syncthreads();
    if (tid == 0)
        put(P, R, out[0],
            bad ? __longlong_as_double(0x7ff8000000000000LL) : (double)replay_max(rf));
}

// convolve_wf (banded route): out[o] = sum_t x[lo + o - t] * taps[t] from a
// window of the row with a zero halo, win[s] = x[lo - mc + 1 + s], and the
// taps padded with zeros to mp; conv_tile.cuh's loop.
__device__ __forceinline__ void op_conv(const GenParams& P, const Row& R,
                                        const int* in, const int* out,
                                        const int* ip) {
    const float* x = plane(P, in[0]);
    float* o = plane(P, out[0]);
    float* g = esc_plane(P, R, out[0]);
    const int n = plen(P, in[0]), p = plen(P, out[0]);
    const int m = ip[1], lo = ip[2];
    const int mc = round_up(m, CONV_CHUNK), mp = round_up(m, 4);
    const int span = round_up(p + mc + 4, 4);
    const int s0 = lo - mc + 1;
    float* win = reinterpret_cast<float*>(scratch_of(P));
    float* ks = win + span;
    const bool bad = plane_nan(P, in[0], false);
    const int tid = threadIdx.x;
#pragma unroll 4
    for (int s = tid; s < span; s += GEN_THREADS) {
        const int q = s0 + s;
        win[s] = (q >= 0 && q < n) ? x[q] : 0.f;
    }
    for (int t = tid; t < mp; t += GEN_THREADS)
        ks[t] = t < m ? __ldg(P.taps + ip[0] + t) : 0.f;
    __syncthreads();
    const bool vec = (reinterpret_cast<uintptr_t>(g) & 15) == 0;
    int h = 0;
    int o0 = 0;
    for (; o0 + GEN_R * GEN_THREADS <= p; o0 += GEN_R * GEN_THREADS)
        h |= conv_tile<GEN_R>(win, ks, m, mc, mp, o0, p, bad, o, g, vec);
    for (; o0 < p; o0 += GEN_R_TAIL * GEN_THREADS)
        h |= conv_tile<GEN_R_TAIL>(win, ks, m, mc, mp, o0, p, bad, o, g, vec);
    flag_plane(P, out[0], h);
}

// numpy's 'reflect' index of position q of a row of n samples, for a pad
// shorter than the row (one reflection, the edge sample not repeated).
__device__ __forceinline__ int reflect_at(int q, int n) {
    return q < 0 ? -q : q >= n ? 2 * (n - 1) - q : q;
}

__device__ __forceinline__ float rn_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double rn_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float rn_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double rn_add(double a, double b) { return __dadd_rn(a, b); }

// reflected_convolve_wf (direct route, m <= 32 taps): the plain version pads
// the row by m / 2 + 1 reflected samples, convolves in full and keeps the
// 'same' window, whose output j reads the padded row at 1 + j ... m + j
// only. So out[j] = sum_k taps[k] * x[reflect_at(j + (m - 1) / 2 - k, n)],
// summed as _conv_full_direct sums it: taps[m-1]'s product first, then
// k = m-2 down to 0, each product and each sum rounded apart (an FMA would
// change the bits), in the output's type T: float32, or float64 where the
// taps are float64 (the float32 row widened exactly). No pad is built: the
// index map reads the row in place, its neighbours and reflected edges
// written by other threads (the plan puts a barrier before the op).
template <typename T>
__device__ __forceinline__ int reflected_conv_row(const float* x, int n,
                                                  const T* ks, int m, bool bad,
                                                  T* o, T* g) {
    const int d = (m - 1) / 2;
    int h = 0;
    for (int j = threadIdx.x; j < n; j += GEN_THREADS) {
        T acc = (T)__int_as_float(0x7fc00000);
        if (!bad) {
            acc = rn_mul(__ldg(ks + m - 1), (T)x[reflect_at(j + d - (m - 1), n)]);
            for (int k = m - 2; k >= 0; --k)
                acc = rn_add(acc, rn_mul(__ldg(ks + k), (T)x[reflect_at(j + d - k, n)]));
        }
        o[j] = acc;
        if (g) g[j] = acc;
        h |= nan_inf(acc);
    }
    return h;
}

__device__ __forceinline__ void op_reflected_conv(const GenParams& P,
                                                  const Row& R, const int* in,
                                                  const int* out,
                                                  const int* ip) {
    const float* x = plane(P, in[0]);
    const int n = plen(P, in[0]);
    const bool bad = plane_nan(P, in[0], false);
    // float64 taps sit in pairs of words from an even word (8 bytes)
    const int h = sf(P, out[0], S_F64)
        ? reflected_conv_row(x, n, reinterpret_cast<const double*>(P.taps + ip[0]),
                             ip[1], bad, plane64(P, out[0]), esc_plane64(P, R, out[0]))
        : reflected_conv_row(x, n, P.taps + ip[0], ip[1], bad, plane(P, out[0]),
                             esc_plane(P, R, out[0]));
    flag_plane(P, out[0], h);
}

// bl_subtract, windower and avg_current: one pass over the output.
__device__ __forceinline__ void op_gather(const GenParams& P, const Row& R,
                                          int k, int code, const int* in,
                                          const int* out, const int* ip) {
    const float* x = plane(P, in[0]);
    float* o = plane(P, out[0]);
    float* g = esc_plane(P, R, out[0]);
    const int nx = plen(P, in[0]), m = plen(P, out[0]);
    const float qnan = __int_as_float(0x7fc00000);
    const int tid = threadIdx.x;
    int h = 0;
    if (code == OP_BL_SUB) {
        const double bl = operand(P, k, 1, ip[7]);
        const bool bad = plane_nan(P, in[0], false) || isnan(bl);
        const float b = (float)bl;
        int i0 = 0;
        if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g)) & 15) == 0) {
            const int m4 = m >> 2;
            for (int j = tid; j < m4; j += GEN_THREADS) {
                const float4 a = reinterpret_cast<const float4*>(x)[j];
                const float4 v = bad ? make_float4(qnan, qnan, qnan, qnan)
                    : make_float4(__fsub_rn(a.x, b), __fsub_rn(a.y, b),
                                  __fsub_rn(a.z, b), __fsub_rn(a.w, b));
                reinterpret_cast<float4*>(o)[j] = v;
                if (g) __stcs(reinterpret_cast<float4*>(g) + j, v);
                h |= nan_inf4(v);
            }
            i0 = 4 * m4;
        }
        for (int i = i0 + tid; i < m; i += GEN_THREADS) {
            const float v = bad ? qnan : __fsub_rn(x[i], b);
            o[i] = v;
            if (g) g[i] = v;
            h |= nan_inf(v);
        }
    } else if (code == OP_WINDOWER) {
        const double t0 = operand(P, k, 1, ip[7]);
        const bool bad = plane_nan(P, in[0], false) || isnan(t0);
        double t = trunc(t0);
        t = isnan(t) ? 0.0 : fmin(fmax(t, -(m + 1.0)), (double)nx);
        const int ti = (int)t;
#pragma unroll 4
        for (int j = tid; j < m; j += GEN_THREADS) {
            const int q = ti + j;
            const float v = (bad || q < 0 || q >= nx) ? qnan : x[q];
            o[j] = v;
            if (g) g[j] = v;
            h |= nan_inf(v);
        }
    } else if (sf(P, out[0], S_F64)) {  // OP_AVG_CURRENT over float64 planes
        const int L = ip[0];
        const double lf = tape_dp(P)[k * OP_DP];
        const bool bad = plane_nan(P, in[0], false);
        const double* xd = plane64(P, in[0]);
        double* od = plane64(P, out[0]);
        double* gd = esc_plane64(P, R, out[0]);
        const double dnan = __longlong_as_double(0x7ff8000000000000LL);
#pragma unroll 4
        for (int i = tid; i < m; i += GEN_THREADS) {
            const double v = (bad || i >= nx - L) ? dnan
                             : __ddiv_rn(__dsub_rn(xd[i + L], xd[i]), lf);
            od[i] = v;
            if (gd) gd[i] = v;
            h |= nan_inf(v);
        }
    } else {  // OP_AVG_CURRENT
        const int L = ip[0];
        const float lf = (float)tape_dp(P)[k * OP_DP];
        const bool bad = plane_nan(P, in[0], false);
#pragma unroll 4
        for (int i = tid; i < m; i += GEN_THREADS) {
            const float v = (bad || i >= nx - L) ? qnan
                            : __fdiv_rn(__fsub_rn(x[i + L], x[i]), lf);
            o[i] = v;
            if (g) g[i] = v;
            h |= nan_inf(v);
        }
    }
    flag_plane(P, out[0], h);
}

// moving_window_multi: mw_cascade.cuh's stages. The first reads the input
// plane, the others rewrite the output in place (the output may be the
// input's own space, where the plan put it there).
__device__ __forceinline__ void op_mw_multi(const GenParams& P, Row& R,
                                            const int* in, const int* out,
                                            const int* ip) {
    const float* x = plane(P, in[0]);
    float* o = plane(P, out[0]);
    float* g = esc_plane(P, R, out[0]);
    const int n = plen(P, in[0]);
    const int L = ip[0], num = ip[1], mtype = ip[2];
    const bool bad = plane_nan(P, in[0], false);
    const int tid = threadIdx.x;
    int h = 0;
    if (bad || num == 0) {
        // the plan counts on a barrier before the op's writes, on either
        // path (bad is the same in every thread)
        __syncthreads();
        const float qnan = __int_as_float(0x7fc00000);
        for (int i = tid; i < n; i += GEN_THREADS) {
            const float v = bad ? qnan : x[i];
            o[i] = v;
            if (g) g[i] = v;
            h |= nan_inf(v);
        }
    } else {
        const int pad = prefix_pad(n);
        const double yl = __drcp_rn((double)L);
        double* ps = scratch_of(P);
        const float* src = x;
        for (int it = 0; it < num; ++it) {
            const bool right = ((it % 2 == 1) && mtype == 0) || mtype == 2;
            // x[0] and x[n-1] are read before the prefix's barriers, after
            // which the stage rewrites its row in place
            const float w0 = src[0], wl = src[n - 1];
            gen_prefix_shared(R, src, n, ps, pad);
            const bool last = it == num - 1;
#pragma unroll 2
            for (int i = tid; i < n; i += GEN_THREADS) {
                const float v = mw_at(ps, pad, n, L, right, (double)w0,
                                      (double)wl, yl, i);
                o[i] = v;
                if (last) {
                    if (g) g[i] = v;
                    h |= nan_inf(v);
                }
            }
            if (!last) __syncthreads();
            src = o;
        }
    }
    flag_plane(P, out[0], h);
}

__global__ void __launch_bounds__(GEN_THREADS, GEN_MIN_BLOCKS)
generic_rows_kernel(const __grid_constant__ GenParams P) {
    Row R;
    R.row = blockIdx.x;
    R.rb = 0;
    const int tid = threadIdx.x;

    // the tape into shared memory; then no plane holds a NaN yet, and the
    // external scalars go into their places
    {
        double* dp = gen_smem + P.tape_dbl;
        int* code = reinterpret_cast<int*>(dp + P.n_dpar);
        for (int i = tid; i < P.n_dpar; i += GEN_THREADS) dp[i] = P.dpar[i];
        for (int i = tid; i < P.n_code; i += GEN_THREADS) code[i] = P.code[i];
    }
    for (int s = tid; s < P.n_slots; s += GEN_THREADS) {
        nanf_of(P)[s] = 0;
        const int r = P.n_ops * OP_INTS + s * SLOT_INTS;
        const int e = P.code[r + S_EXT];
        if (P.code[r + S_KIND] == 1 && e >= 0)
            gen_smem[P.code[r + S_SIDX]] =
                P.code[r + S_F64] ? ((const double*)P.ext[e])[R.row]
                                  : (double)((const float*)P.ext[e])[R.row];
    }
    __syncthreads();

    for (int k = 0; k < P.n_ops; ++k) {
        const int* op = tape(P) + k * OP_INTS;
        const int* in = op + 1;
        const int* out = in + OP_IN;
        const int* ip = out + OP_OUT;
        const int code = op[0];
        if (ip[IP_PLAN] & 1) __syncthreads();
        switch (code) {
        case OP_TPT:
        case OP_FTP:
        case OP_UFUNC:
        case OP_CONVERT:
            if ((tid >> 5) == 0) {
                __syncwarp();
                warp_op(P, R, k, code);
            }
            break;
        case OP_LOAD: op_load(P, R, in[0]); break;
        case OP_MIN_MAX: op_min_max(P, R, in, out); break;
        case OP_SLOPE_FIT: op_slope_fit(P, R, in, out); break;
        case OP_POLE_ZERO: op_pole_zero(P, R, k, in, out, ip); break;
        case OP_TRAP: op_trap(P, R, in, out, ip); break;
        case OP_AMAX: op_amax(P, R, in, out); break;
        case OP_CONV: op_conv(P, R, in, out, ip); break;
        case OP_BL_SUB:
        case OP_WINDOWER:
        case OP_AVG_CURRENT: op_gather(P, R, k, code, in, out, ip); break;
        case OP_MW_MULTI: op_mw_multi(P, R, in, out, ip); break;
        case OP_REFL_CONV: op_reflected_conv(P, R, in, out, ip); break;
        default: break;
        }
    }
}

static cudaError_t gen_launch(int smem, int* per_sm) {
    cudaError_t err = cudaFuncSetAttribute(
        generic_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, generic_rows_kernel, GEN_THREADS, smem);
}

extern "C" int dspeed_generic_rows(const GenParams* p, int smem, void* stream) {
    int per_sm;
    cudaError_t err = gen_launch(smem, &per_sm);
    if (err != cudaSuccess) return (int)err;
    if (p->B == 0) return 0;
    generic_rows_kernel<<<p->B, GEN_THREADS, smem, (cudaStream_t)stream>>>(*p);
    return (int)cudaGetLastError();
}

// How a program with `smem` bytes of dynamic shared memory launches: threads
// a block, blocks per SM, registers and local (spill) bytes a thread, static
// shared bytes.
extern "C" int dspeed_generic_rows_config(int smem, int* out) {
    int per_sm;
    cudaError_t err = gen_launch(smem, &per_sm);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, generic_rows_kernel)) != cudaSuccess)
        return (int)err;
    const int vals[] = {GEN_THREADS, per_sm, attr.numRegs,
                        (int)attr.localSizeBytes, (int)attr.sharedSizeBytes};
    for (int i = 0; i < 5; ++i) out[i] = vals[i];
    return 0;
}

extern "C" const char* dspeed_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
