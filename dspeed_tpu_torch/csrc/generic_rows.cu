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
//   double_pole_zero                 the numerator on that float64 prefix,
//                                    the pole by runs and an affine scan of
//                                    their maps in float64 (the plain
//                                    walk's order), the correction from the
//                                    host's p^i table
//   convolve_wf (banded route)       conv_tile.cuh's register-tiled loop, in
//                                    conv_row.cuh's order (K3's and K4's)
//   reflected_convolve_wf (m <= 32)  each output from the row's own samples
//                                    through the reflect index map, summed in
//                                    the plain version's order, unfused, in
//                                    float32 or (float64 taps) float64, on a
//                                    float32 or (float64 kernel) float64 row
//   time_point_thresh,               K2's warp search: 32 positions a
//   interpolated_time_point_thresh   ballot, GEN_WIN ballots a step; the
//                                    interpolation modes in float32
//   poly_diff, poly_exp_rms          the polynomial by FMAs in float32, the
//                                    residual's sums in float64
//   soft_pileup_corr(_bl)            two ops: the exponential fit's
//                                    float64 sums (exp(-i/tau) and its two
//                                    sums from the host) into A and B, then
//                                    the row less the fit
//   wf_correction                    a subtraction of a constant over
//                                    [start, stop)
//   get_wf_centroid                  first-occurrence argmin and argmax,
//                                    then the first positive and last
//                                    negative sample between them
//   inject_sig_pulse, _exp_pulse,    one op: the pulse in float32, each
//   inject_gumbel,                   operation rounded once in the member
//   inject_general_logistic          kernel's order (expf, powf), added
//   normalisation_layer,             one op: the normalisation elementwise;
//   dense_layer_*,                   a product's float64 sums in a fixed
//   classification_layer_*           order (a contiguous run of the inputs a
//                                    warp, then the 8 warps' sums in order,
//                                    ml.layer_rows'), the weights read
//                                    through L2; the activation in float32
//   windower, avg_current            a gather, __fsub_rn and __fdiv_rn
//   fixed_time_pickoff 'l' / 'i'     a per-row gather
//   add, multiply, divide, convert,  per-row scalar arithmetic with _rn
//   convert_round                    intrinsics, rounded to the slot's type
//   greater, less, ... equal         per-row comparisons into bool slots
//   mean_below_threshold,            block sums in float64 (K7's order:
//   linear_slope_diff                _numerics.k7_sum), behind one barrier
//   time_over_threshold, saturation  one op ("count"): integer counts
//   log_check                        __syncthreads_or of x <= 0, then the
//                                    log in float64, rounded once
//   trap_pickoff                     the float64 prefix (gen_prefix), two
//                                    window sums at the row's index
//   presum, min_max_norm,            one pass over the output
//   multi_a_filter
//   get, get_default, where,         per-row gathers and selects, and the
//   *_to_nearest                     four roundings to a multiple
//   trap_filter                      the float64 prefix, prefix differences
//   moving_window_left / _right      the float64 prefix, the member's ramp
//   fixed_time_pickoff 'n' 'f' 'c'   per-row picks; 'h' Hermite's cubic in
//   'h'                              float32, the member's order
//   convolve_wf (m <= 32)            reflected_convolve_wf's direct loop
//   convert_floor / _ceil / _trunc   round_kind on the conversion
//   / _int
//   ufuncs over planes, where        ewise: per sample, the elementwise table
//                                    (ufunc_eval) on planes, per-row
//                                    scalars and constants, into float32 or
//                                    bool planes; per-row ones by the ufunc op
//   amin, min, max, sum, mean,       reduce: extrema exact, sums in K7's
//   nansum, nanmean, nanmax, nanmin  float64 block order
// A row with a NaN poisons what each member poisons, op by op.
//
// Float64 rows run on a kernel of their own, generic_rows_kernel_f64: the
// same interpreter loop over the same tape, plan and barrier tables, with a
// table of ops of its own (gen_op<double>, beside the float kernel's
// gen_op<float>) that takes every op of the float table (the reflected
// convolution there on a float64 row). Every plane there is float64 or bool,
// two words a sample of the arena (a bool plane holds doubles 1.0 and 0.0, its
// stored copy one byte; a slice's place counted in words), and its ops are
// the templated ones above (min_max, amax, the searches, pick-offs and
// gathers, soft_pileup, wf_correction, wf_centroid, the coverage ops, the
// moving windows, the direct convolution, ewise, reduce, the bool load) or
// float64 forms (op_*64, inject and dense among them): each the member's
// arithmetic on a float64 row, every product, sum and quotient rounded once
// (no contraction) in the order of the tape's plain walk, whose members take
// their K7-order variants (k7_plain, given f64); exp, log, pow, tanh and
// log1p are the device's, as PyTorch's float64 ones on the card. The ops
// the float64 flagship, DPZ and extras groups do not run sit behind one
// __noinline__ call site, outlined_op64, as the float kernel's plane ops do
// behind outlined_op. Nothing of the float kernel's table is on that path,
// so its register cap stays; the float64 groups' shared memory (~106 KB for
// the flagship's) allows two blocks an SM, and with them 128 registers a
// thread (108 taken).
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
#define GEN_MIN_BLOCKS_F64 2  // and for the float64 kernel
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
enum { S_KIND, S_TYPE, S_OFF, S_LEN, S_SIDX, S_EXT, S_ESC, S_ROOT };
// a slot's S_TYPE (_tile_program.SLOT_TYPES): planes are float32 or float64;
// a per-row scalar, held as a double, may also be a bool or an int64
enum { T_F32, T_F64, T_BOOL, T_I64 };
enum {
    OP_LOAD = 1, OP_MIN_MAX, OP_BL_SUB, OP_SLOPE_FIT, OP_POLE_ZERO, OP_TRAP,
    OP_AMAX, OP_CONV, OP_TPT, OP_WINDOWER, OP_AVG_CURRENT, OP_MW_MULTI,
    OP_FTP, OP_UFUNC, OP_CONVERT, OP_REFL_CONV, OP_DPZ, OP_POLY_RESID,
    OP_SOFT_PILEUP, OP_WF_CORR, OP_WF_CENTROID, OP_SOFT_PILEUP_OUT, OP_INJECT,
    OP_DENSE, OP_MEAN_BELOW, OP_COUNT, OP_PRESUM, OP_LOG_CHECK, OP_TRAP_PICKOFF,
    OP_MIN_MAX_NORM, OP_SLOPE_DIFF, OP_GET, OP_MULTI_A, OP_WHERE, OP_ROUND,
    OP_MW, OP_CONV_DIRECT, OP_EWISE, OP_REDUCE
};
// the ewise op's conversions of a plane: EW_CONVERT + the convert op's kind
#define EW_CONVERT 40

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

// The same for a plane of samples of type T: float, or double (S_TYPE
// T_F64), which spans two words a sample of the arena (a slice's S_OFF
// counts words too).
template <typename T>
__device__ __forceinline__ T* plane_of(const GenParams& P, int s) {
    return reinterpret_cast<T*>(plane(P, s));
}

template <typename T>
__device__ __forceinline__ T* esc_of(const GenParams& P, const Row& R, int s) {
    const int e = sf(P, s, S_ESC);
    if (e < 0) return nullptr;
    return (T*)P.esc[e] + R.row * (long long)sf(P, s, S_LEN);
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

// Thread 0 stores v, rounded to the slot's type, and its escape. A bool's
// (0 or 1) and an int64's value (integral: its op truncated it) are stored
// as they are, their escapes as float64, which the wrapper converts
// (_tile_program.esc_dtype): a branch on the type here, inlined at every
// scalar store, made the generic flagship's groups 0.9% slower
// (tools/k7_time.py).
__device__ __forceinline__ void put(const GenParams& P, const Row& R, int s,
                                    double v) {
    const int ty = sf(P, s, S_TYPE), e = sf(P, s, S_ESC);
    if (ty == T_F32) v = (double)(float)v;
    gen_smem[sf(P, s, S_SIDX)] = v;
    if (e >= 0) {
        if (ty != T_F32) ((double*)P.esc[e])[R.row] = v;
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
// block (called by every thread) or by warp 0 alone (`warp`), as samples
// of type T.
template <typename T = float>
__device__ __forceinline__ bool plane_has(const GenParams& P, int s, int bit,
                                          bool warp) {
    const int r = sf(P, s, S_ROOT);
    if (!(nanf_of(P)[r] & bit)) return false;
    if (sf(P, s, S_OFF) == sf(P, r, S_OFF) && sf(P, s, S_LEN) == sf(P, r, S_LEN))
        return true;
    const T* x = plane_of<T>(P, s);
    const int n = plen(P, s);
    int h = 0;
    if (warp) {
        for (int i = threadIdx.x; i < n; i += 32) h |= nan_inf(x[i]) & bit;
        return __any_sync(FULL_MASK, h) != 0;
    }
    for (int i = threadIdx.x; i < n; i += blockDim.x) h |= nan_inf(x[i]) & bit;
    return __syncthreads_or(h) != 0;
}

template <typename T = float>
__device__ __forceinline__ bool plane_nan(const GenParams& P, int s,
                                          bool warp) {
    return plane_has<T>(P, s, GEN_NAN, warp);
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

__device__ __forceinline__ double replay_max(const double* v) {
    double w[GEN_WARPS];
#pragma unroll
    for (int l = 0; l < GEN_WARPS; ++l) w[l] = v[l];
#pragma unroll
    for (int o = GEN_WARPS / 2; o > 0; o >>= 1)
#pragma unroll
        for (int l = 0; l < o; ++l) w[l] = fmax(w[l], w[l + o]);
    return w[0];
}

// The reduction buffer rb for values of type T (float or double).
template <typename T>
__device__ __forceinline__ T* red_vals(int rb) {
    if constexpr (sizeof(T) == 4) return gen_redf[rb];
    else return gen_red[rb];
}

__device__ __forceinline__ float gen_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double gen_max(double a, double b) { return fmax(a, b); }

// block_reduce.cuh's first-occurrence rule and crossing predicates on a
// float64 row.
__device__ __forceinline__ bool ext_better(double v, int i, double v2, int i2,
                                           bool is_max, int n) {
    if (i2 == n) return i != n;
    if (i == n) return false;
    if (is_max ? (v > v2) : (v < v2)) return true;
    return v == v2 && i < i2;
}

__device__ __forceinline__ bool cross_fwd(const double* x, int i, double a) {
    const double x0 = x[i], x1 = x[i + 1];
    return (x0 <= a && a < x1) || (x0 >= a && a > x1);
}

__device__ __forceinline__ bool cross_bwd(const double* x, int i, double a) {
    const double x0 = x[i - 1], x1 = x[i];
    return (x0 < a && a <= x1) || (x0 > a && a >= x1);
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

// The inclusive float64 prefix of x[0, n) (float or double samples) into ps
// (padded), every value with block_inclusive_prefix's bits, each run read
// from shared memory twice; ends with a barrier, after which ps may be read.
template <typename X>
__device__ __forceinline__ void gen_prefix_shared(Row& R, const X* x,
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
// K2's warp searches (cascade_tp.cu), the same index in every lane, over
// float or double samples

template <typename T>
__device__ __forceinline__ int gen_search_fwd(const T* x, int n, int s,
                                              T a, int lane) {
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

template <typename T>
__device__ __forceinline__ int gen_search_bwd(const T* x, int s, T a,
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

__device__ __forceinline__ float rn_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double rn_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float rn_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double rn_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float rn_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double rn_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float rn_div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double rn_div(double a, double b) { return __ddiv_rn(a, b); }

// fmod(a, b), exact, in T. For float32 from the quotient in float64 where
// it is below 2^24: its truncation q is the true one or one more in
// magnitude, a - q b is then exact by FMA (the remainder, or, with the sign
// opposite to a's, a sign of one too many, and then q is stepped back and
// the FMA taken again). Else (float64, an infinite or zero divisor, a NaN,
// a large quotient) by binary long division in fmod_long: with t = |b| 2^k
// from the top k down, t <= r < 2 t holds before each step, so r - t is
// exact (Sterbenz). It is not inlined, so that its loop's registers stay out
// of its callers' budget; the library's fmod in its place gave the kernel a
// stack frame and made the generic flagship's groups 1-2% slower.
__device__ __noinline__ double fmod_long(double a, double b) {
    if (isnan(a) || isnan(b) || isinf(a) || b == 0.0)
        return __longlong_as_double(0x7ff8000000000000LL);
    double r = fabs(a);
    const double B = fabs(b);
    if (isinf(b) || r < B) return a;
    double t = ldexp(B, ilogb(r) - ilogb(B));
    for (;;) {
        if (r >= t) r = __dsub_rn(r, t);
        if (t == B) break;
        t = __dmul_rn(t, 0.5);
    }
    return copysign(r, a);
}

template <typename T>
__device__ __forceinline__ T exact_fmod(T a, T b) {
    double q = trunc(__ddiv_rn((double)a, (double)b));
    if (sizeof(T) == 8 || !(fabs(q) < 16777216.0) || isinf(b))
        return (T)fmod_long((double)a, (double)b);
    double r = __fma_rn(-q, (double)b, (double)a);
    if (r != 0.0 && (r < 0.0) != (a < (T)0)) {
        q = __dsub_rn(q, copysign(1.0, q));
        r = __fma_rn(-q, (double)b, (double)a);
    }
    return r == 0.0 ? copysign((T)0, a) : (T)r;
}

// numpy's floor_divide as PyTorch computes it (c10's div_floor_floating),
// each operation rounded in T.
template <typename T>
__device__ __forceinline__ T floor_div(T a, T b) {
    if (b == (T)0) return rn_div(a, b);
    const T mod = exact_fmod(a, b);
    T div = rn_div(rn_sub(a, mod), b);
    if (mod != (T)0 && (b < (T)0) != (mod < (T)0)) div = rn_sub(div, (T)1);
    if (div == (T)0) return copysign((T)0, rn_div(a, b));
    T fd = floor(div);
    if (rn_sub(div, fd) > (T)0.5) fd = rn_add(fd, (T)1);
    return fd;
}

// numpy's remainder (the divisor's sign) as PyTorch computes it.
template <typename T>
__device__ __forceinline__ T py_rem(T a, T b) {
    T mod = exact_fmod(a, b);
    if (mod != (T)0 && (b < (T)0) != (mod < (T)0)) mod = rn_add(mod, b);
    return mod;
}

// One entry of the elementwise table (_tile_program.UFUNCS, ip[0] of the
// per-row ufunc op and of the ewise op) on operands a, b, c as doubles.
// With f32 the member computes in float32: every entry but floor_divide,
// power and remainder rounds once in float64 and once more to float32 in
// the caller, which is the float32 result (53 >= 2 * 24 + 2 bits); those
// three take float32 operations. exp, expm1, log, log1p and log10 are taken
// in float64 in the member too (processing_chain._WIDENED_UFUNCS).
// Comparisons and logical ops give 0 or 1.
__device__ __forceinline__ double ufunc_eval(int kind, double a, double b, double c,
                                            int f32) {
    const double dnan = __longlong_as_double(0x7ff8000000000000LL);
    switch (kind) {
    case 0: return __dadd_rn(a, b);
    case 1: return __dmul_rn(a, b);
    case 2: return __ddiv_rn(a, b);
    case 3: return a > b;
    case 4: return a >= b;
    case 5: return a < b;
    case 6: return a <= b;
    case 7: return a == b;
    case 8: return a != b;
    case 9: return __dsub_rn(a, b);
    case 10: return f32 ? (double)floor_div((float)a, (float)b) : floor_div(a, b);
    case 11: return f32 ? (double)powf((float)a, (float)b) : pow(a, b);
    case 12: return f32 ? (double)py_rem((float)a, (float)b) : py_rem(a, b);
    // maximum and minimum: a NaN operand's NaN, else ATen's ::max / ::min
    case 13: return isnan(a) || isnan(b) ? dnan : fmax(a, b);
    case 14: return isnan(a) || isnan(b) ? dnan : fmin(a, b);
    case 15: return a != 0.0 && b != 0.0;
    case 16: return a != 0.0 || b != 0.0;
    case 17: return -a;
    case 18: return fabs(a);
    case 19: return sqrt(a);
    case 20: return __dmul_rn(a, a);
    case 21: return isnan(a) ? a : a > 0.0 ? 1.0 : a < 0.0 ? -1.0 : 0.0;
    case 22: return rint(a);
    case 23: return floor(a);
    case 24: return ceil(a);
    case 25: return trunc(a);
    case 26: return exp(a);
    case 27: return expm1(a);
    case 28: return log(a);
    case 29: return log1p(a);
    case 30: return log10(a);
    case 31: return a == 0.0;
    case 32: return isnan(a);
    case 33: return isfinite(a);
    default: return a != 0.0 ? b : c;  // 34: where
    }
}

// ufunc_eval for the per-row ufunc op. Not inlined, nor ext_other: inlined,
// the comparisons and ext_other made the generic flagship's group A 0.2%
// slower. The ewise op inlines ufunc_eval: a call a sample kept its
// loop's state in local memory.
__device__ __noinline__ double ufunc_apply(int kind, double a, double b, double c,
                                           int f32) {
    return ufunc_eval(kind, a, b, c, f32);
}

// The convert op's kinds past the plain conversion (ip[0]): 1 round (half
// to even), 2 floor, 3 ceil, 4 trunc, 5 convert_int's rint, or the int64
// maximum where the value is 1e-5 or more from it.
__device__ __forceinline__ double round_eval(int kind, double v) {
    switch (kind) {
    case 1: return rint(v);
    case 2: return floor(v);
    case 3: return ceil(v);
    case 4: return trunc(v);
    default: {
        const double r = rint(v);
        return fabs(__dsub_rn(v, r)) < 1.0e-5 ? r : 9.223372036854775807e18;
    }
    }
}

// round_eval for the per-row convert op, not inlined (as ufunc_apply).
__device__ __noinline__ double round_kind(int kind, double v) {
    return round_eval(kind, v);
}

// fixed_time_pickoff's modes 'n', 'f', 'c' and 'h' at x[i0] + f (f the
// fraction, in float32), as the member computes them in float32; Hermite's
// slopes from the neighbours, one-sided at the row's ends, its cubes as
// PyTorch's pow takes them ((t t) t).
__device__ __noinline__ double ftp_more(const float* x, int n, int i0, float f,
                                        int mode) {
    const float wi = x[min(max(i0, 0), n - 1)];
    const float wi1 = x[min(max(i0 + 1, 0), n - 1)];
    if (mode == 'n') return f < 0.5f ? wi : wi1;
    if (mode == 'f' || f == 0.f) return wi;
    if (mode == 'c') return wi1;
    const float wim1 = x[min(max(i0 - 1, 0), n - 1)];
    const float wi2 = x[min(max(i0 + 2, 0), n - 1)];
    const float t0 = f, t1 = __fsub_rn(1.f, f);
    const float m0 = i0 == 0 ? __fsub_rn(x[1], x[0]) : __fdiv_rn(__fsub_rn(wi1, wim1), 2.f);
    const float m1 = i0 == n - 2 ? __fsub_rn(x[n - 1], x[n - 2])
                                 : __fdiv_rn(__fsub_rn(wi2, wi), 2.f);
    const float t12 = __fmul_rn(t1, t1), t13 = __fmul_rn(t12, t1);
    const float t02 = __fmul_rn(t0, t0), t03 = __fmul_rn(t02, t0);
    const float h00 = __fadd_rn(__fmul_rn(-2.f, t13), __fmul_rn(3.f, t12));
    const float h01 = __fadd_rn(__fmul_rn(-2.f, t03), __fmul_rn(3.f, t02));
    return __fadd_rn(__fsub_rn(__fadd_rn(__fmul_rn(h00, wi), __fmul_rn(h01, wi1)),
                               __fmul_rn(__fsub_rn(t13, t12), m0)),
                     __fmul_rn(__fsub_rn(t03, t02), m1));
}

// fixed_time_pickoff on a float64 row at t (in the row, not NaN), each
// operation rounded once in float64 as the member takes it: 'i' and 'l'
// as in float32, 'n' 'f' 'c', and 'h' Hermite's cubic with its cubes as
// PyTorch's pow takes them ((t t) t).
__device__ __noinline__ double ftp_pick64(const double* x, int n, double t, int mode) {
    const int i0 = (int)floor(t);
    const double f = __dsub_rn(t, (double)i0);
    const double wi = x[min(max(i0, 0), n - 1)];
    const double wi1 = x[min(max(i0 + 1, 0), n - 1)];
    if (mode == 'i') return f == 0.0 ? wi : __longlong_as_double(0x7ff8000000000000LL);
    if (mode == 'n') return f < 0.5 ? wi : wi1;
    if (mode == 'f' || f == 0.0) return wi;
    if (mode == 'c') return wi1;
    const double t0 = f, t1 = __dsub_rn(1.0, f);
    if (mode == 'l') return __dadd_rn(__dmul_rn(t1, wi), __dmul_rn(t0, wi1));
    const double wim1 = x[min(max(i0 - 1, 0), n - 1)];
    const double wi2 = x[min(max(i0 + 2, 0), n - 1)];
    const double m0 = i0 == 0 ? __dsub_rn(x[1], x[0]) : __ddiv_rn(__dsub_rn(wi1, wim1), 2.0);
    const double m1 = i0 == n - 2 ? __dsub_rn(x[n - 1], x[n - 2])
                                  : __ddiv_rn(__dsub_rn(wi2, wi), 2.0);
    const double t12 = __dmul_rn(t1, t1), t13 = __dmul_rn(t12, t1);
    const double t02 = __dmul_rn(t0, t0), t03 = __dmul_rn(t02, t0);
    const double h00 = __dadd_rn(__dmul_rn(-2.0, t13), __dmul_rn(3.0, t12));
    const double h01 = __dadd_rn(__dmul_rn(-2.0, t03), __dmul_rn(3.0, t02));
    return __dadd_rn(__dsub_rn(__dadd_rn(__dmul_rn(h00, wi), __dmul_rn(h01, wi1)),
                               __dmul_rn(__dsub_rn(t13, t12), m0)),
                     __dmul_rn(__dsub_rn(t03, t02), m1));
}

// The ops that warp 0 runs alone, lane 0 storing the result: the searches
// and the per-row scalar arithmetic, over planes of type T (a float64
// row's searches compare in float64, its interpolations and picks round in
// float64; get reads its sample in the row's type).
template <typename T>
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
        const T* x = plane_of<T>(P, in[0]);
        const int n = plen(P, in[0]);
        const double a = operand(P, k, 1, cast);
        const double t = operand(P, k, 2, cast);
        const bool bad = plane_nan<T>(P, in[0], true);
        const double tt = trunc(t);
        const int mode = ip[1];
        // interpolated_time_point_thresh takes any start inside the row
        const bool ok = mode ? t >= 0.0 && t < (double)n
                             : tt >= 0.0 && tt < (double)n && tt == t;
        int idx = -1;
        if (!bad && ok && !isnan(a)) {
            const int s = (int)tt;
            idx = ip[0] ? gen_search_fwd(x, n, s, (T)a, lane)
                        : gen_search_bwd(x, s, (T)a, lane);
            // its backward walk stops at sample 2 and reports i - 1
            if (mode && !ip[0]) idx = idx >= 2 ? idx - 1 : -1;
        }
        if (idx >= 0 && !mode) {
            v = (double)idx;
        } else if constexpr (sizeof(T) == 8) {
            if (idx >= 0) {
                const double wc = x[idx], wc1 = x[idx + 1], fi = (double)idx;
                if (mode == 'a' || mode == 'f') v = fi + 1.0;
                else if (mode == 'r') v = fabs(__dsub_rn(a, wc)) < fabs(__dsub_rn(a, wc1))
                                          ? fi : fi + 1.0;
                else if (mode == 'n') v = __dadd_rn(fi, 0.5);
                else if (mode == 'l')
                    v = __dadd_rn(fi, __ddiv_rn(__dsub_rn(a, wc), __dsub_rn(wc1, wc)));
                else v = fi;  // 'i', 'b', 'c'
            }
        } else if (idx >= 0) {
            const float af = (float)a, wc = x[idx], wc1 = x[idx + 1];
            const float fi = (float)idx;
            if (mode == 'a' || mode == 'f') v = (double)(idx + 1);
            else if (mode == 'r') v = fabsf(__fsub_rn(af, wc)) < fabsf(__fsub_rn(af, wc1))
                                      ? (double)idx : (double)(idx + 1);
            else if (mode == 'n') v = (double)__fadd_rn(fi, 0.5f);
            else if (mode == 'l')
                v = (double)__fadd_rn(fi, __fdiv_rn(__fsub_rn(af, wc), __fsub_rn(wc1, wc)));
            else v = (double)idx;  // 'i', 'b', 'c'
        }
    } else if (code == OP_FTP) {
        const T* x = plane_of<T>(P, in[0]);
        const int n = plen(P, in[0]);
        const double t = operand(P, k, 1, cast);
        const bool bad = plane_nan<T>(P, in[0], true) || isnan(t)
                         || !(t >= 0.0 && t <= (double)(n - 1));
        if constexpr (sizeof(T) == 8) {
            if (!bad) v = ftp_pick64(x, n, t, ip[0]);
        } else if (!bad) {
            const int i0 = (int)floor(t);
            const float f = __fsub_rn((float)t, (float)i0);
            const float wi = x[min(max(i0, 0), n - 1)];
            const float wi1 = x[min(max(i0 + 1, 0), n - 1)];
            if (ip[0] == 'i') {
                v = f == 0.f ? (double)wi : dnan;
            } else if (ip[0] == 'l') {
                const float t1 = __fsub_rn(1.f, f);
                v = f == 0.f ? wi
                    : __fadd_rn(__fmul_rn(t1, wi), __fmul_rn(f, wi1));
            } else {
                v = ftp_more(x, n, i0, f, ip[0]);
            }
        }
    } else if (code == OP_UFUNC) {
        // float32 operands round once in float64 and once more to float32:
        // the float32 result (53 >= 2 * 24 + 2 bits); a comparison of the
        // operands' values (exact in float64) into a bool slot
        const double a = operand(P, k, 0, cast);
        const double b = operand(P, k, 1, cast);
        v = ip[0] == 0 ? __dadd_rn(a, b)
          : ip[0] == 1 ? __dmul_rn(a, b)
          : ip[0] == 2 ? __ddiv_rn(a, b) : ufunc_apply(ip[0], a, b, 0.0, ip[1]);
        if (ip[1]) v = (double)(float)v;
    } else if (code == OP_GET) {
        // get / get_default (ip[0]): the sample at an int64 index (operand
        // 1), from the end where negative, cut to int32 as get._pick cuts
        // it; out of range NaN, or the default (operand 2) there and where
        // the sample is NaN
        const T* x = plane_of<T>(P, in[0]);
        const int n = plen(P, in[0]);
        const int i = (int)(long long)operand(P, k, 1, 0);
        const bool ok = i >= -n && i < n;
        const T val = x[min(max(i < 0 ? i + n : i, 0), n - 1)];
        if (!ip[0]) v = ok ? (double)val : dnan;
        else v = ok && !isnan(val) ? (double)val : operand(P, k, 2, cast);
    } else if (code == OP_WHERE) {
        // operand 0 a bool (0 or 1)
        v = operand(P, k, 0, 0) != 0.0 ? operand(P, k, 1, cast) : operand(P, k, 2, cast);
    } else if (code == OP_ROUND) {
        // round (rint: half to even), floor, ceil or trunc (ip[0]) of
        // val / t, times t, in the value's type (ip[1]: float32)
        const double a = operand(P, k, 0, cast), t = operand(P, k, 1, cast);
        const int kind = ip[0];
        if (ip[1]) {
            const float q = __fdiv_rn((float)a, (float)t);
            const float r = kind == 0 ? rintf(q) : kind == 1 ? floorf(q)
                          : kind == 2 ? ceilf(q) : truncf(q);
            v = (double)__fmul_rn((float)t, r);
        } else {
            const double q = __ddiv_rn(a, t);
            const double r = kind == 0 ? rint(q) : kind == 1 ? floor(q)
                           : kind == 2 ? ceil(q) : trunc(q);
            v = __dmul_rn(t, r);
        }
        if (isnan(a)) v = dnan;
    } else {  // OP_CONVERT
        // (x + offset_in) * ratio - offset_out in float64, rounded (ip[0],
        // round_kind) for convert_round, _floor, _ceil, _trunc and _int, in
        // the input's type
        const double x = operand(P, k, 0, 0);
        const double a = operand(P, k, 1, 0);
        const double b = operand(P, k, 2, 0);
        v = __dsub_rn(__dmul_rn(__dadd_rn(x, a), tape_dp(P)[k * OP_DP]), b);
        if (ip[0]) v = ip[0] == 1 ? rint(v) : round_kind(ip[0], v);
        if (ip[1]) v = (double)(float)v;
        // into an int64 slot as PyTorch converts it on the card (truncated,
        // saturated, a NaN to 0)
        if (sf(P, in[OP_IN], S_TYPE) == T_I64) v = (double)(long long)v;
    }
    if (lane == 0) put(P, R, in[OP_IN], v);
}

__device__ __forceinline__ void gen_cp_async16(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void gen_cp_async8(double* dst, const double* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
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

// An external bool plane (one byte a sample) into its place, as 1.0 and 0.0
// of the program's plane type T (a float64 program's bool planes hold
// doubles).
template <typename T>
__device__ __forceinline__ void op_load_bool(const GenParams& P, const Row& R, int s) {
    T* x = plane_of<T>(P, s);
    const int n = plen(P, s), e = sf(P, s, S_EXT);
    const unsigned char* g = (const unsigned char*)P.ext[e] + R.row * P.ext_stride[e];
    for (int i = threadIdx.x; i < n; i += GEN_THREADS) x[i] = g[i] ? (T)1 : (T)0;
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
// index) in whatever order its candidates meet), lanes 0-3 store. T: the
// row's samples (float or double).
template <typename T>
__device__ __forceinline__ void op_min_max(const GenParams& P, Row& R,
                                           const int* in, const int* out) {
    const T* x = plane_of<T>(P, in[0]);
    const int n = plen(P, in[0]);
    const bool bad = plane_nan<T>(P, in[0], false);
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    T vmin = 0, vmax = 0;
    int imin = n, imax = n;
#pragma unroll 4
    for (int i = tid; i < n; i += GEN_THREADS) {
        const T v = x[i];
        if (imin == n || v < vmin) { vmin = v; imin = i; }
        if (imax == n || v > vmax) { vmax = v; imax = i; }
    }
    for (int o = 16; o > 0; o >>= 1) {
        const T v2 = __shfl_down_sync(FULL_MASK, vmin, o);
        const int i2 = __shfl_down_sync(FULL_MASK, imin, o);
        if (ext_better(v2, i2, vmin, imin, false, n)) { vmin = v2; imin = i2; }
        const T u2 = __shfl_down_sync(FULL_MASK, vmax, o);
        const int j2 = __shfl_down_sync(FULL_MASK, imax, o);
        if (ext_better(u2, j2, vmax, imax, true, n)) { vmax = u2; imax = j2; }
    }
    T* rf = red_vals<T>(R.rb);
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
    vmin = own ? rf[lane] : (T)0;
    imin = own ? ri[lane] : n;
    vmax = own ? rf[GEN_WARPS + lane] : (T)0;
    imax = own ? ri[GEN_WARPS + lane] : n;
    for (int o = GEN_WARPS / 2; o > 0; o >>= 1) {
        const T v2 = __shfl_down_sync(FULL_MASK, vmin, o);
        const int i2 = __shfl_down_sync(FULL_MASK, imin, o);
        if (ext_better(v2, i2, vmin, imin, false, n)) { vmin = v2; imin = i2; }
        const T u2 = __shfl_down_sync(FULL_MASK, vmax, o);
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
// thread's run from registers. The output's places and the constant are
// read from the tape after the scan's barrier, so that they are not held
// in registers across it beside the run (K7's register cap).
__device__ __forceinline__ void op_pole_zero(const GenParams& P, Row& R,
                                             int k, const int* in,
                                             const int* out, const int* ip) {
    const float* x = plane(P, in[0]);
    const int n = plen(P, in[0]);
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
        float* o = plane(P, out[0]);
        float* g = esc_plane(P, R, out[0]);
        const double omc = tape_dp(P)[k * OP_DP];
        int i0, i1;  // the run's place again (j0, j1), not held across the scan
        scan_run(plen(P, in[0]), i0, i1);
        const int m = i1 - i0;
        const bool vec = m == GEN_RUN &&
            ((reinterpret_cast<uintptr_t>(o + i0) |
              reinterpret_cast<uintptr_t>(g)) & 15) == 0;
#pragma unroll
        for (int c = 0; c < GEN_RUN / 4; ++c) {
            float y[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int q = 4 * c + u;
                y[u] = bad ? qnan : __fadd_rn(r[q], (float)(omc * s));
                if (q < m) {
                    s += (double)r[q];
                    h |= nan_inf(y[u]);
                }
            }
            if (vec) {
                const float4 v = make_float4(y[0], y[1], y[2], y[3]);
                reinterpret_cast<float4*>(o + i0)[c] = v;
                if (g) __stcs(reinterpret_cast<float4*>(g + i0) + c, v);
            } else {
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    if (4 * c + u < m) {
                        o[i0 + 4 * c + u] = y[u];
                        if (g) g[i0 + 4 * c + u] = y[u];
                    }
            }
        }
    } else {
        double run = 0.0;
        for (int j = j0; j < j1; ++j) run += (double)x[j];
        double s = gen_excl_scan(R, run);
        float* o = plane(P, out[0]);
        float* g = esc_plane(P, R, out[0]);
        const double omc = tape_dp(P)[k * OP_DP];
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

// double_pole_zero's numerator after its integrator, from the prefix S:
// z = S[j] - k1 S[j-1] + k2 S[j-2] in float64, rounded to float32 (each
// operation rounded once, as the unfused body rounds it).
__device__ __forceinline__ float dpz_z(double s, double s1, double s2, double k1,
                                       double k2) {
    return (float)__dadd_rn(__dsub_rn(s, __dmul_rn(k1, s1)), __dmul_rn(k2, s2));
}

// The exclusive scan of one affine map y -> m y + e per thread, in thread
// order, composed left to right ((m1, e1) then (m2, e2) is (m1 m2,
// m2 e1 + e2), each product and sum rounded once); returns the e of the
// maps before this thread's, i.e. the value y reaches from y = 0. Lanes by
// Hillis-Steele, then each warp folds the warps before it in order from
// one reduction buffer, which it reads after the barrier. Called by every
// thread. _numerics.iir_first_order_runs is this order in PyTorch.
__device__ __forceinline__ double gen_affine_excl(Row& R, double m, double e) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    for (int o = 1; o < 32; o <<= 1) {
        const double m2 = __shfl_up_sync(FULL_MASK, m, o);
        const double e2 = __shfl_up_sync(FULL_MASK, e, o);
        if (lane >= o) {
            e = __dadd_rn(__dmul_rn(m, e2), e);
            m = __dmul_rn(m2, m);
        }
    }
    double mx = __shfl_up_sync(FULL_MASK, m, 1);
    double ex = __shfl_up_sync(FULL_MASK, e, 1);
    if (lane == 0) {
        mx = 1.0;
        ex = 0.0;
    }
    double* red = gen_red[R.rb];
    R.rb ^= 1;
    if (lane == 31) {
        red[wid] = m;
        red[GEN_WARPS + wid] = e;
    }
    __syncthreads();
    if (wid == 0) return ex;
    double am = red[0], ae = red[GEN_WARPS];
    for (int l = 1; l < wid; ++l) {
        const double bm = red[l], be = red[GEN_WARPS + l];
        ae = __dadd_rn(__dmul_rn(bm, ae), be);
        am = __dmul_rn(am, bm);
    }
    return __dadd_rn(__dmul_rn(mx, ae), ex);
}

// double_pole_zero (pole_zero.py's body, the JAX package's :63): z, the
// numerator's prefix, from the row's inclusive float64 prefix S (scan_run's
// runs and scan tree, as pole_zero's; S[j0 - 2] is S[j0 - 1] - x[j0 - 1],
// exact where the prefix is), rounded to float32; the pole y[i] = p y[i-1]
// + z[i] by runs: each thread's run from 0 in float64 into the scratch, the
// runs' maps (p^len, y_end) scanned by gen_affine_excl, then each sample
// plus p^(k+1) times its run's carry (the products p^k taken one factor at
// a time); y rounded to float32, less alpha (1 - p^i) with alpha = x[0] ke
// / kd, in float32. This is _numerics.iir_first_order_runs' order, which
// the tape's plain walk takes (pole_zero.double_pole_zero_runs): it differs
// from the sequential recurrence of double_pole_zero alone by rounding
// only. The tape's doubles hold p, k1 = a+b and k2 = ab; the taps hold
// ke = 1-a+frac(a-b), kd = 1-p and p^i (ip[0] their offset); ip[1] marks a
// NaN parameter. It reads a neighbour's sample before its first barrier
// (the plan puts a barrier before it), writes the scratch after it, and
// reads x[0] and its last reduction buffer after its last.
__device__ __forceinline__ void op_dpz(const GenParams& P, Row& R, int k,
                                       const int* in, const int* out,
                                       const int* ip) {
    const float* x = plane(P, in[0]);
    float* o = plane(P, out[0]);
    float* g = esc_plane(P, R, out[0]);
    const int n = plen(P, in[0]);
    const double* dp = tape_dp(P) + k * OP_DP;
    const double p = dp[0], k1 = dp[1], k2 = dp[2];
    const float* tab = P.taps + ip[0];
    const bool bad = plane_nan(P, in[0], false) || ip[1];
    double* vs = scratch_of(P);
    int j0, j1;
    scan_run(n, j0, j1);
    double run = 0.0;
    for (int j = j0; j < j1; ++j) run += (double)x[j];
    double s1 = gen_excl_scan(R, run);
    double s2 = j0 >= 1 ? s1 - (double)x[j0 - 1] : 0.0;
    double v = 0.0, m = 1.0;
    for (int j = j0; j < j1; ++j) {
        const double s = s1 + (double)x[j];
        const float z = dpz_z(s, s1, s2, k1, k2);
        v = __dadd_rn(__dmul_rn(p, v), (double)z);
        m = __dmul_rn(m, p);
        vs[j] = v;
        s2 = s1;
        s1 = s;
    }
    const double c = gen_affine_excl(R, m, v);
    const float alpha = __fdiv_rn(__fmul_rn(x[0], tab[0]), tab[1]);
    const float* pw = tab + 2;
    const float qnan = __int_as_float(0x7fc00000);
    double pk = p;
    int h = 0;
    for (int j = j0; j < j1; ++j) {
        const float y = (float)__dadd_rn(vs[j], __dmul_rn(pk, c));
        pk = __dmul_rn(pk, p);
        const float val = bad ? qnan
                              : __fsub_rn(y, __fmul_rn(alpha, __fsub_rn(1.f, pw[j])));
        o[j] = val;
        if (g) g[j] = val;
        h |= nan_inf(val);
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

// amax: block_max's tree, behind one barrier, over float or double samples.
template <typename T>
__device__ __forceinline__ void op_amax(const GenParams& P, Row& R,
                                        const int* in, const int* out) {
    const T* x = plane_of<T>(P, in[0]);
    const int n = plen(P, in[0]);
    const bool bad = plane_nan<T>(P, in[0], false);
    const int tid = threadIdx.x;
    T mx = -INFINITY;
#pragma unroll 4
    for (int i = tid; i < n; i += GEN_THREADS) mx = gen_max(mx, x[i]);
    for (int o = 16; o > 0; o >>= 1)
        mx = gen_max(mx, __shfl_down_sync(FULL_MASK, mx, o));
    T* rf = red_vals<T>(R.rb);
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
template <typename T, bool REFLECT, typename X>
__device__ __forceinline__ T conv_sample(const X* x, int q, int n) {
    if (REFLECT) return (T)x[reflect_at(q, n)];
    return q >= 0 && q < n ? (T)x[q] : (T)0;
}

// out[j] = sum_k taps[k] * x[lo + j - k] for j < p, summed as
// _conv_full_direct sums it; x read through the reflect index map
// (REFLECT, reflected_convolve_wf: lo = (m - 1) / 2, p = n) or as zero
// outside the row (convolve_wf's direct route: its mode's window); x of
// type X, float or (a float64 row, with float64 taps) double.
template <typename T, bool REFLECT, typename X = float>
__device__ __forceinline__ int direct_conv_row(const X* x, int n, const T* ks,
                                               int m, int lo, int p, bool bad,
                                               T* o, T* g) {
    int h = 0;
    for (int j = threadIdx.x; j < p; j += GEN_THREADS) {
        T acc = (T)__int_as_float(0x7fc00000);
        if (!bad) {
            acc = rn_mul(__ldg(ks + m - 1), conv_sample<T, REFLECT>(x, lo + j - (m - 1), n));
            for (int k = m - 2; k >= 0; --k)
                acc = rn_add(acc, rn_mul(__ldg(ks + k), conv_sample<T, REFLECT>(x, lo + j - k, n)));
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
    const int m = ip[1], d = (m - 1) / 2;
    const int h = sf(P, out[0], S_TYPE) == T_F64
        ? direct_conv_row<double, true>(x, n, reinterpret_cast<const double*>(P.taps + ip[0]),
                                        m, d, n, bad, plane_of<double>(P, out[0]),
                                        esc_of<double>(P, R, out[0]))
        : direct_conv_row<float, true>(x, n, P.taps + ip[0], m, d, n, bad, plane(P, out[0]),
                                       esc_plane(P, R, out[0]));
    flag_plane(P, out[0], h);
}

// The same on a float64 program's row (the float64 kernel, behind
// outlined_op64): a float64 plane read in place through the reflect map,
// float64 taps, each product and sum rounded once in _conv_full_direct's
// order, as the float form does with the float32 row widened.
__device__ __forceinline__ void op_reflected_conv64(const GenParams& P,
                                                    const Row& R, const int* in,
                                                    const int* out,
                                                    const int* ip) {
    const int m = ip[1], n = plen(P, in[0]);
    const int h = direct_conv_row<double, true, double>(
        plane_of<double>(P, in[0]), n, reinterpret_cast<const double*>(P.taps + ip[0]), m,
        (m - 1) / 2, n, plane_nan<double>(P, in[0], false), plane_of<double>(P, out[0]),
        esc_of<double>(P, R, out[0]));
    flag_plane(P, out[0], h);
}

// bl_subtract, windower, avg_current and soft_pileup's second op: one pass
// over the output.
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
    } else if (code == OP_SOFT_PILEUP_OUT) {
        // soft_pileup's second op: x - (A e + B) in float64, e from the
        // taps (ip[2]), A and B the fit's scalars; NaN where the row, A or
        // B is (a NaN b_in, or a NaN tau's NaN sums)
        const double* e = reinterpret_cast<const double*>(P.taps + ip[2]);
        const double a = operand(P, k, 1, 0), b = operand(P, k, 2, 0);
        const bool bad = plane_nan(P, in[0], false) || isnan(a) || isnan(b);
        for (int i = tid; i < m; i += GEN_THREADS) {
            const float v = bad ? qnan
                : (float)__dsub_rn((double)x[i], __dadd_rn(__dmul_rn(a, __ldg(e + i)), b));
            o[i] = v;
            if (g) g[i] = v;
            h |= nan_inf(v);
        }
    } else if (sf(P, out[0], S_TYPE) == T_F64) {  // OP_AVG_CURRENT, float64 planes
        const int L = ip[0];
        const double lf = tape_dp(P)[k * OP_DP];
        const bool bad = plane_nan(P, in[0], false);
        const double* xd = plane_of<double>(P, in[0]);
        double* od = plane_of<double>(P, out[0]);
        double* gd = esc_of<double>(P, R, out[0]);
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

// poly_diff / poly_exp_rms (ip[0] = 1): the polynomial of the per-row
// parameter plane in[1] (ip[1] coefficients) at each sample as the JAX
// package's einsum takes it, p0 then one FMA a higher term i^k p_k (i^k by
// float32 products), its exponential with ip[0] (in float64, rounded to
// float32, as the plain version takes it); the residual r = x - p,
// and the float64 sums of RN(r / (i+1)) and RN(r * r), behind one barrier.
// Thread 0 stores sum(r/(i+1)) and sqrt(sum(r*r) / (n-1)), each rounded
// once. It reads the coefficients that other threads loaded (the plan puts
// a barrier before it).
__device__ __forceinline__ void op_poly_resid(const GenParams& P, Row& R,
                                              const int* in, const int* out,
                                              const int* ip) {
    const float* x = plane(P, in[0]);
    const int n = plen(P, in[0]);
    const int m = ip[1];
    const float* pars = plane(P, in[1]);
    const bool bad = plane_nan(P, in[0], false) || plane_nan(P, in[1], false);
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    double s1 = 0.0, s2 = 0.0;
    for (int i = tid; i < n; i += GEN_THREADS) {
        const float fi = (float)i;
        float p = pars[0], ik = 1.f;
        for (int q = 1; q < m; ++q) {
            ik = __fmul_rn(ik, fi);
            p = __fmaf_rn(ik, pars[q], p);
        }
        if (ip[0]) p = (float)exp((double)p);
        const float r = __fsub_rn(x[i], p);
        s1 += (double)__fmul_rn(r, __fdiv_rn(1.f, (float)(i + 1)));
        s2 += (double)__fmul_rn(r, r);
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    double* red = gen_red[R.rb];
    R.rb ^= 1;
    if (lane == 0) {
        red[wid] = s1;
        red[GEN_WARPS + wid] = s2;
    }
    __syncthreads();
    if (tid != 0) return;
    s1 = replay_sum(red);
    s2 = replay_sum(red + GEN_WARPS);
    const double dnan = __longlong_as_double(0x7ff8000000000000LL);
    put(P, R, out[0], bad ? dnan : (double)(float)s1);
    put(P, R, out[1], bad ? dnan : (double)(float)sqrt(s2 / (double)(n - 1)));
}

// soft_pileup_corr(_bl) (soft_pileup_corr.py's body) with a constant tau,
// as two ops. This one, the fit: e_i = exp(-i / tau) in float64 from the
// taps (ip[2] their offset, pairs of words) and the fit's sums that depend
// on tau alone, sum e and sum e*e over the first ip[0] samples (the tape's
// doubles), all made on the host as the plain version makes them; sum e*x
// and sum x from each thread's partial sums, reduced by warps into one
// reduction buffer behind one barrier; thread 0 replays the two, solves for
// B (or takes b_in, ip[1]: operand 1) and A in float64 and stores both in
// the op's two float64 scalars. The second op (OP_SOFT_PILEUP_OUT, in
// op_gather) writes x - (A e + B). T: the row's samples.
template <typename T>
__device__ __forceinline__ void op_soft_pileup(const GenParams& P, Row& R, int k,
                                               const int* in, const int* out,
                                               const int* ip) {
    const T* x = plane_of<T>(P, in[0]);
    const int nf = ip[0];
    const double* e = reinterpret_cast<const double*>(P.taps + ip[2]);
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    double s4 = 0.0, s5 = 0.0;
    for (int i = tid; i < nf; i += GEN_THREADS) {
        const double v = (double)x[i];
        s4 += __dmul_rn(__ldg(e + i), v);
        s5 += v;
    }
    if constexpr (sizeof(T) == 8) {
        // on a float64 row the member's masked sums take the samples past
        // the window times 0: a NaN or an infinity there makes both NaN
        // (a finite one adds a zero, which changes no sum)
        for (int i = nf + tid; i < plen(P, in[0]); i += GEN_THREADS) {
            const double z = __dmul_rn(0.0, x[i]);
            s4 += z;
            s5 += z;
        }
    }
    s4 = warp_sum(s4);
    s5 = warp_sum(s5);
    double* red = gen_red[R.rb];
    R.rb ^= 1;
    if (lane == 0) {
        red[wid] = s4;
        red[GEN_WARPS + wid] = s5;
    }
    __syncthreads();
    if (tid != 0) return;
    s4 = replay_sum(red);
    s5 = replay_sum(red + GEN_WARPS);
    const double s1 = (double)nf;
    const double s2 = tape_dp(P)[k * OP_DP], s3 = tape_dp(P)[k * OP_DP + 1];
    const double b = ip[1] ? operand(P, k, 1, ip[7])
        : __ddiv_rn(__dsub_rn(s5, __ddiv_rn(
                        __dmul_rn(s2, __dsub_rn(__dmul_rn(s4, s1), __dmul_rn(s2, s5))),
                        __dsub_rn(__dmul_rn(s3, s1), __dmul_rn(s2, s2)))), s1);
    put(P, R, out[0], __ddiv_rn(__dsub_rn(s4, __dmul_rn(b, s2)), s3));
    put(P, R, out[1], b);
}

// wf_correction: x[i] - c[i - start] over [ip[0], ip[1]), x elsewhere; c
// the constant correction in the taps in the row's type T (ip[2] its
// offset; float64 values as pairs of words from an even one), ip[3]
// marking a NaN in it. One pass over the output.
template <typename T>
__device__ __forceinline__ void op_wf_correction(const GenParams& P, const Row& R,
                                                 const int* in, const int* out,
                                                 const int* ip) {
    const T* x = plane_of<T>(P, in[0]);
    T* o = plane_of<T>(P, out[0]);
    T* g = esc_of<T>(P, R, out[0]);
    const int n = plen(P, in[0]), start = ip[0], stop = ip[1];
    const T* c = reinterpret_cast<const T*>(P.taps + ip[2]);
    const bool bad = plane_nan<T>(P, in[0], false) || ip[3];
    const T qnan = __int_as_float(0x7fc00000);
    int h = 0;
    for (int i = threadIdx.x; i < n; i += GEN_THREADS) {
        const T v = bad ? qnan
            : (i >= start && i < stop) ? rn_sub(x[i], __ldg(c + i - start)) : x[i];
        o[i] = v;
        if (g) g[i] = v;
        h |= nan_inf(v);
    }
    flag_plane(P, out[0], h);
}

// get_wf_centroid: the row's first-occurrence minimum and maximum
// (min_max's candidates, behind one barrier; every thread then folds the
// warps' candidates in order), then the first positive and the last
// negative sample in [imin, imax) (int reductions behind a second barrier);
// thread 0 stores rint of their midpoint plus the shift: in float32 where
// the shift is float32 (bit 1 of ip[7]), else float64. T: the row's
// samples.
template <typename T>
__device__ __forceinline__ void op_wf_centroid(const GenParams& P, Row& R, int k,
                                               const int* in, const int* out,
                                               const int* ip) {
    const T* x = plane_of<T>(P, in[0]);
    const int n = plen(P, in[0]);
    const double sh = operand(P, k, 1, ip[7]);
    const bool sh32 = (ip[7] >> 1) & 1;
    const bool bad = plane_nan<T>(P, in[0], false) || isnan(sh);
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    T vmin = 0, vmax = 0;
    int imin = n, imax = n;
    for (int i = tid; i < n; i += GEN_THREADS) {
        const T v = x[i];
        if (imin == n || v < vmin) { vmin = v; imin = i; }
        if (imax == n || v > vmax) { vmax = v; imax = i; }
    }
    for (int o = 16; o > 0; o >>= 1) {
        const T v2 = __shfl_down_sync(FULL_MASK, vmin, o);
        const int i2 = __shfl_down_sync(FULL_MASK, imin, o);
        if (ext_better(v2, i2, vmin, imin, false, n)) { vmin = v2; imin = i2; }
        const T u2 = __shfl_down_sync(FULL_MASK, vmax, o);
        const int j2 = __shfl_down_sync(FULL_MASK, imax, o);
        if (ext_better(u2, j2, vmax, imax, true, n)) { vmax = u2; imax = j2; }
    }
    T* rf = red_vals<T>(R.rb);
    int* ri = gen_redi[R.rb];
    R.rb ^= 1;
    if (lane == 0) {
        rf[wid] = vmin;
        ri[wid] = imin;
        rf[GEN_WARPS + wid] = vmax;
        ri[GEN_WARPS + wid] = imax;
    }
    __syncthreads();
    vmin = rf[0];
    imin = ri[0];
    vmax = rf[GEN_WARPS];
    imax = ri[GEN_WARPS];
#pragma unroll
    for (int w = 1; w < GEN_WARPS; ++w) {
        if (ext_better(rf[w], ri[w], vmin, imin, false, n)) { vmin = rf[w]; imin = ri[w]; }
        if (ext_better(rf[GEN_WARPS + w], ri[GEN_WARPS + w], vmax, imax, true, n)) {
            vmax = rf[GEN_WARPS + w];
            imax = ri[GEN_WARPS + w];
        }
    }
    int first_pos = n, last_neg = -1;
    for (int i = imin + tid; i < imax; i += GEN_THREADS) {
        const T v = x[i];
        if (v > (T)0 && first_pos == n) first_pos = i;
        if (v < (T)0) last_neg = i;
    }
    first_pos = __reduce_min_sync(FULL_MASK, first_pos);
    last_neg = __reduce_max_sync(FULL_MASK, last_neg);
    int* r2 = gen_redi[R.rb];
    R.rb ^= 1;
    if (lane == 0) {
        r2[wid] = first_pos;
        r2[GEN_WARPS + wid] = last_neg;
    }
    __syncthreads();
    if (tid != 0) return;
    for (int w = 0; w < GEN_WARPS; ++w) {
        first_pos = min(first_pos, r2[w]);
        last_neg = max(last_neg, r2[GEN_WARPS + w]);
    }
    double v = __longlong_as_double(0x7ff8000000000000LL);
    if (!bad && first_pos < n && last_neg >= 0) {
        if (sh32) {
            const float s = (float)sh;
            v = (double)rintf(__fdiv_rn(__fadd_rn(__fadd_rn((float)first_pos, s),
                                                  __fadd_rn((float)last_neg, s)), 2.f));
        } else {
            v = rint(__ddiv_rn(__dadd_rn(__dadd_rn((double)first_pos, sh),
                                         __dadd_rn((double)last_neg, sh)), 2.0));
        }
    }
    put(P, R, out[0], v);
}

// The pulse of inject kind KIND at sample t, in float32 with each operation
// rounded once in the member kernel's order; dt = t - t0, rise = 4 ln 99 /
// rt. Parameters: sig and exp (t0, rt, a, decay); gumbel (a, t0, beta);
// logistic (a, t0, rt, q, v, decay).
template <int KIND>
__device__ __forceinline__ float pulse_at(float t, float dt, float t0, float rise,
                                          const float* p) {
    if (KIND == 0) {
        const float arg = __fmul_rn(-rise, __fsub_rn(t, __fadd_rn(t0, __fmul_rn(p[1], 0.5f))));
        return __fmul_rn(__fdiv_rn(p[2], __fadd_rn(1.f, expf(arg))),
                         expf(__fdiv_rn(-dt, p[3])));
    }
    if (KIND == 1) {
        const float tail = expf(__fdiv_rn(-dt, p[3]));
        const float end = __fadd_rn(t0, p[1]);
        if (t <= t0 && t <= end)
            return __fmul_rn(__fmul_rn(p[2], expf(__fdiv_rn(__fsub_rn(dt, p[1]), p[1]))),
                             tail);
        return t > end ? __fmul_rn(p[2], tail) : 0.f;
    }
    if (KIND == 2) {
        const float b = p[2];
        const float mu = __fadd_rn(t0, __fmul_rn(2.f, b));
        if (!(t >= t0 && t < __fadd_rn(mu, __fmul_rn(8.f, b)))) return 0.f;
        const float z = __fdiv_rn(__fsub_rn(t, mu), b);
        return __fmul_rn(__fdiv_rn(p[0], b), expf(-__fadd_rn(z, expf(-z))));
    }
    const float arg = __fmul_rn(-rise, __fsub_rn(dt, __fmul_rn(p[2], 0.5f)));
    const float base = __fadd_rn(1.f, __fmul_rn(p[3], expf(arg)));
    return __fmul_rn(__fdiv_rn(p[0], powf(base, __fdiv_rn(1.f, p[4]))),
                     expf(__fdiv_rn(-dt, p[5])));
}

// One pass of inject kind KIND over the row: x + pulse, NaN where `bad`;
// the output's flag bits.
template <int KIND>
__device__ __forceinline__ int inject_row(const float* x, float* o, float* g, int n,
                                          bool bad, const float* p, float lg) {
    const float t0 = KIND >= 2 ? p[1] : p[0];
    const float rise = KIND == 0 ? __fdiv_rn(lg, p[1]) : KIND == 3 ? __fdiv_rn(lg, p[2]) : 0.f;
    const float qnan = __int_as_float(0x7fc00000);
    int h = 0;
    for (int i = threadIdx.x; i < n; i += GEN_THREADS) {
        const float t = (float)i;
        const float y = bad ? qnan
            : __fadd_rn(x[i], pulse_at<KIND>(t, __fsub_rn(t, t0), t0, rise, p));
        o[i] = y;
        if (g) g[i] = y;
        h |= nan_inf(y);
    }
    return h;
}

// inject_sig_pulse, inject_exp_pulse, inject_gumbel,
// inject_general_logistic (pulse_injector.py): x + pulse(t), t the sample
// index, in float32 with each operation rounded once in the member kernel's
// order (pulse_at). ip[0] the kind (the order above), ip[1] the taps' offset
// of the six constant parameters (the function's own order, in float32),
// ip[2] a bit for each parameter given one a row instead (operands 1.. in
// order, rounded to float32: ip[7]); the tape's double 0 is 4 ln 99. A NaN
// in the row or in a parameter gives a NaN row. One pass over the output,
// one loop a kind.
__device__ __forceinline__ void op_inject(const GenParams& P, const Row& R, int k,
                                          const int* in, const int* out,
                                          const int* ip) {
    const float* x = plane(P, in[0]);
    float* o = plane(P, out[0]);
    float* g = esc_plane(P, R, out[0]);
    const int n = plen(P, in[0]);
    float p[6];
    bool bad = plane_nan(P, in[0], false);
#pragma unroll
    for (int q = 0, j = 1; q < 6; ++q) {
        p[q] = ((ip[2] >> q) & 1) ? (float)operand(P, k, j++, ip[7])
                                  : __ldg(P.taps + ip[1] + q);
        bad |= isnan(p[q]);
    }
    const float lg = (float)tape_dp(P)[k * OP_DP];
    int h;
    switch (ip[0]) {
    case 0: h = inject_row<0>(x, o, g, n, bad, p, lg); break;
    case 1: h = inject_row<1>(x, o, g, n, bad, p, lg); break;
    case 2: h = inject_row<2>(x, o, g, n, bad, p, lg); break;
    default: h = inject_row<3>(x, o, g, n, bad, p, lg); break;
    }
    flag_plane(P, out[0], h);
}

// ml.py's activations (its _activate), in float32: 's' sigmoid, 'r' ReLU
// and 'l' leaky ReLU as selects (a NaN gives 0), 'm' softplus as
// log1p(exp(t)), 't' tanh.
__device__ __forceinline__ float activate(float t, int flag) {
    const float pos = t > 0.f ? t : 0.f;
    switch (flag) {
    case 's': return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-t)));
    case 'r': return pos;
    case 'l': return __fadd_rn(pos, t < 0.f ? __fmul_rn((float)0.01, t) : 0.f);
    case 'm': return log1pf(expf(t));
    default: return tanhf(t);
    }
}

// normalisation_layer, dense_layer_*, classification_layer_* (ml.py). ip[0]
// the kind: 0, the normalisation (x - mean) / sqrt(var) elementwise, ip[2]
// and ip[3] the taps' offsets of the means and the variances; 1, a dense
// layer into an (m) plane (m = ip[5]), the weights (n, m) row-major at
// ip[2], the bias at ip[3] (or -1); 2, a classification into a scalar, the
// weights (n) at ip[2], the bias operand 1 where ip[6] (rounded to float32:
// ip[7]). ip[1] the activation. A product: warp w sums the products of
// the inputs [w c, (w + 1) c), c = ceil(n / 8), in order in float64 (each
// exact), lane j for outputs j, j + 32, ...; the partial sums meet in the
// scratch behind one barrier, and output j adds them in warp order, rounds
// to float32, adds the bias and activates (ml.layer_rows' order). The
// weights (8 KB to 32 KB and more) are read from device memory through L2
// by every row's block, not staged. A NaN row gives NaN outputs.
__device__ __forceinline__ void op_dense(const GenParams& P, const Row& R, int k,
                                         const int* in, const int* out,
                                         const int* ip) {
    const float* x = plane(P, in[0]);
    const int n = plen(P, in[0]);
    const bool bad = plane_nan(P, in[0], false);
    const float qnan = __int_as_float(0x7fc00000);
    const int tid = threadIdx.x;
    if (ip[0] == 0) {
        float* o = plane(P, out[0]);
        float* g = esc_plane(P, R, out[0]);
        const float* mu = P.taps + ip[2];
        const float* var = P.taps + ip[3];
        int h = 0;
        for (int i = tid; i < n; i += GEN_THREADS) {
            const float v = bad ? qnan
                : __fdiv_rn(__fsub_rn(x[i], __ldg(mu + i)), sqrtf(__ldg(var + i)));
            o[i] = v;
            if (g) g[i] = v;
            h |= nan_inf(v);
        }
        flag_plane(P, out[0], h);
        return;
    }
    const int m = ip[5];
    const float* wt = P.taps + ip[2];
    double* part = scratch_of(P);
    const int lane = tid & 31, wid = tid >> 5;
    const int c = (n + GEN_WARPS - 1) / GEN_WARPS;
    const int i0 = wid * c, i1 = min(n, i0 + c);
    for (int j = lane; j < m; j += 32) {
        double acc = 0.0;
        for (int i = i0; i < i1; ++i)
            acc = __dadd_rn(acc, __dmul_rn((double)x[i], (double)__ldg(wt + i * m + j)));
        part[wid * m + j] = acc;
    }
    __syncthreads();
    // output j: the warps' sums in order, the bias, the activation; a
    // classification's one output by thread 0 into its scalar
    float* o = ip[0] == 1 ? plane(P, out[0]) : nullptr;
    float* g = ip[0] == 1 ? esc_plane(P, R, out[0]) : nullptr;
    int h = 0;
    for (int j = tid; j < m; j += GEN_THREADS) {
        double s = 0.0;
#pragma unroll
        for (int q = 0; q < GEN_WARPS; ++q) s = __dadd_rn(s, part[q * m + j]);
        float t = (float)s;
        if (ip[3] >= 0) t = __fadd_rn(t, __ldg(P.taps + ip[3] + j));
        if (ip[6]) t = __fadd_rn(t, (float)operand(P, k, 1, ip[7]));
        const float v = bad ? qnan : activate(t, ip[1]);
        if (o) {
            o[j] = v;
            if (g) g[j] = v;
            h |= nan_inf(v);
        } else {
            put(P, R, out[0], (double)v);
        }
    }
    if (o) flag_plane(P, out[0], h);
}

// ---------------------------------------------------------------------------
// slice 19's ops: reductions, a prefix pick-off, and passes over a plane

// mean_below_threshold: the samples below a (operand 1, in the row's type)
// summed in float64 by each thread from 0.0 (samples t, t + 256, ...), the
// warps' sums by warp_sum and their counts, into one reduction buffer
// behind one barrier; thread 0 replays the sums (replay_sum:
// _numerics.k7_sum's order) and stores their mean, divided in float64 and
// rounded once; NaN where no sample is below, or where the row or a is NaN.
// T: the row's samples.
template <typename T>
__device__ __forceinline__ void op_mean_below(const GenParams& P, Row& R, int k,
                                              const int* in, const int* out,
                                              const int* ip) {
    const T* x = plane_of<T>(P, in[0]);
    const int n = plen(P, in[0]);
    const double thr = operand(P, k, 1, ip[7]);
    const bool bad = plane_nan<T>(P, in[0], false) || isnan(thr);
    const T a = (T)thr;
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    double s = 0.0;
    int c = 0;
    for (int i = tid; i < n; i += GEN_THREADS) {
        const T v = x[i];
        if (v < a) {
            s += (double)v;
            ++c;
        }
    }
    s = warp_sum(s);
    c = __reduce_add_sync(FULL_MASK, c);
    double* red = gen_red[R.rb];
    R.rb ^= 1;
    if (lane == 0) {
        red[wid] = s;
        red[GEN_WARPS + wid] = (double)c;
    }
    __syncthreads();
    if (tid != 0) return;
    double cnt = 0.0;
#pragma unroll
    for (int w = 0; w < GEN_WARPS; ++w) cnt += red[GEN_WARPS + w];
    const double tot = replay_sum(red);
    put(P, R, out[0], bad || cnt == 0.0 ? __longlong_as_double(0x7ff8000000000000LL)
                                        : __ddiv_rn(tot, cnt));
}

// time_over_threshold (ip[0] = 0: the samples above operand 1) and
// saturation (ip[0] = 1: the samples at 0 and at the high rail, the tape's
// double 0), each compared in the row's type: integer counts by warps into
// one reduction buffer behind one barrier; thread 0 stores them, NaN where
// the row (or the threshold) is NaN. T: the row's samples.
template <typename T>
__device__ __forceinline__ void op_count(const GenParams& P, Row& R, int k,
                                         const int* in, const int* out,
                                         const int* ip) {
    const T* x = plane_of<T>(P, in[0]);
    const int n = plen(P, in[0]);
    const bool sat = ip[0] == 1;
    const double thr = sat ? tape_dp(P)[k * OP_DP] : operand(P, k, 1, ip[7]);
    const bool bad = plane_nan<T>(P, in[0], false) || isnan(thr);
    const T a = (T)thr;
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    int c0 = 0, c1 = 0;
    for (int i = tid; i < n; i += GEN_THREADS) {
        const T v = x[i];
        c0 += sat ? v == (T)0 : v > a;
        c1 += v == a;
    }
    c0 = __reduce_add_sync(FULL_MASK, c0);
    c1 = __reduce_add_sync(FULL_MASK, c1);
    int* ri = gen_redi[R.rb];
    R.rb ^= 1;
    if (lane == 0) {
        ri[wid] = c0;
        ri[GEN_WARPS + wid] = c1;
    }
    __syncthreads();
    if (tid != 0) return;
    int t0 = 0, t1 = 0;
#pragma unroll
    for (int w = 0; w < GEN_WARPS; ++w) {
        t0 += ri[w];
        t1 += ri[GEN_WARPS + w];
    }
    const double dnan = __longlong_as_double(0x7ff8000000000000LL);
    put(P, R, out[0], bad ? dnan : (double)t0);
    if (sat) put(P, R, out[1], bad ? dnan : (double)t1);
}

// linear_slope_diff: the residual r = x - (slope i + intercept) in float64
// (operands 1 and 2, each product and sum rounded once), the sums of
// r / (i + 1) and r * r as op_mean_below sums, behind one barrier; thread 0
// stores the first and sqrt(second / (n - 1)) (0 for one sample). T: the
// row's samples.
template <typename T>
__device__ __forceinline__ void op_slope_diff(const GenParams& P, Row& R, int k,
                                              const int* in, const int* out,
                                              const int* ip) {
    const T* x = plane_of<T>(P, in[0]);
    const int n = plen(P, in[0]);
    const double sl = operand(P, k, 1, ip[7]), b = operand(P, k, 2, ip[7]);
    const bool bad = plane_nan<T>(P, in[0], false) || isnan(sl) || isnan(b);
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    double s1 = 0.0, s2 = 0.0;
    for (int i = tid; i < n; i += GEN_THREADS) {
        const double fi = (double)i;
        const double r = __dsub_rn((double)x[i], __dadd_rn(__dmul_rn(sl, fi), b));
        s1 += __dmul_rn(r, __ddiv_rn(1.0, __dadd_rn(fi, 1.0)));
        s2 += __dmul_rn(r, r);
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    double* red = gen_red[R.rb];
    R.rb ^= 1;
    if (lane == 0) {
        red[wid] = s1;
        red[GEN_WARPS + wid] = s2;
    }
    __syncthreads();
    if (tid != 0) return;
    s1 = replay_sum(red);
    s2 = replay_sum(red + GEN_WARPS);
    const double dnan = __longlong_as_double(0x7ff8000000000000LL);
    put(P, R, out[0], bad ? dnan : s1);
    put(P, R, out[1], bad ? dnan : n > 1 ? sqrt(__ddiv_rn(s2, (double)(n - 1))) : 0.0);
}

// log_check: whether any sample is <= 0 (__syncthreads_or, a barrier), then
// the log of each sample in float64, rounded once to the row's type T; a
// NaN row where one is, or where the row holds a NaN.
template <typename T>
__device__ __forceinline__ void op_log_check(const GenParams& P, const Row& R,
                                             const int* in, const int* out) {
    const T* x = plane_of<T>(P, in[0]);
    T* o = plane_of<T>(P, out[0]);
    T* g = esc_of<T>(P, R, out[0]);
    const int n = plen(P, in[0]);
    const bool nan = plane_nan<T>(P, in[0], false);
    int nonpos = 0;
    for (int i = threadIdx.x; i < n; i += GEN_THREADS) nonpos |= x[i] <= (T)0;
    const bool bad = __syncthreads_or(nonpos) != 0 || nan;
    const T qnan = __int_as_float(0x7fc00000);
    int h = 0;
    for (int i = threadIdx.x; i < n; i += GEN_THREADS) {
        const T v = bad ? qnan : (T)log((double)x[i]);
        o[i] = v;
        if (g) g[i] = v;
        h |= nan_inf(v);
    }
    flag_plane(P, out[0], h);
}

// trap_pickoff: the row's float64 prefix (gen_prefix, _numerics.k7_prefix's
// order) into the scratch; thread 0 takes the trapezoid (rise ip[0], flat
// ip[1]) at t = operand 1 from it: (sum x[t+1-rise, t+1) - sum x[t+1-2 rise
// -flat, t+1-rise-flat)) / rise, each window a prefix difference; NaN where
// t is NaN or not an integer, the windows do not fit, or the row is NaN.
// T: the row's samples (a float64 row's prefix from shared memory,
// gen_prefix_shared, in the same order).
template <typename T>
__device__ __forceinline__ void op_trap_pickoff(const GenParams& P, Row& R, int k,
                                                const int* in, const int* out,
                                                const int* ip) {
    const T* x = plane_of<T>(P, in[0]);
    const int n = plen(P, in[0]);
    const bool nan = plane_nan<T>(P, in[0], false);
    const int pad = prefix_pad(n);
    double* ps = scratch_of(P);
    if constexpr (sizeof(T) == 4) gen_prefix(R, x, n, ps, pad);
    else gen_prefix_shared(R, x, n, ps, pad);
    if (threadIdx.x != 0) return;
    const int rise = ip[0], flat = ip[1];
    const double t = operand(P, k, 1, ip[7]);
    const double start = trunc(t) + 1.0;
    const bool bad = nan || isnan(t) || floor(t) != t
                     || !(start >= (double)(2 * rise + flat) && start <= (double)n);
    double v = __longlong_as_double(0x7ff8000000000000LL);
    if (!bad) {
        const int hi = (int)start, h2 = hi - rise - flat;
        auto at = [&](int q) { return q < 0 ? 0.0 : ps[pidx(q, pad)]; };
        const double i1 = __dsub_rn(at(hi - 1), at(hi - rise - 1));
        const double i2 = __dsub_rn(at(h2 - 1), at(h2 - rise - 1));
        v = __ddiv_rn(__dsub_rn(i1, i2), (double)rise);
    }
    put(P, R, out[0], v);
}

// presum: output j the sum of samples [j f, (j + 1) f) (f = ip[1]) added in
// turn to 0.0 in the row's type T, each divided by f first where ip[0];
// thread 0 stores f in the first output. One pass over the output; NaN
// where the row holds a NaN.
template <typename T>
__device__ __forceinline__ void op_presum(const GenParams& P, const Row& R,
                                          const int* in, const int* out,
                                          const int* ip) {
    const T* x = plane_of<T>(P, in[0]);
    T* o = plane_of<T>(P, out[1]);
    T* g = esc_of<T>(P, R, out[1]);
    const int m = plen(P, out[1]), f = ip[1];
    const bool bad = plane_nan<T>(P, in[0], false);
    const T ff = (T)f, qnan = __int_as_float(0x7fc00000);
    int h = 0;
    for (int j = threadIdx.x; j < m; j += GEN_THREADS) {
        T acc = 0;
        for (int q = 0; q < f; ++q) {
            const T v = x[j * f + q];
            acc = rn_add(acc, ip[0] ? rn_div(v, ff) : v);
        }
        const T y = bad ? qnan : acc;
        o[j] = y;
        if (g) g[j] = y;
        h |= nan_inf(y);
    }
    flag_plane(P, out[1], h);
    if (threadIdx.x == 0)
        put(P, R, out[0], bad ? __longlong_as_double(0x7ff8000000000000LL) : (double)f);
}

// min_max_norm: the row over max(|a_min|, |a_max|) (operands 1 and 2, in
// the row's type T), the row itself where either is 0; one pass, NaN where
// the row holds a NaN.
template <typename T>
__device__ __forceinline__ void op_min_max_norm(const GenParams& P, const Row& R,
                                                int k, const int* in,
                                                const int* out, const int* ip) {
    const T* x = plane_of<T>(P, in[0]);
    T* o = plane_of<T>(P, out[0]);
    T* g = esc_of<T>(P, R, out[0]);
    const int n = plen(P, in[0]);
    const bool bad = plane_nan<T>(P, in[0], false);
    const T amin = fabs((T)operand(P, k, 1, ip[7]));
    const T amax = fabs((T)operand(P, k, 2, ip[7]));
    const bool zero = amax == (T)0 || amin == (T)0;
    T d = amax >= amin ? amax : amin;
    if (d == (T)0) d = 1;
    const T qnan = __int_as_float(0x7fc00000);
    int h = 0;
    for (int i = threadIdx.x; i < n; i += GEN_THREADS) {
        const T v = bad ? qnan : zero ? x[i] : rn_div(x[i], d);
        o[i] = v;
        if (g) g[i] = v;
        h |= nan_inf(v);
    }
    flag_plane(P, out[0], h);
}

// multi_a_filter: output j the row's sample at index vt[j] (the plane in[1],
// NaN-padded), cut to int32 as the member cuts it (a NaN as 0, an infinity
// saturated); NaN where vt[j] is NaN or out of the row, or the row holds a
// NaN. One pass over the output; T the planes' type.
template <typename T>
__device__ __forceinline__ void op_multi_a(const GenParams& P, const Row& R,
                                           const int* in, const int* out) {
    const T* x = plane_of<T>(P, in[0]);
    const T* vt = plane_of<T>(P, in[1]);
    T* o = plane_of<T>(P, out[0]);
    T* g = esc_of<T>(P, R, out[0]);
    const int n = plen(P, in[0]), m = plen(P, out[0]);
    const bool bad = plane_nan<T>(P, in[0], false);
    const T qnan = __int_as_float(0x7fc00000);
    int h = 0;
    for (int j = threadIdx.x; j < m; j += GEN_THREADS) {
        const T t = vt[j];
        const int i = isnan(t) ? 0 : (int)t;
        const T v = (bad || isnan(t) || i < 0 || i >= n) ? qnan : x[i];
        o[j] = v;
        if (g) g[j] = v;
        h |= nan_inf(v);
    }
    flag_plane(P, out[0], h);
}


// ---------------------------------------------------------------------------
// the plane ops: the rest of what generic_rows takes on float32 rows

// trap_filter (the trap op's kind 2): the unnormalised trapezoid
// (S[i] - S[i - rise]) - (S[i - rise - flat] - S[i - 2 rise - flat]) from the
// row's float64 prefix (gen_prefix, _numerics.k7_prefix's order), each
// window a prefix difference, rounded once.
__device__ __forceinline__ void op_trap_sum(const GenParams& P, Row& R, const int* in,
                                            const int* out, const int* ip) {
    const float* x = plane(P, in[0]);
    const int n = plen(P, in[0]);
    const bool bad = plane_nan(P, in[0], false);
    const int pad = prefix_pad(n);
    double* ps = scratch_of(P);
    gen_prefix(R, x, n, ps, pad);
    // the output's places and the sections after the prefix's barrier, so
    // that they are not held in registers across it beside the run
    float* o = plane(P, out[0]);
    float* g = esc_plane(P, R, out[0]);
    const int rise = ip[1], flat = ip[2];
    const float qnan = __int_as_float(0x7fc00000);
    int h = 0;
    for (int i = threadIdx.x; i < n; i += GEN_THREADS) {
        const double d1 = gen_win_sum(x, ps, pad, false, i, rise, 0);
        const double d2 = gen_win_sum(x, ps, pad, false, i, rise, rise + flat);
        const float v = bad ? qnan : (float)__dsub_rn(d1, d2);
        o[i] = v;
        if (g) g[i] = v;
        h |= nan_inf(v);
    }
    flag_plane(P, out[0], h);
}

// moving_window_left (ip[0] = 0) and moving_window_right (1) of a length L
// (the tape's double 0; ip[1] = int(L)): from the row's float64 prefix S
// (gen_prefix), the member's formulas, each operation rounded once in
// float64: left (S[i] - S[i - L']) / L, over the first L' samples w0 + (S[i]
// - (i + 1) w0) / L; right (S[i + L' - 1] - S[i - 1]) / L, over the last L'
// wl + ((S[n - 1] - S[i - 1]) - (n - i) wl) / L. After the prefix's
// barrier it reads w0 = x[0] and wl = x[n - 1] (the row is not written), and
// its parameters and places, which are then not held across the barrier.
// T: the row's samples (a float64 row's prefix from shared memory,
// gen_prefix_shared, in the same order), and the output's, rounded once.
template <typename T>
__device__ __forceinline__ void op_mw(const GenParams& P, Row& R, int k, const int* in,
                                      const int* out, const int* ip) {
    const T* x = plane_of<T>(P, in[0]);
    const int n = plen(P, in[0]);
    const bool bad = plane_nan<T>(P, in[0], false);
    const int pad = prefix_pad(n);
    double* ps = scratch_of(P);
    if constexpr (sizeof(T) == 4) gen_prefix(R, x, n, ps, pad);
    else gen_prefix_shared(R, x, n, ps, pad);
    const double w0 = (double)x[0], wl = (double)x[n - 1];
    const bool right = ip[0];
    const int li = ip[1];
    const double len = tape_dp(P)[k * OP_DP];
    T* o = plane_of<T>(P, out[0]);
    T* g = esc_of<T>(P, R, out[0]);
    const T qnan = __int_as_float(0x7fc00000);
    int h = 0;
    for (int i = threadIdx.x; i < n; i += GEN_THREADS) {
        double v;
        if (!right) {
            const double s = ps[pidx(i, pad)];
            v = i < li ? __dadd_rn(w0, __ddiv_rn(__dsub_rn(s, __dmul_rn((double)(i + 1), w0)), len))
                       : __ddiv_rn(__dsub_rn(s, ps[pidx(i - li, pad)]), len);
        } else {
            const double se = i > 0 ? ps[pidx(i - 1, pad)] : 0.0;
            if (i > n - 1 - li) {
                v = __dadd_rn(wl, __ddiv_rn(__dsub_rn(__dsub_rn(ps[pidx(n - 1, pad)], se),
                                                      __dmul_rn((double)(n - i), wl)), len));
            } else {
                v = __ddiv_rn(__dsub_rn(ps[pidx(li > 0 ? i + li - 1 : i, pad)], se), len);
            }
        }
        const T y = bad ? qnan : (T)v;
        o[i] = y;
        if (g) g[i] = y;
        h |= nan_inf(y);
    }
    flag_plane(P, out[0], h);
}

// convolve_wf and fft_convolve_wf with m <= 32 taps (ip[1]; ip[0] their
// offset, in the row's type T: float64 taps in pairs of words from an even
// one): the mode's window [lo, lo + p) of the full convolution (lo = ip[2],
// p the output's length: n + m - 1 for 'f'), the direct loop of
// reflected_convolve_wf with zeros outside the row; a NaN row's outputs NaN.
template <typename T>
__device__ __forceinline__ void op_conv_direct(const GenParams& P, const Row& R,
                                               const int* in, const int* out,
                                               const int* ip) {
    const T* x = plane_of<T>(P, in[0]);
    const bool bad = plane_nan<T>(P, in[0], false);
    const int h = direct_conv_row<T, false, T>(
        x, plen(P, in[0]), reinterpret_cast<const T*>(P.taps + ip[0]), ip[1], ip[2],
        plen(P, out[0]), bad, plane_of<T>(P, out[0]), esc_of<T>(P, R, out[0]));
    flag_plane(P, out[0], h);
}

// A conversion of a plane's sample (the ewise op's kinds from EW_CONVERT):
// (x + offset_in) * ratio - offset_out in float64, rounded by kind.
__device__ __forceinline__ double convert_value(int kind, double x, double a,
                                                double b, double ratio) {
    const double v = __dsub_rn(__dmul_rn(__dadd_rn(x, a), ratio), b);
    return kind ? round_eval(kind, v) : v;
}

// ewise: an entry of the elementwise table (ip[0], ufunc_eval) or a
// conversion over the output plane's samples, each thread its samples i,
// i + 256, ...: operand q (of ip[2]) a plane (bit q of ip[3]; float32 or
// bool, read at i) or a per-row scalar or constant (operand, rounded to
// float32 by bit q of ip[7]); ip[1] the member's float32. The result is
// rounded to the output's type: the plane type T (float32, or a float64
// program's float64), or a bool (1 or 0: a bool plane holds one sample of
// type T, its stored copy one byte).
template <typename T>
__device__ __forceinline__ void op_ewise(const GenParams& P, const Row& R, int k,
                                         const int* in, const int* out, const int* ip) {
    const int kind = ip[0], f32 = ip[1], nin = ip[2];
    const T* xp[3];
    double sv[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
        const bool pl = q < nin && ((ip[3] >> q) & 1);
        xp[q] = pl ? plane_of<T>(P, in[q]) : nullptr;
        sv[q] = q < nin && !pl ? operand(P, k, q, ip[7]) : 0.0;
    }
    const double ratio = tape_dp(P)[k * OP_DP];
    const int m = plen(P, out[0]);
    const bool bo = sf(P, out[0], S_TYPE) == T_BOOL;
    T* o = plane_of<T>(P, out[0]);
    const int e = sf(P, out[0], S_ESC);
    T* g = !bo && e >= 0 ? (T*)P.esc[e] + R.row * (long long)m : nullptr;
    unsigned char* gb = bo && e >= 0 ? (unsigned char*)P.esc[e] + R.row * (long long)m
                                     : nullptr;
    int h = 0;
    for (int i = threadIdx.x; i < m; i += GEN_THREADS) {
        const double a = xp[0] ? (double)xp[0][i] : sv[0];
        const double b = xp[1] ? (double)xp[1][i] : sv[1];
        const double c = xp[2] ? (double)xp[2][i] : sv[2];
        const double v = kind >= EW_CONVERT ? convert_value(kind - EW_CONVERT, a, b, c, ratio)
                                            : ufunc_eval(kind, a, b, c, f32);
        const T y = bo ? (v != 0.0 ? (T)1 : (T)0) : (T)v;
        o[i] = y;
        if (g) g[i] = y;
        if (gb) gb[i] = (unsigned char)(y != (T)0);
        h |= nan_inf(y);
    }
    flag_plane(P, out[0], h);
}

// The numpy reductions of a row (ip[0], _tile_program.REDUCTIONS): 0 amin /
// min and 1 max (NaN where the row holds a NaN), 2 nanmin and 3 nanmax
// (NaN-skipping; NaN for a row of NaNs), the extrema exact in any order; 4
// sum, 5 mean, 6 nansum, 7 nanmean: float64 sums in K7's block order
// (op_mean_below's, _numerics.k7_sum; a NaN skipped by the nan kinds), a
// mean divided by its count in float64. The warps' values and counts meet
// in one reduction buffer behind one barrier; thread 0 stores the result,
// rounded to the output's type. A bool row reads as 0 and 1. T: the row's
// samples.
template <typename T>
__device__ __forceinline__ void op_reduce(const GenParams& P, Row& R, const int* in,
                                          const int* out, const int* ip) {
    const T* x = plane_of<T>(P, in[0]);
    const int n = plen(P, in[0]), kind = ip[0];
    const bool ext = kind <= 3;
    const bool nan = kind <= 1 && plane_nan<T>(P, in[0], false);
    const double dnan = __longlong_as_double(0x7ff8000000000000LL);
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    double s = ext ? dnan : 0.0;
    int c = 0;
    for (int i = tid; i < n; i += GEN_THREADS) {
        const double v = (double)x[i];
        if (ext) {
            s = (kind & 1) ? fmax(s, v) : fmin(s, v);
        } else if (kind < 6 || !isnan(v)) {
            s += v;
            ++c;
        }
    }
    if (ext) {
        for (int o = 16; o > 0; o >>= 1) {
            const double t = __shfl_down_sync(FULL_MASK, s, o);
            s = (kind & 1) ? fmax(s, t) : fmin(s, t);
        }
    } else {
        s = warp_sum(s);
    }
    c = __reduce_add_sync(FULL_MASK, c);
    double* red = gen_red[R.rb];
    R.rb ^= 1;
    if (lane == 0) {
        red[wid] = s;
        red[GEN_WARPS + wid] = (double)c;
    }
    __syncthreads();
    if (tid != 0) return;
    double v;
    if (ext) {
        v = red[0];
#pragma unroll
        for (int w = 1; w < GEN_WARPS; ++w)
            v = (kind & 1) ? fmax(v, red[w]) : fmin(v, red[w]);
        if (nan) v = dnan;
    } else {
        v = replay_sum(red);
        double cnt = 0.0;
#pragma unroll
        for (int w = 0; w < GEN_WARPS; ++w) cnt += red[GEN_WARPS + w];
        if (kind == 5 || kind == 7) v = __ddiv_rn(v, cnt);
    }
    put(P, R, out[0], v);
}

// ---------------------------------------------------------------------------
// the float64 forms: the ops of the float64 flagship, DPZ and extras groups
// on float64 planes (generic_rows_kernel_f64). Each is its member's
// arithmetic on a float64 row, every product, sum and quotient rounded once
// (__dmul_rn, __dadd_rn, __ddiv_rn: no contraction), in the order of the
// tape's plain walk (the member's K7-order variant, k7_plain given f64,
// where the member sums: K7's prefix _numerics.k7_prefix, its block sums
// k7_sum). The
// barriers, buffers and scratch are the float forms' (the plan's tables
// hold per opcode).

// An external float64 plane into its place by cp.async: 16 bytes (two
// samples) a lane where the row starts on 16 bytes, 8 where it does not;
// then each thread tests the samples it copied itself.
__device__ __forceinline__ void op_load64(const GenParams& P, const Row& R, int s) {
    double* x = plane_of<double>(P, s);
    const int n = plen(P, s), e = sf(P, s, S_EXT);
    const double* g = (const double*)P.ext[e] + R.row * P.ext_stride[e];
    const int tid = threadIdx.x;
    const bool vec = (reinterpret_cast<uintptr_t>(g) & 15) == 0;
    const int i0 = vec ? (n >> 1) << 1 : 0;
    for (int j = tid; 2 * j < i0; j += GEN_THREADS)
        gen_cp_async16(reinterpret_cast<float*>(x + 2 * j),
                       reinterpret_cast<const float*>(g + 2 * j));
    for (int i = i0 + tid; i < n; i += GEN_THREADS) gen_cp_async8(x + i, g + i);
    gen_cp_async_wait_all();
    int h = 0;
    for (int j = tid; 2 * j < i0; j += GEN_THREADS) h |= nan_inf(x[2 * j]) | nan_inf(x[2 * j + 1]);
    for (int i = i0 + tid; i < n; i += GEN_THREADS) h |= nan_inf(x[i]);
    flag_plane(P, s, h);
}

// bl_subtract, windower, avg_current and soft_pileup's second op on a
// float64 row: one pass over the output, as op_gather.
__device__ __forceinline__ void op_gather64(const GenParams& P, const Row& R, int k,
                                            int code, const int* in, const int* out,
                                            const int* ip) {
    const double* x = plane_of<double>(P, in[0]);
    double* o = plane_of<double>(P, out[0]);
    double* g = esc_of<double>(P, R, out[0]);
    const int nx = plen(P, in[0]), m = plen(P, out[0]);
    const double dnan = __longlong_as_double(0x7ff8000000000000LL);
    bool bad = plane_nan<double>(P, in[0], false);
    double a = 0.0, b = 0.0;  // the baseline; A and B; avg_current's length
    int ti = 0;               // the window's start; avg_current's int(length)
    const double* e = reinterpret_cast<const double*>(P.taps + ip[2]);
    if (code == OP_BL_SUB) {
        a = operand(P, k, 1, ip[7]);
        bad |= isnan(a);
    } else if (code == OP_WINDOWER) {
        const double t0 = operand(P, k, 1, ip[7]);
        bad |= isnan(t0);
        const double t = trunc(t0);
        ti = (int)(isnan(t) ? 0.0 : fmin(fmax(t, -(m + 1.0)), (double)nx));
    } else if (code == OP_SOFT_PILEUP_OUT) {
        a = operand(P, k, 1, 0);
        b = operand(P, k, 2, 0);
        bad |= isnan(a) || isnan(b);
    } else {
        a = tape_dp(P)[k * OP_DP];
        ti = ip[0];
    }
    int h = 0;
    for (int i = threadIdx.x; i < m; i += GEN_THREADS) {
        double v;
        if (code == OP_BL_SUB) {
            v = __dsub_rn(x[i], a);
        } else if (code == OP_WINDOWER) {
            const int q = ti + i;
            v = q < 0 || q >= nx ? dnan : x[q];
        } else if (code == OP_SOFT_PILEUP_OUT) {
            v = __dsub_rn(x[i], __dadd_rn(__dmul_rn(a, __ldg(e + i)), b));
        } else {
            v = i >= nx - ti ? dnan : __ddiv_rn(__dsub_rn(x[i + ti], x[i]), a);
        }
        if (bad) v = dnan;
        o[i] = v;
        if (g) g[i] = v;
        h |= nan_inf(v);
    }
    flag_plane(P, out[0], h);
}

// linear_slope_fit on a float64 row: op_slope_fit's two sums and their
// barriers; the moments and the fit in float64 as the member takes them
// (linear_slope_fit_k7), none rounded to float32.
__device__ __forceinline__ void op_slope_fit64(const GenParams& P, Row& R,
                                               const int* in, const int* out) {
    const double* x = plane_of<double>(P, in[0]);
    const bool bad = plane_nan<double>(P, in[0], false);
    const int L = plen(P, in[0]);
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    double sy = 0.0, sxy = 0.0;
    for (int j = tid; j < L; j += GEN_THREADS) {
        sy = __dadd_rn(sy, x[j]);
        sxy = __dadd_rn(sxy, __dmul_rn(x[j], (double)j));
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
    sxy = replay_sum(r1 + GEN_WARPS);
    const double Ld = (double)L;
    const double mean = __ddiv_rn(sy, Ld);
    double ss = 0.0;
    for (int j = tid; j < L; j += GEN_THREADS) {
        const double d = __dsub_rn(x[j], mean);
        ss = __dadd_rn(ss, __dmul_rn(d, d));
    }
    ss = warp_sum(ss);
    double* r2 = gen_red[R.rb];
    R.rb ^= 1;
    if (lane == 0) r2[wid] = ss;
    __syncthreads();
    if (tid != 0) return;
    ss = replay_sum(r2);
    const double var = L > 1 ? __ddiv_rn(ss, (double)(L - 1)) : 0.0;
    const double sum_x = __ddiv_rn(__dmul_rn(Ld, Ld - 1.0), 2.0);
    const double sum_x2 = __ddiv_rn(__dmul_rn(__dmul_rn(Ld - 1.0, Ld), 2.0 * Ld - 1.0), 6.0);
    const double slope = __ddiv_rn(__dsub_rn(__dmul_rn(Ld, sxy), __dmul_rn(sum_x, sy)),
                                   __dsub_rn(__dmul_rn(Ld, sum_x2), __dmul_rn(sum_x, sum_x)));
    const double dnan = __longlong_as_double(0x7ff8000000000000LL);
    put(P, R, out[0], bad ? dnan : mean);
    put(P, R, out[1], bad ? dnan : sqrt(var));
    put(P, R, out[2], bad ? dnan : slope);
    put(P, R, out[3], bad ? dnan : __ddiv_rn(__dsub_rn(sy, __dmul_rn(sum_x, slope)), Ld));
}

// pole_zero on a float64 row: x + omc * (exclusive prefix of x), the
// prefix in K7's order (gen_excl_scan over the runs, then each run's
// samples in turn), each run read from shared memory twice.
__device__ __forceinline__ void op_pole_zero64(const GenParams& P, Row& R, int k,
                                               const int* in, const int* out,
                                               const int* ip) {
    const double* x = plane_of<double>(P, in[0]);
    const int n = plen(P, in[0]);
    const bool bad = plane_nan<double>(P, in[0], false) || ip[0];
    int j0, j1;
    scan_run(n, j0, j1);
    double run = 0.0;
    for (int j = j0; j < j1; ++j) run = __dadd_rn(run, x[j]);
    double s = gen_excl_scan(R, run);
    double* o = plane_of<double>(P, out[0]);
    double* g = esc_of<double>(P, R, out[0]);
    const double omc = tape_dp(P)[k * OP_DP];
    const double dnan = __longlong_as_double(0x7ff8000000000000LL);
    int h = 0;
    for (int j = j0; j < j1; ++j) {
        const double v = x[j];
        const double y = bad ? dnan : __dadd_rn(v, __dmul_rn(omc, s));
        o[j] = y;
        if (g) g[j] = y;
        h |= nan_inf(y);
        s = __dadd_rn(s, v);
    }
    flag_plane(P, out[0], h);
}

// The window sum x[i - off - len + 1, i - off] from the padded inclusive
// prefix: a prefix difference, 0 where the window ends before the row.
__device__ __forceinline__ double prefix_win(const double* ps, int pad, int i, int len,
                                             int off) {
    const int hi = i - off;
    const int lo = hi - len + 1;
    if (hi < 0) return 0.0;
    return __dsub_rn(ps[pidx(hi, pad)], lo >= 1 ? ps[pidx(lo - 1, pad)] : 0.0);
}

// trap_norm (ip[0] 0), asym_trap_filter (1) and trap_filter (2) on a float64
// row, from its float64 prefix in K7's order: every window a prefix
// difference (trap_norm_k7, asym_trap_filter_k7, trap_filter_k7), divided
// by its length in float64.
__device__ __forceinline__ void op_trap64(const GenParams& P, Row& R, const int* in,
                                          const int* out, const int* ip) {
    const double* x = plane_of<double>(P, in[0]);
    const int n = plen(P, in[0]);
    const bool bad = plane_nan<double>(P, in[0], false);
    const int pad = prefix_pad(n);
    double* ps = scratch_of(P);
    gen_prefix_shared(R, x, n, ps, pad);
    double* o = plane_of<double>(P, out[0]);
    double* g = esc_of<double>(P, R, out[0]);
    const int kind = ip[0], rise = ip[1], flat = ip[2], fall = ip[3];
    const double dnan = __longlong_as_double(0x7ff8000000000000LL);
    int h = 0;
    for (int i = threadIdx.x; i < n; i += GEN_THREADS) {
        const double d1 = prefix_win(ps, pad, i, rise, 0);
        const double d2 = prefix_win(ps, pad, i, fall, rise + flat);
        const double v = bad ? dnan
            : kind == 0 ? __ddiv_rn(__dsub_rn(d1, d2), (double)rise)
            : kind == 1 ? __dsub_rn(__ddiv_rn(d1, (double)rise), __ddiv_rn(d2, (double)fall))
                        : __dsub_rn(d1, d2);
        o[i] = v;
        if (g) g[i] = v;
        h |= nan_inf(v);
    }
    flag_plane(P, out[0], h);
}

// convolve_wf (m > 32 taps, ip[1]) on a float64 row with float64 taps
// (pairs of words from ip[0]): the window [lo, lo + p) of the full
// convolution (lo = ip[2]) summed as _conv_full_direct sums it, taps[m-1]'s
// product first, then m-2 down to 0 (convolve_k7). The row's window with
// zeros outside it, win[s] = x[lo - (m - 1) + s], and the taps are staged
// in the scratch before the op's barrier, as op_conv stages them.
__device__ __forceinline__ void op_conv64(const GenParams& P, const Row& R,
                                          const int* in, const int* out, const int* ip) {
    const double* x = plane_of<double>(P, in[0]);
    const int n = plen(P, in[0]), p = plen(P, out[0]);
    const int m = ip[1], lo = ip[2];
    const int span = p + m - 1, s0 = lo - (m - 1);
    double* win = scratch_of(P);
    double* ks = win + span;
    const double* taps = reinterpret_cast<const double*>(P.taps + ip[0]);
    const bool bad = plane_nan<double>(P, in[0], false);
    const int tid = threadIdx.x;
    for (int s = tid; s < span; s += GEN_THREADS) {
        const int q = s0 + s;
        win[s] = (q >= 0 && q < n) ? x[q] : 0.0;
    }
    for (int t = tid; t < m; t += GEN_THREADS) ks[t] = __ldg(taps + t);
    __syncthreads();
    double* o = plane_of<double>(P, out[0]);
    double* g = esc_of<double>(P, R, out[0]);
    int h = 0;
    for (int j = tid; j < p; j += GEN_THREADS) {
        double acc = __longlong_as_double(0x7ff8000000000000LL);
        if (!bad) {
            acc = __dmul_rn(ks[m - 1], win[j]);
            for (int t = m - 2; t >= 0; --t)
                acc = __dadd_rn(acc, __dmul_rn(ks[t], win[j + m - 1 - t]));
        }
        o[j] = acc;
        if (g) g[j] = acc;
        h |= nan_inf(acc);
    }
    flag_plane(P, out[0], h);
}

// mw_at on a float64 row: the stage's value at i, divided by L in float64.
__device__ __forceinline__ double mw_at64(const double* ps, int pad, int n, int L,
                                          bool right, double w0, double wl, int i) {
    const double lf = (double)L;
    if (!right) {
        if (i < L)
            return __dadd_rn(w0, __ddiv_rn(__dsub_rn(ps[pidx(i, pad)],
                                                     __dmul_rn((double)(i + 1), w0)), lf));
        return __ddiv_rn(__dsub_rn(ps[pidx(i, pad)], ps[pidx(i - L, pad)]), lf);
    }
    const double se = i > 0 ? ps[pidx(i - 1, pad)] : 0.0;
    if (i > n - 1 - L)
        return __dadd_rn(wl, __ddiv_rn(__dsub_rn(__dsub_rn(ps[pidx(n - 1, pad)], se),
                                                 __dmul_rn((double)(n - i), wl)), lf));
    return __ddiv_rn(__dsub_rn(ps[pidx(i + L - 1, pad)], se), lf);
}

// moving_window_multi on a float64 row: op_mw_multi's stages, each from
// the stage's float64 prefix in K7's order (moving_window_multi_k7).
__device__ __forceinline__ void op_mw_multi64(const GenParams& P, Row& R,
                                              const int* in, const int* out,
                                              const int* ip) {
    const double* x = plane_of<double>(P, in[0]);
    double* o = plane_of<double>(P, out[0]);
    double* g = esc_of<double>(P, R, out[0]);
    const int n = plen(P, in[0]);
    const int L = ip[0], num = ip[1], mtype = ip[2];
    const bool bad = plane_nan<double>(P, in[0], false);
    const int tid = threadIdx.x;
    int h = 0;
    if (bad || num == 0) {
        // the plan counts on a barrier before the op's writes
        __syncthreads();
        for (int i = tid; i < n; i += GEN_THREADS) {
            const double v = bad ? __longlong_as_double(0x7ff8000000000000LL) : x[i];
            o[i] = v;
            if (g) g[i] = v;
            h |= nan_inf(v);
        }
    } else {
        const int pad = prefix_pad(n);
        double* ps = scratch_of(P);
        const double* src = x;
        for (int it = 0; it < num; ++it) {
            const bool right = ((it % 2 == 1) && mtype == 0) || mtype == 2;
            const double w0 = src[0], wl = src[n - 1];
            gen_prefix_shared(R, src, n, ps, pad);
            const bool last = it == num - 1;
            for (int i = tid; i < n; i += GEN_THREADS) {
                const double v = mw_at64(ps, pad, n, L, right, w0, wl, i);
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

// double_pole_zero on a float64 row: op_dpz's runs and scans with nothing
// rounded to float32; the table (ip[0], pairs of words) holds ke, kd and
// p^i in float64 (double_pole_zero_runs).
__device__ __forceinline__ void op_dpz64(const GenParams& P, Row& R, int k,
                                         const int* in, const int* out, const int* ip) {
    const double* x = plane_of<double>(P, in[0]);
    double* o = plane_of<double>(P, out[0]);
    double* g = esc_of<double>(P, R, out[0]);
    const int n = plen(P, in[0]);
    const double* dp = tape_dp(P) + k * OP_DP;
    const double p = dp[0], k1 = dp[1], k2 = dp[2];
    const double* tab = reinterpret_cast<const double*>(P.taps + ip[0]);
    const bool bad = plane_nan<double>(P, in[0], false) || ip[1];
    double* vs = scratch_of(P);
    int j0, j1;
    scan_run(n, j0, j1);
    double run = 0.0;
    for (int j = j0; j < j1; ++j) run = __dadd_rn(run, x[j]);
    double s1 = gen_excl_scan(R, run);
    double s2 = j0 >= 1 ? __dsub_rn(s1, x[j0 - 1]) : 0.0;
    double v = 0.0, m = 1.0;
    for (int j = j0; j < j1; ++j) {
        const double s = __dadd_rn(s1, x[j]);
        const double z = __dadd_rn(__dsub_rn(s, __dmul_rn(k1, s1)), __dmul_rn(k2, s2));
        v = __dadd_rn(__dmul_rn(p, v), z);
        m = __dmul_rn(m, p);
        vs[j] = v;
        s2 = s1;
        s1 = s;
    }
    const double c = gen_affine_excl(R, m, v);
    const double alpha = __ddiv_rn(__dmul_rn(x[0], tab[0]), tab[1]);
    const double* pw = tab + 2;
    const double dnan = __longlong_as_double(0x7ff8000000000000LL);
    double pk = p;
    int h = 0;
    for (int j = j0; j < j1; ++j) {
        const double y = __dadd_rn(vs[j], __dmul_rn(pk, c));
        pk = __dmul_rn(pk, p);
        const double val = bad ? dnan : __dsub_rn(y, __dmul_rn(alpha, __dsub_rn(1.0, pw[j])));
        o[j] = val;
        if (g) g[j] = val;
        h |= nan_inf(val);
    }
    flag_plane(P, out[0], h);
}

// poly_diff / poly_exp_rms (ip[0] = 1) on a float64 row: the polynomial of
// the parameter plane in[1] as poly_eval takes it on float64 (p0, then
// i^k p_k + out, the product and the sum each rounded), its exponential
// with ip[0]; the residual's sums of r / (i + 1) and r * r in float64,
// behind one barrier (poly_diff_k7).
__device__ __forceinline__ void op_poly_resid64(const GenParams& P, Row& R,
                                                const int* in, const int* out,
                                                const int* ip) {
    const double* x = plane_of<double>(P, in[0]);
    const int n = plen(P, in[0]);
    const int m = ip[1];
    const double* pars = plane_of<double>(P, in[1]);
    const bool bad = plane_nan<double>(P, in[0], false) || plane_nan<double>(P, in[1], false);
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    double s1 = 0.0, s2 = 0.0;
    for (int i = tid; i < n; i += GEN_THREADS) {
        const double fi = (double)i;
        double p = pars[0], ik = 1.0;
        for (int q = 1; q < m; ++q) {
            ik = __dmul_rn(ik, fi);
            p = __dadd_rn(__dmul_rn(ik, pars[q]), p);
        }
        if (ip[0]) p = exp(p);
        const double r = __dsub_rn(x[i], p);
        s1 = __dadd_rn(s1, __dmul_rn(r, __ddiv_rn(1.0, fi + 1.0)));
        s2 = __dadd_rn(s2, __dmul_rn(r, r));
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    double* red = gen_red[R.rb];
    R.rb ^= 1;
    if (lane == 0) {
        red[wid] = s1;
        red[GEN_WARPS + wid] = s2;
    }
    __syncthreads();
    if (tid != 0) return;
    s1 = replay_sum(red);
    s2 = replay_sum(red + GEN_WARPS);
    const double dnan = __longlong_as_double(0x7ff8000000000000LL);
    put(P, R, out[0], bad ? dnan : s1);
    put(P, R, out[1], bad ? dnan : sqrt(__ddiv_rn(s2, (double)(n - 1))));
}

// The pulse of inject kind KIND at sample t on a float64 row: pulse_at's
// operations in float64, each rounded once in the member kernel's order
// (exp and pow the device's, as PyTorch's float64 ones on the card).
template <int KIND>
__device__ __forceinline__ double pulse_at64(double t, double dt, double t0, double rise,
                                             const double* p) {
    if (KIND == 0) {
        const double arg = __dmul_rn(-rise, __dsub_rn(t, __dadd_rn(t0, __dmul_rn(p[1], 0.5))));
        return __dmul_rn(__ddiv_rn(p[2], __dadd_rn(1.0, exp(arg))),
                         exp(__ddiv_rn(-dt, p[3])));
    }
    if (KIND == 1) {
        const double tail = exp(__ddiv_rn(-dt, p[3]));
        const double end = __dadd_rn(t0, p[1]);
        if (t <= t0 && t <= end)
            return __dmul_rn(__dmul_rn(p[2], exp(__ddiv_rn(__dsub_rn(dt, p[1]), p[1]))), tail);
        return t > end ? __dmul_rn(p[2], tail) : 0.0;
    }
    if (KIND == 2) {
        const double b = p[2];
        const double mu = __dadd_rn(t0, __dmul_rn(2.0, b));
        if (!(t >= t0 && t < __dadd_rn(mu, __dmul_rn(8.0, b)))) return 0.0;
        const double z = __ddiv_rn(__dsub_rn(t, mu), b);
        return __dmul_rn(__ddiv_rn(p[0], b), exp(-__dadd_rn(z, exp(-z))));
    }
    const double arg = __dmul_rn(-rise, __dsub_rn(dt, __dmul_rn(p[2], 0.5)));
    const double base = __dadd_rn(1.0, __dmul_rn(p[3], exp(arg)));
    return __dmul_rn(__ddiv_rn(p[0], pow(base, __ddiv_rn(1.0, p[4]))),
                     exp(__ddiv_rn(-dt, p[5])));
}

template <int KIND>
__device__ __forceinline__ int inject_row64(const double* x, double* o, double* g, int n,
                                            bool bad, const double* p, double lg) {
    const double t0 = KIND >= 2 ? p[1] : p[0];
    const double rise = KIND == 0 ? __ddiv_rn(lg, p[1]) : KIND == 3 ? __ddiv_rn(lg, p[2]) : 0.0;
    const double dnan = __longlong_as_double(0x7ff8000000000000LL);
    int h = 0;
    for (int i = threadIdx.x; i < n; i += GEN_THREADS) {
        const double t = (double)i;
        const double y = bad ? dnan
            : __dadd_rn(x[i], pulse_at64<KIND>(t, __dsub_rn(t, t0), t0, rise, p));
        o[i] = y;
        if (g) g[i] = y;
        h |= nan_inf(y);
    }
    return h;
}

// The inject op on a float64 row: op_inject's parameters in float64 (the
// constant ones from the taps, pairs of words from ip[1]; one a row as
// operands, not rounded), 4 ln 99 in float64, the pulse by pulse_at64.
__device__ __forceinline__ void op_inject64(const GenParams& P, const Row& R, int k,
                                            const int* in, const int* out, const int* ip) {
    const double* x = plane_of<double>(P, in[0]);
    const double* taps = reinterpret_cast<const double*>(P.taps + ip[1]);
    const int n = plen(P, in[0]);
    double p[6];
    bool bad = plane_nan<double>(P, in[0], false);
#pragma unroll
    for (int q = 0, j = 1; q < 6; ++q) {
        p[q] = ((ip[2] >> q) & 1) ? operand(P, k, j++, ip[7]) : __ldg(taps + q);
        bad |= isnan(p[q]);
    }
    const double lg = tape_dp(P)[k * OP_DP];
    double* o = plane_of<double>(P, out[0]);
    double* g = esc_of<double>(P, R, out[0]);
    int h;
    switch (ip[0]) {
    case 0: h = inject_row64<0>(x, o, g, n, bad, p, lg); break;
    case 1: h = inject_row64<1>(x, o, g, n, bad, p, lg); break;
    case 2: h = inject_row64<2>(x, o, g, n, bad, p, lg); break;
    default: h = inject_row64<3>(x, o, g, n, bad, p, lg); break;
    }
    flag_plane(P, out[0], h);
}

// ml.py's activations in float64 (activate's, each operation rounded once;
// exp, log1p and tanh the device's).
__device__ __forceinline__ double activate64(double t, int flag) {
    const double pos = t > 0.0 ? t : 0.0;
    switch (flag) {
    case 's': return __ddiv_rn(1.0, __dadd_rn(1.0, exp(-t)));
    case 'r': return pos;
    case 'l': return __dadd_rn(pos, t < 0.0 ? __dmul_rn(0.01, t) : 0.0);
    case 'm': return log1p(exp(t));
    default: return tanh(t);
    }
}

// The dense op on a float64 row: op_dense's kinds and sums with float64
// constants (pairs of words in the taps) and products, each product and sum
// rounded once (ml.layer_rows' order), the bias and the activation in
// float64; nothing rounded to float32.
__device__ __forceinline__ void op_dense64(const GenParams& P, const Row& R, int k,
                                           const int* in, const int* out, const int* ip) {
    const double* x = plane_of<double>(P, in[0]);
    const int n = plen(P, in[0]);
    const bool bad = plane_nan<double>(P, in[0], false);
    const double dnan = __longlong_as_double(0x7ff8000000000000LL);
    const int tid = threadIdx.x;
    if (ip[0] == 0) {
        double* o = plane_of<double>(P, out[0]);
        double* g = esc_of<double>(P, R, out[0]);
        const double* mu = reinterpret_cast<const double*>(P.taps + ip[2]);
        const double* var = reinterpret_cast<const double*>(P.taps + ip[3]);
        int h = 0;
        for (int i = tid; i < n; i += GEN_THREADS) {
            const double v = bad ? dnan
                : __ddiv_rn(__dsub_rn(x[i], __ldg(mu + i)), sqrt(__ldg(var + i)));
            o[i] = v;
            if (g) g[i] = v;
            h |= nan_inf(v);
        }
        flag_plane(P, out[0], h);
        return;
    }
    const int m = ip[5];
    const double* wt = reinterpret_cast<const double*>(P.taps + ip[2]);
    double* part = scratch_of(P);
    const int lane = tid & 31, wid = tid >> 5;
    const int c = (n + GEN_WARPS - 1) / GEN_WARPS;
    const int i0 = wid * c, i1 = min(n, i0 + c);
    for (int j = lane; j < m; j += 32) {
        double acc = 0.0;
        for (int i = i0; i < i1; ++i)
            acc = __dadd_rn(acc, __dmul_rn(x[i], __ldg(wt + i * m + j)));
        part[wid * m + j] = acc;
    }
    __syncthreads();
    double* o = ip[0] == 1 ? plane_of<double>(P, out[0]) : nullptr;
    double* g = ip[0] == 1 ? esc_of<double>(P, R, out[0]) : nullptr;
    int h = 0;
    for (int j = tid; j < m; j += GEN_THREADS) {
        double t = 0.0;
#pragma unroll
        for (int q = 0; q < GEN_WARPS; ++q) t = __dadd_rn(t, part[q * m + j]);
        if (ip[3] >= 0)
            t = __dadd_rn(t, __ldg(reinterpret_cast<const double*>(P.taps + ip[3]) + j));
        if (ip[6]) t = __dadd_rn(t, operand(P, k, 1, ip[7]));
        const double v = bad ? dnan : activate64(t, ip[1]);
        if (o) {
            o[j] = v;
            if (g) g[j] = v;
            h |= nan_inf(v);
        } else {
            put(P, R, out[0], v);
        }
    }
    if (o) flag_plane(P, out[0], h);
}

// An external bool or int64 per-row scalar as a double (not inlined, as
// ufunc_apply).
__device__ __noinline__ double ext_other(const GenParams& P, int e, int ty,
                                         const Row& R) {
    return ty == T_BOOL ? (double)((const unsigned char*)P.ext[e])[R.row]
                        : (double)((const long long*)P.ext[e])[R.row];
}

// The plane ops that run on the whole block (and the trap op's trap_filter
// kind, a bool plane's load), from one call site: the call returns the op's
// index and the reduction buffer, so that the kernel's loop holds nothing
// across it.
__device__ __noinline__ int2 outlined_op(const GenParams& P, Row R, int k) {
    const int* op = tape(P) + k * OP_INTS;
    const int* in = op + 1;
    const int* out = in + OP_IN;
    const int* ip = out + OP_OUT;
    switch (op[0]) {
    case OP_LOAD: op_load_bool<float>(P, R, in[0]); break;
    case OP_TRAP: op_trap_sum(P, R, in, out, ip); break;
    case OP_MW: op_mw<float>(P, R, k, in, out, ip); break;
    case OP_CONV_DIRECT: op_conv_direct<float>(P, R, in, out, ip); break;
    case OP_EWISE: op_ewise<float>(P, R, k, in, out, ip); break;
    default: op_reduce<float>(P, R, in, out, ip); break;
    }
    return make_int2(k, R.rb);
}

// The float64 kernel's one call site of the same kind: the ops its float64
// flagship, DPZ and extras groups do not run (get, where and the rounders on
// warp 0, a bool plane's load, inject, dense, the coverage block ops, the
// plane ops and the SiPM chain's reflected convolution). Inline, they would
// add their registers and branches to the kernel's loop.
__device__ __noinline__ int2 outlined_op64(const GenParams& P, Row R, int k) {
    const int* op = tape(P) + k * OP_INTS;
    const int* in = op + 1;
    const int* out = in + OP_IN;
    const int* ip = out + OP_OUT;
    switch (op[0]) {
    case OP_GET:
    case OP_WHERE:
    case OP_ROUND:
        if ((threadIdx.x >> 5) == 0) {
            __syncwarp();
            warp_op<double>(P, R, k, op[0]);
        }
        break;
    case OP_LOAD: op_load_bool<double>(P, R, in[0]); break;
    case OP_INJECT: op_inject64(P, R, k, in, out, ip); break;
    case OP_DENSE: op_dense64(P, R, k, in, out, ip); break;
    case OP_MEAN_BELOW: op_mean_below<double>(P, R, k, in, out, ip); break;
    case OP_COUNT: op_count<double>(P, R, k, in, out, ip); break;
    case OP_SLOPE_DIFF: op_slope_diff<double>(P, R, k, in, out, ip); break;
    case OP_LOG_CHECK: op_log_check<double>(P, R, in, out); break;
    case OP_TRAP_PICKOFF: op_trap_pickoff<double>(P, R, k, in, out, ip); break;
    case OP_PRESUM: op_presum<double>(P, R, in, out, ip); break;
    case OP_MIN_MAX_NORM: op_min_max_norm<double>(P, R, k, in, out, ip); break;
    case OP_MULTI_A: op_multi_a<double>(P, R, in, out); break;
    case OP_MW: op_mw<double>(P, R, k, in, out, ip); break;
    case OP_CONV_DIRECT: op_conv_direct<double>(P, R, in, out, ip); break;
    case OP_EWISE: op_ewise<double>(P, R, k, in, out, ip); break;
    case OP_REDUCE: op_reduce<double>(P, R, in, out, ip); break;
    case OP_REFL_CONV: op_reflected_conv64(P, R, in, out, ip); break;
    default: break;
    }
    return make_int2(k, R.rb);
}

// A block's start: the tape into shared memory; then no plane holds a NaN
// yet, and the external scalars go into their places.
__device__ __forceinline__ void gen_start(const GenParams& P, const Row& R) {
    const int tid = threadIdx.x;
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
        if (P.code[r + S_KIND] == 1 && e >= 0) {
            const int ty = P.code[r + S_TYPE];
            gen_smem[P.code[r + S_SIDX]] =
                ty == T_F32 ? (double)((const float*)P.ext[e])[R.row]
                : ty == T_F64 ? ((const double*)P.ext[e])[R.row] : ext_other(P, e, ty, R);
        }
    }
    __syncthreads();
}

// The interpreter's table of ops for each plane type: op k of the tape (its
// code and its fields), on the float kernel or on the float64 one. An op
// that runs outlined moves k and the reduction buffer on.
template <typename T>
__device__ __forceinline__ void gen_op(const GenParams& P, Row& R, int& k, int code,
                                       const int* in, const int* out, const int* ip);

template <>
__device__ __forceinline__ void gen_op<float>(const GenParams& P, Row& R, int& k,
                                              int code, const int* in, const int* out,
                                              const int* ip) {
    switch (code) {
    case OP_TPT:
    case OP_FTP:
    case OP_UFUNC:
    case OP_CONVERT:
    case OP_GET:
    case OP_WHERE:
    case OP_ROUND:
        if ((threadIdx.x >> 5) == 0) {
            __syncwarp();
            warp_op<float>(P, R, k, code);
        }
        break;
    case OP_LOAD:
        if (sf(P, in[0], S_TYPE) == T_BOOL) goto outlined;
        op_load(P, R, in[0]);
        break;
    case OP_MIN_MAX: op_min_max<float>(P, R, in, out); break;
    case OP_SLOPE_FIT: op_slope_fit(P, R, in, out); break;
    case OP_POLE_ZERO: op_pole_zero(P, R, k, in, out, ip); break;
    case OP_TRAP:
        if (ip[0] == 2) goto outlined;  // trap_filter
        op_trap(P, R, in, out, ip);
        break;
    case OP_AMAX: op_amax<float>(P, R, in, out); break;
    case OP_CONV: op_conv(P, R, in, out, ip); break;
    case OP_BL_SUB:
    case OP_WINDOWER:
    case OP_AVG_CURRENT:
    case OP_SOFT_PILEUP_OUT: op_gather(P, R, k, code, in, out, ip); break;
    case OP_MW_MULTI: op_mw_multi(P, R, in, out, ip); break;
    case OP_REFL_CONV: op_reflected_conv(P, R, in, out, ip); break;
    case OP_DPZ: op_dpz(P, R, k, in, out, ip); break;
    case OP_POLY_RESID: op_poly_resid(P, R, in, out, ip); break;
    case OP_SOFT_PILEUP: op_soft_pileup<float>(P, R, k, in, out, ip); break;
    case OP_WF_CORR: op_wf_correction<float>(P, R, in, out, ip); break;
    case OP_WF_CENTROID: op_wf_centroid<float>(P, R, k, in, out, ip); break;
    case OP_INJECT: op_inject(P, R, k, in, out, ip); break;
    case OP_DENSE: op_dense(P, R, k, in, out, ip); break;
    case OP_MEAN_BELOW: op_mean_below<float>(P, R, k, in, out, ip); break;
    case OP_COUNT: op_count<float>(P, R, k, in, out, ip); break;
    case OP_SLOPE_DIFF: op_slope_diff<float>(P, R, k, in, out, ip); break;
    case OP_LOG_CHECK: op_log_check<float>(P, R, in, out); break;
    case OP_TRAP_PICKOFF: op_trap_pickoff<float>(P, R, k, in, out, ip); break;
    case OP_PRESUM: op_presum<float>(P, R, in, out, ip); break;
    case OP_MIN_MAX_NORM: op_min_max_norm<float>(P, R, k, in, out, ip); break;
    case OP_MULTI_A: op_multi_a<float>(P, R, in, out); break;
    case OP_MW:
    case OP_CONV_DIRECT:
    case OP_EWISE:
    case OP_REDUCE:
    outlined: {
        const int2 r = outlined_op(P, R, k);
        k = r.x;
        R.rb = r.y;
        break;
    }
    default: break;
    }
}

// The float64 kernel's table: every op of a float64 program
// (_tile_program.F64_OPS) in its float64 form; those its flagship, DPZ and
// extras groups do not run behind outlined_op64.
template <>
__device__ __forceinline__ void gen_op<double>(const GenParams& P, Row& R, int& k,
                                               int code, const int* in, const int* out,
                                               const int* ip) {
    switch (code) {
    case OP_TPT:
    case OP_FTP:
    case OP_UFUNC:
    case OP_CONVERT:
        if ((threadIdx.x >> 5) == 0) {
            __syncwarp();
            warp_op<double>(P, R, k, code);
        }
        break;
    case OP_LOAD:
        if (sf(P, in[0], S_TYPE) == T_BOOL) goto outlined;
        op_load64(P, R, in[0]);
        break;
    case OP_MIN_MAX: op_min_max<double>(P, R, in, out); break;
    case OP_SLOPE_FIT: op_slope_fit64(P, R, in, out); break;
    case OP_POLE_ZERO: op_pole_zero64(P, R, k, in, out, ip); break;
    case OP_TRAP: op_trap64(P, R, in, out, ip); break;
    case OP_AMAX: op_amax<double>(P, R, in, out); break;
    case OP_CONV: op_conv64(P, R, in, out, ip); break;
    case OP_BL_SUB:
    case OP_WINDOWER:
    case OP_AVG_CURRENT:
    case OP_SOFT_PILEUP_OUT: op_gather64(P, R, k, code, in, out, ip); break;
    case OP_MW_MULTI: op_mw_multi64(P, R, in, out, ip); break;
    case OP_DPZ: op_dpz64(P, R, k, in, out, ip); break;
    case OP_POLY_RESID: op_poly_resid64(P, R, in, out, ip); break;
    case OP_SOFT_PILEUP: op_soft_pileup<double>(P, R, k, in, out, ip); break;
    case OP_WF_CORR: op_wf_correction<double>(P, R, in, out, ip); break;
    case OP_WF_CENTROID: op_wf_centroid<double>(P, R, k, in, out, ip); break;
    default:  // every other op (_tile_program.F64_OPS), outlined
    outlined: {
        const int2 r = outlined_op64(P, R, k);
        k = r.x;
        R.rb = r.y;
        break;
    }
    }
}

// The interpreter: one block a row walks the tape, each op from its plane
// type's table, behind the planned barrier where the plan puts one. The loop
// is written out in each kernel: run through a shared device function, the
// float kernel took 2.2-2.4% longer on the generic flagship's groups (H100,
// same tape, bit-identical outputs).
__global__ void __launch_bounds__(GEN_THREADS, GEN_MIN_BLOCKS)
generic_rows_kernel(const __grid_constant__ GenParams P) {
    Row R;
    R.row = blockIdx.x;
    R.rb = 0;
    gen_start(P, R);
    for (int k = 0; k < P.n_ops; ++k) {
        const int* op = tape(P) + k * OP_INTS;
        const int* in = op + 1;
        const int* out = in + OP_IN;
        const int* ip = out + OP_OUT;
        const int code = op[0];
        if (ip[IP_PLAN] & 1) __syncthreads();
        gen_op<float>(P, R, k, code, in, out, ip);
    }
}

// K7 on float64 planes: the same tape, plan and loop over the float64 table.
// A kernel of its own, so that the float kernel's code and its register cap
// stay as they were; its groups' shared memory (about 106 KB for the float64
// flagship's) allows two blocks an SM, and with them 128 registers a thread.
__global__ void __launch_bounds__(GEN_THREADS, GEN_MIN_BLOCKS_F64)
generic_rows_kernel_f64(const __grid_constant__ GenParams P) {
    Row R;
    R.row = blockIdx.x;
    R.rb = 0;
    gen_start(P, R);
    for (int k = 0; k < P.n_ops; ++k) {
        const int* op = tape(P) + k * OP_INTS;
        const int* in = op + 1;
        const int* out = in + OP_IN;
        const int* ip = out + OP_OUT;
        const int code = op[0];
        if (ip[IP_PLAN] & 1) __syncthreads();
        gen_op<double>(P, R, k, code, in, out, ip);
    }
}

typedef void (*GenKernel)(const GenParams);

static GenKernel gen_kernel(int f64) {
    return f64 ? generic_rows_kernel_f64 : generic_rows_kernel;
}

static cudaError_t gen_launch(int smem, int f64, int* per_sm) {
    cudaError_t err = cudaFuncSetAttribute(
        gen_kernel(f64), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, gen_kernel(f64), GEN_THREADS, smem);
}

// One launch of a lowered program: the float kernel, or (f64) the float64
// one.
extern "C" int dspeed_generic_rows(const GenParams* p, int smem, int f64, void* stream) {
    int per_sm;
    cudaError_t err = gen_launch(smem, f64, &per_sm);
    if (err != cudaSuccess) return (int)err;
    if (p->B == 0) return 0;
    if (f64)
        generic_rows_kernel_f64<<<p->B, GEN_THREADS, smem, (cudaStream_t)stream>>>(*p);
    else
        generic_rows_kernel<<<p->B, GEN_THREADS, smem, (cudaStream_t)stream>>>(*p);
    return (int)cudaGetLastError();
}

// How a program with `smem` bytes of dynamic shared memory launches on the
// float (or, f64, the float64) kernel: threads a block, blocks per SM,
// registers and local (spill) bytes a thread, static shared bytes.
extern "C" int dspeed_generic_rows_config(int smem, int f64, int* out) {
    int per_sm;
    cudaError_t err = gen_launch(smem, f64, &per_sm);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, gen_kernel(f64))) != cudaSuccess)
        return (int)err;
    const int vals[] = {GEN_THREADS, per_sm, attr.numRegs,
                        (int)attr.localSizeBytes, (int)attr.sharedSizeBytes};
    for (int i = 0; i < 5; ++i) out[i] = vals[i];
    return 0;
}

extern "C" const char* dspeed_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
