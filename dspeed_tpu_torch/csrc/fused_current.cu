// The A/E current front for Hopper (sm_90a): upsample the current c by
// replication (x[j] = c[(j + half) / ratio], j < n_up), run `num`
// alternating moving averages of L samples over x, and reduce to the
// first-occurrence t_min, t_max, a_min, a_max. Two routes, chosen by the
// wrapper from the geometry alone (processors/_poly_plan.py):
//
// K6, `fused_current_kernel`, the up-domain route, replaces
// `_fused_current_kernel` / `_fused_current_call`
// (dspeed_tpu/processors/_pallas.py:572, :637). It runs the cascade at full
// upsampled width.
//
// K5, `fused_current_poly_kernel`, the polyphase route, replaces
// `_fused_current_poly_kernel` / `_fused_current_poly_call` (:804, :910;
// plan `_poly_plan` :705). Away from the edges the cascade is a linear
// filter, and on a replicated row it collapses to one short filter per
// phase: y[ratio*t + p] = sum_k H[p][k] c[t + q_min + k] (11 taps at the
// flagship geometry). Only the two W-sample windows at the true edges run
// the staged cascade; the plan proves which outputs each method owns.
//
// Both: a row of c holding a NaN, or, where a moving-window stage runs
// (num > 0), an infinity that the upsampled row reads, gives NaN in all
// four outputs (cur_bad, cur_poison_last). With no stage the curve is the
// upsampled row itself, and an infinity it reads is its extremum. With need
// clearing both t_min and a_min (or t_max and a_max) that extremum is not
// reduced, and an output nothing needs holds 0.
//
// What bounds them on this card: at the flagship geometry (n_curr 300, ratio
// 16, n_up 4784, L 48, 3 stages) a row is 1.2 KB read and 16 bytes written:
// 19.7 MB per 16384 rows, 6 us at 3.35 TB/s. K5's work is 4640 x 11 FMAs in
// the interior plus 2 x 3 float64 prefix stages over 256 samples at the
// edges, about 0.12 MFLOP a row; K6's is 3 float64 prefix stages over 4784
// samples, with a handful of float64 operations per sample. Both are bound
// by operations: K6 by its float32 <-> float64 conversions and instruction
// issue, K5 by its float64 divisions and the interior's FMAs.
//
// How the designs meet it. The TPU's triangular-matmul cumsums (`tri`,
// `sup`, `triL`), the dense banded interior matmuls (`A`, `A_last`), the
// one-hot window matrices (`RL`, `RR`) and the row tilings exist for its
// matrix unit and are gone; the replication is plain indexing. K6: one
// block of 256 threads per row, each thread's run of the row in registers
// (below). Each stage is mw_cascade.cuh's (a float64 block scan, rounding
// to float32 per stage, as the plain version does), bit for bit, and one
// first-occurrence reduction (lower index on ties) takes the extrema: the
// same result as the TPU kernel's ordered fold of its regions with strict
// comparisons. K5: one warp per row and no block barrier after the filters
// are staged (below); its edge samples and interior sums equal K6's
// block-scan arithmetic and the TPU kernel's per-phase sums bit for bit,
// and its extrema follow the same rule.

#include <cuda_runtime.h>
#include <math.h>

#include "block_reduce.cuh"

// Mirrored field for field by ctypes in processors/_cuda.py.
struct CurrentParams {
    const float* c;  // (B, n_curr)
    const float* H;  // K5: (ratio, nq) per-phase filters
    float* out[4];   // t_min, t_max, a_min, a_max, each (B,)
    int B;
    int n_curr;
    int ratio;
    int half;
    int n_up;
    int L;
    int num;
    int mtype;
    int need[4];
    // K5's plan (processors/_poly_plan.py)
    int W;
    int EL;
    int ERW;
    int nq;
    int q_min;
};

// The last sample of c that the upsampled row reads, c[(j + half) / ratio]
// for j < n_up; every sample before it is read too (half < ratio).
__device__ __forceinline__ int cur_last_read(const CurrentParams& P) {
    return (P.n_up - 1 + P.half) / P.ratio;
}

// The last sample whose infinity poisons a row: cur_last_read where a
// stage takes prefix differences (they are then NaN: the plain version
// gives NaN on all four outputs), and none (-1) with no stage, where the
// plain version reports the infinity as the extremum.
__device__ __forceinline__ int cur_poison_last(const CurrentParams& P) {
    return P.num > 0 ? cur_last_read(P) : -1;
}

// Whether sample i of a row, v, poisons the row: a NaN anywhere, or an
// infinity at i <= last (cur_poison_last). Bitwise: a short-circuit form
// cost K6 3%.
__device__ __forceinline__ int cur_bad(float v, int i, int last) {
    return isnan(v) | (isinf(v) & (i <= last));
}

// ---------------------------------------------------------------------------
// K6: the up-domain route
//
// One block of K6_THREADS = 256 threads a row, thread t standing for thread
// t of row_prefix.cuh's block scan (mw_cascade.cuh, the reference order):
// it owns the run [t per, t per + per) of the upsampled row, per = ceil(n_up
// / 256). Where per is K6_RUN = 19 (4609 <= n_up <= 4864: the flagship's
// 4784, and 4788) the run is held in registers as float64, widened once,
// samples past the row's end as +0.0 (they leave every sum as it is);
// other rows keep their runs in a float32 row in shared memory (the
// generic instance). The run is gathered from c before the NaN test's
// barrier, so that both reads of the row wait on memory together. A stage
// is three passes over the run and two barriers:
// - the run's sum from 0.0 in float64, serially; block_excl_scan's warp
//   Kogge-Stone scan; the warp totals through shared memory (barrier 1),
//   where every warp repeats warp 0's scan of them on lanes 0..7 (the lanes
//   above 7 add nothing there), so the run's start is the block scan's,
//   (warp offset + exclusive), bit for bit;
// - the inclusive prefix from that start along the run, kept in registers
//   and stored to shared memory as float64 (barrier 2);
// - the window: mw_stage's formulas, ramps included, in the same roundings,
//   the far end of each window read from shared memory, the quotient by L
//   through k6_div (below). A warp whose runs hold no ramp sample and no
//   sample past the row's end takes a pass with no select and no clamp. The
//   stage's output, rounded to float32, replaces the run in registers; the
//   last stage folds it into the extrema instead.
// Barrier 1 of a stage also orders the previous stage's prefix reads before
// this stage's prefix stores; the warp totals are read between barriers 1
// and 2, and the stages' end samples (the ramps' x[0] and x[n-1]) come from
// pass 3 of the stage before through a buffer of two by stage parity. The
// extrema: each thread's first occurrence along its run (strict comparisons
// in ascending index), then block_argext's rule (the more extreme value,
// the lower index on equal values) over the warp by shuffles and over the
// warps by thread 0: the same (value, index) as the reference's block
// reduction, since a curve of finite samples has one first-occurrence
// extremum. A row that the NaN rule poisons skips the cascade and gives NaN
// on all four outputs. Eight barriers a row at three stages, against 26 in
// mw_cascade.cuh's order; 8 * 256 per bytes of shared memory, against 12
// n_up, so 3 rows an SM at 80 registers.
//
// On the H100 at the flagship geometry its pipes would allow ~0.12 ms (two
// float32 <-> float64 conversions a sample and stage, at 16 a clock an SM);
// it takes about 0.44 ms, bound by each block's latency: the passes' serial
// chains, the barriers, and the warps whose runs hold ramp samples (their
// pass 3 takes about twice as long, and the block waits for them).

#define K6_THREADS 256
#define K6_WARPS (K6_THREADS / 32)
#define K6_RUN 19         // samples of a run held in registers (4609..4864)
#define K6_MIN_BLOCKS 3   // blocks an SM that the registers must allow

__host__ __device__ inline int k6_per(int n_up) {
    return (n_up + K6_THREADS - 1) / K6_THREADS;
}

__host__ __device__ inline bool k6_in_registers(int n_up) {
    return k6_per(n_up) == K6_RUN;
}

extern "C" int dspeed_fused_current_smem_bytes(int n_up) {
    // the float64 prefix of 256 whole runs; the generic instance: the prefix
    // of the row, and the row beside it
    return k6_in_registers(n_up) ? 8 * K6_THREADS * k6_per(n_up) : 12 * n_up;
}

// a / L, correctly rounded, from yl = RN(1/L) (generic_rows.cu's div_by):
// q = RN(a yl) lies within an ulp of a / L, the residual a - L q is exact by
// FMA, and RN(q + (a - L q) yl) is RN(a / L) (Markstein's theorem), where no
// step under- or overflows. Here 1 <= L <= 128, and every numerator is a
// difference of prefix sums of float32 samples, or a prefix sum less a
// multiple of a sample: finite (below 2^128 * 2^15 in magnitude), a
// multiple of 2^-149, so zero or at least 2^-149 in magnitude, and never
// -0 (every sum starts from +0.0). So no step under- or overflows, and a
// zero numerator gives +0, as the division does.
__device__ __forceinline__ double k6_div(double a, double lf, double yl) {
    const double q = __dmul_rn(a, yl);
    return __fma_rn(__fma_rn(-lf, q, a), yl, q);
}

// The start of this thread's run in the block scan over 256 threads:
// row_prefix.cuh's block_excl_scan, bit for bit, with one barrier.
__device__ __forceinline__ double k6_start(double run, double* red, int lane,
                                           int wid) {
    double x = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const double y = __shfl_up_sync(FULL_MASK, x, o);
        if (lane >= o) x += y;
    }
    double excl = __shfl_up_sync(FULL_MASK, x, 1);
    if (lane == 0) excl = 0.0;
    if (lane == 31) red[wid] = x;
    __syncthreads();
    double t = lane < K6_WARPS ? red[lane] : 0.0;
#pragma unroll
    for (int o = 1; o < K6_WARPS; o <<= 1) {
        const double y = __shfl_up_sync(FULL_MASK, t, o);
        if (lane >= o) t += y;
    }
    const double tw = __shfl_sync(FULL_MASK, t, max(wid - 1, 0));
    return (wid > 0 ? tw : 0.0) + excl;
}

// mw_stage's left window at sample i, from the prefix si = S[i] and ps;
// fi = i + 1 (as a double, for the ramp); without RAMP, for i >= L only.
template <bool RAMP>
__device__ __forceinline__ double k6_left(const double* ps, double si, int i,
                                          int L, double w0, double lf,
                                          double yl, double fi) {
    // i < L: w0 + (S[i] - (i+1) w0) / L; else (S[i] - S[i-L]) / L
    if (!RAMP) return k6_div(__dsub_rn(si, ps[i - L]), lf, yl);
    const bool ramp = i < L;
    const double sl = ps[max(i - L, 0)];
    const double q =
        k6_div(__dsub_rn(si, ramp ? __dmul_rn(fi, w0) : sl), lf, yl);
    return ramp ? __dadd_rn(w0, q) : q;
}

// mw_stage's right window at sample i, from se = S[i-1] (0 at i = 0), the
// row's total stot = S[n-1] and ps; fr = n - i (as a double, for the ramp);
// without RAMP, for i <= n-1-L only.
template <bool RAMP>
__device__ __forceinline__ double k6_right(const double* ps, double se,
                                           double stot, int i, int n, int L,
                                           double wl, double lf, double yl,
                                           double fr) {
    // i > n-1-L: wl + ((S[n-1] - S[i-1]) - (n-i) wl) / L;
    // else (S[i+L-1] - S[i-1]) / L
    if (!RAMP) return k6_div(__dsub_rn(ps[i + L - 1], se), lf, yl);
    const bool ramp = i > n - 1 - L;
    const double sr = ps[min(i + L - 1, n - 1)];
    const double q = k6_div(
        ramp ? __dsub_rn(__dsub_rn(stot, se), __dmul_rn(fr, wl))
             : __dsub_rn(sr, se),
        lf, yl);
    return ramp ? __dadd_rn(wl, q) : q;
}

// A thread's first-occurrence extrema along its run, in ascending index.
struct K6Ext {
    float v[2];  // min, max
    int i[2];    // n: none
    __device__ __forceinline__ void take(float y, int j, bool mn, bool mx,
                                         int n) {
        if (mn && (i[0] == n || y < v[0])) { v[0] = y; i[0] = j; }
        if (mx && (i[1] == n || y > v[1])) { v[1] = y; i[1] = j; }
    }
};

// What pass 3 of a stage reads besides the run: the prefix, the run's
// place, the geometry, the ramp's end sample (x[0] left, x[n-1] right), L
// and its reciprocal, which extrema the last stage takes, and where the
// next stage's end samples go.
struct K6Win {
    const double* ps;
    double* wb;
    int j0, cnt, n, L;
    double w, lf, yl;
    bool mn, mx;
};

// Pass 3 of a stage over a run of RUN samples in registers: s holds the
// run's prefix on entry and the stage's output (rounded to float32) on
// exit, unless LAST, where the output goes to the extrema instead. Without
// EDGE the run is whole (cnt == RUN) and holds no ramp sample: no sample
// needs a select or a clamp. With EDGE, a sample past the row (k >= cnt)
// is computed on clamped indices and dropped, its slot kept at +0.0, and
// S[i] is read from shared memory, so that the registers hold no more than
// the run while the selects are live. The row's first and last outputs go
// to wb as they are computed: a store of s[k] chosen by a runtime index
// would put s in local memory.
template <bool RIGHT, bool LAST, bool EDGE, int RUN>
__device__ __forceinline__ void k6_window(double (&s)[RUN], const K6Win& W,
                                          K6Ext& e) {
    const double stot = RIGHT && EDGE ? W.ps[W.n - 1] : 0.0;
    double sp = RIGHT && W.j0 > 0 ? W.ps[W.j0 - 1] : 0.0;  // S[i - 1]
    // the ramps' factors i + 1 and n - i at k = 0, exact in float64; a
    // constant k added or taken off each sample, for no conversion a sample
    const double fi0 = EDGE ? (double)(W.j0 + 1) : 0.0;
    const double fr0 = EDGE ? (double)(W.n - W.j0) : 0.0;
#pragma unroll
    for (int k = 0; k < RUN; ++k) {
        const int i = W.j0 + k;
        const double si = EDGE ? W.ps[i] : s[k];
        const double v =
            RIGHT ? k6_right<EDGE>(W.ps, sp, stot, i, W.n, W.L, W.w, W.lf,
                                   W.yl, __dsub_rn(fr0, (double)k))
                  : k6_left<EDGE>(W.ps, si, i, W.L, W.w, W.lf, W.yl,
                                  __dadd_rn(fi0, (double)k));
        sp = si;
        const float y = (float)v;
        const bool in = !EDGE || k < W.cnt;
        if (LAST && !EDGE) {
            // a whole run: its first sample starts the extrema
            if (W.mn && (k == 0 || y < e.v[0])) { e.v[0] = y; e.i[0] = i; }
            if (W.mx && (k == 0 || y > e.v[1])) { e.v[1] = y; e.i[1] = i; }
        } else if (LAST) {
            if (in) e.take(y, i, W.mn, W.mx, W.n);
        } else {
            const double yd = (double)y;
            s[k] = in ? yd : 0.0;
            if (k == 0 && W.j0 == 0) W.wb[0] = yd;
            if ((EDGE || k == RUN - 1) && i == W.n - 1) W.wb[1] = yd;
        }
    }
}

// Pass 3 of a stage: the instance for the stage's last-ness and for the
// warp's runs, chosen for the whole warp (a warp that diverged here would
// run both instances).
template <bool RIGHT, int RUN>
__device__ __forceinline__ void k6_window_run(double (&s)[RUN], const K6Win& W,
                                              K6Ext& e, bool last) {
    const bool edge = __any_sync(
        FULL_MASK,
        W.cnt < RUN || (RIGHT ? W.j0 + RUN > W.n - W.L : W.j0 < W.L));
    if (last) {
        if (edge) k6_window<RIGHT, true, true>(s, W, e);
        else k6_window<RIGHT, true, false>(s, W, e);
    } else {
        if (edge) k6_window<RIGHT, false, true>(s, W, e);
        else k6_window<RIGHT, false, false>(s, W, e);
    }
}

// The row's extrema from every thread's (block_argext's rule) into its
// four outputs; an output nothing needs holds 0.
__device__ __forceinline__ void k6_store(const CurrentParams& P, K6Ext e,
                                         bool mn, bool mx, int n,
                                         float (*redf)[K6_WARPS],
                                         int (*redi)[K6_WARPS], int lane,
                                         int wid) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        if (!(s == 0 ? mn : mx)) continue;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const float v2 = __shfl_down_sync(FULL_MASK, e.v[s], o);
            const int i2 = __shfl_down_sync(FULL_MASK, e.i[s], o);
            if (ext_better(v2, i2, e.v[s], e.i[s], s == 1, n)) {
                e.v[s] = v2;
                e.i[s] = i2;
            }
        }
        if (lane == 0) {
            redf[s][wid] = e.v[s];
            redi[s][wid] = e.i[s];
        }
    }
    __syncthreads();
    if (threadIdx.x != 0) return;
    float v[2] = {0.f, 0.f};
    int ix[2] = {n, n};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        if (!(s == 0 ? mn : mx)) continue;
        for (int w = 0; w < K6_WARPS; ++w)
            if (ext_better(redf[s][w], redi[s][w], v[s], ix[s], s == 1, n)) {
                v[s] = redf[s][w];
                ix[s] = redi[s][w];
            }
    }
    const long long row = blockIdx.x;
    P.out[0][row] = P.need[0] ? (float)ix[0] : 0.f;
    P.out[1][row] = P.need[1] ? (float)ix[1] : 0.f;
    P.out[2][row] = mn ? v[0] : 0.f;
    P.out[3][row] = mx ? v[1] : 0.f;
}

// RUN == K6_RUN: a thread's run in registers; RUN == 0: the generic
// instance, the runs in a float32 row in shared memory after the prefix. MN,
// MX: whether the minimum and the maximum are reduced (need).
template <int RUN, bool MN, bool MX>
__global__ void __launch_bounds__(K6_THREADS, K6_MIN_BLOCKS)
fused_current_kernel(const CurrentParams P) {
    extern __shared__ double k6_sm[];  // the float64 prefix
    __shared__ double red[K6_WARPS];   // the warp totals of a stage's runs
    __shared__ double wb[2][2];        // a stage's first and last sample
    __shared__ float redf[2][K6_WARPS];
    __shared__ int redi[2][K6_WARPS];
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    const int n = P.n_up, L = P.L;
    const long long row = blockIdx.x;
    const float* cr = P.c + row * (long long)P.n_curr;

    double* const ps = k6_sm;
    const int half = P.half, ratio = P.ratio;
    // j / ratio as the high word of j * (2^32 / ratio + 1) (K5's), exact
    // while j * ratio < 2^32, as every j < n_up + half is here when checked so
    const bool magic =
        ratio > 1 && (unsigned long long)(n + half) * ratio < (1ull << 32);
    const unsigned m = 0xffffffffu / (unsigned)ratio + 1u;
    auto src = [=](int j) {
        const unsigned u = j + half;
        return __ldg(cr + (magic ? __umulhi(u, m) : u / ratio));
    };
    const bool mn = MN, mx = MX;
    // the register instances' run [j0, j0 + RUN) in float64, widened once:
    // the stage's input, then (pass 2) its prefix, then (pass 3) the
    // stage's output. Its samples past the row are +0.0, which leave every
    // sum as it is; the prefix has slots for 256 whole runs. It is gathered
    // before the NaN test's barrier, so that the two reads of the row wait
    // on memory together.
    const int per = RUN > 0 ? RUN : k6_per(n);
    const int j0 = RUN > 0 ? tid * RUN : min(n, tid * per);
    const int cnt = max(0, min(per, n - j0));  // samples in the row
    double s[RUN > 0 ? RUN : 1];
    if constexpr (RUN > 0) {
#pragma unroll
        for (int k = 0; k < RUN; ++k) {
            const float v = src(min(j0 + k, n - 1));  // no branch a sample
            s[k] = k < cnt ? (double)v : 0.0;
        }
    }

    int bad = 0;
    const int last_bad = cur_poison_last(P);
    for (int i = tid; i < P.n_curr; i += K6_THREADS)
        bad |= cur_bad(__ldg(cr + i), i, last_bad);
    if (__syncthreads_or(bad)) {
        if (tid == 0) {
            const float qnan = __int_as_float(0x7fc00000);
            for (int q = 0; q < 4; ++q) P.out[q][row] = qnan;
        }
        return;
    }

    if constexpr (RUN > 0) {
        // the stages' first and last samples, by stage parity: the first
        // stage's from the row, each later stage's from pass 3 of the one
        // before it (read after barrier 2, written after the next barrier 2)
        if (tid == 0) wb[0][0] = s[0];
        if (cnt > 0 && j0 + cnt == n) wb[0][1] = (double)src(n - 1);
        for (int it = 0; it < P.num; ++it) {
            const bool right = ((it % 2 == 1) && P.mtype == 0) || P.mtype == 2;
            const bool last = it == P.num - 1;
            double run = 0.0;
#pragma unroll
            for (int k = 0; k < RUN; ++k) run += s[k];
            double acc = k6_start(run, red, lane, wid);
#pragma unroll
            for (int k = 0; k < RUN; ++k) {
                acc += s[k];
                s[k] = acc;
                ps[j0 + k] = acc;
            }
            __syncthreads();
            // the run's start and L, taken anew each stage (shuffles), so
            // that the compiler keeps neither L's reciprocal nor the ramps'
            // per-sample constants live across the passes in registers it
            // does not have
            const int jb = __shfl_sync(FULL_MASK, j0, lane);
            const int Lb = __shfl_sync(FULL_MASK, L, lane);
            const double lf = (double)Lb;
            const double w = wb[it & 1][right];
            const K6Win W = {ps, wb[(it + 1) & 1], jb, cnt, n, Lb, w, lf,
                             __drcp_rn(lf), mn, mx};
            K6Ext e = {{0.f, 0.f}, {n, n}};
            if (right) k6_window_run<true>(s, W, e, last);
            else k6_window_run<false>(s, W, e, last);
            if (last) k6_store(P, e, mn, mx, n, redf, redi, lane, wid);
        }
        if (P.num == 0) {
            K6Ext e = {{0.f, 0.f}, {n, n}};
#pragma unroll
            for (int k = 0; k < RUN; ++k)
                if (k < cnt) e.take((float)s[k], j0 + k, mn, mx, n);
            k6_store(P, e, mn, mx, n, redf, redi, lane, wid);
        }
    } else {
        K6Ext e = {{0.f, 0.f}, {n, n}};
        const double lf = (double)L, yl = __drcp_rn(lf);
        float* const xs = reinterpret_cast<float*>(ps + n);
        const bool owns_last = cnt > 0 && j0 + cnt == n;
        for (int k = 0; k < cnt; ++k) xs[j0 + k] = src(j0 + k);
        for (int it = 0; it < P.num; ++it) {
            const bool right = ((it % 2 == 1) && P.mtype == 0) || P.mtype == 2;
            const bool last = it == P.num - 1;
            double run = 0.0;
            for (int k = 0; k < cnt; ++k) run += (double)xs[j0 + k];
            if (tid == 0) wb[0][0] = (double)xs[0];
            if (owns_last) wb[0][1] = (double)xs[n - 1];
            double acc = k6_start(run, red, lane, wid);
            const double w0 = wb[0][0], wl = wb[0][1];
            for (int k = 0; k < cnt; ++k) {
                acc += (double)xs[j0 + k];
                ps[j0 + k] = acc;
            }
            __syncthreads();
            const double stot = ps[n - 1];
            for (int k = 0; k < cnt; ++k) {
                const int i = j0 + k;
                const double v =
                    right ? k6_right<true>(ps, i > 0 ? ps[i - 1] : 0.0, stot, i,
                                           n, L, wl, lf, yl, (double)(n - i))
                          : k6_left<true>(ps, ps[i], i, L, w0, lf, yl,
                                          (double)(i + 1));
                xs[i] = (float)v;  // the thread's own run: no other reads it
                if (last) e.take(xs[i], i, mn, mx, n);
            }
        }
        if (P.num == 0)
            for (int k = 0; k < cnt; ++k) e.take(xs[j0 + k], j0 + k, mn, mx, n);
        k6_store(P, e, mn, mx, n, redf, redi, lane, wid);
    }
}

typedef void (*K6Kernel)(const CurrentParams);

template <int RUN>
static K6Kernel k6_by_sides(bool mn, bool mx) {
    if (mn && mx) return fused_current_kernel<RUN, true, true>;
    if (mn) return fused_current_kernel<RUN, true, false>;
    if (mx) return fused_current_kernel<RUN, false, true>;
    return fused_current_kernel<RUN, false, false>;
}

// The instance for rows of n_up samples and the extrema asked for.
static K6Kernel k6_kernel(int n_up, bool mn, bool mx) {
    return k6_in_registers(n_up) ? k6_by_sides<K6_RUN>(mn, mx)
                                 : k6_by_sides<0>(mn, mx);
}

extern "C" int dspeed_fused_current(const CurrentParams* p, void* stream) {
    const int smem = dspeed_fused_current_smem_bytes(p->n_up);
    const K6Kernel fn = k6_kernel(p->n_up, p->need[0] || p->need[2],
                                  p->need[1] || p->need[3]);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (p->B == 0) return 0;
    fn<<<p->B, K6_THREADS, smem, (cudaStream_t)stream>>>(*p);
    return (int)cudaGetLastError();
}

// How a row of n_up upsampled samples launches (the instance for need_min
// / need_max): threads and rows a block, shared memory bytes a block
// (dynamic), blocks per SM, registers and local bytes per thread.
extern "C" int dspeed_fused_current_config(int n_up, int need_min, int need_max,
                                           int* out) {
    const int smem = dspeed_fused_current_smem_bytes(n_up);
    const K6Kernel fn = k6_kernel(n_up, need_min != 0, need_max != 0);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, K6_THREADS,
                                                        smem);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return (int)err;
    const int vals[] = {K6_THREADS, 1,           smem,
                        per_sm,     attr.numRegs, (int)attr.localSizeBytes};
    for (int i = 0; i < 6; ++i) out[i] = vals[i];
    return 0;
}

// ---------------------------------------------------------------------------
// K5: the polyphase route
//
// One warp per event, K5_EPB events a block. The per-phase filters are
// staged once per block behind the kernel's only barrier; after it a warp
// meets only its own lanes (__syncwarp, shuffles, votes). Shared memory
// holds, per warp, its row of c and one edge window's float64 prefix; the
// curve itself never leaves registers.
//
// The edge windows (W = 256) run the staged cascade eight samples a lane,
// sample 32 s + l in lane l, stage by stage, the left window then the
// right. Each stage's float64 prefix equals, bit for bit, the one
// row_prefix.cuh's block scan takes over 256 threads (one sample a thread):
// where every partial sum of the window is exact (k5_exact: nearly every
// window of real currents) the order cannot change it, and the lanes sum
// runs of eight samples and scan the run totals once; elsewhere the block
// scan's own order is followed. The stage's formulas are mw_cascade.cuh's,
// intrinsic for intrinsic, one division a sample; the left window's stages
// divide only where its kept range depends on them. So every kept edge
// sample equals the block kernel's bit for bit. The interior is
// register-tiled: a lane owns K5_R consecutive current samples t, holds
// the K5_R + nq - 1 samples of c they read in registers, and walks the
// phases with each tap H[p][k] broadcast from shared memory to K5_R FMAs;
// each output is fmaf over ascending k from 0.f, the per-phase sums of the
// plan. The extrema: each lane keeps its kept edge samples'
// first-occurrence (value, index) and, in the interior, only each column
// t's extreme value (one fmaxf / fminf an output) and its first best
// column. The warp agrees on the row's extreme value V, each lane offers
// its first sample equal to V (recomputing at most one column's phases,
// bit for bit), and the lowest index wins: the first occurrence, as the
// block kernel's strict comparisons with the lower index on ties give it.
// A row with a NaN, or an infinite current sample that the upsampled row
// reads, gives NaN on all four outputs, as the plain composition does (an
// infinite sample turns the cascade's prefix differences into NaN), so no
// curve sample is NaN. With no stage (num == 0) an infinity poisons
// nothing: the curve is the upsampled row itself, and each phase's filter
// is a single 1 among zeros (nq <= 2, the generic instance), whose zero
// taps add nothing (k5_tap) rather than 0 * inf = NaN.
//
// On the H100 at the flagship geometry no single pipe bounds it: the
// float64 divisions of the edge stages and the interior's FMAs and folds
// are its largest costs, and 16 events a block at 64 registers (2 blocks
// an SM) was the fastest launch without spills.

#define K5_EPB 16         // events (warps) a block; fewer where a row does not fit
#define K5_MIN_BLOCKS 2   // blocks an SM that the registers must allow
#define K5_W 256          // edge-window width (_poly_plan.W)
#define K5_SPL (K5_W / 32)  // window samples a lane
#define K5_R 10           // consecutive current samples a lane filters
#define K5_R2 5           // the same where both extrema are reduced, so that
                          // the registers hold them without spills
#define K5_NQ 11          // taps of the register-tiled instances (the flagship's)
#define K5_MAX_SMEM 232448  // bytes of shared memory a block may use
#define K5_FULL 0xffffffffu

// Shared memory of a block of epb events: per warp a float64 window and its
// row of c (rounded up to 4 floats but for the last), then the filters.
__host__ __device__ inline int k5_cs_stride(int n_curr) {
    return (n_curr + 3) / 4 * 4;
}

__host__ __device__ inline int k5_smem(int n_curr, int n_h, int epb) {
    return 8 * K5_W * epb + 4 * (k5_cs_stride(n_curr) * (epb - 1) + n_curr) +
           4 * n_h;
}

// Events a block: K5_EPB, halved until the block's memory fits.
static int k5_epb(int n_curr, int n_h) {
    int epb = K5_EPB;
    while (epb > 1 && k5_smem(n_curr, n_h, epb) > K5_MAX_SMEM) epb /= 2;
    return epb;
}

extern "C" int dspeed_fused_current_poly_smem_bytes(int n_curr, int n_up,
                                                    int n_h, int W) {
    (void)n_up;
    if (W != K5_W) return 0x7fffffff;  // the kernel is built for one width
    return k5_smem(n_curr, n_h, k5_epb(n_curr, n_h));
}

template <bool MAX>
__device__ __forceinline__ float k5_ext(float a, float b) {
    return MAX ? fmaxf(a, b) : fminf(a, b);
}

// Keep (v, j) where it is the better first-occurrence extremum.
template <bool MAX>
__device__ __forceinline__ void k5_take(float& bv, int& bi, float v, int j) {
    if ((MAX ? v > bv : v < bv) || (v == bv && j < bi)) {
        bv = v;
        bi = j;
    }
}

// Where sample i of a window's float64 prefix lies in the warp's scratch:
// the low four bits of i swizzled by the next four, so that both the
// lanes' consecutive samples and eight-sample runs meet no bank conflict.
__device__ __forceinline__ int k5_sw(int i) { return i ^ ((i >> 3) & 15); }

// Whether every partial sum of the window is exact in float64, in any
// order: its nonzero samples are finite float32, each a multiple of
// 2^(f - 150) and below 2^(f - 126) (f its exponent field, 1 for a
// denormal), so 256 of them sum exactly when the fields span at most
// 53 - 24 - 8 = 21.
__device__ __forceinline__ bool k5_exact(const float (&x)[K5_SPL]) {
    int fmin = 255, fmax = 0;
#pragma unroll
    for (int s = 0; s < K5_SPL; ++s) {
        const unsigned u = __float_as_uint(x[s]);
        if (u << 1) {
            const int f = max((int)((u >> 23) & 255), 1);
            fmin = min(fmin, f);
            fmax = max(fmax, f);
        }
    }
    fmin = __reduce_min_sync(K5_FULL, fmin);
    fmax = __reduce_max_sync(K5_FULL, fmax);
    return fmax - fmin <= 21;
}

// A window's inclusive float64 prefix into ps, equal bit for bit to the
// block scan's over 256 threads (one sample a thread). Where every partial
// sum is exact (k5_exact) the order cannot matter, and the lanes sum runs of
// eight consecutive samples (transposed through ps) and scan the run totals
// once. Otherwise the block scan's order: a Kogge-Stone scan of each
// 32-sample chunk, a Kogge-Stone scan of the eight chunk totals, then
// (chunk offset + exclusive) + sample.
__device__ __forceinline__ void k5_prefix(const float (&x)[K5_SPL], double* ps,
                                          int lane) {
    if (k5_exact(x)) {
        float* xs = reinterpret_cast<float*>(ps);
#pragma unroll
        for (int s = 0; s < K5_SPL; ++s) xs[32 * s + lane] = x[s];
        __syncwarp();
        const float4 a = reinterpret_cast<const float4*>(xs)[2 * lane];
        const float4 b = reinterpret_cast<const float4*>(xs)[2 * lane + 1];
        __syncwarp();  // read before ps overwrites it
        const float v[K5_SPL] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        double r[K5_SPL], t = 0.0;
#pragma unroll
        for (int j = 0; j < K5_SPL; ++j) {
            t += (double)v[j];
            r[j] = t;
        }
        double inc = t;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const double y = __shfl_up_sync(K5_FULL, inc, o);
            if (lane >= o) inc += y;
        }
        const double off = inc - t;  // the lanes below
#pragma unroll
        for (int j = 0; j < K5_SPL; ++j)
            ps[k5_sw(K5_SPL * lane + j)] = off + r[j];
        return;
    }
    double incl[K5_SPL], tot[K5_SPL];
#pragma unroll
    for (int s = 0; s < K5_SPL; ++s) {
        double v = 0.0;  // a thread's run of one sample, as summed there
        v += (double)x[s];
        incl[s] = v;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
#pragma unroll
        for (int s = 0; s < K5_SPL; ++s) {
            const double y = __shfl_up_sync(K5_FULL, incl[s], o);
            if (lane >= o) incl[s] += y;
        }
#pragma unroll
    for (int s = 0; s < K5_SPL; ++s) {
        tot[s] = __shfl_sync(K5_FULL, incl[s], 31);
        const double excl = __shfl_up_sync(K5_FULL, incl[s], 1);
        incl[s] = lane == 0 ? 0.0 : excl;
    }
    // the chunk totals' scan, as the block scan's first warp runs it
#pragma unroll
    for (int o = 1; o < K5_SPL; o <<= 1)
#pragma unroll
        for (int s = K5_SPL - 1; s >= o; --s) tot[s] += tot[s - o];
#pragma unroll
    for (int s = 0; s < K5_SPL; ++s) {
        double v = (s > 0 ? tot[s - 1] : 0.0) + incl[s];
        v += (double)x[s];
        ps[k5_sw(32 * s + lane)] = v;
    }
}

// One moving average of L samples over a window, in place in x:
// mw_cascade.cuh's mw_stage, formula for formula, for the samples in [lo,
// hi). Each sample's numerator is chosen before its one division, so that
// lanes on both sides of a ramp do not issue two divisions.
__device__ __forceinline__ void k5_stage(float (&x)[K5_SPL], double* ps,
                                         int lane, int L, bool right, int lo,
                                         int hi) {
    k5_prefix(x, ps, lane);
    const double w0 = (double)__shfl_sync(K5_FULL, x[0], 0);
    const double wl = (double)__shfl_sync(K5_FULL, x[K5_SPL - 1], 31);
    __syncwarp();
    const double lf = (double)L;
    const int n = K5_W;
#pragma unroll
    for (int s = 0; s < K5_SPL; ++s) {
        const int i = 32 * s + lane;
        if (i < lo || i >= hi) continue;
        double num, base;
        bool ramp;
        if (!right) {
            // i < L: w0 + (S[i] - (i+1) w0) / L; else (S[i] - S[i-L]) / L
            ramp = i < L;
            const double sl = ps[k5_sw(max(i - L, 0))];
            num = __dsub_rn(ps[k5_sw(i)],
                            ramp ? __dmul_rn((double)(i + 1), w0) : sl);
            base = w0;
        } else {
            // i > n-1-L: wl + ((S[n-1] - S[i-1]) - (n-i) wl) / L;
            // else (S[i+L-1] - S[i-1]) / L
            const double se = i > 0 ? ps[k5_sw(i - 1)] : 0.0;
            ramp = i > n - 1 - L;
            const double sr = ps[k5_sw(min(i + L - 1, n - 1))];
            num = ramp ? __dsub_rn(__dsub_rn(sr, se),
                                   __dmul_rn((double)(n - i), wl))
                       : __dsub_rn(sr, se);
            base = wl;
        }
        const double q = __ddiv_rn(num, lf);
        x[s] = (float)(ramp ? __dadd_rn(base, q) : q);
    }
    __syncwarp();  // every lane has read ps before it is written again
}

// The end of the left window's samples [0, hi) that stage `it` must
// compute: EL in the last stage; in each earlier stage, what the stage
// after it reads: its own range for a left stage, that range widened by
// L - 1 for a right stage, or the whole window where a right stage reads
// its end ramp.
__device__ __forceinline__ int k5_left_hi(const CurrentParams& P, int it) {
    int hi = P.EL;
    for (int j = P.num - 1; j > it; --j)
        if (((j % 2 == 1) && P.mtype == 0) || P.mtype == 2)
            hi = hi > K5_W - P.L ? K5_W : hi + P.L - 1;
    return hi;
}

// A lane's interior extrema so far: the best column's value and its t
// (-1: none yet), the first best in ascending t.
struct K5Cols {
    float v[2];  // min, max
    int t[2];
};

template <bool MN, bool MX>
__device__ __forceinline__ void k5_col(K5Cols& b, float vmin, float vmax,
                                       int t) {
    if (MN && (b.t[0] < 0 || vmin < b.v[0])) { b.v[0] = vmin; b.t[0] = t; }
    if (MX && (b.t[1] < 0 || vmax > b.v[1])) { b.v[1] = vmax; b.t[1] = t; }
}

// acc + h c in the generic instance's sums, a zero tap adding nothing: with
// no stage a phase's filter is a 1 among zeros, and 0 * inf would be NaN.
// A finite sum is unchanged (but for the sign of a zero).
__device__ __forceinline__ float k5_tap(float h, float c, float acc) {
    return h == 0.f ? acc : fmaf(h, c, acc);
}

// y[ratio t + p] for p < ratio, t in [t_a, t_b): each column's extremes
// into b. NQ > 0: R consecutive t a lane (K5_R, or K5_R2 where both
// extrema are reduced), c from registers, nq == NQ taps; NQ == 0: any nq,
// one t at a time from shared memory.
template <int NQ, bool MN, bool MX>
__device__ __forceinline__ void k5_interior(const CurrentParams& P,
                                            const float* cs, const float* hs,
                                            int t_a, int t_b, int lane,
                                            K5Cols& b) {
    const int ratio = P.ratio, nq = P.nq, q_min = P.q_min;
    if constexpr (NQ == 0) {
        for (int t = t_a + lane; t < t_b; t += 32) {
            const float* cc = cs + t + q_min;
            float mn = INFINITY, mx = -INFINITY;
            for (int p = 0; p < ratio; ++p) {
                const float* hp = hs + p * nq;
                float acc = 0.f;
                for (int k = 0; k < nq; ++k) acc = k5_tap(hp[k], cc[k], acc);
                mn = fminf(mn, acc);
                mx = fmaxf(mx, acc);
            }
            k5_col<MN, MX>(b, mn, mx, t);
        }
    } else {
        constexpr int R = MN && MX ? K5_R2 : K5_R;
        constexpr int NW = R + NQ - 1;
        for (int t0 = t_a + lane * R; t0 < t_b; t0 += 32 * R) {
            float cw[NW];
            const int g0 = t0 + q_min;  // >= 0 (the plan)
#pragma unroll
            for (int i = 0; i < NW; ++i)
                cw[i] = g0 + i < P.n_curr ? cs[g0 + i] : 0.f;
            float mn[R], mx[R];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                mn[r] = INFINITY;
                mx[r] = -INFINITY;
            }
            for (int p = 0; p < ratio; ++p) {
                float acc[R];
#pragma unroll
                for (int r = 0; r < R; ++r) acc[r] = 0.f;
                const float* hp = hs + p * nq;
#pragma unroll
                for (int k = 0; k < NQ; ++k) {
                    const float h = hp[k];
#pragma unroll
                    for (int r = 0; r < R; ++r)
                        acc[r] = fmaf(h, cw[r + k], acc[r]);
                }
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    if (MN) mn[r] = fminf(mn[r], acc[r]);
                    if (MX) mx[r] = fmaxf(mx[r], acc[r]);
                }
            }
            const int cnt = min(R, t_b - t0);
#pragma unroll
            for (int r = 0; r < R; ++r)
                if (r < cnt) k5_col<MN, MX>(b, mn[r], mx[r], t0 + r);
        }
    }
}

// The row's first-occurrence extremum on one side, in every lane: from the
// lane's edge candidate (ev, ei) and its best interior column (cv, ct),
// whose phases are summed again as k5_interior<NQ> sums them.
template <int NQ, bool MAX>
__device__ __forceinline__ void k5_resolve(const CurrentParams& P,
                                           const float* cs, const float* hs,
                                           float ev, int ei, float cv, int ct,
                                           float& v_out, int& i_out) {
    const int n_up = P.n_up, ratio = P.ratio, nq = P.nq;
    float V = ct < 0 ? ev : (ei == n_up ? cv : k5_ext<MAX>(ev, cv));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        V = k5_ext<MAX>(V, __shfl_xor_sync(K5_FULL, V, off));
    int ci = n_up;
    float cval = 0.f;
    if (ei < n_up && ev == V) {
        ci = ei;
        cval = ev;
    }
    if (ct >= 0 && cv == V) {  // the first phase of column ct that holds V
        const float* cc = cs + ct + P.q_min;
        for (int p = 0; p < ratio; ++p) {
            const float* hp = hs + p * nq;
            float acc = 0.f;
            for (int k = 0; k < nq; ++k)
                acc = NQ == 0 ? k5_tap(hp[k], cc[k], acc)
                              : fmaf(hp[k], cc[k], acc);
            if (acc == V) {
                if (ratio * ct + p < ci) {
                    ci = ratio * ct + p;
                    cval = acc;
                }
                break;
            }
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const int oi = __shfl_xor_sync(K5_FULL, ci, off);
        const float ov = __shfl_xor_sync(K5_FULL, cval, off);
        if (oi < ci) {
            ci = oi;
            cval = ov;
        }
    }
    v_out = cval;
    i_out = ci;
}

template <int NQ, bool MN, bool MX>
__global__ void __launch_bounds__(32 * K5_EPB, K5_MIN_BLOCKS)
fused_current_poly_kernel(const CurrentParams P, int epb) {
    extern __shared__ double k5_sm[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_curr = P.n_curr, n_up = P.n_up, ratio = P.ratio;
    const int n_h = ratio * P.nq, ncs = k5_cs_stride(n_curr);
    float* const cbase = reinterpret_cast<float*>(k5_sm + K5_W * epb);
    float* const hs = cbase + ncs * (epb - 1) + n_curr;
    for (int k = threadIdx.x; k < n_h; k += blockDim.x) hs[k] = P.H[k];
    __syncthreads();  // the kernel's only block barrier

    const long long row = (long long)blockIdx.x * epb + warp;
    if (row >= P.B) return;
    double* const ps = k5_sm + K5_W * warp;
    float* const cs = cbase + ncs * warp;

    // the row of c, 16 bytes a lane where it is aligned, and whether it
    // holds a NaN or an infinity
    const float* cr = P.c + row * (long long)n_curr;
    int bad = 0;
    int head = 0;
    if ((reinterpret_cast<unsigned long long>(cr) & 15) == 0) {
        head = n_curr / 4 * 4;
        for (int i = 4 * lane; i < head; i += 128) {
            const float4 v = *reinterpret_cast<const float4*>(cr + i);
            bad |= !isfinite(v.x) | !isfinite(v.y) | !isfinite(v.z) |
                   !isfinite(v.w);
            *reinterpret_cast<float4*>(cs + i) = v;
        }
    }
    for (int i = head + lane; i < n_curr; i += 32) {
        const float v = cr[i];
        bad |= !isfinite(v);
        cs[i] = v;
    }
    if (__any_sync(K5_FULL, bad)) {
        // a row with a non-finite sample, taken again from its copy: a NaN
        // anywhere, or an infinity that poisons (cur_poison_last), gives
        // NaN (cur_bad; testing each sample so in the loop above costs K5
        // 1%)
        __syncwarp();
        const int last_bad = cur_poison_last(P);
        bad = 0;
        for (int i = lane; i < n_curr; i += 32) bad |= cur_bad(cs[i], i, last_bad);
        if (__any_sync(K5_FULL, bad)) {
            if (lane == 0) {
                const float qnan = __int_as_float(0x7fc00000);
                for (int q = 0; q < 4; ++q) P.out[q][row] = qnan;
            }
            return;
        }
    }
    __syncwarp();

    // the edge windows [0, W) and [n_up - W, n_up), replicated from c, each
    // through the cascade; the last stage computes only the kept ranges
    const int half = P.half, jr = n_up - K5_W;
    // j / ratio as the high word of j * (2^32 / ratio + 1), for ratio > 1:
    // exact while j * ratio < 2^32, as every j < n_up + half is here when
    // checked so
    const bool magic = ratio > 1 &&
        (unsigned long long)(n_up + half) * ratio < (1ull << 32);
    const unsigned m = 0xffffffffu / (unsigned)ratio + 1u;
    float xl[K5_SPL], xr[K5_SPL];
#pragma unroll
    for (int s = 0; s < K5_SPL; ++s) {
        const unsigned i = 32 * s + lane + half, k = jr + i;
        xl[s] = cs[magic ? __umulhi(i, m) : i / ratio];
        xr[s] = cs[magic ? __umulhi(k, m) : k / ratio];
    }
    for (int it = 0; it < P.num; ++it) {
        const bool right = ((it % 2 == 1) && P.mtype == 0) || P.mtype == 2;
        const bool last = it == P.num - 1;
        k5_stage(xl, ps, lane, P.L, right, 0, k5_left_hi(P, it));
        k5_stage(xr, ps, lane, P.L, right, last ? K5_W - P.ERW : 0, K5_W);
    }

    // the lane's candidates: its kept edge samples, its interior columns
    float emin = INFINITY, emax = -INFINITY;
    int eimin = n_up, eimax = n_up;
#pragma unroll
    for (int s = 0; s < K5_SPL; ++s) {
        const int i = 32 * s + lane;
        if (i < P.EL) {
            if (MN) k5_take<false>(emin, eimin, xl[s], i);
            if (MX) k5_take<true>(emax, eimax, xl[s], i);
        }
        if (i >= K5_W - P.ERW) {
            if (MN) k5_take<false>(emin, eimin, xr[s], jr + i);
            if (MX) k5_take<true>(emax, eimax, xr[s], jr + i);
        }
    }
    K5Cols cols = {{INFINITY, -INFINITY}, {-1, -1}};
    k5_interior<NQ, MN, MX>(P, cs, hs, P.EL / ratio, (n_up - P.ERW) / ratio,
                            lane, cols);

    float vmin = 0.f, vmax = 0.f;
    int imin = n_up, imax = n_up;
    if (MN)
        k5_resolve<NQ, false>(P, cs, hs, emin, eimin, cols.v[0], cols.t[0], vmin,
                              imin);
    if (MX)
        k5_resolve<NQ, true>(P, cs, hs, emax, eimax, cols.v[1], cols.t[1], vmax,
                             imax);
    if (lane == 0) {
        P.out[0][row] = P.need[0] ? (float)imin : 0.f;
        P.out[1][row] = P.need[1] ? (float)imax : 0.f;
        P.out[2][row] = vmin;
        P.out[3][row] = vmax;
    }
}

typedef void (*K5Kernel)(const CurrentParams, int);

template <int NQ>
static K5Kernel k5_by_sides(bool mn, bool mx) {
    if (mn && mx) return fused_current_poly_kernel<NQ, true, true>;
    if (mn) return fused_current_poly_kernel<NQ, true, false>;
    if (mx) return fused_current_poly_kernel<NQ, false, true>;
    return fused_current_poly_kernel<NQ, false, false>;
}

// The instance for nq taps and the extrema asked for: the register-tiled
// one where nq == K5_NQ (the flagship's), else the generic one.
static K5Kernel k5_kernel(int nq, bool mn, bool mx) {
    if (nq == K5_NQ) return k5_by_sides<K5_NQ>(mn, mx);
    return k5_by_sides<0>(mn, mx);
}

extern "C" int dspeed_fused_current_poly(const CurrentParams* p, void* stream) {
    if (p->W != K5_W) return (int)cudaErrorInvalidValue;
    const int n_h = p->ratio * p->nq;
    const bool mn = p->need[0] || p->need[2], mx = p->need[1] || p->need[3];
    const int epb = k5_epb(p->n_curr, n_h);
    const int smem = k5_smem(p->n_curr, n_h, epb);
    const K5Kernel fn = k5_kernel(p->nq, mn, mx);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (p->B == 0) return 0;
    const int blocks = (int)((p->B + epb - 1) / epb);
    fn<<<blocks, 32 * epb, smem, (cudaStream_t)stream>>>(*p, epb);
    return (int)cudaGetLastError();
}

// How a row of n_curr samples with nq taps a phase launches (the instance
// for need_min / need_max): events and threads a block, shared memory bytes
// a block, blocks per SM, registers and local bytes per thread.
extern "C" int dspeed_fused_current_poly_config(int n_curr, int ratio,
                                                int n_up, int nq, int need_min,
                                                int need_max, int* out) {
    (void)n_up;
    const int n_h = ratio * nq;
    const int epb = k5_epb(n_curr, n_h);
    const int smem = k5_smem(n_curr, n_h, epb);
    const K5Kernel fn = k5_kernel(nq, need_min != 0, need_max != 0);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, 32 * epb,
                                                        smem);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return (int)err;
    const int vals[] = {epb,    32 * epb,     smem,
                        per_sm, attr.numRegs, (int)attr.localSizeBytes};
    for (int i = 0; i < 6; ++i) out[i] = vals[i];
    return 0;
}

extern "C" const char* dspeed_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
