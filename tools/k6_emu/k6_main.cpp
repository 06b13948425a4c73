// Runs K6 (fused_current.cu's up-domain kernel, included as KSRC, turned
// into host C++ by run_k6_emu.py) and a reference kernel over the same rows
// and writes both kernels' four outputs.
//
// The reference is the up-domain kernel as it stood before its register
// design: load_current's NaN rule (with no stage, an infinity poisons
// nothing), the replication, mw_cascade.cuh's block
// scan and stages over the whole row in shared memory (12 n_up bytes), and
// block_argext's first-occurrence extrema, over the unchanged headers.
//
//     k6_main IN OUT       the rows of IN through both kernels into OUT
//     k6_main --div N      k6_div against the division, N numerators an L
#include "cuda_runtime.h"
thread_local emu_dim3 threadIdx, blockIdx;
emu_dim3 blockDim, gridDim;
EmuBlock* emu_blk;
thread_local std::vector<EmuCp> emu_cp_queue;

#include KSRC

#include "mw_cascade.cuh"

#include <cstdio>
#include <cstdlib>
#include <random>

static bool ref_load_current(const CurrentParams& P, long long row) {
    const float* cr = P.c + row * (long long)P.n_curr;
    int bad = 0;
    for (int i = threadIdx.x; i < P.n_curr; i += blockDim.x) {
        const float v = cr[i];
        const int j0 = i * P.ratio - P.half;
        // an infinity poisons only where a stage takes prefix differences
        bad |= isnan(v) | (isinf(v) & (P.num > 0) & (j0 <= P.n_up - 1) &
                           (j0 + P.ratio > 0));
    }
    return __syncthreads_or(bad) != 0;
}

static void ref_store_extrema(const CurrentParams& P, const float* y, int n,
                              bool bad, long long row, float* redf, int* redi) {
    const bool nmin = P.need[0] || P.need[2], nmax = P.need[1] || P.need[3];
    float vmin = 0.f, vmax = 0.f;
    int imin = n, imax = n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float v = y[i];
        if (nmin && (imin == n || v < vmin)) { vmin = v; imin = i; }
        if (nmax && (imax == n || v > vmax)) { vmax = v; imax = i; }
    }
    if (nmin) block_argext(vmin, imin, false, n, redf, redi);
    if (nmax) block_argext(vmax, imax, true, n, redf, redi);
    if (threadIdx.x == 0) {
        const float qnan = __int_as_float(0x7fc00000);
        P.out[0][row] = bad ? qnan : (P.need[0] ? (float)imin : 0.f);
        P.out[1][row] = bad ? qnan : (P.need[1] ? (float)imax : 0.f);
        P.out[2][row] = bad ? qnan : (nmin ? vmin : 0.f);
        P.out[3][row] = bad ? qnan : (nmax ? vmax : 0.f);
    }
}

static void ref_kernel(const CurrentParams P) {
    static double red[32];
    static float redf[32];
    static int redi[32];
    const int n_up = P.n_up;
    double* ps = (double*)emu_blk->smem;
    float* x = (float*)(ps + n_up);
    const long long row = blockIdx.x;
    const float* cr = P.c + row * (long long)P.n_curr;
    for (int j = threadIdx.x; j < n_up; j += blockDim.x)
        x[j] = cr[(j + P.half) / P.ratio];
    const bool bad = ref_load_current(P, row);
    mw_cascade(x, n_up, P.L, P.num, P.mtype, ps, red);
    ref_store_extrema(P, x, n_up, bad, row, redf, redi);
}

template <class T> static T rd(FILE* f) { T v; if (fread(&v, sizeof v, 1, f) != 1) abort(); return v; }

// k6_div(a, L, RN(1/L)) against a / L: numerators that are multiples of
// 2^-149 (as every K6 numerator is), of every exponent from -149 to 140.
static int div_check(long long n) {
    std::mt19937_64 rng(12);
    long long bad = 0;
    for (int L = 1; L <= 128; ++L) {
        const double lf = L, yl = __drcp_rn(lf);
        for (long long k = 0; k < n; ++k) {
            const unsigned long long u = rng();
            const int bits = 1 + (int)(u % 53);
            const long long mant = (long long)((rng() >> (64 - bits)) | 1ull);
            const int e = -149 + (int)(rng() % 237);
            const double a = std::ldexp((double)mant, e) * ((u >> 60) & 1 ? -1 : 1);
            if (!std::isfinite(a)) continue;
            const double want = a / lf, got = k6_div(a, lf, yl);
            if (memcmp(&want, &got, 8) != 0 && ++bad <= 5)
                fprintf(stderr, "k6_div(%a, %d) = %a, not %a\n", a, L, got, want);
        }
    }
    printf("k6_div: %lld of %lld quotients differ from the division\n", bad, 128 * n);
    return bad != 0;
}

int main(int argc, char** argv) {
    if (argc == 3 && !strcmp(argv[1], "--div")) return div_check(atoll(argv[2]));
    FILE* f = fopen(argv[1], "rb");
    CurrentParams P;
    memset(&P, 0, sizeof P);
    P.B = rd<int>(f); P.n_curr = rd<int>(f); P.ratio = rd<int>(f);
    P.half = rd<int>(f); P.n_up = rd<int>(f); P.L = rd<int>(f);
    P.num = rd<int>(f); P.mtype = rd<int>(f);
    for (int q = 0; q < 4; ++q) P.need[q] = rd<int>(f);
    const unsigned char fill = (unsigned char)rd<int>(f);
    const long long nc = (long long)P.B * P.n_curr;
    float* c = (float*)malloc(4 * nc + 16);
    if (fread(c, 4, nc, f) != (size_t)nc) abort();
    fclose(f);
    P.c = c;
    std::vector<float> outs[2];
    for (auto& o : outs) o.assign(4 * (size_t)P.B, 0.f);
    gridDim.x = P.B;
    const bool regs = k6_in_registers(P.n_up);
    const K6Kernel kernel = k6_kernel(P.n_up, P.need[0] || P.need[2],
                                      P.need[1] || P.need[3]);
    const int smem = dspeed_fused_current_smem_bytes(P.n_up);
    for (int which = 0; which < 2; ++which) {
        for (int q = 0; q < 4; ++q) P.out[q] = outs[which].data() + (size_t)q * P.B;
        for (int b = 0; b < P.B; ++b) {
            if (which == 0)
                emu_run_block(b, K6_THREADS, smem, [&] { kernel(P); }, fill);
            else
                emu_run_block(b, 256, 12 * (size_t)P.n_up, [&] { ref_kernel(P); }, fill);
        }
    }
    FILE* o = fopen(argv[2], "wb");
    for (auto& v : outs) fwrite(v.data(), 4, v.size(), o);
    fclose(o);
    printf("%s instance, %d bytes of shared memory a block\n",
           regs ? "register" : "generic", smem);
    return 0;
}
