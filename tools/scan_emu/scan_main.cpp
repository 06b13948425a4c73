// Runs the sweeps of peakdet_scan.cu and bilevel_scan.cu (included as PKSRC
// and BLSRC, turned into host C++ by run_scan_emu.py) over the rows of an
// input file and writes their outputs.
//
//     scan_main IN OUT
//
// IN: int32 kind (0 the peak finder, 1 the bi-level trigger), f64, B, n,
// stride, offset (of the first row, in samples), then m_max, m_min, reverse
// (kind 0) or m, 0, 0 (kind 1), and the fill byte of the outputs; the rows'
// buffer (offset + (B - 1) stride + n samples); then dmax, dmin, amax, amin
// (kind 0, B each in the rows' type) or pos, neg (B each) and gate, start
// (B int32 each). OUT: smax, smin, nmax, nmin (kind 0) or nc, pol, trig.
// Every buffer is allocated at exactly its size, so that under
// AddressSanitizer a read or write past it fails.
#include "cuda_runtime.h"
thread_local emu_dim3 threadIdx, blockIdx;
emu_dim3 blockDim, gridDim;
EmuBlock* emu_blk;
thread_local std::vector<EmuCp> emu_cp_queue;

#include PKSRC
#include BLSRC

#include <cstdio>
#include <cstdlib>

template <class T> static T rd(FILE* f) { T v; if (fread(&v, sizeof v, 1, f) != 1) abort(); return v; }

// n values, 16-byte aligned, exactly n of them (filled with `fill`, or read
// from f).
template <class T> static T* buf(long long n, FILE* f = nullptr, int fill = 0) {
    void* p = nullptr;
    if (posix_memalign(&p, 16, n ? sizeof(T) * n : 1)) abort();
    memset(p, fill, sizeof(T) * n);
    if (f && n && fread(p, sizeof(T), n, f) != (size_t)n) abort();
    return (T*)p;
}

template <class T> static void put(FILE* o, const T* p, long long n) {
    if (n) fwrite(p, sizeof(T), n, o);
}

template <class T>
static void run(FILE* f, FILE* o, int kind, int B, int n, long long stride, int off,
                int a, int b, int c, int fill) {
    T* w = buf<T>(off + (B - 1) * stride + n, f) + off;
    if (kind == 0) {
        PeakdetParams P;
        memset(&P, 0, sizeof P);
        P.w = w;
        P.stride = stride;
        P.dmax = buf<T>(B, f);
        P.dmin = buf<T>(B, f);
        P.amax = buf<T>(B, f);
        P.amin = buf<T>(B, f);
        P.smax = buf<T>((long long)B * a, nullptr, fill);
        P.smin = buf<T>((long long)B * b, nullptr, fill);
        P.nmax = buf<int>(B, nullptr, fill);
        P.nmin = buf<int>(B, nullptr, fill);
        P.B = B, P.n = n, P.m_max = a, P.m_min = b, P.reverse = c, P.f64 = sizeof(T) == 8;
        const int blocks = (B + PK_WARPS - 1) / PK_WARPS;
        gridDim.x = blocks;
        for (int k = 0; k < blocks; ++k)
            emu_run_block(k, PK_THREADS, 0, [&] { peakdet_scan_kernel<T>(P); }, fill);
        put(o, (T*)P.smax, (long long)B * a);
        put(o, (T*)P.smin, (long long)B * b);
        put(o, (int*)P.nmax, B);
        put(o, (int*)P.nmin, B);
    } else {
        BilevelParams P;
        memset(&P, 0, sizeof P);
        P.w = w;
        P.stride = stride;
        P.pos = buf<T>(B, f);
        P.neg = buf<T>(B, f);
        P.gate = buf<int>(B, f);
        P.start = buf<int>(B, f);
        P.nc = buf<int>(B, nullptr, fill);
        P.pol = buf<T>((long long)B * a, nullptr, fill);
        P.trig = buf<T>((long long)B * a, nullptr, fill);
        P.B = B, P.n = n, P.m = a, P.f64 = sizeof(T) == 8;
        const int vec = bl_vec_ok<T>(&P);
        const int blocks = (B + BL_WARPS - 1) / BL_WARPS;
        gridDim.x = blocks;
        if (n > 0)
            for (int k = 0; k < blocks; ++k)
                emu_run_block(k, BL_THREADS, 0, [&] { bilevel_scan_kernel<T>(P, vec); }, fill);
        put(o, P.nc, B);
        put(o, (T*)P.pol, (long long)B * a);
        put(o, (T*)P.trig, (long long)B * a);
        printf("16-byte loads: %d\n", vec);
    }
}

int main(int argc, char** argv) {
    if (argc != 3) return 2;
    FILE* f = fopen(argv[1], "rb");
    if (!f) return 2;
    const int kind = rd<int>(f), f64 = rd<int>(f), B = rd<int>(f), n = rd<int>(f);
    const long long stride = rd<int>(f);
    const int off = rd<int>(f), a = rd<int>(f), b = rd<int>(f), c = rd<int>(f);
    const int fill = rd<int>(f);
    FILE* o = fopen(argv[2], "wb");
    if (f64) run<double>(f, o, kind, B, n, stride, off, a, b, c, fill);
    else run<float>(f, o, kind, B, n, stride, off, a, b, c, fill);
    fclose(f);
    fclose(o);
    return 0;
}
