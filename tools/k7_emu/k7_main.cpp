// Runs one K7 kernel source (included as KSRC, turned into host C++ by
// run_k7_emu.py) over an input file and writes its escapes.
#include "cuda_runtime.h"
thread_local emu_dim3 threadIdx, blockIdx;
emu_dim3 blockDim, gridDim;
EmuBlock* emu_blk;
thread_local std::vector<EmuCp> emu_cp_queue;

#include KSRC

#include <cstdio>
#include <cstdlib>

template <class T> static T rd(FILE* f) { T v; if (fread(&v, sizeof v, 1, f) != 1) abort(); return v; }
template <class T> static T* rdv(FILE* f, long long n, int off = 0) {
    char* base = (char*)malloc(sizeof(T) * (n + off) + 16);
    T* p = (T*)base + off;
    if (n && fread(p, sizeof(T), n, f) != (size_t)n) abort();
    return p;
}

int main(int argc, char** argv) {
    FILE* f = fopen(argv[1], "rb");
    const int n_code = rd<int>(f), n_dbl = rd<int>(f), n_taps = rd<int>(f);
    static GenParams P;
    memset(&P, 0, sizeof P);
    P.B = rd<int>(f); P.n_ops = rd<int>(f); P.n_slots = rd<int>(f);
    P.n_scal = rd<int>(f); P.scratch_dbl = rd<int>(f); P.arena_floats = rd<int>(f);
    const int dyn_smem = rd<int>(f), n_ext = rd<int>(f), n_esc = rd<int>(f);
    const unsigned char fill = (unsigned char)rd<int>(f);
    const int tape_dbl = rd<int>(f);
    const int f64 = rd<int>(f);
#ifdef GEN_MAX_CODE
    if (n_code > GEN_MAX_CODE || n_dbl > GEN_MAX_DP) abort();
    memcpy(P.code, rdv<int>(f, n_code), 4 * n_code);
    memcpy(P.dpar, rdv<double>(f, n_dbl), 8 * n_dbl);
    P.tape_dbl = tape_dbl;
    P.n_dpar = n_dbl;
    P.n_code = n_code;
#else
    (void)tape_dbl;
    P.code = rdv<int>(f, n_code);
    P.dpar = rdv<double>(f, n_dbl);
#endif
    P.taps = rdv<float>(f, n_taps);
    for (int e = 0; e < n_ext; ++e) {
        const int kind = rd<int>(f), off = rd<int>(f);
        const long long n = rd<long long>(f), stride = rd<long long>(f);
        P.ext_stride[e] = stride;
        if (kind == 2) P.ext[e] = rdv<double>(f, n, off);
        else if (kind == 3) P.ext[e] = rdv<unsigned char>(f, n, off);
        else if (kind == 4) P.ext[e] = rdv<long long>(f, n, off);
        else P.ext[e] = rdv<float>(f, n, off);
    }
    std::vector<std::pair<void*, size_t>> outs;
    for (int q = 0; q < n_esc; ++q) {
        const int size = rd<int>(f);
        const long long n = rd<long long>(f);
        void* p = calloc(n, size);
        P.esc[q] = p;
        outs.push_back({p, (size_t)n * size});
    }
    fclose(f);
    gridDim.x = P.B;
    for (int b = 0; b < P.B; ++b)
        emu_run_block(b, 256, dyn_smem, [&] {
#ifdef EMU_F64  // a source with K7's float64 kernel
            if (f64) return generic_rows_kernel_f64(P);
#endif
            if (f64) abort();
            generic_rows_kernel(P);
        }, fill);
    FILE* o = fopen(argv[2], "wb");
    for (auto& pr : outs) fwrite(pr.first, 1, pr.second, o);
    fclose(o);
    return 0;
}
