"""Run K7 (``dspeed_tpu_torch/csrc/generic_rows.cu``) on the CPU, one thread
per CUDA thread, and hold every output against the plain walk.

The kernel's source is turned into host C++ by text (the dynamic shared
array into the block's buffer, the ``cp.async`` asm into copies that land
at the wait), compiled with ``g++`` and the shims of ``cuda_runtime.h``, and
run by ``k7_main.cpp`` on programs lowered from small chains. Three
builds, each a check the card cannot make:

- ``tsan``: ``-fsanitize=thread``. Block and warp barriers are pthread
  barriers, so two threads' accesses to shared memory with no barrier
  between them (a barrier the host's plan left out, a reduction buffer
  reused too early) are a reported race.
- ``asan``: ``-fsanitize=address``, each block given exactly the launch's
  dynamic shared bytes, so a plan that sizes a plane, the scratch or the
  tape too small fails.
- ``sites``: every thread of a block barrier, and every lane of a warp
  collective, must arrive by one call path (a collective reached from two
  branches hangs the card).

Every escape of the ``full`` lowering (every key the group writes) is held
against ``_cuda.generic_rows_plain`` by ``chip_smoke.check_generic``'s rule,
on the rows without an infinite sample, the convolution within its
tolerance (the CPU's plain convolution does not sum in ``conv_row.cuh``'s
order). ``--parent SRC`` also emulates another ``generic_rows.cu`` of the
same tape layout (a ``git archive`` of an earlier commit) and holds every
escape bit for bit against it.

    python3 tools/k7_emu/run_k7_emu.py [--mode tsan|asan|sites] [--rows N]
        [--parent SRC] [--build DIR] [case ...]

Cases: ``reductions`` (reductions back to back), ``ops256`` and ``ops1001``
(the small op chain at 256 and 1001 samples, rows 4 bytes off 16-byte
alignment included), ``flagship`` (the generic flagship's two groups),
``sipm`` (the SiPM chain's group, ``reflected_convolve_wf`` and
``avg_current`` in float64, on ``chip_smoke.sipm_edge_rows``: every escape
bit for bit against the plain walk, the row with an infinite sample too),
``dpz`` (``DPZ_CONFIG``: ``double_pole_zero`` between a baseline
subtraction and the fit, trapezoid and maximum that read it, at 1001 and
4100 samples, with a NaN sample, a NaN baseline and an infinite sample:
every escape bit for bit against the plain walk), ``extras`` (``EXTRAS_CONFIG``:
one group with each op of the flagship extras, ``poly_residual``,
``soft_pileup``, ``time_point_thresh`` in an interpolation mode,
``wf_correction`` and ``wf_centroid``, at 600 samples with a NaN sample, a
NaN baseline and an infinite sample), ``injml`` (``INJML_CONFIG``: the four
injectors, a normalisation, two dense layers and two classifications in one
group at 600 samples, with a NaN sample, a NaN baseline and an infinite
sample; the CPU's ``exp`` and ``sqrt`` are not the card's, so the plain
walk holds it by ``check_generic``'s rule), ``cover`` (``COVER_CONFIG``:
slice 19's ops, ``mean_below_threshold``, ``time_over_threshold`` and
``saturation`` (the ``count`` op), ``linear_slope_diff``, ``log_check``,
``trap_pickoff``, ``presum``, ``min_max_norm``, ``get``, ``get_default`` at
an int64 index, ``multi_a_filter``, ``where`` on a bool comparison and
``round_to_nearest``, in two groups at 600 samples with a NaN sample, a NaN
baseline and an infinite sample), ``plane`` (``PLANE_CONFIG``: the plane
ops, ``trap_filter``, the moving windows, the pick-off's modes ``n f c h``,
the direct convolution in three modes, elementwise ops over planes into
float32 and bool planes, the row reductions, a per-row ``sqrt``, the
rounding conversions and ``convert_int``, in one group at 600 samples with
a NaN sample, a NaN baseline and an infinite sample: every escape bit for
bit against the plain walk), ``f64`` (K7's float64 kernel on the float64
flagship's two groups, the float64 DPZ's energy front and the float64
extras' three groups, at 4096 samples with a NaN sample, a NaN baseline, an
infinite sample and a flat row from 4 rows on; and this file's ``injml``,
``cover`` and ``plane`` groups widened to float64 at 600 samples
(``tests/torch_k7_ops.widen``),
every op of a float64 program among them: every escape bit for bit against
the plain walk on every row, rows 8 bytes off alignment too; the programs are
lowered and walked with the host's libm for the float64 functions of
``LIBM``, ``host_libm``, as the emulated kernel calls it; and the SiPM
chain's group on ``chip_smoke.sipm_edge_rows`` widened to float64, the
float64 ``reflected_conv`` op, which under ``tsan`` is also run with the
planned barrier before it cleared and must then be reported as a race,
``PLANNED_DROPS``).
``--drop-barrier OP`` builds the kernel with
the first block barrier (``__syncthreads()``, or ``log_check``'s
``__syncthreads_or``) of that op's device function taken out, for
``trap_pickoff`` and ``moving_window`` the one that ends their prefix
(``gen_prefix``), ``conv_f64`` the float64 convolution's (``op_conv64``,
which stages the row's window before it) and ``dense_f64`` the float64 dense
layer's (``op_dense64``, after its warps' partial sums): a mutation the
``tsan`` mode must report; the run stops at the first case that fails.
"""

import argparse
import contextlib
import math
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
for p in (REPO, os.path.join(REPO, "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dspeed_tpu_torch.processors._cuda import esc_value  # noqa: E402
from dspeed_tpu_torch.processors._tile_program import esc_dtype  # noqa: E402

SRC = os.path.join(REPO, "dspeed_tpu_torch", "csrc", "generic_rows.cu")
CASES = ("reductions", "ops256", "ops1001", "flagship", "sipm", "dpz", "extras",
         "injml", "cover", "plane", "f64")
# one group holding each op of the flagship extras, every op reading
# samples that other threads wrote
EXTRAS_CONFIG = {
    "outputs": ["p_mean", "p_rms", "s_mean", "s_std", "s_slope", "s_icpt", "tp_i",
                "c_max", "centroid"],
    "processors": {
        "wf_blsub": {"function": "bl_subtract", "module": "dspeed_tpu.processors",
                     "args": ["waveform", "baseline", "wf_blsub(unit='ADC')"]},
        "bl_poly": {"function": "poly_fit", "module": "dspeed_tpu.processors",
                    "init_args": ["50", "1"],
                    "args": ["wf_blsub[0:50]", "bl_poly(2, 'f')"]},
        "p_mean, p_rms": {"function": "poly_diff", "module": "dspeed_tpu.processors",
                          "args": ["wf_blsub[0:50]", "bl_poly", "p_mean", "p_rms"],
                          "unit": ["ADC", "ADC"]},
        "wf_spc": {"function": "soft_pileup_corr", "module": "dspeed_tpu.processors",
                   "args": ["wf_blsub", "50", "2000.0", "wf_spc"], "unit": "ADC"},
        "s_mean, s_std, s_slope, s_icpt": {
            "function": "linear_slope_fit", "module": "dspeed_tpu.processors",
            "args": ["wf_spc[0:50]", "s_mean", "s_std", "s_slope", "s_icpt"],
            "unit": ["ADC"] * 4},
        "tp_i": {"function": "interpolated_time_point_thresh",
                 "module": "dspeed_tpu.processors",
                 "args": ["wf_spc", "s_std", "300", 0, "'l'", "tp_i"], "unit": "ns"},
        "step_kernel": {"function": "step", "module": "dspeed_tpu.processors",
                        "args": ["16", "step_kernel(64, 'f')"]},
        "wf_corr": {"function": "wf_correction", "module": "dspeed_tpu.processors",
                    "args": ["wf_spc", "step_kernel", "90", "154", "wf_corr"],
                    "unit": "ADC"},
        "c_max": {"function": "amax", "module": "numpy", "unit": "ADC",
                  "args": ["wf_corr", 1, "c_max"],
                  "kwargs": {"signature": "(n),()->()", "types": ["fi->f"]}},
        "wf_step": {"function": "convolve_wf", "module": "dspeed_tpu.processors",
                    "args": ["wf_corr", "step_kernel", "'v'", "wf_step(537, 'f')"],
                    "unit": "ADC"},
        "centroid": {"function": "get_wf_centroid", "module": "dspeed_tpu.processors",
                     "args": ["wf_step", "2", "centroid"], "unit": "ns"},
    },
}
# one group holding each kind of the inject and dense ops: the four
# injectors on the baseline-subtracted row (a parameter one a row), the
# maximum of one, and a normalisation, two dense layers and two
# classifications (a bias one a row) of a window of the row
K = "dspeed_tpu.processors"
INJML_CONFIG = {
    "outputs": ["sig_max", "exp_max", "gum_max", "log_max", "score", "score_nb", "h2"],
    "processors": {
        "wf_blsub": {"function": "bl_subtract", "module": K,
                     "args": ["waveform", "baseline", "wf_blsub(unit='ADC')"]},
        "wf_sig": {"function": "inject_sig_pulse", "module": K,
                   "args": ["wf_blsub", "400.0", "6.0", "baseline*0.5", "200.0",
                            "wf_sig"]},
        "wf_exp": {"function": "inject_exp_pulse", "module": K,
                   "args": ["wf_blsub", "420.0", "8.0", "80.0", "150.0", "wf_exp"]},
        "wf_gum": {"function": "inject_gumbel", "module": K,
                   "args": ["wf_blsub", "60.0", "baseline*2.2", "4.0", "wf_gum"]},
        "wf_log": {"function": "inject_general_logistic", "module": K,
                   "args": ["wf_blsub", "90.0", "450.0", "6.0", "1.5", "2.5", "250.0",
                            "wf_log"]},
        **{f"{k}_max": {"function": "amax", "module": "numpy", "unit": "ADC",
                        "args": [f"wf_{k}", 1, f"{k}_max"],
                        "kwargs": {"signature": "(n),()->()", "types": ["fi->f"]}}
           for k in ("sig", "exp", "gum", "log")},
        "xn": {"function": "normalisation_layer", "module": K,
               "args": ["wf_sig[300:556]", "db.nn.mu", "db.nn.var", "xn"]},
        "h1": {"function": "dense_layer_with_bias", "module": K,
               "args": ["xn", "db.nn.w1", "db.nn.b1", "'r'", "h1(32, 'f')"]},
        "h2": {"function": "dense_layer_no_bias", "module": K,
               "args": ["h1", "db.nn.w2", "'t'", "h2(16, 'f')"]},
        "score": {"function": "classification_layer_with_bias", "module": K,
                  "args": ["h2", "db.nn.v", "baseline*0.001", "'s'", "score"]},
        "score_nb": {"function": "classification_layer_no_bias", "module": K,
                     "args": ["h2", "db.nn.v", "'l'", "score_nb"]},
    },
}


def injml_db(seed=17) -> dict:
    """Seeded weights for ``INJML_CONFIG``'s layers."""
    rng = np.random.default_rng(seed)
    return {"nn": {"mu": rng.uniform(-5, 5, 256).astype("float32"),
                   "var": rng.uniform(50, 500, 256).astype("float32"),
                   "w1": rng.normal(0, 0.06, (256, 32)).astype("float32"),
                   "b1": rng.normal(0, 0.1, 32).astype("float32"),
                   "w2": rng.normal(0, 0.2, (32, 16)).astype("float32"),
                   "v": rng.normal(0, 0.3, 16).astype("float32")}}


def _red(fn, src, out):
    """A numpy reduction of a row of ``src`` into ``out``."""
    return {"function": fn, "module": "numpy", "args": [src, 1, out],
            "kwargs": {"signature": "(n),()->()", "types": ["fi->f"]}}


# slice 19's ops in two groups (the peak finder's sweep between them), each
# barriered op placed where its own barrier is all that orders it: the
# reductions read their buffers after it, trap_pickoff its prefix, and
# log_check's output takes the space of the plane presum read just before
COVER_CONFIG = {
    "outputs": ["mb", "n_tot", "s_lo", "s_hi", "d_mean", "d_rms", "pick", "ps_f",
                "lg_mean", "ps_max", "w_last", "w_at", "m_sel", "m_r", "pk_0"],
    "processors": {
        "wf_blsub": {"function": "bl_subtract", "module": K,
                     "args": ["waveform", "baseline", "wf_blsub(unit='ADC')"]},
        "tp_min, tp_max, wf_min, wf_max": {
            "function": "min_max", "module": K,
            "args": ["wf_blsub", "tp_min", "tp_max", "wf_min", "wf_max"],
            "unit": ["ns", "ns", "ADC", "ADC"]},
        "b_mean, b_std, b_slope, b_icpt": {
            "function": "linear_slope_fit", "module": K,
            "args": ["wf_blsub[0:50]", "b_mean", "b_std", "b_slope", "b_icpt"]},
        "mb": {"function": "mean_below_threshold", "module": K,
               "args": ["wf_blsub", "b_std*3", "mb"]},
        "n_tot": {"function": "time_over_threshold", "module": K,
                  "args": ["wf_blsub", "wf_max*0.5", "n_tot"]},
        "s_lo, s_hi": {"function": "saturation", "module": K,
                       "args": ["waveform", "16", "s_lo", "s_hi"]},
        "d_mean, d_rms": {"function": "linear_slope_diff", "module": K,
                          "args": ["wf_blsub[0:50]", "b_slope", "b_icpt", "d_mean",
                                   "d_rms"]},
        "pick": {"function": "trap_pickoff", "module": K,
                 "args": ["wf_blsub", "20", "5", "round(tp_max, wf_blsub.grid)",
                          "pick"]},
        "wf_n": {"function": "min_max_norm", "module": K,
                 "args": ["wf_blsub", "wf_min", "wf_max", "wf_n"]},
        "ps_f, wf_ps": {"function": "presum", "module": K,
                        "args": ["wf_n", "1", "ps_f", "wf_ps(150, 'f')"]},
        "ps_max": {"function": "amax", "module": "numpy", "unit": "ADC",
                   "args": ["wf_ps", 1, "ps_max"],
                   "kwargs": {"signature": "(n),()->()", "types": ["fi->f"]}},
        "wf_lg": {"function": "log_check", "module": K, "args": ["waveform", "wf_lg"]},
        "lg_mean": {"function": "mean_below_threshold", "module": K,
                    "args": ["wf_lg", "6.0", "lg_mean"]},
        "w_last": {"function": "get", "module": K, "args": ["wf_blsub", "-1", "w_last"]},
        "w_at": "wf_blsub[round(tp_max, wf_blsub.grid, 'int64')]",
        "m_sel": "where(mb > 0, mb, n_tot)",
        "m_r": {"function": "round_to_nearest", "module": K, "args": ["mb", "0.5", "m_r"]},
        "vt_max, vt_min, n_max, n_min": {
            "function": "get_multi_local_extrema", "module": K,
            "args": ["wf_blsub", "wf_max*0.5", "wf_max*0.5", "0", "wf_max*0.5", "0",
                     "vt_max(4, vector_len=n_max)", "vt_min(4, vector_len=n_min)",
                     "n_max", "n_min"]},
        "pk_a": {"function": "multi_a_filter", "module": K,
                 "args": ["wf_blsub", "vt_max", "pk_a"]},
        "pk_0": {"function": "get", "module": K, "args": ["pk_a", "0", "pk_0"]},
    },
}

# the plane ops in generic groups: the unnormalised trapezoid and the two
# moving windows (each on K7's float64 prefix), the pick-off's four new
# modes, the direct convolution in three modes (the 'f' plane longer than
# the row), elementwise ops over planes (a comparison into a bool plane read
# by where and logical_not, a per-row scalar along the row, maximum of two
# planes, floor_divide), the row reductions (a bool plane's sum among them,
# each reading its buffer after its barrier), a per-row sqrt, the rounding
# conversions and convert_int
PLANE_CONFIG = {
    "outputs": ["tf_max", "p_n", "p_f", "p_c", "p_h", "cs_max", "cf_sum", "cv_mean",
                "sel_sum", "ok_sum", "hi_nmax", "fd_nmean", "bl_amin", "bl_min",
                "bl_nsum", "bl_nmin", "b_rt", "t_fl", "t_ce", "t_tr", "t_idx", "w_at"],
    "processors": {
        "wf_blsub": {"function": "bl_subtract", "module": K,
                     "args": ["waveform", "baseline", "wf_blsub(unit='ADC')"]},
        "tp_min, tp_max, wf_min, wf_max": {
            "function": "min_max", "module": K,
            "args": ["wf_blsub", "tp_min", "tp_max", "wf_min", "wf_max"],
            "unit": ["ns", "ns", "ADC", "ADC"]},
        "b_mean, b_std, b_slope, b_icpt": {
            "function": "linear_slope_fit", "module": K,
            "args": ["wf_blsub[0:50]", "b_mean", "b_std", "b_slope", "b_icpt"]},
        "wf_tf": {"function": "trap_filter", "module": K,
                  "args": ["wf_blsub", "20", "5", "wf_tf"]},
        "tf_max": _red("amax", "wf_tf", "tf_max"),
        "wf_mwl": {"function": "moving_window_left", "module": K,
                   "args": ["wf_blsub", "12.5", "wf_mwl"]},
        "wf_mwr": {"function": "moving_window_right", "module": K,
                   "args": ["wf_blsub", "12.5", "wf_mwr"]},
        **{f"p_{m}": {"function": "fixed_time_pickoff", "module": K,
                      "args": ["wf_tf", f"{t}+b_mean", f"'{m}'", f"p_{m}"]}
           for m, t in (("n", "300.5"), ("f", "301.25"), ("c", "302.75"), ("h", "303.4"))},
        **{f"wf_c{m}": {"function": "convolve_wf", "module": K,
                        "args": ["wf_mwl", "db.k17", f"'{m}'", f"wf_c{m}({p}, 'f')"]}
           for m, p in (("s", 600), ("f", 616), ("v", 584))},
        "cs_max": _red("max", "wf_cs", "cs_max"),
        "cf_sum": _red("sum", "wf_cf", "cf_sum"),
        "cv_mean": _red("mean", "wf_cv", "cv_mean"),
        "wf_sel": "where(wf_blsub > 3*b_std, wf_blsub, 0.0)",
        "sel_sum": _red("nansum", "wf_sel", "sel_sum"),
        "wf_ok": {"function": "logical_not", "module": "numpy",
                  "args": ["wf_blsub > 3*b_std", "wf_ok"],
                  "kwargs": {"signature": "()->()", "types": ["?->?"]}},
        "ok_sum": {"function": "sum", "module": "numpy", "args": ["wf_ok", 1, "ok_sum"],
                   "kwargs": {"signature": "(n),()->()", "types": ["?i->l"]}},
        "wf_hi": {"function": "maximum", "module": "numpy",
                  "args": ["wf_mwl", "wf_mwr", "wf_hi"],
                  "kwargs": {"signature": "(),()->()", "types": ["ff->f"]}},
        "hi_nmax": _red("nanmax", "wf_hi", "hi_nmax"),
        "wf_fd": "wf_blsub // (b_std+1)",
        "fd_nmean": _red("nanmean", "wf_fd", "fd_nmean"),
        "bl_amin": _red("amin", "wf_blsub[0:50]", "bl_amin"),
        "bl_min": _red("min", "wf_cs[0:100]", "bl_min"),
        "bl_nsum": _red("nansum", "wf_blsub[0:50]", "bl_nsum"),
        "bl_nmin": _red("nanmin", "wf_blsub[0:50]", "bl_nmin"),
        "b_rt": {"function": "sqrt", "module": "numpy", "args": ["b_std", "b_rt"],
                 "kwargs": {"signature": "()->()", "types": ["f->f"]}},
        "t_fl": "floor(tp_max, wf_blsub.grid)",
        "t_ce": "ceil(tp_max, 48*ns)",
        "t_tr": "trunc(tp_max, 48*ns)",
        "t_idx": "round(tp_max, wf_blsub.grid, 'int64')",
        "w_at": "wf_blsub[10:][t_idx]",
    },
}


def plane_db(seed=19) -> dict:
    """Seeded 17 taps for ``PLANE_CONFIG``'s convolutions."""
    return {"k17": np.random.default_rng(seed).normal(0, 0.3, 17).astype("float32")}


# the device function of each op with a barrier of its own (--drop-barrier);
# trap_pickoff's barrier is the one that ends its prefix
OP_FUNCTIONS = {"poly_residual": "op_poly_resid", "soft_pileup": "op_soft_pileup",
                "wf_centroid": "op_wf_centroid", "dense": "op_dense",
                "mean_below_threshold": "op_mean_below", "count": "op_count",
                "linear_slope_diff": "op_slope_diff", "log_check": "op_log_check",
                "trap_pickoff": "gen_prefix", "moving_window": "gen_prefix",
                "reduce": "op_reduce", "conv_f64": "op_conv64", "dense_f64": "op_dense64"}
# double_pole_zero in a group: it reads the samples bl_subtract's threads
# wrote (the planned barrier before it), and the fit, trapezoid and maximum
# read its output
DPZ_CONFIG = {
    "outputs": ["pz_mean", "pz_std", "pz_slope", "pz_icpt", "trap_max", "wf_pz"],
    "processors": {
        "wf_blsub": {"function": "bl_subtract", "module": "dspeed_tpu.processors",
                     "args": ["waveform", "baseline", "wf_blsub(unit='ADC')"]},
        "wf_pz": {"function": "double_pole_zero", "module": "dspeed_tpu.processors",
                  "args": ["wf_blsub", "2000.0", "40.0", "0.05", "wf_pz"],
                  "unit": "ADC"},
        "pz_mean, pz_std, pz_slope, pz_icpt": {
            "function": "linear_slope_fit", "module": "dspeed_tpu.processors",
            "args": ["wf_pz[600:]", "pz_mean", "pz_std", "pz_slope", "pz_icpt"],
            "unit": ["ADC"] * 4},
        "wf_trap": {"function": "trap_norm", "module": "dspeed_tpu.processors",
                    "args": ["wf_pz", "50", "10", "wf_trap"], "unit": "ADC"},
        "trap_max": {"function": "amax", "module": "numpy", "unit": "ADC",
                     "args": ["wf_trap", 1, "trap_max"],
                     "kwargs": {"signature": "(n),()->()", "types": ["fi->f"]}},
    },
}
# a scalar input's kind in the input file (k7_main.cpp) and its numpy type
SCALAR_KINDS = {torch.float32: (1, np.float32), torch.float64: (2, np.float64),
                torch.bool: (3, np.bool_), torch.int64: (4, np.int64)}
FLAGS = {
    "tsan": ["-fsanitize=thread", "-O1"],
    "asan": ["-fsanitize=address", "-O1"],
    "sites": ["-O0", "-fno-omit-frame-pointer", "-DEMU_SITES"],
}


K7_CUTS = ("typedef void (*GenKernel)", "static cudaError_t gen_launch",
           'extern "C" int dspeed_generic_rows')


def host_source(src: str, out: str, cuts=K7_CUTS, drop=None) -> str:
    """``src`` as host C++ up to its host-side launch code (the first of
    ``cuts`` found), into ``out``; with ``drop`` (an op of
    ``OP_FUNCTIONS``) the first block barrier of that op's function taken
    out."""
    text = open(src).read()
    if drop is not None:
        fn = re.search(rf"\b(?:void|int)\s+{OP_FUNCTIONS[drop]}\(", text).start()
        at = min(i for i in (text.find("__syncthreads();", fn),
                             text.find("__syncthreads_or(", fn)) if i >= 0)
        if text.startswith("__syncthreads();", at):
            text = text[:at] + "/* barrier dropped */" + text[at + len("__syncthreads();"):]
        else:  # the flag of this thread alone, with no barrier
            text = text[:at] + "/* barrier dropped */ (" + text[at + len("__syncthreads_or("):]
    text = re.sub(
        r"extern __shared__\s+(?:__align__\(\d+\)\s+)?(\w+)\s+(\w+)\[\];",
        r"\n#define \2 ((\1*)emu_blk->smem)\n", text)
    text = re.sub(
        r'const unsigned d = \(unsigned\)__cvta_generic_to_shared\(dst\);\s*'
        r'asm volatile\("cp\.async\.c[ga]\.shared\.global \[%0\], \[%1\], '
        r'(\d+);\\n" ::"r"\(d\),\s*"l"\(src\)\s*: "memory"\);',
        r"emu_cp_async(dst, src, \1);", text)
    text = text.replace('asm volatile("cp.async.wait_all;\\n" ::: "memory");',
                        "emu_cp_wait_all();")
    if "asm" in text:
        raise SystemExit(f"{src}: an asm statement the emulation does not rewrite")
    cut = min(i for i in (text.find(c) for c in cuts) if i >= 0)
    with open(out, "w") as f:
        f.write(text[:cut])
    return out


def build(src: str, mode: str, build_dir: str, tag: str = "k7",
          main: str = os.path.join(HERE, "k7_main.cpp"), cuts=K7_CUTS,
          drop=None) -> str:
    """The emulation of ``src`` built for ``mode`` with the host program
    ``main`` (``drop``: see :func:`host_source`); returns the executable."""
    os.makedirs(build_dir, exist_ok=True)
    exe = os.path.join(build_dir, f"{tag}_{mode}")
    inc = host_source(src, os.path.join(build_dir, f"{tag}.inc"), cuts, drop)
    f64 = ["-DEMU_F64"] if "generic_rows_kernel_f64" in open(inc).read() else []
    cmd = ["g++", "-std=c++17", "-g", "-ffp-contract=off", "-pthread",
           *FLAGS[mode], *f64, f"-I{HERE}", f"-I{os.path.dirname(src)}",
           f'-DKSRC="{inc}"', "-o", exe, main]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"g++ failed for {src} ({mode}):\n{r.stderr[-4000:]}")
    return exe


def write_input(path, prog, vals, misalign=0) -> None:
    """The tape, its plan, the inputs (each row ``misalign`` floats past
    16-byte alignment) and the escapes' sizes, as ``k7_main.cpp`` reads
    them. Shared memory starts filled with 0x7f bytes (each float a NaN), so
    that a read of what no thread wrote shows in the outputs."""
    fill = 0x7F
    ints, dbls, taps = prog.encode()
    B = int(vals[prog.ext_keys[0]].shape[0])
    with open(path, "wb") as f:
        hdr = [len(ints), len(dbls), len(taps), B, len(prog.ops),
               len(prog.slots), prog.n_scal, prog.scratch_dbl,
               prog.arena_floats, prog.smem_bytes, len(prog.ext_keys),
               len(prog.esc_roots), fill, prog.tape_dbl, int(prog.f64)]
        f.write(np.asarray(hdr, np.int32).tobytes())
        f.write(ints.astype(np.int32).tobytes())
        f.write(dbls.astype(np.float64).tobytes())
        f.write(taps.astype(np.float32).tobytes())
        for key in prog.ext_keys:
            v = vals[key]
            if v.ndim == 2:
                stride = v.stride(0)
                kind, dt = {torch.bool: (3, np.bool_), torch.float64: (2, np.float64)}.get(
                    v.dtype, (0, np.float32))
                data = np.zeros(B * stride, dt)
                a = v.numpy()
                for r in range(B):
                    data[r * stride : r * stride + a.shape[1]] = a[r]
            else:
                stride = 1
                kind, dt = SCALAR_KINDS[v.dtype]
                data = v.numpy().astype(dt)
            f.write(np.asarray([kind, misalign], np.int32).tobytes())
            f.write(np.asarray([data.size, stride], np.int64).tobytes())
            f.write(data.tobytes())
        for sid in prog.esc_roots:
            s = prog.slots[sid]
            n = B * (s.length if s.kind == "plane" else 1)
            f.write(np.asarray([esc_dtype(s).itemsize], np.int32).tobytes())
            f.write(np.asarray([n], np.int64).tobytes())


def read_output(path, prog, B) -> dict:
    raw = open(path, "rb").read()
    pos, roots = 0, {}
    for sid in prog.esc_roots:
        s = prog.slots[sid]
        n = B * (s.length if s.kind == "plane" else 1)
        dt = SCALAR_KINDS[esc_dtype(s)][1]
        a = np.frombuffer(raw, dt, n, pos).copy()
        pos += n * a.itemsize
        roots[sid] = esc_value(torch.from_numpy(a.reshape(B, -1) if s.kind == "plane"
                                                else a), s.dtype)
    return roots


def run(exe, prog, vals, build_dir, tag, misalign=0) -> dict:
    """The emulated kernel's escapes (env key -> tensor) on ``vals``."""
    from dspeed_tpu_torch.processors import _cuda

    inp = os.path.join(build_dir, f"{tag}.in")
    out = os.path.join(build_dir, f"{tag}.out")
    write_input(inp, prog, vals, misalign)
    env = dict(os.environ, TSAN_OPTIONS="halt_on_error=1 report_signal_unsafe=0",
               ASAN_OPTIONS="detect_leaks=0")
    r = subprocess.run([exe, inp, out], capture_output=True, text=True, env=env)
    if r.returncode:
        raise RuntimeError(f"{tag}: the emulated kernel failed ({r.returncode}):\n"
                           f"{r.stdout[-2000:]}{r.stderr[-6000:]}")
    B = int(vals[prog.ext_keys[0]].shape[0])
    roots = read_output(out, prog, B)
    roots.update({prog.by_key[k]: vals[k] for k in prog.ext_keys})
    return _cuda._escape_values(prog, roots)


def chain_groups(cfg, wf, bl, db=None, fuse="generic") -> list:
    """``[(program, full program, vals)]`` for each generic group of
    ``cfg`` on ``(wf, bl)`` (no baseline column where ``bl`` is None);
    ``full`` stores every key the group writes."""
    from dspeed_tpu_torch import lh5
    from dspeed_tpu_torch.processing_chain import GroupStep, build_processing_chain
    from dspeed_tpu_torch.processors import _cuda
    from dspeed_tpu_torch.processors._tile_program import lower

    cols = {"waveform": lh5.WaveformTable(values=wf, t0=0.0, t0_units="ns",
                                          dt=16.0, dt_units="ns")}
    if bl is not None:
        cols["baseline"] = lh5.Array(bl.astype(np.float32))
    chain, _, _ = build_processing_chain(cfg, lh5.Table(cols), db_dict=db,
                                         device="cpu", fuse=fuse)
    inputs, _ = chain._gather_inputs(0, len(wf))
    env = chain._to_device(inputs)
    env.update(chain._const_env())
    out = []
    for step in chain._steps:
        if not isinstance(step, GroupStep):
            step.run(env)
            continue
        vals = {k: env[k] for k in step.ext_in}
        prog = lower(step.members, vals, step.escapes)
        every = sorted(s.key for s in prog.slots if not s.ext)
        out.append((prog, lower(step.members, vals, every), vals))
        env.update(_cuda.generic_rows_plain(prog, vals))
    return out


def cases(names, rows=6):
    """``(label, program, full program, vals)`` for each case of ``names``."""
    import chip_smoke as cs
    from test_torch_generic import OPS_CONFIG, RED_CONFIG, _events

    if "reductions" in names:
        wf, bl = _events(n=max(rows, 8), nsamp=256, seed=3)
        for prog, full, vals in chain_groups(RED_CONFIG, wf[:rows], bl[:rows]):
            yield "reductions", prog, full, vals
    for nsamp in (256, 1001):
        if f"ops{nsamp}" not in names:
            continue
        wf, bl = _events(n=max(rows, 8), nsamp=nsamp, seed=5)
        wf[min(6, rows - 1), nsamp * 3 // 4 :] = wf[min(6, rows - 1), nsamp * 3 // 4 - 1]
        wf[0, 0] = np.nan
        wf[1 % rows, -1] = np.nan
        for prog, full, vals in chain_groups(OPS_CONFIG, wf[:rows], bl[:rows]):
            yield f"ops{nsamp}", prog, full, vals
    if "flagship" in names:
        wf, _amp, _t0, bl, _rt = cs.make_hpge_waveforms(rows)
        wf[3 % rows, 500] = np.nan
        bl[min(5, rows - 1)] = np.nan
        if rows > 4:
            wf[4, 2000] = np.inf
            wf[2, :] = wf[2, 0]  # flat: the searches find nothing
        groups = chain_groups(cs.config(), wf, bl, {"pz": {"tau": cs.TAU}})
        for lab, (prog, full, vals) in zip("AB", groups):
            yield f"flagship {lab}", prog, full, vals
    if "f64" in names:
        # the float64 flagship's groups on float64 rows (K7's float64
        # kernel): a NaN sample, a NaN baseline, an infinite sample, a flat
        # row (from 4 rows on)
        def poison(wf, bl, at=(500, 2000)):
            wf = wf.astype(np.float64)
            wf[0, at[0]] = np.nan
            bl[1 % rows] = np.nan
            if rows >= 4:
                wf[2, at[1]] = np.inf
                wf[3, :] = wf[3, 0]
            return wf, bl

        wf, bl = poison(*cs.make_hpge_waveforms(rows)[::3])
        # and the DPZ's energy front and the extras' three groups; lowered
        # with the host's libm, as the plain walk takes it
        dwf, dbl = poison(*cs.make_hpge_dpz_waveforms(rows)[::3])
        db = {"pz": {"tau": cs.TAU}}
        with host_libm():
            # first the injection + ML, coverage and plane groups of this
            # file in float64 at 600 samples: the float64 forms of their ops
            # with a block barrier (dense, the reductions, the prefix ops,
            # min_max_norm and the direct convolution among the rest); each
            # group yielded as soon as it is lowered
            from test_torch_generic import _events as events
            from torch_k7_ops import widen

            for name, cfg, db6, seed in (("injml", INJML_CONFIG, injml_db(), 9),
                                         ("cover", COVER_CONFIG, None, 13),
                                         ("plane", PLANE_CONFIG, plane_db(), 17)):
                w6, b6 = events(n=max(rows, 8), nsamp=600, seed=seed)
                w6, b6 = poison(w6[:rows], b6[:rows], (350, 450))
                for lab, g in zip("AB", chain_groups(widen(cfg), w6, b6, db6, fuse=True)):
                    yield (f"f64 {name} {lab}", *g)
            for lab, g in zip("AB", chain_groups(cs.flagship_config("float64"), wf, bl, db)):
                yield (f"f64 flagship {lab}", *g)
            yield ("f64 dpz A", *chain_groups(cs.dpz_config("float64"), dwf, dbl, db)[0])
            for lab, g in zip("CDE", chain_groups(cs.extras_config("float64"), wf, bl, db,
                                                  fuse=True)):
                yield (f"f64 extras {lab}", *g)
        # the SiPM chain's group on its rows widened to float64: the float64
        # reflected_conv, which reads the row's neighbours and reflected
        # edges that other threads loaded (behind the planned barrier)
        swf, _ = cs.make_sipm_waveforms(max(rows, 3))
        for g in chain_groups(cs.sipm_config(),
                              cs.sipm_edge_rows(swf)[:rows].astype(np.float64), None,
                              fuse=True):
            yield ("f64 sipm", *g)
    if "dpz" in names:
        from torch_flagship import make_hpge_dpz_waveforms

        # 1001 samples: runs of 4, some threads with none; 4100: runs of 17
        for nsamp in (1001, 4100):
            wf, _amp, _t0, bl, _rt = make_hpge_dpz_waveforms(max(rows, 4), nsamp=4800)
            wf = np.ascontiguousarray(wf[:rows, 700:700 + nsamp])
            wf[0, 300] = np.nan
            bl[1 % rows] = np.nan
            wf[min(2, rows - 1), 500] = np.inf
            for prog, full, vals in chain_groups(DPZ_CONFIG, wf, bl[:rows]):
                yield "dpz", prog, full, vals
    if "extras" in names:
        from test_torch_generic import _events as events

        wf, bl = events(n=max(rows, 8), nsamp=600, seed=7)
        wf[0, 300] = np.nan
        bl[1 % rows] = np.nan
        wf[min(2, rows - 1), 450] = np.inf
        for prog, full, vals in chain_groups(EXTRAS_CONFIG, wf[:rows], bl[:rows],
                                             fuse=True):
            yield "extras", prog, full, vals
    if "injml" in names:
        from test_torch_generic import _events as events

        wf, bl = events(n=max(rows, 8), nsamp=600, seed=9)
        wf[0, 350] = np.nan
        bl[1 % rows] = np.nan
        wf[min(2, rows - 1), 450] = np.inf
        for prog, full, vals in chain_groups(INJML_CONFIG, wf[:rows], bl[:rows],
                                             injml_db(), fuse=True):
            yield "injml", prog, full, vals
    if "cover" in names:
        from test_torch_generic import _events as events

        wf, bl = events(n=max(rows, 8), nsamp=600, seed=13)
        wf[0, 350] = np.nan
        bl[1 % rows] = np.nan
        wf[min(2, rows - 1), 450] = np.inf
        for prog, full, vals in chain_groups(COVER_CONFIG, wf[:rows], bl[:rows]):
            yield "cover", prog, full, vals
    if "plane" in names:
        from test_torch_generic import _events as events

        wf, bl = events(n=max(rows, 8), nsamp=600, seed=17)
        wf[0, 350] = np.nan
        bl[1 % rows] = np.nan
        wf[min(2, rows - 1), 450] = np.inf
        for prog, full, vals in chain_groups(PLANE_CONFIG, wf[:rows], bl[:rows],
                                             plane_db()):
            yield "plane", prog, full, vals
    if "sipm" in names:
        wf, _ = cs.make_sipm_waveforms(max(rows, 3))
        # the SiPM chain's default mode forms its group
        for prog, full, vals in chain_groups(cs.sipm_config(),
                                             cs.sipm_edge_rows(wf)[:rows],
                                             None, fuse=True):
            yield "sipm", prog, full, vals


def _same(a, b):
    return (a == b) | (torch.isnan(a) & torch.isnan(b))


def _libm(fn):
    def one(*v):
        try:
            return fn(*v)
        except OverflowError:
            return math.inf
        except ValueError:  # a domain error: the C function's NaN or -inf
            if fn in (math.log, math.log10) and v[0] == 0:
                return -math.inf
            if fn is math.log1p and v[0] == -1:
                return -math.inf
            return math.nan
    return np.vectorize(one, otypes=[np.float64])


# the float64 functions the float64 kernel takes from the math library
LIBM = ("sqrt", "exp", "expm1", "log", "log1p", "log10", "tanh", "pow")


@contextlib.contextmanager
def host_libm():
    """``torch``'s float64 functions of :data:`LIBM` as the host's libm
    takes them, which the emulated kernel calls: PyTorch's CPU functions of
    a float64 row are not always correctly rounded (the card's kernel and
    PyTorch's CUDA ones are the device's libm). A chain built inside binds
    its ufuncs to these."""
    real = {name: getattr(torch, name) for name in LIBM}

    def wrap(name):
        host = _libm(getattr(math, name))

        def call(*args):
            ts = [a for a in args if isinstance(a, torch.Tensor)]
            if any(t.dtype != torch.float64 for t in ts) or len(args) > 2:
                return real[name](*args)
            vals = [a.numpy() if isinstance(a, torch.Tensor) else np.float64(a)
                    for a in args]
            with np.errstate(all="ignore"):
                out = host(*np.broadcast_arrays(*vals))
            return torch.from_numpy(np.ascontiguousarray(out))
        return call

    try:
        for name in real:
            setattr(torch, name, wrap(name))
        yield
    finally:
        for name, fn in real.items():
            setattr(torch, name, fn)


# ops whose barrier is the plan's (ip[IP_PLAN]) and not their function's:
# run once more with it cleared on the case's ``full`` program, under tsan,
# which must then report a race (no second build: the plan is the tape's)
PLANNED_DROPS = {"f64 sipm": "reflected_conv"}


def without_plan(exe, prog, vals, build_dir, tag, op_name) -> str:
    """``prog`` run with the planned barrier before each ``op_name`` op
    cleared: ThreadSanitizer must report a race; returns a summary, or
    raises AssertionError."""
    import copy

    from dspeed_tpu_torch.processors._tile_program import OPCODES

    bare = copy.deepcopy(prog)
    cleared = 0
    for op in bare.ops:
        if op.code == OPCODES[op_name] and op.plan:
            op.plan, cleared = 0, cleared + 1
    assert cleared, f"no planned barrier before {op_name}"
    try:
        run(exe, bare, vals, build_dir, tag)
    except RuntimeError as e:
        if "ThreadSanitizer: data race" in str(e):
            return f"; without the planned barrier before {op_name}: a race reported"
        raise
    raise AssertionError(f"no race reported without the planned barrier before {op_name}")


def check(label, prog, vals, got, parent=None) -> str:
    """``got`` (the ``full`` program's escapes) against the plain walk on
    the rows without an infinite sample, and bit for bit against
    ``parent`` where given; raises AssertionError, or returns a summary."""
    import chip_smoke as cs
    from dspeed_tpu_torch.processors import _cuda

    B = int(vals[prog.ext_keys[0]].shape[0])
    fin = torch.ones(B, dtype=torch.bool)
    for v in vals.values():
        if v.ndim == 2:
            fin &= ~torch.isinf(v).any(1)
    sub = {k: v[fin] for k, v in vals.items()}
    plain = _cuda.generic_rows_plain(prog, sub)
    err, rel, excused, _ = cs.check_generic(
        prog, sub, {k: v[fin] for k, v in got.items()}, plain, label)
    msg = f"vs plain: max err {err:.3e} ({rel:.2e} of scale), {excused} rows excused"
    if label in ("sipm", "dpz", "plane") or label.startswith("f64"):
        # unfused products and sums in the plain walk's order: every row
        # bit for bit, the row with an infinite sample included (a float64
        # program's sqrt and exp the host's libm's)
        with host_libm() if prog.f64 else contextlib.nullcontext():
            plain = _cuda.generic_rows_plain(prog, vals)
        diff = [k for k in plain if not bool(_same(got[k], plain[k]).all())]
        assert not diff, f"{label}: differs from the plain walk in {diff}"
        msg += "; every row bit for bit"
    if parent is not None:
        diff = [k for k in parent if not bool(_same(got[k], parent[k]).all())]
        assert not diff, f"{label}: differs from the parent kernel in {diff}"
        msg += "; equal to the parent kernel's bit for bit"
    return msg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=sorted(FLAGS), default="tsan")
    ap.add_argument("--rows", type=int, default=6)
    ap.add_argument("--parent", help="another generic_rows.cu to hold bit for bit")
    ap.add_argument("--build", default=os.path.join(HERE, "build"))
    ap.add_argument("--drop-barrier", choices=sorted(OP_FUNCTIONS),
                    help="take out the first barrier of this op's function")
    ap.add_argument("cases", nargs="*", default=list(CASES[:3]))
    args = ap.parse_args(argv)
    exe = build(SRC, args.mode, args.build, drop=args.drop_barrier)
    par = build(args.parent, args.mode, args.build, "parent") if args.parent else None
    bad = 0
    for label, prog, full, vals in cases(args.cases, args.rows):
        for mis in (0, 1):
            tag = f"{label.replace(' ', '_')}_{mis}"
            try:
                run(exe, prog, vals, args.build, tag + "_chain", mis)
                got = run(exe, full, vals, args.build, tag + "_full", mis)
                want = run(par, full, vals, args.build, tag + "_parent", mis) if par else None
                msg = check(label, full, vals, got, want)
                if (args.mode == "tsan" and label in PLANNED_DROPS
                        and not args.drop_barrier):
                    msg += without_plan(exe, full, vals, args.build, tag + "_bare",
                                        PLANNED_DROPS[label])
            except (AssertionError, RuntimeError) as e:
                bad += 1
                msg = f"FAILED: {e}"
            print(f"{label} [{args.mode}, rows {mis} samples off alignment] "
                  f"{len(full.ops)} ops, {sum(o.plan for o in full.ops)} planned "
                  f"barriers: {msg}", flush=True)
            if bad and args.drop_barrier:
                break  # the mutation is seen: the rest need not run
        if bad and args.drop_barrier:
            break
    print("FAILED" if bad else "OK")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
