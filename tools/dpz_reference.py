"""The JAX package's own worst ``trapEmax`` error on the flagship DPZ's
synthetic events, the bound ``chip_smoke.py``'s DPZ path is held to.

    JAX_PLATFORMS=cpu python3 tools/dpz_reference.py [--events 16384]

Builds ``chip_smoke.make_hpge_dpz_waveforms(N)`` with the NaN rows that
``chip_smoke.e2e_phase`` sets, runs ``chip_smoke.dpz_config()`` through the
JAX package's ``build_dsp`` on the CPU (float32, its default fusion), and
prints max and median ``|trapEmax / amplitude - 1|`` over the events without
a NaN, and the same for the float64 chain on the same values.
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--events", type=int, default=16384)
    ap.add_argument("--chunk", type=int, default=2048)
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_enable_x64", True)
    import chip_smoke as cs
    import dspeed_tpu
    from dspeed_tpu import lh5

    wf, amp, _t0, bl, _rt = cs.make_hpge_dpz_waveforms(args.events)
    wf[cs.NAN_SAMPLE_ROW, 500] = np.nan
    bl = bl.copy()
    bl[cs.NAN_BASELINE_ROW] = np.nan
    good = np.ones(args.events, dtype=bool)
    good[[cs.NAN_SAMPLE_ROW, cs.NAN_BASELINE_ROW]] = False
    for dtype in ("float32", "float64"):
        cfg = cs.dpz_config() if dtype == "float32" else cs.dpz_config("float64")
        tb = lh5.Table({
            "waveform": lh5.WaveformTable(
                values=wf.astype(dtype), t0=0.0, t0_units="ns", dt=cs.DT,
                dt_units="ns"),
            "baseline": lh5.Array(bl.astype(dtype)),
        })
        out = dspeed_tpu.build_dsp(tb, dsp_config=cfg, buffer_len=args.chunk)
        rel = np.abs(np.asarray(out["trapEmax"].nda, np.float64)[good] / amp[good] - 1)
        print(f"JAX package, {dtype} chain, {args.events} events: trapEmax vs "
              f"injected amplitude max {rel.max()!r}, median {np.median(rel)!r}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
