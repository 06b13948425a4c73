"""The JAX package's ``optimize_2pz`` on the first events of the flagship
DPZ's generator, the reference ``chip_smoke.py``'s optimisers' phase holds
the port to.

    JAX_PLATFORMS=cpu python3 tools/optimize_2pz_reference.py

Builds ``chip_smoke.make_hpge_dpz_waveforms(chip_smoke.OPT_2PZ_EVENTS)``,
takes its first ``OPT_2PZ_REF_EVENTS`` rows less their float32 baselines in
float64 (as ``chip_smoke.opt_configs("float64")``'s chain subtracts them), runs the JAX package's ``optimize_2pz`` on the
CPU in x64 with ``chip_smoke``'s window, bounds and start, and writes the
results and the JAX package's objective at them (by its own formula, and
by the port's, which sums the centred indices) to
``chip_smoke.OPT_2PZ_REF`` (``tests/torch_optimize_2pz_jax.npz``).
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def reference_rows(cs):
    """The rows both packages optimise: the float32 waveform less the
    float32 baseline, in float64."""
    wf, _amp, _t0, bl, _rt = cs.make_hpge_dpz_waveforms(cs.OPT_2PZ_EVENTS)
    n = cs.OPT_2PZ_REF_EVENTS
    return wf[:n].astype(np.float64) - bl[:n, None].astype(np.float32).astype(np.float64)


def main() -> int:
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import chip_smoke as cs
    from dspeed_tpu.processors import optimize_2pz
    from dspeed_tpu.processors.optimize import _dpz_traced, _slope_objective

    rows = reference_rows(cs).astype(np.float64)
    beg, end = cs.OPT_2PZ_WINDOW
    args = (0.0, beg, end, *cs.OPT_2PZ_BOUNDS, *cs.OPT_2PZ_START)
    tau1, tau2, frac = (np.asarray(v) for v in jax.jit(
        lambda w: optimize_2pz.fn(w, *args))(rows))
    y = np.asarray(_dpz_traced(jnp.asarray(rows), jnp.asarray(tau1), jnp.asarray(tau2),
                               jnp.asarray(frac)))
    obj = np.asarray(_slope_objective(jnp.asarray(y), beg, end))
    # the same objective without the cancellation of its two terms, as the
    # port evaluates it (its slope_objective)
    xc = np.arange(beg, end) - (beg + end - 1) / 2.0
    centered = (end - beg) * np.abs((xc * y[:, beg:end]).sum(-1))
    start = np.asarray(_slope_objective(_dpz_traced(
        jnp.asarray(rows), *(jnp.full(len(rows), v) for v in cs.OPT_2PZ_START)),
        beg, end))
    np.savez(cs.OPT_2PZ_REF, tau1=tau1, tau2=tau2, frac=frac, objective=obj,
             objective_centered=centered,
             start_objective=start, window=np.asarray(cs.OPT_2PZ_WINDOW),
             bounds=np.asarray(cs.OPT_2PZ_BOUNDS), start=np.asarray(cs.OPT_2PZ_START),
             events=np.asarray([cs.OPT_2PZ_EVENTS, len(rows)]))
    print(f"JAX package optimize_2pz on {len(rows)} DPZ rows: objective median "
          f"{np.median(obj)!r}, max {obj.max()!r} (centered: median "
          f"{np.median(centered)!r}, max {centered.max()!r}; from a median {np.median(start)!r} "
          f"at the start); tau1 median {np.median(tau1)!r}, tau2 {np.median(tau2)!r}, "
          f"frac {np.median(frac)!r}; written to {cs.OPT_2PZ_REF}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
