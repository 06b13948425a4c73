"""One K7 op alone: a small chain built unfused on the CPU, one of its steps
lowered as a one-op group, and the tape's plain walk held against the JAX
package's ``_pallas.generic_rows`` in interpret mode on the same inputs
(``tests/test_tile_safety.py``'s route, at its 8 x 256 and tolerance), as
``tests/test_torch_generic.py`` holds the flagship's ops."""

import numpy as np
import torch

import dspeed_tpu_torch
from dspeed_tpu_torch.processing_chain import KernelStep
from dspeed_tpu_torch.processing_chain import build_processing_chain as torch_build_chain
from dspeed_tpu_torch.processors import _cuda, _tile_program

TILE_TOL = dict(rtol=2e-6, atol=2e-5)  # tests/test_tile_safety.py:92
B, N = 8, 256


def table(lh5, wf, bl):
    return lh5.Table({
        "waveform": lh5.WaveformTable(values=wf, t0=0.0, t0_units="ns", dt=16.0,
                                      dt_units="ns"),
        "baseline": lh5.Array(bl),
    })


def events(dtype="float32", seed=11):
    """8 rows of 256 samples: a baseline, a pulse rising at sample 100 with
    a decay, noise; row 1 holds a NaN sample and row 6 is flat after its
    rise (searches that find nothing). Returns ``(wf, bl)``."""
    rng = np.random.default_rng(seed)
    t = np.arange(N)[None, :]
    amp = rng.uniform(50, 500, (B, 1))
    bl = rng.uniform(100, 200, B)
    wf = (bl[:, None] + amp * np.clip((t - 100) / 20, 0, 1) * np.exp(
        -np.maximum(t - 120, 0) / 300) + rng.normal(0, 2, (B, N)))
    wf[1, 40] = np.nan
    wf[6, 130:] = wf[6, 129]
    return wf.astype(dtype), bl.astype(dtype)


def one_op(processors: dict, name: str, wf, bl, outputs, db=None):
    """``(step, vals, env, chain)``: the unfused chain of ``processors``
    (after a baseline subtraction, ``wf_blsub``) on ``(wf, bl)`` with the
    database ``db``, its step of kernel ``name``, and the env keys that step
    reads."""
    cfg = {"outputs": list(outputs), "processors": {
        "wf_blsub": {"function": "bl_subtract", "module": "dspeed_tpu.processors",
                     "args": ["waveform", "baseline", "wf_blsub(unit='ADC')"]},
        **processors}}
    chain, _, _ = torch_build_chain(cfg, table(dspeed_tpu_torch.lh5, wf, bl),
                                    db_dict=db, device="cpu", fuse=False)
    inputs, _ = chain._gather_inputs(0, len(wf))
    env = chain._run_steps(chain._to_device(inputs))
    step = next(s for s in chain._steps if isinstance(s, KernelStep)
                and s.kernel.__name__ == name)
    vals = {k: env[k] for k in sorted(chain._step_env_reads(step))}
    return step, vals, env, chain


def check_against_pallas(step, vals, jax_fn, codes):
    """Lower ``step`` alone (the ops ``codes``, a name or a tuple, besides
    its loads), walk the tape, and hold every output against ``jax_fn``
    (the JAX package's processor on the same arguments, a tuple) traced into
    ``_pallas.generic_rows`` in interpret mode. Returns the program."""
    import jax.numpy as jnp

    from dspeed_tpu.processors import _pallas

    codes = (codes,) if isinstance(codes, str) else tuple(codes)
    writes = [sp.key for sp in step.out_specs]
    prog = _tile_program.lower([step], vals, writes)
    ops = [op for op in prog.ops if op.code != _tile_program.OPCODES["load"]]
    assert [op.code for op in ops] == [_tile_program.OPCODES[c] for c in codes]
    got = _cuda.generic_rows_plain(prog, vals)
    op = ops[-1]

    def body(jv):
        jargs = [jv[prog.slots[a[1]].key].astype(
                     {torch.float32: jnp.float32, torch.float64: jnp.float64,
                      torch.bool: jnp.bool_, torch.int64: jnp.int64}[a[2]])
                 if a[0] == "slot" else a[1] for a in op.args]
        return dict(zip(writes, jax_fn(*jargs)))

    jvals = {k: np.asarray(v) for k, v in vals.items()}
    want = _pallas.generic_rows(body, jvals, {k: v.ndim - 1 for k, v in jvals.items()},
                                interpret=True)
    assert want is not None, f"{codes}: generic_rows declined"
    for k in writes:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"{k}: NaN")
        np.testing.assert_allclose(np.nan_to_num(a.astype(np.float64), nan=-12345.0),
                                   np.nan_to_num(b.astype(np.float64), nan=-12345.0),
                                   err_msg=k, **TILE_TOL)
    return prog


def check_float64_body(step, vals, jax_fn):
    """A float64 row: K7 takes float32 planes only, so the lowering refuses
    the op (its group splits and runs unfused); the member kernel itself is
    held against ``jax_fn`` traced into ``_pallas.generic_rows`` in interpret
    mode, in float64."""
    import pytest

    from dspeed_tpu.processors import _pallas

    writes = [sp.key for sp in step.out_specs]
    with pytest.raises(_tile_program.LoweringError, match="float32"):
        _tile_program.lower([step], vals, writes)
    args = [vals[s.key] if s.kind == "env" else s.value for s in step.arg_specs]
    got = step.kernel(*args)
    keys = [s.key for s in step.arg_specs if s.kind == "env"]

    def body(jv):
        jargs = [jv[s.key] if s.kind == "env" else s.value for s in step.arg_specs]
        return dict(zip(writes, jax_fn(*jargs)))

    jvals = {k: np.asarray(vals[k]) for k in keys}
    want = _pallas.generic_rows(body, jvals, {k: v.ndim - 1 for k, v in jvals.items()},
                                interpret=True)
    assert want is not None
    for k, g in zip(writes, got):
        a, b = g.numpy(), np.asarray(want[k])
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        ok = np.isfinite(b)
        assert np.abs(a[ok] - b[ok]).max() <= 1e-9 * np.abs(b[ok]).max(), k
