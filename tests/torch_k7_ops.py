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
# float64 rows: the golden replay's tolerance (tests/test_goldens.py:40-45),
# relative to a column's scale
F64_TOL = dict(rtol=1e-9, atol=1e-12)
B, N = 8, 256


def assert_f64_close(got, want, what):
    """``got`` against ``want`` at :data:`F64_TOL` of the column's scale:
    NaN and infinite positions equal, the finite values within ``atol +
    rtol * max|want|``."""
    a, b = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"{what}: NaN")
    np.testing.assert_array_equal(a[np.isinf(b)], b[np.isinf(b)], err_msg=f"{what}: inf")
    ok = np.isfinite(b)
    if ok.any():
        err = np.abs(a[ok] - b[ok]).max()
        lim = F64_TOL["atol"] + F64_TOL["rtol"] * np.abs(b[ok]).max()
        assert err <= lim, f"{what}: max |diff| {err:.3e} > {lim:.3e}"


def widen(cfg):
    """``cfg`` (a config, or its processors) with its float32 declarations
    widened to float64: its outputs' ``'f'`` and its ufuncs' and reductions'
    types, as ``chip_smoke.flagship_config`` widens the flagship's."""
    import json

    txt = json.dumps(cfg)
    for f32, f64 in (("'f')", "'d')"), ('"fi->f"', '"di->d"'), ('"f->f"', '"d->d"'),
                     ('"ff->f"', '"dd->d"'), ('"f->?"', '"d->?"')):
        txt = txt.replace(f32, f64)
    return json.loads(txt)


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


def check_against_pallas(step, vals, jax_fn, codes, f64=False):
    """Lower ``step`` alone (the ops ``codes``, a name or a tuple, besides
    its loads), walk the tape, and hold every output against ``jax_fn``
    (the JAX package's processor on the same arguments, a tuple) traced into
    ``_pallas.generic_rows`` in interpret mode, at ``TILE_TOL`` (with
    ``f64``, float64 rows: at :data:`F64_TOL` of the column's scale).
    Returns the program."""
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
        if f64:
            assert_f64_close(a, b, k)
            continue
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"{k}: NaN")
        np.testing.assert_allclose(np.nan_to_num(a.astype(np.float64), nan=-12345.0),
                                   np.nan_to_num(b.astype(np.float64), nan=-12345.0),
                                   err_msg=k, **TILE_TOL)
    return prog


def member_outputs(step, vals) -> dict:
    """The member's own kernel body (the unfused step's run) on ``vals``:
    its outputs by key."""
    env = dict(vals)
    step.run(env)
    return {sp.key: env[sp.key] for sp in step.out_specs}


def check_float64_body(step, vals, jax_fn, codes):
    """A float64 row, on which K7 runs the op (its ops ``codes``, as
    :func:`check_against_pallas` takes them) in a float64 program: the tape's
    plain walk against ``jax_fn`` traced into ``_pallas.generic_rows`` in
    interpret mode, in float64, and the member's own body against the plain
    walk, each at :data:`F64_TOL` of the column's scale; and the member
    kernel itself against ``jax_fn`` in float64."""
    from dspeed_tpu.processors import _pallas

    writes = [sp.key for sp in step.out_specs]
    prog = check_against_pallas(step, vals, jax_fn, codes, f64=True)
    assert prog.f64
    plain = _cuda.generic_rows_plain(prog, vals)
    for k, v in member_outputs(step, vals).items():
        assert_f64_close(v.numpy(), plain[k].numpy(), f"{k}: member against plain walk")
    member = member_outputs(step, vals)
    keys = [s.key for s in step.arg_specs if s.kind == "env"]

    def body(jv):
        jargs = [jv[s.key] if s.kind == "env" else s.value for s in step.arg_specs]
        return dict(zip(writes, jax_fn(*jargs)))

    jvals = {k: np.asarray(vals[k]) for k in keys}
    want = _pallas.generic_rows(body, jvals, {k: v.ndim - 1 for k, v in jvals.items()},
                                interpret=True)
    assert want is not None
    for k in writes:
        a, b = member[k].numpy(), np.asarray(want[k])
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        ok = np.isfinite(b)
        assert np.abs(a[ok] - b[ok]).max() <= 1e-9 * np.abs(b[ok]).max(), k


def member_name(step):
    """The name of a step's kernel (or a FuncStep's function), else None."""
    kern = getattr(step, "kernel", None)
    return kern.__name__ if kern is not None else getattr(getattr(step, "fn", None),
                                                          "__name__", None)


def jax_member(op):
    """The JAX package's function for ``op``'s member, on the op's
    arguments."""
    import jax.numpy as jnp

    import dspeed_tpu.processors as jp
    from dspeed_tpu.processors import unit_conversion

    step = op.step
    name = member_name(step)
    if not hasattr(step, "kernel"):  # a FuncStep
        return getattr(jnp, name)
    if name in _tile_program.REDUCTIONS or name == "amax":
        return lambda x, axis: getattr(jnp, name)(x, axis=-1)
    if name.startswith("convert"):
        return getattr(unit_conversion, name)
    if name in _tile_program.UFUNCS and name != "where":
        return getattr(jnp, name)
    fn = getattr(jp, name)
    if step.kernel.uses_dims:
        return lambda *a: fn(*a, dims=step.dims)
    return fn


def check_group(steps, vals, codes, f64=False, except_rows=(), jax_out=None):
    """Lower ``steps`` as one group (the ops ``codes``, besides its loads),
    walk the tape, and hold every output against the JAX package's members
    traced into ``_pallas.generic_rows`` in interpret mode on the same
    inputs, at ``TILE_TOL`` (with ``f64``: at :data:`F64_TOL` of the
    column's scale), on every row but ``except_rows`` (a known difference
    the caller holds itself). ``jax_out`` (a dict) receives the JAX
    package's outputs. Returns the program."""
    import jax.numpy as jnp

    from dspeed_tpu.processors import _pallas
    from dspeed_tpu_torch.processing_chain import _step_writes

    writes = sorted(set().union(*(_step_writes(s) for s in steps)))
    prog = _tile_program.lower(steps, vals, writes)
    ops = [op for op in prog.ops if op.code != _tile_program.OPCODES["load"]]
    assert [op.code for op in ops] == [_tile_program.OPCODES[c] for c in codes]
    got = _cuda.generic_rows_plain(prog, vals)
    jdt = {torch.float32: jnp.float32, torch.float64: jnp.float64, torch.bool: jnp.bool_,
           torch.int64: jnp.int64}

    def body(jv):
        env = dict(jv)

        def get(sid):
            s = prog.slots[sid]
            if s.key not in env:  # a view: its root's, sliced
                v = get(s.root)
                whole = (s.start, s.length) == (0, prog.slots[s.root].length)
                env[s.key] = v if s.kind != "plane" or whole else \
                    v[..., s.start:s.start + s.length]
            return env[s.key]

        for op in ops:
            jargs = [get(a[1]) if a[0] == "slot" else a[1] for a in op.args]
            jargs = [v.astype(jdt[a[2]]) if a[0] == "slot" and a[2] is not None else v
                     for v, a in zip(jargs, op.args)]
            if op.code == _tile_program.OPCODES["ewise"]:
                jargs = [v[:, None] if getattr(v, "ndim", 0) == 1 else v for v in jargs]
            outs = jax_member(op)(*jargs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            for sid, o in zip(op.outs, outs):
                env[prog.slots[sid].key] = o
        return {k: get(prog.by_key[k]) for k in writes}

    jvals = {k: np.asarray(v) for k, v in vals.items()}
    want = _pallas.generic_rows(body, jvals, {k: v.ndim - 1 for k, v in jvals.items()},
                                interpret=True)
    assert want is not None, f"{codes}: generic_rows declined"
    if jax_out is not None:
        jax_out.update({k: np.asarray(want[k]) for k in writes})
    for k in writes:
        rows = np.setdiff1d(np.arange(got[k].shape[0]), except_rows)
        a, b = got[k].numpy()[rows], np.asarray(want[k])[rows]
        if f64:
            assert_f64_close(a, b, k)
            continue
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_array_equal(np.isnan(a.astype(np.float64)),
                                      np.isnan(b.astype(np.float64)), err_msg=f"{k}: NaN")
        np.testing.assert_allclose(np.nan_to_num(a.astype(np.float64), nan=-12345.0),
                                   np.nan_to_num(b.astype(np.float64), nan=-12345.0),
                                   err_msg=k, **TILE_TOL)
    return prog
