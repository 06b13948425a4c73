"""Checked mode in the port, held against the JAX package directly.

The JAX package's own checked-mode tests (``tests/test_checked.py``) hold it
against the reference's kernel bodies, which are not part of this tree, so
they skip here. These tests feed the same bad events to both packages'
checkers (the 12 kernels that declare one) and compare the codes and the
messages, and the unchecked kernels' NaN; then the chain, ``build_dsp`` and
the CLI with ``checked``; the steps each package flags on the flagship
(default and generic), the DPZ, the extras and the injection + ML
configurations; the toggle of a cached chain; and F11 (the port's CSE pass
merged two identical steps whose kernel declares a checker). On the card
(``gpu``), the flags equal the CPU's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from torch_flagship import flagship_config  # noqa: E402

import dspeed_tpu_torch  # noqa: E402
from dspeed_tpu_torch import lh5  # noqa: E402
from dspeed_tpu_torch.errors import DSPFatal  # noqa: E402
from dspeed_tpu_torch.processing_chain import GroupStep, KernelStep  # noqa: E402
from dspeed_tpu_torch.processing_chain import (  # noqa: E402
    build_processing_chain as torch_build_chain,
)
from dspeed_tpu_torch.processors import _cuda  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAU = {"pz": {"tau": 27460.5}}


def _port_build_dsp():
    """The port's ``build_dsp`` function. The package binds it lazily; a
    direct import of the submodule ``dspeed_tpu_torch.build_dsp`` binds the
    package attribute to the module instead, and the package's
    ``__getattr__`` binds it back."""
    return dspeed_tpu_torch.__getattr__("build_dsp")


def _jax_build_dsp():
    """The JAX package's ``build_dsp`` function, bound as the port's is."""
    import dspeed_tpu

    return dspeed_tpu.__getattr__("build_dsp")


@pytest.fixture(autouse=True)
def fresh_chain_cache():
    cache = sys.modules[_port_build_dsp().__module__]._CHAIN_CACHE
    cache.clear()
    yield
    cache.clear()


# ---------------------------------------------------------------------------
# the 12 checkers, case by case (the bad events of tests/test_checked.py)


def _histogram_weights():
    nb = 16
    e = np.broadcast_to(np.linspace(-8, 8, nb + 1), (2, nb + 1)).copy()
    w = np.random.default_rng(42).uniform(0, 10, (2, nb))
    w[0, 3] = np.nan
    return w, e


def _nan_rows():
    w = np.random.default_rng(42).normal(0, 1, (3, 64))
    w[1, 10] = np.nan
    return w


def _centroid_rows():
    rng = np.random.default_rng(42)
    n = 128
    t = np.arange(n, dtype="f8")
    base = np.where(t < 50, -1.0, np.where(t < 78, (t - 64) / 14.0, 1.0))
    w = base[None, :].repeat(5, 0) + rng.normal(0, 0.01, (5, n))
    w[4] = np.nan
    return w


def _alignment_rows():
    w = np.random.default_rng(42).normal(0, 1, (5, 128))
    w[4] = np.nan
    return w


def _mtpt_inputs():
    w = np.linspace(0, 200, 64)[None, :].repeat(4, 0)
    thr = np.broadcast_to(np.array([50.0, 100.0, 150.0]), (4, 3)).copy()
    thr[2, 1] = np.nan
    t = np.full(4, 32.0)
    t[3] = 99999.0
    return w, thr, t, np.array([0.0, 1.0, 0.0, 0.0])


def _pz_rows():
    w = np.ones((4, 32))
    w[1, 4] = 0.0
    w[3, 0] = np.nan
    return w


def _rc_cr2_rows():
    w = np.cumsum(np.random.default_rng(42).normal(0, 1, (3, 64)), axis=1)
    w[2] = np.nan
    return w


_RAMP = np.linspace(0, 10, 32)[None, :]
# name -> (kernel module attribute, inputs factory, keyword args, expected codes)
CASES = {
    "get": ("get", lambda: (np.arange(24.0).reshape(2, 12),
                            np.array([3, 40], "int64")), {}, [0, 1]),
    "time_point_thresh_frac": (
        "time_point_thresh",
        lambda: (_RAMP.repeat(3, 0), np.full(3, 5.0), np.array([10.5, 10.0, 10.0]), 0),
        {}, [1, 0, 0]),
    "time_point_thresh_range": (
        "time_point_thresh",
        lambda: (_RAMP.repeat(3, 0), np.array([np.nan, 5.0, 5.0]),
                 np.array([10.0, 10.0, 99.0]), 0),
        {}, [0, 0, 2]),
    "fixed_time_pickoff_i": (
        "fixed_time_pickoff",
        lambda: (_RAMP.repeat(4, 0), np.array([4.5, 4.0, np.nan, 40.5]),
                 np.int8(ord("i"))), {}, [1, 0, 0, 0]),
    "fixed_time_pickoff_i_constant": (
        "fixed_time_pickoff",
        lambda: (np.where(np.arange(3)[:, None] == 1, np.nan, _RAMP), 4.5,
                 np.int8(ord("i"))), {}, [1, 0, 1]),
    "fixed_time_pickoff_l": (
        "fixed_time_pickoff",
        lambda: (_RAMP.repeat(2, 0), np.array([4.5, 4.0]), np.int8(ord("l"))),
        {}, [0, 0]),
    "trap_pickoff": (
        "trap_pickoff",
        lambda: (np.linspace(0, 10, 64)[None, :].repeat(2, 0), 4, 2,
                 np.array([30.25, 30.0])), {}, [1, 0]),
    "bi_level_zero_crossing_time_points": (
        "bi_level_zero_crossing_time_points",
        lambda: (np.sin(np.linspace(0, 20, 128))[None, :].repeat(2, 0) * 10, 3.0,
                 -3.0, 10.0, np.array([5.5, 5.0])), {"dims": {"m": 4}}, [1, 0]),
    "histogram_around_mode": (
        "histogram_around_mode", lambda: (_nan_rows(), np.nan, 2.0), {}, [0, 1, 0]),
    "histogram_peakstats": (
        "histogram_peakstats", lambda: (*_histogram_weights(), np.nan, 0, 0), {},
        [1, 0]),
    "get_wf_centroid": (
        "get_wf_centroid",
        lambda: (_centroid_rows(), np.array([np.nan, 5.0, -1.0, 500.0, 5.0])), {},
        [1, 0, 2, 3, 0]),
    "wf_alignment": (
        "wf_alignment",
        lambda: (_alignment_rows(), np.array([np.nan, 60.0, 60.0, 60.0, 60.0]),
                 np.array([5.0, np.nan, -2.0, 300.0, 5.0]), 40),
        {}, [1, 2, 3, 4, 0]),
    "multi_time_point_thresh": (
        "multi_time_point_thresh", lambda: (*_mtpt_inputs(), ord("i")), {},
        [1, 0, 0, 0]),
    "pole_zero": (
        "pole_zero",
        lambda: (_pz_rows(), np.array([27000.0, -1e-3, -1e-3, -1e-3])), {},
        [0, 1, 1, 0]),
    "rc_cr2": ("rc_cr2", lambda: (_rc_cr2_rows(), 30.0), {}, [0, 0, 0]),
}


# the kernels' own dims (their signatures leave these lengths open)
KERNEL_DIMS = {"bi_level_zero_crossing_time_points": {"m": 4},
               "histogram_around_mode": {"m": 8, "p": 9},
               "wf_alignment": {"m": 40}}
# kernels whose flagged event is NaN unchecked (the others follow the
# reference's arithmetic past the check, as in the JAX package)
NAN_WHEN_FLAGGED = ("get", "time_point_thresh", "fixed_time_pickoff", "pole_zero")


def _kernels(attr):
    import dspeed_tpu.processors as jp

    import dspeed_tpu_torch.processors as tp

    if attr == "bi_level_zero_crossing_time_points":
        from dspeed_tpu.processors.time_point_thresh import (
            bi_level_zero_crossing_time_points as jk,
        )

        from dspeed_tpu_torch.processors.time_point_thresh import (
            bi_level_zero_crossing_time_points as tk,
        )

        return tk, jk
    return getattr(tp, attr), getattr(jp, attr)


def _as(x, to):
    return to(x) if isinstance(x, np.ndarray) else x


def test_every_jax_checker_has_a_port():
    """The 12 kernels of the JAX package that declare a checker, and no
    other, declare one in the port."""
    import dspeed_tpu.processors as jp

    import dspeed_tpu_torch.processors as tp

    def checked(mod):
        return sorted(
            name for name in dir(mod)
            if getattr(getattr(mod, name), "checker", None) is not None
        )

    names = checked(jp)
    assert names == checked(tp)
    from dspeed_tpu_torch.processors.time_point_thresh import (
        bi_level_zero_crossing_time_points,
    )

    assert bi_level_zero_crossing_time_points.checker is not None
    assert len(set(names) | {"bi_level_zero_crossing_time_points"}) == 12
    assert {c[0] for c in CASES.values()} == set(names) | {
        "bi_level_zero_crossing_time_points"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_checker_matches_jax(case):
    """The same bad events give the same codes and messages in both
    packages; the unchecked kernels agree on which events are NaN, and
    every flagged event is NaN in both."""
    import jax.numpy as jnp

    attr, make, kw, want = CASES[case]
    tk, jk = _kernels(attr)
    inputs = make()
    t_in = [_as(x, torch.from_numpy) for x in inputs]
    j_in = [_as(x, jnp.asarray) for x in inputs]
    t_flag = tk.checker(*t_in, **kw)
    j_flag = np.asarray(jk.checker(*j_in, **kw))
    assert t_flag.dtype == torch.int32
    assert t_flag.numpy().tolist() == j_flag.tolist() == want
    assert tk.check_messages == jk.check_messages
    if attr == "multi_time_point_thresh":
        return  # the port's kernel takes a static polarity (checked at build)
    dims = KERNEL_DIMS.get(attr)
    call = {} if dims is None else {"dims": dims}
    t_outs, j_outs = tk(*t_in, **call), jk(*j_in, **call)
    assert len(t_outs) == len(j_outs)
    for t_out, j_out in zip(t_outs, j_outs):
        t_out, j_out = t_out.numpy(), np.asarray(j_out)
        if t_out.dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(t_out), np.isnan(j_out))
    if attr in NAN_WHEN_FLAGGED:
        rows = np.isnan(t_outs[0].numpy().reshape(len(want), -1)).any(axis=1)
        assert rows[np.asarray(want) != 0].all()


def test_pole_zero_flag_read_off_the_output():
    """In a chain, ``pole_zero``'s checker reads the step's own output
    (``checker_reads_outputs``): the flag equals the one that recomputes
    the filter, on the overflow case (a tiny negative tau)."""
    from dspeed_tpu_torch.processors import pole_zero

    w = torch.from_numpy(_pz_rows())
    tau = torch.tensor([27000.0, -1e-3, -1e-3, -1e-3], dtype=torch.float64)
    assert pole_zero.checker_reads_outputs
    out = pole_zero(w, tau)[0]
    assert torch.equal(pole_zero.checker(w, tau, out=out), pole_zero.checker(w, tau))


# ---------------------------------------------------------------------------
# the chain, build_dsp and the CLI


_GET_CFG = {
    "outputs": ["picked"],
    "processors": {
        "picked": {
            "function": "get",
            "module": "dspeed_tpu.processors",
            "args": ["waveform", "pickidx", "picked"],
        },
    },
}


def _get_table(mod, wf, idx):
    return mod.Table({
        "waveform": mod.WaveformTable(values=wf, t0=0.0, t0_units="ns", dt=16.0,
                                      dt_units="ns"),
        "pickidx": mod.Array(np.asarray(idx)),
    })


def _bad_get(n, bad, value):
    wf = np.random.default_rng(42).normal(0, 1, (n, 64)).astype("float32")
    idx = np.full(n, 5, "int64")
    idx[bad] = value
    return wf, idx


def _raised(fn):
    with pytest.raises(DSPFatal) as exc:
        fn()
    return exc.value.args[0], exc.value.processor, exc.value.wf_range


def _jax_raised(fn):
    from dspeed_tpu.errors import DSPFatal as JaxFatal

    with pytest.raises(JaxFatal) as exc:
        fn()
    return exc.value.args[0], exc.value.processor, exc.value.wf_range


def test_chain_raises_with_exact_entry():
    from dspeed_tpu import lh5 as jlh5
    from dspeed_tpu.processing_chain import build_processing_chain as jax_build

    wf, idx = _bad_get(16, 11, 400)
    chain, _, tb_out = torch_build_chain(_GET_CFG, _get_table(lh5, wf, idx),
                                         device="cpu")
    chain.set_checked(True)
    got = _raised(lambda: chain(_get_table(lh5, wf, idx), tb_out))
    jc, _, jout = jax_build(_GET_CFG, _get_table(jlh5, wf, idx))
    jc.set_checked(True)
    want = _jax_raised(lambda: jc(_get_table(jlh5, wf, idx), jout))
    assert got == want
    assert got[0] == "i is out of range" and got[2] == (11, 11)
    assert got[1].startswith("get(")
    # after the raise the chain runs on: unchecked, the event is NaN
    chain.set_checked(False)
    chain(_get_table(lh5, wf, idx), tb_out)
    picked = np.asarray(tb_out["picked"].nda)
    assert np.isnan(picked[11]) and np.isfinite(picked[0])


@pytest.mark.parametrize("route", ["file", "table"])
def test_build_dsp_annotates_global_entry(tmp_path, route):
    """``build_dsp(checked=True)`` raises with the entry in the whole input
    (the bad event in the second chunk of 16), as the JAX package does; the
    same call unchecked writes NaN there. Then the cached chain, toggled
    back, raises again."""
    import dspeed_tpu

    wf, idx = _bad_get(40, 27, 1000)
    kw = dict(buffer_len=16)
    if route == "file":
        raw = str(tmp_path / "chk_raw.lh5")
        lh5.write(_get_table(lh5, wf, idx), "ch000/raw", raw)
        out = str(tmp_path / "chk_dsp.lh5")
        args = (raw, out, _GET_CFG)
        kw.update(lh5_tables="ch000/raw", write_mode="r")
        jargs = (raw, str(tmp_path / "jchk_dsp.lh5"), _GET_CFG)
    else:
        args = (_get_table(lh5, wf, idx), None, _GET_CFG)
        jargs = (_get_table(dspeed_tpu.lh5, wf, idx), None, _GET_CFG)

    def port(checked):
        return _port_build_dsp()(*args, device="cpu", checked=checked, **kw)

    got = _raised(lambda: port(True))
    want = _jax_raised(lambda: _jax_build_dsp()(*jargs, checked=True, **kw))
    assert got == want
    assert got[0] == "i is out of range" and got[2] == (27, 27)
    res = port(False)
    if route == "file":
        import h5py

        with h5py.File(args[1]) as f:
            picked = f["ch000/dsp/picked"][:]
    else:
        picked = np.asarray(res["picked"].nda)
    assert len(picked) == 40
    assert np.isnan(picked[27]) and np.isfinite(picked[[0, 26, 28]]).all()
    assert _raised(lambda: port(True)) == got


def test_cli_checked(tmp_path):
    wf, idx = _bad_get(40, 27, 1000)
    raw = str(tmp_path / "run_raw.lh5")
    lh5.write(_get_table(lh5, wf, idx), "ch000/raw", raw)
    cfg = str(tmp_path / "get.json")
    with open(cfg, "w") as f:
        json.dump(_GET_CFG, f)
    out = str(tmp_path / "run_dsp.lh5")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    base = [sys.executable, "-m", "dspeed_tpu_torch.cli", raw, "-c", cfg, "-o", out,
            "--device", "cpu", "-k", "16"]
    res = subprocess.run(base + ["--checked"], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode != 0
    assert "DSPFatal" in res.stderr and "i is out of range" in res.stderr
    assert "(27, 27)" in res.stderr


def _events(n=8):
    wf, amp, t0, bl, _ = cs.make_hpge_waveforms(n)
    return wf, bl.astype("float32")


def _hpge_table(mod, wf, bl):
    return mod.Table({
        "waveform": mod.WaveformTable(values=wf, t0=0.0, t0_units="ns", dt=16.0,
                                      dt_units="ns"),
        "baseline": mod.Array(bl),
    })


PLAN_CONFIGS = {
    "flagship": (flagship_config, TAU, True),
    "flagship_generic": (flagship_config, TAU, "generic"),
    "dpz": (cs.dpz_config, TAU, True),
    "extras": (cs.extras_config, TAU, True),
    "inject_ml": (cs.inject_ml_config, None, True),
}


@pytest.mark.parametrize("name", sorted(PLAN_CONFIGS))
def test_check_steps_match_jax(name, monkeypatch):
    """The steps each package flags while checked, by their processor
    strings: on the fused flagship the four ``fixed_time_pickoff`` steps
    (K1 absorbs ``pole_zero``, and its checker, in both packages)."""
    import dspeed_tpu
    from dspeed_tpu.processing_chain import build_processing_chain as jax_build

    make, db, fuse = PLAN_CONFIGS[name]
    if db is None:
        db = cs.inject_ml_db(512)
    wf, bl = _events()
    if fuse == "generic":
        monkeypatch.setenv("DSPEED_TPU_FUSE", "generic")
    jc, _, _ = jax_build(make(), _hpge_table(dspeed_tpu.lh5, wf, bl), db_dict=db)
    jc.set_checked(True)
    jc._build_fn()
    tc, _, _ = torch_build_chain(make(), _hpge_table(lh5, wf, bl), db_dict=db,
                                 device="cpu", fuse=fuse)
    tc.set_checked(True)
    tc._run_plan()
    got = [str(s) for _, s in tc._check_steps]
    assert got == [str(s) for _, s in jc._check_steps]
    if name == "flagship":
        assert got == cs.CHECKED_FLAGSHIP_STEPS


def test_set_checked_toggles_a_cached_generic_chain(monkeypatch):
    """The generic flagship through ``build_dsp`` checked, then unchecked,
    then checked: one chain (a cache hit), K7's plain walk never while
    checked and twice a chunk unchecked (its groups and tapes kept), every
    column equal bit for bit (the plain walk equals the unfused steps)."""
    calls = []
    orig = _cuda.generic_rows

    def counted(prog, vals):
        calls.append(prog)
        return orig(prog, vals)

    monkeypatch.setattr(_cuda, "generic_rows", counted)
    wf, bl = _events(12)
    cfg = flagship_config()
    bdsp = sys.modules[_port_build_dsp().__module__]

    def run(checked):
        calls.clear()
        out = _port_build_dsp()(_hpge_table(lh5, wf, bl), dsp_config=cfg,
                                         database=TAU, device="cpu", fuse="generic",
                                         checked=checked)
        return {k: np.asarray(out[k].nda) for k in cfg["outputs"]}, len(calls)

    a, n_a = run(True)
    (chain, _, _), = bdsp._CHAIN_CACHE.values()
    programs = {id(s): dict(s._programs) for s in chain._steps
                if isinstance(s, GroupStep)}
    b, n_b = run(False)
    c, n_c = run(True)
    assert (n_a, n_b, n_c) == (0, 2, 0)
    assert len(bdsp._CHAIN_CACHE) == 1
    assert len(programs) == 2
    for s in chain._steps:
        if isinstance(s, GroupStep):
            assert all(s._programs[k] is v for k, v in programs[id(s)].items())
    for k in cfg["outputs"]:
        assert a[k].tobytes() == b[k].tobytes() == c[k].tobytes(), k


def test_flagship_bad_pickoff_raises_like_jax(tmp_path):
    """The chip phase's bad event at a small size: its configuration (the
    flagship plus one ``fixed_time_pickoff(wf_blsub, t_pick, 'i')`` on a
    per-event float column integral but at one event), its outputs cut to
    that pick-off; both packages raise the same message, processor string
    and entry through ``build_dsp`` over a file in chunks of 8 (the bad
    event in the second); unchecked, that event alone is NaN."""
    import dspeed_tpu

    wf, bl = _events(20)
    tb = _hpge_table(lh5, wf, bl)
    tb.add_field("t_pick", lh5.Array(cs.pickoff_times(20, bad=13)))
    raw = str(tmp_path / "pick_raw.lh5")
    lh5.write(tb, "ch000/raw", raw)
    cfg = cs.checked_raise_config()
    kw = dict(database={"ch000": TAU}, outputs=["pick_i"], buffer_len=8,
              write_mode="r")

    def port(checked):
        return _port_build_dsp()(raw, None, cfg, device="cpu",
                                          checked=checked, **kw)

    got = _raised(lambda: port(True))
    want = _jax_raised(lambda: _jax_build_dsp()(raw, None, cfg, checked=True,
                                                    **kw))
    assert got == want == (cs.PICK_MESSAGE, cs.PICK_PROCESSOR, (13, 13))
    picked = np.asarray(port(False)["ch000"]["dsp"]["pick_i"].nda)
    assert np.isnan(picked[13]) and np.isfinite(np.delete(picked, 13)).all()


# ---------------------------------------------------------------------------
# F11


_TWO_GETS = {
    "outputs": ["a", "b"],
    "processors": {
        "a": {"function": "get", "module": "dspeed_tpu.processors",
              "args": ["waveform", "pickidx", "a"]},
        "b": {"function": "get", "module": "dspeed_tpu.processors",
              "args": ["waveform", "pickidx", "b"]},
    },
}


def test_f11_cse_keeps_checker_steps():
    """Two identical ``get`` steps: the CSE pass keeps both in both
    packages (a kernel with a checker is never merged), so each raise site
    keeps its own flag column and step name."""
    from dspeed_tpu import lh5 as jlh5
    from dspeed_tpu.processing_chain import build_processing_chain as jax_build

    wf, idx = _bad_get(8, 2, 99)
    jc, _, _ = jax_build(_TWO_GETS, _get_table(jlh5, wf, idx))
    tc, _, _ = torch_build_chain(_TWO_GETS, _get_table(lh5, wf, idx), device="cpu")
    steps = [str(s) for s in tc._steps]
    assert steps == [str(s) for s in jc._steps]
    assert sum(s.startswith("get(waveform, pickidx, ") for s in steps) == 2
    assert all(isinstance(s, KernelStep) for s in tc._steps if "get(" in str(s))
    tc.set_checked(True)
    tc._run_plan()
    assert [str(s) for _, s in tc._check_steps] == [
        "get(waveform, pickidx, a)", "get(waveform, pickidx, b)"]


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_checker_on_the_card(cuda_device, case):
    """Each checker's flags on the card equal its CPU flags."""
    import dspeed_tpu_torch.processors as tp

    attr, make, kw, want = CASES[case]
    if attr == "bi_level_zero_crossing_time_points":
        from dspeed_tpu_torch.processors.time_point_thresh import (
            bi_level_zero_crossing_time_points as tk,
        )
    else:
        tk = getattr(tp, attr)
    inputs = make()
    cpu = tk.checker(*[_as(x, torch.from_numpy) for x in inputs], **kw)
    card = tk.checker(*[_as(x, lambda a: torch.from_numpy(a).to(cuda_device))
                        for x in inputs], **kw)
    assert card.cpu().tolist() == cpu.tolist() == want
