"""``module: numpy`` processors in the port against the JAX package.

The JAX package swaps a numpy function for its ``jax.numpy`` namesake, which
keeps numpy's signature; the port takes it from its own table
(``dspeed_tpu_torch/_numpy_funcs.py``). Each case runs one such processor
through both packages' ``build_dsp`` on the same seeded float32 table, which
holds a NaN sample in one row and an all-NaN row. Float outputs agree within
rtol 1e-6, index outputs exactly, NaN positions identically. The running sums
and products are float32 scans that round in another order in XLA than in
PyTorch, so their error is bounded by 1e-6 of the column's scale (max |jax|),
not of each element: a partial sum near zero carries the rounding of the
larger terms before it.
"""

import sys

import numpy as np
import pytest
import torch

import dspeed_tpu
import dspeed_tpu_torch
from dspeed_tpu_torch._numpy_funcs import NUMPY_FUNCS
from dspeed_tpu_torch.errors import ProcessingChainError


@pytest.fixture(autouse=True)
def fresh_chain_cache():
    """Each test builds its own chains: one that another test cached (with
    other fusion passes or settings patched in) must not serve it."""
    from dspeed_tpu_torch import build_dsp

    cache = sys.modules[build_dsp.__module__]._CHAIN_CACHE
    cache.clear()
    yield
    cache.clear()


# name -> (input args, signature, types[, the output's declaration])
CASES = {
    # tests/test_numpy_parsing.py:126-144
    "median": (["waveform", 1], "(n),()->()", "fi->f"),
    # tests/test_numpy_parsing.py:62-80: numpy's positional dtype
    "cumsum": (["waveform", 1, None], "(n),(),()->(n)", "fii->f"),
    "sort": (["waveform", 1], "(n),()->(n)", "fi->f"),
    "nanmax": (["waveform", 1], "(n),()->()", "fi->f"),
    "nanmin": (["waveform", 1], "(n),()->()", "fi->f"),
    "nanstd": (["waveform", 1], "(n),()->()", "fi->f"),
    "nanvar": (["waveform", 1], "(n),()->()", "fi->f"),
    "nanargmax": (["waveform", 1], "(n),()->()", "fi->i"),
    "nanargmin": (["waveform", 1], "(n),()->()", "fi->i"),
    "nancumsum": (["waveform", 1], "(n),()->(n)", "fi->f"),
    "nancumprod": (["waveform", 1], "(n),()->(n)", "fi->f"),
    "percentile": (["waveform", 30.0, 1], "(n),(),()->()", "ffi->f"),
    "ptp": (["waveform", 1], "(n),()->()", "fi->f"),
    "average": (["waveform", 1], "(n),()->()", "fi->f"),
    "round": (["waveform", 2], "(n),()->(n)", "fi->f"),
    "flip": (["waveform", 1], "(n),()->(n)", "fi->f"),
    "std": (["waveform", 1], "(n),()->()", "fi->f"),
    "amax": (["waveform", 1], "(n),()->()", "fi->f"),
    # torch's namesakes of these take numpy's positional arguments; the
    # table still holds each, so none is taken on trust
    "diff": (["waveform", 1, -1], "(n),(),()->(m)", "fii->f", "out(31, 'float32')"),
    "clip": (["waveform", -0.5, 0.5], "(n),(),()->(n)", "fff->f"),
    "where": (["waveform > 0", "waveform", 0.0], "(n),(n),()->(n)", "?ff->f"),
}
INDEX_OUTPUTS = ("nanargmax", "nanargmin")
SCANS = ("cumsum", "nancumsum", "nancumprod")


def _values(seed=7):
    x = np.random.default_rng(seed).normal(0, 1, (6, 32)).astype("float32")
    x[1, 5] = np.nan
    x[3] = np.nan
    return x


def _table(lh5, x):
    return lh5.Table({
        "waveform": lh5.WaveformTable(values=x, dt=16, dt_units="ns"),
    })


def _run(pkg, x, function, args, signature, types, out="out", **kw):
    config = {
        "outputs": ["out"],
        "processors": {
            "out": {
                "function": function,
                "module": "numpy",
                "args": [*args, out],
                "kwargs": {"signature": signature, "types": [types]},
            }
        },
    }
    out = pkg.build_dsp(_table(pkg.lh5, x), dsp_config=config, **kw)["out"]
    return np.asarray(getattr(out, "values", out).nda)


def _assert_same(got, want, what):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    ok = ~np.isnan(want)
    if what in INDEX_OUTPUTS:
        np.testing.assert_array_equal(got[ok], want[ok], err_msg=what)
        return
    atol = 1e-6 * np.abs(want[ok]).max() if what in SCANS else 0.0
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-6, atol=atol, err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_numpy_function_matches_jax(name):
    case = CASES[name]
    x = _values()
    want = _run(dspeed_tpu, x, name, *case)
    got = _run(dspeed_tpu_torch, x, name, *case, device="cpu")
    _assert_same(got, want, name)


def test_weighted_average_matches_jax():
    w = list(np.linspace(0.5, 2.0, 32))
    args = (["waveform", 1, w], "(n),(),(n)->()", "fid->f")
    x = _values()
    want = _run(dspeed_tpu, x, "average", *args)
    got = _run(dspeed_tpu_torch, x, "average", *args, device="cpu")
    _assert_same(got, want, "average(weights)")


def test_median_of_an_even_count_averages_the_middle_pair():
    x = np.array([[1, 2, 3, 4], [4, 1, 3, 2]], dtype="float32")
    args = (["waveform", 1], "(n),()->()", "fi->f")
    got = _run(dspeed_tpu_torch, x, "median", *args, device="cpu")
    want = _run(dspeed_tpu, x, "median", *args)
    np.testing.assert_array_equal(got, [2.5, 2.5])
    np.testing.assert_array_equal(got, want)


# torch's nanmedian takes the lower middle value and its nan_to_num has no
# positional copy; neither is in the table
@pytest.mark.parametrize("name", ["nanmedian", "nan_to_num"])
def test_a_numpy_function_without_an_entry_raises(name):
    with pytest.raises(ProcessingChainError) as err:
        _run(dspeed_tpu_torch, _values(), name, ["waveform", 1], "(n),()->()",
             "fi->f", device="cpu")
    assert f"numpy.{name} has no counterpart" in str(err.value.__cause__)


def test_every_table_entry_keeps_its_numpy_name():
    # each entry stands for the numpy function of its name
    for name in NUMPY_FUNCS:
        assert callable(getattr(np, name)), name
    # torch's namesakes differ from numpy on these: the table must not be them
    for name in ("median", "sort", "round", "flip", "cumsum"):
        assert NUMPY_FUNCS[name] is not getattr(torch, name)
