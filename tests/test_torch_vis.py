"""The port's waveform browser (``dspeed_tpu_torch.vis``) against the JAX
package's (``dspeed_tpu.vis``), on the six scenarios of
``tests/vis/test_waveform_browser.py``: a basic draw, DSP outputs and a
legend, table input and iteration, norm and align, chunk crossing, an entry
list with aux values.

Both browsers read the same seeded 32-event file (written once with h5py)
or table; the port's chain runs on the CPU (``device="cpu"``). Every stored
line's x and y data, ``n_stored``, ``len``, the legend texts, the x label,
the auto limits and the ``IndexError`` past the end are compared: float32
columns within 1e-4 of their scale, a time point (``tp_*``) within one
sample (16 ns), as ``tests/ref_oracle/test_parity_chain.py:173-191`` holds
the chain. A subprocess builds the port's browser and fetches entries with
matplotlib kept out of ``sys.modules``: the data path needs none.
"""

import os
import re
import subprocess
import sys

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import dspeed_tpu_torch  # noqa: E402
from dspeed_tpu_torch.vis import WaveformBrowser as TorchBrowser  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "hpge-energy-timing.yaml")
DB = {"pz": {"tau": 27460.5}}
REL = 1e-4  # of a float32 column's scale
SAMPLE_NS = 16.0  # a time point's tolerance: one sample


@pytest.fixture(autouse=True)
def fresh_chain_cache():
    from dspeed_tpu_torch import build_dsp

    cache = sys.modules[build_dsp.__module__]._CHAIN_CACHE
    cache.clear()
    yield
    cache.clear()


def _table(lh5, wf, bl):
    return lh5.Table({
        "waveform": lh5.WaveformTable(values=wf, t0=0.0, t0_units="ns", dt=16.0,
                                      dt_units="ns"),
        "baseline": lh5.Array(bl.astype("float32")),
    })


@pytest.fixture(scope="module")
def raw_file(tmp_path_factory):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_build_dsp import make_hpge_waveforms

    from dspeed_tpu import lh5

    path = str(tmp_path_factory.mktemp("torch_vis") / "vis_raw.lh5")
    wf, _amp, _t0, bl = make_hpge_waveforms(n=32)
    lh5.write(_table(lh5, wf, bl), "geds/raw", path)
    return path


def _jax_browser(*args, **kwargs):
    from dspeed_tpu.vis import WaveformBrowser

    return WaveformBrowser(*args, **kwargs)


def _torch_browser(*args, **kwargs):
    return TorchBrowser(*args, device="cpu", **kwargs)


def _tol(want):
    """``REL`` of the data's finite scale."""
    fin = np.abs(want[np.isfinite(want)])
    return REL * (fin.max() if fin.size else 1.0)


def _close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    ok = np.isfinite(b)
    np.testing.assert_array_equal(a[~ok & ~np.isnan(b)], b[~ok & ~np.isnan(b)],
                                  err_msg=what)
    if ok.any():
        err = np.abs(a[ok] - b[ok]).max()
        assert err <= tol, f"{what}: {err:.3e} > {tol:.3e}"


_NUM = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?|nan|inf")


def _same_text(a, b, tol, what):
    """Legend texts: the same words, their numbers within ``tol``."""
    assert _NUM.sub("#", a) == _NUM.sub("#", b), (what, a, b)
    _close([float(x) for x in _NUM.findall(a)], [float(x) for x in _NUM.findall(b)],
           tol, what)


def _same_store(tw, jw, time_lines=(), x_per_ns=1.0, tp_align=False):
    """The port's browser ``tw`` holds what the JAX package's ``jw`` holds:
    counts, every line's x and y data, legend values and the auto limits.
    ``time_lines``: lines whose x is a time point (one sample's tolerance);
    ``tp_align``: x is aligned on a time point (x within one sample)."""
    assert tw.n_stored == jw.n_stored
    assert len(tw) == len(jw)
    assert tw.next_entry == jw.next_entry
    assert list(tw.lines) == list(jw.lines)
    sample = SAMPLE_NS * x_per_ns
    for name in jw.lines:
        assert len(tw.lines[name]) == len(jw.lines[name]), name
        for i, (t, j) in enumerate(zip(tw.lines[name], jw.lines[name])):
            jx, jy = np.asarray(j.get_xdata()), np.asarray(j.get_ydata())
            x_tol = sample if (name in time_lines or tp_align) else 1e-9 * max(
                1.0, np.abs(jx[np.isfinite(jx)]).max())
            _close(t.get_xdata(), jx, x_tol, f"{name}[{i}] x")
            _close(t.get_ydata(), jy, _tol(jy), f"{name}[{i}] y")
    assert list(tw.legend_vals) == list(jw.legend_vals)
    for name, vals in jw.legend_vals.items():
        tv = tw.legend_vals[name]
        assert len(tv) == len(vals), name
        for a, b in zip(tv, vals):
            if isinstance(b, str):
                assert a == b, name
                continue
            assert str(getattr(a, "u", "")) == str(getattr(b, "u", "")), name
            am, bm = float(getattr(a, "m", a)), float(getattr(b, "m", b))
            _close([am], [bm], REL * max(abs(bm), 1.0), f"legend {name}")
    assert str(tw.x_unit) == str(jw.x_unit)
    for k in (0, 1):
        _close([tw.auto_y_lim[k]], [jw.auto_y_lim[k]],
               REL * max(1.0, np.abs(np.asarray(jw.auto_y_lim)[np.isfinite(jw.auto_y_lim)]).max(
                   initial=1.0)), "auto_y_lim")
        _close([tw.auto_x_lim[k]], [jw.auto_x_lim[k]], sample if (time_lines or tp_align)
               else 1e-9 * max(1.0, abs(jw.auto_x_lim[k])), "auto_x_lim")


def _same_drawing(tw, jw, tol=0.0):
    """Both drawn: the same x label, and legend texts with the same words
    and numbers within ``tol``."""
    tw.draw_current()
    jw.draw_current()
    assert tw.ax.get_xlabel() == jw.ax.get_xlabel()
    tl, jl = tw.ax.get_legend(), jw.ax.get_legend()
    assert (tl is None) == (jl is None)
    if jl is not None:
        tt = [t.get_text() for t in tl.get_texts()]
        jt = [t.get_text() for t in jl.get_texts()]
        assert len(tt) == len(jt)
        for a, b in zip(tt, jt):
            _same_text(a, b, tol, "legend text")
    assert len(tw.ax.get_lines()) == len(jw.ax.get_lines())


def test_basic_waveform_draw(raw_file):
    tw = _torch_browser(raw_file, "geds/raw", lines="waveform")
    jw = _jax_browser(raw_file, "geds/raw", lines="waveform")
    tw.draw_entry(3)
    jw.draw_entry(3)
    assert tw.n_stored == 1 and len(tw.lines["waveform"][0].get_xdata()) == 4096
    _same_store(tw, jw)
    _same_drawing(tw, jw)
    assert tw.ax.get_xlabel() == "ns"


def test_dsp_outputs_and_legend(raw_file):
    kw = dict(dsp_config=CONFIG, database=DB, lines=["wf_blsub", "tp_50", "trapEmax"],
              legend=["trapEmax"], x_unit="us")
    tw = _torch_browser(raw_file, "geds/raw", **kw)
    jw = _jax_browser(raw_file, "geds/raw", **kw)
    tw.draw_entry([1, 2], append=False)
    jw.draw_entry([1, 2], append=False)
    assert tw.n_stored == 2
    x = tw.lines["wf_blsub"][0].get_xdata()
    assert x[-1] == pytest.approx(4095 * 16.0 / 1000.0)
    _same_store(tw, jw, time_lines=("tp_50",), x_per_ns=1e-3)
    scale = max(abs(float(getattr(v, "m", v))) for v in jw.legend_vals["trapEmax"])
    _same_drawing(tw, jw, tol=REL * scale)
    assert any("trapEmax" in t.get_text() for t in tw.ax.get_legend().get_texts())


def test_table_input_and_iteration(raw_file):
    from dspeed_tpu import lh5 as jlh5

    tw = _torch_browser(dspeed_tpu_torch.lh5.read("geds/raw", raw_file),
                        lines="waveform", n_drawn=4)
    jw = _jax_browser(jlh5.read("geds/raw", raw_file), lines="waveform", n_drawn=4)
    assert list(tw.draw_next()) == list(jw.draw_next()) == [0, 1, 2, 3]
    _same_store(tw, jw)
    assert list(tw.draw_next()) == list(jw.draw_next()) == [4, 5, 6, 7]
    _same_store(tw, jw)
    _same_drawing(tw, jw)
    with pytest.raises(IndexError):
        tw.find_entry(32)
    with pytest.raises(IndexError):
        jw.find_entry(32)


def test_norm_and_align(raw_file):
    kw = dict(dsp_config=CONFIG, database=DB, lines="wf_blsub", norm="trapEmax",
              align="tp_50")
    tw = _torch_browser(raw_file, "geds/raw", **kw)
    jw = _jax_browser(raw_file, "geds/raw", **kw)
    tw.draw_entry(0)
    jw.draw_entry(0)
    y = tw.lines["wf_blsub"][0].get_ydata()
    assert 0.8 < np.nanmax(y) < 1.3
    x = tw.lines["wf_blsub"][0].get_xdata()
    assert x[0] < 0 < x[-1]
    _same_store(tw, jw, tp_align=True)
    _same_drawing(tw, jw)


def test_chunk_crossing(raw_file):
    """Entries in three chunks of 8 and back: each entry's stored row is its
    own, not a row the chain computed for an earlier chunk; the DSP line
    equals the port's build_dsp of the whole file."""
    kw = dict(lines=["waveform", "wf_blsub"], dsp_config=CONFIG, database=DB,
              buffer_len=8)
    tw = _torch_browser(raw_file, "geds/raw", **kw)
    jw = _jax_browser(raw_file, "geds/raw", **kw)
    entries = [3, 20, 5, 31, 12]
    for e in entries:
        tw.find_entry(e)
        jw.find_entry(e)
    assert tw.n_stored == len(entries)
    _same_store(tw, jw)
    raw = dspeed_tpu_torch.lh5.read("geds/raw", raw_file)
    full = dspeed_tpu_torch.build_dsp(raw, dsp_config=CONFIG, database=DB,
                                      device="cpu", outputs=["wf_blsub"])
    for i, e in enumerate(entries):
        np.testing.assert_array_equal(tw.lines["waveform"][i].get_ydata(),
                                      raw["waveform"].values.nda[e])
        np.testing.assert_array_equal(tw.lines["wf_blsub"][i].get_ydata(),
                                      full["wf_blsub"].values.nda[e])
    for wb in (tw, jw):
        with pytest.raises(IndexError):
            wb.find_entry(99)


def test_entry_list_and_aux_values(raw_file):
    aux = {"run_label": np.array([f"r{i}" for i in range(32)], dtype=object)}
    kw = dict(entry_list=[3, 7, 11, 19], lines="waveform", aux_values=aux,
              legend=["run_label"])
    tw = _torch_browser(raw_file, "geds/raw", **kw)
    jw = _jax_browser(raw_file, "geds/raw", **kw)
    assert len(tw) == len(jw) == 4
    tw.draw_entry(1)
    jw.draw_entry(1)
    assert tw.legend_vals["run_label"][0] == "r7"
    _same_store(tw, jw)
    _same_drawing(tw, jw)
    np.testing.assert_array_equal(
        tw.lines["waveform"][0].get_ydata(),
        dspeed_tpu_torch.lh5.read("geds/raw", raw_file)["waveform"].values.nda[7])


_NO_MATPLOTLIB = r"""
import sys
sys.path.insert(0, {repo!r})
sys.modules["matplotlib"] = None  # any import of it fails
import numpy as np
from dspeed_tpu_torch import lh5
from dspeed_tpu_torch.vis import WaveformBrowser

rng = np.random.default_rng(5)
wf = (15000 + rng.normal(0, 3, (12, 4096))).astype("float32")
wf[:, 1000:] += np.linspace(500, 8000, 12, dtype="float32")[:, None]
tb = lh5.Table({{
    "waveform": lh5.WaveformTable(values=wf, t0=0.0, t0_units="ns", dt=16.0,
                                  dt_units="ns"),
    "baseline": lh5.Array(np.full(12, 15000, "float32")),
}})
wb = WaveformBrowser(tb, dsp_config={config!r}, database={{"pz": {{"tau": 27460.5}}}},
                     lines=["wf_blsub", "tp_50", "trapEmax"], legend=["trapEmax"],
                     x_unit="us", norm="trapEmax", align="tp_50", device="cpu")
wb.find_entry([2, 7])
wb.find_next(3)
assert wb.n_stored == 3 and len(wb.lines["wf_blsub"]) == 3, wb.n_stored
y = wb.lines["wf_blsub"][0].get_ydata()
assert 0.8 < np.nanmax(y) < 1.3
print(sorted(m for m in sys.modules if m.startswith("matplotlib") and sys.modules[m]))
"""


def test_data_path_needs_no_matplotlib():
    code = _NO_MATPLOTLIB.format(repo=REPO, config=CONFIG)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"
