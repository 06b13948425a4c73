"""VectorOfVectors I/O of the port (``LGDOVectorOfVectorsIOManager``,
``dspeed_tpu_torch/processing_chain.py``) against the JAX package's on the
same inputs: VoV columns in and out of a chain, a ``WaveformTable`` of VoV
values, rows without a declared maximum length, float counts as vector
lengths, the LH5 file round trip of the SiPM chain (channel-wise, as
``tests/test_build_dsp.py::test_sipm_channelwise_vov``) and the production
loop (read-ahead, staging, write-behind) over several chunks of it.
"""

import os
import sys

import numpy as np
import pytest

import dspeed_tpu_torch
from dspeed_tpu_torch import lh5
from dspeed_tpu_torch.errors import DSPFatal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIPM = os.path.join(REPO, "configs", "sipm-pulse-finding.yaml")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def fresh_chain_cache():
    cache = sys.modules[dspeed_tpu_torch.build_dsp.__module__]._CHAIN_CACHE
    cache.clear()
    yield
    cache.clear()


def _both(make_table, config, **kw):
    """``build_dsp`` of ``config`` on the table ``make_table(lh5 module)``
    through the port (CPU) and the JAX package."""
    import dspeed_tpu
    from dspeed_tpu import lh5 as jlh5

    got = dspeed_tpu_torch.build_dsp(make_table(lh5), dsp_config=config,
                                     device="cpu", **kw)
    want = dspeed_tpu.build_dsp(make_table(jlh5), dsp_config=config, **kw)
    return got, want


def _vov_equal(a, b, what=""):
    ca, cb = np.asarray(a.cumulative_length.nda), np.asarray(b.cumulative_length.nda)
    np.testing.assert_array_equal(ca, cb, err_msg=f"{what} lengths")
    assert ca.dtype == cb.dtype
    fa = np.asarray(a.flattened_data.nda)[: ca[-1] if len(ca) else 0]
    fb = np.asarray(b.flattened_data.nda)[: cb[-1] if len(cb) else 0]
    assert fa.dtype == fb.dtype, what
    np.testing.assert_array_equal(fa, fb, err_msg=what)
    assert a.attrs.get("units") == b.attrs.get("units"), what


def _vov_rows(rng, n=6, dtype="float64"):
    return [np.arange(i + 1, dtype=dtype) * 1.5 + rng.normal(0, 1)
            for i in range(n)]


def test_io_type_round_trips_match_jax():
    """All LGDO input column types, a VoV among them, flow through the chain
    unchanged (``tests/test_coordinate_grids.py::test_io_type_round_trips``)."""
    rng = np.random.default_rng(42)
    n = 6
    aoesa = rng.normal(0, 1, (n, 12))
    rows = _vov_rows(rng, n)
    wf = rng.normal(0, 1, (n, 16))

    def table(m):
        return m.Table({
            "scalar_col": m.Array(np.arange(n, dtype="float64")),
            "aoesa_col": m.ArrayOfEqualSizedArrays(aoesa),
            "vov_col": m.VectorOfVectors(data=rows),
            "wf_col": m.WaveformTable(values=wf, dt=16, dt_units="ns"),
        })

    config = {
        "outputs": ["s2", "a2", "v2", "w2"],
        "processors": {
            "s2": "scalar_col*1",
            "a2": "aoesa_col*1",
            "v2": "vov_col(shape=8, vector_len=len(vov_col))*1",
            "w2": "wf_col*1",
        },
    }
    got, want = _both(table, config)
    assert isinstance(got["v2"], lh5.VectorOfVectors)
    for i in range(n):
        np.testing.assert_array_equal(got["v2"][i], rows[i])
    _vov_equal(got["v2"], want["v2"], "v2")
    np.testing.assert_array_equal(got["a2"].nda, aoesa)
    np.testing.assert_array_equal(got["w2"].values.nda, want["w2"].values.nda)


def test_waveform_table_of_vov_values_matches_jax():
    """A ``WaveformTable`` whose values are a VoV (the JAX package's
    ``processing_chain.py:4134-4137``): rows of 10 to 19 samples padded to
    32 on the device, written back at their lengths."""
    rng = np.random.default_rng(42)
    rows = [rng.normal(0, 1, 10 + 3 * i) for i in range(4)]

    def table(m):
        vov = m.VectorOfVectors(data=rows, dtype="float64")
        return m.Table({"wf_vov": m.WaveformTable(
            values=vov, t0=np.arange(4.0), t0_units="ns", dt=16.0, dt_units="ns")})

    config = {"outputs": ["wv2"],
              "processors": {"wv2": "wf_vov(shape=32, vector_len=len(wf_vov))*1"}}
    got, want = _both(table, config)
    gv, wv = got["wv2"], want["wv2"]
    gv = gv.values if hasattr(gv, "values") else gv
    wv = wv.values if hasattr(wv, "values") else wv
    for i in range(4):
        np.testing.assert_array_equal(gv[i], rows[i])
    _vov_equal(gv, wv, "wv2")


def test_variable_length_outputs_match_jax():
    """``get_multi_local_extrema``'s slots as a VoV whose length is its
    count output (``tests/test_coordinate_grids.py::
    test_variable_length_chain_output``)."""
    rng = np.random.default_rng(42)
    wf = rng.normal(0, 0.2, (6, 256)).astype("float32")
    for ev in range(6):
        for p in (40, 120, 200)[: ev % 3 + 1]:
            t = np.arange(256) - p
            wf[ev] += np.where(t >= 0, 30.0 * np.exp(-np.abs(t) / 5.0), 0.0)

    def table(m):
        return m.Table({"waveform": m.WaveformTable(values=wf, dt=16, dt_units="ns")})

    config = {
        "outputs": ["vt_max_out", "n_max_out"],
        "processors": {
            "vt_max_out, vt_min_out, n_max_out, n_min_out": {
                "function": "get_multi_local_extrema",
                "module": "dspeed_tpu.processors",
                "args": ["waveform", 5, 5, 0, 10, 0,
                         "vt_max_out(10, vector_len=n_max_out)", "vt_min_out(10)",
                         "n_max_out", "n_min_out"],
                "unit": "ADC",
            }
        },
    }
    got, want = _both(table, config)
    _vov_equal(got["vt_max_out"], want["vt_max_out"], "vt_max_out")
    lens = [len(got["vt_max_out"][i]) for i in range(6)]
    assert lens == [int(x) for x in got["n_max_out"].nda]
    assert max(lens) >= 1


def test_vov_without_a_length_takes_twice_the_first_chunk(caplog):
    """An input VoV variable of no known length: the manager pads its rows
    to twice the longest row of the first chunk, with a warning, and reads
    what the JAX package's manager reads."""
    import dspeed_tpu.processing_chain as jpc
    from dspeed_tpu import lh5 as jlh5

    import dspeed_tpu_torch.processing_chain as tpc

    rows = _vov_rows(np.random.default_rng(3), 5)
    got = []
    for pc_mod, m, kw in ((tpc, lh5, {"device": "cpu"}), (jpc, jlh5, {})):
        pc = pc_mod.ProcessingChain(buffer_len=5, **kw)
        var = pc.add_variable("vov_in")
        man = pc_mod.LGDOVectorOfVectorsIOManager(
            m.VectorOfVectors(data=rows), var, output=False)
        with caplog.at_level("WARNING"):
            arrs, n = man.read(0, 5)
        assert n == 5 and var.shape == (10,)
        got.append({k.split("#")[0]: np.asarray(v) for k, v in arrs.items()})
    assert any("twice the maximum" in r.getMessage() for r in caplog.records)
    assert got[0].keys() == got[1].keys() == {"vov_in", "len(vov_in)"}
    for k in got[0]:
        assert got[0][k].dtype == got[1][k].dtype, k
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
    np.testing.assert_array_equal(got[0]["len(vov_in)"], [1, 2, 3, 4, 5])


def test_vov_row_longer_than_its_length_raises():
    tb = lh5.Table({"vov_in": lh5.VectorOfVectors(
        data=[np.arange(3.0), np.arange(9.0)])})
    config = {"outputs": ["v2"],
              "processors": {"v2": "vov_in(shape=4, vector_len=len(vov_in))*1"}}
    with pytest.raises(DSPFatal, match="larger than array variable length"):
        dspeed_tpu_torch.build_dsp(tb, dsp_config=config, device="cpu")


def test_float_count_is_a_vector_length():
    """``peak_snr_threshold``'s float count ``no_out`` as the length of
    ``trigger_pos``: truncated to an integer when written, the rows packed
    in order."""
    from dspeed_tpu_torch.processing_chain import (
        LGDOVectorOfVectorsIOManager, ProcessingChain,
    )

    pc = ProcessingChain(device="cpu", buffer_len=3)
    var = pc.add_variable("x", dtype="float32", shape=(4,))
    var.vector_len = pc.add_variable("nx", dtype="float32", shape=())
    out = lh5.VectorOfVectors(shape_guess=(3, 0), dtype="float32")
    man = LGDOVectorOfVectorsIOManager(out, var, output=True)
    key, len_key = man.out_keys()
    padded = np.arange(12, dtype="float32").reshape(3, 4)
    man.write({key: padded, len_key: np.asarray([2.7, 0.0, 4.0], "float32")}, 0, 3)
    np.testing.assert_array_equal(out.cumulative_length.nda[:3], [2, 2, 6])
    np.testing.assert_array_equal(out.flattened_data.nda[:6], [0, 1, 8, 9, 10, 11])


@pytest.fixture(scope="module")
def sipm_raw_file(tmp_path_factory):
    from test_build_dsp import make_sipm_waveforms

    path = str(tmp_path_factory.mktemp("spm") / "spms_raw.lh5")
    wf, n_pulses = make_sipm_waveforms()
    tb = lh5.Table({"waveform": lh5.WaveformTable(
        values=wf, t0=0.0, t0_units="ns", dt=16.0, dt_units="ns")})
    for ch in ("ch0", "ch1", "ch2"):
        lh5.write(tb, f"{ch}/raw", path)
    return path, n_pulses


def test_sipm_channelwise_vov(sipm_raw_file, tmp_path):
    """The SiPM chain file -> file per channel, VoV outputs
    (``tests/test_build_dsp.py::test_sipm_channelwise_vov``), against the
    JAX package's output file."""
    import dspeed_tpu
    from dspeed_tpu import lh5 as jlh5

    path, n_pulses = sipm_raw_file
    chan_config = {f"ch{i}/raw": SIPM for i in range(3)}
    outs = {}
    for name, pkg, kw in (("port", dspeed_tpu_torch, {"device": "cpu"}),
                          ("jax", dspeed_tpu, {})):
        out = str(tmp_path / f"spms_{name}_dsp.lh5")
        pkg.build_dsp(path, out, {}, n_entries=20, lh5_tables=list(chan_config),
                      chan_config=chan_config, write_mode="r", **kw)
        outs[name] = out
    out = outs["port"]
    assert sorted(lh5.ls(out)) == ["ch0", "ch1", "ch2"]
    assert lh5.ls(out, "ch0/") == ["ch0/dsp"]
    for ch in ("ch0", "ch1", "ch2"):
        for col in ("energies", "trigger_pos"):
            got = lh5.read(f"{ch}/dsp/{col}", out)
            want = jlh5.read(f"{ch}/dsp/{col}", outs["jax"])
            assert isinstance(got, lh5.VectorOfVectors) and len(got) == 20
            np.testing.assert_array_equal(got.cumulative_length.nda,
                                          want.cumulative_length.nda)
            if col == "trigger_pos":
                np.testing.assert_array_equal(got.flattened_data.nda,
                                              want.flattened_data.nda)
            else:
                np.testing.assert_allclose(got.flattened_data.nda,
                                           want.flattened_data.nda, rtol=2e-6)
    trig = lh5.read("ch0/dsp/trigger_pos", out)
    found = np.array([len(trig[i]) for i in range(20)])
    assert np.abs(found - n_pulses[:20]).mean() < 1.5


def test_sipm_vov_through_the_production_loop(sipm_raw_file, tmp_path):
    """Chunks of 5 events through build_dsp's production loop (read-ahead,
    staging, fetch and write-behind): the VoV columns, their length
    variables included, equal one chunk of all 24 bit for bit."""
    path, _ = sipm_raw_file
    cols = {}
    for buffer_len in (24, 5):
        out = str(tmp_path / f"spms_{buffer_len}.lh5")
        dspeed_tpu_torch.build_dsp(path, out, SIPM, lh5_tables=["ch1/raw"],
                                   buffer_len=buffer_len, device="cpu",
                                   write_mode="r")
        cols[buffer_len] = {c: lh5.read(f"ch1/dsp/{c}", out)
                            for c in ("energies", "trigger_pos")}
    for c in ("energies", "trigger_pos"):
        _vov_equal(cols[5][c], cols[24][c], c)
        assert len(cols[5][c]) == 24
