"""The event source that the window drives ``build_dsp`` with."""

import numpy as np

import run
from bench_helpers import named_cell, small_cell
from source import PoolSource


def test_chunks_entries_and_rows():
    pool = {"waveform": np.arange(100 * 4, dtype=np.float32).reshape(100, 4),
            "baseline": np.arange(100, dtype=np.float32)}
    handed = []
    src = PoolSource(pool, {"waveform": "waveform", "baseline": "array"}, 16.0,
                     offset=7, n_events=50, buffer_len=16,
                     on_handover=lambda: handed.append(1))
    assert len(src) == 50 and src.n_entries == 50
    seen = []
    for tb in src:
        seen.append((src.current_i_entry, len(tb), float(tb["baseline"].nda[0])))
        assert tb["waveform"].values.nda.base is not None  # a view of the pool
    assert seen == [(0, 16, 7.0), (16, 16, 23.0), (32, 16, 39.0), (48, 2, 55.0)]
    assert len(handed) == 4
    first = src.read(0)
    np.testing.assert_array_equal(first["waveform"].values.nda, pool["waveform"][7:23])
    np.testing.assert_array_equal(first["waveform"].dt.nda, 16.0)
    src.reset_field_mask(["waveform"])
    assert src.field_mask == ["waveform"]


def test_a_file_through_the_source_equals_one_call_over_its_table():
    """A 64-event file read in four chunks through the production loop, and
    the same 64 events as one Table in one call: every column equal."""
    from dspeed_tpu_torch import lh5
    from dspeed_tpu_torch.build_dsp import build_dsp

    _, _, c = small_cell("hpge-icpc.stream-16k")
    streamed = c.run_file(3)
    lo = c.offset(3)
    assert lo == 15
    tb = lh5.Table({
        "waveform": lh5.WaveformTable(values=c.pool["waveform"][lo:lo + 64], t0=0.0,
                                      t0_units="ns", dt=16.0, dt_units="ns"),
        "baseline": lh5.Array(c.pool["baseline"][lo:lo + 64]),
    })
    whole = build_dsp(tb, dsp_config=c.cfg["dsp_config"], buffer_len=64, device="cpu")
    names = [k for k, _ in whole.items()]
    assert [k for k, _ in streamed.items()] == names
    assert set(names) == set(c.cfg["dsp_config"]["outputs"])
    for k in names:
        np.testing.assert_array_equal(streamed[k].nda, whole[k].nda, err_msg=k)


def test_pool_is_made_from_the_seed():
    _, _, cfg, _ = named_cell("sipm.stream-16k")
    a = run.make_pool(cfg, 40, 2**31 + 12345, "cpu")
    b = run.make_pool(cfg, 40, 2**31 + 12345, "cpu")
    c = run.make_pool(cfg, 40, 2**31 + 12346, "cpu")
    np.testing.assert_array_equal(a["waveform"], b["waveform"])
    assert not np.array_equal(a["waveform"], c["waveform"])
    assert a["waveform"].dtype == np.float32 and a["waveform"].shape == (40, 1024)
