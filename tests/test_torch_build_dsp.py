"""The port's production driver (``dspeed_tpu_torch/build_dsp.py``) and the
engine's staged, split execution (``ProcessingChain.stage_inputs`` /
``dispatch`` / ``fetch`` / ``execute_profiled``), against the JAX package on
the same inputs, mirroring ``tests/test_build_dsp.py`` and
``tests/test_engine_extras.py::test_staged_inputs_match_unstaged``.

Columns are held by ``PERF.md`` §2's rule
(``torch_flagship.assert_timing_columns``): float columns within 1e-5 of
their scale, index columns exactly, except the columns that read an
event's ``tp_0_est`` where it moves by one sample. Within the port, a
chain-cache hit, the staged path and the pipelined loop equal the plain
path bit for bit.

The tests marked ``gpu`` run the pipelined loop, the cache and the
``buffer_len="auto"`` probe on the card; without one they skip.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
from torch_flagship import assert_timing_columns, flagship_config  # noqa: E402

import dspeed_tpu_torch  # noqa: E402
from dspeed_tpu_torch import lh5  # noqa: E402

DB_FLAT = {"pz": {"tau": 27460.5}}
DB = {"geds": DB_FLAT}
N_EVENTS = 60


def make_hpge_waveforms(n, nsamp=4096):
    """``tests/test_build_dsp.py``'s generator (``chip_smoke.py`` holds the
    same, for a machine with neither JAX nor ``h5py``)."""
    wf, amp, t0, bl, _rt = chip_smoke.make_hpge_waveforms(n, nsamp=nsamp)
    return wf, amp, t0, bl


def _driver():
    """The driver module (the package binds the name ``build_dsp`` to the
    function)."""
    from dspeed_tpu_torch import build_dsp

    return sys.modules[build_dsp.__module__]


@pytest.fixture(autouse=True)
def fresh_chain_cache():
    """Each test builds its own chains: one that another test cached (with
    other fusion passes or settings patched in) must not serve it."""
    cache = _driver()._CHAIN_CACHE
    cache.clear()
    yield
    cache.clear()


def _table(pkg_lh5, wf, bl):
    return pkg_lh5.Table({
        "waveform": pkg_lh5.WaveformTable(
            values=wf, t0=0.0, t0_units="ns", dt=16.0, dt_units="ns"
        ),
        "baseline": pkg_lh5.Array(bl),
    })


@pytest.fixture(scope="module")
def raw60(tmp_path_factory):
    """A 60-event flagship raw file (a NaN sample in event 3, a NaN
    baseline in event 5)."""
    wf, amp, _t0, bl = make_hpge_waveforms(n=N_EVENTS)
    bl = bl.astype("float32")
    wf[3, 500] = np.nan
    bl[5] = np.nan
    path = str(tmp_path_factory.mktemp("raw") / "run60_raw.lh5")
    lh5.write(_table(lh5, wf, bl), "geds/raw", path)
    return path, wf, bl


def _read(path, outputs, group="geds/dsp"):
    import h5py

    with h5py.File(path, "r") as f:
        return {k: f[f"{group}/{k}"][()] for k in outputs}


def _cols(st, outputs):
    tb = st["geds"]["dsp"]
    return {k: np.asarray(tb[k].nda) for k in outputs}


def _assert_bits(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k


# ---------------------------------------------------------------------------
# the chunked driver against the JAX package and against one chunk


def test_chunked_file_matches_jax(raw60, tmp_path):
    """60 events at ``buffer_len=16`` (a short last chunk of 12), file to
    file, against the JAX package's ``build_dsp`` on the same file."""
    import dspeed_tpu

    path, _, _ = raw60
    cfg = flagship_config()
    out_t = str(tmp_path / "t_dsp.lh5")
    out_j = str(tmp_path / "j_dsp.lh5")
    dspeed_tpu_torch.build_dsp(path, out_t, cfg, database=DB, buffer_len=16,
                               device="cpu")
    dspeed_tpu.build_dsp(path, out_j, cfg, database=DB, buffer_len=16)
    got, want = _read(out_t, cfg["outputs"]), _read(out_j, cfg["outputs"])
    assert len(got["trapEmax"]) == N_EVENTS
    assert_timing_columns(got, want)
    for k in cfg["outputs"]:
        assert np.isnan(got[k][3]), k


def test_chunked_matches_single_chunk(raw60):
    """Four chunks (the last one short) against one chunk of all 60: within
    the rule, every index column exactly (the CPU's products may sum in
    another order at another chunk length)."""
    path, _, _ = raw60
    cfg = flagship_config()
    small = dspeed_tpu_torch.build_dsp(path, None, cfg, database=DB,
                                       buffer_len=16, device="cpu")
    big = dspeed_tpu_torch.build_dsp(path, None, cfg, database=DB,
                                     buffer_len=64, device="cpu")
    got, want = _cols(small, cfg["outputs"]), _cols(big, cfg["outputs"])
    assert assert_timing_columns(got, want) == 0
    for k in cfg["outputs"]:
        if k.startswith("tp_"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("input_kind", ["iterator", "table"])
def test_input_types_match(raw60, input_kind):
    """``LH5Iterator`` (read ahead and staged on a worker) and ``Table``
    input give the file input's outputs (``test_build_dsp.py``'s
    ``test_input_type_equivalence``)."""
    path, wf, bl = raw60
    cfg = flagship_config()
    ref = _cols(dspeed_tpu_torch.build_dsp(path, None, cfg, database=DB,
                                           buffer_len=16, device="cpu"),
                cfg["outputs"])
    src = (lh5.LH5Iterator(path, "geds/raw", buffer_len=16)
           if input_kind == "iterator" else _table(lh5, wf, bl))
    out = dspeed_tpu_torch.build_dsp(src, None, cfg, database=DB_FLAT,
                                     buffer_len=16, device="cpu")
    got = {k: np.asarray(out[k].nda) for k in cfg["outputs"]}
    if input_kind == "table":  # one chunk of 60
        assert assert_timing_columns(got, ref) == 0
    else:
        _assert_bits(got, ref)


def test_pipelined_loop_equals_synchronous_calls():
    """Five chunks of 12 distinct events through the production loop
    (``_process_chunks`` with read-ahead, as ``chip_smoke.py`` drives it on
    the card): each chunk's outputs equal the synchronous call of the same
    chain on the same chunk bit for bit, and land at the chunk's entry."""
    from dspeed_tpu_torch.processing_chain import build_processing_chain

    wf, _, _, bl, _ = chip_smoke.make_hpge_waveforms(12)
    tables = chip_smoke.distinct_chunks(lh5, wf, bl, 5, offset=5)
    chain, _, tb_out = build_processing_chain(
        flagship_config(), tables[0], db_dict=DB_FLAT, device="cpu")
    got, split, _ = chip_smoke.run_pipeline(dspeed_tpu_torch.build_dsp, chain, tb_out,
                                    tables)
    assert sorted(got) == [12 * k for k in range(5)]
    assert set(split) == {"loading_s", "processing_s", "write_s"}
    for k, tb in enumerate(tables):
        want = chain(tb)
        _assert_bits(got[12 * k], {c: v.nda for c, v in want.items()})


# ---------------------------------------------------------------------------
# the chain cache


def _counting_builds(monkeypatch):
    driver = _driver()
    calls = []
    orig = driver.build_processing_chain

    def build(*a, **k):
        calls.append(k.get("fuse"))
        return orig(*a, **k)

    monkeypatch.setattr(driver, "build_processing_chain", build)
    return calls


def test_cache_hit_equals_miss(raw60, monkeypatch):
    path, _, _ = raw60
    cfg = flagship_config()
    calls = _counting_builds(monkeypatch)
    miss = dspeed_tpu_torch.build_dsp(path, None, cfg, database=DB,
                                      buffer_len=16, device="cpu")
    hit = dspeed_tpu_torch.build_dsp(path, None, cfg, database=DB,
                                     buffer_len=16, device="cpu")
    assert len(calls) == 1
    assert len(_driver()._CHAIN_CACHE) == 1
    _assert_bits(_cols(hit, cfg["outputs"]), _cols(miss, cfg["outputs"]))


def _key(**change):
    cfg = flagship_config()
    wf, _, _, bl = make_hpge_waveforms(n=4, nsamp=512)
    args = dict(processors=cfg["processors"], db_dict=DB_FLAT,
                outputs=cfg["outputs"], tb_in=_table(lh5, wf, bl.astype("f4")),
                device=torch.device("cpu"), fuse=True)
    args.update(change)
    return _driver()._chain_cache_key(**args)


def _other_schema():
    wf, _, _, bl = make_hpge_waveforms(n=4, nsamp=512)
    return _table(lh5, wf.astype("float64"), bl.astype("f4"))


@pytest.mark.parametrize("change", [
    {"device": torch.device("cuda")},
    {"fuse": "generic"},
    {"fuse": False},
    {"outputs": ["trapEmax"]},
    {"db_dict": {"pz": {"tau": 1.0}}},
    {"tb_in": "schema"},
    {"tb_in": "length"},
], ids=["device", "fuse_generic", "fuse_off", "outputs", "database", "schema",
        "chunk_length"])
def test_cache_key_separates(change):
    if change.get("tb_in") == "schema":
        change = {"tb_in": _other_schema()}
    elif change.get("tb_in") == "length":
        wf, _, _, bl = make_hpge_waveforms(n=5, nsamp=512)
        change = {"tb_in": _table(lh5, wf, bl.astype("f4"))}
    base = _key()
    assert base is not None and base == _key()
    assert _key(**change) != base


def test_cache_key_separates_database_arrays_that_differ_inside():
    """Two databases whose weight matrices differ only in the middle (which
    an array's str() elides): two keys; the same arrays again: one key."""
    w = np.zeros((256, 32), np.float32)
    w2 = w.copy()
    w2[128, 16] = 1.0
    assert str(w) == str(w2)
    a = _key(db_dict={"nn": {"w": w}})
    assert a != _key(db_dict={"nn": {"w": w2}})
    assert a == _key(db_dict={"nn": {"w": w.copy()}})


def test_cache_off(raw60, monkeypatch):
    path, _, _ = raw60
    monkeypatch.setenv("DSPEED_TPU_CHAIN_CACHE", "0")
    assert _key() is None
    calls = _counting_builds(monkeypatch)
    cfg = flagship_config(); cfg["outputs"] = ["trapEmax", "bl_mean"]
    for _ in range(2):
        dspeed_tpu_torch.build_dsp(path, None, cfg, database=DB, device="cpu")
    assert len(calls) == 2
    assert not _driver()._CHAIN_CACHE


def test_cache_lru_bound(raw60, monkeypatch):
    path, _, _ = raw60
    driver = _driver()
    monkeypatch.setattr(driver, "_CHAIN_CACHE_MAX", 2)
    calls = _counting_builds(monkeypatch)
    cfg = flagship_config()

    def run(outputs):
        c = dict(cfg, outputs=outputs)
        dspeed_tpu_torch.build_dsp(path, None, c, database=DB, device="cpu")

    run(["trapEmax"])
    run(["bl_mean"])
    run(["trapEmax"])  # a hit, now the most recent
    assert len(calls) == 2
    run(["bl_std"])  # evicts bl_mean, the least recent
    assert len(driver._CHAIN_CACHE) == 2
    run(["trapEmax"])
    assert len(calls) == 3
    run(["bl_mean"])
    assert len(calls) == 4


# ---------------------------------------------------------------------------
# the engine's staged and split execution


STAGED_CONFIG = {
    "outputs": ["trapEmax", "bl_mean"],
    "processors": {
        "wf_blsub": {
            "function": "bl_subtract",
            "module": "dspeed_tpu.processors",
            "args": ["waveform", "baseline", "wf_blsub"],
        },
        "wf_pz": {
            "function": "pole_zero",
            "module": "dspeed_tpu.processors",
            "args": ["wf_blsub", "db.pz.tau", "wf_pz"],
        },
        "wf_trap": {
            "function": "trap_norm",
            "module": "dspeed_tpu.processors",
            "args": ["wf_pz", "625", "188", "wf_trap"],
        },
        "trapEmax": {
            "function": "amax",
            "module": "numpy",
            "args": ["wf_trap", 1, "trapEmax"],
            "kwargs": {"signature": "(n),()->()", "types": ["fi->f"]},
        },
        "bl_mean": {
            "function": "mean",
            "module": "numpy",
            "args": ["waveform[0:512]", 1, "bl_mean"],
            "kwargs": {"signature": "(n),()->()", "types": ["fi->f"]},
        },
    },
}


def _events_table(n=48):
    wf, _, _, bl = make_hpge_waveforms(n=n)
    return _table(lh5, wf, bl.astype("float32"))


def test_staged_inputs_match_unstaged():
    """``stage_inputs`` + ``__call__(staged=...)`` equals the plain path
    bit for bit, and equals the JAX package's staged path within the
    rule."""
    from dspeed_tpu.lh5 import Array, Table, WaveformTable
    from dspeed_tpu.processing_chain import build_processing_chain as jax_build

    from dspeed_tpu_torch.processing_chain import build_processing_chain

    tb = _events_table()
    chain, _, out1 = build_processing_chain(STAGED_CONFIG, tb, db_dict=DB_FLAT,
                                            device="cpu")
    chain(tb, out1)
    chain2, _, out2 = build_processing_chain(STAGED_CONFIG, tb, db_dict=DB_FLAT,
                                             device="cpu")
    staged = chain2.stage_inputs(tb)
    assert staged is not None
    chain2(tb, out2, staged=staged)
    _assert_bits({k: out2[k].nda for k in STAGED_CONFIG["outputs"]},
                 {k: out1[k].nda for k in STAGED_CONFIG["outputs"]})

    jtb = Table({
        "waveform": WaveformTable(values=tb["waveform"].values.nda, t0=0.0,
                                  t0_units="ns", dt=16.0, dt_units="ns"),
        "baseline": Array(tb["baseline"].nda),
    })
    jchain, _, jout = jax_build(STAGED_CONFIG, jtb, db_dict=DB_FLAT)
    jchain(jtb, jout, staged=jchain.stage_inputs(jtb))
    for k in STAGED_CONFIG["outputs"]:
        w = np.asarray(jout[k].nda, np.float64)
        assert np.abs(out2[k].nda - w).max() <= 1e-5 * np.abs(w).max(), k


def test_dispatch_then_fetch_in_turns():
    """Two chunks dispatched before either is fetched: each handle's
    outputs are its own chunk's, equal to the plain path's bit for bit."""
    from dspeed_tpu_torch.processing_chain import build_processing_chain

    tb = _events_table(32)
    tb_a, tb_b = tb[0:16], tb[16:32]
    chain, _, out = build_processing_chain(STAGED_CONFIG, tb_a, db_dict=DB_FLAT,
                                           device="cpu")
    pend_a, n_a = chain.dispatch_chunk(tb_a)
    pend_b, n_b = chain.dispatch_chunk(tb_b)
    assert n_a == n_b == 16
    got = {}
    for name, pend in (("b", pend_b), ("a", pend_a)):
        chain.finish_chunk(pend, 16)
        got[name] = {k: out[k].nda.copy() for k in STAGED_CONFIG["outputs"]}
    for name, sub in (("a", tb_a), ("b", tb_b)):
        want = chain(sub)
        _assert_bits(got[name], {k: want[k].nda for k in STAGED_CONFIG["outputs"]})


def test_execute_profiled_times_every_step():
    from dspeed_tpu_torch.processing_chain import build_processing_chain

    tb = _events_table()
    cfg = flagship_config()
    chain, _, out1 = build_processing_chain(cfg, tb, db_dict=DB_FLAT,
                                            device="cpu")
    chain(tb, out1)
    chain2, _, out2 = build_processing_chain(cfg, tb, db_dict=DB_FLAT,
                                             device="cpu")
    assert set(chain2.get_timing().values()) == {0.0}
    chain2._link_inputs(tb)
    chain2.execute_profiled()
    timing = chain2.get_timing()
    assert set(timing) == {str(s) for s in chain2._steps}
    assert all(t > 0 for t in timing.values())
    _assert_bits({k: out2[k].nda for k in cfg["outputs"]},
                 {k: out1[k].nda for k in cfg["outputs"]})


def test_stats_split(raw60):
    path, _, _ = raw60
    cfg = flagship_config()
    stats = {}
    dspeed_tpu_torch.build_dsp(path, None, cfg, database=DB, buffer_len=16,
                               device="cpu", stats=stats)
    assert set(stats) == {"loading_s", "processing_s", "write_s", "total_s",
                          "rows"}
    assert stats["rows"] == N_EVENTS
    assert all(stats[k] >= 0 for k in stats)
    assert stats["processing_s"] > 0 and stats["total_s"] > 0


def test_debug_timing_dump(raw60, caplog):
    path, _, _ = raw60
    cfg = dict(flagship_config(), outputs=["trapEmax"])
    with caplog.at_level("DEBUG", logger="dspeed_tpu_torch"):
        dspeed_tpu_torch.build_dsp(path, None, cfg, database=DB, device="cpu")
    assert "Processor timing info" in caplog.text


def test_profile_trace(raw60, tmp_path, monkeypatch):
    """``DSPEED_TPU_PROFILE=<dir>`` writes a ``torch.profiler`` trace of
    the chunk loop there."""
    path, _, _ = raw60
    cfg = dict(flagship_config(), outputs=["trapEmax"])
    monkeypatch.setenv("DSPEED_TPU_PROFILE", str(tmp_path / "prof"))
    dspeed_tpu_torch.build_dsp(path, None, cfg, database=DB, device="cpu")
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    with open(tmp_path / "prof" / traces[0]) as f:
        assert json.load(f)["traceEvents"]


def test_buffer_len_auto(raw60):
    """``buffer_len="auto"`` keeps the reference default on the CPU, as the
    JAX package does on its CPU backend; results are those of the default."""
    from dspeed_tpu.build_dsp import _auto_buffer_len as jax_auto

    path, _, _ = raw60
    assert _driver()._auto_buffer_len("cpu") == jax_auto() == 3200
    cfg = flagship_config()
    auto = dspeed_tpu_torch.build_dsp(path, None, cfg, database=DB,
                                      buffer_len="auto", device="cpu")
    ref = dspeed_tpu_torch.build_dsp(path, None, cfg, database=DB, device="cpu")
    _assert_bits(_cols(auto, cfg["outputs"]), _cols(ref, cfg["outputs"]))
    with pytest.raises(ValueError, match="buffer_len"):
        dspeed_tpu_torch.build_dsp(path, None, cfg, database=DB,
                                   buffer_len="fast", device="cpu")


def _write_sequence(pkg, path, out, **kw):
    """The write modes through each package's writer, two chunks of 4 at
    each step: a new file, its refusal, ``'r'``, ``'a'`` (entries 8..16
    appended) and ``'u'`` (a new column written at entries 4..12)."""
    cfg = dict(flagship_config(), outputs=["trapEmax", "bl_mean"])

    def run(c=cfg, **k):
        pkg.build_dsp(path, out, c, database=DB, buffer_len=4, n_entries=8,
                      **kw, **k)

    run()
    with pytest.raises(FileExistsError):
        run()
    run(write_mode="r")
    run(i_start=8, write_mode="a")
    run(dict(cfg, outputs=["trapEmax", "bl_std"]), i_start=4, write_mode="u")
    return _read(out, ["trapEmax", "bl_mean", "bl_std"])


def test_write_modes_through_the_writer(raw60, tmp_path):
    import dspeed_tpu

    path, _, _ = raw60
    got = _write_sequence(dspeed_tpu_torch, path, str(tmp_path / "t.lh5"),
                          device="cpu")
    want = _write_sequence(dspeed_tpu, path, str(tmp_path / "j.lh5"))
    assert {k: len(v) for k, v in got.items()} == {k: len(v) for k, v in want.items()}
    assert {k: len(v) for k, v in got.items()} == {"trapEmax": 16, "bl_mean": 16,
                                                   "bl_std": 12}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 * np.abs(want[k]).max(), err_msg=k)
    full = _cols(dspeed_tpu_torch.build_dsp(
        path, None, dict(flagship_config(), outputs=["trapEmax", "bl_std"]),
        database=DB, device="cpu"), ["trapEmax", "bl_std"])
    np.testing.assert_array_equal(got["trapEmax"], full["trapEmax"][:16])
    np.testing.assert_array_equal(got["bl_std"][4:], full["bl_std"][4:12])


def test_outputs_subset_and_n_entries(raw60):
    path, _, _ = raw60
    st = dspeed_tpu_torch.build_dsp(path, None, flagship_config(), database=DB,
                                    outputs=["trapEmax"], n_entries=10,
                                    buffer_len=4, device="cpu")
    tb = st["geds"]["dsp"]
    assert list(tb.keys()) == ["trapEmax"]
    assert len(tb) == 10


# ---------------------------------------------------------------------------
# multi-process partitioning

_TABLES = [f"ch{i}/raw" for i in range(5)]
_MASK = (np.arange(50) % 3 != 1)
PARTITION_CASES = {
    "tables": dict(lh5_tables=_TABLES, i_start=0, n_entries=None),
    "one_table": dict(lh5_tables=["geds/raw"], i_start=0, n_entries=None),
    "i_start": dict(lh5_tables=["geds/raw"], i_start=7, n_entries=None),
    "n_entries": dict(lh5_tables=["geds/raw"], i_start=3, n_entries=37),
    "entry_list": dict(lh5_tables=["geds/raw"], i_start=0, n_entries=None,
                       entry_list=[1, 4, 9, 16, 25, 36, 49, 64, 81]),
    "entry_mask": dict(lh5_tables=["geds/raw"], i_start=0, n_entries=None,
                       entry_mask=_MASK),
}


@pytest.mark.parametrize("case", sorted(PARTITION_CASES))
@pytest.mark.parametrize("pc, pi", [(pc, pi) for pc in range(1, 5)
                                    for pi in range(pc)])
def test_host_partition_matches_jax(case, pc, pi):
    from dspeed_tpu.build_dsp import host_partition as jax_partition

    kw = {"entry_list": None, "entry_mask": None, **PARTITION_CASES[case]}
    args = (kw["lh5_tables"], kw["i_start"], kw["n_entries"], kw["entry_list"],
            kw["entry_mask"], lambda tb: 100, pc, pi)
    got = _driver().host_partition(*args)
    want = jax_partition(*args)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("name", ["out.lh5", "dir/run_{process}.lh5", "noext"])
@pytest.mark.parametrize("pi", range(4))
def test_per_host_out_path_matches_jax(name, pi):
    from dspeed_tpu.build_dsp import per_host_out_path as jax_path

    assert _driver().per_host_out_path(name, pi) == jax_path(name, pi)


_RANK = r"""
import sys
from datetime import timedelta
sys.path.insert(0, {repo!r})
import torch.distributed as dist
import yaml
from dspeed_tpu_torch import build_dsp

rank = int(sys.argv[1])
dist.init_process_group("gloo", store=dist.FileStore({store!r}, 2), rank=rank,
                        world_size=2, timeout=timedelta(seconds=120))
cfg = yaml.safe_load(open({config!r}))
build_dsp({raw!r}, {out!r}, cfg, database={db!r}, buffer_len=10, device="cpu")
dist.barrier()
dist.destroy_process_group()
"""


def test_two_gloo_ranks_split_the_file(raw60, tmp_path):
    """Two processes under ``torch.distributed`` (gloo, a ``FileStore``)
    each take half of the one table's entries and write ``.p0`` / ``.p1``;
    together they equal the one-process run (chunks of 10, so every chunk
    has the same length in both runs)."""
    path, _, _ = raw60
    cfg = flagship_config()
    out = str(tmp_path / "dist_dsp.lh5")
    code = _RANK.format(repo=REPO, store=str(tmp_path / "store"),
                        config=os.path.join(REPO, "configs",
                                            "hpge-energy-timing.yaml"),
                        raw=path, out=out, db=DB)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], errs
    parts = [_read(str(tmp_path / f"dist_dsp.p{r}.lh5"), cfg["outputs"])
             for r in range(2)]
    assert [len(p["trapEmax"]) for p in parts] == [30, 30]
    one = _cols(dspeed_tpu_torch.build_dsp(path, None, cfg, database=DB,
                                           buffer_len=10, device="cpu"),
                cfg["outputs"])
    _assert_bits({k: np.concatenate([p[k] for p in parts]) for k in one}, one)


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_pipelined_chunks_equal_synchronous_on_the_card(cuda_device):
    """Eight chunks of 64 distinct events through the production loop
    (read-ahead, pinned staging on the copy stream, write-behind): every
    output of every chunk equals the synchronous call of the same chain on
    the same chunk, bit for bit; a staging buffer refilled too early, or a
    chunk written at another's place, shows here."""
    from dspeed_tpu_torch.processing_chain import build_processing_chain

    wf, _, _, bl, _ = chip_smoke.make_hpge_waveforms(64)
    tables = chip_smoke.distinct_chunks(lh5, wf, bl, 8, offset=7)
    chain, _, tb_out = build_processing_chain(
        flagship_config(), tables[0], db_dict=DB_FLAT, device="cuda")
    got, split, _ = chip_smoke.run_pipeline(dspeed_tpu_torch.build_dsp, chain, tb_out,
                                    tables)
    assert sorted(got) == [64 * k for k in range(8)]
    for k, tb in enumerate(tables):
        want = chain(tb)
        for col, w in want.items():
            g = got[64 * k][col]
            assert g.tobytes() == np.asarray(w.nda).tobytes(), (k, col)


@pytest.mark.gpu
def test_cache_separates_cpu_and_cuda_on_the_card(monkeypatch, cuda_device):
    calls = _counting_builds(monkeypatch)
    wf, _, _, bl = make_hpge_waveforms(n=32)
    tb = _table(lh5, wf, bl.astype("float32"))
    cfg = flagship_config()
    cpu = dspeed_tpu_torch.build_dsp(tb, dsp_config=cfg, database=DB_FLAT,
                                     device="cpu")
    card = dspeed_tpu_torch.build_dsp(tb, dsp_config=cfg, database=DB_FLAT,
                                      device="cuda")
    assert len(calls) == 2
    again = dspeed_tpu_torch.build_dsp(tb, dsp_config=cfg, database=DB_FLAT,
                                       device="cuda")
    assert len(calls) == 2
    _assert_bits({k: again[k].nda for k in cfg["outputs"]},
                 {k: card[k].nda for k in cfg["outputs"]})
    devices = {str(c.device) for c, _, _ in _driver()._CHAIN_CACHE.values()}
    assert devices == {"cpu", "cuda"}
    assert np.isfinite(cpu["trapEmax"].nda).all()


@pytest.mark.gpu
def test_auto_buffer_len_on_the_card(cuda_device):
    rates = {}
    pick = _driver()._auto_buffer_len("cuda", rates=rates)
    assert sorted(rates) == [1024, 2048, 4096, 8192]
    assert all(r > 0 for r in rates.values())
    assert pick in rates and rates[pick] == max(rates.values())
