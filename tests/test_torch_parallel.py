"""The port's ``parallel`` package on four gloo ranks, mirroring
``tests/test_parallel.py`` (the JAX package on its 8-device CPU mesh).

One four-rank run (``tests/torch_parallel_worker.py``, one process per rank,
a ``FileStore``) does every multi-rank scenario; each test reads its part:
``sp_convolve_same`` for 15, 16 and 33 taps over ``{"sp": 4}`` against
``numpy.convolve(..., "same")`` and the JAX function on its mesh, at the JAX
test's ``atol``; the halo exchange present; a sample-sharded chain over
``{"data": 2, "sp": 2}`` and the long auxiliary input's designation; the
flagship stacked over ``{"channel": 2, "data": 2}``; ``build_dsp_stacked``
over that mesh, and round-robin with more ranks than channels; ``build_dsp``
one channel table a rank. Single-process tests: ``build_dsp_stacked``
against sequential ``build_dsp`` in memory, its chain-cache reuse, and the
F10 rule of its cache key (two databases that differ only inside a large
array).
"""

import copy
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from torch_flagship import flagship_config  # noqa: E402

import dspeed_tpu_torch  # noqa: E402
from dspeed_tpu_torch import lh5  # noqa: E402
from dspeed_tpu_torch.parallel import build_dsp_stacked, bulk  # noqa: E402
from dspeed_tpu_torch.processing_chain import build_processing_chain  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
WORLD = 4
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


CHANS = [f"ch{c}/raw" for c in range(4)]
OUTS = ["trapEmax", "tp_50"]


def _bdsp():
    return sys.modules[_port_build_dsp().__module__]


@pytest.fixture(autouse=True)
def fresh_chain_cache():
    _bdsp()._CHAIN_CACHE.clear()
    yield
    _bdsp()._CHAIN_CACHE.clear()


def _hpge(n, seed):
    wf, amp, t0, bl, _ = cs.make_hpge_waveforms(n, seed=seed)
    return wf, bl.astype("float32")


def _table(wf, bl=None):
    tb = lh5.Table({"waveform": lh5.WaveformTable(
        values=wf, t0=0.0, t0_units="ns", dt=16.0, dt_units="ns")})
    if bl is not None:
        tb.add_field("baseline", lh5.Array(bl))
    return tb


def _write_channels(path, n):
    """Four channel tables of distinct events."""
    for c, tb in enumerate(CHANS):
        wf, bl = _hpge(n, 11 + c)
        lh5.write(_table(wf, bl), tb, path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four-rank run: ``(inputs, [result of each rank], workdir)``."""
    work = str(tmp_path_factory.mktemp("par"))
    rng = np.random.default_rng(42)
    raw = os.path.join(work, "multi_raw.lh5")
    _write_channels(raw, 24)
    seq_wf = rng.normal(0, 1, (6, 512)).astype("float32")
    seq_wf[1] = np.nan
    inp = {
        "sp_w": rng.normal(0, 1, (4, 1024)).astype("float32"),
        "taps": {m: rng.normal(0, 1, m).astype("float32") for m in (15, 16, 33)},
        "seq_wf": seq_wf,
        "aux_wf": rng.normal(0, 1, (16, 256)).astype("float32"),
        "aux": rng.normal(0, 1, (16, 1024)).astype("float32"),
        "stack": [_hpge(14, 21 + c) for c in range(2)],
        "raw": raw,
        "chans": CHANS,
    }
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    store = os.path.join(work, "store")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(WORLD), store, work],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    try:
        errs = [p.communicate(timeout=400)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * WORLD, "\n".join(
        e[-3000:] for e in errs)
    res = []
    for r in range(WORLD):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return inp, res, work


# ---------------------------------------------------------------------------
# sp_convolve_same


@pytest.mark.parametrize("m", [15, 16, 33])
def test_sp_convolve_matches_numpy_same(ranks, m):
    """Every rank holds the whole result: ``numpy.convolve(row, taps,
    "same")`` and the JAX package's ``sp_convolve_same`` on its mesh of
    8 ``sp`` shards, at the JAX test's ``atol``."""
    import jax

    from dspeed_tpu.parallel import make_mesh as jax_mesh
    from dspeed_tpu.parallel import sp_convolve_same as jax_sp

    inp, res, _ = ranks
    w, taps = inp["sp_w"], inp["taps"][m]
    exp = np.stack([np.convolve(x, taps, "same") for x in w])
    atol = 2e-5 * np.abs(exp).max()
    for r in res:
        got = r[f"sp_conv_{m}"]
        assert got.shape == w.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, exp, atol=atol)
        np.testing.assert_array_equal(got, res[0][f"sp_conv_{m}"])
    if len(jax.devices()) >= 8:
        jgot = np.asarray(jax_sp(w, taps, jax_mesh({"sp": 8})))
        np.testing.assert_allclose(res[0][f"sp_conv_{m}"], jgot, atol=atol)


def test_sp_convolve_exchanges_halos(ranks):
    """Each call swaps its halos in one ``batch_isend_irecv``; a short
    kernel on short rows keeps the shape; the JAX package's ``ValueError``
    cases raise (rows that do not divide, a halo longer than a block)."""
    inp, res, _ = ranks
    for r in res:
        assert r["sp_hops"] == 3
        assert r["sp_small"].shape == (2, 512)
        exp = np.stack([np.convolve(x, inp["taps"][15][:9], "same")
                        for x in inp["sp_w"][:2, :512]])
        np.testing.assert_allclose(r["sp_small"], exp, atol=2e-5 * np.abs(exp).max())
        assert r["sp_errors"] == ["sample axis 1022 must divide into 4 shards",
                                  "kernel halo larger than one shard"]


# ---------------------------------------------------------------------------
# chains


def test_sharded_sample_axis_matches_single_device(ranks):
    """``fft_convolve_wf`` and ``convolve_wf`` take the halo route on a chain
    over ``{"data": 2, "sp": 2}``; the outputs equal the unsharded port's
    bit for bit on every rank (a NaN row included) and the JAX package's
    chain at its test's tolerance."""
    from dspeed_tpu import lh5 as jlh5
    from dspeed_tpu.processing_chain import build_processing_chain as jax_build

    from torch_parallel_worker import conv_chain_config

    inp, res, _ = ranks
    wf = inp["seq_wf"]
    chain, _, _ = build_processing_chain(conv_chain_config(), _table(wf), device="cpu")
    ref = {k: np.array(v.nda) for k, v in chain(_table(wf)).items()}
    jc, _, jout = jax_build(conv_chain_config(), jlh5.Table({"waveform": jlh5.WaveformTable(
        values=wf, t0=0.0, t0_units="ns", dt=16.0, dt_units="ns")}))
    jc(jlh5.Table({"waveform": jlh5.WaveformTable(
        values=wf, t0=0.0, t0_units="ns", dt=16.0, dt_units="ns")}), jout)
    for r in res:
        assert r["seq_halo_routes"] == 2
        for k, v in ref.items():
            assert r["seq_chain"][k].tobytes() == v.tobytes(), k
            j = np.asarray(jout[k].nda)
            np.testing.assert_allclose(r["seq_chain"][k], j, rtol=1e-5,
                                       atol=2e-6 * np.nanmax(np.abs(j)),
                                       equal_nan=True, err_msg=k)
    assert np.isnan(ref["wf_smooth"][1]).all()


def test_long_aux_input_not_sample_sharded(ranks):
    """An auxiliary input longer than the waveform keeps its samples whole
    (the waveform length comes from the gridded inputs); the outputs equal
    the unsharded port's."""
    from torch_parallel_worker import long_aux_config

    inp, res, _ = ranks
    tb = _table(inp["aux_wf"])
    tb.add_field("longaux", lh5.ArrayOfEqualSizedArrays(nda=inp["aux"]))
    chain, _, _ = build_processing_chain(long_aux_config(), tb, device="cpu")
    ref = {k: np.array(v.nda) for k, v in chain(tb).items()}
    for r in res:
        assert r["aux_split"] == ["waveform"]
        assert r["aux_shapes"]["longaux"] == (8, 1024)
        assert r["aux_shapes"]["waveform"] == (8, 128)
        for k, v in ref.items():
            assert r["aux_chain"][k].tobytes() == v.tobytes(), k


def test_channel_data_mesh_matches_single_device(ranks):
    """The flagship stacked over ``{"channel": 2, "data": 2}`` (14 events a
    channel, padded to 14 on 2 data ranks): every rank gets both channels,
    each equal bit for bit to the unsharded port's chain on that channel,
    and within the flagship's column rule of the JAX package's."""
    import dspeed_tpu

    from torch_flagship import assert_timing_columns

    inp, res, _ = ranks
    cfg = flagship_config()
    for ci, (wf, bl) in enumerate(inp["stack"]):
        out = _port_build_dsp()(_table(wf, bl), dsp_config=cfg, database=TAU,
                                         device="cpu")
        ref = {k: np.asarray(out[k].nda) for k in cfg["outputs"]}
        jtb = dspeed_tpu.lh5.Table({
            "waveform": dspeed_tpu.lh5.WaveformTable(values=wf, t0=0.0, t0_units="ns",
                                                     dt=16.0, dt_units="ns"),
            "baseline": dspeed_tpu.lh5.Array(bl)})
        jout = _jax_build_dsp()(jtb, dsp_config=cfg, database=TAU)
        for r in res:
            assert r["stack_lead"] == (2, 14)
            got = {k: np.asarray(r["stack"][ci][k]) for k in cfg["outputs"]}
            for k in cfg["outputs"]:
                assert got[k].tobytes() == ref[k].tobytes(), (ci, k)
        assert_timing_columns(got, {k: np.asarray(jout[k].nda) for k in cfg["outputs"]})


# ---------------------------------------------------------------------------
# stacked production


def _sequential(path, chans, outputs=None):
    cfg = flagship_config()
    out = _port_build_dsp()(
        path, None, cfg, lh5_tables=chans, database={c.split("/")[0]: TAU for c in chans},
        outputs=outputs, device="cpu", buffer_len=16)
    keys = outputs or cfg["outputs"]
    return {c.split("/")[0]: {k: np.asarray(out[c.split("/")[0]]["dsp"][k].nda)
                              for k in keys} for c in chans}


def _assert_bits(got, want):
    assert set(got) == set(want)
    for k in want:
        assert np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes(), k


def test_stacked_mesh_matches_sequential(ranks):
    """``build_dsp_stacked`` over the mesh (rank 0 writes) equals four
    sequential ``build_dsp`` calls bit for bit, every column."""
    inp, _, work = ranks
    seq = _sequential(inp["raw"], CHANS)
    path = os.path.join(work, "multi_mesh_dsp.lh5")
    assert not os.path.exists(os.path.join(work, "multi_mesh_dsp.p1.lh5"))
    for ch, want in seq.items():
        got = lh5.read(f"{ch}/dsp", path)
        _assert_bits({k: got[k].nda for k in want}, want)


def test_stacked_more_ranks_than_channels(ranks):
    """Without a mesh, ranks take channels round-robin: three channels on
    four ranks, the fourth rank returns an empty ``Struct`` and writes no
    file; the others' columns equal the sequential run's."""
    inp, res, work = ranks
    seq = _sequential(inp["raw"], CHANS[:3], OUTS)
    assert [sorted(r["rr_struct"]) for r in res] == [["ch0"], ["ch1"], ["ch2"], []]
    assert [r["rr_file"] for r in res] == [True, True, True, False]
    for r in res[:3]:
        (ch, cols), = r["rr_struct"].items()
        _assert_bits(cols, seq[ch])
        rank = int(ch[2:])
        got = lh5.read(f"{ch}/dsp", os.path.join(work, f"multi_rr_dsp.p{rank}.lh5"))
        _assert_bits({k: got[k].nda for k in OUTS}, seq[ch])


def test_build_dsp_channel_round_robin(ranks):
    """``build_dsp`` on four ranks: one channel table a rank, each in its
    own ``.p<rank>`` file, equal to the one-process run."""
    inp, _, work = ranks
    seq = _sequential(inp["raw"], CHANS, ["trapEmax"])
    for rank, ch in enumerate(CHANS):
        f = os.path.join(work, f"multi_bd_dsp.p{rank}.lh5")
        assert lh5.ls(f, "*") == [ch.split("/")[0]]
        got = lh5.read(f"{ch.split('/')[0]}/dsp", f)
        _assert_bits({"trapEmax": got["trapEmax"].nda}, seq[ch.split("/")[0]])


def test_stacked_in_memory_matches_sequential(tmp_path):
    """``build_dsp_stacked`` in one process, ``dsp_out=None``: a ``Struct``
    per channel, every column equal to sequential ``build_dsp`` bit for bit
    (chunks of 16 over 24 events: a short last chunk)."""
    path = str(tmp_path / "mem_raw.lh5")
    _write_channels(path, 24)
    st = build_dsp_stacked(path, None, flagship_config(), CHANS[:2], database=TAU,
                           buffer_len=16, device="cpu")
    seq = _sequential(path, CHANS[:2])
    for ch, want in seq.items():
        _assert_bits({k: st[ch]["dsp"][k].nda for k in want}, want)


def test_stacked_reuses_cached_chain(tmp_path):
    """A second stacked call takes the chain from ``build_dsp``'s cache (no
    build) and gives the same columns."""
    path = str(tmp_path / "cache_raw.lh5")
    _write_channels(path, 8)
    kw = dict(database=TAU, outputs=["trapEmax"], device="cpu")
    st1 = build_dsp_stacked(path, None, flagship_config(), CHANS[:2], **kw)
    key = next(k for k in _bdsp()._CHAIN_CACHE if k[0] == "stacked")
    chain = _bdsp()._CHAIN_CACHE[key][0]
    built = []
    import dspeed_tpu_torch.processing_chain as pc

    real = pc.build_processing_chain
    pc.build_processing_chain = lambda *a, **k: built.append(1) or real(*a, **k)
    try:
        st2 = build_dsp_stacked(path, None, flagship_config(), CHANS[:2], **kw)
    finally:
        pc.build_processing_chain = real
    assert built == []
    assert _bdsp()._CHAIN_CACHE[key][0] is chain
    np.testing.assert_array_equal(st1["ch0"]["dsp"]["trapEmax"].nda,
                                  st2["ch0"]["dsp"]["trapEmax"].nda)


def test_stacked_cache_key_f10_rule():
    """Two databases that differ only inside a large array get different
    stacked cache keys in the port (an array is keyed by its bytes), and
    the same key in the JAX package (its ``str()`` elides the middle of the
    array: the flaw ROADMAP.md lists as in the reference, not the port)."""
    from dspeed_tpu.parallel.bulk import _stacked_cache_key as jax_key

    _jax_build_dsp()  # load its module through the package (jax_key imports it)
    wf, bl = _hpge(4, 11)
    tb = _table(wf, bl)
    a = np.zeros(4096)
    b = a.copy()
    b[2048] = 1.0
    cfg = flagship_config()
    key = [bulk._stacked_cache_key(cfg, {"w": x, **TAU}, None, tb, "cpu", True, None)
           for x in (a, b)]
    assert key[0] != key[1]
    jk = [jax_key(cfg, {"w": x, **TAU}, None, tb) for x in (a, b)]
    assert jk[0] == jk[1]


def test_stacked_one_dispatch_per_chunk(tmp_path):
    """The chunk step on in-memory tables: one dispatch a stacked chunk of
    ``C * B`` rows, each channel's columns equal to its own ``build_dsp``."""
    chain_tabs = [_table(*_hpge(10, 31 + c)) for c in range(3)]
    chain, _, tb_out = bulk.stacked_chain(flagship_config(), chain_tabs[0],
                                          database=TAU, device="cpu")
    rows = []
    orig = chain.dispatch

    def dispatch(staged):
        rows.append(next(v.shape[0] for k, v in staged[0].items()
                         if k.startswith("waveform#")))
        return orig(staged)

    chain.dispatch = dispatch
    try:
        pending, n = bulk.stacked_dispatch(chain, chain_tabs, 10)
    finally:
        del chain.dispatch
    assert rows == [30] and n == 10
    tb_outs = [copy.deepcopy(tb_out) for _ in chain_tabs]
    bulk.write_channels(chain, bulk.stacked_results(chain, pending), tb_outs, n)
    cfg = flagship_config()
    for tb, got in zip(chain_tabs, tb_outs):
        out = _port_build_dsp()(tb, dsp_config=cfg, database=TAU, device="cpu")
        _assert_bits({k: got[k].nda[:n] for k in cfg["outputs"]},
                     {k: out[k].nda for k in cfg["outputs"]})


# ---------------------------------------------------------------------------
# on the card


@pytest.mark.gpu
def test_stacked_chunk_on_the_card():
    """The chunk step on the card: the stack written straight into pinned
    memory (``ProcessingChain.stage_stacked``), each channel equal bit for
    bit to its own ``build_dsp`` on the card, and the pinned stack's copy
    safe to reuse (three chunks back to back)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = flagship_config()
    for rnd in range(3):
        tabs = [_table(*_hpge(37, 41 + 3 * rnd + c)) for c in range(3)]
        chain, _, tb_out = bulk.stacked_chain(cfg, tabs[0], database=TAU, device="cuda")
        pending, n = bulk.stacked_dispatch(chain, tabs, 37)
        tb_outs = [copy.deepcopy(tb_out) for _ in tabs]
        bulk.write_channels(chain, bulk.stacked_results(chain, pending), tb_outs, n)
        for tb, got in zip(tabs, tb_outs):
            out = _port_build_dsp()(tb, dsp_config=cfg, database=TAU,
                                             device="cuda")
            _assert_bits({k: got[k].nda[:n] for k in cfg["outputs"]},
                         {k: out[k].nda for k in cfg["outputs"]})
