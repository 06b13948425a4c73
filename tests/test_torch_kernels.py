"""The port's two CUDA kernels, through their plain PyTorch versions on the
CPU, against the JAX package's Pallas kernels run in interpret mode (as
``tests/processors/test_pallas.py`` runs them).

- K1 ``fused_energy`` (``dspeed_tpu_torch/csrc/fused_energy.cu``);
- K4 ``banded_conv_multi`` (``dspeed_tpu_torch/csrc/banded_conv.cu``).

Float outputs agree within 1e-5 of their column's scale (max |jax|), index
outputs exactly, NaN positions identically. Crossing-mask bits agree exactly
wherever the trapezoid sits more than 1e-5 of its scale from the threshold.

The tests marked ``gpu`` hold each CUDA kernel against its plain version on
the card; without one they skip. The JAX package is imported inside the CPU
tests only, so that on a machine with a card and no JAX the file still
collects:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from dspeed_tpu_torch.processors import _cuda

TAU = 27460.5
REL = 1e-5


def _hpge(n_ev=16, n=1024, seed=11):
    """Synthetic HPGe pulses (baseline, linear rise at ``t0``, exponential
    decay), with a NaN sample in row 3 and a NaN baseline in row 5."""
    rng = np.random.default_rng(seed)
    amp = rng.uniform(500, 30000, n_ev)
    t0 = rng.integers(n // 4, n // 4 + 100, n_ev)
    rt = rng.integers(40, 150, n_ev)
    bl = rng.uniform(14000, 16000, n_ev)
    t = np.arange(n)[None, :]
    rise = np.clip((t - t0[:, None]) / rt[:, None], 0, 1)
    decay = np.where(
        t > t0[:, None] + rt[:, None],
        np.exp(-(t - t0[:, None] - rt[:, None]) / TAU),
        1.0,
    )
    wf = bl[:, None] + amp[:, None] * rise * decay + rng.normal(0, 3, (n_ev, n))
    wf[3, 300] = np.nan
    bl[5] = np.nan
    return wf.astype("float32"), bl.astype("float32")


def _flat(outs):
    pz, traps, emaxes, *rest = outs
    return [pz, *traps, *emaxes, *rest]


def _compare(got, want, exact=False, what=""):
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, what
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{what}: NaN positions")
    ok = ~np.isnan(w)
    if exact:
        np.testing.assert_array_equal(g[ok], w[ok], err_msg=what)
        return
    scale = np.abs(w[ok]).max() if ok.any() else 0.0
    err = np.abs(g[ok] - w[ok]).max() if ok.any() else 0.0
    assert err <= REL * scale, f"{what}: {err:.3e} > {REL:g} * {scale:.3e}"


K1_CASES = {
    # the flagship energy front's spec set, on a 1024-sample row
    "flagship": dict(
        trap_specs=(("norm", 156, 47),), emax_for=(0,), emit_blsub=True,
        emit_minmax=True, slope_specs=((0, 0, 188), (1, 375, 1024)),
    ),
    # norm + asym + a <= 32-sample norm window; two maxima
    "multi_trap": dict(
        trap_specs=(("norm", 64, 16), ("asym", 8, 4, 60), ("norm", 8, 2)),
        emax_for=(0, 2),
    ),
    # the timing slice's absorbed crossing mask: asym trap vs bl_std
    "mask": dict(
        trap_specs=(("norm", 64, 16), ("asym", 8, 4, 60)), emax_for=(0, 1),
        slope_specs=((0, 0, 256), (1, 600, 1024)),
        mask_specs=((("asym", 8, 4, 60), 0, 1, True, True),),
    ),
}


def _jax_slopes(wf, bl, slope_specs):
    """The slope-fit quadruples from the JAX package's unfused bodies (x64),
    the oracle of its own slope-spec contract test. The Pallas kernel sums
    these in float32 and drifts by more than 1e-5 of the column scale on a
    near-zero pz slope, so the port's slope columns are held to this."""
    import dspeed_tpu.processors as jp

    (ws,) = jp.bl_subtract(wf, bl)
    (pz,) = jp.pole_zero(np.asarray(ws), TAU)
    src = (np.asarray(ws), np.asarray(pz))
    return [
        np.asarray(o)
        for s, a0, b0 in slope_specs
        for o in jp.linear_slope_fit(src[s][:, a0:b0])
    ]


def _check_k1(got, want, kw, what):
    """Hold the flattened outputs of K1 (numpy) against a reference."""
    assert len(got) == len(want)
    nm = len(kw.get("mask_specs", ()))
    ntr = len(kw["trap_specs"])
    s0 = 1 + ntr + len(kw["emax_for"])
    n_float = len(got) - nm
    idx = set()
    if kw.get("emit_minmax"):
        pos = s0 + 4 * len(kw.get("slope_specs", ()))
        idx = {pos, pos + 1}  # t_min, t_max
    for i in range(n_float):
        _compare(got[i], want[i], exact=i in idx, what=f"{what} output {i}")
    for q, (sp, si, oi, _ff, _bb) in enumerate(kw.get("mask_specs", ())):
        g, w = got[n_float + q], want[n_float + q]
        assert g.dtype == np.uint8 and w.dtype == np.uint8
        trap = got[1 + list(kw["trap_specs"]).index(sp)].astype(np.float64)
        thr = got[s0 + 4 * si + oi].astype(np.float64)
        tol = REL * np.nanmax(np.abs(trap))
        near = np.abs(trap - thr[:, None]) <= tol
        near = near | np.roll(near, 1, 1) | np.roll(near, -1, 1)
        near |= np.isnan(trap)
        assert (g[~near] == w[~near]).all(), f"{what} mask {q}"
        assert (g[np.isnan(trap).any(1)] == 0).all()
        assert g.any(), "the mask case must hold crossings"


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_fused_energy_plain_matches_pallas_interpret(case):
    from dspeed_tpu.processors import _pallas

    kw = K1_CASES[case]
    wf, bl = _hpge()
    want = [np.asarray(o) for o in _flat(
        _pallas.fused_energy(wf, bl, TAU, interpret=True, **kw)
    )]
    got = [o.numpy() for o in _flat(
        _cuda.fused_energy(torch.from_numpy(wf), torch.from_numpy(bl), TAU, **kw)
    )]
    s0 = 1 + len(kw["trap_specs"]) + len(kw["emax_for"])
    slopes = _jax_slopes(wf, bl, kw.get("slope_specs", ()))
    want[s0 : s0 + len(slopes)] = slopes
    _check_k1(got, want, kw, case)


def test_fused_energy_nan_poisoning_plain():
    """NaN sample or NaN baseline poisons every float plane and scalar of
    the row, except the raw min_max quadruple (waveform NaN only)."""
    wf, bl = _hpge()
    kw = K1_CASES["flagship"]
    outs = _cuda.fused_energy(torch.from_numpy(wf), torch.from_numpy(bl), TAU, **kw)
    flat = _flat(outs)
    mm = flat[1 + 1 + 1 + 8 : 1 + 1 + 1 + 8 + 4]
    for o in flat:
        a = o.numpy()
        assert np.isnan(a[3]).all()
        assert np.isfinite(a[[0, 1, 2, 4, 6, 7]]).all()
    for o in mm:
        assert np.isfinite(o.numpy()[5]).all()
    for o in [flat[0], flat[1], flat[2], flat[-1]]:
        assert np.isnan(o.numpy()[5]).all()


def _k4_inputs(n_ev, n, seed=2):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1, (n_ev, n)).astype("float32")
    w[2, 17] = np.nan
    w[4, :] = np.nan
    return w, rng


K4_CASES = {
    # the timing slice's single-kernel 's' window (t0 filter geometry)
    "s_nk1": dict(n=1024, m=133, mode="s", nk=1, n_in=None),
    # the CUSP/ZAC bank: 'v' window, two kernels
    "v_nk2": dict(n=499, m=400, mode="v", nk=2, n_in=None),
    # the bank reading only the leading n_in samples of a wider row
    "v_nk2_n_in": dict(n=1024, m=400, mode="v", nk=2, n_in=600),
    # a 'f' window reaching past both ends of the row
    "f_nk1": dict(n=256, m=65, mode="f", nk=1, n_in=None),
    "f_nk2": dict(n=256, m=65, mode="f", nk=2, n_in=None),
}


def _window(mode, n, m):
    if mode == "f":
        return 0, n + m - 1
    if mode == "v":
        return min(n, m) - 1, abs(n - m) + 1
    return (min(n, m) - 1) // 2, max(n, m)


@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_banded_conv_plain_matches_pallas_interpret(case):
    from dspeed_tpu.processors import _pallas

    c = K4_CASES[case]
    w, rng = _k4_inputs(12, c["n"])
    n_read = c["n_in"] or c["n"]
    if c["n_in"]:
        w[:, n_read + 3 :] = np.nan  # beyond the read window: never seen
    kerns = [rng.normal(0, 1, c["m"]) for _ in range(c["nk"])]
    lo, p = _window(c["mode"], n_read, c["m"])
    want = _pallas.banded_conv_multi(w, kerns, lo, p, n_in=c["n_in"], interpret=True)
    got = _cuda.banded_conv_multi(torch.from_numpy(w), kerns, lo, p, n_in=c["n_in"])
    assert len(got) == len(want) == c["nk"]
    for j, (g, wv) in enumerate(zip(got, want)):
        _compare(g.numpy(), wv, what=f"{case} kernel {j}")
        rows = np.isnan(g.numpy()).all(1)
        assert rows.tolist() == [i in (2, 4) for i in range(12)]


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
@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_fused_energy_kernel_matches_plain_on_the_card(case, cuda_device):
    kw = K1_CASES[case]
    wf, bl = _hpge(n_ev=256, n=4096)
    w, b = torch.from_numpy(wf).to(cuda_device), torch.from_numpy(bl).to(cuda_device)
    before = _cuda.LAUNCHES["fused_energy"]
    got = _flat(_cuda.fused_energy(w, b, TAU, **kw))
    assert _cuda.LAUNCHES["fused_energy"] == before + 1
    want = _flat(_cuda.fused_energy_plain(w, b, TAU, **kw))
    torch.cuda.synchronize()
    _check_k1([o.cpu().numpy() for o in got], [o.cpu().numpy() for o in want], kw, case)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_banded_conv_kernel_matches_plain_on_the_card(case, cuda_device):
    c = K4_CASES[case]
    w, rng = _k4_inputs(64, c["n"])
    kerns = [rng.normal(0, 1, c["m"]) for _ in range(c["nk"])]
    n_read = c["n_in"] or c["n"]
    lo, p = _window(c["mode"], n_read, c["m"])
    wt = torch.from_numpy(w).to(cuda_device)
    before = _cuda.LAUNCHES["banded_conv_multi"]
    got = _cuda.banded_conv_multi(wt, kerns, lo, p, n_in=c["n_in"])
    assert _cuda.LAUNCHES["banded_conv_multi"] == before + 1
    want = _cuda.banded_conv_plain(wt, kerns, lo, p, n_in=c["n_in"])
    torch.cuda.synchronize()
    for j, (g, wv) in enumerate(zip(got, want)):
        _compare(g.cpu().numpy(), wv.cpu().numpy(), what=f"{case} kernel {j}")


def test_cuda_wrappers_never_fall_back_on_a_cuda_tensor(monkeypatch):
    """A CUDA tensor reaches the kernel's build, never the plain version:
    where the library cannot be built the wrapper raises."""

    class FakeCuda:
        device = torch.device("cuda")
        dtype = torch.float32
        shape = (4, 256)

        def is_contiguous(self):
            return True

    def no_lib(name):
        raise RuntimeError(f"no {name} library")

    monkeypatch.setattr(_cuda, "_lib", no_lib)
    monkeypatch.setattr(_cuda, "fused_energy_plain", None)
    monkeypatch.setattr(_cuda, "banded_conv_plain", None)
    with pytest.raises(RuntimeError, match="no fused_energy library"):
        _cuda.fused_energy(FakeCuda(), np.zeros(4, "float32"), TAU, (("norm", 8, 2),))
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(RuntimeError, match="no banded_conv library"):
        _cuda.banded_conv_multi(FakeCuda(), [np.ones(5)], 4, 256)
    assert _cuda.LAUNCHES == before
