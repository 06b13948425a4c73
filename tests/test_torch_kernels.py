"""The port's CUDA kernels, through their plain PyTorch versions on the CPU,
against the JAX package's Pallas kernels run in interpret mode (as
``tests/processors/test_pallas.py`` runs them).

- K1 ``fused_energy`` (``dspeed_tpu_torch/csrc/fused_energy.cu``);
- K2 ``cascade_tp`` (``dspeed_tpu_torch/csrc/cascade_tp.cu``);
- K3 ``fused_t0`` (``dspeed_tpu_torch/csrc/fused_t0.cu``);
- K4 ``banded_conv_multi`` (``dspeed_tpu_torch/csrc/banded_conv.cu``);
- K5 and K6, the A/E current front's polyphase and up-domain routes
  (``dspeed_tpu_torch/csrc/fused_current.cu``), with the polyphase plan
  (``dspeed_tpu_torch/processors/_poly_plan.py``) against the JAX package's.

Float outputs agree within 1e-5 of their column's scale (max |jax|), index
outputs exactly, NaN positions identically. Crossing-mask bits agree exactly
wherever the trapezoid sits more than 1e-5 of its scale from the threshold.
The cascade (K2) is bit-identical. K3's index outputs may differ on at most
one near-tie per column, where the two float32 convolutions (or trapezoids)
round differently, as the JAX package's own K3 test allows
(``test_pallas.py:735``). K3's absorbed A/E current equals the Pallas
kernel's bit for bit on every row where ``tp_0`` agrees. The current front's
amplitudes agree within 2e-5 of scale (``test_pallas.py:332-339``) and its
indices exactly, except on a near-tie: a row where the plain curve's value
at the other index lies within that tolerance of its extremum.

The tests marked ``gpu`` hold each CUDA kernel against its plain version on
the card; without one they skip. The JAX package is imported inside the CPU
tests only, so that on a machine with a card and no JAX the file still
collects:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""

import sys

import numpy as np
import pytest
import torch

from dspeed_tpu_torch.processors import _cuda


@pytest.fixture(autouse=True)
def fresh_chain_cache():
    """Each test builds its own chains: one that another test cached (with
    other fusion passes or settings patched in) must not serve it."""
    from dspeed_tpu_torch import build_dsp

    cache = sys.modules[build_dsp.__module__]._CHAIN_CACHE
    cache.clear()
    yield
    cache.clear()


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
    # the flagship bank's geometry: a 4096-sample row read to 1996 samples
    "v_nk2_flagship": dict(n=4096, m=1696, mode="v", nk=2, n_in=1996),
    # banks of three and four kernels
    "v_nk3": dict(n=600, m=200, mode="v", nk=3, n_in=None),
    "v_nk4_n_in": dict(n=700, m=77, mode="v", nk=4, n_in=650),
    # p = 1003 is a multiple of no kernel instance's outputs per thread
    "s_nk2_p1003": dict(n=1003, m=33, mode="s", nk=2, n_in=None),
    # 37 rows: a multiple of no block's rows
    "v_nk2_37_rows": dict(n=499, m=100, mode="v", nk=2, n_in=None, rows=37),
}


def _window(mode, n, m):
    if mode == "f":
        return 0, n + m - 1
    if mode == "v":
        return min(n, m) - 1, abs(n - m) + 1
    return (min(n, m) - 1) // 2, max(n, m)


@pytest.mark.parametrize("case", sorted(K4_CASES))
def _k4_case(case, n_ev):
    """The inputs of a K4 case: rows 2 and 4 hold a NaN; with ``n_in`` every
    row holds NaNs beyond the read window, which must not poison."""
    c = K4_CASES[case]
    w, rng = _k4_inputs(c.get("rows", n_ev), c["n"])
    n_read = c["n_in"] or c["n"]
    if c["n_in"]:
        w[:, n_read + 3 :] = np.nan  # beyond the read window: never seen
        w[6, n_read] = np.nan
    kerns = [rng.normal(0, 1, c["m"]) for _ in range(c["nk"])]
    lo, p = _window(c["mode"], n_read, c["m"])
    return w, kerns, lo, p


def _check_k4_nan_rows(got, n_ev):
    rows = np.isnan(got).all(1)
    assert rows.tolist() == [i in (2, 4) for i in range(n_ev)]
    assert not np.isnan(got[rows == 0]).any()


@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_banded_conv_plain_matches_pallas_interpret(case):
    from dspeed_tpu.processors import _pallas

    c = K4_CASES[case]
    w, kerns, lo, p = _k4_case(case, 12)
    want = _pallas.banded_conv_multi(w, kerns, lo, p, n_in=c["n_in"], interpret=True)
    got = _cuda.banded_conv_multi(torch.from_numpy(w), kerns, lo, p, n_in=c["n_in"])
    assert len(got) == len(want) == c["nk"]
    for j, (g, wv) in enumerate(zip(got, want)):
        _compare(g.numpy(), wv, what=f"{case} kernel {j}")
        _check_k4_nan_rows(g.numpy(), len(w))


CASCADE_CASES = {
    # the JAX package's own cascade contract (test_pallas.py:666-668)
    "ten_links": (
        [1.0, 0.99, 0.95, 0.90, 0.80, 0.50, 0.20, 0.10, 0.01, 0.005],
        [1, 1, -1, -1, -1, -1, -1, -1, -1, -1],
        [-1, -1, 1, 2, 3, 4, 5, 6, 7, 8],
    ),
    # the flagship's tp_100 ... tp_01
    "flagship": (
        [1, 0.99, 0.95, 0.9, 0.8, 0.5, 0.2, 0.1, 0.01],
        [1, 1, 0, 0, 0, 0, 0, 0, 0],
        [-1, -1, 1, 2, 3, 4, 5, 6, 7],
    ),
    # a forward link above every sample walks to n - 2 and finds nothing;
    # on row 15 its crossing is the last position, n - 2
    "fwd_walks_to_end": ([1.0, 1.5, 0.5], [1, 1, 0], [-1, -1, 1]),
    # a backward link from n - 1 walks down to sample 1 (rows 14-17: the
    # crossing at 1, or, on row 17, none: w[0] equals the threshold)
    "bwd_walks_to_one": ([1.0, 0.5], [1, 0], [-1, -1]),
    # rows quantized to an eighth of their maximum: thresholds equal to
    # samples, and plateaus at a threshold
    "exact_ties": ([0.5, 0.25, 0.125], [1, 0, 0], [-1, 0, 1]),
    # a NaN at sample 0 (row 14) and at sample n - 1 (row 15)
    "nan_ends": (
        [1, 0.99, 0.95, 0.9, 0.8, 0.5, 0.2, 0.1, 0.01],
        [1, 1, 0, 0, 0, 0, 0, 0, 0],
        [-1, -1, 1, 2, 3, 4, 5, 6, 7],
    ),
    "one_link": ([0.5], [1], [-1]),
    # rows of noise: many crossings in every 32-sample window, both ways
    "crossings_everywhere": ([0.1, 0.05, 0.02], [1, 0, 1], [-1, 0, 1]),
    # the most links the kernel takes (the Pallas kernel takes 15)
    "sixteen_links": (
        [1, 0.99, 0.95, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3, 0.2, 0.1, 0.05,
         0.02, 0.01, 0.005],
        [1, 1] + [0] * 14,
        [-1, -1] + list(range(1, 15)),
    ),
    # rows of 1001 samples: on the card a row starts off 16 bytes (the
    # Pallas kernel takes n % 128 == 0 only)
    "misaligned_1001": (
        [1, 0.99, 0.95, 0.9, 0.8, 0.5, 0.2, 0.1, 0.01],
        [1, 1, 0, 0, 0, 0, 0, 0, 0],
        [-1, -1, 1, 2, 3, 4, 5, 6, 7],
    ),
}


def _cascade_inputs(case, n_ev=48, seed=4):
    """Rows and bases for a cascade, with the edge rows of the JAX
    package's test: exact ties at the extremum, a NaN sample, a NaN base,
    and NaN, non-integral, negative and out-of-range starts; each case's
    own rows on 14-17."""
    rng = np.random.default_rng(seed)
    if case == "ten_links":
        n = 512
        w = np.abs(np.cumsum(rng.normal(0.05, 1.0, (n_ev, n)), axis=1)).astype(
            "float32"
        ) + 1.0
        t0 = np.full(n_ev, 40.0, "float32")
        base = (np.nanmax(w, axis=1) * 0.97).astype("float32")
    else:
        n = 1001 if case == "misaligned_1001" else 1024
        wf, bl = _hpge(n_ev=n_ev, n=n, seed=seed)
        w = (wf - bl[:, None]).astype("float32")
        w[5] = wf[5] - 15000.0  # the NaN-baseline row keeps a waveform
        if case == "exact_ties":
            q = (np.nanmax(w, 1) / 8).astype("float32")[:, None]
            w = (np.round(w / q) * q).astype("float32")
        # tp_0_est sits on the baseline, just before the rise
        t0 = (np.argmax(w > 0.05 * np.nanmax(w, 1)[:, None], 1) - 3).astype(
            "float32"
        )
        base = np.nanmax(w, axis=1).astype("float32")
        if case == "crossings_everywhere":
            w = rng.normal(0, 1, w.shape).astype("float32")
            base, t0 = np.nanmax(w, axis=1), np.full(n_ev, n // 2, "float32")
    if case == "fwd_walks_to_end":
        w[15, n - 1] = 1.6 * base[15]
    elif case == "bwd_walks_to_one":
        w[14:18, 1:] = np.abs(w[14:18, 1:]) + 1.0
        w[14:18, 0] = -1.0
        w[17, 0] = 0.5
        base[14:18], t0[14:18] = 1.0, n - 1
    elif case == "nan_ends":
        w[14, 0] = w[15, n - 1] = np.nan
    w[2, 300:310] = w[2, 299]  # exact ties
    w[3, 100] = np.nan
    base[5] = np.nan
    t0[7], t0[9], t0[11], t0[13] = t0[7] + 0.5, -3.0, np.nan, n
    return w, base, t0


def _check_cascade_case(case, w, base, got):
    """The case's own rows did what it is for, and its links found
    crossings elsewhere; every edge row is NaN on every link."""
    n = w.shape[1]
    got = [np.asarray(g) for g in got]
    for g in got:
        assert np.isnan(g[[3, 5, 7, 9, 11, 13]]).all()
    assert np.isfinite(got[5] if len(got) > 5 else got[0]).sum() >= 20
    if case == "fwd_walks_to_end":
        assert got[1][15] == n - 2
        assert np.isnan(np.delete(got[1], 15)).all()
    elif case == "bwd_walks_to_one":
        assert (got[1][14:17] == 1).all() and np.isnan(got[1][17])
    elif case == "exact_ties":
        for k, f in enumerate(CASCADE_CASES[case][0]):
            # a sample equals the threshold where a link found its crossing
            rows = np.flatnonzero(np.isfinite(got[k]))
            idx = got[k][rows].astype(int)
            a = np.float32(f) * base[rows]
            assert ((w[rows, idx] == a) | (w[rows, idx - 1] == a)).sum() >= 20
    elif case == "nan_ends":
        assert all(np.isnan(g[[14, 15]]).all() for g in got)
    elif case == "crossings_everywhere":
        # each link found a crossing within a few samples of its start
        ok = np.isfinite(got[2])
        assert ok.sum() >= 30 and (np.abs(got[2] - got[1])[ok] < 32).all()


@pytest.mark.parametrize("case", sorted(CASCADE_CASES))
def test_cascade_plain_bit_identical_to_pallas_and_xla(case):
    import jax.numpy as jnp

    from dspeed_tpu.processors import _pallas
    from dspeed_tpu.processors.tp_chain import chained_time_point_thresh

    factors, dirs, starts = CASCADE_CASES[case]
    w, base, t0 = _cascade_inputs(case)
    pallas = _pallas.cascade_tp(w, base, t0, factors, dirs, starts, interpret=True)
    xla = chained_time_point_thresh(factors, dirs, starts).fn(
        jnp.asarray(w), jnp.asarray(base), jnp.asarray(t0)
    )
    got = _cuda.cascade_tp(
        torch.from_numpy(w), torch.from_numpy(base), torch.from_numpy(t0),
        factors, dirs, starts,
    )
    refs = [(xla, "xla")]
    if pallas is None:  # beyond the Pallas kernel's gates: 15 links, n % 128
        assert len(factors) > 15 or w.shape[1] % 128
    else:
        refs.append((pallas, "pallas"))
    for ref, what in refs:
        assert len(got) == len(ref) == len(factors)
        for k, (g, r) in enumerate(zip(got, ref)):
            g, r = g.numpy(), np.asarray(r)
            same = (g == r) | (np.isnan(g) & np.isnan(r))
            assert same.all(), (case, what, k, np.where(~same)[0][:5])
    _check_cascade_case(case, w, base, got)


T0_CASES = {
    # test_pallas.py:704-735: a 33-tap kernel on random walks
    "walk": dict(atrap_spec=None, need=(True,) * 4),
    "walk_atrap": dict(atrap_spec=("asym", 8, 4, 32), need=(True,) * 4),
    "walk_need_max": dict(atrap_spec=None, need=(False, True, False, True)),
    # a row that is no whole number of the CUDA kernel's output tiles
    "walk_odd_length": dict(atrap_spec=None, need=(True,) * 4),
    # the flagship's 133-tap t0 kernel (rise 8, fall 125) on HPGe pulses
    "flagship": dict(atrap_spec=("asym", 8, 4, 125), need=(True,) * 4),
    # the absorbed A/E current: test_pallas.py:587's window (many rows run
    # past the end), one with a longer difference, and the flagship's
    "walk_curr": dict(atrap_spec=None, need=(True,) * 4, curr_spec=(101, 1, 100)),
    "walk_curr_len3": dict(
        atrap_spec=("asym", 8, 4, 32), need=(False, True, False, True),
        curr_spec=(101, 3, 120),
    ),
    "flagship_curr": dict(
        atrap_spec=None, need=(False, True, False, True), curr_spec=(301, 1, 300)
    ),
    # edge cases of the register-tiled kernel: the flagship's full row with
    # a NaN at its first and at its last sample (two rows)
    "flagship_4096_nan_ends": dict(
        atrap_spec=("asym", 8, 4, 125), need=(True,) * 4, curr_spec=(301, 1, 300)
    ),
    # whole 32-tap chunks only, a partial chunk only, a single tap
    "walk_m64": dict(atrap_spec=None, need=(True,) * 4),
    "walk_m7": dict(atrap_spec=None, need=(True,) * 4, curr_spec=(101, 1, 100)),
    "walk_m1": dict(atrap_spec=("asym", 8, 4, 32), need=(True,) * 4),
    # a falling walk: the maximum within the first samples, nothing found
    "walk_falling": dict(atrap_spec=None, need=(True,) * 4),
    # a constant row under a 33-tap box: a plateau of exact ties
    "box_plateau": dict(atrap_spec=("asym", 8, 4, 32), need=(True,) * 4),
    # a row longer than one tile of outputs
    "walk_n5000": dict(atrap_spec=None, need=(True,) * 4, curr_spec=(101, 1, 100)),
}

# box_plateau's thresholds, cycled over its rows: the filtered row rises
# from 12.75 by 0.75 a sample to its plateau of 24.75 at sample 16, so these
# cross at samples 9, 10, 16 (t_max itself) and 1, and never
PLATEAU_THRESHOLDS = (19.5, 20.0, 24.75, 13.0, 12.75, 30.0)
PLATEAU_TP0 = (9.0, 10.0, 16.0, 1.0, np.nan, np.nan)


def _t0_inputs(case, n_ev=12, seed=3):
    rng = np.random.default_rng(seed)
    if case.startswith("flagship"):
        import dspeed_tpu_torch.processors as tp

        n = 4096 if case == "flagship_4096_nan_ends" else 1024
        wf, bl = _hpge(n_ev=n_ev, n=n, seed=seed)
        bl[5] = 15000.0
        (pz,) = tp.pole_zero(torch.from_numpy(wf - bl[:, None]), TAU)
        w = pz.numpy().astype(np.float32)
        kern = np.asarray(tp.t0_filter(8.0, 125.0, dims={"n": 133})[0])
        std = rng.uniform(2.0, 4.0, n_ev).astype("float32")
        if case == "flagship_4096_nan_ends":
            w[1, 0] = np.nan
            w[4, 4095] = np.nan
    elif case == "box_plateau":
        w = np.full((n_ev, 512), 3.0, np.float32)
        w[9, 200] = np.nan
        kern = np.full(33, 0.25)
        std = np.resize(np.float32(PLATEAU_THRESHOLDS), n_ev)
    elif case in ("walk_m64", "walk_m7", "walk_m1", "walk_falling", "walk_n5000"):
        n = 5000 if case == "walk_n5000" else 512
        drift, start = (-1.0, 1000.0) if case == "walk_falling" else (0.2, 0.0)
        w = start + np.cumsum(rng.normal(drift, 1.0, (n_ev, n)), axis=1)
        w = w.astype("float32")
        w[9, :] = np.nan
        if case == "walk_falling":  # a 7-tap triangle
            kern = np.minimum(np.arange(1, 8), np.arange(7, 0, -1)) / 16.0
        elif case == "walk_n5000":  # positive taps: t_max inside the row
            kern = np.abs(rng.normal(0, 1, 33))
            kern /= kern.sum()
        else:
            m = {"walk_m64": 64, "walk_m7": 7, "walk_m1": 1}.get(case, 33)
            kern = rng.normal(0, 1, m)
            kern *= np.sign(kern.sum()) / np.abs(kern).sum()
        std = rng.uniform(0.5, 2.0, n_ev).astype("float32")
    else:
        n = 777 if case == "walk_odd_length" else 512
        w = np.cumsum(rng.normal(0.2, 1.0, (n_ev, n)), axis=1).astype("float32")
        w[9, :] = np.nan
        kern = rng.normal(0, 1, 33)
        kern /= np.abs(kern).sum()
        std = rng.uniform(0.5, 2.0, n_ev).astype("float32")
    std[6] = np.nan  # a NaN threshold: the searches find nothing
    return w, kern, std


def _check_nan_ends(w, got):
    t_max, tp0 = got[1], got[4]
    assert np.isnan(t_max[[1, 3, 4]]).all() and np.isnan(tp0[[1, 3, 4, 6]]).all()
    assert np.isfinite(np.delete(tp0, [1, 3, 4, 6])).sum() >= 6


def _check_falling(w, got):
    t_max, tp0 = got[1], got[4]
    assert np.isnan(tp0).all()
    assert (np.delete(t_max, 9) <= 5).all() and np.isnan(t_max[9])


def _check_plateau(w, got):
    t_min, t_max, a_min, a_max, tp0 = got[:5]
    rows = np.delete(np.arange(len(w)), 9)
    assert (t_min[rows] == 0).all() and (t_max[rows] == 16).all()
    assert (a_min[rows] == 12.75).all() and (a_max[rows] == 24.75).all()
    want = np.resize(np.float32(PLATEAU_TP0), len(w))
    want[[6, 9]] = np.nan
    np.testing.assert_array_equal(tp0, want)


# the CPU test's checks of what an edge case must find, beside the
# comparison with the Pallas kernel
T0_EDGE_CHECKS = {
    "flagship_4096_nan_ends": _check_nan_ends,
    "walk_falling": _check_falling,
    "box_plateau": _check_plateau,
}


def _split_curr(outs, kw):
    """K3's outputs without the current plane, and the plane (or None)."""
    outs = list(outs)
    if kw.get("curr_spec") is None:
        return outs, None
    return outs[:5] + outs[6:], outs[5]


def _check_curr(got, want, tp0_got, tp0_want, what):
    """The current plane: bit for bit, NaN included, on every row where
    tp_0 agrees; returns the number of rows with a finite current."""
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, what
    rows = (tp0_got == tp0_want) | (np.isnan(tp0_got) & np.isnan(tp0_want))
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    assert same[rows].all(), (what, np.argwhere(~same[rows])[:5])
    return int(np.isfinite(w[rows]).any(axis=1).sum())


def _check_t0(got, want, need, what):
    """K3's rule: floats within REL of scale, indices exact except at most
    one near-tie per column, NaN positions equal off such near-ties."""
    names = ["t_min", "t_max", "a_min", "a_max", "tp_0", "tp_atrap"]
    assert len(got) == len(want)
    for q, (g, w) in enumerate(zip(got, want)):
        if q < 4 and not need[q]:
            continue
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        if q in (2, 3):
            _compare(g, w, what=f"{what} {names[q]}")
            continue
        neq = np.nan_to_num(g, nan=-1) != np.nan_to_num(w, nan=-1)
        assert neq.sum() <= 1, (what, names[q], g[neq], w[neq])


@pytest.mark.parametrize("case", sorted(T0_CASES))
def test_fused_t0_plain_matches_pallas_interpret(case):
    from dspeed_tpu.processors import _pallas

    kw = T0_CASES[case]
    w, kern, std = _t0_inputs(case)
    want = _pallas.fused_t0(w, kern, std, interpret=True, **kw)
    got = _cuda.fused_t0(torch.from_numpy(w), kern, torch.from_numpy(std), **kw)
    n_curr = kw.get("curr_spec") is not None
    assert len(got) == 5 + n_curr + (kw["atrap_spec"] is not None)
    got, g_curr = _split_curr([o.numpy() for o in got], kw)
    want, w_curr = _split_curr([np.asarray(o) for o in want], kw)
    _check_t0(got, want, kw["need"], case)
    tp0 = got[4]
    if case in T0_EDGE_CHECKS:
        T0_EDGE_CHECKS[case](w, got)
    else:
        assert np.isnan(tp0[6]) and np.isfinite(np.delete(tp0, [6, 9])).sum() >= 6
    if n_curr:
        import dspeed_tpu.processors as jp

        win_m, avg_len, n_c = kw["curr_spec"]
        # the JAX package's unfused steps, driven by the Pallas kernel's tp_0
        (wle,) = jp.windower(w, want[4], dims={"m": win_m})
        (steps,) = jp.avg_current(np.asarray(wle), float(avg_len), dims={"m": n_c})
        finite = _check_curr(g_curr, np.asarray(steps), tp0, want[4], case)
        assert finite >= 2, "the case must hold rows whose window fits"
        assert np.isnan(g_curr[np.isnan(tp0)]).all()
        if avg_len == 1:
            _check_curr(g_curr, w_curr, tp0, want[4], case)
        else:
            # the Pallas kernel multiplies by the rounded reciprocal of
            # avg_len: one rounding from its own unfused steps (ROADMAP §3)
            ok = np.isfinite(w_curr)
            np.testing.assert_array_equal(np.isnan(g_curr), np.isnan(w_curr))
            np.testing.assert_allclose(g_curr[ok], w_curr[ok], rtol=2.4e-7, atol=0)


def test_cascade_links_are_checked():
    w = torch.zeros(2, 64)
    with pytest.raises(Exception, match="earlier time point"):
        _cuda.cascade_tp(w, torch.ones(2), torch.zeros(2), [1, 1], [1, 0], [-1, 1])


def test_cascade_wrapper_checks_what_the_kernel_takes(monkeypatch):
    """On a CUDA tensor the wrapper refuses, before any build, more than 16
    links and a row whose warp buffer (n rounded up to 16 bytes) exceeds a
    block's shared memory; a row that fits goes on to the kernel's build."""

    class FakeCuda:
        device = torch.device("cuda")
        dtype = torch.float32

        def __init__(self, n):
            self.shape = (4, n)

        def is_contiguous(self):
            return True

    def no_lib(name):
        raise RuntimeError(f"no {name} library")

    monkeypatch.setattr(_cuda, "_lib", no_lib)
    base, t = np.ones(4, "float32"), np.zeros(4, "float32")
    with pytest.raises(ValueError, match="1 to 16 links"):
        _cuda.cascade_tp(FakeCuda(64), base, t, [1] * 17, [1] * 17, [-1] * 17)
    with pytest.raises(ValueError, match="232464 bytes"):
        _cuda.cascade_tp(FakeCuda(58113), base, t, [1], [1], [-1])
    with pytest.raises(RuntimeError, match="no cascade_tp library"):
        _cuda.cascade_tp(FakeCuda(58112), base, t, [1], [1], [-1])


# ---------------------------------------------------------------------------
# K5 / K6: the A/E current front

# test_pallas.py:290-297, the geometries the polyphase plan accepts
POLY_GEOMETRIES = {
    "flagship_4788": (301, 16, 4788, 48, 3, 0),
    "flagship": (301, 16, 4784, 48, 3, 0),
    "lr_ratio8": (200, 8, 1590, 24, 2, 0),
    "all_left": (300, 16, 4700, 32, 3, 1),
    "all_right": (300, 16, 4700, 32, 3, 2),
    "one_stage": (128, 4, 500, 12, 1, 0),
}
# test_pallas.py:342-350, geometries it rejects (n_curr, ratio, half, n_up,
# L, num, mtype)
POLY_REJECTED = {
    "n_up_below_window": (100, 4, 2, 200, 24, 3, 0),
    "map_not_all_valid": (30, 16, 8, 600, 48, 3, 0),
    "L_128": (301, 16, 8, 4788, 128, 3, 0),
}
# the chain's geometry (curr has 300 samples) and the rest of the list
CURRENT_CASES = {
    "flagship": (300, 16, 4784, 48, 3, 0),
    "flagship_4788": POLY_GEOMETRIES["flagship_4788"],
    "lr_ratio8": (200, 8, 1590, 24, 2, 0),
    "all_left": POLY_GEOMETRIES["all_left"],
    "all_right": (300, 16, 4700, 32, 3, 2),
    "one_stage": POLY_GEOMETRIES["one_stage"],
}
CUR_REL = 2e-5  # test_pallas.py:333
# the up-domain route's cases: those, and L = 128, which only it serves (the
# polyphase plan rejects L >= W / 2)
UPDOMAIN_CASES = {**CURRENT_CASES, "L_128": (301, 16, 4788, 128, 3, 0)}


@pytest.mark.parametrize("case", sorted(POLY_GEOMETRIES))
def test_poly_plan_matches_jax(case):
    from dspeed_tpu.processors import _pallas

    from dspeed_tpu_torch.processors._poly_plan import T, W, poly_plan

    n_curr, ratio, n_up, L, num, mtype = POLY_GEOMETRIES[case]
    half = ratio // 2
    want = _pallas._poly_plan(n_curr, ratio, half, n_up, L, num, mtype)
    got = poly_plan(n_curr, ratio, half, n_up, L, num, mtype)
    assert want is not None and got is not None
    assert (W, T) == (_pallas._POLY_W, _pallas._POLY_T)
    for k in ("EL", "ERW", "nq", "q_min", "t0_base", "nblk", "T_last"):
        assert got[k] == want[k], k
    # the TPU's band matrices are the per-phase filters laid out per block
    Hm, nq = got["Hm"], got["nq"]
    for key, tb in (("A", T), ("A_last", got["T_last"])):
        A = np.zeros((tb + nq - 1, ratio * tb))
        for tl in range(tb):
            A[tl : tl + nq, ratio * tl : ratio * (tl + 1)] = Hm.T
        np.testing.assert_array_equal(A.astype(np.float32), want[key])
    # and the edge windows' one-hot matrices are the replication map
    for key, j0 in (("RL", 0), ("RR", n_up - W)):
        src = (j0 + np.arange(W) + half) // ratio
        np.testing.assert_array_equal(want[key].argmax(0), src)
        assert (want[key].sum(0) == 1).all()


@pytest.mark.parametrize("case", sorted(POLY_REJECTED))
def test_poly_plan_rejects_what_jax_rejects(case):
    from dspeed_tpu.processors import _pallas

    from dspeed_tpu_torch.processors._poly_plan import poly_plan

    g = POLY_REJECTED[case]
    assert _pallas._poly_plan(*g) is None
    assert poly_plan(*g) is None


def _current_inputs(n_curr, b=64, seed=42):
    """test_pallas.py:311-313: random currents with a common spike."""
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 30, (b, n_curr)).astype("float32")
    c[:, n_curr // 3] += 500.0
    return c


def _updomain_curve(c, ratio, n_up, L, num, mtype):
    """The plain version's upsampled, averaged rows (float64)."""
    from dspeed_tpu_torch.processors import moving_window_multi, upsampler

    (up,) = upsampler(torch.as_tensor(c), float(ratio), dims={"m": n_up})
    (av,) = moving_window_multi(up, float(L), float(num), np.int32(mtype))
    return av.double().cpu().numpy()


def _check_current(got, want, curve, rel, what):
    """The current front's rule: a_min/a_max within ``rel`` of scale;
    t_min/t_max equal, except on a near-tie, where ``curve`` (the plain
    version's rows) at the other index lies within that tolerance of the
    extremum. NaN rows must agree. Returns the excused rows per index."""
    got = [np.asarray(o, np.float64) for o in got]
    want = [np.asarray(o, np.float64) for o in want]
    for q in range(4):
        np.testing.assert_array_equal(np.isnan(got[q]), np.isnan(want[q]), what)
    ok = ~np.isnan(want[3])
    scale = max(np.abs(want[2][ok]).max(), np.abs(want[3][ok]).max(), 1.0)
    tol = rel * scale
    for q in (2, 3):
        err = np.abs(got[q][ok] - want[q][ok]).max()
        assert err <= tol, f"{what} output {q}: {err:.3e} > {tol:.3e}"
    excused = {}
    for q, ext in ((0, np.min), (1, np.max)):
        rows = np.flatnonzero(ok & (got[q] != want[q]))
        for r in rows:
            v = curve[r, [int(got[q][r]), int(want[q][r])]]
            assert np.abs(v - ext(curve[r])).max() <= tol, (what, q, r, v)
        excused[("t_min", "t_max")[q]] = rows.tolist()
    print(f"{what}: rows excused as near-ties {excused}")
    return excused


@pytest.mark.parametrize("case", sorted(CURRENT_CASES))
def test_fused_current_poly_plain_matches_pallas_interpret(case):
    import jax.numpy as jnp
    from dspeed_tpu.processors import _pallas

    n_curr, ratio, n_up, L, num, mtype = CURRENT_CASES[case]
    half = ratio // 2
    c = _current_inputs(n_curr)
    b = c.shape[0]
    cp = jnp.pad(jnp.asarray(c), ((0, (-b) % _pallas._POLY_TILE_B), (0, 0)))
    want = [
        np.asarray(o[:b, 0])
        for o in _pallas._fused_current_poly_call(
            cp, n_curr, ratio, half, n_up, L, num, mtype, interpret=True
        )
    ]
    got = _cuda.fused_current_poly_plain(
        torch.from_numpy(c), ratio, half, n_up, L, num, mtype
    )
    curve = _updomain_curve(c, ratio, n_up, L, num, mtype)
    _check_current([o.numpy() for o in got], want, curve, CUR_REL, case)


@pytest.mark.parametrize("case", sorted(UPDOMAIN_CASES))
def test_fused_current_plain_matches_pallas_interpret(case):
    import jax.numpy as jnp
    from dspeed_tpu.processors import _pallas

    n_curr, ratio, n_up, L, num, mtype = UPDOMAIN_CASES[case]
    half = ratio // 2
    c = _current_inputs(n_curr)
    rep = jnp.repeat(jnp.asarray(c), ratio, axis=-1)
    if half + n_up > rep.shape[-1]:
        rep = jnp.pad(rep, ((0, 0), (0, half + n_up - rep.shape[-1])))
    want = [
        np.asarray(o[:, 0])
        for o in _pallas._fused_current_call(
            rep, half, n_up, L, num, mtype, interpret=True
        )
    ]
    got = _cuda.fused_current(torch.from_numpy(c), ratio, half, n_up, L, num, mtype)
    curve = _updomain_curve(c, ratio, n_up, L, num, mtype)
    _check_current([o.numpy() for o in got], want, curve, CUR_REL, case)


@pytest.mark.parametrize(
    "need",
    [(False, True, False, True), (True, False, False, False),
     (False, False, True, True)],
    ids=["max_side", "t_min_only", "amplitudes"],
)
def test_fused_current_need_leaves_needed_outputs_unchanged(need):
    n_curr, ratio, n_up, L, num, mtype = CURRENT_CASES["flagship"]
    c = torch.from_numpy(np.abs(_current_inputs(n_curr, b=16)))
    for fn in (_cuda.fused_current_poly_plain, _cuda.fused_current):
        full = fn(c, ratio, ratio // 2, n_up, L, num, mtype)
        part = fn(c, ratio, ratio // 2, n_up, L, num, mtype, need=need)
        for q in range(4):
            if need[q]:
                np.testing.assert_array_equal(part[q].numpy(), full[q].numpy())
    # the polyphase route reduces neither side nothing needs: zeros there
    part = _cuda.fused_current_poly_plain(c, ratio, ratio // 2, n_up, L, num,
                                          mtype, need=need)
    if not (need[0] or need[2]):
        assert (part[0] == 0).all() and (part[2] == 0).all()
    if not need[1]:
        assert (part[1] == 0).all()


@pytest.mark.parametrize("mtype,num", [(0, 3), (1, 2), (2, 2), (0, 0)])
def test_fused_current_plain_equals_unfused_steps(mtype, num):
    """test_pallas.py:257-274: the front's plain composition against the
    JAX package's unfused upsampler -> moving_window_multi -> min_max, bit
    for bit, through the port's factory."""
    import dspeed_tpu.processors as jp
    import dspeed_tpu_torch.processors as tp

    rng = np.random.default_rng(5)
    c = rng.normal(0, 5, (6, 100)).astype("float32")
    n_up = 790
    got = tp.fused_current_front(n_up, 8, 32, num, mtype)(torch.from_numpy(c))
    (up,) = jp.upsampler(c, 8.0, dims={"m": n_up})
    (av,) = jp.moving_window_multi(np.asarray(up), 32.0, float(num), np.int32(mtype))
    want = jp.min_max(np.asarray(av))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fused_current_nan_poisoning():
    """test_pallas.py:277-285: a NaN in a row of the current poisons its
    four outputs, in the factory and in the polyphase plain version."""
    import dspeed_tpu_torch.processors as tp

    rng = np.random.default_rng(6)
    c = rng.normal(0, 5, (4, 100)).astype("float32")
    c[2, 50] = np.nan
    for o in tp.fused_current_front(790, 8, 32, 3, 0)(torch.from_numpy(c)):
        o = o.numpy()
        assert np.isnan(o[2]).all() and np.isfinite(o[[0, 1, 3]]).all()
    c = _current_inputs(300, b=4)
    c[1, 7] = np.nan
    for o in _cuda.fused_current_poly_plain(torch.from_numpy(c), 16, 8, 4784, 48, 3, 0):
        o = o.numpy()
        assert np.isnan(o[1]) and np.isfinite(o[[0, 2, 3]]).all()


def test_fused_current_checks_its_geometry():
    c = torch.zeros(2, 300)
    with pytest.raises(ValueError, match="replication map"):
        _cuda.fused_current(c, 16, 8, 4800, 48, 3, 0)  # half + n_up > 4800
    with pytest.raises(ValueError, match="replication map"):
        _cuda.fused_current(c, 16, 3, 4784, 48, 3, 0)  # half != ratio // 2
    with pytest.raises(ValueError, match="out of range"):
        _cuda.fused_current(c, 16, 8, 4784, 129, 3, 0)
    with pytest.raises(ValueError, match="no polyphase plan"):
        _cuda.fused_current_poly_plain(torch.zeros(2, 301), 16, 8, 4788, 128, 3, 0)


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


def _card_k1_case(case, n):
    """A K1 case with its slope slices cut to rows of ``n`` samples."""
    kw = dict(K1_CASES[case])
    kw["slope_specs"] = tuple(
        (src, a0, min(b0, n)) for src, a0, b0 in kw.get("slope_specs", ())
    )
    return kw


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(K1_CASES))
@pytest.mark.parametrize("n", [4095, 1000, 5000, 8192, 19000])
def test_fused_energy_kernel_takes_row_tails_on_the_card(case, n, cuda_device):
    """Rows whose length is no multiple of 16 samples (4095: no multiple of
    4 either, so no 16-byte vector access), and rows of more than 4096
    samples, which take K1's long-row instance (8 lane-steps a warp, up to
    1024 threads a block) with full (8192) or partial (5000, 19000) last
    warps, against the plain version."""
    kw = _card_k1_case(case, n)
    wf, bl = _hpge(n_ev=64, n=n)
    w, b = torch.from_numpy(wf).to(cuda_device), torch.from_numpy(bl).to(cuda_device)
    got = _flat(_cuda.fused_energy(w, b, TAU, **kw))
    want = _flat(_cuda.fused_energy_plain(w, b, TAU, **kw))
    torch.cuda.synchronize()
    _check_k1([o.cpu().numpy() for o in got], [o.cpu().numpy() for o in want], kw,
              f"{case} n={n}")


@pytest.mark.gpu
def test_fused_energy_kernel_poisons_nan_rows_on_the_card(cuda_device):
    """A NaN sample (row 3) and a NaN baseline (row 5): every float plane and
    scalar of both rows is NaN, but the raw min_max of the NaN-baseline row,
    and every mask byte of both rows is 0."""
    kw = _card_k1_case("mask", 4096)
    kw.update(emit_blsub=True, emit_minmax=True)
    wf, bl = _hpge(n_ev=64, n=4096)
    w, b = torch.from_numpy(wf).to(cuda_device), torch.from_numpy(bl).to(cuda_device)
    flat = [o.cpu().numpy() for o in _flat(_cuda.fused_energy(w, b, TAU, **kw))]
    mask = flat.pop()
    s0 = 1 + len(kw["trap_specs"]) + len(kw["emax_for"]) + 4 * len(kw["slope_specs"])
    mm = flat[s0 : s0 + 4]
    good = [0, 1, 2, 4, 6, 7]
    for q, o in enumerate(flat):
        assert np.isnan(o[3]).all() and np.isfinite(o[good]).all(), q
        assert np.isnan(o[5]).all() == (not any(o is m for m in mm)), q
    assert not mask[[3, 5]].any() and mask[good].any()


@pytest.mark.gpu
def test_fused_energy_kernel_walks_more_rows_than_its_grid(cuda_device):
    """Each block of the persistent grid takes several rows."""
    n = 1024
    cfg = _cuda.fused_energy_launch(n)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    rows = 2 * cfg["blocks_per_sm"] * sms + 5
    kw = K1_CASES["mask"]
    wf, bl = _hpge(n_ev=rows, n=n)
    w, b = torch.from_numpy(wf).to(cuda_device), torch.from_numpy(bl).to(cuda_device)
    got = _flat(_cuda.fused_energy(w, b, TAU, **kw))
    want = _flat(_cuda.fused_energy_plain(w, b, TAU, **kw))
    torch.cuda.synchronize()
    _check_k1([o.cpu().numpy() for o in got], [o.cpu().numpy() for o in want], kw,
              f"{rows} rows")


@pytest.mark.gpu
def test_f64_flagship_on_the_card_meets_the_golden_tolerance(cuda_device):
    """A float64 flagship runs on the card as K7's two float64 groups (no
    hand kernel takes a float64 plane; the default mode forms the generic
    groups), two launches of the one chunk and no split, and meets the
    golden replay's tolerance (``tests/test_goldens.py:40-45``) against the
    CPU run of the events."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_flagship import flagship_config

    import dspeed_tpu_torch
    from dspeed_tpu_torch import lh5

    wf, bl = _hpge(n_ev=64, n=4096)
    table = lh5.Table({
        "waveform": lh5.WaveformTable(values=wf.astype("float64"), t0=0.0,
                                      t0_units="ns", dt=16.0, dt_units="ns"),
        "baseline": lh5.Array(bl.astype("float64")),
    })
    kw = dict(dsp_config=flagship_config("float64"), database={"pz": {"tau": TAU}})
    hand = ("fused_energy", "cascade_tp", "fused_t0", "banded_conv_multi",
            "fused_current_poly", "fused_current")
    from dspeed_tpu_torch.processors import _tile_program

    before = dict(_cuda.LAUNCHES)
    _tile_program.reset_splits()
    card = dspeed_tpu_torch.build_dsp(table, device="cuda", **kw)
    assert all(_cuda.LAUNCHES[k] == before[k] for k in hand)
    assert _cuda.LAUNCHES["generic_rows"] == before["generic_rows"] + 2
    assert _tile_program.SPLITS == {}
    cpu = dspeed_tpu_torch.build_dsp(table, device="cpu", **kw)
    for k in kw["dsp_config"]["outputs"]:
        g, w = np.asarray(card[k].nda), np.asarray(cpu[k].nda)
        assert g.dtype == w.dtype == np.float64, k
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12, equal_nan=True,
                                   err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_banded_conv_kernel_matches_plain_on_the_card(case, cuda_device):
    c = K4_CASES[case]
    w, kerns, lo, p = _k4_case(case, 64)
    wt = torch.from_numpy(w).to(cuda_device)
    before = _cuda.LAUNCHES["banded_conv_multi"]
    got = _cuda.banded_conv_multi(wt, kerns, lo, p, n_in=c["n_in"])
    assert _cuda.LAUNCHES["banded_conv_multi"] == before + 1
    want = _cuda.banded_conv_plain(wt, kerns, lo, p, n_in=c["n_in"])
    torch.cuda.synchronize()
    for j, (g, wv) in enumerate(zip(got, want)):
        _compare(g.cpu().numpy(), wv.cpu().numpy(), what=f"{case} kernel {j}")
        _check_k4_nan_rows(g.cpu().numpy(), len(w))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case", sorted(k for k, c in K4_CASES.items() if c["nk"] > 1)
)
def test_banded_conv_bank_equals_its_kernels_alone_on_the_card(case, cuda_device):
    """Each output is summed in the same order whatever the bank's size, so
    a bank's outputs equal K4 launched with each of its kernels alone, bit
    for bit."""
    c = K4_CASES[case]
    w, kerns, lo, p = _k4_case(case, 64)
    wt = torch.from_numpy(w).to(cuda_device)
    bank = _cuda.banded_conv_multi(wt, kerns, lo, p, n_in=c["n_in"])
    for j, k in enumerate(kerns):
        (alone,) = _cuda.banded_conv_multi(wt, [k], lo, p, n_in=c["n_in"])
        g, a = bank[j].cpu().numpy(), alone.cpu().numpy()
        same = (g == a) | (np.isnan(g) & np.isnan(a))
        assert same.all(), (case, j, np.argwhere(~same)[:5])


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASCADE_CASES))
def test_cascade_kernel_bit_identical_to_plain_on_the_card(case, cuda_device):
    args = [torch.from_numpy(x).to(cuda_device)
            for x in _cascade_inputs(case, n_ev=256)]
    _check_cascade_on_the_card(case, *args)


def _check_cascade_on_the_card(case, w, base, t0):
    factors, dirs, starts = CASCADE_CASES[case]
    before = _cuda.LAUNCHES["cascade_tp"]
    got = _cuda.cascade_tp(w, base, t0, factors, dirs, starts)
    assert _cuda.LAUNCHES["cascade_tp"] == before + 1
    want = _cuda.cascade_tp_plain(w, base, t0, factors, dirs, starts)
    torch.cuda.synchronize()
    for k, (g, wv) in enumerate(zip(got, want)):
        g, wv = g.cpu().numpy(), wv.cpu().numpy()
        same = (g == wv) | (np.isnan(g) & np.isnan(wv))
        assert same.all(), (case, k, np.where(~same)[0][:5])


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASCADE_CASES))
@pytest.mark.parametrize("batch", ["37_rows", "beyond_the_grid"])
def test_cascade_kernel_odd_batches_on_the_card(case, batch, cuda_device):
    """A batch that is not a multiple of the rows a block takes, and one
    of more rows than the persistent grid holds at once."""
    n = _cascade_inputs(case, n_ev=18)[0].shape[1]
    n_ev = 37
    if batch == "beyond_the_grid":
        launch = _cuda.cascade_tp_launch(n)
        sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
        n_ev += launch["rows_per_block"] * launch["blocks_per_sm"] * sms
    args = [torch.from_numpy(x).to(cuda_device)
            for x in _cascade_inputs(case, n_ev=n_ev)]
    _check_cascade_on_the_card(case, *args)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["flagship", "nan_ends", "bwd_walks_to_one"])
def test_cascade_kernel_takes_an_offset_row_pointer_on_the_card(case, cuda_device):
    """Rows of n % 4 == 0 samples that start 4 bytes past 16-byte
    alignment take the kernel's 4-byte copies."""
    w, base, t0 = _cascade_inputs(case, n_ev=64)
    flat = torch.zeros(w.size + 1, dtype=torch.float32, device=cuda_device)
    flat[1:] = torch.from_numpy(w.ravel()).to(cuda_device)
    w_off = flat[1:].view(w.shape)
    assert w_off.data_ptr() % 16 == 4 and w_off.is_contiguous()
    _check_cascade_on_the_card(
        case, w_off, *[torch.from_numpy(x).to(cuda_device) for x in (base, t0)]
    )


@pytest.mark.gpu
def test_cascade_kernel_launches_once_with_no_local_memory(cuda_device):
    """One warp a row, as many rows a block as its shared memory holds (at
    most 16), no local memory, one launch a call at every row length up to
    the largest one warp's buffer takes."""
    for n in (4096, 1024, 1001, 19000, 58112):
        launch = _cuda.cascade_tp_launch(n)
        assert launch["local_bytes"] == 0, (n, launch)
        assert launch["blocks_per_sm"] >= 1, (n, launch)
        assert launch["threads"] == 32 * launch["rows_per_block"], (n, launch)
        row_bytes = 4 * (-(-n // 4) * 4)
        assert launch["smem_bytes"] == launch["rows_per_block"] * row_bytes
        assert launch["rows_per_block"] == min(16, 232448 // row_bytes), (n, launch)
        w = torch.linspace(0, 1, n, device=cuda_device).repeat(3, 1)
        base = torch.ones(3, device=cuda_device)
        t0 = torch.zeros(3, device=cuda_device)
        before = _cuda.LAUNCHES["cascade_tp"]
        got = _cuda.cascade_tp(w, base, t0, [0.5, 0.25], [1, 0], [-1, 0])
        assert _cuda.LAUNCHES["cascade_tp"] == before + 1
        want = _cuda.cascade_tp_plain(w, base, t0, [0.5, 0.25], [1, 0], [-1, 0])
        for g, wv in zip(got, want):
            assert torch.equal(g, wv), (n, g, wv)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(T0_CASES))
def test_fused_t0_kernel_matches_plain_on_the_card(case, cuda_device):
    kw = T0_CASES[case]
    w, kern, std = _t0_inputs(case, n_ev=256)
    wt, st = (torch.from_numpy(x).to(cuda_device) for x in (w, std))
    before = _cuda.LAUNCHES["fused_t0"]
    got = _cuda.fused_t0(wt, kern, st, **kw)
    assert _cuda.LAUNCHES["fused_t0"] == before + 1
    want = _cuda.fused_t0_plain(wt, kern, st, **kw)
    torch.cuda.synchronize()
    got, g_curr = _split_curr([o.cpu().numpy() for o in got], kw)
    want, w_curr = _split_curr([o.cpu().numpy() for o in want], kw)
    if g_curr is not None:
        assert _check_curr(g_curr, w_curr, got[4], want[4], case) >= 2
    # on the card the plain version's convolution is K4's 's' window, whose
    # summation order K3 shares: the filtered rows, hence t_min, t_max and
    # tp_0, agree bit for bit
    for q in (0, 1, 4):
        if q == 4 or kw["need"][q]:
            same = (got[q] == want[q]) | (np.isnan(got[q]) & np.isnan(want[q]))
            assert same.all(), (case, q, np.where(~same)[0][:5])
    _check_t0(got, want, kw["need"], case)


def _card_currents(cuda_device, n_curr, b=512):
    c = _current_inputs(n_curr, b=b)
    c[3, 11] = np.nan
    return torch.from_numpy(c).to(cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CURRENT_CASES))
@pytest.mark.parametrize(
    "need", [(True,) * 4, (False, True, False, True)], ids=["all", "max_side"]
)
def test_fused_current_poly_kernel_matches_plain_on_the_card(case, need, cuda_device):
    n_curr, ratio, n_up, L, num, mtype = CURRENT_CASES[case]
    c = _card_currents(cuda_device, n_curr)
    args = (c, ratio, ratio // 2, n_up, L, num, mtype)
    before = _cuda.LAUNCHES["fused_current_poly"]
    got = _cuda.fused_current(*args, need=need)
    assert _cuda.LAUNCHES["fused_current_poly"] == before + 1
    poly = _cuda.fused_current_poly_plain(*args, need=need)
    plain = _cuda.fused_current_plain(*args)
    torch.cuda.synchronize()
    got = [o.cpu().numpy() for o in got]
    curve = _updomain_curve(c, ratio, n_up, L, num, mtype)
    keep = [q for q in range(4) if need[q]]
    for ref, rel, what in ((poly, 1e-5, "poly"), (plain, 2e-5, "plain")):
        ref = [o.cpu().numpy() for o in ref]
        g = [got[q] if q in keep else ref[q] for q in range(4)]
        _check_current(g, ref, curve, rel, f"{case} {what}")
    assert np.isnan(got[3][3]) and np.isfinite(np.delete(got[3], 3)).all()


def _k5_rows(case, n_curr):
    """Currents for K5's edge cases on the card (flagship geometry)."""
    if case == "batch_1":
        return _current_inputs(n_curr, b=1, seed=3)
    c = _current_inputs(n_curr, b=37, seed=4)
    if case == "nan_ends":  # NaN at the first and at the last sample
        c[2, 0] = np.nan
        c[30, n_curr - 1] = np.nan
    elif case == "constant":  # exact ties across lanes, windows and interior
        c[:] = 0.0
        c[::2] = 7.0
    elif case == "max_left":  # the maximum in the left window's kept range
        c[:, n_curr // 3] -= 500.0
        c[:, 0] += 4000.0 + 10 * np.arange(37)
    elif case == "max_right":  # and in the right window's
        c[:, n_curr // 3] -= 500.0
        c[:, n_curr - 1] += 4000.0 + 10 * np.arange(37)
    elif case == "inf":  # infinite samples: at both ends, inside, both signs
        c[5, 0] = np.inf
        c[6, n_curr - 1] = -np.inf
        c[7, n_curr // 2] = np.inf
        c[8, n_curr // 2 + 1] = -np.inf
        c[9, 100], c[9, 200] = np.inf, -np.inf
    return c


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case",
    ["batch_37", "batch_1", "nan_ends", "constant", "max_left", "max_right", "inf"],
)
@pytest.mark.parametrize(
    "need", [(True,) * 4, (False, True, False, True)], ids=["all", "max_side"]
)
def test_fused_current_poly_kernel_edge_cases_on_the_card(case, need, cuda_device):
    from dspeed_tpu_torch.processors._poly_plan import poly_plan

    n_curr, ratio, n_up, L, num, mtype = CURRENT_CASES["flagship"]
    c_np = _k5_rows(case, n_curr)
    c = torch.from_numpy(c_np).to(cuda_device)
    args = (c, ratio, ratio // 2, n_up, L, num, mtype)
    before = _cuda.LAUNCHES["fused_current_poly"]
    got = _cuda.fused_current(*args, need=need)
    assert _cuda.LAUNCHES["fused_current_poly"] == before + 1
    poly = _cuda.fused_current_poly_plain(*args, need=need)
    plain = _cuda.fused_current_plain(*args)
    torch.cuda.synchronize()
    got = [o.cpu().numpy() for o in got]
    curve = _updomain_curve(c_np, ratio, n_up, L, num, mtype)
    keep = [q for q in range(4) if need[q]]
    bad = ~np.isfinite(c_np).all(axis=1)
    inf = np.isinf(c_np).any(axis=1)
    assert inf.sum() == (5 if case == "inf" else 0)
    # an infinite sample: the composition gives NaN on all four outputs, and
    # the polyphase formulation a NaN amplitude (its indices are n_up there)
    plain = [o.cpu().numpy() for o in plain]
    poly = [o.cpu().numpy() for o in poly]
    assert all(np.isnan(plain[q][inf]).all() for q in range(4))
    assert np.isnan(poly[3][inf]).all()
    poly = [np.where(inf, np.nan, o) for o in poly]
    for ref, rel, what in ((poly, 1e-5, "poly"), (plain, 2e-5, "plain")):
        g = [got[q] if q in keep else ref[q] for q in range(4)]
        _check_current(g, ref, curve, rel, f"{case} {what}")
    for q in range(4):
        assert (np.isnan(got[q]) == bad).all()
        if not need[q] and not (q >= 2 and need[q - 2]):
            assert (got[q][~bad] == 0).all()
    plan = poly_plan(n_curr, ratio, ratio // 2, n_up, L, num, mtype)
    if case == "constant":  # a flat zero curve: the first sample wins
        flat = np.flatnonzero((curve == 0).all(axis=1))
        assert flat.size == 18
        for q in keep:
            assert (got[q][flat] == 0).all()
    elif case in ("max_left", "max_right"):
        lo, hi = (0, plan["EL"]) if case == "max_left" else (n_up - plan["ERW"], n_up)
        where = curve.argmax(axis=1)
        assert ((where >= lo) & (where < hi)).all()
        if need[1]:
            assert ((got[1] >= lo) & (got[1] < hi)).all()


@pytest.mark.gpu
@pytest.mark.parametrize(
    "need", [(True,) * 4, (False, True, False, True), (True, False, False, False)],
    ids=["all", "max_side", "min_side"],
)
def test_fused_current_poly_launch_has_no_spills(need, cuda_device):
    """K5's instance for each side, at the flagship geometry (the
    register-tiled instance) and at geometries of the generic instance:
    registers without local memory, and a launch that fits the card."""
    from dspeed_tpu_torch.processors._poly_plan import poly_plan

    for case in ("flagship", "lr_ratio8", "one_stage"):
        n_curr, ratio, n_up, L, num, mtype = CURRENT_CASES[case]
        plan = poly_plan(n_curr, ratio, ratio // 2, n_up, L, num, mtype)
        launch = _cuda.fused_current_poly_launch(n_curr, ratio, n_up, plan["nq"],
                                                 need)
        assert launch["local_bytes"] == 0, (case, launch)
        assert launch["blocks_per_sm"] >= 1, (case, launch)
        assert launch["threads"] == 32 * launch["events_per_block"]
    launch = _cuda.fused_current_poly_launch(400, 4, 1500, 31, need)  # generic
    assert launch["local_bytes"] == 0 and launch["blocks_per_sm"] >= 1, launch


@pytest.mark.gpu
def test_fused_current_poly_takes_every_geometry_the_block_kernel_took(cuda_device):
    """Every plan geometry on a grid that the block-per-row K5 accepted,
    ``8 W + 4 (n_curr + ratio nq + W + n_up) <= _MAX_SMEM`` bytes of shared
    memory, is still launched, at B = 2, and agrees with its polyphase
    plain version."""
    from dspeed_tpu_torch.processors._poly_plan import W, poly_plan

    L, num, mtype = 24, 3, 0
    taken = 0
    for ratio in (4, 8, 16):
        half = ratio // 2
        n_h = ratio * poly_plan(1000, ratio, half, 512, L, num, mtype)["nq"]
        # the largest n_curr the block-per-row kernel took with n_up = 512
        top = (_cuda._MAX_SMEM - 8 * W - 4 * (n_h + W + 512)) // 4
        for n_curr in sorted({64, 100, 300, 1000, 3000, 10000, top - 1, top}):
            for n_up in (512, n_curr * ratio - half):
                if 4 * (n_curr + n_h + W + n_up) + 8 * W > _cuda._MAX_SMEM:
                    continue
                plan = poly_plan(n_curr, ratio, half, n_up, L, num, mtype)
                if plan is None:
                    continue
                assert ratio * plan["nq"] == n_h
                c_np = _current_inputs(n_curr, b=2, seed=n_curr)
                c = torch.from_numpy(c_np).to(cuda_device)
                args = (c, ratio, half, n_up, L, num, mtype)
                before = _cuda.LAUNCHES["fused_current_poly"]
                got = _cuda.fused_current(*args)
                assert _cuda.LAUNCHES["fused_current_poly"] == before + 1
                want = _cuda.fused_current_poly_plain(*args)
                torch.cuda.synchronize()
                for q in (2, 3):
                    np.testing.assert_allclose(
                        got[q].cpu().numpy(), want[q].cpu().numpy(),
                        rtol=0, atol=1e-5 * float(want[q].abs().max()),
                    )
                taken += 1
    assert taken >= 30


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["flagship", "L_128"])
def test_fused_current_updomain_kernel_matches_plain_on_the_card(case, cuda_device):
    n_curr, ratio, n_up, L, num, mtype = (
        CURRENT_CASES["flagship"] if case == "flagship"
        else (301, 16, 4788, 128, 3, 0)
    )
    c = _card_currents(cuda_device, n_curr)
    # _k5_rows' infinite rows (5 to 9) in place of rows 5 to 9: all four
    # outputs NaN, as the plain version gives them, where the upsampled row
    # reads an infinite sample (c[(j + half) / ratio], j < n_up); at L = 128
    # row 6's -inf sits in the last sample, which it does not read
    inf_rows = torch.from_numpy(_k5_rows("inf", n_curr)[5:10]).to(cuda_device)
    c[5:10] = inf_rows
    read = c[:, ratio // 2 // ratio : (n_up - 1 + ratio // 2) // ratio + 1]
    inf_read = torch.nonzero(torch.isinf(read).any(1)).flatten().tolist()
    assert inf_read == ([5, 6, 7, 8, 9] if case == "flagship" else [5, 7, 8, 9])
    args = (c, ratio, ratio // 2, n_up, L, num, mtype)
    before = dict(_cuda.LAUNCHES)
    if case == "flagship":
        got = _cuda.fused_current_updomain(*args)
    else:  # no polyphase plan: the front itself takes K6
        got = _cuda.fused_current(*args)
        assert _cuda.LAUNCHES["fused_current_poly"] == before["fused_current_poly"]
    assert _cuda.LAUNCHES["fused_current"] == before["fused_current"] + 1
    want = _cuda.fused_current_plain(*args)
    torch.cuda.synchronize()
    for q in range(4):
        assert bool(torch.isnan(want[q][inf_read]).all()), q
        assert bool(torch.isnan(got[q][inf_read]).all()), q
    curve = _updomain_curve(c, ratio, n_up, L, num, mtype)
    _check_current([o.cpu().numpy() for o in got], [o.cpu().numpy() for o in want],
                   curve, 1e-6, case)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "need", [(True,) * 4, (False, True, False, True)], ids=["all", "max_side"]
)
def test_fused_current_poly_kernel_unread_infinite_tail_on_the_card(need, cuda_device):
    """K5 poisons a row for an infinity only where its upsampled row reads
    it: at ``all_right`` (n_up 4700) the row reads c[0..294], so infinities
    in c[295..299] leave the outputs finite and equal to both plain
    versions; an infinity at c[294], or a NaN anywhere, gives NaN."""
    n_curr, ratio, n_up, L, num, mtype = CURRENT_CASES["all_right"]
    half = ratio // 2
    assert (n_up - 1 + half) // ratio == 294
    c_np = _current_inputs(n_curr, b=37, seed=8)
    c_np[1, 295:] = np.inf
    c_np[2, 299] = -np.inf
    c_np[3, 296], c_np[3, 298] = -np.inf, np.inf
    c_np[4, 294] = np.inf
    c_np[5, 299] = np.nan
    c = torch.from_numpy(c_np).to(cuda_device)
    args = (c, ratio, half, n_up, L, num, mtype)
    before = _cuda.LAUNCHES["fused_current_poly"]
    got = _cuda.fused_current(*args, need=need)
    assert _cuda.LAUNCHES["fused_current_poly"] == before + 1
    poly = _cuda.fused_current_poly_plain(*args, need=need)
    plain = _cuda.fused_current_plain(*args)
    torch.cuda.synchronize()
    got = [o.cpu().numpy() for o in got]
    plain = [o.cpu().numpy() for o in plain]
    bad = np.zeros(len(c_np), bool)
    bad[[4, 5]] = True
    # the polyphase formulation gives n_up, not NaN, as the index of a row
    # whose read sample is infinite
    poly = [np.where(bad, np.nan, o.cpu().numpy()) for o in poly]
    keep = [q for q in range(4) if need[q]]
    curve = _updomain_curve(c_np, ratio, n_up, L, num, mtype)
    for ref, rel, what in ((poly, 1e-5, "poly"), (plain, 2e-5, "plain")):
        g = [got[q] if q in keep else ref[q] for q in range(4)]
        _check_current(g, ref, curve, rel, f"unread tail {what}")
    for q in range(4):
        assert (np.isnan(got[q]) == bad).all(), q
        assert (np.isnan(plain[q]) == bad).all(), q


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["K5", "K6"])
@pytest.mark.parametrize(
    "need", [(True,) * 4, (False, True, False, True)], ids=["all", "max_side"]
)
def test_fused_current_no_stage_infinite_rows_on_the_card(route, need, cuda_device):
    """With no moving-window stage (num = 0) the curve is the upsampled row
    itself: an infinity it reads is the extremum, as the plain composition
    gives it, and only a NaN poisons a row. K5 (the route ``fused_current``
    takes, since the polyphase plan holds) and K6 called directly, on
    ``chip_smoke.with_infinite_rows``' five rows, by
    ``chip_smoke.check_current``'s rule."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    from dspeed_tpu_torch.processors._poly_plan import poly_plan

    g = (16, 8, 4784, 48, 0, 0)
    assert poly_plan(300, *g) is not None
    c = chip_smoke.with_infinite_rows(_card_currents(cuda_device, 300, b=64))
    before = dict(_cuda.LAUNCHES)
    if route == "K5":
        got = _cuda.fused_current(c, *g, need=need)
        assert _cuda.LAUNCHES["fused_current_poly"] == before["fused_current_poly"] + 1
    else:
        got = _cuda.fused_current_updomain(c, *g, need=need)
        assert _cuda.LAUNCHES["fused_current"] == before["fused_current"] + 1
    want = _cuda.fused_current_plain(c, *g)
    torch.cuda.synchronize()
    # rows 30, 32 and 34 hold a +inf (the maximum), 31, 33 and 34 a -inf
    assert bool((want[3][[30, 32, 34]] == float("inf")).all())
    assert bool((want[2][[31, 33, 34]] == float("-inf")).all())
    for q in range(4):
        if need[q]:
            assert torch.isnan(got[q]).nonzero().flatten().tolist() == [3], q
    chip_smoke.check_current(f"{route} no stage", got, want, c, g, 1e-6, need)


# K6 at the geometries it serves: the flagship's, called directly, and
# L = 128, which the polyphase plan rejects, through the front itself
K6_GEOMETRIES = {
    "flagship": CURRENT_CASES["flagship"],
    "L_128": UPDOMAIN_CASES["L_128"],
}


def _k6_call(geometry, c, need):
    n_curr, ratio, n_up, L, num, mtype = K6_GEOMETRIES[geometry]
    args = (c, ratio, ratio // 2, n_up, L, num, mtype)
    before = dict(_cuda.LAUNCHES)
    if geometry == "flagship":
        got = _cuda.fused_current_updomain(*args, need=need)
    else:
        got = _cuda.fused_current(*args, need=need)
    assert _cuda.LAUNCHES["fused_current"] == before["fused_current"] + 1
    assert _cuda.LAUNCHES["fused_current_poly"] == before["fused_current_poly"]
    return got, _cuda.fused_current_plain(*args)


@pytest.mark.gpu
@pytest.mark.parametrize("geometry", sorted(K6_GEOMETRIES))
@pytest.mark.parametrize(
    "case",
    ["batch_37", "batch_1", "nan_ends", "constant", "max_left", "max_right", "inf"],
)
@pytest.mark.parametrize(
    "need", [(True,) * 4, (False, True, False, True)], ids=["all", "max_side"]
)
def test_fused_current_updomain_kernel_edge_cases_on_the_card(
    geometry, case, need, cuda_device
):
    """K6's edge cases, as K5's (``_k5_rows``), against the plain version:
    batches of 37 and 1 rows, NaN at a row's first and last sample, exact
    ties (a flat curve: index 0), the maximum at either end of the row, and
    infinite samples (NaN on all four outputs where the upsampled row reads
    one; at L = 128 the last of 301 samples is not read, and its -inf
    leaves the row finite); both ``need`` settings."""
    n_curr, ratio, n_up, L, num, mtype = K6_GEOMETRIES[geometry]
    last_read = (n_up - 1 + ratio // 2) // ratio
    c_np = _k5_rows(case, n_curr)
    if case == "max_right" and last_read < n_curr - 1:
        # the maximum on the last sample the upsampled row reads
        c_np[:, [last_read, n_curr - 1]] = c_np[:, [n_curr - 1, last_read]]
    c = torch.from_numpy(c_np).to(cuda_device)
    got, want = _k6_call(geometry, c, need)
    torch.cuda.synchronize()
    got = [o.cpu().numpy() for o in got]
    want = [o.cpu().numpy() for o in want]
    read = np.arange(n_curr) <= last_read
    bad = np.isnan(c_np).any(axis=1) | (np.isinf(c_np) & read).any(axis=1)
    if case == "inf":
        assert bad.sum() == (5 if geometry == "flagship" else 4)
    keep = [q for q in range(4) if need[q]]
    curve = _updomain_curve(c_np, ratio, n_up, L, num, mtype)
    g = [got[q] if q in keep else want[q] for q in range(4)]
    _check_current(g, want, curve, 1e-6, f"{geometry} {case}")
    for q in range(4):
        assert (np.isnan(got[q]) == bad).all(), q
        if not need[q] and not (q >= 2 and need[q - 2]):
            assert (got[q][~bad] == 0).all(), q
    if case == "constant":  # a flat zero curve: the first sample wins
        flat = np.flatnonzero((curve == 0).all(axis=1))
        assert flat.size == 18
        for q in keep:
            assert (got[q][flat] == 0).all(), q
    elif case in ("max_left", "max_right"):
        edge = n_up // 10
        for where in [curve.argmax(axis=1)] + ([got[1]] if need[1] else []):
            assert (where < edge if case == "max_left" else where >= n_up - edge).all()


@pytest.mark.gpu
def test_fused_current_updomain_launch_on_the_card(cuda_device):
    """K6's launch: one row a block of 256 threads; shared memory as
    ``dspeed_fused_current_smem_bytes`` states it, the float64 prefix of 256
    whole runs where the runs are held in registers (19 samples: 4609 <=
    n_up <= 4864), the prefix and the row (12 n_up) otherwise; three
    blocks an SM in the register instances; and no local memory in the
    instances a chain launches for one extremum or none (the flagship's
    reads the maximum only)."""
    lib = _cuda._lib("fused_current")
    for n_up in (4100, 4608, 4609, 4784, 4788, 4864, 5120, 5121, 790, 6392):
        per = -(-n_up // 256)
        regs = per == 19
        smem = 8 * 256 * per if regs else 12 * n_up
        assert lib.dspeed_fused_current_smem_bytes(n_up) == smem, n_up
        for need in ((False, True, False, True), (True, False, False, False),
                     (False,) * 4):
            launch = _cuda.fused_current_launch(n_up, need)
            assert launch["smem_bytes"] == smem, (n_up, launch)
            assert launch["threads"] == 256 and launch["rows_per_block"] == 1
            assert launch["local_bytes"] == 0, (n_up, need, launch)
            assert launch["blocks_per_sm"] >= (3 if regs else 1), (n_up, launch)


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
    monkeypatch.setattr(_cuda, "fused_t0_plain", None)
    monkeypatch.setattr(_cuda, "cascade_tp_plain", None)
    monkeypatch.setattr(_cuda, "fused_current_plain", None)
    with pytest.raises(RuntimeError, match="no fused_energy library"):
        _cuda.fused_energy(FakeCuda(), np.zeros(4, "float32"), TAU, (("norm", 8, 2),))
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(RuntimeError, match="no banded_conv library"):
        _cuda.banded_conv_multi(FakeCuda(), [np.ones(5)], 4, 256)
    with pytest.raises(RuntimeError, match="no fused_t0 library"):
        _cuda.fused_t0(FakeCuda(), np.ones(33), np.ones(4, "float32"))
    with pytest.raises(RuntimeError, match="no cascade_tp library"):
        _cuda.cascade_tp(FakeCuda(), np.ones(4, "float32"), np.zeros(4, "float32"),
                         [1, 0.5, 0.2], [1, 0, 0], [-1, 0, 1])
    FakeCuda.shape = (4, 300)
    for fn in (_cuda.fused_current, _cuda.fused_current_updomain):
        with pytest.raises(RuntimeError, match="no fused_current library"):
            fn(FakeCuda(), 16, 8, 4784, 48, 3, 0)
    assert _cuda.LAUNCHES == before

