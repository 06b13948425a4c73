"""The Fourier-domain processors (``fft``, ``ifft``, ``psd``, ``abs2norm``),
the Haar wavelet transform (``discrete_wavelet_transform``) and the Wiener
filter factory (``wiener_filter``, its LH5 file written to a temporary
directory) of the port against the JAX package's, on the same seeded inputs
(at most 16 events), and their ``DSPFatal`` limits. Tolerances are
``test_torch_filters``'s: float64 outputs within ``1e-9`` of their scale,
float32 within ``2e-6`` (the two packages' FFTs sum in other orders), NaN
positions identical; complex outputs part by part.
"""

import os
import sys

import numpy as np
import pytest
import torch

import dspeed_tpu_torch.processors as tp
from dspeed_tpu_torch.errors import DSPFatal

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_filters import _check, _jax, _t  # noqa: E402


def _jp():
    import dspeed_tpu.processors as jp

    return jp


def _walk(dtype, n=256, n_ev=8, seed=2):
    """Random walks (row 3 with a NaN sample)."""
    w = np.cumsum(np.random.default_rng(seed).normal(0, 1, (n_ev, n)), axis=-1)
    w[3, 40] = np.nan
    return w.astype(dtype)


def _check_complex(got, want, dtype):
    g, w = got[0], np.asarray(want[0])
    assert g.dtype == {np.complex64: torch.complex64,
                       np.complex128: torch.complex128}[w.dtype.type]
    _check((g.real.contiguous(), g.imag.contiguous()),
           (np.ascontiguousarray(w.real), np.ascontiguousarray(w.imag)), dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [256, 255])
def test_fft_psd_ifft_match_jax(n, dtype):
    jp = _jp()
    w = _walk(dtype, n=n)
    dims = {"m": n // 2 + 1}
    _check_complex(tp.fft(_t(w), dims=dims), _jax(jp.fft, w, dims=dims), dtype)
    _check(tp.psd(_t(w), dims=dims), _jax(jp.psd, w, dims=dims), dtype)
    spec = np.fft.rfft(np.nan_to_num(w).astype(np.float64), axis=-1).astype(
        np.complex64 if dtype == "float32" else np.complex128)
    spec[5, 3] = complex(np.nan, 0.0)
    back = {"m": 2 * (spec.shape[-1] - 1)}
    _check(tp.ifft(_t(spec), dims=back), _jax(jp.ifft, spec, dims=back), dtype)


def test_abs2norm_matches_jax():
    jp = _jp()
    x = (np.random.default_rng(1).normal(0, 3, 16)
         + 1j * np.random.default_rng(2).normal(0, 3, 16))
    for dt in (np.complex64, np.complex128):
        _check(tp.abs2norm(_t(x.astype(dt)), 7), _jax(jp.abs2norm, x.astype(dt), 7),
               "float32" if dt is np.complex64 else "float64")


def test_fourier_sizes_raise_as_jax():
    jp = _jp()
    w = _walk("float32")
    spec = np.fft.rfft(np.nan_to_num(w), axis=-1).astype(np.complex64)
    for kern, jkern, x, m in ((tp.fft, jp.fft, w, 5), (tp.psd, jp.psd, w, 5),
                              (tp.ifft, jp.ifft, spec, 7)):
        with pytest.raises(DSPFatal, match="Size of"):
            kern(_t(x), dims={"m": m})
        with pytest.raises(Exception, match="Size of") as e:
            jkern(x, dims={"m": m})
        assert type(e.value).__name__ == "DSPFatal"


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("level, wave, coeff, m", [
    (1, "h", "a", 128), (2, "h", "a", 64), (2, "d", "d", 64), (3, "h", "d", 20),
    (4, "d", "a", 16)])
def test_dwt_matches_jax(level, wave, coeff, m, dtype):
    w = _walk(dtype, n=257)
    args = (w, level, ord(wave), ord(coeff))
    _check(tp.discrete_wavelet_transform(*(_t(a) for a in args), dims={"m": m}),
           _jax(_jp().discrete_wavelet_transform, *args, dims={"m": m}), dtype)


@pytest.mark.parametrize("args, err", [
    ((0, "h", "a", 8), "level must be a positive"),
    ((1, "x", "a", 8), "Unrecognized wavelet"),
    ((1, "h", "x", 8), "Unrecognized coefficient"),
    ((3, "h", "a", 64), "larger than coefficient count"),
])
def test_dwt_limits_raise_as_jax(args, err):
    w = _walk("float32")
    level, wave, coeff, m = args
    call = (level, ord(wave), ord(coeff))
    with pytest.raises(DSPFatal, match=err):
        tp.discrete_wavelet_transform(_t(w), *call, dims={"m": m})
    with pytest.raises(Exception, match=err) as e:
        _jp().discrete_wavelet_transform(w, *call, dims={"m": m})
    assert type(e.value).__name__ == "DSPFatal"


def _wiener_file(tmp_path, n=256, seed=4):
    """An LH5 file with the factory's superpulse and noise waveform."""
    from dspeed_tpu_torch import lh5

    t = np.arange(n)
    sp = np.exp(-((t - 100.0) ** 2) / 50.0)
    noise = np.random.default_rng(seed).normal(0, 0.1, n)
    path = str(tmp_path / "wiener.lh5")
    lh5.write(lh5.Array(sp), "spms/processed/superpulse", path)
    lh5.write(lh5.Array(noise), "spms/processed/noise_wf", path)
    return path


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_wiener_filter_matches_jax(tmp_path, dtype):
    path = _wiener_file(tmp_path)
    jk, tk = _jp().wiener_filter([path]), tp.wiener_filter([path])
    assert (tk.signature, tk.types) == (jk.signature, jk.types)
    x = np.fft.fft(np.random.default_rng(1).normal(0, 1, (4, 256)), axis=-1).astype(dtype)
    x[2, 9] = complex(np.nan, 0.0)
    got, want = tk(_t(x))[0], np.asarray(_jax(jk, x)[0])
    rel = "float32" if dtype is np.complex64 else "float64"
    # the taps of bins where the spectra underflow are not finite in either
    # package: compare where the JAX package's are
    fin = np.isfinite(want.real) & np.isfinite(want.imag)
    np.testing.assert_array_equal(np.isnan(got.numpy().real), np.isnan(want.real))
    for part in ("real", "imag"):
        g = getattr(got.numpy(), part)[fin].astype(np.float64)
        w = getattr(want, part)[fin].astype(np.float64)
        _check((torch.from_numpy(g),), (w,), rel)


def test_wiener_filter_limits_raise_as_jax(tmp_path):
    with pytest.raises(DSPFatal, match="valid lh5 file"):
        tp.wiener_filter([str(tmp_path / "missing.lh5")])
    kern = tp.wiener_filter([_wiener_file(tmp_path)])
    with pytest.raises(DSPFatal, match="same length"):
        kern(torch.zeros(2, 100, dtype=torch.complex64))
