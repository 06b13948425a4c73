"""The host-model factories (``svm.py``, ``tf_model.py``) and the user API
for custom processors (``dspeed_tpu_torch/utils.py``) against the JAX
package's: ``svm_predict`` on a stub model and a real
``sklearn.svm.SVC`` (float64, NaN for a row with a NaN, exactly the JAX
package's values), its ``DSPFatal`` refusals; ``tf_model``'s gate without
TensorFlow and a Keras ``Dense`` round trip; a ``GUFuncWrapper`` processor
in a chain, through both packages' ``build_dsp``; ``TpuDefaults``.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

import dspeed_tpu_torch
import dspeed_tpu_torch.processors as tp
from dspeed_tpu_torch.errors import DSPFatal
from dspeed_tpu_torch.utils import (
    GUFuncWrapper, ProcChainVarBase, TpuDefaults, dspeed_guvectorize,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_filters import _jax, _t  # noqa: E402


def _jp():
    import dspeed_tpu.processors as jp

    return jp


class _StubSVM:
    def predict(self, x):
        return (np.asarray(x).sum(axis=-1) > 0).astype("int64")


def _rows(dtype="float32", n_ev=12, n=16, seed=4):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1, (n_ev, n))
    w[3, 5] = np.nan
    w[4, 2] = np.inf
    return w.astype(dtype)


@pytest.mark.parametrize("model", ["stub", "svc"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_svm_predict_matches_jax(tmp_path, model, dtype):
    path = str(tmp_path / "svm.pkl")
    if model == "stub":
        obj = _StubSVM()
    else:
        from sklearn.svm import SVC

        rng = np.random.default_rng(1)
        x = rng.normal(0, 1, (80, 16))
        obj = SVC(gamma="scale").fit(x, (x[:, :4].sum(1) > 0).astype(int))
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    w = _rows(dtype)
    got = tp.svm_predict(path)(_t(w))[0].numpy()
    want = np.asarray(_jax(_jp().svm_predict(path), w)[0])
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[3]) and not np.isnan(got[4])


def test_svm_predict_refusals(tmp_path):
    with pytest.raises(DSPFatal, match="could not load SVM pickle"):
        tp.svm_predict(str(tmp_path / "missing.pkl"))
    path = str(tmp_path / "obj.pkl")
    with open(path, "wb") as f:
        pickle.dump({"not": "a model"}, f)
    with pytest.raises(DSPFatal, match="does not contain an object with .predict"):
        tp.svm_predict(path)


def test_tf_model_without_tensorflow(monkeypatch):
    """Without TensorFlow the factory raises ``DSPFatal``, as the JAX
    package's does."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(DSPFatal, match="tf_model requires tensorflow"):
        tp.tf_model("model.keras")
    with pytest.raises(Exception, match="tf_model requires tensorflow") as e:
        _jp().tf_model("model.keras")
    assert type(e.value).__name__ == "DSPFatal"


def test_tf_model_dense_round_trip(tmp_path):
    """A Keras ``Dense`` layer saved and loaded by both factories: the same
    float64 predictions, ``(n_ev, 3)``, as the model's own."""
    tf = pytest.importorskip("tensorflow")
    keras = tf.keras
    model = keras.Sequential([keras.Input((16,)), keras.layers.Dense(3)])
    rng = np.random.default_rng(2)
    model.layers[0].set_weights([rng.normal(0, 1, (16, 3)).astype("float32"),
                                 rng.normal(0, 1, 3).astype("float32")])
    path = str(tmp_path / "dense.keras")
    model.save(path)
    w = _rows()[[0, 1, 2, 5, 6]]
    got = tp.tf_model(path)(_t(w))[0].numpy()
    want = np.asarray(_jax(_jp().tf_model(path), w)[0])
    assert got.shape == (5, 3) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, model.predict(w, verbose=0), rtol=1e-6)


# ---------------------------------------------------------------------------
# utils.py


def _clip_sum(w_in, hi):
    """A custom processor over batched tensors: the row's sum after
    clipping its samples at ``hi``."""
    return torch.clamp(w_in, max=hi).sum(-1)


clip_sum = GUFuncWrapper(_clip_sum, "(n),()->()", ["ff->f", "dd->d"],
                         name="clip_sum", vectorized=True, copy_out=False,
                         doc_string="clipped sum")


@dspeed_guvectorize("(n)->(n)", ["f->f", "d->d"])
def doubled(w_in):
    return 2 * w_in


def _jax_clip_sum(w_in, hi):
    import jax.numpy as jnp

    return jnp.minimum(w_in, hi).sum(-1)


def test_gufunc_wrapper_processor_in_a_chain():
    """Both wrappers as processors of a chain (``module`` this test module),
    through the port's ``build_dsp``, against the JAX package's wrapper of
    the same function through its own."""
    import dspeed_tpu
    from dspeed_tpu.utils import GUFuncWrapper as JaxWrapper

    assert clip_sum.__doc__ == "clipped sum" and clip_sum.__name__ == "clip_sum"
    rng = np.random.default_rng(3)
    wf = rng.normal(10, 3, (32, 64)).astype(np.float32)
    wf[2, 7] = np.nan

    def table(lh5):
        return lh5.Table({"waveform": lh5.WaveformTable(values=wf, dt=16.0, dt_units="ns")})

    mod = sys.modules[__name__]
    mod.jax_clip_sum = JaxWrapper(_jax_clip_sum, "(n),()->()", ["ff->f", "dd->d"],
                                  name="clip_sum")
    cfg = {"outputs": ["cs"], "processors": {
        "wf2": {"function": "doubled", "module": __name__, "args": ["waveform", "wf2"]},
        "cs": {"function": "clip_sum", "module": __name__, "args": ["wf2", "25.0", "cs"]},
    }}
    out = dspeed_tpu_torch.build_dsp(table(dspeed_tpu_torch.lh5), dsp_config=cfg,
                                     device="cpu")
    want = np.minimum(2 * wf, 25.0).sum(-1)
    np.testing.assert_allclose(out["cs"].nda, want, rtol=1e-6)
    assert np.isnan(out["cs"].nda[2])
    jcfg = {"outputs": ["cs"], "processors": {
        "cs": {"function": "jax_clip_sum", "module": __name__,
               "args": ["waveform*2", "25.0", "cs"]}}}
    jout = dspeed_tpu.build_dsp(table(dspeed_tpu.lh5), dsp_config=jcfg)
    np.testing.assert_allclose(out["cs"].nda, jout["cs"].nda, rtol=1e-6)


def test_tpu_defaults(monkeypatch):
    monkeypatch.setenv("DSPEED_TPU_ACCUM", "f64")
    monkeypatch.setenv("DSPEED_TPU_X64", "1")
    monkeypatch.setenv("DSPEED_TPU_DEBUG_NANS", "true")
    d = TpuDefaults()
    assert (d.accumulation, d.enable_x64, d.debug_nans) == ("f64", True, True)
    d.apply()
    monkeypatch.setenv("DSPEED_TPU_ACCUM", "ds")
    with pytest.raises(ValueError, match="float64 only"):
        TpuDefaults().apply()
    monkeypatch.delenv("DSPEED_TPU_ACCUM")
    monkeypatch.delenv("DSPEED_TPU_X64")
    d = TpuDefaults()
    assert (d.accumulation, d.enable_x64) == ("auto", False)
    d.apply()
    assert ProcChainVarBase.__slots__ == ()
