"""The flagship configuration, ``configs/hpge-energy-timing.yaml``, for the
port's tests. It imports neither JAX nor the JAX package, so the ``gpu``
tests can take it on a machine that has neither."""

import os

import yaml

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "hpge-energy-timing.yaml")


def flagship_config(dtype="float32"):
    """The flagship as the YAML holds it. With ``dtype="float64"`` its float32
    declarations (the filter kernels, the convolved and windowed planes, the
    ``amax`` types) are widened to float64, so a float64 waveform stays
    float64 through the chain."""
    with open(CONFIG) as f:
        txt = f.read()
    if dtype == "float64":
        for f32, f64 in (("'f')", "'d')"), ("'f', grid", "'d', grid"),
                         ('"fi->f"', '"di->d"')):
            txt = txt.replace(f32, f64)
    cfg = yaml.safe_load(txt)
    assert len(cfg["outputs"]) == 34
    return cfg
