"""The PyTorch port stands alone: it imports neither JAX nor any module of
the JAX package, and asking for a card that is not there raises."""

import ast
import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def fresh_chain_cache():
    """Each test builds its own chains: one that another test cached (with
    other fusion passes or settings patched in) must not serve it."""
    from dspeed_tpu_torch import build_dsp

    cache = sys.modules[build_dsp.__module__]._CHAIN_CACHE
    cache.clear()
    yield
    cache.clear()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "dspeed_tpu_torch")
SOURCES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True)
)


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or name == "dspeed_tpu" or (
        name.startswith("dspeed_tpu.")
    )


_RUN_ENERGY_CHAIN = r"""
import json, sys
sys.path.insert(0, {repo!r})
import numpy as np
import yaml
import dspeed_tpu_torch
from dspeed_tpu_torch import build_dsp, lh5

rng = np.random.default_rng(3)
wf = (15000 + rng.normal(0, 3, (4, 4096))).astype("float32")
wf[:, 1000:] += 5000
tb = lh5.Table({{
    "waveform": lh5.WaveformTable(values=wf, t0=0.0, t0_units="ns", dt=16.0,
                                  dt_units="ns"),
    "baseline": lh5.Array(np.full(4, 15000, "float32")),
}})
with open({config!r}) as f:
    cfg = yaml.safe_load(f)
cfg["outputs"] = {outputs!r}
out = build_dsp(tb, dsp_config=cfg, database={{"pz": {{"tau": 27460.5}}}},
                device="cpu", fuse={fuse!r})
assert np.isfinite(out["trapEmax"].nda).all()
print(json.dumps(sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax.")
                        or m == "dspeed_tpu" or m.startswith("dspeed_tpu."))))
print("dspeed_tpu_torch" in sys.modules)
"""


def _run_without_jax(outputs, fuse=True):
    code = _RUN_ENERGY_CHAIN.format(
        repo=REPO,
        config=os.path.join(REPO, "configs", "hpge-energy-timing.yaml"),
        outputs=outputs, fuse=fuse,
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, env=env, timeout=600,
    )
    assert res.returncode == 0, res.stderr
    *_, modules, imported = res.stdout.strip().splitlines()
    assert json.loads(modules) == []
    assert imported == "True"


def test_energy_chain_runs_without_jax_or_the_jax_package():
    _run_without_jax(["trapEmax", "cuspEmax", "zacEftp", "bl_std", "tp_max"])


def test_timing_chain_runs_without_jax_or_the_jax_package():
    _run_without_jax(["trapEmax", "tp_0_est", "tp_0_atrap", "tp_50", "dt_eff"])


def test_flagship_chain_runs_without_jax_or_the_jax_package():
    _run_without_jax(["trapEmax", "tp_0_est", "A_max", "tp_aoe_max", "tp_aoe_samp"])


def test_generic_flagship_runs_without_jax_or_the_jax_package():
    _run_without_jax(["trapEmax", "tp_0_est", "A_max", "tp_aoe_samp", "cuspEmax"],
                     fuse="generic")


_RUN_SIPM_CHAIN = r"""
import json, sys
sys.path.insert(0, {repo!r})
import numpy as np
from dspeed_tpu_torch import build_dsp, lh5

rng = np.random.default_rng(3)
wf = rng.normal(0, 1, (4, 1024)).astype("float32")
t = np.arange(1024)
wf[:, 300:] += (80 * np.exp(-(t[300:] - 300) / 80)).astype("float32")
tb = lh5.Table({{
    "waveform": lh5.WaveformTable(values=wf, t0=0.0, t0_units="ns", dt=16.0,
                                  dt_units="ns"),
}})
out = build_dsp(tb, dsp_config={config!r}, device="cpu")
assert isinstance(out["trigger_pos"], lh5.VectorOfVectors)
assert len(out["energies"]) == 4
print(json.dumps(sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax.")
                        or m == "dspeed_tpu" or m.startswith("dspeed_tpu."))))
print("dspeed_tpu_torch" in sys.modules)
"""


def test_sipm_chain_runs_without_jax_or_the_jax_package():
    """The SiPM chain (VoV outputs, K7's group on its plain walk, the peak
    finder's sweep) with JAX and the JAX package kept off the path: a
    meta-path finder refuses to import either."""
    guard = (
        "import sys, importlib.abc\n"
        "class _Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'dspeed_tpu'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, _Block())\n"
    )
    code = guard + _RUN_SIPM_CHAIN.format(
        repo=REPO, config=os.path.join(REPO, "configs", "sipm-pulse-finding.yaml"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=600)
    assert res.returncode == 0, res.stderr
    *_, modules, imported = res.stdout.strip().splitlines()
    assert json.loads(modules) == []
    assert imported == "True"


def test_sources_cover_the_sipm_modules():
    for mod in ("gaussian_filter1d", "histogram", "histogram_stats", "peak_finding",
                "convolutions"):
        assert os.path.join("dspeed_tpu_torch", "processors", f"{mod}.py") in SOURCES
    with open(os.path.join(PKG, "csrc", "peakdet_scan.cu")) as f:
        src = f.read()
    assert "torch/" not in src and 'extern "C" int dspeed_peakdet_scan' in src


def test_sources_cover_the_generic_modules():
    assert os.path.join("dspeed_tpu_torch", "processors", "_tile_program.py") in SOURCES
    with open(os.path.join(PKG, "csrc", "generic_rows.cu")) as f:
        src = f.read()
    # a plain C interface: no PyTorch headers, built by nvcc alone
    assert "torch/" not in src and 'extern "C" int dspeed_generic_rows' in src


def test_sources_cover_the_a_e_modules():
    for mod in ("windower", "moving_windows", "upsampler", "_poly_plan"):
        assert os.path.join("dspeed_tpu_torch", "processors", f"{mod}.py") in SOURCES


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_neither_jax_nor_the_jax_package(path):
    with open(os.path.join(REPO, path)) as f:
        text = f.read()
    names = []
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert not [n for n in names if _forbidden(n)]
    dynamic = re.findall(r"import_module\(\s*[\"']([\w.]+)", text)
    assert not [n for n in dynamic if _forbidden(n)]


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert "dspeed_tpu_torch" in names
    assert not [n for n in names if _forbidden(n) or n.startswith("tests")]


def test_cuda_without_a_card_raises(monkeypatch):
    from dspeed_tpu_torch import ProcessingChain, build_dsp, lh5

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ProcessingChain(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ProcessingChain()  # the default device is the card
    tb = lh5.Table({"x": lh5.Array(np.zeros(4, "float32"))})
    cfg = {"outputs": ["y"], "processors": {"y": "x + 1"}}
    with pytest.raises(RuntimeError, match="cuda"):
        build_dsp(tb, dsp_config=cfg, device="cuda")
