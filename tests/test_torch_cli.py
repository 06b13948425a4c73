"""The port's CLI (``python -m dspeed_tpu_torch.cli``) by subprocess, with
``--device cpu``, mirroring ``tests/test_cli.py``; and its output against
the JAX package's CLI on the same file, by ``torch_flagship``'s column
rule."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_build_dsp import make_hpge_waveforms  # noqa: E402
from torch_flagship import assert_timing_columns, flagship_config  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "hpge-energy-timing.yaml")


def _write_raw(tmp_path, n=16):
    from dspeed_tpu_torch import lh5

    wf, amp, _t0, bl = make_hpge_waveforms(n=n)
    raw = str(tmp_path / "run1_raw.lh5")
    tb = lh5.Table({
        "waveform": lh5.WaveformTable(
            values=wf, t0=0.0, t0_units="ns", dt=16.0, dt_units="ns"
        ),
        "baseline": lh5.Array(bl.astype("float32")),
    })
    lh5.write(tb, "ch0/raw", raw)
    db = str(tmp_path / "db.json")
    with open(db, "w") as f:
        json.dump({"ch0": {"pz": {"tau": 27460.5}}}, f)
    return raw, db, amp


def _cli(args, module="dspeed_tpu_torch.cli", device=("--device", "cpu"),
         env=(), **kw):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **dict(env))
    return subprocess.run(
        [sys.executable, "-m", module, *args, *device],
        capture_output=True, text=True, env=env, timeout=600, **kw,
    )


def _read(path, outputs, group="ch0/dsp"):
    import h5py

    with h5py.File(path, "r") as f:
        return {k: f[f"{group}/{k}"][()] for k in outputs}


def test_cli_end_to_end(tmp_path):
    raw, db, amp = _write_raw(tmp_path)
    out = str(tmp_path / "out_dsp.lh5")
    res = _cli([raw, "-c", CONFIG, "-D", db, "-o", out, "-p", "trapEmax", "-n", "8"])
    assert res.returncode == 0, res.stderr[-2000:]
    got = _read(out, ["trapEmax"])["trapEmax"]
    assert len(got) == 8
    np.testing.assert_allclose(got, amp[:8], rtol=1e-2)


def test_cli_version():
    res = _cli(["--version"], device=())
    assert res.returncode == 0
    from dspeed_tpu_torch import __version__

    assert res.stdout.strip() == __version__


def test_cli_help_names_the_port_options():
    res = _cli(["--help"], device=())
    assert res.returncode == 0
    for opt in ("--device", "--fuse", "--chunk", "--update", "--checked"):
        assert opt in res.stdout, opt


def test_cli_default_overwrite_and_api_refusal(tmp_path):
    """The CLI defaults to overwrite (reference ``cli.py:129``); the bare
    ``build_dsp`` API with ``write_mode=None`` refuses an existing file."""
    from dspeed_tpu_torch import build_dsp

    raw, db, _ = _write_raw(tmp_path)
    out = str(tmp_path / "out_dsp.lh5")
    for _ in range(2):
        res = _cli([raw, "-c", CONFIG, "-D", db, "-o", out, "-p", "trapEmax"])
        assert res.returncode == 0, res.stderr[-2000:]
    with pytest.raises(FileExistsError):
        build_dsp(raw, out, CONFIG, database=json.load(open(db)), device="cpu")


def test_cli_overwrite_and_update(tmp_path):
    raw, db, amp = _write_raw(tmp_path)
    out = str(tmp_path / "out_dsp.lh5")
    res = _cli([raw, "-c", CONFIG, "-D", db, "-o", out, "-p", "trapEmax", "bl_mean"])
    assert res.returncode == 0, res.stderr[-2000:]
    res = _cli([raw, "-c", CONFIG, "-D", db, "-o", out, "-w", "-p", "trapEmax",
                "bl_mean"])
    assert res.returncode == 0, res.stderr[-2000:]
    res = _cli([raw, "-c", CONFIG, "-D", db, "-o", out, "-u", "-p", "bl_std"])
    assert res.returncode == 0, res.stderr[-2000:]
    got = _read(out, ["trapEmax", "bl_mean", "bl_std"])
    np.testing.assert_allclose(got["trapEmax"], amp, rtol=1e-2)
    assert len(got["bl_std"]) == len(amp)


def test_cli_group_wildcard(tmp_path):
    raw, db, amp = _write_raw(tmp_path)
    out = str(tmp_path / "wild_dsp.lh5")
    res = _cli([raw, "-c", CONFIG, "-D", db, "-o", out, "-g", "ch*", "-p", "trapEmax"])
    assert res.returncode == 0, res.stderr[-2000:]
    np.testing.assert_allclose(_read(out, ["trapEmax"])["trapEmax"], amp, rtol=1e-2)


def test_cli_default_output_name(tmp_path):
    raw, db, _ = _write_raw(tmp_path)
    res = _cli([raw, "-c", CONFIG, "-D", db, "-p", "trapEmax"], cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-2000:]
    assert os.path.isfile(tmp_path / "run1_dsp.lh5")


def test_cli_bad_config_errors(tmp_path):
    raw, db, _ = _write_raw(tmp_path)
    bad = str(tmp_path / "bad.yaml")
    with open(bad, "w") as f:
        f.write("outputs: [nope]\nprocessors: {}\n")
    res = _cli([raw, "-c", bad, "-o", str(tmp_path / "x_dsp.lh5")])
    # unknown output must not silently succeed with data
    assert res.returncode != 0 or "nope" in (res.stderr + res.stdout)


def test_cli_without_a_card_raises(tmp_path):
    """The default device is the card: with none, the CLI fails rather than
    running on the CPU."""
    raw, db, _ = _write_raw(tmp_path)
    code = (
        "import sys, torch; torch.cuda.is_available = lambda: False; "
        "from dspeed_tpu_torch.cli import dspeed_cli; dspeed_cli(sys.argv[1:])"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", code, raw, "-c", CONFIG, "-D", db, "-o",
         str(tmp_path / "x_dsp.lh5"), "-p", "trapEmax"],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert not os.path.exists(tmp_path / "x_dsp.lh5")


@pytest.mark.parametrize("fuse", ["true", "generic"])
def test_cli_matches_the_jax_cli(tmp_path, fuse):
    """The whole flagship (34 columns) in chunks of 12 (the last one short)
    through both CLIs on the same file; ``--fuse generic`` against the JAX
    package's ``DSPEED_TPU_FUSE=generic``. The JAX CLI runs with x64 on, as
    the test suite runs the JAX package (``tests/conftest.py``): its
    float32 run puts ``pz_slope`` ~1e-5 from the float64 chain's, the
    port's within 5e-7."""
    raw, db, _ = _write_raw(tmp_path, n=40)
    out_t = str(tmp_path / "t_dsp.lh5")
    out_j = str(tmp_path / "j_dsp.lh5")
    res = _cli([raw, "-c", CONFIG, "-D", db, "-o", out_t, "-k", "12",
                "--fuse", fuse])
    assert res.returncode == 0, res.stderr[-2000:]
    env = {"JAX_ENABLE_X64": "1"}
    if fuse == "generic":
        env["DSPEED_TPU_FUSE"] = "generic"
    res = _cli([raw, "-c", CONFIG, "-D", db, "-o", out_j, "-k", "12"],
               module="dspeed_tpu.cli", device=(), env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    outputs = flagship_config()["outputs"]
    assert_timing_columns(_read(out_t, outputs), _read(out_j, outputs))
