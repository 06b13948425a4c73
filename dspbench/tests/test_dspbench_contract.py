"""BENCHMARK.json against the benchmark's contract, and the harness's
isolation from the JAX package."""

import json
import os
import re
import subprocess
import sys

import pytest

import run

ROOT = run.ROOT
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TEXT = re.compile(r"[^\n\t]{1,200}")
CELLS = ["hpge-icpc.stream-16k"]


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["command"]) <= 32
    assert all(TEXT.fullmatch(w) for w in bench["command"])
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_texts(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and TEXT.fullmatch(c["source"])
        assert TEXT.fullmatch(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.fullmatch(w[k]) for k in ("name", "config", "traffic"))
        assert TEXT.fullmatch(w["why"]) and w["chips"] in (1, 4)
        names.append(w["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert TEXT.fullmatch(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    assert [w["name"] for w in bench["workloads"]] == CELLS


def test_every_name_resolves_to_its_file(bench):
    here = run.HERE
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"] == f"dspbench/configs/{c['name']}.json"
        cfg = run.load_json(ROOT, c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        for sub in (("generators", cfg["generator"]), ("reference", cfg["reference"])):
            assert os.path.isfile(os.path.join(here, sub[0], f"{sub[1]}.py"))
    for w in bench["workloads"]:
        assert os.path.isfile(os.path.join(here, "traffic", f"{w['traffic']}.json"))
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(os.path.join(here, "metrics", f"{m['name']}.py"))
    for m in bench["per_layer"]:
        assert m["moves"] in e2e


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in bench["end_to_end"]}["setup_s"] == 0.25


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "dspeed_tpu_torch_fake.x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dspeed_tpu.fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert run.forbidden_modules() == ["dspeed_tpu", "jaxlib"]


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=300)


def test_harness_loads_no_jax_and_no_jax_package():
    """Every file of the harness, loaded together with the program, in a
    fresh process: no module whose top-level name is forbidden."""
    code = f"""
import glob, os, sys
sys.path[:0] = [{run.HERE!r}, {ROOT!r}]
import run, source, check, tracing
for d in ("metrics", "generators", "reference"):
    for p in sorted(glob.glob(os.path.join({run.HERE!r}, d, "*.py"))):
        run.load_module(p, "m_" + os.path.basename(p)[:-3].replace("-", "_"))
print(run.forbidden_modules())
"""
    res = _python(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("name", ["hpge-icpc", "sipm"])
def test_reference_imports_nothing_of_the_program(name):
    code = f"""
import importlib.util, sys
spec = importlib.util.spec_from_file_location("r", {os.path.join(run.HERE, "reference", name + ".py")!r})
m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)
print(sorted({{k.split(".")[0] for k in sys.modules}} & {{"dspeed_tpu_torch", "dspeed_tpu", "jax"}}))
"""
    res = _python(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_a_run_without_a_card_fails_and_prints_no_result():
    res = subprocess.run(
        [sys.executable, "dspbench/run.py", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert res.returncode != 0
    assert "correct" not in res.stdout
