"""The comparison rejects a broken timed path: the harness's window and
comparison on the CPU (no look for a card), with each fault of
``faults.py`` planted in the program where a chunk's outputs are fetched,
and the control (the reference in the next lower precision) in the
program's place, in every chunk or in one."""

import numpy as np
import pytest
import torch

import control
import faults
import run
from bench_helpers import SMALL, named_cell

CELLS = ["hpge-icpc.stream-16k", "sipm.stream-16k"]
BENCH_CELLS = [w["name"] for w in named_cell(CELLS[0])[0]["workloads"]]
FAULTS = [(w, k) for w in CELLS for k in faults.kinds(named_cell(w)[2]["check"])]


@pytest.mark.parametrize("workload,kind", FAULTS)
def test_a_broken_timed_path_is_not_correct(workload, kind):
    bench, cell, cfg, traffic = named_cell(workload)
    spec = cfg["check"]
    assert all(v is not None for v in spec["limits"].values())
    per_file = SMALL["events_per_file"] // SMALL["buffer_len"]
    with faults.planted(kind, spec, per_file):
        result = run.measure(bench, cell, cfg, dict(traffic, **SMALL), seed=11, seconds=0.0,
                             trace=False, device="cpu")
    assert result["correct"] is False, result["checks"]
    # each of these faults strikes whole events: bad_share fails by itself
    share = result["checks"]["bad_share"]
    assert share["value"] > share["limit"], result["checks"]
    assert result["attempted"] == SMALL["events_per_file"]
    assert list(result)[-1] == "checks"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", BENCH_CELLS)
def test_a_sound_run_on_the_card_is_correct(workload):
    """The whole harness on the card, a short window: correct, every metric."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json
    import subprocess
    import sys

    res = subprocess.run(
        [sys.executable, "dspbench/run.py", "--workload", workload, "--seed", "4242",
         "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, cwd=run.ROOT, timeout=900,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0


def _control_numbers(workload: str, device: str, one: bool = False, n_files: int = 4):
    """The control's numbers over ``n_files`` files of 1024 events, in every
    chunk or (``one``) in the middle chunk of each file alone."""
    _, _, cfg, traffic = named_cell(workload)
    spec = cfg["check"]
    tr = dict(traffic, buffer_len=256, events_per_file=1024, file_offset_step=37)
    c = run.Cell(cfg, tr, 7, device=device)
    pool = run.make_pool(cfg, c.n_file + c.bl, 7, device)
    ref = run.reference(cfg, pool, device)
    ctl = run.reference(cfg, pool, device, precision=spec["control"])
    from check import Comparison

    cmp = Comparison(ref, spec, c.bl)
    for k in range(1, n_files + 1):
        lo = c.offset(k)
        if one:
            out = control.as_table(control.one_chunk(ref, ctl, lo, c.n_file, c.bl), spec, 0,
                                   c.n_file)
        else:
            out = control.as_table(ctl, spec, lo, c.n_file)
        cmp.add_file(out, lo)
    return cmp.numbers(), spec["limits"]


@pytest.mark.parametrize("one", [False, True], ids=["every_chunk", "one_chunk"])
def test_float32_control_of_the_sipm_chain_is_not_correct(one):
    numbers, limits = _control_numbers("sipm.stream-16k", "cpu", one)
    assert not run.judge(numbers, limits)[0], numbers


@pytest.mark.gpu
@pytest.mark.parametrize("one", [False, True], ids=["every_chunk", "one_chunk"])
def test_tf32_control_of_the_hpge_chain_is_not_correct(one):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    numbers, limits = _control_numbers("hpge-icpc.stream-16k", "cuda", one)
    assert not run.judge(numbers, limits)[0], numbers


def test_the_reference_in_the_programs_place_is_correct():
    """The comparison of the reference with itself reads 0, in every chunk,
    with the middle chunk taken from a copy."""
    _, _, cfg, _ = named_cell("sipm.stream-16k")
    spec = cfg["check"]
    pool = run.make_pool(cfg, 80, 3, "cpu")
    ref = run.reference(cfg, pool, "cpu")
    from check import Comparison

    sound = Comparison(ref, spec, 16)
    sound.add_file(control.as_table(control.one_chunk(ref, ref, 5, 64, 16), spec, 0, 64), 5)
    assert sound.numbers() == {"bad_share": 0.0, "energy_gap": 0.0}
    assert np.isfinite(list(sound.worst.values())).all()
