"""Small cells on the CPU for the benchmark's tests."""

import run

SMALL = {"buffer_len": 16, "events_per_file": 64, "file_offset_step": 5}


def named_cell(name: str) -> tuple:
    """(BENCHMARK.json, cell entry, configuration, traffic) of the cell
    ``<config>.<traffic>``, whether or not BENCHMARK.json lists it: the
    configurations and mixes kept for later cells are tested too."""
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    config, traffic = name.split(".", 1)
    cell = next((w for w in bench["workloads"] if w["name"] == name),
                {"name": name, "config": config, "traffic": traffic, "chips": 1})
    return (bench, cell, run.load_json(run.HERE, "configs", f"{config}.json"),
            run.load_json(run.HERE, "traffic", f"{traffic}.json"))


def small_cell(workload: str, seed: int = 20261018, **traffic):
    """(BENCHMARK.json, cell entry, Cell on the CPU with a shrunk traffic
    mix, set up)."""
    bench, cell, cfg, tr = named_cell(workload)
    c = run.Cell(cfg, dict(tr, **{**SMALL, **traffic}), seed, device="cpu")
    c.setup()
    return bench, cell, c
