"""Each configuration's plain reference against the port on the CPU, through
the harness's own window and comparison, at 64 events a file."""

import pytest

from bench_helpers import small_cell

# float32 columns against a float64 reference: a median gap of a few float32
# roundings of the column's scale; the SiPM chain runs in float64
GAP = {"hpge-icpc.stream-16k": 1e-5, "sipm.stream-16k": 1e-12}


@pytest.mark.parametrize("workload", sorted(GAP))
def test_reference_agrees_with_the_port(workload):
    _, _, c = small_cell(workload)
    c.window(0.0)
    assert len(c.outputs) == 1
    numbers = c.compare()
    assert c.comparison.events == 64
    assert numbers["bad_share"] == 0.0
    assert numbers["energy_gap"] < GAP[workload]
