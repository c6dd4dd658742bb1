"""A run with its timed path broken underneath comes out not correct, once
for each fault the cell can have; the same run unbroken comes out
correct. At the port's test sizes on the CPU, in float32, under each
cell's own limits."""

import pytest

from conftest import tiny_cell
from portbench import faults, harness

CASES = [("rn50-eval", "test-tiny-rn"), ("vit-eval", "test-tiny"),
         ("rn50-train", "test-tiny-rn")]


@pytest.mark.parametrize("workload,backbone", CASES)
def test_unbroken_run_is_correct(workload, backbone):
    out = harness.run_cell(tiny_cell(workload, backbone), 21, 0.5, False,
                           "cpu")
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("workload,backbone,fault", [
    (w, b, f) for w, b in CASES
    for f in harness.entry(harness.find_cell(w).traffic["entry"]).FAULTS])
def test_fault_is_caught(workload, backbone, fault):
    out = harness.run_cell(tiny_cell(workload, backbone), 21, 0.5, False,
                           "cpu", plant=faults.FAULTS[fault])
    assert not out["correct"], out["checks"]
