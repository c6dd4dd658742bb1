"""The control, the reference computed in float8 (one precision below the
configurations' bf16) put in the program's place, reads further from the
float32 reference than the program under bf16 does, on a number that the
cell compares. At the port's test sizes on the CPU, on one seed: there
the float8 error is smaller than at the cells' widths, so the cells'
limits, set from readings on the card, are not what is held here."""

import pytest
import torch

from conftest import tiny_cell
from portbench import compare, harness, inputs
from portbench.reference import precision

CASES = [("rn50-eval", "test-tiny-rn"), ("vit-eval", "test-tiny"),
         ("rn50-train", "test-tiny-rn")]


@pytest.mark.parametrize("workload,backbone", CASES)
def test_the_control_reads_beyond_the_program(workload, backbone):
    seed = 31
    cell = tiny_cell(workload, backbone, amp=True)
    program = {k: c["value"] for k, c in harness.run_cell(
        cell, seed, 0.3, False, "cpu")["checks"].items()}
    ent = harness.entry(cell.traffic["entry"])
    pool = inputs.make_episodes(
        cell.traffic, len(inputs.class_names(cell.config, ent.SPLIT)), seed,
        "cpu")
    control = ent.control(harness.reference_inputs(cell, pool, seed, "cpu"),
                          precision.fp8)
    compared = compare.limits(workload)
    assert any(control[k] > 2 * program[k] for k in compared), (
        program, control)


def test_fp8_rounds_and_passes_gradients():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = precision.fp8(x)
    # e4m3 keeps 3 bits of mantissa: a relative step of 2^-3 at most
    rel = ((y - x).abs() / x.abs().clamp(min=1e-3)).max()
    assert 0 < float(rel) <= 2 ** -4 + 1e-6
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones(101))
