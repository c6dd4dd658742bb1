"""The plain reference against the port's CPU path at the port's test
sizes, in float32: the text tables, evaluation answers and the checked
training steps, through a whole run of the harness."""

import pytest
import torch

from conftest import tiny_cell
from portbench import harness, inputs, program
from portbench.reference import run as ref

# float32 on both sides: what is left is the order of summation
TIGHT = {"logit_gap": 1e-4, "loss_gap": 1e-5, "loss_gap_first": 1e-5,
         "grad_gap": 1e-4, "change_gap": 1e-2}
NUMBERS = {"evaluate": ("logit_gap", "loss_gap"),
           "train_episodes": ("loss_gap_first", "loss_gap", "grad_gap",
                              "change_gap")}


@pytest.mark.parametrize("backbone", ["test-tiny-rn", "test-tiny"])
def test_text_tables(backbone):
    cell = tiny_cell("rn50-eval", backbone)
    learner = program.build(cell.config, 11, "cpu")
    P = inputs.make_weights(cell.config, 11, "cpu")
    for split, got in (("train", learner.text_train),
                       ("test", learner.text_test)):
        want = ref.text_table(P, cell.config["published"],
                              inputs.class_names(cell.config, split), "cpu")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("workload,backbone", [
    ("rn50-eval", "test-tiny-rn"), ("vit-eval", "test-tiny"),
    ("rn50-train", "test-tiny-rn")])
def test_run_agrees(workload, backbone):
    cell = tiny_cell(workload, backbone)
    limits = {k: TIGHT[k] for k in NUMBERS[cell.traffic["entry"]]}
    out = harness.run_cell(cell, 2 ** 31 + 5, 0.5, False, "cpu",
                           limits=limits)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    rate = [k for k in out["metrics"] if k.endswith("_episodes_per_s")]
    assert rate and "setup_s" in out["metrics"]
    assert list(out)[-1] == "checks"


def test_traced_run_reads_its_layers():
    cell = tiny_cell("rn50-eval", "test-tiny-rn")
    out = harness.run_cell(cell, 3, 0.5, True, "cpu")
    assert out["correct"]
    assert "host_stall_share.eval" in out["metrics"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
