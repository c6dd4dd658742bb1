"""On the card (skips without one): a traced run of a cell at the port's
test sizes goes through kernel K1 and reads its device layers."""

import pytest

from conftest import tiny_cell
from portbench import harness


@pytest.mark.cuda
def test_traced_run_on_the_card(cuda_device):
    cell = tiny_cell("rn50-eval", "test-tiny-rn")
    out = harness.run_cell(cell, 41, 0.5, True, cuda_device)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
    for name in ("tower_device_ms.eval", "device_idle_share.eval",
                 "k1_roofline.eval", "mfu.eval"):
        assert name in out["metrics"], name
