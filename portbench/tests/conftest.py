"""Shared fixtures of the benchmark's tests: the checkout's root on the
path, tiny variants of the cells for the CPU, and the card (decided inside
a fixture, never while a module is imported)."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the port's test archs as the reference's published blocks
TINY = {
    "test-tiny-rn": {"vision": "rn", "embed_dim": 64, "image": 32,
                     "vision_layers": [1, 1, 1, 1], "vision_width": 8,
                     "vision_heads": 4, "patch": None, "context_length": 16,
                     "vocab_size": 600, "text_width": 32, "text_heads": 2,
                     "text_layers": 2},
    "test-tiny": {"vision": "vit", "embed_dim": 32, "image": 32,
                  "vision_layers": 2, "vision_width": 64, "vision_heads": 1,
                  "patch": 8, "context_length": 16, "vocab_size": 600,
                  "text_width": 32, "text_heads": 2, "text_layers": 2},
}


def tiny_cell(workload: str, backbone: str, amp: bool = False):
    """``workload`` of ``BENCHMARK.json`` at a size the CPU holds: the
    backbone one of ``TINY``, 32-px crops of 96-px frames, two episodes a
    step, pools of four (evaluation) and six (training) episodes; fp32
    unless ``amp``."""
    from portbench import harness

    cell = harness.find_cell(workload)
    conf = copy.deepcopy(cell.config)
    conf["published"] = TINY[backbone]
    pc = conf["port_config"]
    pc["MODEL"]["BACKBONE"] = backbone
    pc["DATA"]["IMG_SIZE"] = 32
    pc["USE_AMP"] = amp
    t = copy.deepcopy(cell.traffic)
    t["frame_px"] = 96
    if t["entry"] == "evaluate":
        t.update(episodes_per_step=2, pool=4, checked=3, trace_steps=1)
    else:
        pc["TRAIN"]["TASKS_PER_BATCH"] = 2
        t.update(episodes_per_step=2, pool=6, checked_steps=3, trace_steps=1)
    cell.config, cell.traffic = conf, t
    return cell


@pytest.fixture
def cuda_device():
    """The card, or a skip."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device visible: this case runs on the card")
    return "cuda"


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
