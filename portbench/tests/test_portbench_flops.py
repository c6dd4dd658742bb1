"""The FLOP and bound arithmetic of ``flops.py`` against hand counts and
against ``torch.utils.flop_counter`` over the plain reference."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT, TINY
from portbench import flops, inputs
from portbench.reference import clip


def _config(name):
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_conv_and_vit_by_hand():
    assert flops._conv(3, 4, 3, 2) == 2 * 3 * 4 * 9 * 4
    # test-tiny: 16 patches of 8x8x3 into width 64, 17 tokens, 2 layers,
    # projection to 32
    patch = 2 * 16 * 3 * 64 * 64
    layer = 24 * 17 * 64 * 64 + 4 * 17 * 17 * 64
    assert flops.vit_frame_flops(TINY["test-tiny"]) == \
        patch + 2 * layer + 2 * 64 * 32


def test_rn_by_hand():
    # test-tiny-rn at 32 px: stem at 16x16, blocks at 8, 4, 2, 1
    a = TINY["test-tiny-rn"]
    c = flops._conv
    f = c(3, 4, 3, 16) + c(4, 4, 3, 16) + c(4, 8, 3, 16)
    f += c(8, 8, 1, 8) + c(8, 8, 3, 8) + c(8, 32, 1, 8) + c(8, 32, 1, 8)
    for inp, planes, h in ((32, 16, 8), (64, 32, 4), (128, 64, 2)):
        f += c(inp, planes, 1, h) + c(planes, planes, 3, h) \
            + c(planes, 4 * planes, 1, h // 2) + c(inp, 4 * planes, 1, h // 2)
    C, n = 256, 2
    f += 2 * C * C + 4 * n * C * C + 4 * n * C + 2 * C * 64
    assert flops.rn_frame_flops(a) == f


@pytest.mark.parametrize("arch", ["test-tiny-rn", "test-tiny", "clipspm-rn50",
                                  "clipspm-vit-b16"])
def test_towers_against_the_flop_counter(arch):
    a = TINY[arch] if arch in TINY else _config(arch)["published"]
    P = {n: torch.zeros(s, device="meta") for n, s, _, _ in
         clip.visual_specs(a)}
    x = torch.zeros(2, a["image"], a["image"], 3, device="meta")
    with FlopCounterMode(display=False) as counter:
        clip.visual(x, P, a)
    assert counter.get_total_flops() == 2 * flops.frame_flops(a)


def test_published_towers():
    # github.com/openai/CLIP's RN50 is about 5.8 GMAC a 224-px frame, its
    # ViT-B/16 about 17.6
    assert 11.5e9 < flops.frame_flops(_config("clipspm-rn50")["published"]) \
        < 11.7e9
    assert 35.0e9 < flops.frame_flops(
        _config("clipspm-vit-b16")["published"]) < 35.2e9


def test_episode_flops_adds_the_head():
    conf = _config("clipspm-rn50")
    t = {"way": 5, "shot": 5, "queries": 1}
    head = flops.head_flops(conf, 1)
    assert 0 < head < 0.02 * 240 * flops.frame_flops(conf["published"])
    assert flops.episode_flops(conf, t) == \
        240 * flops.frame_flops(conf["published"]) + head


def test_k1_bound_by_hand():
    # Q = S = 5, L = 8, D = 1024, both directions
    ops = 2 * 25 * 64 * 1024 + 2 * 10 * 8 * 1024 + 2 * 25 * (8 + 7 * 9 * 15)
    by = 4 * 10 * 8 * 1024 + 4 * 25
    b = flops.bound_ms(by, ops)
    assert b["by"] == "bytes"
    assert b["ms"] == pytest.approx(by / 3.35e12 * 1e3)
    assert flops.otam_fused_bound_ms(5, 5, 8, 1024) == b["ms"]
    assert flops.otam_dp_ops(25, 8, 8) == 25 * 953


def test_weights_cover_the_reference():
    conf = _config("clipspm-rn50")
    names = [n for n, *_ in inputs.weight_specs(conf)]
    assert len(names) == len(set(names))
    assert sum(1 for n in names if n.startswith("head.")) == 40
