"""Torchvision-style ResNet trunk for the non-CLIP heads.

Port of ``clipspm_tpu/models/backbones/resnet.py``: the torchvision v1
topology (7x7/2 stem conv + BN + ReLU + 3x3/2 max-pool, then four stages of
bottleneck or basic blocks with the stride on the 3x3 conv), truncated
before the classifier. ``output="spatial"`` keeps the last feature map,
``output="pooled"`` averages it. Modules carry torchvision's state-dict
names (``conv1``, ``bn1``, ``layer1.0.conv1``, ``layer2.0.downsample.0``
...), so a torchvision checkpoint loads by name.

Frames are NHWC ``[N, H, W, 3]`` at the public functions and NCHW only
inside the trunk (the permuted view keeps NHWC strides, which cuDNN runs as
channels-last); the spatial output is NHWC ``[N, h, w, C]``. BatchNorm
computes in fp32 whatever the compute dtype, so the trunk's output is fp32
under bf16 autocast, as the JAX trunk's is. The trunk is a ``GraphedTower``
(``models/tower_graph.py``): in evaluation on the card a call replays a CUDA
graph of ``tower_forward``, the eager body.

``temporal_blocks`` gives the reference's experimental temporal ResNets:
``"bottleneck"`` a temporal-excitation ``Blk`` (``temporal_excitation.py``)
in every bottleneck (``blk``, then ``bn4`` and a ReLU, after the 3x3 conv),
``"stage"`` one ``Blk`` after stage 2 and one after stage 3 (``blk_1``,
``blk_2``). Their frames are whole clips of ``seq_len``.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from ..tower_graph import GraphedTower
from .clip import FP32BatchNorm2d
from .temporal_excitation import Blk

RESNET_LAYERS = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
}
BASIC_BLOCK_ARCHS = ("resnet18", "resnet34")


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(OrderedDict([("0", _conv(cin, cout, 1, stride)),
                                      ("1", FP32BatchNorm2d(cout))]))


def blk_nchw(blk: Blk, x: torch.Tensor) -> torch.Tensor:
    """A ``Blk`` (NHWC frames) inside the channels-first trunk."""
    return blk(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class TVBottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 -> 3x3(stride) -> 1x1, expansion 4.
    ``temporal``: ``relu(bn4(blk(h)))`` after the 3x3 conv (the reference's
    ``newBottleneck``)."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 temporal: bool = False, seq_len: int = 8):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = FP32BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = FP32BatchNorm2d(planes)
        if temporal:
            self.blk = Blk(planes, seq_len)
            self.bn4 = FP32BatchNorm2d(planes)
        self.conv3 = _conv(planes, out_ch, 1)
        self.bn3 = FP32BatchNorm2d(out_ch)
        self.downsample = (_downsample(inplanes, out_ch, stride)
                           if stride != 1 or inplanes != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        if hasattr(self, "blk"):
            h = F.relu(self.bn4(blk_nchw(self.blk, h)))
        h = self.bn3(self.conv3(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class TVBasicBlock(nn.Module):
    """torchvision BasicBlock: 3x3(stride) -> 3x3, expansion 1."""
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = FP32BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = FP32BatchNorm2d(planes)
        self.downsample = (_downsample(inplanes, planes, stride)
                           if stride != 1 or inplanes != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class TorchResNet(GraphedTower):
    """ResNet trunk; ``output``: "spatial" -> ``[N, H/32, W/32, C]``,
    "pooled" -> ``[N, C]``.

    ``temporal_blocks``: "none"; "bottleneck", a ``Blk`` in every
    bottleneck (the reference's ``resnet50_1``; a basic-block arch takes
    none, as in the JAX package); "stage", ``blk_1`` and ``blk_2`` after
    stages 2 and 3 (``resnet50_2``). Frames then come in whole clips of
    ``seq_len``.
    """

    graph_switches = ("fp32", "affine", "track_running_stats", "ceil_mode",
                      "return_indices", "transposed")

    def __init__(self, arch: str = "resnet50", output: str = "spatial",
                 width: int = 64, temporal_blocks: str = "none",
                 seq_len: int = 8):
        super().__init__()
        if temporal_blocks not in ("none", "bottleneck", "stage"):
            raise ValueError(f"temporal_blocks must be 'none', 'bottleneck' "
                             f"or 'stage', got {temporal_blocks!r}")
        if arch not in RESNET_LAYERS:
            raise ValueError(f"unknown ResNet arch {arch!r}")
        if output not in ("spatial", "pooled"):
            raise ValueError(f"output must be 'spatial' or 'pooled', got "
                             f"{output!r}")
        self.arch, self.output, self.width = arch, output, width
        self.temporal_blocks = temporal_blocks
        basic = arch in BASIC_BLOCK_ARCHS
        block = TVBasicBlock if basic else TVBottleneck
        extra = ({} if basic else dict(
            temporal=temporal_blocks == "bottleneck", seq_len=seq_len))
        self.conv1 = _conv(3, width, 7, stride=2)
        self.bn1 = FP32BatchNorm2d(width)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = width
        for stage, blocks in enumerate(RESNET_LAYERS[arch]):
            planes = width * 2 ** stage
            mods = []
            for b in range(blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                mods.append(block(inplanes, planes, stride, **extra))
                inplanes = planes * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*mods))
            if temporal_blocks == "stage" and stage in (1, 2):
                self.add_module(f"blk_{stage}", Blk(inplanes, seq_len))

    @property
    def feature_dim(self) -> int:
        mult = 1 if self.arch in BASIC_BLOCK_ARCHS else 4
        return self.width * 8 * mult

    def tower_forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``[N, H, W, 3]`` -> ``[N, h, w, C]`` or ``[N, C]``."""
        x = x.permute(0, 3, 1, 2)
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
            if self.temporal_blocks == "stage" and stage in (2, 3):
                x = blk_nchw(getattr(self, f"blk_{stage - 1}"), x)
        if self.output == "pooled":
            return x.mean(dim=(2, 3))
        return x.permute(0, 2, 3, 1)
