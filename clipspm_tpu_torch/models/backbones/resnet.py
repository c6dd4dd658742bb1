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
under bf16 autocast, as the JAX trunk's is.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from .clip import FP32BatchNorm2d

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


class TVBottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 -> 3x3(stride) -> 1x1, expansion 4."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = FP32BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = FP32BatchNorm2d(planes)
        self.conv3 = _conv(planes, out_ch, 1)
        self.bn3 = FP32BatchNorm2d(out_ch)
        self.downsample = (_downsample(inplanes, out_ch, stride)
                           if stride != 1 or inplanes != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
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


class TorchResNet(nn.Module):
    """ResNet trunk; ``output``: "spatial" -> ``[N, H/32, W/32, C]``,
    "pooled" -> ``[N, C]``.

    ``temporal_blocks`` other than "none" (the reference's experimental
    temporal ResNets, dead code in the JAX package) is not ported.
    """

    def __init__(self, arch: str = "resnet50", output: str = "spatial",
                 width: int = 64, temporal_blocks: str = "none"):
        super().__init__()
        if temporal_blocks != "none":
            raise NotImplementedError(
                f"temporal_blocks={temporal_blocks!r} (the experimental "
                "temporal ResNets) is not ported (ROADMAP.md, open item "
                "'opt-in extras')")
        if arch not in RESNET_LAYERS:
            raise ValueError(f"unknown ResNet arch {arch!r}")
        if output not in ("spatial", "pooled"):
            raise ValueError(f"output must be 'spatial' or 'pooled', got "
                             f"{output!r}")
        self.arch, self.output, self.width = arch, output, width
        block = TVBasicBlock if arch in BASIC_BLOCK_ARCHS else TVBottleneck
        self.conv1 = _conv(3, width, 7, stride=2)
        self.bn1 = FP32BatchNorm2d(width)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = width
        for stage, blocks in enumerate(RESNET_LAYERS[arch]):
            planes = width * 2 ** stage
            mods = []
            for b in range(blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                mods.append(block(inplanes, planes, stride))
                inplanes = planes * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*mods))

    @property
    def feature_dim(self) -> int:
        mult = 1 if self.arch in BASIC_BLOCK_ARCHS else 4
        return self.width * 8 * mult

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``[N, H, W, 3]`` -> ``[N, h, w, C]`` or ``[N, C]``."""
        x = x.permute(0, 3, 1, 2)
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
        if self.output == "pooled":
            return x.mean(dim=(2, 3))
        return x.permute(0, 2, 3, 1)
