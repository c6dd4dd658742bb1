"""Temporal-excitation blocks (``Blk``: CE, GTE, LTE, SE).

Port of ``clipspm_tpu/models/backbones/temporal_excitation.py``. ``Blk``
splits the channels into quarters and sends each through one excitation
branch: CE (clip-level channel excitation from frame differences), GTE
(global temporal excitation: temporal convolutions over the spatially
pooled differences), LTE (local temporal convolutions) and SE (dilated
spatial convolutions over the time mean). Each branch gates its input by a
sigmoid. The temporal ResNets of ``backbones/resnet.py``
(``TorchResNet(temporal_blocks=...)``) put them in the trunk.

Frames are NHWC ``[N*T, H, W, C]`` with a static ``seq_len`` ``T``, as in
the JAX package; inside a branch the clips ``[N, T, H, W, C]`` turn to
channels-first for the convolutions. Every BatchNorm is
:class:`~.clip.FP32BatchNorm2d` or ``3d`` (flax's biased running variance,
the statistics in fp32). Module names follow the JAX parameter tree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .clip import FP32BatchNorm2d, FP32BatchNorm3d


def clipify(x: torch.Tensor, seq_len: int) -> torch.Tensor:
    """``[N*T, H, W, C]`` -> ``[N, T, H, W, C]``; frames that do not make
    whole clips of ``seq_len`` raise, as the JAX reshape does."""
    nt = x.shape[0]
    if nt % seq_len:
        raise ValueError(f"{nt} frames are not whole clips of {seq_len}")
    return x.reshape((nt // seq_len, seq_len) + tuple(x.shape[1:]))


def _frame_diff_padded(clips: torch.Tensor) -> torch.Tensor:
    """``x[t+1] - x[t]`` over ``[N, T, ...]``, a zero frame appended."""
    return F.pad(clips[:, 1:] - clips[:, :-1],
                 (0, 0) * (clips.dim() - 2) + (0, 1))


def _to_ncthw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def _to_nthwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


def _temporal_conv(cin: int, cout: int, dilation: int = 1) -> nn.Conv3d:
    """A ``(3, 1, 1)`` convolution over time, "same" padding, no bias."""
    return nn.Conv3d(cin, cout, (3, 1, 1), padding=(dilation, 0, 0),
                     dilation=(dilation, 1, 1), bias=False)


class CE(nn.Module):
    """Clip-level channel excitation: the mean of the padded frame
    differences over T, H and W, a 1x1x1 convolution with a bias, a sigmoid
    gate on the input."""

    def __init__(self, channels: int, seq_len: int = 8):
        super().__init__()
        self.seq_len = seq_len
        self.fc = nn.Conv3d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        clips = clipify(x, self.seq_len)
        diff = _frame_diff_padded(clips).mean(dim=(1, 2, 3), keepdim=True)
        g = _to_nthwc(self.fc(_to_ncthw(diff)))
        return (torch.sigmoid(g) * clips).reshape(x.shape)


class GTE(nn.Module):
    """Global temporal excitation: the spatial mean of the padded frame
    differences, two ``(3, 1, 1)`` temporal convolutions, each followed by
    a BatchNorm over ``[N, T, 1, 1]``, a sigmoid gate on the input."""

    def __init__(self, channels: int, seq_len: int = 8):
        super().__init__()
        self.seq_len = seq_len
        self.conv1 = _temporal_conv(channels, 2 * channels)
        self.bn1 = FP32BatchNorm3d(2 * channels)
        self.conv2 = _temporal_conv(2 * channels, channels)
        self.bn2 = FP32BatchNorm3d(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        clips = clipify(x, self.seq_len)
        diff = _frame_diff_padded(clips).mean(dim=(2, 3), keepdim=True)
        h = F.relu(self.bn1(self.conv1(_to_ncthw(diff))))
        h = _to_nthwc(self.bn2(self.conv2(h)))
        return (torch.sigmoid(h) * clips).reshape(x.shape)


class LTE(nn.Module):
    """Local temporal excitation: a ``(3, 1, 1)`` temporal convolution,
    then one dilated by 2 in time, each followed by a BatchNorm, a sigmoid
    gate on the input."""

    def __init__(self, channels: int, seq_len: int = 8):
        super().__init__()
        self.seq_len = seq_len
        self.conv1 = _temporal_conv(channels, 2 * channels)
        self.bn1 = FP32BatchNorm3d(2 * channels)
        self.conv2 = _temporal_conv(2 * channels, channels, dilation=2)
        self.bn2 = FP32BatchNorm3d(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        clips = clipify(x, self.seq_len)
        h = F.relu(self.bn1(self.conv1(_to_ncthw(clips))))
        h = _to_nthwc(self.bn2(self.conv2(h)))
        return (torch.sigmoid(h) * clips).reshape(x.shape)


class SE(nn.Module):
    """Spatial excitation: the time mean, two 3x3 convolutions dilated by 2,
    each followed by a BatchNorm, a sigmoid gate on every frame."""

    def __init__(self, channels: int, seq_len: int = 8):
        super().__init__()
        self.seq_len = seq_len
        self.conv1 = nn.Conv2d(channels, 2 * channels, 3, padding=2,
                               dilation=2, bias=False)
        self.bn1 = FP32BatchNorm2d(2 * channels)
        self.conv2 = nn.Conv2d(2 * channels, channels, 3, padding=2,
                               dilation=2, bias=False)
        self.bn2 = FP32BatchNorm2d(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        clips = clipify(x, self.seq_len)
        h = clips.mean(dim=1).permute(0, 3, 1, 2)
        h = F.relu(self.bn1(self.conv1(h)))
        h = self.bn2(self.conv2(h)).permute(0, 2, 3, 1)
        return (torch.sigmoid(h)[:, None] * clips).reshape(x.shape)


class Blk(nn.Module):
    """The quarter-channel split: channels ``[0, q)`` through CE, ``[q,
    2q)`` GTE, ``[2q, 3q)`` LTE and the rest SE (``q = C // 4``), the four
    outputs concatenated in that order."""

    def __init__(self, in_channels: int, seq_len: int = 8):
        super().__init__()
        q = in_channels // 4
        self.q = q
        self.ce = CE(q, seq_len)
        self.gte = GTE(q, seq_len)
        self.lte = LTE(q, seq_len)
        self.se = SE(in_channels - 3 * q, seq_len)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.q
        return torch.cat([self.ce(x[..., :q]), self.gte(x[..., q:2 * q]),
                          self.lte(x[..., 2 * q:3 * q]),
                          self.se(x[..., 3 * q:])], dim=-1)
