"""SOAP head: pixel-space priors before the trunk, then TRX matching.

Port of ``clipspm_tpu/models/heads/soap.py``. Three excitation modules run
on the ``[N, T, H, W, 3]`` pixels before the backbone (``SOAPPrior``): a
3-D conv gate over the channel-mean volume, a channel squeeze-excite with a
temporal conv, and ``HMEM``, multi-horizon frame differences mixed back to
T frames by ``hm_lin``. Then the trunk's pooled frames feed the TRX
cross-transformers, and ``t_loss`` penalises the spread of the support
videos by ``exp(-lmd * mean_pairwise_distance^2)`` (``lmd`` is learned and
starts at 0.5). The priors need the pixels of every episode, so the model
has no ``feature_cacheable`` and evaluates through the uncached evaluator.
No kernel. The convolutions run channels-first views of the channels-last
clips.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ...utils.precision import fp32_or_wider
from ..backbones.resnet import TorchResNet
from ..blocks import conv2d_nhwc
from ..visual import compute_autocast, encode_frames, fp32_context
from .trx import TemporalCrossTransformer


def soap_t_loss(support_video_means: torch.Tensor, lmd: torch.Tensor
                ) -> torch.Tensor:
    """``exp(-lmd * m^2)``, ``m`` the mean over all ``S x S`` pairs of the
    support videos' distances (the diagonal counted as 0); x: ``[S, D]``
    per-video means."""
    x = fp32_or_wider(support_video_means)
    diff = x[:, None, :] - x[None, :, :]
    dist = torch.sqrt((diff ** 2).sum(dim=-1).clamp_min(1e-12))
    mask = 1.0 - torch.eye(x.shape[0], dtype=dist.dtype, device=dist.device)
    return torch.exp(-lmd * (dist * mask).mean() ** 2)


class HMEM(nn.Module):
    """Frame differences over one horizon ``h``: ``[N, T, H, W, C]`` ->
    ``[N, h * (T - h), H, W, C]``, the windows of ``conv(x) - x`` in
    reversed order of their start."""

    def __init__(self, horizon: int, channels: int = 3):
        super().__init__()
        self.horizon = horizon
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, T = x.shape[:2]
        conv_f = conv2d_nhwc(self.conv, x.flatten(0, 1)).reshape(x.shape)
        h = self.horizon
        return torch.cat([conv_f[:, i: i + h] - x[:, i: i + h]
                          for i in reversed(range(T - h))], dim=1)


class SOAPPrior(nn.Module):
    """The three pixel priors: ``[N, T, H, W, 3]`` -> the same shape,
    ``clips + tdem + cwem + hmem``. ``hm_lin`` maps the horizons' frame
    count back to T."""

    def __init__(self, seq_len: int, horizons: Sequence[int] = (2, 3),
                 cr: int = 16, channels: int = 3):
        super().__init__()
        self.horizons = tuple(horizons)
        self.conv_st = nn.Conv3d(1, 1, 3, padding=1, bias=False)
        self.conv_ch1 = nn.Linear(channels, cr, bias=False)
        self.conv_ch_1d = nn.Conv1d(cr, cr, 3, padding=1)
        self.conv_ch2 = nn.Linear(cr, channels, bias=False)
        for h in self.horizons:
            self.add_module(f"hmem_{h}", HMEM(h, channels))
        f_cnt = sum(h * (seq_len - h) for h in self.horizons)
        self.hm_lin = nn.Linear(f_cnt, seq_len)

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        N, T = clips.shape[:2]
        # TDEM: a 3-D conv gate over (T, H, W) of the channel mean
        vol = clips.mean(dim=-1)[:, None]               # [N, 1, T, H, W]
        f = self.conv_st(vol)[:, 0, ..., None]          # [N, T, H, W, 1]
        tdem = torch.sigmoid(f) * clips + clips
        # CWEM: squeeze-excite with a conv over T
        g = self.conv_ch1(clips.mean(dim=(2, 3)))       # [N, T, cr]
        g = self.conv_ch_1d(g.transpose(1, 2)).transpose(1, 2)
        g = self.conv_ch2(g)                            # [N, T, C]
        cwem = torch.sigmoid(g)[:, :, None, None, :] * clips + clips
        # HMEM: multi-horizon differences mixed back to T frames
        feats = torch.cat([getattr(self, f"hmem_{h}")(clips)
                           for h in self.horizons], dim=1)
        mixed = self.hm_lin(feats.reshape(N, feats.shape[1], -1)
                            .transpose(1, 2))            # [N, HWC, T]
        mixed = mixed.transpose(1, 2).reshape(clips.shape)
        gate = torch.sigmoid(mixed.mean(dim=(2, 3)))[:, :, None, None, :]
        hmem = gate * clips + clips
        return clips + tdem + cwem + hmem


class SOAPModel(nn.Module):
    """Pixel priors (``tripel_prior``) + ResNet trunk (pooled output) +
    one TRX cross-transformer per cardinality (``tct_<n>``) + the learned
    ``lmd``. Returns dict(logits=``[1, Q, way]``, t_loss=scalar)."""

    def __init__(self, way: int, shot: int, seq_len: int = 8,
                 temp_set: Sequence[int] = (2,), out_dim: int = 1152,
                 horizons: Sequence[int] = (2, 3), cr: int = 16,
                 arch: str = "resnet50", backbone_width: int = 64,
                 dropout: float = 0.1, encode_chunk: int = 0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.way, self.shot, self.seq_len = way, shot, seq_len
        self.temp_set = tuple(temp_set)
        self.encode_chunk, self.compute_dtype = encode_chunk, compute_dtype
        self.tripel_prior = SOAPPrior(seq_len, horizons, cr)
        self.backbone = TorchResNet(arch=arch, output="pooled",
                                    width=backbone_width)
        for s in self.temp_set:
            self.add_module(f"tct_{s}", TemporalCrossTransformer(
                way, shot, seq_len, self.backbone.feature_dim, out_dim, s,
                dropout))
        self.lmd = nn.Parameter(torch.full((), 0.5))

    def forward(self, support_images, target_images, support_labels,
                real_support_labels=None, real_target_labels=None,
                text_train=None, text_test=None) -> Dict[str, torch.Tensor]:
        S = support_images.shape[0]
        with compute_autocast(support_images.device, self.compute_dtype):
            clips = torch.cat([self.tripel_prior(support_images),
                               self.tripel_prior(target_images)])
        feats = encode_frames(self.backbone, clips, self.encode_chunk,
                              self.compute_dtype)          # [S+Q, T, D]
        return self.head(feats[:S], feats[S:], support_labels)

    def head(self, su: torch.Tensor, qu: torch.Tensor,
             support_labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The head over the trunk's pooled features of the support's and
        the queries' prior clips, ``[S, T, D]`` and ``[Q, T, D]``."""
        with fp32_context(su.device):
            t_loss = soap_t_loss(su.mean(dim=1), self.lmd)
        with compute_autocast(su.device, self.compute_dtype):
            logits = torch.stack(
                [getattr(self, f"tct_{s}")(su, support_labels, qu)
                 for s in self.temp_set], dim=-1).mean(dim=-1)
        return {"logits": logits[None], "t_loss": t_loss}
