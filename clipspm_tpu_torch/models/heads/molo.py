"""MoLo head: appearance and motion streams with long-short contrast.

Port of ``clipspm_tpu/models/heads/molo.py``. From the trunk's last maps:
an appearance stream (frame means) and a motion stream (a Conv3d over
``(T, h, w)`` reducing D to D/8, a Conv2d, their frame differences, a 1x1
conv back to D), each with a class token, the sinusoidal positional encoder
and a self-attention transformer. Logits: min-pooled frame matching of the
class prototypes, plus the motion stream's times ``LOGIT_BALANCE_COFF``;
frame-to-global contrastive logits in both directions for each stream; an
optional classifier over the dataset's classes (per token with
``USE_LOCAL``). In training, a bilinear-upsampling decoder reconstructs the
pixel frame differences from the motion maps for ``loss_recons``. The
decoder feeds nothing else, so evaluation skips it (its output there is the
constant 0 either way). The reconstruction needs each episode's pixels, so
the model has no ``feature_cacheable`` and evaluates uncached. No kernel.
Under bf16 autocast the convolutions and dense layers run in bf16,
BatchNorm, the cosine tables and the distances in fp32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.precision import fp32_or_wider
from ..backbones.clip import FP32BatchNorm2d
from ..backbones.resnet import TorchResNet
from ..blocks import (PositionalEncoder, TransformerV2, class_prototypes,
                      conv2d_nhwc, cos_sim)
from ..visual import compute_autocast, encode_frames, fp32_context


def upsample_bilinear_align_corners(x: torch.Tensor, scale: int
                                    ) -> torch.Tensor:
    """Bilinear upsampling by ``scale`` with corners aligned, channels-last
    ``[N, H, W, C]`` -> ``[N, H*scale, W*scale, C]``."""
    H, W = x.shape[1:3]
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(H * scale, W * scale),
                      mode="bilinear", align_corners=True)
    return y.permute(0, 2, 3, 1)


class Up2(nn.Module):
    """Bilinear upsample, 3x3 conv (no bias), BatchNorm (fp32, flax's
    statistics), ReLU; channels-last."""

    def __init__(self, in_channels: int, out_channels: int, scale: int = 2):
        super().__init__()
        self.scale = scale
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                              bias=False)
        self.bn = FP32BatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = upsample_bilinear_align_corners(x, self.scale)
        return F.relu(self.bn(self.conv(x.permute(0, 3, 1, 2)))
                      ).permute(0, 2, 3, 1)


class MoLoModel(nn.Module):
    """ResNet trunk (spatial output) + MoLo head.

    Returns dict(logits, logits_s2q, logits_q2s, logits_s2q_motion,
    logits_q2s_motion: ``[1, Q, way]``; loss_recons: scalar, 0 outside
    training; class_logits: ``[1, S+Q, NUM_CLASS]``, ``[1, (S+Q)(T+1),
    NUM_CLASS]`` with ``USE_LOCAL``, when ``use_classification``).
    """

    def __init__(self, way: int, shot: int, seq_len: int = 8,
                 arch: str = "resnet50", backbone_width: int = 64,
                 num_class: int = 64, use_classification: bool = True,
                 use_local: bool = False, use_contrastive: bool = True,
                 temp_coff: float = 0.0, logit_balance: float = 0.3,
                 single_direct: bool = False, heads: int = 8,
                 position_a: float = 10.0, position_b: float = 1.0,
                 factor: int = 8, encode_chunk: int = 0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.way, self.shot, self.seq_len = way, shot, seq_len
        self.num_class = num_class
        self.use_classification, self.use_local = use_classification, use_local
        self.use_contrastive, self.temp_coff = use_contrastive, temp_coff
        self.logit_balance, self.single_direct = logit_balance, single_direct
        self.encode_chunk, self.compute_dtype = encode_chunk, compute_dtype
        self.backbone = TorchResNet(arch=arch, output="spatial",
                                    width=backbone_width)
        d = self.backbone.feature_dim
        r = d // factor
        self.pe = PositionalEncoder(dim=d, scale_a=position_a,
                                    scale_b=position_b)
        self.class_token = nn.Parameter(torch.zeros(1, 1, d))
        self.class_token_motion = nn.Parameter(torch.zeros(1, 1, d))
        self.temporal_atte_before = TransformerV2(
            dim=d, heads=heads, dim_head_k=d // heads, dropout_atte=0.2)
        self.temporal_atte_before_motion = TransformerV2(
            dim=d, heads=heads, dim_head_k=d // heads, dropout_atte=0.2)
        self.motion_reduce = nn.Conv3d(d, r, 3, padding=1)
        self.motion_conv = nn.Conv2d(r, r, 3, padding=1)
        self.motion_up = nn.Conv2d(r, d, 1)
        if use_classification:
            self.classification_layer = nn.Linear(d, num_class)
        if not temp_coff and use_contrastive:
            self.scale = nn.Parameter(torch.ones(()))
            self.scale_motion = nn.Parameter(torch.ones(()))
        self.up1 = Up2(r, 128, scale=2)
        self.up2 = Up2(128, 32, scale=4)
        self.up3 = Up2(32, 16, scale=4)
        self.outc = nn.Conv2d(16, 3, 1)

    def _scales(self):
        if self.temp_coff:
            return self.temp_coff, self.temp_coff
        if self.use_contrastive:
            return self.scale, self.scale_motion
        return 1.0, 1.0

    def _stream_logits(self, su, qu, scale):
        """(min-pooled frame distances, s2q logits, q2s logits), each
        ``[Q, way]``, of class prototypes ``su [way, T+1, D]`` and queries
        ``qu [Q, T+1, D]`` (token 0 the class token), in fp32."""
        su, qu = fp32_or_wider(su), fp32_or_wider(qu)
        su_g, su_f = su[:, 0], su[:, 1:]
        qu_g, qu_f = qu[:, 0], qu[:, 1:]
        logits_s2q = -((1 - cos_sim(su_f, qu_g)).sum(dim=1) * scale).T
        logits_q2s = -((1 - cos_sim(qu_f, su_g)).sum(dim=1) * scale)
        D, nf = qu_f.shape[-1], qu_f.shape[1]
        sim = cos_sim(qu_f.reshape(-1, D), su_f.reshape(-1, D))
        dists = (1 - sim).reshape(qu_f.shape[0], nf, su_f.shape[0], nf
                                  ).transpose(1, 2)     # [Q, way, nf, nf]
        cum = dists.amin(dim=3).sum(dim=2)
        if not self.single_direct:
            cum = cum + dists.amin(dim=2).sum(dim=2)
        return cum, logits_s2q, logits_q2s

    def forward(self, support_images, target_images, support_labels,
                real_support_labels=None, real_target_labels=None,
                text_train=None, text_test=None) -> Dict[str, torch.Tensor]:
        both = torch.cat([support_images, target_images])
        fmap = encode_frames(self.backbone, both, self.encode_chunk,
                             self.compute_dtype)
        return self.head(fmap, both, support_labels)

    def head(self, fmap: torch.Tensor, both: torch.Tensor,
             support_labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The head over the trunk's maps ``fmap [B, T, h, w, D]`` of the
        episode's clips ``both [B, T, H, W, 3]`` (the support's first, one
        per support label); the clips are the reconstruction's target."""
        S, (B, T, h, w, D) = support_labels.shape[0], fmap.shape
        with compute_autocast(both.device, self.compute_dtype):
            # motion stream: Conv3d over (T, h, w), then frame differences
            mo = self.motion_reduce(fmap.permute(0, 4, 1, 2, 3)
                                    ).permute(0, 2, 3, 4, 1)
            r = mo.shape[-1]
            mo_conv = conv2d_nhwc(self.motion_conv, mo.flatten(0, 1)
                                   ).reshape(mo.shape)
            mo_flat = (mo_conv[:, 1:] - mo[:, :-1]).reshape(
                B * (T - 1), h, w, r)
            motion = F.relu(conv2d_nhwc(self.motion_up, mo_flat))
            motion = motion.mean(dim=(1, 2)).reshape(B, T - 1, D)
            motion = torch.cat([self.class_token_motion.to(motion.dtype)
                                .expand(B, 1, D), motion], dim=1)
            motion = F.relu(self.temporal_atte_before_motion(self.pe(motion)))
            # appearance stream
            app = fmap.mean(dim=(2, 3))                    # [B, T, D]
            app = torch.cat([self.class_token.to(app.dtype).expand(B, 1, D),
                             app], dim=1)
            app = F.relu(self.temporal_atte_before(self.pe(app)))
            class_logits = None
            if self.use_classification:
                if self.use_local:
                    class_logits = self.classification_layer(app).reshape(
                        -1, self.num_class)
                else:
                    class_logits = self.classification_layer(
                        app.mean(dim=1) + motion.mean(dim=1))
            rec = self._decode(mo_flat) if self.training else None
        su_app = class_prototypes(app[:S], support_labels, self.way)
        su_mo = class_prototypes(motion[:S], support_labels, self.way)
        sa, sm = self._scales()
        with fp32_context(both.device):
            cum_app, s2q, q2s = self._stream_logits(su_app, app[S:], sa)
            cum_mo, s2q_m, q2s_m = self._stream_logits(su_mo, motion[S:], sm)
            class_dists = cum_app + self.logit_balance * cum_mo
            if rec is not None:
                # the reconstruction target: pixel frame differences
                diffs = (both[:, 1:] - both[:, :-1]).reshape(rec.shape)
                loss_recons = ((fp32_or_wider(rec) - fp32_or_wider(diffs))
                               ** 2).mean()
            else:
                loss_recons = torch.zeros((), dtype=class_dists.dtype,
                                          device=class_dists.device)
        out = {"logits": -class_dists[None],
               "logits_s2q": s2q[None], "logits_q2s": q2s[None],
               "logits_s2q_motion": s2q_m[None],
               "logits_q2s_motion": q2s_m[None],
               "loss_recons": loss_recons}
        if class_logits is not None:
            out["class_logits"] = class_logits[None]
        return out

    def _decode(self, mo_flat: torch.Tensor) -> torch.Tensor:
        """The decoder: ``[B(T-1), h, w, D/8]`` motion maps ->
        ``[B(T-1), H, W, 3]`` reconstructed frame differences."""
        rec = self.up3(self.up2(self.up1(mo_flat)))
        return conv2d_nhwc(self.outc, rec)
