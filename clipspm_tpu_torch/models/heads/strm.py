"""STRM head: spatio-temporal enrichment and TRX-style matching.

Port of ``clipspm_tpu/models/heads/strm.py``. Per frame, the trunk's last
map is max-pooled to 4x4 patches, the patches self-attend (``SelfAttnBot``,
its attention gated by ``gamma``, which starts at 0) and are averaged: the
cacheable frame features. Per episode, an MLP-mixer enriches the frames
across time (``MLPMixEnrich``) before the TRX cross-transformers
(``logits``), and a tuple-level min-distance on the un-enriched frames gives
``logits_post_pat`` (``TupleDistanceLoss``). No kernel. Under bf16 autocast
the dense layers run in bf16; the attention scores and softmax, and the
tuple distances, in fp32, as the JAX head casts them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.precision import fp32_or_wider
from ..blocks import group_by_class
from ..visual import ResNetVideoModel, compute_autocast, fp32_context
from .trx import FrameTuples, TemporalCrossTransformer, trx_positional_table


def adaptive_max_pool_2d(x: torch.Tensor, out_h: int, out_w: int
                         ) -> torch.Tensor:
    """Adaptive max-pool of channels-last ``[..., H, W, C]`` to
    ``[..., out_h, out_w, C]`` (cell i spans ``[floor(i H / out),
    ceil((i + 1) H / out))``; cells overlap where ``out`` does not divide
    ``H``, and repeat where ``out > H``)."""
    lead, (H, W, C) = x.shape[:-3], x.shape[-3:]
    y = F.adaptive_max_pool2d(x.reshape(-1, H, W, C).permute(0, 3, 1, 2),
                              (out_h, out_w))
    return y.permute(0, 2, 3, 1).reshape(lead + (out_h, out_w, C))


def _table(rows: int, dim: int) -> torch.Tensor:
    return torch.from_numpy(trx_positional_table(int(rows * 1.5), dim))


class SelfAttnBot(nn.Module):
    """Patch self-attention, gated by ``gamma`` (starts at 0), with a
    residual, then a 3-layer bottleneck MLP with a residual:
    ``[B, N, D] -> [B, N, D]``."""

    def __init__(self, dim: int, seq_len: int):
        super().__init__()
        self.register_buffer("pe", _table(seq_len, dim), persistent=False)
        self.drop = nn.Dropout(0.1)
        self.query_proj = nn.Linear(dim, dim)
        self.key_proj = nn.Linear(dim, dim)
        self.value_conv = nn.Linear(dim, dim)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.inp_fc = nn.Linear(dim, dim // 2)
        self.hid_fc = nn.Linear(dim // 2, dim // 2)
        self.out_fc = nn.Linear(dim // 2, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop(x + self.pe[: x.shape[1]].to(x.dtype))
        q, k, v = self.query_proj(x), self.key_proj(x), self.value_conv(x)
        attn = torch.softmax(fp32_or_wider(
            torch.matmul(q, k.transpose(-1, -2))), dim=-1)
        out = torch.matmul(attn.to(v.dtype), v)
        out = self.gamma.to(out.dtype) * out + x
        h = F.relu(self.inp_fc(out))
        h = F.relu(self.hid_fc(h))
        return self.out_fc(h) + out


class MLPMixEnrich(nn.Module):
    """A token MLP across the frames, then a bottleneck MLP across the
    channels, each with a residual: ``[N, T, D] -> [N, T, D]``."""

    def __init__(self, dim: int, seq_len: int):
        super().__init__()
        self.register_buffer("pe", _table(seq_len, dim), persistent=False)
        self.drop = nn.Dropout(0.1)
        self.tok_inp = nn.Linear(seq_len, seq_len)
        self.tok_out = nn.Linear(seq_len, seq_len)
        self.bot_inp = nn.Linear(dim, dim)
        self.bot_out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop(x + self.pe[: x.shape[1]].to(x.dtype))
        h = F.relu(self.tok_inp(x.transpose(-1, -2)))
        out = self.tok_out(h).transpose(-1, -2) + x
        h = F.relu(self.bot_inp(out))
        return self.bot_out(h) + out


class TupleDistanceLoss(nn.Module):
    """Each query tuple's least euclidean distance to a class's support
    tuples, averaged over the query's tuples and negated: ``(support,
    labels, queries) -> [Q, way]``. The distance is the expanded square
    clamped at 1e-12 before the root, as the JAX head computes it."""

    def __init__(self, way: int, shot: int, seq_len: int, in_dim: int,
                 set_size: int):
        super().__init__()
        self.way, self.shot = way, shot
        self.tuples = FrameTuples(seq_len, set_size)
        self.drop = nn.Dropout(0.1)
        self.clsW = nn.Linear(set_size * in_dim, in_dim // 2)

    def forward(self, support, support_labels, queries) -> torch.Tensor:
        qe = F.relu(self.clsW(self.tuples(self.drop(queries))))
        se = F.relu(self.clsW(self.tuples(self.drop(support))))
        nt, Q = self.tuples.n_tuples, queries.shape[0]
        with fp32_context(support.device):
            qe = fp32_or_wider(qe).reshape(Q * nt, -1)
            ce = group_by_class(fp32_or_wider(se), support_labels, self.way,
                                self.shot).reshape(self.way, self.shot * nt,
                                                   -1)
            d2 = ((qe ** 2).sum(-1)[None, :, None]
                  + (ce ** 2).sum(-1)[:, None, :]
                  - 2.0 * torch.einsum("qd,wsd->wqs", qe, ce))
            dist = torch.sqrt(d2.clamp_min(1e-12))    # [way, Q*nt, shot*nt]
            min_dist = dist.amin(dim=-1).reshape(self.way, Q, nt)
            return (-min_dist.mean(dim=-1)).T          # [Q, way]


class STRMModel(ResNetVideoModel):
    """ResNet trunk (spatial output) + patch attention (``attn_pat``),
    frame enrichment (``fr_enrich``), one TRX cross-transformer
    (``tct_<n>``) and one tuple distance (``tdl_<n>``) per cardinality.
    ``encode`` gives ``[N, T, D]`` patch-attended frames; ``match_features``
    returns dict(logits=``[1, Q, way]``, logits_post_pat=``[1, Q, way]``).
    """

    def __init__(self, way: int, shot: int, seq_len: int = 8,
                 temp_set: Sequence[int] = (2,), out_dim: int = 1152,
                 arch: str = "resnet50", backbone_width: int = 64,
                 num_patches_side: int = 4, dropout: float = 0.1,
                 encode_chunk: int = 0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(way, shot, arch, backbone_width, "spatial",
                         encode_chunk, compute_dtype)
        self.seq_len, self.temp_set = seq_len, tuple(temp_set)
        self.num_patches_side = num_patches_side
        d = self.backbone.feature_dim
        self.attn_pat = SelfAttnBot(d, num_patches_side ** 2)
        self.fr_enrich = MLPMixEnrich(d, seq_len)
        for s in self.temp_set:
            self.add_module(f"tct_{s}", TemporalCrossTransformer(
                way, shot, seq_len, d, out_dim, s, dropout))
            self.add_module(f"tdl_{s}", TupleDistanceLoss(
                way, shot, seq_len, d, s))

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """``[N, T, H, W, 3]`` frames -> ``[N, T, D]``: trunk, adaptive
        max-pool to ``num_patches_side``^2 patches, patch attention (within
        a frame only, so the result is per video), patch mean."""
        fmap = super().encode(images)                      # [N, T, h, w, D]
        p = self.num_patches_side
        patches = adaptive_max_pool_2d(fmap, p, p).flatten(2, 3)
        N, T, n, D = patches.shape
        with compute_autocast(images.device, self.compute_dtype):
            out = self.attn_pat(patches.reshape(N * T, n, D))
        return out.mean(dim=1).reshape(N, T, D)

    def match_features(self, su, qu, support_labels, real_support_labels=None,
                       real_target_labels=None, text_train=None,
                       text_test=None) -> Dict[str, torch.Tensor]:
        """Head over precomputed frames ``su [S,T,D]`` / ``qu [Q,T,D]``.
        The text tables are not read."""
        with compute_autocast(su.device, self.compute_dtype):
            post_pat = torch.stack(
                [getattr(self, f"tdl_{s}")(su, support_labels, qu)
                 for s in self.temp_set], dim=-1).mean(dim=-1)
            su_fr, qu_fr = self.fr_enrich(su), self.fr_enrich(qu)
            logits = torch.stack(
                [getattr(self, f"tct_{s}")(su_fr, support_labels, qu_fr)
                 for s in self.temp_set], dim=-1).mean(dim=-1)
        return {"logits": logits[None], "logits_post_pat": post_pat[None]}
