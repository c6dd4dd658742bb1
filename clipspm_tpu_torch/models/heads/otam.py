"""OTAM head: ResNet spatial tokens, a motion-token branch and one
bidirectional OTAM distance.

Port of ``clipspm_tpu/models/heads/otam.py``. The trunk's last feature map
becomes ``[N, T, h*w, D]`` tokens (the cacheable stage); the head averages
them per frame, class-merges the bidirectional OTAM distance at lambda 0.1
(on the GPU one launch of kernel K1's fused mode per episode) and negates it.
``MoTokens`` scales a learned ``[1, 49, D]`` token bank by each video's mean
and refines it through two cross-attention transformers; its softmaxed
class similarities are returned as ``mo_logits``, which no loss reads (the
default branch of ``train/losses.py``), as the JAX head returns them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...utils.precision import fp32_or_wider
from ..blocks import TransformerV1, class_prototypes, otam_fp32
from ..visual import ResNetVideoModel, compute_autocast, fp32_context


def cosine_similarity_rows(x: torch.Tensor, y: torch.Tensor,
                           eps: float = 1e-8) -> torch.Tensor:
    """Row-wise cosine similarity ``[N, M]``, each norm clamped at
    ``eps``."""
    xn = torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(eps)
    yn = torch.linalg.vector_norm(y, dim=-1, keepdim=True).clamp_min(eps)
    return (x / xn) @ (y / yn).T


class MoTokens(nn.Module):
    """The motion-token branch over spatial tokens. ``mo`` is a
    ``[1, tokens, dim]`` bank (xavier-normal, ``weights.random_init_``)."""

    def __init__(self, dim: int, tokens: int = 49, way: int = 5):
        super().__init__()
        self.way = way
        self.mo = nn.Parameter(torch.zeros(1, tokens, dim))
        self.trans_1 = TransformerV1(dim=dim, dropout_atte=0.2)
        self.trans_2 = TransformerV1(dim=dim, dropout_atte=0.2)

    def refine(self, sp: torch.Tensor) -> torch.Tensor:
        """``[N, T, hw, D]`` -> ``[N, D]``. The bank, scaled by each video's
        scalar mean, cross-attends to each frame's tokens in turn: after
        the first frame it holds ``hw`` tokens, the query's count."""
        m = self.mo.to(sp.dtype) * sp.mean(dim=(1, 2, 3))[:, None, None]
        for i in range(sp.shape[1]):
            m = self.trans_1(sp[:, i], m, m)
        m = self.trans_2(m, m, m)
        return m.mean(dim=1)

    def forward(self, qu_sp: torch.Tensor, su_sp: torch.Tensor,
                su_labels: torch.Tensor) -> torch.Tensor:
        """qu_sp: ``[Q, T, hw, D]``; su_sp: ``[S, T, hw, D]`` ->
        ``[1, Q, way]`` class probabilities."""
        mo_q, mo_s = self.refine(qu_sp), self.refine(su_sp)
        with fp32_context(qu_sp.device):
            sim = cosine_similarity_rows(fp32_or_wider(mo_q),
                                         fp32_or_wider(mo_s))
            class_sim = class_prototypes(sim.T, su_labels, self.way).T
            return torch.softmax(class_sim, dim=-1)[None]


class OTAMModel(ResNetVideoModel):
    """ResNet trunk (spatial output) + OTAM head. ``encode`` gives
    ``[N, T, h*w, D]`` spatial tokens; ``match_features`` returns
    dict(logits=``[1, Q, way]``, mo_logits=``[1, Q, way]``)."""

    def __init__(self, way: int, shot: int, arch: str = "resnet50",
                 backbone_width: int = 64, encode_chunk: int = 0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(way, shot, arch, backbone_width, "spatial",
                         encode_chunk, compute_dtype)
        self.mo = MoTokens(dim=self.backbone.feature_dim, tokens=49, way=way)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """``[N, T, H, W, 3]`` frames -> ``[N, T, h*w, D]`` spatial
        tokens."""
        return super().encode(images).flatten(2, 3)

    def match_features(self, su_sp, qu_sp, support_labels,
                       real_support_labels=None, real_target_labels=None,
                       text_train=None, text_test=None
                       ) -> Dict[str, torch.Tensor]:
        """Head over precomputed tokens ``su_sp [S,T,hw,D]`` /
        ``qu_sp [Q,T,hw,D]``. The text tables are not read."""
        with compute_autocast(su_sp.device, self.compute_dtype):
            mo_logits = self.mo(qu_sp, su_sp, support_labels)
            cum = otam_fp32(su_sp.mean(dim=2), qu_sp.mean(dim=2),
                            bidirectional=True, lbda=0.1)     # [Q, S]
        class_dists = class_prototypes(cum.T, support_labels, self.way).T
        return {"logits": -class_dists[None], "mo_logits": mo_logits}
