"""STEN head: the minimal CLIP baseline.

Port of ``clipspm_tpu/models/heads/sten.py``. Mean-pooled frame features;
class prototypes of the visual features and of the single-prompt text
features; logits are ``softmax(cos(q, text_proto)) * softmax(cos(q,
visual_proto))``. No parameters beyond the tower, and no kernel.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ...utils.precision import fp32_or_wider
from ..backbones.clip import CLIPArch
from ..blocks import class_prototypes, cos_sim
from ..visual import CLIPVideoModel, fp32_context


class STENModel(CLIPVideoModel):
    """CLIP visual tower + STEN head (shapes: ``CLIPVideoModel``). Returns
    dict(logits=``[1, Q, way]``)."""

    def __init__(self, arch: CLIPArch, way: int, shot: int,
                 encode_chunk: int = 0, train_encode_chunk: int = 0,
                 train_remat_policy: str = "attn_out",
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(arch, encode_chunk, train_encode_chunk,
                         train_remat_policy, compute_dtype)
        self.way, self.shot = way, shot

    def match_features(self, su, qu, support_labels, real_support_labels,
                       real_target_labels, text_train, text_test
                       ) -> Dict[str, torch.Tensor]:
        table = text_train if self.training else text_test
        with fp32_context(su.device):
            qu_f = fp32_or_wider(qu.mean(dim=1))
            t_proto = class_prototypes(
                fp32_or_wider(table[real_support_labels.long()]),
                support_labels, self.way)
            s_proto = class_prototypes(fp32_or_wider(su.mean(dim=1)),
                                       support_labels, self.way)
            sim_qt = torch.softmax(cos_sim(qu_f, t_proto), dim=-1)
            sim_qs = torch.softmax(cos_sim(qu_f, s_proto), dim=-1)
        return {"logits": (sim_qt * sim_qs)[None]}
