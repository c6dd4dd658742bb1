"""CLIP-FSAR head: joint support+text transformer and bidirectional OTAM.

Port of ``clipspm_tpu/models/heads/clipfsar.py``. The query frames
self-attend through ``context2``; the support frames, concatenated with
their class-text token, pass through the same ``context2``; class-mean
prototypes; one OTAM distance at lambda 0.5 (on the GPU one launch of kernel
K1's fused mode per episode). Evaluation branches: ``EVAL_TEXT`` (text-only
logits) and ``COMBINE`` (``text^c * visual^(1-c)``); ``MERGE_BEFORE``
class-merges the support before the joint transformer instead of after.
The video-to-text ``class_logits`` always use the train table, even in
evaluation, as the JAX package (and the reference) do.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...utils.precision import fp32_or_wider
from ..backbones.clip import CLIPArch
from ..blocks import TransformerV1, class_prototypes, cos_sim, otam_fp32
from ..visual import CLIPVideoModel, compute_autocast, fp32_context


class CLIPFSARModel(CLIPVideoModel):
    """CLIP visual tower + CLIP-FSAR head (shapes: ``CLIPVideoModel``).
    Returns dict(logits=``[1, Q, way]``, class_logits=``[1, S+Q, C]`` with
    ``use_classification``)."""

    def __init__(self, arch: CLIPArch, way: int, shot: int,
                 transformer_depth: int = 1, use_classification: bool = True,
                 single_direct: bool = False, merge_before: bool = False,
                 eval_text: bool = False, combine: bool = False,
                 text_coff: float = 0.9, encode_chunk: int = 0,
                 train_encode_chunk: int = 0,
                 train_remat_policy: str = "attn_out",
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(arch, encode_chunk, train_encode_chunk,
                         train_remat_policy, compute_dtype)
        d = arch.embed_dim
        self.way, self.shot = way, shot
        self.use_classification = use_classification
        self.single_direct = single_direct
        self.merge_before = merge_before
        self.eval_text, self.combine = eval_text, combine
        self.text_coff = text_coff
        self.context2 = TransformerV1(dim=d, heads=8, dim_head_k=d // 8,
                                      dropout_atte=0.2,
                                      depth=transformer_depth)
        self.scale = nn.Parameter(torch.ones(()))

    def _class_logits(self, su, qu, text_train):
        """Video-to-text cosine logits against the train table."""
        with fp32_context(su.device):
            feats = torch.cat([su, qu], dim=0).mean(dim=1)
            return cos_sim(fp32_or_wider(feats),
                           fp32_or_wider(text_train)) * self.scale

    def _visual_cum_dists(self, su, qu, support_labels, context):
        """Joint transformer, class merge and OTAM: ``[Q, way]``."""
        T = qu.shape[1]
        qu2 = self.context2(qu, qu, qu)
        if self.merge_before:
            su_m = class_prototypes(su, support_labels, self.way)
            ctx = class_prototypes(context, support_labels, self.way)
            su_cat = torch.cat([su_m, ctx], dim=1)
            su2 = self.context2(su_cat, su_cat, su_cat)[:, :T, :]
        else:
            su_cat = torch.cat([su, context], dim=1)
            su2 = self.context2(su_cat, su_cat, su_cat)[:, :T, :]
            su2 = class_prototypes(su2, support_labels, self.way)
        return otam_fp32(su2, qu2, not self.single_direct)

    def _text_logits(self, qu, support_labels, text_gathered):
        """Softmaxed cosine logits of each query's mean frame against the
        class-text prototypes: ``[Q, way]``."""
        with fp32_context(qu.device):
            text_proto = class_prototypes(fp32_or_wider(text_gathered),
                                          support_labels, self.way)
            img = fp32_or_wider(qu.mean(dim=1))
            img = img / torch.linalg.vector_norm(img, dim=1, keepdim=True)
            txt = text_proto / torch.linalg.vector_norm(text_proto, dim=1,
                                                        keepdim=True)
            return torch.softmax(self.scale * img @ txt.T, dim=1)

    def match_features(self, su, qu, support_labels, real_support_labels,
                       real_target_labels, text_train, text_test
                       ) -> Dict[str, torch.Tensor]:
        train = self.training
        table = text_train if train else text_test
        gathered = table[real_support_labels.long()]
        context = gathered[:, None, :]
        with compute_autocast(su.device, self.compute_dtype):
            class_logits = self._class_logits(su, qu, text_train)
            if not train and self.eval_text:
                cum_dists = -self._text_logits(qu, support_labels, gathered)
            elif not train and self.combine:
                text_p = self._text_logits(qu, support_labels, gathered)
                cum_v = self._visual_cum_dists(su, qu, support_labels,
                                               context)
                T = qu.shape[1]
                vis_soft = torch.softmax((T - cum_v) / T, dim=1)
                cum_dists = -(text_p ** self.text_coff
                              * vis_soft ** (1.0 - self.text_coff))
            else:
                cum_dists = self._visual_cum_dists(su, qu, support_labels,
                                                   context)
        out = {"logits": -cum_dists[None]}
        if self.use_classification:
            out["class_logits"] = class_logits[None]
        return out
