"""CLIP-SPM head: HSMR motion refinement + SPM semantic prototype modulation
+ PADM dual modulation.

Port of ``clipspm_tpu/models/heads/clipspm.py``. As shipped, the consist and
text distances are literal 0; logits are ``-(0.5 * class_dists +
task_dist)``. Each forward makes three bidirectional OTAM distances
(``ops/otam.py:otam_distance``), each one launch of kernel K1's fused mode
on the GPU.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.precision import fp32_or_wider
from ..blocks import (FeedForward, TransformerV1, class_prototypes,
                      group_by_class, otam_fp32)


def _dis(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean squared L2 norm of ``x - y`` over the trailing feature dims."""
    diff = fp32_or_wider(x - y)
    dims = (-2, -1) if diff.dim() >= 3 else (-1,)
    return (diff * diff).sum(dim=dims).mean()


class CLIPSPM(nn.Module):
    """The clipspm matching head over per-frame backbone features.

    Args:
        dim: feature width (1024 for RN50).
        way, shot: episode layout.
        spm: per-dataset hyperparameters (``mid_dim_vision``,
            ``mid_dim_text``, ``negative_slope``, ``alpha``, ...).
        single_direct: one-directional OTAM.
    """

    def __init__(self, dim: int, way: int, shot: int, spm: Mapping[str, float],
                 single_direct: bool = False):
        super().__init__()
        self.dim, self.way, self.shot = dim, way, shot
        self.spm = dict(spm)
        self.single_direct = single_direct
        d = dim
        self.motion_conv1 = nn.Conv1d(d, d, 3, padding=1)
        self.motion_conv2 = nn.Conv1d(d, d, 3, padding=1)
        self.token_tr = FeedForward(d, 2048, dropout=0.05)
        self.context1 = TransformerV1(dim=d, heads=8, dim_head_k=256,
                                      dropout_atte=0.2)
        self.context2 = TransformerV1(dim=d, heads=8, dim_head_k=256,
                                      dropout_atte=0.2)
        self.mo_alpha1 = nn.Parameter(torch.ones(()))
        self.scale = nn.Parameter(torch.ones(()))
        self.gate_text_fc1 = nn.Linear(d, int(d * self.spm["mid_dim_text"]))
        self.gate_text_fc2 = nn.Linear(int(d * self.spm["mid_dim_text"]), d)
        self.gate_vision_fc1 = nn.Linear(d, int(d * self.spm["mid_dim_vision"]))
        self.gate_vision_fc2 = nn.Linear(int(d * self.spm["mid_dim_vision"]), d)

    # -- submodules ---------------------------------------------------------

    def _gate(self, fc1, fc2, x):
        h = F.leaky_relu(fc1(x), negative_slope=self.spm["negative_slope"])
        return torch.sigmoid(fc2(h))

    def _se_te(self, frames, token):
        """Gated text/vision fusion + joint transformer.
        frames: ``[N, T, D]``; token: ``[N, 1, D]`` -> same shapes."""
        gate_t = self._gate(self.gate_text_fc1, self.gate_text_fc2, token)
        gate_v = self._gate(self.gate_vision_fc1, self.gate_vision_fc2, frames)
        fused = token * gate_t * self.spm["alpha"] + frames * gate_v
        x = torch.cat([token, fused], dim=1)
        x = self.context2(x, x, x)
        return x[:, 1:, :], x[:, :1, :]

    def _motion_feats(self, feats):
        """Temporal-conv motion diffs, time-mean pooled: ``[N, T, D] ->
        [N, D]``. The convs run over time (channels-first inside)."""
        conv = self.motion_conv2(self.motion_conv1(feats.transpose(1, 2)))
        conv = conv.transpose(1, 2)
        fwd = conv[:, 1:, :] - feats[:, :-1, :]
        bwd = conv[:, :-1, :] - feats[:, 1:, :]
        return (0.5 * (fwd + bwd)).mean(dim=1)

    def _mo(self, su, qu):
        """HSMR motion-consistency distance."""
        su_mo = self._motion_feats(su)
        qu_mo = self._motion_feats(qu)
        qu_m, qu_tok = self._se_te(qu, qu_mo[:, None, :])
        su_m, su_tok = self._se_te(su, su_mo[:, None, :])
        new_sm = self._motion_feats(su_m)
        new_qm = self._motion_feats(qu_m)
        return _dis(new_qm, qu_tok[:, 0, :]) + _dis(new_sm, su_tok[:, 0, :])

    def _otam(self, support, query):
        return otam_fp32(support, query, not self.single_direct)

    def _sem(self, su, qu, su_l, context_support, target_context_support):
        """SPM semantic prototype modulation."""
        token = torch.cat([target_context_support, context_support],
                          dim=0).mean(dim=0, keepdim=True)      # [1, 1, D]
        scale_su = su.mean(dim=(1, 2), keepdim=True)            # [S, 1, 1]
        scale_qu = qu.mean(dim=(1, 2), keepdim=True)            # [Q, 1, 1]
        support_token = self.token_tr(token * scale_su)
        target_token = self.token_tr(token * scale_qu)

        qu_real, tok_q_real = self._se_te(qu, target_context_support)
        su_fake, tok_s_fake = self._se_te(su, support_token)
        qu_fake, tok_q_fake = self._se_te(qu, target_token)
        su_real, tok_s_real = self._se_te(su, context_support)

        su_pro = class_prototypes(su_real, su_l, self.way)
        return su_real, qu_fake, su_pro, tok_s_real, tok_q_fake

    def _cpt_sem(self, su, qu, su_l, context_support, target_context_support):
        su_real, qu_fake, su_pro, tok_s_real, tok_q_fake = self._sem(
            su, qu, su_l, context_support, target_context_support)
        # as shipped: the consist and text distances are literal zero
        zero = torch.zeros((), dtype=torch.float32, device=su.device)
        class_dists = self._otam(su_pro, qu_fake)
        return su_real, qu_fake, tok_s_real, tok_q_fake, class_dists, zero, zero

    def _task_m(self, su, qu, su_l):
        """PADM task-level prototype/anchor modulation."""
        way = self.way
        suu = group_by_class(su, su_l, way, self.shot)      # [way, shot, T, D]
        qu_rep = qu[None].expand((way,) + tuple(qu.shape))
        token_s = torch.cat([suu, qu_rep], dim=1).mean(dim=1)    # [way, T, D]
        token_q = token_s.mean(dim=0, keepdim=True)              # [1, T, D]

        su_t = torch.cat([token_s, su], dim=0).transpose(0, 1)
        qu_t = torch.cat([token_q, qu], dim=0).transpose(0, 1)
        _su = self.context1(su_t, su_t, su_t).transpose(0, 1)
        _qu = self.context1(qu_t, qu_t, qu_t).transpose(0, 1)
        return _su[way:], _qu[1:], _su[:way], _qu[:1]

    # -- forward -------------------------------------------------------------

    def forward(self, support_features: torch.Tensor,
                target_features: torch.Tensor,
                support_labels: torch.Tensor,
                context_support: torch.Tensor,
                target_context_support: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """
        Args:
            support_features: ``[S, T, D]`` backbone frame features.
            target_features: ``[Q, T, D]``.
            support_labels: ``[S]`` relative labels.
            context_support: ``[S, 1, D]`` text features of support classes.
            target_context_support: ``[Q, 1, D]`` text features of query
                classes.
        Returns:
            dict(logits=``[1, Q, way]``, dists=scalar aux distance).
        """
        su, qu = support_features, target_features
        mo_dist = self._mo(su, qu)
        (su2, qu2, _, _, class_dists, consist_d, text_d) = self._cpt_sem(
            su, qu, support_labels, context_support, target_context_support)
        dists = consist_d + text_d + self.mo_alpha1 * mo_dist

        su3, qu3, su_t3, qu_t3 = self._task_m(su2, qu2, support_labels)
        su_pro = class_prototypes(su3, support_labels, self.way)
        task_dist = self._otam(su_pro, qu3) + self._otam(su_t3, qu_t3)

        logits = -(0.5 * class_dists + task_dist)
        return {"logits": logits[None], "dists": dists}
