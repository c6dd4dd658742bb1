"""CPM2C head: cross-modal prototype modulation with motion consistency.

Port of ``clipspm_tpu/models/heads/cpm2c.py``: multiscale motion (k=1, k=3
and dilated k=3 temporal convolutions fused by a 1x1 one), gated text/vision
fusion with class-token "fake" variants through a joint ``context2``
transformer, appearance and motion consistency distances, global token
distances, OTAM frame alignment on both streams (on the GPU two launches of
kernel K1's fused mode per episode: the appearance stream at L=T, the motion
stream at L=T-1) and video-to-text classification logits against the
active split's table. The convolutions run over time as ``nn.Conv1d`` on
``[N, D, T]`` (flax convolves ``[N, T, D]``; the layout turns at their
boundary). The JAX module's visual prompt generators and video adapter are
reached by no config and are not carried (ROADMAP.md, opt-in extras).
``CPM2C_DEFAULT_PARAMS`` fills the hyperparameters the reference expects in
``cfg.params``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.precision import fp32_or_wider
from ..backbones.clip import CLIPArch
from ..blocks import TransformerV1, class_prototypes, cos_sim, otam_fp32
from ..visual import CLIPVideoModel, compute_autocast, fp32_context

# neutral defaults of the hyperparameters the reference reads from
# cfg.params (a copy of the JAX package's table)
CPM2C_DEFAULT_PARAMS: Dict[str, float] = dict(
    mid_dim_text=1.5, mid_dim_vision=0.5, negative_slope=0.01, alpha=0.2,
    motion_residual_ratio=0.5, lambdas0=1.0, lambdas1=1.0, lambdas2=0.0,
    lambdas3=0.0, prompt_patch=16, hid_dim=64, prompt_patch_2=3,
    prompt_patch_22=3, hid_dim_2=8, prompts_2_weight=0.1,
    support_prompt_ratio=0.1, target_prompt_ratio=0.1,
)


def _consist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean over items of the squared Frobenius norm of ``a - b``."""
    diff = fp32_or_wider(a - b)
    return (diff * diff).sum(dim=(-2, -1)).mean()


class CPM2CModel(CLIPVideoModel):
    """CLIP visual tower + CPM2C head (shapes: ``CLIPVideoModel``). Returns
    dict(logits_local, logits_global, logits (= logits_local), each ``[1, Q,
    way]``; target_consist_distance, a scalar; class_logits ``[1, S+Q, C]``
    with ``use_classification``)."""

    def __init__(self, arch: CLIPArch, way: int, shot: int,
                 params: Mapping[str, float], motion_coeff: float = 0.5,
                 normal_coeff: float = 0.5, transformer_depth: int = 1,
                 use_classification: bool = True,
                 use_contrastive: bool = False, single_direct: bool = False,
                 merge_before: bool = False, encode_chunk: int = 0,
                 train_encode_chunk: int = 0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(arch, encode_chunk, train_encode_chunk, "full",
                         compute_dtype)
        d = arch.embed_dim
        p = {**CPM2C_DEFAULT_PARAMS, **dict(params)}
        self.p = p
        self.way, self.shot = way, shot
        self.motion_coeff, self.normal_coeff = motion_coeff, normal_coeff
        self.use_classification = use_classification
        self.use_contrastive = use_contrastive
        self.single_direct = single_direct
        self.merge_before = merge_before
        self.context2 = TransformerV1(dim=d, heads=8, dim_head_k=d // 8,
                                      dropout_atte=0.2,
                                      depth=transformer_depth)
        self.scale = nn.Parameter(torch.ones(()))
        self.class_token = nn.Parameter(torch.randn(1, 1, d))
        self.class_token_motion = nn.Parameter(torch.randn(1, 1, d))
        mid_t, mid_v = int(d * p["mid_dim_text"]), int(d * p["mid_dim_vision"])
        self.gate_text_fc1 = nn.Linear(d, mid_t)
        self.gate_text_fc2 = nn.Linear(mid_t, d)
        self.gate_vision_fc1 = nn.Linear(d, mid_v)
        self.gate_vision_fc2 = nn.Linear(mid_v, d)
        self.motion_conv1_1 = nn.Conv1d(d, d, 1)
        self.motion_conv1_3 = nn.Conv1d(d, d, 3, padding=1)
        self.motion_conv1_5 = nn.Conv1d(d, d, 3, padding=2, dilation=2)
        self.scale_conv = nn.Conv1d(3 * d, d, 1)

    # -- submodules ----------------------------------------------------------

    def _gate(self, fc1, fc2, x):
        h = F.leaky_relu(fc1(x), negative_slope=self.p["negative_slope"])
        return torch.sigmoid(fc2(h))

    def _fuse_and_transform(self, frames, token):
        """Gated text/vision fusion, the token prepended, ``context2``:
        ``[N, T, D]`` frames and a ``[N or 1, 1, D]`` token ->
        ``[N, T+1, D]``."""
        fused = (token * self._gate(self.gate_text_fc1, self.gate_text_fc2,
                                    token) * self.p["alpha"]
                 + frames * self._gate(self.gate_vision_fc1,
                                       self.gate_vision_fc2, frames))
        x = torch.cat([token.expand(frames.shape[0], 1, frames.shape[-1]),
                       fused], dim=1)
        return self.context2(x, x, x)

    def _multiscale_motion(self, feats):
        """``[N, T, D]`` -> ``[N, T-1, D]`` motion features."""
        x = feats.transpose(1, 2)
        fused = self.scale_conv(torch.cat([
            self.motion_conv1_1(x), self.motion_conv1_3(x),
            self.motion_conv1_5(x)], dim=1)).transpose(1, 2)
        conv = fused * self.p["motion_residual_ratio"] + feats
        fwd = conv[:, 1:, :] - feats[:, :-1, :]
        bwd = conv[:, :-1, :] - feats[:, 1:, :]
        return 0.5 * (fwd + bwd)

    def _text_eh(self, context_support, su, qu, su_l, token, tcs):
        """One stream's real and fake support and query through
        ``context2``: (support out, query out, support prototypes, fake
        support, real query)."""
        token = token.to(su.dtype)
        qu_contra = self._fuse_and_transform(qu, tcs)
        su_contra = self._fuse_and_transform(su, token)
        qu_out = self._fuse_and_transform(qu, token)
        if self.merge_before:
            su_m = class_prototypes(su, su_l, self.way)
            cs_m = class_prototypes(context_support, su_l, self.way)
            su_out = self._fuse_and_transform(su_m, cs_m)
            su_pro = su_out
        else:
            su_out = self._fuse_and_transform(su, context_support)
            su_pro = class_prototypes(su_out, su_l, self.way)
        return su_out, qu_out, su_pro, su_contra, qu_contra

    def _global_distance(self, su_g, su_l, qu):
        """``su_g [S, D]``, ``qu [Q, T+1, D]`` -> ``[way, Q]``: summed
        ``1 - cos`` over the query's tokens, summed over each class's
        members (a class mean times members per class)."""
        dists = 1 - cos_sim(fp32_or_wider(qu), fp32_or_wider(su_g))
        per_class = class_prototypes(dists.sum(dim=1).T, su_l, self.way) \
            * (su_g.shape[0] / self.way)
        if self.use_contrastive:
            per_class = per_class * self.scale
        return per_class

    # -- forward -------------------------------------------------------------

    def match_features(self, su, qu, support_labels, real_support_labels,
                       real_target_labels, text_train, text_test
                       ) -> Dict[str, torch.Tensor]:
        table = text_train if self.training else text_test
        cs = table[real_support_labels.long()][:, None, :]
        tcs = table[real_target_labels.long()][:, None, :]
        out = {}
        with compute_autocast(su.device, self.compute_dtype):
            su_mo = self._multiscale_motion(su)
            qu_mo = self._multiscale_motion(qu)
            if self.use_classification:
                with fp32_context(su.device):
                    pooled = torch.cat([su, qu], dim=0).mean(dim=1)
                    out["class_logits"] = (cos_sim(
                        fp32_or_wider(pooled), fp32_or_wider(table))
                        * self.scale)[None]
            su_mo2, qu_mo2, su_mo_pro, su_mo_c, qu_mo_c = self._text_eh(
                cs, su_mo, qu_mo, support_labels, self.class_token_motion,
                tcs)
            su2, qu2, su_pro, su_c, qu_c = self._text_eh(
                cs, su, qu, support_labels, self.class_token, tcs)
            with fp32_context(su.device):
                consist_motion = (_consist(qu_mo2, qu_mo_c)
                                  + _consist(su_mo2, su_mo_c))
                consist = _consist(qu2, qu_c) + _consist(su2, su_c)
                g_motion = self._global_distance(su_mo2[:, 0, :],
                                                 support_labels, qu_mo2)
                g_normal = self._global_distance(su2[:, 0, :],
                                                 support_labels, qu2)
            cum = otam_fp32(su_pro[:, 1:, :], qu2[:, 1:, :],
                            not self.single_direct)
            cum_mo = otam_fp32(su_mo_pro[:, 1:, :], qu_mo2[:, 1:, :],
                               not self.single_direct)
        class_dists_g = (self.normal_coeff * g_normal
                         + self.motion_coeff * g_motion).T
        class_dists_l = self.normal_coeff * cum + self.motion_coeff * cum_mo
        out.update({
            "logits_local": -class_dists_l[None],
            "logits_global": -class_dists_g[None],
            "target_consist_distance": (self.normal_coeff * consist
                                        + self.motion_coeff
                                        * consist_motion),
            "logits": -class_dists_l[None],
        })
        return out
