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
boundary). ``CPM2C_DEFAULT_PARAMS`` fills the hyperparameters the reference
expects in ``cfg.params``.

Two constructor flags, off by default and set by no config (as in the JAX
package): ``use_visual_prompts`` adds prompts to the pixels before the
tower (``get_prompts``: a patch MLP and a two-layer convolution, the
support and the query each at its own ratio; the features then depend on a
video's role, so the model is not feature-cacheable), and
``use_video_adapter`` runs the frames through a 6-layer CLIP transformer
with learned frame positions before the classification pooling.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.precision import fp32_or_wider
from ..backbones.clip import CLIPArch, TransformerStack
from ..blocks import (TransformerV1, class_prototypes, conv2d_nhwc, cos_sim,
                      otam_fp32)
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
    with ``use_classification``).

    ``use_visual_prompts`` creates ``meta_fc1`` / ``meta_fc2`` (the patch
    MLP, ``3 n^2 -> hid_dim -> 3 n^2`` with ``n = prompt_patch``) and
    ``meta_conv1`` / ``meta_conv2`` (``3 -> hid_dim_2 -> 3``, kernels
    ``prompt_patch_2`` and ``prompt_patch_22``, "same" padding).
    ``use_video_adapter`` (with ``use_classification``, where flax creates
    it) creates ``frame_position_embeddings`` (77 positions) and
    ``temporal_transformer`` (6 blocks, 8 heads, not causal; the tower's
    switches do not reach it, as in the JAX package)."""

    def __init__(self, arch: CLIPArch, way: int, shot: int,
                 params: Mapping[str, float], motion_coeff: float = 0.5,
                 normal_coeff: float = 0.5, transformer_depth: int = 1,
                 use_classification: bool = True,
                 use_contrastive: bool = False, single_direct: bool = False,
                 merge_before: bool = False,
                 use_visual_prompts: bool = False,
                 use_video_adapter: bool = False, encode_chunk: int = 0,
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
        self.use_visual_prompts = use_visual_prompts
        if use_visual_prompts:
            n, n2, n22 = (int(p[k]) for k in ("prompt_patch",
                                              "prompt_patch_2",
                                              "prompt_patch_22"))
            hid, hid2 = int(p["hid_dim"]), int(p["hid_dim_2"])
            self.meta_fc1 = nn.Linear(3 * n * n, hid)
            self.meta_fc2 = nn.Linear(hid, 3 * n * n)
            self.meta_conv1 = nn.Conv2d(3, hid2, n2, padding=(n2 - 1) // 2)
            self.meta_conv2 = nn.Conv2d(hid2, 3, n22, padding=(n22 - 1) // 2)
        self.use_video_adapter = use_video_adapter and use_classification
        if self.use_video_adapter:
            self.frame_position_embeddings = nn.Embedding(77, d)
            self.temporal_transformer = TransformerStack(d, 6, 8)

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

    def get_prompts(self, x: torch.Tensor) -> torch.Tensor:
        """The visual prompts of NHWC frames ``x [N, H, W, 3]``: the patch
        MLP over non-overlapping ``n x n`` patches (cut in the JAX order
        ``(hp, n, wp, n, C) -> (hp, wp, n, n, C)``) plus
        ``prompts_2_weight`` times the convolution branch."""
        N, H, W, C = x.shape
        n = int(self.p["prompt_patch"])
        hp, wp = H // n, W // n
        patches = x.reshape(N, hp, n, wp, n, C).permute(0, 1, 3, 2, 4, 5)
        local = self.meta_fc2(F.relu(self.meta_fc1(
            patches.reshape(N * hp * wp, n * n * C))))
        local = local.reshape(N, hp, wp, n, n, C).permute(0, 1, 3, 2, 4, 5)
        glob = conv2d_nhwc(self.meta_conv2,
                           F.relu(conv2d_nhwc(self.meta_conv1, x)))
        return local.reshape(N, H, W, C) + self.p["prompts_2_weight"] * glob

    def _prompted(self, images: torch.Tensor, ratio: float) -> torch.Tensor:
        """``[N, T, H, W, 3]`` pixels plus ``ratio`` times their prompts:
        the prompt layers in the compute dtype, the sum in the pixels'
        (promoted) dtype; the tower's autocast then casts it, as the JAX
        model casts the sum."""
        flat = images.reshape((-1,) + tuple(images.shape[2:]))
        with compute_autocast(images.device, self.compute_dtype):
            flat = flat + self.get_prompts(flat) * ratio
        return flat.reshape(images.shape)

    # -- forward -------------------------------------------------------------

    def encode_episode(self, support_images, target_images
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The features ``[S, T, D]`` and ``[Q, T, D]`` of an episode's
        clips in one tower call, each role's pixels with its prompts where
        they are on."""
        S = support_images.shape[0]
        if self.use_visual_prompts:
            support_images = self._prompted(support_images,
                                            self.p["support_prompt_ratio"])
            target_images = self._prompted(target_images,
                                           self.p["target_prompt_ratio"])
        feats = CLIPVideoModel.encode(
            self, torch.cat([support_images, target_images], dim=0))
        return feats[:S], feats[S:]

    def forward(self, support_images, target_images, support_labels,
                real_support_labels, real_target_labels, text_train,
                text_test) -> Dict[str, torch.Tensor]:
        su, qu = self.encode_episode(support_images, target_images)
        return self.match_features(su, qu, support_labels,
                                   real_support_labels, real_target_labels,
                                   text_train, text_test)

    def feature_cacheable(self) -> bool:
        """With visual prompts a video's features depend on its role (the
        support's and the query's ratios differ): not cacheable."""
        return not self.use_visual_prompts

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """``[N, T, H, W, 3]`` -> ``[N, T, D]`` (the feature cache's
        encode); refused with visual prompts, as the JAX model refuses."""
        if self.use_visual_prompts:
            raise ValueError(
                "cpm2c with MODEL.USE_VISUAL_PROMPTS applies role-dependent "
                "pixel prompts before the backbone — per-video features are "
                "not cacheable (see feature_cacheable)")
        return super().encode(images)

    def _pooled(self, feats: torch.Tensor) -> torch.Tensor:
        """``[N, T, D]`` -> ``[N, D]`` for the classification logits: the
        time mean, after the residual adapter where it is on."""
        if not self.use_video_adapter:
            return feats.mean(dim=1)
        pos = self.frame_position_embeddings.weight[:feats.shape[1]]
        h = feats + pos[None].to(feats.dtype)
        return (self.temporal_transformer(h) + feats).mean(dim=1)

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
                pooled = self._pooled(torch.cat([su, qu], dim=0))
                with fp32_context(su.device):
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
