"""TA2N head: two-stage temporal-spatial alignment + prototype matching.

Port of ``clipspm_tpu/models/heads/ta2n.py``:

- **TTM**: a 3-D conv localisation net predicts an affine temporal warp
  ``t' = a t + b`` of each video, applied by a linear-interpolation gather
  along the frame axis (align-corners, zero padding);
- **ACM**: temporal coordination cross-attention on time-pooled features,
  then a motion net predicts per-frame (x, y) offsets; soft box masks built
  from the offsets (with a 9-point perturbation grid) spatially pool support
  and query;
- **insupport_align**: multi-shot prototype fusion against the first shot;
- prototype matching: negative timewise cosine distance (``METRIC: cos``) or
  soft-DTW at gamma 0.1 (``METRIC: otam``; on the GPU one launch of kernel
  K2's fused mode per episode), optional LayerNorm over the logits.

The tensors keep the JAX package's channels-last layout ``[N, T, h, w, C]``
at every function and between modules; the 3-D convs and pools see
channels-first views of it. The head's Linear layers apply to the last axis
of 3- to 6-D tensors, as flax Dense does. Under bf16 autocast the convs and
Linear layers run in bf16, BatchNorm in fp32, and the few einsums the JAX
package accumulates in fp32 run in fp32 here too; the cosine tables and the
soft-DTW run in fp32.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.softdtw import softdtw
from ...utils.precision import fp32_or_wider
from ..backbones.clip import FP32BatchNorm3d
from ..backbones.resnet import TorchResNet
from ..blocks import group_by_class
from ..visual import compute_autocast, encode_frames

# 9-point offset perturbation
_PERTURB = np.asarray([[0, 0], [0, 1], [1, 0], [0, -1], [-1, 0],
                       [1, 1], [-1, -1], [1, -1], [-1, 1]],
                      dtype=np.float32) * 0.2


def _no_autocast(t: torch.Tensor):
    return torch.autocast(t.device.type, enabled=False)


def temporal_grid_sample(feats: torch.Tensor, coords: torch.Tensor
                         ) -> torch.Tensor:
    """1-D grid sample along the frame axis with ``grid_sample``'s
    semantics (align_corners=True, zero padding).

    feats: ``[N, T, ...]``; coords: ``[N, T]`` in ``[-1, 1]`` -> same shape
    as feats.
    """
    N, T = feats.shape[:2]
    pos = (coords + 1.0) * 0.5 * (T - 1)
    lo = torch.floor(pos)
    hi = lo + 1.0
    w = pos - lo
    valid_lo = (lo >= 0) & (lo <= T - 1)
    valid_hi = (hi >= 0) & (hi <= T - 1)
    rows = torch.arange(N, device=feats.device)[:, None]
    extra = (1,) * (feats.dim() - 2)

    def gather(idx, valid):
        f = feats[rows, idx.long().clamp(0, T - 1)]
        return f * valid.reshape(valid.shape + extra)

    wexp = w.reshape(w.shape + extra)
    return gather(lo, valid_lo) * (1 - wexp) + gather(hi, valid_hi) * wexp


def gen_mask(offsets: torch.Tensor, resolution: int) -> torch.Tensor:
    """Soft box masks from (x, y) offsets: ``[..., 2] -> [..., L, L]``."""
    L = resolution
    shape = tuple(offsets.shape[:-1])
    if L == 1:
        # degenerate 1x1 maps (tiny test shapes): the box covers the pixel
        return offsets.new_ones(shape + (1, 1))
    off = offsets.reshape(-1, 1, 2)
    grid = (torch.arange(L, dtype=off.dtype, device=off.device) / (L - 1)) \
        * 2 - 1
    grid = grid.reshape(1, L, 1).expand(off.shape[0], L, 2) + off
    full = ((grid > -1) & (grid < 1)).to(off.dtype)
    margin = F.relu((1 - full) * (1 - (grid.abs() - 1) * ((L - 1) / 2)))
    mask_xy = full + margin
    mask_x, mask_y = mask_xy[..., 0], mask_xy[..., 1]
    mask = mask_y[..., :, None] * mask_x[..., None, :]
    return mask.reshape(shape + (L, L))


def _safe_pool(x: torch.Tensor, window) -> torch.Tensor:
    """VALID max-pool of channels-first ``[N, C, T, H, W]`` whose window is
    clamped to the actual dim sizes (the reference pooling on 8x7x7 maps;
    legal on tiny test shapes)."""
    win = tuple(min(w, s) for w, s in zip(window, x.shape[2:]))
    return F.max_pool3d(x, win, stride=win)


def _conv3d(cin: int, cout: int) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, 3, padding=1)


class TTM(nn.Module):
    """Temporal transform module. ``loc_fc2`` starts at a zero kernel and
    bias ``[2, 0]`` (``weights.random_init_``)."""

    def __init__(self, seq_len: int, dim: int):
        super().__init__()
        self.seq_len = seq_len
        self.loc_conv1 = _conv3d(dim, 64)
        self.loc_bn1 = FP32BatchNorm3d(64)
        self.loc_conv2 = _conv3d(64, 128)
        self.loc_bn2 = FP32BatchNorm3d(128)
        self.loc_fc1 = nn.Linear(128, 32)
        self.loc_fc2 = nn.Linear(32, 2)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """feats: ``[N, T, H, W, C]`` -> warped, same shape."""
        x = self.loc_conv1(feats.permute(0, 4, 1, 2, 3))
        x = F.relu(_safe_pool(self.loc_bn1(x), (2, 2, 2)))
        x = self.loc_conv2(x)
        x = F.relu(_safe_pool(self.loc_bn2(x), (2, 2, 2)))
        x = x.amax(dim=(2, 3, 4))                       # adaptive max (1,1,1)
        x = F.relu(self.loc_fc1(x))
        theta = torch.tanh(self.loc_fc2(x))             # [N, 2] (a, b)
        base = torch.linspace(-1.0, 1.0, self.seq_len, dtype=feats.dtype,
                              device=feats.device)
        coords = theta[:, :1] * base[None, :] + theta[:, 1:]   # [N, T]
        return temporal_grid_sample(feats, coords)


class ACM(nn.Module):
    """Action coordination module. ``mv_fc2`` starts at zero
    (``weights.random_init_``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.keynet = nn.Linear(dim, dim, bias=False)
        self.querynet = nn.Linear(dim, dim, bias=False)
        self.valuenet = nn.Linear(dim, dim, bias=False)
        self.mv_conv1 = _conv3d(2 * dim, 128)
        self.mv_bn1 = FP32BatchNorm3d(128)
        self.mv_conv2 = _conv3d(128, 128)
        self.mv_bn2 = FP32BatchNorm3d(128)
        self.mv_fc1 = nn.Linear(128, 64)
        self.mv_fc2 = nn.Linear(64, 2)

    def forward(self, support: torch.Tensor, query: torch.Tensor):
        """support: ``[n, T, H, W, C]``; query: ``[m, T, H, W, C]``
        -> (pairs ``[n, m, T, 2C]``, offsets ``[n*m, T, 2]``)."""
        C = self.dim
        n, T, H, W = support.shape[:4]
        m = query.shape[0]

        # temporal coordination
        su_t = support.mean(dim=(2, 3))                  # [n, T, C]
        qu_t = query.mean(dim=(2, 3))                    # [m, T, C]
        keys = self.keynet(su_t)
        querys = self.querynet(qu_t)
        values = self.valuenet(qu_t)                     # [m, T, C]
        su_v = self.valuenet(su_t)
        with _no_autocast(support):
            attn = torch.einsum("nxc,myc->nmxy", fp32_or_wider(keys),
                                fp32_or_wider(querys)) / (C ** 0.5)
            attn = torch.softmax(attn, dim=-1).to(support.dtype)
            aligned = torch.einsum("nmxy,myc->nmxc", attn,
                                   values.to(attn.dtype))
        query_aligned = query[None] + aligned[:, :, :, None, None, :]
        support_projed = support + su_v[:, :, None, None, :]

        # motion net -> offsets
        su_b = support_projed[:, None].expand(
            (n, m) + support_projed.shape[1:])
        pairs_vol = torch.cat([su_b, query_aligned], dim=-1)   # [n,m,T,H,W,2C]
        pv = pairs_vol.reshape((n * m,) + pairs_vol.shape[2:])
        x = self.mv_conv1(pv.permute(0, 4, 1, 2, 3))
        x = F.relu(_safe_pool(self.mv_bn1(x), (1, 2, 2)))
        x = self.mv_conv2(x)
        x = F.relu(_safe_pool(self.mv_bn2(x), (1, 2, 2)))
        x = x.amax(dim=(3, 4)).transpose(1, 2)           # [B, T, 128]
        x = F.relu(self.mv_fc1(x))
        offsets = torch.tanh(self.mv_fc2(x)) * 0.75      # [B, T, 2]

        perturb = torch.as_tensor(_PERTURB, dtype=offsets.dtype,
                                  device=offsets.device).reshape(1, 1, 9, 2)
        off_p = offsets[:, :, None, :] + perturb         # [B, T, 9, 2]

        def pooled_mask(off):
            mask = gen_mask(off, H)                      # [B, T, 9, H, W]
            area = mask.sum(dim=(-1, -2), keepdim=True)
            mask = (mask / area).mean(dim=2)             # [B, T, H, W]
            return mask.reshape(n, m, T, H, W)

        # the masked sums accumulate in fp32, as the JAX package's do
        with _no_autocast(support):
            su_pooled = torch.einsum("nmthw,nthwc->nmtc",
                                     fp32_or_wider(pooled_mask(off_p)),
                                     fp32_or_wider(support_projed))
            qu_pooled = torch.einsum("nmthw,nmthwc->nmtc",
                                     fp32_or_wider(pooled_mask(-off_p)),
                                     fp32_or_wider(query_aligned))
        pairs = torch.cat([su_pooled, qu_pooled], dim=-1)
        return pairs, offsets


class TA2NModel(nn.Module):
    """ResNet trunk + TTM (per video) + ACM and prototype matching (per
    episode).

    Shapes (S=way*shot, Q=way*queries, T=seq_len): images ``[S|Q, T, H, W,
    3]`` float (0-1); ``encode`` gives ``[N, T, h, w, D]`` post-TTM maps;
    ``match_features`` returns dict(logits=``[1, Q, way]``).
    """

    def __init__(self, way: int, shot: int, seq_len: int = 8,
                 arch: str = "resnet50", backbone_width: int = 64,
                 dropout: float = 0.5, dist_norm: bool = False,
                 metric: str = "cos", encode_chunk: int = 0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if metric not in ("cos", "otam"):
            raise ValueError(f"MODEL.METRIC must be 'cos' or 'otam', got "
                             f"{metric!r}")
        self.way, self.shot, self.seq_len = way, shot, seq_len
        self.metric, self.dist_norm = metric, dist_norm
        self.encode_chunk = encode_chunk
        self.compute_dtype = compute_dtype
        self.backbone = TorchResNet(arch=arch, output="spatial",
                                    width=backbone_width)
        d = self.dim = self.backbone.feature_dim
        self.feat_dropout = nn.Dropout(dropout)
        self.ttm = TTM(seq_len, d)
        self.acm = ACM(d)
        if shot > 1:
            self.keynet_multi = nn.Linear(d, d, bias=False)
            self.querynet_multi = nn.Linear(d, d, bias=False)
            self.valuenet_multi = nn.Linear(d, d, bias=False)
        if dist_norm:
            self.norm_layer = nn.LayerNorm(way, eps=1e-5)

    def feature_cacheable(self) -> bool:
        """The TTM warp is computed per video from its own features, so the
        post-warp spatial maps fully determine this head's inputs
        (train/feature_cache.py)."""
        return True

    def forward(self, support_images, target_images, support_labels,
                real_support_labels=None, real_target_labels=None,
                text_train=None, text_test=None) -> Dict[str, torch.Tensor]:
        """One trunk call over support and query frames; TTM on the support
        videos, then on the query videos (in train mode its BatchNorm
        statistics update twice, in that order, as in the JAX package)."""
        S, Q = support_images.shape[0], target_images.shape[0]
        with compute_autocast(support_images.device, self.compute_dtype):
            fmap = self._trunk(torch.cat([support_images, target_images]))
            su, qu = self.ttm(fmap[:S]), self.ttm(fmap[S:S + Q])
        return self.match_features(su, qu, support_labels,
                                   real_support_labels, real_target_labels,
                                   text_train, text_test)

    def _trunk(self, images: torch.Tensor) -> torch.Tensor:
        """``[N, T, H, W, 3]`` frames -> ``[N, T, h, w, D]`` trunk maps
        after dropout."""
        return self.feat_dropout(encode_frames(
            self.backbone, images, self.encode_chunk, self.compute_dtype))

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """``[N, T, H, W, 3]`` frames -> ``[N, T, h, w, D]`` TTM-aligned
        spatial maps: backbone -> dropout -> per-video temporal transform."""
        with compute_autocast(images.device, self.compute_dtype):
            return self.ttm(self._trunk(images))

    def _insupport_align(self, support: torch.Tensor) -> torch.Tensor:
        """Multi-shot prototype fusion.
        support: ``[way, shot, T, H, W, C]`` -> ``[way, T, H, W, C]``."""
        su_t = support.mean(dim=(3, 4))                  # [way, k, T, C]
        keys = self.keynet_multi(su_t)
        querys = self.querynet_multi(su_t[:, 0])         # [way, T, C]
        values = self.valuenet_multi(support)            # [way,k,T,H,W,C]
        with _no_autocast(support):
            attn = torch.einsum("nkxc,nyc->nkxy", fp32_or_wider(keys),
                                fp32_or_wider(querys)) / (self.dim ** 0.5)
            attn = torch.softmax(attn, dim=2).to(support.dtype)
            recon = torch.einsum("nkxy,nkxhwc->nkyhwc", attn,
                                 values.to(attn.dtype))
        return recon.mean(dim=1)

    def match_features(self, su, qu, support_labels, real_support_labels=None,
                       real_target_labels=None, text_train=None,
                       text_test=None) -> Dict[str, torch.Tensor]:
        """Head over precomputed (post-TTM) spatial maps ``su [S,T,h,w,D]``
        / ``qu [Q,T,h,w,D]``. The text tables are not read."""
        with compute_autocast(su.device, self.compute_dtype):
            return self._match(su, qu, support_labels)

    def _match(self, su, qu, support_labels) -> Dict[str, torch.Tensor]:
        Q, T, D = qu.shape[0], qu.shape[1], qu.shape[-1]
        grouped = group_by_class(su, support_labels, self.way, self.shot)
        if self.shot > 1:
            proto = self._insupport_align(grouped)       # [way, T, h, w, D]
            qu = self.valuenet_multi(qu)
        else:
            proto = grouped[:, 0]

        pairs, _offsets = self.acm(proto, qu)
        su_al = pairs[..., :D]                           # [way, Q, T, D]
        qu_al = pairs[..., D:]

        with _no_autocast(su):
            if self.metric == "otam":
                # soft-DTW with the full wrapper semantics (cos distance,
                # query-axis zero-padding, forward/reverse averaging)
                dist = softdtw(
                    fp32_or_wider(qu_al.reshape(self.way * Q, T, D)),
                    fp32_or_wider(su_al.reshape(self.way * Q, T, D)),
                    gamma=0.1).reshape(self.way, Q)
            else:
                sn = su_al / torch.linalg.vector_norm(
                    fp32_or_wider(su_al), dim=-1,
                    keepdim=True).clamp_min(1e-12)
                qn = qu_al / torch.linalg.vector_norm(
                    fp32_or_wider(qu_al), dim=-1,
                    keepdim=True).clamp_min(1e-12)
                dist = (1 - (sn * qn).sum(-1)).sum(-1)   # [way, Q]
            logits = (-dist).T                           # [Q, way]
            if self.dist_norm:
                logits = self.norm_layer(fp32_or_wider(logits))
        return {"logits": logits[None]}
