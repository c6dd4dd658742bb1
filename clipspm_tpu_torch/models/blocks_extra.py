"""The reference's dormant blocks: attention, motion-token and grouped
matching experiments that no head uses.

Port of ``clipspm_tpu/models/blocks_extra.py``: ``AttentionV3``, ``Mo1``,
``Mo2``, ``Mo22``, ``TGroup``, ``PositionalEncoderV2`` and ``GroupGLKA``,
kept so the inventory of the JAX package is whole. No head imports this
module, in either package. Module and parameter names follow the JAX
parameter tree (``mo``, ``trans_1``, ``conv2_3``, ``lka3_0`` ...), so
``weights.py`` carries them by name. Features are ``[N*T, D]`` rows (or
``[N, T, D]``) with a static ``seq_len``; ``GroupGLKA`` takes NHWC maps.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.precision import fp32_or_wider
from .blocks import (PositionalEncoder, TransformerV1, class_prototypes,
                     conv2d_nhwc, cos_sim)
from .heads.otam import cosine_similarity_rows


class AttentionV3(nn.Module):
    """Cross-attention over the whole inner width (no head split): the
    scores and softmax in fp32, the probabilities back in the values'
    dtype; ``to_out`` and dropout unless one head spans ``dim``."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.scale = dim_head ** -0.5
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.project_out = not (heads == 1 and dim_head == dim)
        if self.project_out:
            self.to_out = nn.Linear(inner, dim)
            self.drop = nn.Dropout(dropout)

    def forward(self, q, k, v):
        qp, kp, vp = self.to_q(q), self.to_k(k), self.to_v(v)
        attn = torch.softmax(fp32_or_wider(qp @ kp.transpose(-1, -2))
                             * self.scale, dim=-1)
        out = attn.to(vp.dtype) @ vp
        if self.project_out:
            out = self.drop(self.to_out(out))
        return out


def _uniform_token(dim: int) -> nn.Parameter:
    """A ``[1, 1, dim]`` token, U[0, 1) as flax's ``uniform(1.0)``."""
    return nn.Parameter(torch.rand(1, 1, dim))


class Mo1(nn.Module):
    """Motion-token experiment v1: a learned token ``mo`` cross-attended by
    each video's time-mean feature; class-mean cosine distances.
    ``(qu [Q*T, D], su [S*T, D], labels [S])`` -> ``[1, Q, way]``."""

    def __init__(self, dim: int = 2048, way: int = 5, seq_len: int = 8):
        super().__init__()
        self.dim, self.way, self.seq_len = dim, way, seq_len
        self.mo = _uniform_token(dim)
        self.trans = TransformerV1(dim=dim)

    def forward(self, qu, su, su_labels):
        qu_v = qu.reshape(-1, self.seq_len, self.dim).mean(1)[None]
        su_v = su.reshape(-1, self.seq_len, self.dim).mean(1)[None]
        mo_q = self.trans(qu_v, self.mo, self.mo)[0]
        mo_s = class_prototypes(self.trans(su_v, self.mo, self.mo)[0],
                                su_labels, self.way)
        dist = 1 - cos_sim(mo_q, mo_s)
        return -torch.softmax(dist, dim=-1)[None]


class _MotionToken(nn.Module):
    """Mo2's and Mo22's shared part: the token ``mo`` attended by each
    video's time mean (``trans_1``), then by its frame differences
    (``trans_2``): ``[N*T, D]`` -> ``([N, T, D] videos, [N, 1, D]
    tokens)``."""

    def __init__(self, dim: int, seq_len: int):
        super().__init__()
        self.dim, self.seq_len = dim, seq_len
        self.mo = _uniform_token(dim)
        self.trans_1 = TransformerV1(dim=dim, dropout_atte=0.2)
        self.trans_2 = TransformerV1(dim=dim, dropout_atte=0.2)

    def token(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.reshape(-1, self.seq_len, self.dim)
        tok = self.trans_1(x.mean(1)[None], self.mo, self.mo)[0][:, None, :]
        diff = x[:, 1:] - x[:, :-1]
        return x, self.trans_2(tok, diff, diff)


class Mo2(_MotionToken):
    """Motion-token experiment v2: the token refined by frame-difference
    cross-attention, row cosine similarities averaged per class, a
    softmax. ``(qu, su, labels)`` -> ``[1, Q, way]``."""

    def __init__(self, dim: int = 2048, way: int = 5, seq_len: int = 8):
        super().__init__(dim, seq_len)
        self.way = way

    def forward(self, qu, su, su_labels):
        mo_q, mo_s = self.token(qu)[1][:, 0], self.token(su)[1][:, 0]
        sim = cosine_similarity_rows(fp32_or_wider(mo_q),
                                     fp32_or_wider(mo_s))
        class_sim = class_prototypes(sim.T, su_labels, self.way).T
        return torch.softmax(class_sim, dim=-1)[None]


class Mo22(_MotionToken):
    """Motion gating: every frame scaled by its video's ReLU'd token.
    ``(qu, su)`` -> ``([Q*T, D], [S*T, D])``."""

    def __init__(self, dim: int = 2048, seq_len: int = 8):
        super().__init__(dim, seq_len)

    def forward(self, qu, su):
        out = []
        for x in (qu, su):
            videos, tok = self.token(x)
            out.append((videos * F.relu(tok)).reshape(-1, self.dim))
        return tuple(out)


class TGroup(nn.Module):
    """Grouped temporal windows: frames padded by repeating the first and
    last, the positional encoding, 4 windows of 4 frames at stride 2, each
    pooled by its mean plus a convolution branch (``conv2_3``: kernel 2,
    dilation 2, no padding: length 2) plus a transformer branch; the
    distance of two videos the trace of their 4x4 window distances,
    averaged per class. ``(qu, su, labels)`` -> ``[1, Q, way]``."""

    def __init__(self, dim: int = 2048, way: int = 5, seq_len: int = 8):
        super().__init__()
        self.dim, self.way, self.seq_len = dim, way, seq_len
        self.pe = PositionalEncoder(dim=dim, scale_a=10.0, scale_b=1.0)
        self.trans = TransformerV1(dim=dim, dropout_atte=0.2, depth=2)
        self.conv2_1 = nn.Conv1d(dim, dim, 1, bias=False)
        self.conv2_2 = nn.Conv1d(dim, dim, 3, padding=1, bias=False)
        self.conv2_3 = nn.Conv1d(dim, dim, 2, dilation=2, bias=False)

    def _windows(self, x):
        x = x.reshape(-1, self.seq_len, self.dim)
        x = self.pe(torch.cat([x[:, :1], x, x[:, -1:]], dim=1))
        w = torch.stack([x[:, 2 * i:2 * i + 4] for i in range(4)], dim=1)
        return w.reshape(-1, 4, self.dim)

    def _pool(self, w):
        h = w.transpose(1, 2)
        for conv in (self.conv2_1, self.conv2_2, self.conv2_3):
            h = F.relu(conv(h))
        glob = F.relu(self.trans(w, w, w)).mean(dim=1)
        return w.mean(dim=1) + h.mean(dim=2) + glob

    def forward(self, qu, su, su_labels):
        qp, sp = self._pool(self._windows(qu)), self._pool(self._windows(su))
        nq, ns = qp.shape[0] // 4, sp.shape[0] // 4
        dist = 1 - cos_sim(fp32_or_wider(qp), fp32_or_wider(sp))
        dist = dist.reshape(nq, 4, ns, 4).transpose(1, 2)
        dist = dist.diagonal(dim1=-2, dim2=-1).sum(-1)
        return -class_prototypes(dist.T, su_labels, self.way).T[None]


class PositionalEncoderV2(PositionalEncoder):
    """The reference's odd-width-safe encoder: ``PositionalEncoder``, whose
    table already drops the trailing cosine channel at an odd width."""


class GroupGLKA(nn.Module):
    """Multiscale large-kernel attention over NHWC ``[N, H, W, C]``: an fp32
    LayerNorm, a 1x1 projection to ``2C`` split into gates ``a`` and values
    ``h``; ``a``'s thirds through depthwise large-kernel branches (3/5
    dilated 2, 5/7 dilated 3, 7/9 dilated 4), each times a depthwise gate;
    ``proj_last(h * a) * scale + x``. ``scale`` starts at 0, as flax's."""

    _BRANCHES = (("3", 3, 5, 2), ("5", 5, 7, 3), ("7", 7, 9, 4))

    def __init__(self, n_feats: int):
        super().__init__()
        c = n_feats
        third = c // 3
        self.splits = (third, third, c - 2 * third)
        self.norm = nn.LayerNorm(c, eps=1e-6)
        self.scale = nn.Parameter(torch.zeros(1, 1, 1, c))
        self.proj_first = nn.Conv2d(c, 2 * c, 1)
        for ch, (tag, k1, k2, dil) in zip(self.splits, self._BRANCHES):
            self.add_module(f"lka{tag}_0", self._dw(ch, k1, 1))
            self.add_module(f"lka{tag}_1", self._dw(ch, k2, dil))
            self.add_module(f"lka{tag}_2", nn.Conv2d(ch, ch, 1))
            self.add_module(f"x{tag}", self._dw(ch, k1, 1))
        self.proj_last = nn.Conv2d(c, c, 1)

    @staticmethod
    def _dw(ch: int, k: int, dil: int) -> nn.Conv2d:
        return nn.Conv2d(ch, ch, k, padding=(k // 2) * dil, dilation=dil,
                         groups=ch)

    def forward(self, x):
        h = self.norm(fp32_or_wider(x)).to(x.dtype)
        a, h = conv2d_nhwc(self.proj_first, h).chunk(2, dim=-1)
        gated = []
        for ai, (tag, *_) in zip(a.split(self.splits, dim=-1),
                                 self._BRANCHES):
            g = ai
            for i in range(3):
                g = conv2d_nhwc(getattr(self, f"lka{tag}_{i}"), g)
            gated.append(g * conv2d_nhwc(getattr(self, f"x{tag}"), ai))
        out = conv2d_nhwc(self.proj_last, h * torch.cat(gated, dim=-1))
        return out * self.scale.to(out.dtype) + x
