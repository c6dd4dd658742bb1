"""Shared model blocks of the CLIP heads.

Port of the parts of ``clipspm_tpu/models/blocks.py`` that the heads use:
the episodic metric utilities, the pre-norm cross-attention transformer
(clipspm, clipfsar, cpm2c, otam), the fused-QKV self-attention transformer
and the sinusoidal positional encoder (molo); and the heads' OTAM call.
Module and parameter names follow the JAX parameter tree (``fc1``, ``to_q``,
``norm_0`` ...) so ``weights.py`` maps one onto the other by name.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.otam import otam_distance
from ..utils.precision import fp32_or_wider


def cos_sim(x: torch.Tensor, y: torch.Tensor, epsilon: float = 0.01
            ) -> torch.Tensor:
    """Cosine similarity over the last dim, epsilon in the denominator."""
    num = torch.matmul(x, y.transpose(-1, -2))
    xn = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    yn = torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    return num / (torch.matmul(xn, yn.transpose(-1, -2)) + epsilon)


def otam_fp32(support: torch.Tensor, query: torch.Tensor,
              bidirectional: bool, lbda: float = 0.5) -> torch.Tensor:
    """``otam_distance`` over fp32 (or fp64) features with autocast off:
    the DP and its cosine table take no bf16 matmul (on the GPU one launch
    of kernel K1's fused mode)."""
    with torch.autocast(support.device.type, enabled=False):
        return otam_distance(fp32_or_wider(support), fp32_or_wider(query),
                             lbda=lbda, bidirectional=bidirectional)


def conv2d_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A 2-D conv over channels-last ``[N, H, W, C]`` (a channels-first
    view in and out)."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def class_prototypes(features: torch.Tensor, labels: torch.Tensor,
                     way: int) -> torch.Tensor:
    """Per-class mean of support features, ordered by class id.

    Args:
        features: ``[S, ...]`` support features.
        labels: ``[S]`` int episode-relative labels in ``[0, way)``.
    Returns:
        ``[way, ...]`` prototypes.
    """
    labels = labels.to(device=features.device, dtype=torch.long)
    sums = features.new_zeros((way,) + features.shape[1:])
    sums.index_add_(0, labels, features)
    counts = torch.bincount(labels, minlength=way).to(features.dtype)
    return sums / counts.reshape((way,) + (1,) * (features.dim() - 1))


def group_by_class(features: torch.Tensor, labels: torch.Tensor,
                   way: int, shot: int) -> torch.Tensor:
    """Support features in ``[way, shot, ...]`` class-major order; within a
    class, entries keep their order in ``features`` (a stable argsort)."""
    labels = labels.to(device=features.device, dtype=torch.long)
    order = torch.argsort(labels, stable=True)
    return features[order].reshape((way, shot) + features.shape[1:])


class FeedForward(nn.Module):
    """Linear - exact GELU - Dropout - Linear - Dropout."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop(F.gelu(self.fc1(x)))
        return self.drop(self.fc2(x))


class AttentionQKV(nn.Module):
    """Multi-head cross-attention with separate q/k/v projections and no
    projection biases. The softmax runs in fp32."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.project_out = not (heads == 1 and dim_head == dim)
        if self.project_out:
            self.to_out = nn.Linear(inner, dim)
            self.drop = nn.Dropout(dropout)

    def forward(self, q, k, v):
        def split(t):
            b, n, _ = t.shape
            return t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)

        qh, kh, vh = split(self.to_q(q)), split(self.to_k(k)), split(self.to_v(v))
        attn = fp32_or_wider(torch.matmul(qh, kh.transpose(-1, -2))) \
            * self.dim_head ** -0.5
        attn = torch.softmax(attn, dim=-1).to(vh.dtype)
        out = torch.matmul(attn, vh)
        b, _, n, _ = out.shape
        out = out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head)
        if self.project_out:
            out = self.drop(self.to_out(out))
        return out


class TransformerV1(nn.Module):
    """Pre-norm cross-attention block: ``attn(LN(q), LN(k), LN(v)) + q`` then
    ``FF(x) + x``. Layers beyond the first self-attend on the running value.
    """

    def __init__(self, dim: int, heads: int = 8, dim_head_k: int = 256,
                 mlp_dim: int = 2048, dropout_atte: float = 0.05,
                 dropout_ffn: float = 0.05, depth: int = 1):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"norm_{i}", nn.LayerNorm(dim, eps=1e-5))
            self.add_module(f"attn_{i}", AttentionQKV(
                dim, heads=heads, dim_head=dim_head_k, dropout=dropout_atte))
            self.add_module(f"ff_{i}", FeedForward(dim, mlp_dim,
                                                    dropout=dropout_ffn))

    def forward(self, q, k, v):
        x = q
        for i in range(self.depth):
            ln = getattr(self, f"norm_{i}")
            attn = getattr(self, f"attn_{i}")
            if i == 0:
                x = attn(_ln(ln, q), _ln(ln, k), _ln(ln, v)) + q
            else:
                h = _ln(ln, x)
                x = attn(h, h, h) + x
            x = getattr(self, f"ff_{i}")(x) + x
        return x


def _ln(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm statistics in fp32, result in the input dtype."""
    return ln(fp32_or_wider(x)).to(x.dtype)


class SelfAttention(nn.Module):
    """Multi-head self-attention with one fused q/k/v projection and no
    projection bias. The scores and softmax run in fp32; the probabilities
    return to the values' dtype."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.project_out = not (heads == 1 and dim_head == dim)
        if self.project_out:
            self.to_out = nn.Linear(inner, dim)
            self.drop = nn.Dropout(dropout)

    def forward(self, x):
        def split(t):
            b, n, _ = t.shape
            return t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)

        qh, kh, vh = (split(t) for t in self.to_qkv(x).chunk(3, dim=-1))
        attn = fp32_or_wider(torch.matmul(qh, kh.transpose(-1, -2))) \
            * self.dim_head ** -0.5
        attn = torch.softmax(attn, dim=-1).to(vh.dtype)
        out = torch.matmul(attn, vh)
        b, _, n, _ = out.shape
        out = out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head)
        if self.project_out:
            out = self.drop(self.to_out(out))
        return out


class TransformerV2(nn.Module):
    """Pre-norm self-attention block: ``attn(LN(x)) + x`` then
    ``FF(x) + x``, ``depth`` times."""

    def __init__(self, dim: int, heads: int = 8, dim_head_k: int = 256,
                 mlp_dim: int = 2048, dropout_atte: float = 0.05,
                 dropout_ffn: float = 0.05, depth: int = 1):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"norm_{i}", nn.LayerNorm(dim, eps=1e-5))
            self.add_module(f"attn_{i}", SelfAttention(
                dim, heads=heads, dim_head=dim_head_k, dropout=dropout_atte))
            self.add_module(f"ff_{i}", FeedForward(dim, mlp_dim,
                                                    dropout=dropout_ffn))

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"attn_{i}")(
                _ln(getattr(self, f"norm_{i}"), x)) + x
            x = getattr(self, f"ff_{i}")(x) + x
        return x


def sinusoidal_positions(seq_len: int, dim: int) -> np.ndarray:
    """``[seq_len, dim]`` sinusoid table: even channel ``i`` holds
    ``sin(pos / 10000^(2i/d))`` and odd channel ``i+1`` holds
    ``cos(pos / 10000^(2(i+1)/d))``, with ``i`` the channel index itself,
    not a pair index (so it is not TRX's table, ``heads/trx.py``)."""
    pos = np.arange(seq_len, dtype=np.float64)[:, None]
    i = np.arange(0, dim, 2, dtype=np.float64)[None, :]
    table = np.zeros((seq_len, dim), dtype=np.float64)
    table[:, 0::2] = np.sin(pos / np.power(10000.0, 2 * i / dim))
    n_odd = table[:, 1::2].shape[1]
    table[:, 1::2] = np.cos(
        pos / np.power(10000.0, 2 * (i[:, :n_odd] + 1) / dim))
    return table.astype(np.float32)


class PositionalEncoder(nn.Module):
    """``x * sqrt(D / A) + B * PE`` over the second-to-last axis, then
    dropout."""

    def __init__(self, dim: int, max_len: int = 20, scale_a: float = 10.0,
                 scale_b: float = 1.0, dropout: float = 0.1):
        super().__init__()
        self.dim, self.scale_a, self.scale_b = dim, scale_a, scale_b
        self.register_buffer("table", torch.from_numpy(
            sinusoidal_positions(max_len, dim)), persistent=False)
        self.drop = nn.Dropout(dropout)

    def forward(self, x):
        # the square root is taken in x's dtype, as the JAX module takes it
        x = x * torch.sqrt(torch.tensor(self.dim / self.scale_a,
                                        dtype=x.dtype, device=x.device))
        x = x + self.scale_b * self.table[: x.shape[-2]].to(x.dtype)
        return self.drop(x)
