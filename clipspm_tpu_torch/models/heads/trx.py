"""TRX head: temporal-relational cross-transformers over frame tuples.

Port of ``clipspm_tpu/models/heads/trx.py``. For each cardinality of
``MODEL.TEMP_SET`` (default 2 and 3: C(8,2)=28 and C(8,3)=56 tuples of 8
frames), the frames' tuples in ``itertools.combinations`` order attend, per
class, to that class's support tuples; the query's distance to the resulting
query-specific prototype, negated and averaged over cardinalities, is the
logit. No kernel: dense layers and einsums. Under bf16 autocast the key and
value projections run in bf16; the key LayerNorm, keys, values, scores,
softmax and distances run in fp32, as the JAX head casts them.
"""

from __future__ import annotations

import math
from itertools import combinations
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ...utils.precision import fp32_or_wider
from ..blocks import group_by_class
from ..visual import ResNetVideoModel, compute_autocast, fp32_context


def trx_positional_table(max_len: int, d_model: int,
                         scale: float = 0.1) -> np.ndarray:
    """``[max_len, d_model]`` sin/cos table over frame pairs of channels,
    times ``scale``."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                 * -(math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model))
    pe[:, 0::2] = np.sin(pos * div) * scale
    pe[:, 1::2] = np.cos(pos * div) * scale
    return pe.astype(np.float32)


class FrameTuples(nn.Module):
    """The frame tuples of one cardinality: ``[N, T, D]`` ->
    ``[N, n_tuples, set_size * D]``, tuples in ``itertools.combinations``
    order, each tuple's frames concatenated."""

    def __init__(self, seq_len: int, set_size: int):
        super().__init__()
        tuples = np.asarray(list(combinations(range(seq_len), set_size)))
        self.n_tuples = len(tuples)
        self.register_buffer("index", torch.from_numpy(tuples.reshape(-1)),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x[:, self.index].reshape(x.shape[0], self.n_tuples, -1)


class TemporalCrossTransformer(nn.Module):
    """One cardinality's cross-transformer: ``(support [S, T, D], labels,
    queries [Q, T, D])`` -> logits ``[Q, way]``."""

    def __init__(self, way: int, shot: int, seq_len: int, in_dim: int,
                 out_dim: int, set_size: int, dropout: float = 0.1):
        super().__init__()
        self.way, self.shot, self.seq_len = way, shot, seq_len
        self.out_dim = out_dim
        self.tuples = FrameTuples(seq_len, set_size)
        self.register_buffer("pe", torch.from_numpy(trx_positional_table(
            int(seq_len * 1.5), in_dim)[:seq_len]), persistent=False)
        self.drop = nn.Dropout(dropout)
        self.k_linear = nn.Linear(set_size * in_dim, out_dim)
        self.v_linear = nn.Linear(set_size * in_dim, out_dim)
        self.norm_k = nn.LayerNorm(out_dim, eps=1e-5)

    def forward(self, support, support_labels, queries) -> torch.Tensor:
        s_t = self.tuples(self.drop(support + self.pe.to(support.dtype)))
        q_t = self.tuples(self.drop(queries + self.pe.to(queries.dtype)))
        s_k, q_k = self.k_linear(s_t), self.k_linear(q_t)
        s_v, q_v = self.v_linear(s_t), self.v_linear(q_t)
        with fp32_context(support.device):
            s_k = self.norm_k(fp32_or_wider(s_k))
            q_k = self.norm_k(fp32_or_wider(q_k))
            s_v, q_v = fp32_or_wider(s_v), fp32_or_wider(q_v)
            # class-grouped keys and values: [way, shot, nt, od]
            c_k = group_by_class(s_k, support_labels, self.way, self.shot)
            c_v = group_by_class(s_v, support_labels, self.way, self.shot)
            nt, Q = self.tuples.n_tuples, q_k.shape[0]
            scores = torch.einsum("qtd,wsud->wqtsu", q_k, c_k) \
                / math.sqrt(self.out_dim)
            # softmax over all of a class's support tuples
            attn = torch.softmax(
                scores.reshape(self.way, Q, nt, self.shot * nt), dim=-1
            ).reshape(self.way, Q, nt, self.shot, nt)
            proto = torch.einsum("wqtsu,wsud->wqtd", attn, c_v)
            diff = q_v[None] - proto                       # [way, Q, nt, od]
            norm_sq = (diff * diff).sum(dim=(-2, -1))
            return (-(norm_sq / nt)).T                     # [Q, way]


class TRXModel(ResNetVideoModel):
    """ResNet trunk (pooled output) + one ``TemporalCrossTransformer`` per
    cardinality (``tct_<n>``). ``encode`` gives ``[N, T, D]``;
    ``match_features`` returns dict(logits=``[1, Q, way]``)."""

    def __init__(self, way: int, shot: int, seq_len: int = 8,
                 temp_set: Sequence[int] = (2, 3), out_dim: int = 1152,
                 arch: str = "resnet50", backbone_width: int = 64,
                 dropout: float = 0.1, encode_chunk: int = 0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(way, shot, arch, backbone_width, "pooled",
                         encode_chunk, compute_dtype)
        self.seq_len, self.temp_set = seq_len, tuple(temp_set)
        for s in self.temp_set:
            self.add_module(f"tct_{s}", TemporalCrossTransformer(
                way, shot, seq_len, self.backbone.feature_dim, out_dim, s,
                dropout))

    def match_features(self, su, qu, support_labels, real_support_labels=None,
                       real_target_labels=None, text_train=None,
                       text_test=None) -> Dict[str, torch.Tensor]:
        """Head over precomputed features ``su [S,T,D]`` / ``qu [Q,T,D]``.
        The text tables are not read."""
        with compute_autocast(su.device, self.compute_dtype):
            logits = torch.stack(
                [getattr(self, f"tct_{s}")(su, support_labels, qu)
                 for s in self.temp_set], dim=-1).mean(dim=-1)
        return {"logits": logits[None]}
