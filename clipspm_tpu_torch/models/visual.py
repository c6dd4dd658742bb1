"""Visual-tower construction helpers (leaf module: no head imports)."""

from __future__ import annotations

import functools
from contextlib import nullcontext
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .backbones.clip import make_clip_visual  # noqa: F401 (re-export)

# What each remat policy of the chunked train encode keeps across the
# recompute, named as the JAX package names them (clipspm_tpu/models/
# visual.py:encode_chunked): a test on the aten op that made a tensor.
# "full" keeps nothing; "attn_out" each block's attention output (the
# scaled_dot_product_attention op, ``_Attention`` in backbones/clip.py);
# "dots" every matmul without batch dimensions (the projections and the
# MLP, not the attention's batched products).
_SAVED_BY_POLICY = {
    "full": None,
    "attn_out": lambda op: "scaled_dot_product" in str(op),
    "dots": lambda op: op in (torch.ops.aten.mm.default,
                              torch.ops.aten.addmm.default),
}
# the JAX package's policies that need tensors the port's ops do not expose
# (the post-softmax attention probabilities; the MLP's gelu output)
_NOT_PORTED_POLICIES = ("attn", "mlp")


def check_remat_policy(policy: str) -> None:
    """Refuse a ``MODEL.TRAIN_REMAT_POLICY`` the port does not honour."""
    if policy in _NOT_PORTED_POLICIES:
        raise NotImplementedError(
            f"MODEL.TRAIN_REMAT_POLICY={policy!r} is not ported yet "
            "(ROADMAP.md, open item 'remat policies attn and mlp'); the port "
            f"honours {sorted(_SAVED_BY_POLICY)}")
    if policy not in _SAVED_BY_POLICY:
        known = sorted(_SAVED_BY_POLICY) + list(_NOT_PORTED_POLICIES)
        raise ValueError(f"unknown remat policy {policy!r}; expected one of "
                         f"{known}")


def _remat_context(policy: str):
    check_remat_policy(policy)
    saved = _SAVED_BY_POLICY[policy]
    if saved is None:
        return None

    def policy_fn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if saved(op)
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


def compute_autocast(device: torch.device,
                     compute_dtype: Optional[torch.dtype]):
    """The model's compute context: autocast to ``compute_dtype`` on
    ``device``, or nothing when it is None (fp32)."""
    if compute_dtype is None:
        return nullcontext()
    return torch.autocast(device.type, dtype=compute_dtype)


def encode_chunked(backbone: nn.Module, frames: torch.Tensor, chunk: int,
                   train_chunk: int = 0,
                   remat_policy: str = "attn_out") -> torch.Tensor:
    """Encode ``[N, ...]`` frames through ``backbone``, ``chunk`` frames per
    call (0 or >= N: one call).

    In eval mode a memory knob only: it caps the activations held at once;
    per-frame results are those of one batched call. In train mode it is
    one call unless ``train_chunk`` is set (1 reuses ``chunk``, more is the
    width): then each chunk runs under ``torch.utils.checkpoint`` and its
    backward recomputes the chunk's activations, keeping only what
    ``remat_policy`` names (``check_remat_policy``). The frames are padded
    with leading frames to whole chunks and the output cut to ``N``, as in
    the JAX package's scan. Remat changes what is stored, not the
    arithmetic; only towers without BatchNorm take it (``build_model``
    refuses the rest: per-chunk batch statistics would differ).
    """
    N = frames.shape[0]
    if backbone.training:
        chunk = chunk if train_chunk == 1 else int(train_chunk)
        if not chunk or chunk >= N:
            return backbone(frames)
        pad = (-N) % chunk
        if pad:
            frames = torch.cat([frames, frames[:pad]], dim=0)
        context = _remat_context(remat_policy)
        kw = {} if context is None else {"context_fn": context}
        feats = torch.cat([
            checkpoint(backbone, frames[i:i + chunk], use_reentrant=False,
                       **kw) for i in range(0, frames.shape[0], chunk)])
        return feats[:N]
    if not chunk or chunk >= N:
        return backbone(frames)
    return torch.cat([backbone(frames[i:i + chunk])
                      for i in range(0, N, chunk)], dim=0)
