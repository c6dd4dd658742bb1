"""Visual-tower construction helpers (leaf module: no head imports)."""

from __future__ import annotations

from contextlib import nullcontext
from typing import Optional

import torch
from torch import nn

from .backbones.clip import make_clip_visual  # noqa: F401 (re-export)


def compute_autocast(device: torch.device,
                     compute_dtype: Optional[torch.dtype]):
    """The model's compute context: autocast to ``compute_dtype`` on
    ``device``, or nothing when it is None (fp32)."""
    if compute_dtype is None:
        return nullcontext()
    return torch.autocast(device.type, dtype=compute_dtype)


def encode_chunked(backbone: nn.Module, frames: torch.Tensor,
                   chunk: int) -> torch.Tensor:
    """Encode ``[N, ...]`` frames through ``backbone``, ``chunk`` frames per
    call (0 or >= N: one call). A memory knob only: it caps the activations
    held at once; per-frame results are those of one batched call. In train
    mode it is one call whatever ``chunk`` says: BatchNorm's batch
    statistics span every frame of the episode, as in the JAX package."""
    N = frames.shape[0]
    if not chunk or chunk >= N or backbone.training:
        return backbone(frames)
    return torch.cat([backbone(frames[i:i + chunk])
                      for i in range(0, N, chunk)], dim=0)
