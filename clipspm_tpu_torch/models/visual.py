"""Visual-tower construction helpers (leaf module: no head imports)."""

from __future__ import annotations

import torch
from torch import nn

from .backbones.clip import make_clip_visual  # noqa: F401 (re-export)


def encode_chunked(backbone: nn.Module, frames: torch.Tensor,
                   chunk: int) -> torch.Tensor:
    """Encode ``[N, ...]`` frames through ``backbone``, ``chunk`` frames per
    call (0 or >= N: one call). A memory knob only: it caps the activations
    held at once; per-frame results are those of one batched call."""
    N = frames.shape[0]
    if not chunk or chunk >= N:
        return backbone(frames)
    return torch.cat([backbone(frames[i:i + chunk])
                      for i in range(0, N, chunk)], dim=0)

