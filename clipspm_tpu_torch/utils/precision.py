"""The port's precision rule for norms, softmaxes, losses and the DPs."""

from __future__ import annotations

import torch


def fp32_or_wider(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or as it is when it is wider (fp64). Under bf16
    autocast the norms, softmaxes, losses and DPs run in fp32; a model run
    in fp64 (``chip_smoke.py``'s reference train step) stays fp64
    throughout."""
    return x if x.dtype == torch.float64 else x.float()
