"""Operand rounding for the reference's products: float32 as it is, or the
control's float8 (e4m3, one scale a tensor, its largest magnitude at the
format's largest value), the step below the bfloat16 that the
configurations state. The float8 rounding passes gradients through
unchanged, so the control's backward stays in float32."""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def fp32(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (q - x).detach() if x.requires_grad else q


PRECISIONS = {"fp32": fp32, "fp8": fp8}
