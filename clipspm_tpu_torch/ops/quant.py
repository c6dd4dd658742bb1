"""Dynamic symmetric int8 matmul for evaluation (``MODEL.INT8_EVAL``).

Port of ``clipspm_tpu/ops/quant.py``: ``y = (sx . sw) * (q(x) @ q(w))``
with per-row activation scales ``sx = max|x_row| / 127`` and per-output-
channel weight scales ``sw = max|w_row| / 127`` (both floored at 1e-8; the
division as compiled XLA computes it, :func:`quantize_rows`),
codes ``round(v / s)`` (half to even, as ``jnp.round``), int32 sums, then
``acc * sx * sw (+ bias)`` in fp32 and a cast back to the input's dtype.
The weight keeps ``nn.Linear``'s ``[M, K]`` layout (the JAX kernel is its
transpose), so the same parameters drive the float and the int8 path.

The product of the codes, :func:`int8_mm`:

- on the card, ``torch._int_mm`` (cuBLASLt's int8 tensor-core GEMM: the
  JAX package leaves this product to XLA, outside any Pallas kernel). A
  shape it refuses raises; nothing falls back to a float product. Each call
  adds one to ``launches``, and a tower's CUDA-graph replay the GEMMs it
  holds (``models/tower_graph.py``);
- on the CPU, the plain version :func:`int8_mm_plain`: the codes
  multiplied in float64, which is exact (``127 * 127 * K < 2**53``), so the
  card's int32 sums must equal it bit for bit.

Evaluation only: rounding has no gradient, so the ViT blocks take this
path only outside training (``backbones/clip.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

launches = 0


def quantize_rows(x: torch.Tensor, tp=None) -> tuple:
    """Codes and scales of each row of fp32 ``x [..., K]``: ``(int8 [...,
    K], fp32 [..., 1])``. The scale is ``max|x|`` times the fp32 reciprocal
    of 127: XLA compiles the JAX package's division by the constant so,
    and so does PyTorch's CUDA division by a scalar, where the CPU's
    divides; one rule keeps the card's codes equal to the CPU's. With
    ``tp`` (a ``parallel/tensor.py:TPContext``) the rows are shards of
    rows cut over the tp ranks, and ``max|x|`` is the whole row's."""
    amax = x.abs().amax(-1, keepdim=True)
    if tp is not None:
        tp.max_(amax)
    s = torch.clamp_min(amax * (1.0 / 127.0), 1e-8)
    return torch.round(x / s).to(torch.int8), s


def int8_mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [R, K] @ b[M, K]^T`` of int8 codes as int32, through float64."""
    return torch.matmul(a.double(), b.double().t()).to(torch.int32)


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [R, K] @ b [M, K]^T`` of int8 codes with int32 sums: the int8
    GEMM on the card (it raises for a shape it does not take: R <= 16, or K
    or M not a multiple of 8), the plain version on the CPU."""
    global launches
    if a.device.type == "cpu":
        return int8_mm_plain(a, b)
    out = torch._int_mm(a, b.t())
    launches += 1
    return out


def int8_linear(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, tp=None) -> torch.Tensor:
    """``F.linear(x, weight, bias)`` with dynamic int8 quantisation: ``x
    [..., K]``, ``weight [M, K]``, ``bias [M]``; returns ``[..., M]`` in
    ``x.dtype``. Quantises from the fp32 view of ``x`` with autocast off,
    as the JAX package does. With ``tp`` the layer is row-parallel: ``x``
    and ``weight`` hold this rank's share of K, the scales are taken over
    the whole of K and the int32 sums added over the tp ranks before the
    rescale, so each rank computes what one rank computes from the whole."""
    K = x.shape[-1]
    with torch.autocast(x.device.type, enabled=False):
        xq, sx = quantize_rows(x.float(), tp)
        wq, sw = quantize_rows(weight.float(), tp)
        acc = int8_mm(xq.reshape(-1, K), wq)
        if tp is not None:
            tp.sum_(acc)
        y = acc.float() * sx.reshape(-1, 1) * sw.reshape(1, -1)
        if bias is not None:
            y = y + bias.float()
    return y.reshape(tuple(x.shape[:-1]) + (weight.shape[0],)).to(x.dtype)
