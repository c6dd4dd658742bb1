"""PyTorch / CUDA port of clipspm_tpu for NVIDIA Hopper (H100).

The JAX package ``clipspm_tpu`` is the reference; this package mirrors its
layout module for module and imports nothing from it. Plain tensor code is
PyTorch; each Pallas kernel of the reference on a ported path is a
hand-written CUDA C++ kernel under ``csrc/`` with a plain PyTorch version
beside it (the CPU path and the kernel's oracle).

Entry points run on ``cuda`` unless the caller asks for the CPU: with no GPU
visible and no explicit CPU request they raise instead of carrying on
quietly on the host.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise. Raises when CUDA is asked for (explicitly or by default) and
    no GPU is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: clipspm_tpu_torch runs on the GPU "
            "unless asked for the CPU (device='cpu', CLI --device cpu)")
    return dev


def set_matmul_precision(use_amp: bool) -> None:
    """State the fp32 matmul/conv precision explicitly: TF32 only under
    ``USE_AMP`` (bf16 compute), full fp32 otherwise."""
    torch.backends.cuda.matmul.allow_tf32 = bool(use_amp)
    torch.backends.cudnn.allow_tf32 = bool(use_amp)

