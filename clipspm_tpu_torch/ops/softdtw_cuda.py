"""Kernel K2: the soft-DTW DP as a hand-written CUDA kernel.

K2 (``csrc/softdtw_dp.cu``) replaces ``clipspm_tpu/ops/softdtw_pallas.py:
_sdtw_kernel``. One thread owns one distance table and walks it row by row
with one rolling row in registers; see the source for the design. On the
TA2N head (25 tables of 10 x 8 per launch, two launches per episode) K2 is
bound neither by bytes nor by FLOPs but by latency: the launch plus one
thread's serial chain of dependent soft-mins.

``softdtw_from_dists`` has the signature of ``ops/softdtw.py:
softdtw_from_dists``. A CUDA tensor launches K2; a CPU tensor takes the plain
wavefront. Nothing falls back from the kernel to the plain version.

The gradient is a ``torch.autograd.Function`` whose backward replays the
plain wavefront under autograd on the saved tables, as the JAX custom VJP
does (``softdtw_pallas.py:125-127``).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .softdtw import softdtw_from_dists as plain_from_dists

# Launches of K2 since the count was last set to 0 (read by chip_smoke.py
# to show that a run went through the kernel).
launches = 0

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("softdtw_dp")
        lib.softdtw_dp_launch.restype = ctypes.c_int
        lib.softdtw_dp_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        lib.softdtw_dp_max_m.restype = ctypes.c_int
        lib.softdtw_dp_max_m.argtypes = []
        _lib = lib
    return _lib


def softdtw_dp_cuda(tables: torch.Tensor, gamma: float,
                    bandwidth: float = 0.0) -> torch.Tensor:
    """Launch K2 on contiguous fp32 CUDA tables ``[B, N, M]`` -> ``[B]``."""
    global launches
    if tables.device.type != "cuda":
        raise ValueError(f"K2 takes CUDA tensors, got {tables.device}")
    if tables.dtype != torch.float32:
        raise TypeError(f"K2 takes float32 tables, got {tables.dtype}")
    if tables.dim() != 3 or not tables.is_contiguous():
        raise ValueError("K2 takes contiguous [B, N, M] tables, got shape "
                         f"{tuple(tables.shape)} (contiguous="
                         f"{tables.is_contiguous()})")
    B, N, M = tables.shape
    if N < 1 or M < 1:
        raise ValueError(f"K2 needs N, M >= 1, got {tuple(tables.shape)}")
    lib = _library()
    if M > lib.softdtw_dp_max_m():
        raise ValueError(f"K2 takes M <= {lib.softdtw_dp_max_m()}, got M={M}")
    out = torch.empty(B, device=tables.device, dtype=torch.float32)
    if B == 0:
        return out
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream(tables.device).cuda_stream
        rc = lib.softdtw_dp_launch(tables.data_ptr(), out.data_ptr(), B, N, M,
                                   float(gamma), float(bandwidth), stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {rc}")
    launches += 1
    return out


class _SoftDTW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tables, gamma, bandwidth):
        ctx.save_for_backward(tables)
        ctx.gamma, ctx.bandwidth = gamma, bandwidth
        return softdtw_dp_cuda(tables, gamma, bandwidth)

    @staticmethod
    def backward(ctx, grad_out):
        (tables,) = ctx.saved_tensors
        with torch.enable_grad():
            t = tables.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(
                plain_from_dists(t, ctx.gamma, ctx.bandwidth), t, grad_out)
        return grad, None, None


def softdtw_from_dists(D: torch.Tensor, gamma: float = 1.0,
                       bandwidth: float = 0.0) -> torch.Tensor:
    """Soft-DTW values ``R[N, M]`` of ``[..., N, M]`` tables.

    K2 on a CUDA tensor, the plain wavefront on a CPU tensor. Returns
    ``[...]`` fp32."""
    if D.device.type == "cpu":
        return plain_from_dists(D, gamma, bandwidth)
    batch_shape = D.shape[:-2]
    N, M = D.shape[-2], D.shape[-1]
    tables = D.reshape(-1, N, M).to(torch.float32).contiguous()
    return _SoftDTW.apply(tables, float(gamma),
                          float(bandwidth)).reshape(batch_shape)
