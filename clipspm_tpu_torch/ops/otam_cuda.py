"""Kernel K1: the OTAM band DP as a hand-written CUDA kernel.

K1 (``csrc/otam_dp.cu``) replaces ``clipspm_tpu/ops/otam_pallas.py:
_otam_kernel``. One thread owns one (query, support) table and walks it row
by row with one rolling row in registers; see the source for the design. At
the main-path sizes K1 is bound neither by bytes nor by FLOPs (about 6.4 KB
is read per launch at B=25) but by latency: the launch plus one thread's
serial chain of dependent soft-mins.

``otam_cum_dist`` has the signature of ``ops/otam.py:otam_cum_dist``. A CUDA
tensor launches K1; a CPU tensor takes the plain wavefront. Nothing falls
back from the kernel to the plain version. (The config key
``MODEL.OTAM_BACKEND`` picks between two JAX implementations of this same
function; the port does not read it.)

The gradient is a ``torch.autograd.Function`` whose backward replays the
plain wavefront under autograd on the saved tables, as the JAX custom VJP
does (``otam_pallas.py:146-149``).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .otam import otam_cum_dist as plain_cum_dist

# Launches of K1 since the count was last set to 0 (read by chip_smoke.py
# to show that a run went through the kernel).
launches = 0

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("otam_dp")
        lib.otam_dp_launch.restype = ctypes.c_int
        lib.otam_dp_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        lib.otam_dp_max_m.restype = ctypes.c_int
        lib.otam_dp_max_m.argtypes = []
        _lib = lib
    return _lib


def otam_dp_cuda(tables: torch.Tensor, lbda: float) -> torch.Tensor:
    """Launch K1 on contiguous fp32 CUDA tables ``[B, L, Ms]`` -> ``[B]``."""
    global launches
    if tables.device.type != "cuda":
        raise ValueError(f"K1 takes CUDA tensors, got {tables.device}")
    if tables.dtype != torch.float32:
        raise TypeError(f"K1 takes float32 tables, got {tables.dtype}")
    if tables.dim() != 3 or not tables.is_contiguous():
        raise ValueError("K1 takes contiguous [B, L, Ms] tables, got shape "
                         f"{tuple(tables.shape)} (contiguous="
                         f"{tables.is_contiguous()})")
    B, L, Ms = tables.shape
    if L < 1 or Ms < 1:
        raise ValueError(f"K1 needs L, Ms >= 1, got {tuple(tables.shape)}")
    lib = _library()
    if Ms + 2 > lib.otam_dp_max_m():
        raise ValueError(f"K1 takes Ms + 2 <= {lib.otam_dp_max_m()}, got "
                         f"Ms={Ms}")
    out = torch.empty(B, device=tables.device, dtype=torch.float32)
    if B == 0:
        return out
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream(tables.device).cuda_stream
        rc = lib.otam_dp_launch(tables.data_ptr(), out.data_ptr(), B, L, Ms,
                                float(lbda), stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {rc}")
    launches += 1
    return out


class _OtamDP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tables, lbda):
        ctx.save_for_backward(tables)
        ctx.lbda = lbda
        return otam_dp_cuda(tables, lbda)

    @staticmethod
    def backward(ctx, grad_out):
        (tables,) = ctx.saved_tensors
        with torch.enable_grad():
            t = tables.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(plain_cum_dist(t, ctx.lbda), t,
                                          grad_out)
        return grad, None


def otam_cum_dist(dists: torch.Tensor, lbda: float = 0.5) -> torch.Tensor:
    """Batched OTAM cumulative distance over ``[..., L, Ms]`` tables.

    K1 on a CUDA tensor, the plain wavefront on a CPU tensor. Returns
    ``[...]`` fp32."""
    if dists.device.type == "cpu":
        return plain_cum_dist(dists, lbda)
    batch_shape = dists.shape[:-2]
    L, Ms = dists.shape[-2], dists.shape[-1]
    tables = dists.reshape(-1, L, Ms).contiguous()
    return _OtamDP.apply(tables, float(lbda)).reshape(batch_shape)
