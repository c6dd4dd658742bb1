"""Kernel K2: the soft-DTW DP as a hand-written CUDA kernel.

K2 (``csrc/softdtw_dp.cu``, shared device code in ``csrc/dp_wavefront.cuh``)
replaces ``clipspm_tpu/ops/softdtw_pallas.py:_sdtw_kernel``. One lane
segment of a warp owns one table and walks it by anti-diagonals; see the
sources for the design. Two entries, one counter of launches for both:

- table mode, ``softdtw_dp_cuda``: ``[B, N, M]`` tables -> ``[B]``, behind
  ``softdtw_from_dists`` (the signature of ``ops/softdtw.py:
  softdtw_from_dists``; ``softdtw(normalize=True)``, ``dist="l2sq"``);
- fused mode, ``softdtw_cos_padded_cuda``: x ``[B, N, D]`` and y
  ``[B, M, D]`` -> ``[B]``, what ``softdtw(x, y, normalize=False,
  dist="cos")`` computes before its trailing ``[..., None]``: the cosine
  table, the query-axis padding and both directions in one launch, behind
  ``softdtw_cos_padded``.

A CUDA tensor launches K2; a CPU tensor takes the plain version (the
wavefront, and ``ops/softdtw.py:softdtw_cos_padded_plain``). Nothing falls
back from the kernel to the plain version: an entry given what it cannot
take raises before anything is built.

Each gradient is a ``torch.autograd.Function`` whose backward replays the
plain version under autograd, as the JAX custom VJP does
(``softdtw_pallas.py:125-127``). Under autocast the forward takes fp32
inputs with autocast off (``custom_fwd(cast_inputs=float32)``), and the
backward runs with the forward's autocast state (``custom_bwd``), so the
replay's cosine matmuls are fp32 whether ``loss.backward()`` is called
inside an autocast block or outside one, as in ``ops/otam_cuda.py``.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.metrics import span
from . import build
from .softdtw import softdtw_cos_padded_plain
from .softdtw import softdtw_from_dists as plain_from_dists

# Launches of K2, both modes, since the count was last set to 0 (read by
# chip_smoke.py to show that a run went through the kernel).
launches = 0

# Widest table (csrc/softdtw_dp.cu, kMaxM): M <= 32 in table mode; up to 32
# steps on either side in fused mode (its table is read both ways).
MAX_COLS = 32

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("softdtw_dp")
        lib.softdtw_dp_launch.restype = ctypes.c_int
        lib.softdtw_dp_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        lib.softdtw_cos_padded_launch.restype = ctypes.c_int
        lib.softdtw_cos_padded_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_void_p]
        _lib = lib
    return _lib


def _check(x: torch.Tensor, what: str, layout: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"K2 takes CUDA tensors, got {what} on {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"K2 takes float32 {what}, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"K2 takes contiguous {layout} {what}, got shape "
                         f"{tuple(x.shape)} (contiguous={x.is_contiguous()})")


def _launched(rc: int) -> None:
    global launches
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {rc}")
    launches += 1


def softdtw_dp_cuda(tables: torch.Tensor, gamma: float,
                    bandwidth: float = 0.0) -> torch.Tensor:
    """K2's table mode on contiguous fp32 CUDA tables ``[B, N, M]`` ->
    ``[B]``."""
    _check(tables, "tables", "[B, N, M]")
    B, N, M = tables.shape
    if N < 1 or not 1 <= M <= MAX_COLS:
        raise ValueError(f"K2 takes N >= 1 and 1 <= M <= {MAX_COLS}, got "
                         f"{tuple(tables.shape)}")
    out = torch.empty(B, device=tables.device, dtype=torch.float32)
    if B == 0:
        return out
    lib = _library()
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream(tables.device).cuda_stream
        rc = lib.softdtw_dp_launch(tables.data_ptr(), out.data_ptr(), B, N, M,
                                   float(gamma), float(bandwidth), stream)
    _launched(rc)
    return out


def softdtw_cos_padded_cuda(x: torch.Tensor, y: torch.Tensor, gamma: float,
                            bandwidth: float = 0.0) -> torch.Tensor:
    """K2's fused mode on contiguous fp32 CUDA sequences x ``[B, N, D]`` and
    y ``[B, M, D]`` -> ``[B]``."""
    _check(x, "x", "[B, N, D]")
    _check(y, "y", "[B, M, D]")
    if x.device != y.device:
        raise ValueError(f"K2 takes x and y on one device, got {x.device} "
                         f"and {y.device}")
    B, N, D = x.shape
    By, M, Dy = y.shape
    if By != B or Dy != D or D < 1:
        raise ValueError(f"K2 takes one batch and one feature width D >= 1, "
                         f"got x {tuple(x.shape)} and y {tuple(y.shape)}")
    if not (1 <= N <= MAX_COLS and 1 <= M <= MAX_COLS):
        raise ValueError(f"K2's fused mode takes 1 to {MAX_COLS} steps a "
                         f"side, got N={N}, M={M}")
    out = torch.empty(B, device=x.device, dtype=torch.float32)
    if B == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.softdtw_cos_padded_launch(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), B, N, M, D,
            float(gamma), float(bandwidth), stream)
    _launched(rc)
    return out


_fwd = torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.float32)
_bwd = torch.amp.custom_bwd(device_type="cuda")


class _SoftDTW(torch.autograd.Function):
    @staticmethod
    @_fwd
    def forward(ctx, tables, gamma, bandwidth):
        ctx.save_for_backward(tables)
        ctx.gamma, ctx.bandwidth = gamma, bandwidth
        return softdtw_dp_cuda(tables, gamma, bandwidth)

    @staticmethod
    @_bwd
    def backward(ctx, grad_out):
        (tables,) = ctx.saved_tensors
        with span("softdtw.backward", tables=lambda: tuple(tables.shape)), \
                torch.enable_grad():
            t = tables.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(
                plain_from_dists(t, ctx.gamma, ctx.bandwidth), t, grad_out)
        return grad, None, None


class _SoftDTWCosPadded(torch.autograd.Function):
    @staticmethod
    @_fwd
    def forward(ctx, x, y, gamma, bandwidth):
        ctx.save_for_backward(x, y)
        ctx.gamma, ctx.bandwidth = gamma, bandwidth
        return softdtw_cos_padded_cuda(x, y, gamma, bandwidth)

    @staticmethod
    @_bwd
    def backward(ctx, grad_out):
        x, y = ctx.saved_tensors
        with span("softdtw.backward", x=lambda: tuple(x.shape),
                  y=lambda: tuple(y.shape)), torch.enable_grad():
            tx = x.detach().requires_grad_(True)
            ty = y.detach().requires_grad_(True)
            gx, gy = torch.autograd.grad(
                softdtw_cos_padded_plain(tx, ty, ctx.gamma, ctx.bandwidth),
                (tx, ty), grad_out)
        return gx, gy, None, None


def softdtw_from_dists(D: torch.Tensor, gamma: float = 1.0,
                       bandwidth: float = 0.0) -> torch.Tensor:
    """Soft-DTW values ``R[N, M]`` of ``[..., N, M]`` tables.

    K2's table mode on a CUDA tensor, the plain wavefront on a CPU tensor.
    Returns ``[...]`` fp32."""
    if D.device.type == "cpu":
        return plain_from_dists(D, gamma, bandwidth)
    batch_shape = D.shape[:-2]
    N, M = D.shape[-2], D.shape[-1]
    tables = D.reshape(-1, N, M).to(torch.float32).contiguous()
    return _SoftDTW.apply(tables, float(gamma),
                          float(bandwidth)).reshape(batch_shape)


def softdtw_cos_padded(x: torch.Tensor, y: torch.Tensor, gamma: float = 1.0,
                       bandwidth: float = 0.0) -> torch.Tensor:
    """The padded forward/reverse soft-DTW average over the ``1 - cos``
    tables of x ``[..., N, D]`` and y ``[..., M, D]`` (one batch shape):
    K2's fused mode, one launch, on a CUDA tensor (the sequences made
    contiguous fp32 once); the plain composition on a CPU tensor. Returns
    ``[...]`` fp32."""
    if x.device.type == "cpu":
        return softdtw_cos_padded_plain(x, y, gamma, bandwidth)
    batch_shape = x.shape[:-2]
    if y.shape[:-2] != batch_shape:
        raise ValueError(f"K2 takes x and y of one batch shape, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    xs = x.reshape(-1, *x.shape[-2:]).to(torch.float32).contiguous()
    ys = y.reshape(-1, *y.shape[-2:]).to(torch.float32).contiguous()
    return _SoftDTWCosPadded.apply(xs, ys, float(gamma),
                                   float(bandwidth)).reshape(batch_shape)
