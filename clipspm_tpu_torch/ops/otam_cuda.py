"""Kernel K1: the OTAM band DP as a hand-written CUDA kernel.

K1 (``csrc/otam_dp.cu``, shared device code in ``csrc/dp_wavefront.cuh``)
replaces ``clipspm_tpu/ops/otam_pallas.py:_otam_kernel``. One lane segment
of a warp owns one table and walks it by anti-diagonals; see the sources
for the design. Two entries, one counter of launches for both:

- table mode, ``otam_dp_cuda``: ``[B, L, Ms]`` tables -> ``[B]``, behind
  ``otam_cum_dist`` (the signature of ``ops/otam.py:otam_cum_dist``);
- fused mode, ``otam_distance_cuda``: support ``[S, L, D]`` and query
  ``[Q, L, D]`` frame features -> ``[Q, S]``: the cosine table and both DP
  directions in one launch, behind ``otam_distance`` (``ops/otam.py:
  otam_distance`` on a CUDA tensor).

A CUDA tensor launches K1; a CPU tensor takes the plain version (the
wavefront, and ``ops/otam.py:otam_distance_plain``). Nothing falls back from
the kernel to the plain version: an entry given what it cannot take raises
before anything is built. (The config key ``MODEL.OTAM_BACKEND`` picks
between two JAX implementations of this same function; the port does not
read it.)

Each gradient is a ``torch.autograd.Function`` whose backward replays the
plain version under autograd, as the JAX custom VJP does
(``otam_pallas.py:146-149``). Under autocast the forward takes fp32 inputs
with autocast off (``custom_fwd(cast_inputs=float32)``), and the backward
runs with the forward's autocast state (``custom_bwd``), so the replay is
fp32 whether ``loss.backward()`` is called inside an autocast block or, as
the trainer calls it, outside one.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.metrics import span
from . import build
from .otam import otam_cum_dist as plain_cum_dist
from .otam import otam_distance_plain

# Launches of K1, both modes, since the count was last set to 0 (read by
# chip_smoke.py to show that a run went through the kernel).
launches = 0

# Widest table (csrc/otam_dp.cu, kMaxMs): Ms + 2 <= 34 in table mode; up to
# 32 frames on either side in fused mode (its table is read both ways).
MAX_COLS = 32

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("otam_dp")
        lib.otam_dp_launch.restype = ctypes.c_int
        lib.otam_dp_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        lib.otam_distance_launch.restype = ctypes.c_int
        lib.otam_distance_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        _lib = lib
    return _lib


def _check(x: torch.Tensor, what: str, layout: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"K1 takes CUDA tensors, got {what} on {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"K1 takes float32 {what}, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"K1 takes contiguous {layout} {what}, got shape "
                         f"{tuple(x.shape)} (contiguous={x.is_contiguous()})")


def _launched(rc: int) -> None:
    global launches
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {rc}")
    launches += 1


def otam_dp_cuda(tables: torch.Tensor, lbda: float) -> torch.Tensor:
    """K1's table mode on contiguous fp32 CUDA tables ``[B, L, Ms]`` ->
    ``[B]``."""
    _check(tables, "tables", "[B, L, Ms]")
    B, L, Ms = tables.shape
    if L < 1 or not 1 <= Ms <= MAX_COLS:
        raise ValueError(f"K1 takes L >= 1 and 1 <= Ms <= {MAX_COLS} "
                         f"(Ms + 2 <= {MAX_COLS + 2}), got "
                         f"{tuple(tables.shape)}")
    out = torch.empty(B, device=tables.device, dtype=torch.float32)
    if B == 0:
        return out
    lib = _library()
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream(tables.device).cuda_stream
        rc = lib.otam_dp_launch(tables.data_ptr(), out.data_ptr(), B, L, Ms,
                                float(lbda), stream)
    _launched(rc)
    return out


def otam_distance_cuda(support: torch.Tensor, query: torch.Tensor,
                       lbda: float, bidirectional: bool,
                       epsilon: float) -> torch.Tensor:
    """K1's fused mode on contiguous fp32 CUDA features: support
    ``[S, Ls, D]`` and query ``[Q, Lq, D]`` -> ``[Q, S]``."""
    _check(support, "support", "[S, L, D]")
    _check(query, "query", "[Q, L, D]")
    if support.device != query.device:
        raise ValueError(f"K1 takes support and query on one device, got "
                         f"{support.device} and {query.device}")
    S, Ls, D = support.shape
    Q, Lq, Dq = query.shape
    if Dq != D or D < 1:
        raise ValueError(f"K1 takes one feature width D >= 1, got support "
                         f"{tuple(support.shape)} and query "
                         f"{tuple(query.shape)}")
    if not (1 <= Ls <= MAX_COLS and 1 <= Lq <= MAX_COLS):
        raise ValueError(f"K1's fused mode takes 1 to {MAX_COLS} frames a "
                         f"side, got Ls={Ls}, Lq={Lq}")
    out = torch.empty(Q, S, device=support.device, dtype=torch.float32)
    if Q == 0 or S == 0:
        return out
    lib = _library()
    with torch.cuda.device(support.device):
        stream = torch.cuda.current_stream(support.device).cuda_stream
        rc = lib.otam_distance_launch(
            support.data_ptr(), query.data_ptr(), out.data_ptr(), S, Ls, Q,
            Lq, D, float(lbda), float(epsilon), int(bool(bidirectional)),
            stream)
    _launched(rc)
    return out


_fwd = torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.float32)
_bwd = torch.amp.custom_bwd(device_type="cuda")


class _OtamDP(torch.autograd.Function):
    @staticmethod
    @_fwd
    def forward(ctx, tables, lbda):
        ctx.save_for_backward(tables)
        ctx.lbda = lbda
        return otam_dp_cuda(tables, lbda)

    @staticmethod
    @_bwd
    def backward(ctx, grad_out):
        (tables,) = ctx.saved_tensors
        with span("otam.backward", tables=lambda: tuple(tables.shape)), \
                torch.enable_grad():
            t = tables.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(plain_cum_dist(t, ctx.lbda), t,
                                          grad_out)
        return grad, None


class _OtamDistance(torch.autograd.Function):
    @staticmethod
    @_fwd
    def forward(ctx, support, query, lbda, bidirectional, epsilon):
        ctx.save_for_backward(support, query)
        ctx.args = (lbda, bidirectional, epsilon)
        return otam_distance_cuda(support, query, lbda, bidirectional,
                                  epsilon)

    @staticmethod
    @_bwd
    def backward(ctx, grad_out):
        support, query = ctx.saved_tensors
        with span("otam.backward", support=lambda: tuple(support.shape),
                  query=lambda: tuple(query.shape)), torch.enable_grad():
            s = support.detach().requires_grad_(True)
            q = query.detach().requires_grad_(True)
            gs, gq = torch.autograd.grad(
                otam_distance_plain(s, q, *ctx.args), (s, q), grad_out)
        return gs, gq, None, None, None


def otam_cum_dist(dists: torch.Tensor, lbda: float = 0.5) -> torch.Tensor:
    """Batched OTAM cumulative distance over ``[..., L, Ms]`` tables.

    K1's table mode on a CUDA tensor, the plain wavefront on a CPU tensor.
    Returns ``[...]`` fp32."""
    if dists.device.type == "cpu":
        return plain_cum_dist(dists, lbda)
    batch_shape = dists.shape[:-2]
    L, Ms = dists.shape[-2], dists.shape[-1]
    tables = dists.reshape(-1, L, Ms).contiguous()
    return _OtamDP.apply(tables, float(lbda)).reshape(batch_shape)


def otam_distance(support: torch.Tensor, query: torch.Tensor,
                  lbda: float = 0.5, bidirectional: bool = True,
                  epsilon: float = 0.01) -> torch.Tensor:
    """OTAM distances ``[Q, S]`` of support ``[S, L, D]`` and query
    ``[Q, L, D]`` features: K1's fused mode, one launch, on a CUDA tensor
    (the features made contiguous fp32 once); the plain composition on a
    CPU tensor."""
    if support.device.type == "cpu":
        return otam_distance_plain(support, query, lbda, bidirectional,
                                   epsilon)
    return _OtamDistance.apply(
        support.to(torch.float32).contiguous(),
        query.to(torch.float32).contiguous(), float(lbda),
        bool(bidirectional), float(epsilon))
