"""Soft-DTW dynamic program: the plain PyTorch versions.

Port of ``clipspm_tpu/ops/softdtw.py``. The recurrence over ``[N, M]``
distance tables ``D``:

    R[0, 0] = 0,  R[i, 0] = R[0, j] = BIG                 (borders)
    R[i, j] = D[i-1, j-1] + smin(R[i-1,j-1], R[i-1,j], R[i,j-1])

with ``smin`` the clamped, max-shifted soft-min at temperature ``gamma``
(``_softmin3_masked``) and ``BIG = 1e30`` a finite stand-in for +inf. With
``bandwidth > 0`` cells with ``|i - j| > bandwidth`` are pruned (Sakoe-Chiba)
and stay at ``BIG``. The result is ``R[N, M]``.

``softdtw_from_dists`` here is the anti-diagonal wavefront of the reference's
scan path. It runs under autograd; it is the CPU path and the oracle of
kernel K2 (``ops/softdtw_cuda.py``), and K2's backward replays it.
``softdtw_cos_padded_plain`` is the same for K2's fused mode. ``softdtw``
builds the tables and runs the DPs through K2 on a CUDA tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.precision import fp32_or_wider

_BIG = 1e30  # finite stand-in for +inf: exp(-BIG/gamma) == 0, grads are 0


def _softmin3_masked(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                     gamma: float) -> torch.Tensor:
    m = torch.minimum(torch.minimum(a, b), c)
    # clamp the shifted args so BIG - BIG style cancellations never appear
    ea = torch.exp(-torch.clamp_max((a - m) / gamma, 80.0))
    eb = torch.exp(-torch.clamp_max((b - m) / gamma, 80.0))
    ec = torch.exp(-torch.clamp_max((c - m) / gamma, 80.0))
    return m - gamma * torch.log(ea + eb + ec)


def softdtw_from_dists(D: torch.Tensor, gamma: float = 1.0,
                       bandwidth: float = 0.0) -> torch.Tensor:
    """Soft-DTW values from precomputed distance tables (the plain
    wavefront).

    Args:
        D: ``[..., N, M]`` pairwise distance tables.
        gamma: soft-min temperature.
        bandwidth: Sakoe-Chiba band; cells with ``|i - j| > bandwidth`` are
            pruned when > 0.
    Returns:
        ``[...]`` soft-DTW values ``R[N, M]`` in fp32 (fp64 for fp64
        tables).
    """
    batch_shape = D.shape[:-2]
    N, M = D.shape[-2], D.shape[-1]
    out = _softdtw_wavefront(fp32_or_wider(D.reshape(-1, N, M)),
                             float(gamma), float(bandwidth))
    return out.reshape(batch_shape)


def _softdtw_wavefront(D: torch.Tensor, gamma: float,
                       bandwidth: float) -> torch.Tensor:
    """Wavefront over anti-diagonals ``k = i + j`` of the ``[B, N+1, M+1]``
    state: one step updates one diagonal of every table."""
    B, N, M = D.shape
    R = torch.full((B, N + 1, M + 1), _BIG, dtype=D.dtype, device=D.device)
    R[:, 0, 0] = 0.0
    iis = torch.arange(N + 1, device=D.device)[:, None]
    jjs = torch.arange(M + 1, device=D.device)[None, :]
    body = (iis >= 1) & (jjs >= 1)
    if bandwidth > 0:
        body &= (iis - jjs).abs() <= bandwidth
    Dpad = F.pad(D, (1, 0, 1, 0))
    for k in range(2, N + M + 1):
        up = torch.roll(R, 1, dims=1)          # R[i-1, j]
        left = torch.roll(R, 1, dims=2)        # R[i, j-1]
        upleft = torch.roll(up, 1, dims=2)     # R[i-1, j-1]
        cand = Dpad + _softmin3_masked(upleft, up, left, gamma)
        R = torch.where(body & (iis + jjs == k), cand, R)
    return R[:, -1, -1]


def pairwise_l2sq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``[..., N, D] x [..., M, D] -> [..., N, M]`` squared euclidean."""
    return ((x[..., :, None, :] - y[..., None, :, :]) ** 2).sum(dim=-1)


def pairwise_cos_dist(x: torch.Tensor, y: torch.Tensor,
                      eps: float = 1e-8) -> torch.Tensor:
    """``1 - cosine`` per timestep pair, each norm clamped at ``eps`` (as
    ``torch.cosine_similarity`` does; not OTAM's ``frame_distance_cos``,
    which adds 0.01 to the norm product)."""
    xn = torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(eps)
    yn = torch.linalg.vector_norm(y, dim=-1, keepdim=True).clamp_min(eps)
    return 1.0 - (x / xn) @ (y / yn).transpose(-1, -2)


def softdtw_cos_padded_plain(x: torch.Tensor, y: torch.Tensor,
                             gamma: float = 1.0,
                             bandwidth: float = 0.0) -> torch.Tensor:
    """``softdtw(x, y, normalize=False, dist="cos")`` as plain PyTorch,
    without the trailing ``[..., None]``: the ``1 - cos`` table padded with a
    zero row on each side of the query axis, the wavefront over it and over
    the padded reverse table ``dist(y, x)``, averaged. The CPU path, the
    plain version of K2's fused mode, and what its backward replays."""
    return _padded_average(x, y, pairwise_cos_dist, softdtw_from_dists,
                           gamma, bandwidth)


def _padded_average(x, y, dist_fn, dp, gamma, bandwidth):
    def padded(a, b):
        # the reverse direction pads dist(y, x): not the forward table's
        # transpose
        return dp(F.pad(dist_fn(a, b), (0, 0, 1, 1)), gamma, bandwidth)

    return 0.5 * (padded(x, y) + padded(y, x))


def softdtw(x: torch.Tensor, y: torch.Tensor, gamma: float = 1.0,
            normalize: bool = False, bandwidth: float = 0.0,
            dist: str = "cos") -> torch.Tensor:
    """Soft-DTW between batched sequences.

    Args:
        x: ``[B, N, D]``; y: ``[B, M, D]``.
        dist: "cos" or "l2sq".
        normalize: if True returns ``sdtw(x,y) - (sdtw(x,x)+sdtw(y,y))/2``;
            otherwise the query axis of the table is zero-padded by one row
            on each side and the forward and reverse DPs are averaged.
    Returns: ``[B]`` (normalize=True) or ``[B, 1]``. On a CUDA tensor the
        shipped form (``normalize=False``, ``dist="cos"``) is one launch of
        kernel K2's fused mode, and every other form runs each DP as a
        launch of K2's table mode; on a CPU tensor the plain wavefront
        (``ops/softdtw_cuda.py``).
    """
    from .softdtw_cuda import softdtw_cos_padded
    from .softdtw_cuda import softdtw_from_dists as dp

    if not normalize and dist == "cos":
        return softdtw_cos_padded(x, y, gamma, bandwidth)[..., None]
    dist_fn = pairwise_cos_dist if dist == "cos" else pairwise_l2sq
    if normalize:
        d_xy = dp(dist_fn(x, y), gamma, bandwidth)
        d_xx = dp(dist_fn(x, x), gamma, bandwidth)
        d_yy = dp(dist_fn(y, y), gamma, bandwidth)
        return d_xy - 0.5 * (d_xx + d_yy)
    return _padded_average(x, y, dist_fn, dp, gamma, bandwidth)[..., None]
