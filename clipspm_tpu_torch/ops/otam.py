"""OTAM temporal-alignment dynamic program: the plain PyTorch versions.

Port of ``clipspm_tpu/ops/otam.py`` and ``ops/softmin.py``. The recurrence,
after zero-padding one column on each side of each ``[L, Ms]`` table:

    C[0, m]   = D[0, m] + C[0, m-1]                       (top row: cumsum)
    C[l, 0]   = 0                                          (left pad column)
    C[l, 1]   = D[l, 1] + smin(C[l-1,0], C[l-1,1], C[l,0])
    C[l, m]   = D[l, m] + smin(C[l-1,m-1], C[l,m-1])       (2 <= m <= M-2)
    C[l, M-1] = D[l, M-1] + smin(C[l-1,M-2], C[l-1,M-1], C[l,M-2])

with ``smin(xs) = -lbda * log(sum(exp(-x / lbda)))`` in its max-shifted form.
The result is ``C[L-1, M-1]``.

``otam_cum_dist`` here is the anti-diagonal wavefront of the reference's
scan path: every cell of diagonal ``k = l + m`` depends only on diagonals
``k-1`` and ``k-2``, so one step updates a whole diagonal of every table.
It runs under autograd; it is the CPU path and the oracle of kernel K1's
table mode (``ops/otam_cuda.py``), and K1's backward replays it;
``otam_distance_plain`` is the same for K1's fused mode.
"""

from __future__ import annotations

import torch

from ..utils.precision import fp32_or_wider


def softmin_pair(a: torch.Tensor, b: torch.Tensor, lbda: float) -> torch.Tensor:
    m = torch.minimum(a, b)
    return m - lbda * torch.log(
        torch.exp(-(a - m) / lbda) + torch.exp(-(b - m) / lbda))


def softmin3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             lbda: float) -> torch.Tensor:
    m = torch.minimum(torch.minimum(a, b), c)
    return m - lbda * torch.log(
        torch.exp(-(a - m) / lbda)
        + torch.exp(-(b - m) / lbda)
        + torch.exp(-(c - m) / lbda))


def _pad_cols(dists: torch.Tensor) -> torch.Tensor:
    """Zero-pad one column on each side of the last axis."""
    return torch.nn.functional.pad(dists, (1, 1))


def otam_cum_dist(dists: torch.Tensor, lbda: float = 0.5) -> torch.Tensor:
    """Batched OTAM cumulative distance (the plain wavefront).

    Args:
        dists: ``[..., L, Ms]`` frame-distance tables (``1 - cos``).
        lbda: soft-min temperature: 0.5 on the CLIP heads, 0.1 on the otam
            head.
    Returns:
        ``[...]`` cumulative alignment distances ``C[L-1, M-1]`` in fp32
        (fp64 for fp64 tables).
    """
    D = _pad_cols(fp32_or_wider(dists))
    batch_shape = D.shape[:-2]
    L, M = D.shape[-2], D.shape[-1]
    out = _otam_wavefront(D.reshape(-1, L, M), lbda)
    return out.reshape(batch_shape)


def _otam_wavefront(D: torch.Tensor, lbda: float) -> torch.Tensor:
    """Wavefront over anti-diagonals. ``D``: ``[B, L, M]`` padded tables."""
    B, L, M = D.shape
    ls = torch.arange(L, device=D.device)[:, None]
    ms = torch.arange(M, device=D.device)[None, :]
    first_col, last_col = ms == 1, ms == M - 1

    # row 0 is a plain cumulative sum of the padded distances
    C = torch.cat([torch.cumsum(D[:, :1, :], dim=-1),
                   torch.zeros_like(D[:, 1:, :])], dim=1)
    zeros = torch.zeros_like(C)
    for k in range(2, L + M - 1):
        up = torch.roll(C, 1, dims=1)          # C[l-1, m]
        left = torch.roll(C, 1, dims=2)        # C[l, m-1]
        upleft = torch.roll(up, 1, dims=2)     # C[l-1, m-1]

        mid = D + softmin_pair(upleft, left, lbda)            # 2 <= m <= M-2
        first = D + softmin3(up, zeros, zeros, lbda)          # m == 1
        last = D + softmin3(upleft, up, left, lbda)           # m == M-1
        cand = torch.where(first_col, first, mid)
        cand = torch.where(last_col, last, cand)

        write = (ls + ms == k) & (ls >= 1) & (ms >= 1)
        C = torch.where(write, cand, C)
    return C[:, -1, -1]


def otam_cum_dist_unrolled(dists: torch.Tensor, lbda: float = 0.5
                           ) -> torch.Tensor:
    """Row-by-row oracle of the same recurrence (test reference)."""
    D = _pad_cols(fp32_or_wider(dists))
    L, M = D.shape[-2], D.shape[-1]
    zeros = torch.zeros_like(D[..., 0, 0])
    prev = torch.cumsum(D[..., 0, :], dim=-1)
    for l in range(1, L):
        cells = [zeros]      # column 0 is never written: stays 0
        cells.append(D[..., l, 1] + softmin3(prev[..., 0], prev[..., 1],
                                             zeros, lbda))
        for m in range(2, M - 1):
            cells.append(D[..., l, m]
                         + softmin_pair(prev[..., m - 1], cells[m - 1], lbda))
        cells.append(D[..., l, M - 1]
                     + softmin3(prev[..., M - 2], prev[..., M - 1],
                                cells[M - 2], lbda))
        prev = torch.stack(cells, dim=-1)
    return prev[..., -1]


def frame_distance_cos(query: torch.Tensor, support: torch.Tensor,
                       epsilon: float = 0.01) -> torch.Tensor:
    """``1 - cos`` frame-distance tables, epsilon added to the norm product.

    Args:
        query: ``[Q, L, D]`` per-frame features.
        support: ``[S, L, D]`` per-frame features.
    Returns:
        ``[Q, S, L, L]`` distance tables.
    """
    Q, Lq, Dd = query.shape
    S, Ls, _ = support.shape
    qf = query.reshape(Q * Lq, Dd)
    sf = support.reshape(S * Ls, Dd)
    num = qf @ sf.T
    qn = torch.linalg.vector_norm(qf, dim=-1, keepdim=True)
    sn = torch.linalg.vector_norm(sf, dim=-1, keepdim=True)
    sim = num / (qn @ sn.T + epsilon)
    dist = 1.0 - sim
    return dist.reshape(Q, Lq, S, Ls).permute(0, 2, 1, 3)


def otam_distance_plain(support: torch.Tensor, query: torch.Tensor,
                        lbda: float = 0.5, bidirectional: bool = True,
                        epsilon: float = 0.01) -> torch.Tensor:
    """``otam_distance`` as plain PyTorch: ``frame_distance_cos`` and the
    wavefront, once over the tables and once over their transposes. The CPU
    path, the plain version of K1's fused mode, and what its backward
    replays."""
    tables = frame_distance_cos(query, support, epsilon)
    cum = otam_cum_dist(tables, lbda)
    if bidirectional:
        cum = cum + otam_cum_dist(tables.transpose(-2, -1), lbda)
    return cum


def otam_distance(support: torch.Tensor, query: torch.Tensor,
                  lbda: float = 0.5, bidirectional: bool = True,
                  epsilon: float = 0.01) -> torch.Tensor:
    """End-to-end OTAM matching distance used by every CLIP head.

    Args:
        support: ``[S, L, D]`` support videos or class prototypes.
        query: ``[Q, L, D]`` query videos.
    Returns:
        ``[Q, S]`` cumulative distances; bidirectional sums the DP over the
        table and its transpose. On a CUDA tensor the cosine tables and both
        DPs are one launch of kernel K1's fused mode; on a CPU tensor
        ``otam_distance_plain`` (``ops/otam_cuda.py``).
    """
    from .otam_cuda import otam_distance as dispatch

    return dispatch(support, query, lbda, bidirectional, epsilon)
