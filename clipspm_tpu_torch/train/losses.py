"""Episodic losses and metrics + per-model loss dispatch.

Port of ``clipspm_tpu/train/losses.py`` for the ported heads (clipspm, and
ta2n through the default branch):
``episodic_ce`` is a logsumexp over the sample dim (size 1 in practice)
followed by a **sum** over queries; ``aggregate_accuracy`` is the argmax of
that logsumexp.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..utils.precision import fp32_or_wider

# loss branches of the JAX dispatch not ported yet: their heads are not
PENDING_BRANCHES = ("strm", "molo", "clipfsar", "cpm2c", "soap")


def episodic_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Args: logits ``[n_samples, Q, way]``, labels ``[Q]``. Returns the
    sum over queries of the sample-averaged cross-entropy."""
    n = logits.shape[0]
    logp = F.log_softmax(fp32_or_wider(logits), dim=-1)
    idx = labels.long()[None, :, None].expand(n, -1, 1)
    log_py = logp.gather(-1, idx)[..., 0]                  # [n, Q]
    score = torch.logsumexp(log_py, dim=0) - math.log(float(n))
    return -score.sum()


def aggregate_accuracy(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    avg = torch.logsumexp(fp32_or_wider(logits), dim=0)
    pred = avg.argmax(dim=-1)
    return (pred == labels.to(pred.dtype)).float().mean()


def loss_and_acc(model_name: str, outputs: Dict[str, torch.Tensor],
                 target_labels: torch.Tensor, tasks_per_batch: int,
                 train: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-model loss dispatch: ``(loss, accuracy)`` for one episode. The
    ``1/tasks_per_batch`` factor is part of the loss. ``train`` is the JAX
    dispatch's flag; the clipspm and default branches are the same in
    training and evaluation (only the pending molo and cpm2c branches read
    it)."""
    tpb = float(tasks_per_batch)
    logits = outputs["logits"]
    if model_name in PENDING_BRANCHES:
        raise NotImplementedError(
            f"the {model_name!r} loss branch is not ported yet (ROADMAP.md, "
            "open items 'the other CLIP heads' and 'the remaining ResNet "
            "heads')")
    loss = episodic_ce(logits, target_labels) / tpb
    if model_name == "clipspm":
        loss = loss + 0.001 * outputs["dists"]
    return loss, aggregate_accuracy(logits, target_labels)
