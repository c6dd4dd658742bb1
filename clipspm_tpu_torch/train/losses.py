"""Episodic losses and metrics + per-model loss dispatch.

Port of ``clipspm_tpu/train/losses.py`` for the ported heads (clipspm,
clipfsar, cpm2c; sten and ta2n through the default branch):
``episodic_ce`` is a logsumexp over the sample dim (size 1 in practice)
followed by a **sum** over queries; ``aggregate_accuracy`` is the argmax of
that logsumexp.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from ..utils.precision import fp32_or_wider

# loss branches of the JAX dispatch not ported yet: their heads are not
PENDING_BRANCHES = ("strm", "molo", "soap")


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


def cpm2c_lambdas(cfg) -> List[float]:
    """cpm2c's four loss weights: ``MODEL.LMD`` padded with zeros to 4, or,
    without it, ``cfg.params``' ``lambdas0..3`` (defaults 1, 1, 0, 0)."""
    if cfg is not None and "LMD" in cfg.MODEL:
        return (list(cfg.MODEL.LMD) + [0.0] * 4)[:4]
    p = cfg.params
    return [p.get("lambdas0", 1.0), p.get("lambdas1", 1.0),
            p.get("lambdas2", 0.0), p.get("lambdas3", 0.0)]


def loss_and_acc(model_name: str, outputs: Dict[str, torch.Tensor],
                 target_labels: torch.Tensor,
                 real_support_labels: torch.Tensor,
                 real_target_labels: torch.Tensor, tasks_per_batch: int,
                 cfg=None, train: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-model loss dispatch: ``(loss, accuracy)`` for one episode, with
    the JAX dispatch's signature. The ``1/tasks_per_batch`` factor is part
    of the loss. clipfsar adds ``USE_CLASSIFICATION_VALUE`` times the
    video-to-text cross-entropy over the real labels of support and query;
    cpm2c weighs its class, local and global cross-entropies by
    :func:`cpm2c_lambdas` and adds its consistency distance in training
    only (``train``); the other branches read neither ``cfg`` nor
    ``train``."""
    tpb = float(tasks_per_batch)
    logits = outputs.get("logits")
    if model_name in PENDING_BRANCHES:
        raise NotImplementedError(
            f"the {model_name!r} loss branch is not ported yet (ROADMAP.md, "
            "open item 'the remaining ResNet heads')")
    if model_name == "clipfsar":
        both_real = torch.cat([real_support_labels, real_target_labels])
        cls_v = float(cfg.MODEL.USE_CLASSIFICATION_VALUE)
        loss = (episodic_ce(logits, target_labels)
                + cls_v * episodic_ce(outputs["class_logits"], both_real)) / tpb
        return loss, aggregate_accuracy(logits, target_labels)
    if model_name == "cpm2c":
        lambdas = cpm2c_lambdas(cfg)
        both_real = torch.cat([real_support_labels, real_target_labels])
        total_logits = (lambdas[1] * outputs["logits_local"]
                        + lambdas[2] * outputs["logits_global"])
        loss = (lambdas[0] * episodic_ce(outputs["class_logits"], both_real)
                / tpb
                + lambdas[1] * episodic_ce(outputs["logits_local"],
                                           target_labels) / tpb
                + lambdas[2] * episodic_ce(outputs["logits_global"],
                                           target_labels) / tpb)
        if train:
            loss = loss + 0.001 * outputs["target_consist_distance"]
        return loss, aggregate_accuracy(total_logits, target_labels)
    loss = episodic_ce(logits, target_labels) / tpb
    if model_name == "clipspm":
        loss = loss + 0.001 * outputs["dists"]
    return loss, aggregate_accuracy(logits, target_labels)
