"""Episodic losses and metrics + per-model loss dispatch.

Port of ``clipspm_tpu/train/losses.py``: the branches of all ten heads
(clipspm, clipfsar, cpm2c, strm, molo, soap; otam, trx, sten and ta2n
through the default branch).
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
    only (``train``); strm adds 0.1 times its tuple-distance logits, to the
    logits and as a cross-entropy of their own; soap adds its ``t_loss``;
    molo, in training only, adds the classifier's, the four contrastive
    and the reconstruction terms (below). The other branches read neither
    ``cfg`` nor ``train``."""
    tpb = float(tasks_per_batch)
    logits = outputs.get("logits")
    if model_name == "strm":
        lmd = 0.1
        post_pat = outputs["logits_post_pat"]
        joint = logits + lmd * post_pat
        loss = (episodic_ce(joint, target_labels) / tpb
                + lmd * episodic_ce(post_pat, target_labels) / tpb)
        return loss, aggregate_accuracy(joint, target_labels)
    if model_name == "molo":
        return _molo_loss(outputs, target_labels, real_support_labels,
                          real_target_labels, tpb, cfg, train)
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
    elif model_name == "soap":
        loss = loss + outputs["t_loss"]
    return loss, aggregate_accuracy(logits, target_labels)


def _molo_loss(outputs, target_labels, real_support_labels,
               real_target_labels, tpb: float, cfg, train: bool):
    """molo's branch. In evaluation the cross-entropy over ``tpb``. In
    training: the cross-entropy and ``USE_CLASSIFICATION_VALUE`` times the
    classifier's over the real labels of support and query (each repeated
    per token with ``USE_LOCAL``), that sum over ``tpb`` again, so the main
    cross-entropy is divided by ``tpb`` twice, as in the JAX dispatch; plus
    ``USE_CONTRASTIVE_COFF`` times each of the four contrastive
    cross-entropies over ``tpb``, and ``RECONS_COFF`` times
    ``loss_recons``."""
    logits = outputs["logits"]
    ce = episodic_ce(logits, target_labels) / tpb
    acc = aggregate_accuracy(logits, target_labels)
    if not train:
        return ce, acc
    both_real = torch.cat([real_support_labels, real_target_labels])
    n_logits = outputs["class_logits"].shape[1]
    if n_logits != both_real.shape[0]:
        both_real = torch.repeat_interleave(both_real,
                                            n_logits // both_real.shape[0])
    cls_v = float(cfg.MODEL.USE_CLASSIFICATION_VALUE)
    contr = float(cfg.MODEL.USE_CONTRASTIVE_COFF)
    recons = float(cfg.MODEL.RECONS_COFF)
    loss = (ce + cls_v * episodic_ce(outputs["class_logits"], both_real)
            ) / tpb
    for key in ("logits_s2q", "logits_q2s", "logits_s2q_motion",
                "logits_q2s_motion"):
        loss = loss + contr * episodic_ce(outputs[key], target_labels) / tpb
    return loss + recons * outputs["loss_recons"], acc
