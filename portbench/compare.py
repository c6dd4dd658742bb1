"""The comparison that decides ``correct``: the program's answers against
the plain reference's, each number held to its limit
(``limits/<workload>.json``).

Evaluation (answers one by one): a sample of the pool episodes that the
window evaluated, drawn from the seed, each against the reference at every
position of the window where it came:

- ``logit_gap``: the widest gap of one of its logits from the reference's,
  each query's logits less their mean (the answer and the cross-entropy
  do not see a shift common to a query's logits), over the median of the
  sampled episodes' spreads (largest minus smallest) of those centred
  reference logits;
- ``loss_gap``: the gap of its loss (``Learner.evaluate``'s row) from the
  reference's, over the reference's;
- every window episode has one answer, and all of them are finite.

Training (the first ``checked_steps`` steps, which set-up drives through
the window's own call): ``loss_gap_first`` and ``loss_gap``, the widest
relative gap of an episode's loss as the step computed it, over the first
step's episodes (same weights on both sides) and over all of them (an
episode missing or run twice fails); ``grad_gap``, the
median leaf's gap of the norm of the gradient as Adam got it at step 1,
over the larger of the reference's norm of that leaf and of the median
leaf, and ``grad_gap_worst``, the worst leaf's (under bf16 a BatchNorm
parameter's cancelling sum); ``change_gap``, by the worst leaf, the same
for each leaf's change after the last checked step, over the leaves whose
reference gradient is at least a thousandth of the median leaf's (the
others move by round-off alone). Which of them are compared is the limits
file's to say; the others are reported beside them.
"""

from __future__ import annotations

import json
import math
import os
import statistics
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
TRAIN_NUMBERS = ("loss_gap_first", "loss_gap", "grad_gap", "grad_gap_worst",
                 "change_gap")


def limits(workload: str) -> Dict[str, float]:
    path = os.path.join(HERE, "limits", f"{workload}.json")
    with open(path) as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def sample_positions(n_pool_seen: int, k: int, seed: int) -> List[int]:
    """``k`` distinct pool positions of the ``n_pool_seen`` that the window
    reached, drawn from the seed."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), 7])
    k = min(k, n_pool_seen)
    return sorted(int(i) for i in rng.choice(n_pool_seen, size=k,
                                             replace=False))


def _centred(x: torch.Tensor) -> torch.Tensor:
    """Logits less each query's mean: what the answer and the
    cross-entropy depend on."""
    x = x.double().cpu()
    return x - x.mean(dim=-1, keepdim=True)


def eval_gaps(window: dict, reference: Dict[int, dict]) -> Dict[str, float]:
    """Gaps of the window's answers at the reference's pool positions."""
    logits, rows = window["logits"], window["result"]["loss_acc"]
    spreads = [float(r.max() - r.min()) for r in
               (_centred(ref["logits"]) for ref in reference.values())]
    scale = max(statistics.median(spreads), 1e-30) if spreads else 1.0
    logit_gap = loss_gap = 0.0
    for i, pos in enumerate(window["positions"]):
        ref = reference.get(pos)
        if ref is None:
            continue
        if i >= len(logits) or i >= len(rows):
            # an answer that never came
            return {"logit_gap": float("inf"), "loss_gap": float("inf")}
        gap = (_centred(logits[i]) - _centred(ref["logits"])).abs().max()
        logit_gap = max(logit_gap, float(gap) / scale)
        lr = float(ref["loss"])
        loss_gap = max(loss_gap, abs(float(rows[i][0]) - lr)
                       / max(abs(lr), 1e-30))
    return {"logit_gap": logit_gap, "loss_gap": loss_gap}


def eval_failed(window: dict) -> int:
    """Window episodes without a finite answer (a missing one counts)."""
    n = window["episodes"]
    rows = np.asarray(window["result"]["loss_acc"])
    finite = [bool(torch.isfinite(x).all()) for x in window["logits"]]
    ok = min(len(finite), len(rows))
    bad = sum(1 for i in range(ok)
              if not (finite[i] and np.isfinite(rows[i]).all()))
    return bad + (n - ok)


def _leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
               keys: Sequence[str]) -> List[float]:
    med = statistics.median(ref[k] for k in keys)
    return [abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def train_gaps(program: dict, reference: dict, name_map,
               first: int) -> Dict[str, float]:
    """``program``/``reference``: ``losses``, ``grad_norms``,
    ``change_norms`` (the program's keyed by its parameter names, mapped
    onto the reference's by ``name_map``); ``first``, the episodes of the
    first step, whose losses both sides compute from the same weights
    (``loss_gap_first``; ``loss_gap`` is over every checked episode).
    ``grad_gap`` is the median leaf's, ``grad_gap_worst`` the worst
    leaf's."""
    pg = {name_map(k): v for k, v in program["grad_norms"].items()}
    pc = {name_map(k): v for k, v in program["change_norms"].items()}
    rg, rc = reference["grad_norms"], reference["change_norms"]
    if set(pg) != set(rg):
        raise ValueError(f"the program's leaves differ from the reference's: "
                         f"{sorted(set(pg) ^ set(rg))[:4]}")
    med_g = statistics.median(rg.values())
    moved = [k for k in rg if rg[k] >= 1e-3 * med_g]
    if len(program["losses"]) != len(reference["losses"]):
        # an episode the step left out, or one it ran twice
        return dict.fromkeys(TRAIN_NUMBERS, float("inf"))
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(program["losses"], reference["losses"])]
    grads = _leaf_gaps(pg, rg, list(rg))
    return {"loss_gap_first": max(gaps[:first]), "loss_gap": max(gaps),
            "grad_gap": statistics.median(grads),
            "grad_gap_worst": max(grads),
            "change_gap": max(_leaf_gaps(pc, rc, moved))}


def judge(numbers: Dict[str, float], limit: Dict[str, float],
          failed: int) -> bool:
    """Every number under its limit (a missing or non-finite one fails),
    and no failed answer."""
    return failed == 0 and all(
        k in numbers and math.isfinite(numbers[k]) and numbers[k] <= v
        for k, v in limit.items())


def checks_block(numbers: Dict[str, float], limit: Dict[str, float]
                 ) -> Dict[str, Dict[str, Optional[float]]]:
    """Each number compared beside its limit, then those reported without
    one (limit ``None``)."""
    out = {k: {"value": numbers.get(k), "limit": v} for k, v in limit.items()}
    out.update({k: {"value": v, "limit": None} for k, v in numbers.items()
                if k not in limit})
    return out
