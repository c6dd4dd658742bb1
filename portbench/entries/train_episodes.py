"""The ``train_episodes`` entry: ``Learner.train_episodes``, one optimizer
step of ``episodes_per_step`` pool episodes a call, the pool cycled.

Set-up drives the built learner through its first ``checked_steps`` steps
by that same call, over pool episodes 0, 1, ... (all different), and reads
each episode's loss as the step computes it, each leaf's gradient as the
optimizer got it at step 1 and each leaf's change after the last; the
window then continues on the same object. The reference follows those
steps from the same weights (``compare.train_gaps``).
"""

from __future__ import annotations

import itertools
import math
import sys
import time
from typing import Dict, List

import torch

from .. import compare, program
from ..reference import run as ref

RATE = "train_episodes_per_s"
SPLIT = "train"
FAULTS = ("unchanged_state", "half_batch", "altered_answer")


def layout(cfg: dict) -> Dict[str, int]:
    return {"way": int(cfg["TRAIN"]["WAY"]), "shot": int(cfg["TRAIN"]["SHOT"]),
            "queries": int(cfg["TRAIN"]["QUERY_PER_CLASS"]),
            "seq_len": int(cfg["DATA"]["SEQ_LEN"]),
            "episodes_per_step": int(cfg["TRAIN"]["TASKS_PER_BATCH"])}


def setup(learner, pool: List[dict], traffic: dict) -> Dict:
    """The checked steps, which are also the window's warm-up. Each
    episode's loss is read by wrapping ``Learner._episode_loss`` for these
    steps alone (the wrapper returns what it wraps)."""
    E, steps = int(traffic["episodes_per_step"]), int(traffic["checked_steps"])
    if len(pool) < E * steps:
        raise ValueError(f"the pool holds {len(pool)} episodes; the checked "
                         f"steps take {E * steps} different ones")
    named = list(learner.model.named_parameters())
    start = {n: p.detach().clone() for n, p in named}
    beta1 = learner.optimizer.param_groups[0]["betas"][0]
    losses, grads = [], {}
    episode_loss = learner._episode_loss

    def tap(ep, train=True):
        loss, acc = episode_loss(ep, train)
        losses.append(loss.detach())
        return loss, acc

    learner._episode_loss = tap
    try:
        for step in range(steps):
            learner.train_episodes(
                [program.episode(d) for d in pool[step * E:(step + 1) * E]])
            if step == 0:
                for n, p in named:
                    # no moment: the step never reached the optimizer's state
                    m = learner.optimizer.state.get(p, {}).get("exp_avg")
                    grads[n] = 0.0 if m is None else float(
                        torch.linalg.vector_norm(m) / (1 - beta1))
    finally:
        del learner._episode_loss
    change = {n: float(torch.linalg.vector_norm(p.detach() - start[n]))
              for n, p in named}
    return {"losses": [float(x) for x in losses], "grad_norms": grads,
            "change_norms": change, "next": (steps * E) % len(pool)}


def _steps(learner, pool: List[dict], traffic: dict, state: Dict,
           seconds: float = 0.0, steps: int = 0) -> Dict:
    """Optimizer steps over the pool from where the last call stopped,
    until ``seconds`` have passed or for ``steps``."""
    E = int(traffic["episodes_per_step"])
    it = itertools.islice(itertools.cycle(pool), state["next"], None)
    step_s, losses = [], []
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        res = learner.train_episodes(
            [program.episode(next(it)) for _ in range(E)])
        step_s.append(time.perf_counter() - t)
        losses.append(res["loss"])
        wall = time.perf_counter() - t0
        if (steps and len(step_s) >= steps) or (not steps and
                                                wall >= seconds):
            break
    state["next"] = (state["next"] + len(step_s) * E) % len(pool)
    return {"episodes": len(step_s) * E, "steps": len(step_s),
            "wall_s": wall, "step_s": step_s, "losses": losses}


def window(learner, pool: List[dict], traffic: dict, seconds: float,
           state: Dict) -> Dict:
    """The timed window: whole steps until ``seconds`` have passed."""
    return _steps(learner, pool, traffic, state, seconds=seconds)


def segment(learner, pool: List[dict], traffic: dict, state: Dict) -> Dict:
    """A traced segment of ``trace_steps`` steps."""
    return _steps(learner, pool, traffic, state,
                  steps=int(traffic["trace_steps"]))


def rate(win: Dict) -> float:
    return win["episodes"] / win["wall_s"]


def diagnostics(win: Dict) -> Dict:
    return {"wall_s": win["wall_s"], "episodes": win["episodes"],
            "steps": win["steps"], "step_s": win["step_s"]}


def _reference(inp, prec=None) -> Dict:
    kw = {} if prec is None else {"prec": prec}
    return ref.train_steps(inp.P, inp.config, inp.pool, inp.table,
                           inp.transform, inp.seed,
                           int(inp.traffic["checked_steps"]),
                           mask_dtype=_mask_dtype(inp.config), **kw)


def check(inp, win: Dict, state: Dict):
    """The checked steps against the reference's; failed: the episodes of
    window steps whose loss is not finite."""
    failed = sum(1 for x in win["losses"] if not math.isfinite(x)) * int(
        inp.traffic["episodes_per_step"])
    try:
        numbers = compare.train_gaps(state, _reference(inp), _ref_name,
                                     int(inp.traffic["episodes_per_step"]))
    except ValueError as exc:
        # the program trains other leaves than the reference
        print(f"portbench: {exc}", file=sys.stderr)
        numbers = dict.fromkeys(compare.TRAIN_NUMBERS, float("inf"))
    return numbers, failed


def control(inp, prec) -> Dict[str, float]:
    """The reference computed with ``prec`` in the program's place,
    against the float32 reference."""
    return compare.train_gaps(_reference(inp, prec), _reference(inp),
                              lambda k: k,
                              int(inp.traffic["episodes_per_step"]))


def _mask_dtype(conf: dict):
    return torch.bfloat16 if conf["port_config"].get("USE_AMP") \
        else torch.float32


def _ref_name(name: str) -> str:
    """The program's parameter name as the reference's state-dict key."""
    return "visual." + name[len("backbone."):] \
        if name.startswith("backbone.") else name
