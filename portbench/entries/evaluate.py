"""The ``evaluate`` entry: ``Learner.evaluate`` over a cycled pool of
episodes, ``episodes_per_step`` a step, in one call a window (the test
protocol's own loop: a staging thread stacks and copies step i+1 while the
card runs step i).

Its answers are checked one by one: a sample of the pool episodes that the
window evaluated, drawn from the seed, against the reference at every
window position where each came (``compare.eval_gaps``).
"""

from __future__ import annotations

import itertools
import math
import time
from typing import Dict, List

import torch

from .. import compare, program
from ..reference import run as ref

RATE = "eval_episodes_per_s"
SPLIT = "test"
# the faults of faults.py that such a cell can have (one chip: no exchange
# between chips; evaluation keeps no state across steps)
FAULTS = ("half_batch", "altered_answer")


def layout(cfg: dict) -> Dict[str, int]:
    """The traffic keys that the configuration fixes."""
    return {"way": int(cfg["TRAIN"]["WAY"]), "shot": int(cfg["TRAIN"]["SHOT"]),
            "queries": int(cfg["TEST"]["QUERY_PER_CLASS"]),
            "seq_len": int(cfg["DATA"]["SEQ_LEN"])}


class LogitTap:
    """Keeps the logits of every forward of ``model`` while it is open (the
    answers the comparison judges)."""

    def __init__(self, model: torch.nn.Module):
        self.logits: List[torch.Tensor] = []
        self._handle = model.register_forward_hook(self._hook)

    def _hook(self, module, args, out):
        self.logits.append(out["logits"].detach()[0])

    def close(self) -> None:
        self._handle.remove()


def _cycle(pool: List[dict]):
    return (program.episode(d) for d in itertools.cycle(pool))


def _evaluate(learner, pool: List[dict], traffic: dict, steps: int,
              tap: bool) -> Dict:
    """One ``Learner.evaluate`` call of ``steps`` steps over the pool from
    its first episode, cycled: the call's result, the episodes, the wall,
    the pool position of each episode and (with ``tap``) its logits."""
    E = int(traffic["episodes_per_step"])
    n = steps * E
    logits = LogitTap(learner.model) if tap else None
    try:
        t0 = time.perf_counter()
        res = learner.evaluate(n, source=_cycle(pool), batch_size=E)
        wall = time.perf_counter() - t0
    finally:
        if logits is not None:
            logits.close()
    return {"result": res, "episodes": n, "steps": steps, "wall_s": wall,
            "positions": [i % len(pool) for i in range(n)],
            "logits": logits.logits if tap else None}


def setup(learner, pool: List[dict], traffic: dict) -> Dict:
    """Every shape of the window (one step), then a warm call of two steps
    whose time sizes the window."""
    E = int(traffic["episodes_per_step"])
    learner.evaluate(E, source=_cycle(pool), batch_size=E)
    t0 = time.perf_counter()
    learner.evaluate(2 * E, source=_cycle(pool), batch_size=E)
    return {"step_s": (time.perf_counter() - t0) / 2}


def window(learner, pool: List[dict], traffic: dict, seconds: float,
           state: Dict) -> Dict:
    """The timed window: as many steps as fill ``seconds`` at the warm
    call's pace, in one call."""
    steps = max(1, math.ceil(seconds / state["step_s"]))
    return _evaluate(learner, pool, traffic, steps, tap=True)


def segment(learner, pool: List[dict], traffic: dict, state: Dict) -> Dict:
    """A traced segment: one call of ``trace_steps`` steps."""
    return _evaluate(learner, pool, traffic, int(traffic["trace_steps"]),
                     tap=False)


def rate(win: Dict) -> float:
    return win["episodes"] / win["wall_s"]


def diagnostics(win: Dict) -> Dict:
    res = win["result"]
    return {"wall_s": win["wall_s"], "episodes": win["episodes"],
            "steps": win["steps"], "host_stall_s": res["host_stall_seconds"]}


def check(inp, win: Dict, state: Dict):
    """The numbers compared and the failed answers: the sample's answers
    against the reference's."""
    seen = min(len(inp.pool), win["episodes"])
    sample = compare.sample_positions(seen, int(inp.traffic["checked"]),
                                      inp.seed)
    reference = {p: ref.eval_episode(inp.P, inp.config, inp.pool[p],
                                     inp.table, inp.transform)
                 for p in sample}
    return compare.eval_gaps(win, reference), compare.eval_failed(win)


def control(inp, prec) -> Dict[str, float]:
    """The reference computed with ``prec`` in the program's place, over
    the sample of a two-step window, against the float32 reference."""
    n = 2 * int(inp.traffic["episodes_per_step"])
    sample = compare.sample_positions(min(len(inp.pool), n),
                                      int(inp.traffic["checked"]), inp.seed)
    want, got = {}, {"positions": [], "logits": [],
                     "result": {"loss_acc": []}}
    for p in sample:
        args = (inp.P, inp.config, inp.pool[p], inp.table, inp.transform)
        want[p] = ref.eval_episode(*args)
        c = ref.eval_episode(*args, prec=prec)
        got["positions"].append(p)
        got["logits"].append(c["logits"])
        got["result"]["loss_acc"].append([float(c["loss"]), float(c["acc"])])
    return compare.eval_gaps(got, want)
