"""Faults planted in the program's timed path, to show that the comparison
catches them (``calibrate.py`` reads them on the card; the tests under
``tests/`` check that a run with one comes out not correct). Which of them
a cell can have is its entry's ``FAULTS``. Each takes the
built ``Learner`` and breaks it in place.
"""

from __future__ import annotations

import torch


def unchanged_state(learner) -> None:
    """An optimizer step that leaves the parameters as they are."""
    learner.optimizer.step = lambda *a, **k: None


def half_batch(learner) -> None:
    """Half of each step's episodes left out, the mean taken over the
    rest: training steps over the first half with the loss divided by
    its size; evaluation runs the first half of each step and gives the
    others the mean of its results."""
    train = learner.train_episodes

    def train_half(episodes, n_valid=None):
        half = max(1, len(episodes) // 2)
        tpb = learner.tasks_per_batch
        learner.tasks_per_batch = half
        try:
            return train(episodes[:half])
        finally:
            learner.tasks_per_batch = tpb

    learner.train_episodes = train_half
    run = learner._eval_batch

    def eval_half(batch, n):
        half = max(1, n // 2)
        rows = run(batch, half)
        return torch.cat([rows, rows.mean(dim=0, keepdim=True).expand(
            n - half, -1)])

    learner._eval_batch = eval_half


def altered_answer(learner) -> None:
    """Each episode's answers altered where they are made: in every
    query's logits the largest and the smallest swapped."""
    def swap(module, args, out):
        logits = out["logits"]
        hi = logits.argmax(dim=-1, keepdim=True)
        lo = logits.argmin(dim=-1, keepdim=True)
        swapped = logits.scatter(-1, hi, logits.gather(-1, lo)).scatter(
            -1, lo, logits.gather(-1, hi))
        return {**out, "logits": swapped}

    learner.model.register_forward_hook(swap)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer}
