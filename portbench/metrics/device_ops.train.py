"""Kernels, copies and sets on the card an episode of a traced training
step, from the trace of the card alone. Layer: the trainer
(``Learner._step``)."""


def read(run):
    if not run.card.device or not run.card_episodes:
        return None
    return len(run.card.device) / run.card_episodes
