"""Optimizers and the learning-rate schedule.

Port of ``clipspm_tpu/train/optim.py``:

- Adam with betas (0.5, 0.999), eps 1e-8 and L2 weight decay added to the
  gradient before the moments (``torch.optim.Adam(weight_decay=...)``; the
  JAX chain is ``add_decayed_weights`` then ``scale_by_adam``, not AdamW);
- SGD with momentum and the same L2 weight decay;
- MultiStep LR decayed by 0.1 at milestones counted in *episodes*: the
  optimizer steps once per ``TASKS_PER_BATCH`` episodes, so at optimizer
  step ``k`` (0-based) the rate is ``LR * 0.1 ** [k * TPB >= LR_SCH]``.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence, Tuple

import torch


def multistep_lr(base_lr: float, milestones: Sequence[int],
                 gamma: float = 0.1, episodes_per_step: int = 1
                 ) -> Callable[[int], float]:
    """LR at optimizer step ``count`` (steps done before it), milestones in
    episode units."""
    milestones = sorted(milestones)

    def schedule(count: int) -> float:
        episodes = count * episodes_per_step
        return base_lr * gamma ** sum(episodes >= m for m in milestones)

    return schedule


def make_optimizer(cfg, params: Iterable[torch.nn.Parameter]
                   ) -> Tuple[torch.optim.Optimizer,
                              torch.optim.lr_scheduler.LambdaLR]:
    """``(optimizer, scheduler)`` for ``cfg.SOLVER``; call
    ``scheduler.step()`` after each ``optimizer.step()``."""
    lr = float(cfg.SOLVER.LR)
    wd = float(cfg.SOLVER.WEIGHT_DECAY)
    method = cfg.SOLVER.OPTIM_METHOD
    if method == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.5, 0.999), eps=1e-8,
                               weight_decay=wd)
    elif method == "sgd":
        opt = torch.optim.SGD(params, lr=lr,
                              momentum=float(cfg.SOLVER.MOMENTUM),
                              weight_decay=wd)
    else:
        raise ValueError(f"unknown optimizer {method!r}")
    factor = multistep_lr(1.0, [int(cfg.SOLVER.LR_SCH)], gamma=0.1,
                          episodes_per_step=int(cfg.TRAIN.TASKS_PER_BATCH))
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)
