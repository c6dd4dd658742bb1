"""The evaluator's view of a built model.

The eval-only counterpart of ``clipspm_tpu/train/learner.py:Learner``: it
holds the model with its weights on the device, the class-text tables and
the frame transform. Training (optimizer, accumulation, the train loop) is
not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..data.transforms import TransformSpec


class Learner:
    def __init__(self, cfg, model: nn.Module, text_train: torch.Tensor,
                 text_test: torch.Tensor, device: torch.device,
                 transform: Optional[TransformSpec] = None,
                 build_seconds: Optional[Dict[str, float]] = None):
        self.cfg = cfg
        self.model_name = cfg.MODEL.NAME
        self.tasks_per_batch = int(cfg.TRAIN.TASKS_PER_BATCH)
        self.device = device
        self.model = model.to(device).eval()
        self.text_train = text_train.to(device)
        self.text_test = text_test.to(device)
        self.transform = transform or TransformSpec.from_config(cfg)
        # wall seconds of each build stage (model init, text tables, ...)
        self.build_seconds = dict(build_seconds or {})
