"""Episodes: numpy leaves on the host, tensors on the device.

Port of ``clipspm_tpu/data/episode.py``. A batch of episodes is an
``Episode`` whose leaves carry a leading episode axis ``[E, ...]``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class Episode:
    """One N-way K-shot episode.

    Shapes (``S = way*shot``, ``Q = way*queries``, ``T = seq_len``):
        support_images: ``[S, T, H, W, 3]`` uint8
        support_labels: ``[S]`` int32 episode-relative labels in [0, way)
        target_images: ``[Q, T, H, W, 3]``
        target_labels: ``[Q]`` int32
        real_support_labels: ``[S]`` int32 dataset-level class ids
        real_target_labels: ``[Q]`` int32
        batch_class_list: ``[way]`` int32 chosen dataset-level classes
    """
    support_images: object
    support_labels: object
    target_images: object
    target_labels: object
    real_support_labels: object
    real_target_labels: object
    batch_class_list: object

    def map(self, fn: Callable) -> "Episode":
        return Episode(*(fn(getattr(self, f.name))
                         for f in dataclasses.fields(self)))

    def __getitem__(self, e: int) -> "Episode":
        """Episode ``e`` of a batch."""
        return self.map(lambda x: x[e])


def stack_episodes(episodes: Sequence[Episode]) -> Episode:
    """Stack host episodes into an ``[E, ...]`` batch: one ``np.stack`` per
    leaf, so the batch crosses to the device as one copy per leaf."""
    return Episode(*(np.stack([getattr(ep, f.name) for ep in episodes])
                     for f in dataclasses.fields(Episode)))


def to_device(episode: Episode, device: torch.device) -> Episode:
    """Move a host episode (or batch) to ``device``. On a GPU each leaf goes
    through pinned host memory and is copied ``non_blocking``; the caller
    orders the copies against their use (``train/learner.py``)."""
    if device.type != "cuda":
        return episode.map(lambda x: torch.from_numpy(np.asarray(x)).to(
            device))
    return episode.map(lambda x: torch.from_numpy(np.asarray(x))
                       .pin_memory().to(device, non_blocking=True))
