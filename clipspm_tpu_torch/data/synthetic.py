"""Synthetic episode sources: seeded random episodes, no dataset needed.

Port of ``clipspm_tpu/data/synthetic.py``. The episodes have the shapes and
the label layout of the real pipeline's, so every head, trainer and bench
runs without a dataset on disk. With one seed the source makes the JAX
source's numpy draws in the same order, so its episodes equal the JAX
package's bit for bit.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from .episode import Episode


class SyntheticEpisodeSource:
    """Yields random uint8 episodes with a valid episodic label layout.

    Each class has its own mean brightness, so a head can fit the classes
    in a smoke test. ``Learner(train_source=...)`` and
    ``Learner.evaluate(n, source=...)`` take it as they take an
    ``EpisodeLoader``.
    """

    def __init__(self, way: int = 5, shot: int = 1, queries: int = 5,
                 seq_len: int = 8, img_size: int = 224, num_classes: int = 16,
                 seed: int = 0, channels: int = 3):
        self.way, self.shot, self.queries = way, shot, queries
        self.seq_len, self.img_size = seq_len, img_size
        self.num_classes = num_classes
        self.channels = channels
        self.rng = np.random.default_rng(seed)

    def sample(self) -> Episode:
        rng = self.rng
        way, shot, q = self.way, self.shot, self.queries
        classes = rng.choice(self.num_classes, size=way, replace=False)

        def clips(n, class_ids):
            noise = rng.integers(
                0, 96, size=(n, self.seq_len, self.img_size, self.img_size,
                             self.channels))
            # the JAX source's clip(base + noise, 0, 255) cast to uint8, in
            # int16: noise is an integer, so the cast's floor of base +
            # noise is floor(base) + noise
            base = np.floor(class_ids * 255.0 / self.num_classes)
            out = noise.astype(np.int16)
            out += base.astype(np.int16)[:, None, None, None, None]
            return np.minimum(out, 255, out=out).astype(np.uint8)

        sup_rl = np.repeat(classes, shot)
        sup_l = np.repeat(np.arange(way), shot)
        tgt_rl = np.repeat(classes, q)
        tgt_l = np.repeat(np.arange(way), q)
        sperm = rng.permutation(way * shot)
        tperm = rng.permutation(way * q)

        return Episode(
            support_images=clips(way * shot, sup_rl)[sperm],
            support_labels=sup_l[sperm].astype(np.int32),
            target_images=clips(way * q, tgt_rl)[tperm],
            target_labels=tgt_l[tperm].astype(np.int32),
            real_support_labels=sup_rl[sperm].astype(np.int32),
            real_target_labels=tgt_rl[tperm].astype(np.int32),
            batch_class_list=classes.astype(np.int32),
        )

    def __iter__(self) -> Iterator[Episode]:
        while True:
            yield self.sample()

    def close(self) -> None:
        """Nothing to release (``Learner.close`` closes its sources)."""
