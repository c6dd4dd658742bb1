"""Episodic sampler: host-side index planning, device-side everything else.

A copy of ``clipspm_tpu/data/sampler.py``: numpy ``default_rng(seed)``
draws the plans, so the port replays the JAX package's episode stream.

The reference assembles whole episodes (decode + transform included) inside
``Dataset.__getitem__`` (reference: video_reader.py:276-329). Here the sampler
only produces an **index plan** — which videos, which frames, which labels —
as small numpy arrays; decode and transform happen later (host decode, device
transform), so the plan is cheap, seedable, and testable in isolation.

Sampling protocol parity (distribution-level) with the reference:
  * sample ``way`` distinct classes, then ``shot + queries`` distinct videos
    per class (reference: video_reader.py:281-310);
  * support and query sets independently shuffled
    (reference: video_reader.py:312-318);
  * frame indices: train mode jitters the clip start/end within an excess
    budget of ``min(5, excess/2)`` then takes ``linspace`` samples; eval mode
    trims the first and last frame (reference: video_reader.py:233-263).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .splits import SplitCatalog


@dataclasses.dataclass
class EpisodePlan:
    """Host-side description of one episode; all arrays are numpy."""
    support_video_idx: np.ndarray       # [way*shot] indices into the catalog
    support_frame_idx: np.ndarray       # [way*shot, seq_len]
    support_labels: np.ndarray          # [way*shot] relative labels
    real_support_labels: np.ndarray     # [way*shot] dataset class ids
    target_video_idx: np.ndarray        # [way*q]
    target_frame_idx: np.ndarray        # [way*q, seq_len]
    target_labels: np.ndarray           # [way*q]
    real_target_labels: np.ndarray      # [way*q]
    batch_class_list: np.ndarray        # [way]

    def frame_paths(self, catalog: SplitCatalog, which: str) -> List[List[str]]:
        vids = (self.support_video_idx if which == "support"
                else self.target_video_idx)
        frames = (self.support_frame_idx if which == "support"
                  else self.target_frame_idx)
        out = []
        for v, fidx in zip(vids, frames):
            paths = catalog.records[int(v)].frame_paths
            out.append([paths[int(i)] for i in fidx])
        return out


def plan_frame_indices(n_frames: int, seq_len: int, train: bool,
                       rng: np.random.Generator) -> np.ndarray:
    """Frame-index policy (reference: video_reader.py:233-263)."""
    if n_frames == seq_len:
        return np.arange(seq_len, dtype=np.int64)
    if train:
        excess = n_frames - seq_len
        excess_pad = int(min(5, excess / 2))
        if excess_pad < 1:
            start, end = 0, n_frames - 1
        else:
            start = int(rng.integers(0, excess_pad + 1))
            end = int(rng.integers(n_frames - 1 - excess_pad, n_frames))
    else:
        start, end = 1, n_frames - 2
    if end - start < seq_len:
        start, end = 0, n_frames - 1
    idx = np.linspace(start, end, num=seq_len)
    if seq_len == 1:
        return np.asarray([rng.integers(start, end)], dtype=np.int64)
    return idx.astype(np.int64)


class EpisodeSampler:
    """Draws episode plans from a catalog with an explicit seeded RNG."""

    def __init__(self, catalog: SplitCatalog, way: int, shot: int,
                 queries: int, seq_len: int, train: bool,
                 seed: int = 0):
        self.catalog = catalog
        self.way = way
        self.shot = shot
        self.queries = queries
        self.seq_len = seq_len
        self.train = train
        self.rng = np.random.default_rng(seed)
        classes = catalog.classes
        if len(classes) < way:
            raise ValueError(
                f"catalog has {len(classes)} classes; need way={way}")
        self._classes = np.asarray(classes)

    def sample(self) -> EpisodePlan:
        rng = self.rng
        chosen = rng.choice(self._classes, size=self.way, replace=False)

        sup_v, sup_l, sup_rl = [], [], []
        tgt_v, tgt_l, tgt_rl = [], [], []
        for rel, cls in enumerate(chosen):
            vids = self.catalog.videos_for_class(int(cls))
            take = rng.choice(len(vids), size=self.shot + self.queries,
                              replace=False)
            for i in take[: self.shot]:
                sup_v.append(vids[int(i)])
                sup_l.append(rel)
                sup_rl.append(int(cls))
            for i in take[self.shot:]:
                tgt_v.append(vids[int(i)])
                tgt_l.append(rel)
                tgt_rl.append(int(cls))

        # independent shuffles (reference: video_reader.py:312-318)
        sperm = rng.permutation(len(sup_v))
        tperm = rng.permutation(len(tgt_v))

        def pick(lst, perm):
            return np.asarray([lst[i] for i in perm])

        sup_v, sup_l, sup_rl = (pick(sup_v, sperm), pick(sup_l, sperm),
                                pick(sup_rl, sperm))
        tgt_v, tgt_l, tgt_rl = (pick(tgt_v, tperm), pick(tgt_l, tperm),
                                pick(tgt_rl, tperm))

        def frames(video_ids):
            rows = []
            for v in video_ids:
                n = len(self.catalog.records[int(v)].frame_paths)
                rows.append(plan_frame_indices(n, self.seq_len, self.train,
                                               rng))
            return np.stack(rows)

        return EpisodePlan(
            support_video_idx=sup_v.astype(np.int64),
            support_frame_idx=frames(sup_v),
            support_labels=sup_l.astype(np.int32),
            real_support_labels=sup_rl.astype(np.int32),
            target_video_idx=tgt_v.astype(np.int64),
            target_frame_idx=frames(tgt_v),
            target_labels=tgt_l.astype(np.int32),
            real_target_labels=tgt_rl.astype(np.int32),
            batch_class_list=np.asarray(chosen, dtype=np.int32),
        )

    def __iter__(self):
        while True:
            yield self.sample()
