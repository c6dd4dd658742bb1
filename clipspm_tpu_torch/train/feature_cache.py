"""Eval-time unique-video feature cache: the test protocol without
re-encoding.

Port of ``clipspm_tpu/train/feature_cache.py``. The eval frame-index policy
and the eval transform are deterministic per video, so each test video
contributes identical features to every episode that samples it. So:

1. every episode's index plan is drawn up front (host numpy);
2. each unique sampled video is encoded once into a device-resident table
   ``[V, T, ...]`` (frame vectors ``[V, T, D]`` for clipspm, post-TTM maps
   ``[V, T, h, w, D]`` for ta2n); the decode of batch i+1 overlaps the
   encode of batch i;
3. the head runs one episode at a time over table gathers, with the
   episodes' index and label arrays moved to the device once.

Metrics (mean accuracy, ``196*std/sqrt(n)`` CI, mean loss) and the result
dict are the JAX evaluator's.
"""

from __future__ import annotations

import concurrent.futures as _cf
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.pipeline import decode_path_lists, probe_frame_size
from ..data.sampler import EpisodePlan, EpisodeSampler
from ..data.transforms import episode_device_transform
from .learner import Learner
from .losses import loss_and_acc


def _model_feature_cacheable(model) -> bool:
    fn = getattr(model, "feature_cacheable", None)
    return bool(fn()) if callable(fn) else False


def _collect_plans(sampler: EpisodeSampler, n_episodes: int
                   ) -> List[EpisodePlan]:
    return [sampler.sample() for _ in range(n_episodes)]


def _frame_plans(plans: Sequence[EpisodePlan]) -> Dict[int, np.ndarray]:
    """vid -> its (deterministic) eval frame indices, in one pass.

    Cross-checks every re-occurrence: the eval frame-index policy must be
    deterministic per video or caching one feature row per video would be
    wrong."""
    out: Dict[int, np.ndarray] = {}
    for p in plans:
        for vids, frames in ((p.support_video_idx, p.support_frame_idx),
                             (p.target_video_idx, p.target_frame_idx)):
            for v, row in zip(vids.tolist(), frames):
                prev = out.get(int(v))
                if prev is None:
                    out[int(v)] = row
                elif not np.array_equal(prev, row):
                    raise AssertionError(
                        f"video {v} drew two different eval frame plans "
                        f"({prev} vs {row}) — eval sampling must be "
                        "deterministic per video for feature caching")
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class FeatureCachedEvaluator:
    """Evaluate ``n_episodes`` of a seeded eval stream via a unique-video
    feature table."""

    def __init__(self, learner: Learner, catalog, sampler: EpisodeSampler, *,
                 encode_videos_per_step: int = 30,
                 eval_batch: int = 64,
                 num_decode_workers: int = 8,
                 log_fn: Callable[[str], None] = print):
        if not _model_feature_cacheable(learner.model):
            raise ValueError(
                f"model {learner.model_name!r} does not support eval "
                "feature caching (needs per-video features that fully "
                "determine the episode forward)")
        if sampler.train:
            raise ValueError("feature caching is eval-only: train-mode "
                             "frame jitter/crop/flip make features "
                             "draw-dependent")
        if sampler.seq_len < 2:
            raise ValueError(
                "feature caching requires DATA.SEQ_LEN >= 2: the eval "
                "frame-index policy is only deterministic per video for "
                "seq_len >= 2")
        self.learner = learner
        self.catalog = catalog
        self.sampler = sampler
        self.encode_videos_per_step = max(1, int(encode_videos_per_step))
        self.eval_batch = max(1, int(eval_batch))
        self.log = log_fn
        from ..data.native_decode import get_library

        use_native = get_library() is not None
        self.frame_size = probe_frame_size(catalog) if use_native else None
        self._pool = _cf.ThreadPoolExecutor(max_workers=num_decode_workers)

        # Host-side center crop: when decoded frames are square at exactly
        # ``resize_to``, the resize is an identity and the center crop a
        # pure slice, so cropping the uint8 array on the host gives
        # identical model input for (img/resize_to)^2 of the bytes moved.
        transform = learner.transform
        self._crop_off = None
        if (self.frame_size is not None
                and self.frame_size[0] == self.frame_size[1]
                == int(transform.resize_to)
                and int(transform.img_size) < int(transform.resize_to)):
            self._crop_off = (int(transform.resize_to)
                              - int(transform.img_size)) // 2

    # -- table build --------------------------------------------------------

    def _decode_videos(self, vids: Sequence[int],
                       frame_plans: Dict[int, np.ndarray]) -> np.ndarray:
        path_lists = []
        for v in vids:
            paths = self.catalog.records[int(v)].frame_paths
            path_lists.append([paths[int(i)] for i in frame_plans[int(v)]])
        arr = decode_path_lists(path_lists, self._pool, self.frame_size)
        if self._crop_off is not None:
            off, size = self._crop_off, int(self.learner.transform.img_size)
            arr = np.ascontiguousarray(
                arr[..., off:off + size, off:off + size, :])
        return arr

    @torch.no_grad()
    def _encode_clips(self, clips_u8: torch.Tensor) -> torch.Tensor:
        t = self.learner.transform
        # when the host already center-cropped, resize_to=img_size makes the
        # resize and the crop identities
        x = episode_device_transform(
            clips_u8, train=False, img_size=t.img_size,
            resize_to=(t.img_size if self._crop_off is not None
                       else t.resize_to),
            normalize=t.normalize)
        return self.learner.model.encode(x)

    def build_table(self, plans: Sequence[EpisodePlan]) -> tuple:
        """Encode every unique video the plans sample.

        Returns ``(table [V, T, ...] device tensor, row_of: vid -> row)``.
        """
        frame_plans = _frame_plans(plans)
        vids = np.asarray(sorted(frame_plans), dtype=np.int64)
        B = self.encode_videos_per_step
        device = self.learner.device
        batches = [vids[i:i + B] for i in range(0, len(vids), B)]

        rows: List[torch.Tensor] = []
        stager = _cf.ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="clipspm-fc")
        t_enc0 = time.perf_counter()
        log_every = max(1, len(batches) // 4)
        try:
            fut = stager.submit(self._decode_videos, batches[0], frame_plans)
            for i in range(len(batches)):
                clips = fut.result()
                if i + 1 < len(batches):
                    fut = stager.submit(self._decode_videos, batches[i + 1],
                                        frame_plans)
                rows.append(self._encode_clips(
                    torch.from_numpy(clips).to(device)))
                if i == 0 or (i + 1) % log_every == 0 \
                        or i + 1 == len(batches):
                    _sync(device)
                    self.log(f"  table encode: batch {i + 1}/{len(batches)}"
                             f" ({time.perf_counter() - t_enc0:.1f}s)")
        finally:
            stager.shutdown(wait=False, cancel_futures=True)
        table = torch.cat(rows, dim=0)
        row_of = {int(v): i for i, v in enumerate(vids)}
        return table, row_of

    # -- evaluation ---------------------------------------------------------

    @torch.no_grad()
    def evaluate(self, n_episodes: int) -> Dict[str, float]:
        learner, device = self.learner, self.learner.device
        # eval mode before the table encode: a trainer calls this between
        # steps, and BatchNorm in train mode would encode with batch
        # statistics (and move its running ones)
        model = learner.model.eval()
        t0 = time.perf_counter()
        plans = _collect_plans(self.sampler, n_episodes)
        t_plan = time.perf_counter() - t0

        t0 = time.perf_counter()
        table, row_of = self.build_table(plans)
        _sync(device)
        t_encode = time.perf_counter() - t0
        n_vids = len(row_of)

        remap = np.vectorize(row_of.__getitem__, otypes=[np.int64])

        def stacked(get, rows=False):
            arr = np.stack([get(p) for p in plans])
            return torch.from_numpy(remap(arr) if rows else arr).to(device)

        su_rows = stacked(lambda p: p.support_video_idx, rows=True)
        qu_rows = stacked(lambda p: p.target_video_idx, rows=True)
        sup_labels = stacked(lambda p: p.support_labels)
        real_sup = stacked(lambda p: p.real_support_labels)
        real_tgt = stacked(lambda p: p.real_target_labels)
        tgt_labels = stacked(lambda p: p.target_labels)

        t0 = time.perf_counter()
        losses, accs = [], []
        n_batches = -(-n_episodes // self.eval_batch)
        fetch_every = max(1, n_batches // 4)
        for j, start in enumerate(range(0, n_episodes, self.eval_batch)):
            batch = []
            for e in range(start, min(start + self.eval_batch, n_episodes)):
                out = model.match_features(
                    table[su_rows[e]], table[qu_rows[e]], sup_labels[e],
                    real_sup[e], real_tgt[e], learner.text_train,
                    learner.text_test)
                batch.append(torch.stack(loss_and_acc(
                    learner.model_name, out, tgt_labels[e], real_sup[e],
                    real_tgt[e], learner.tasks_per_batch, cfg=learner.cfg,
                    train=False)))
            loss_acc = torch.stack(batch).cpu().numpy()
            losses.extend(loss_acc[:, 0].tolist())
            accs.extend(loss_acc[:, 1].tolist())
            if (j + 1) % fetch_every == 0 or j + 1 == n_batches:
                self.log(f"  head fetch: {j + 1}/{n_batches} batches "
                         f"({time.perf_counter() - t0:.1f}s)")
        t_head = time.perf_counter() - t0

        self.log(f"feature-cached eval: {n_episodes} episodes over "
                 f"{n_vids} unique videos — plan {t_plan:.1f}s, "
                 f"encode {t_encode:.1f}s "
                 f"({n_vids * self.sampler.seq_len / max(t_encode, 1e-9):.0f}"
                 f" frames/s), head {t_head:.1f}s "
                 f"({n_episodes / max(t_head, 1e-9):.1f} eps/s)")
        accs_arr = np.asarray(accs)
        return {
            "accuracy": float(accs_arr.mean() * 100.0),
            "confidence": float(196.0 * accs_arr.std()
                                / np.sqrt(len(accs))),
            "loss": float(np.mean(losses)),
            "unique_videos": n_vids,
            "encode_seconds": t_encode,
            "head_seconds": t_head,
        }

    def close(self):
        self._pool.shutdown(wait=False, cancel_futures=True)


def cached_evaluator(cfg, learner: Learner, catalog, sampler: EpisodeSampler,
                     log_fn: Callable[[str], None] = print
                     ) -> FeatureCachedEvaluator:
    """The config's evaluator (``TEST.CACHE_ENCODE_VIDEOS``,
    ``TEST.CACHE_EVAL_BATCH``, ``DATA.NUM_WORKERS``); raises
    ``ValueError`` where the model or the protocol cannot be cached."""
    return FeatureCachedEvaluator(
        learner, catalog, sampler,
        encode_videos_per_step=int(
            cfg.TEST.get("CACHE_ENCODE_VIDEOS", 30) or 30),
        eval_batch=int(cfg.TEST.get("CACHE_EVAL_BATCH", 64) or 64),
        num_decode_workers=int(cfg.DATA.NUM_WORKERS), log_fn=log_fn)


def evaluate_cached(cfg, learner: Learner, *, n_episodes: Optional[int] = None,
                    catalog=None, sampler: Optional[EpisodeSampler] = None,
                    log_fn: Callable[[str], None] = print) -> Dict[str, float]:
    """One-call cached evaluation of the config's test protocol. Builds the
    test catalog/sampler from ``cfg`` when not supplied, seeded as the JAX
    package seeds its test stream (``MODEL.SEED + 1``)."""
    if catalog is None or sampler is None:
        from .setup import build_catalog_and_sampler

        catalog, sampler = build_catalog_and_sampler(
            cfg, "test", False, int(cfg.TEST.QUERY_PER_CLASS))
    n = int(n_episodes if n_episodes is not None
            else cfg.TEST.TEST_EPISODES)
    ev = cached_evaluator(cfg, learner, catalog, sampler, log_fn=log_fn)
    try:
        return ev.evaluate(n)
    finally:
        ev.close()
