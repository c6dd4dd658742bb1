"""Host-side episode loader: plan -> threaded JPEG decode -> uint8 episodes.

Port of ``clipspm_tpu/data/pipeline.py``: ``decode_path_lists`` (frame-path
lists -> uint8 ``[N, T, H, W, 3]``), ``probe_frame_size``, ``decode_plan``
and the prefetching ``EpisodeLoader``. Workers only decode; crop, flip and
scaling run on the device (``data/transforms.py``).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import queue
import threading
from typing import Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .episode import Episode
from .sampler import EpisodePlan, EpisodeSampler
from .splits import SplitCatalog

# seconds ``EpisodeLoader.close`` waits for its producer over a group
CLOSE_WAIT_S = 60


def _decode_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        im.load()
        if im.mode != "RGB":
            im = im.convert("RGB")
        return np.asarray(im, dtype=np.uint8)


def probe_frame_size(catalog: SplitCatalog) -> Optional[tuple]:
    """(H, W) of the first decodable frame (None when empty/unreadable)."""
    for rec in catalog.records[:16]:
        if rec.frame_paths:
            try:
                h, w = _decode_image(rec.frame_paths[0]).shape[:2]
            except (OSError, ValueError):
                continue
            return (h, w)
    return None


def decode_path_lists(path_lists: List[List[str]],
                      pool: Optional[cf.ThreadPoolExecutor] = None,
                      frame_size: Optional[tuple] = None,
                      native_threads: int = 8) -> np.ndarray:
    """Decode ``[clips][t]`` frame paths into a uint8 ``[N, t, H, W, 3]``.

    With ``frame_size`` (uniform dumps such as the 256x256 benchmark
    frames) the whole list goes through the native batch decoder; otherwise
    per-frame PIL, in ``pool`` when given.
    """
    flat = [p for clip in path_lists for p in clip]
    t = len(path_lists[0])
    if frame_size is not None:
        from .native_decode import decode_frames

        arr = decode_frames(flat, frame_size[0], frame_size[1],
                            n_threads=native_threads)
        return arr.reshape((len(path_lists), t) + arr.shape[1:])
    if pool is not None:
        frames = list(pool.map(_decode_image, flat))
    else:
        frames = [_decode_image(p) for p in flat]
    arr = np.stack(frames)
    return arr.reshape((len(path_lists), t) + arr.shape[1:])


def decode_plan(plan: EpisodePlan, catalog: SplitCatalog,
                pool: Optional[cf.ThreadPoolExecutor] = None,
                frame_size: Optional[tuple] = None,
                native_threads: int = 8) -> Episode:
    """Decode every frame of an episode plan into a host (numpy) Episode."""
    def decode_clips(which: str) -> np.ndarray:
        return decode_path_lists(plan.frame_paths(catalog, which), pool,
                                 frame_size, native_threads)

    return Episode(
        support_images=decode_clips("support"),
        support_labels=plan.support_labels,
        target_images=decode_clips("target"),
        target_labels=plan.target_labels,
        real_support_labels=plan.real_support_labels,
        real_target_labels=plan.real_target_labels,
        batch_class_list=plan.batch_class_list,
    )


class EpisodeLoader:
    """Prefetching episode stream over a seeded sampler.

    One producer thread plans and decodes episodes into a bounded queue (the
    back-pressure); iterating yields host ``Episode``s. A bad episode
    (missing or corrupt frames, a sampler error) is dropped and the next
    plan takes its place, as the JAX loader resamples; after 100 failures
    in a row the error is surfaced to the consumer and kept, so every later
    iterator raises it too. ``close()`` ends iteration.

    ``shard=(rank, world)``: every rank plans the whole stream (the same
    seed, the same plans) and decodes only its share, slots ``rank, rank +
    world, ...``, yielding None in the other ranks' places. ``group`` (a
    process group over every rank of the grid, for this loader's producer
    alone; the tp ranks of a dp index share its ``rank``) carries one
    decode-ok flag a slot: the producers run the stream in rounds of
    ``world`` slots, and when slot s's plan fails every rank drops it, the
    next plan takes slot s and every later slot of the round shifts by one
    plan (their owners decode again), which is the stream one JAX producer
    makes, at every ``world``. A rank whose ``close()`` has been called
    says so in its next round's flags, and every producer ends there.
    """

    def __init__(self, sampler: EpisodeSampler, num_workers: int = 8,
                 prefetch: int = 4, use_native: bool = True,
                 shard: tuple = (0, 1), group=None):
        self.sampler = sampler
        self.catalog = sampler.catalog
        self.rank, self.world = (int(x) for x in shard)
        if self.world > 1 and group is None:
            raise ValueError("a sharded EpisodeLoader needs the group its "
                             "ranks exchange their decode flags over")
        self.group = group
        # a frame geometry is pinned only when the native batch decoder
        # loads; otherwise decode goes per frame through PIL in the pool
        if use_native:
            from .native_decode import get_library

            use_native = get_library() is not None
        self.frame_size = probe_frame_size(self.catalog) if use_native else None
        self.num_workers = max(1, num_workers)
        self.native_threads = max(1, min(self.num_workers,
                                         os.cpu_count() or self.num_workers))
        self.prefetch = max(1, prefetch)
        self._queue: "queue.Queue" = queue.Queue(self.prefetch)
        self._pool = cf.ThreadPoolExecutor(max_workers=self.num_workers)
        self._error: Optional[Exception] = None   # terminal producer failure
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _decode(self, plan) -> tuple:
        """``(episode, None)``, or ``(None, error)`` for a plan that failed
        (a sampler error stands in the plan's place)."""
        if isinstance(plan, Exception):
            return None, plan
        try:
            return decode_plan(plan, self.catalog, self._pool,
                               frame_size=self.frame_size,
                               native_threads=self.native_threads), None
        except Exception as exc:  # noqa: BLE001 - dropped, bounded
            return None, exc

    def _sample(self):
        try:
            return self.sampler.sample()
        except Exception as exc:  # noqa: BLE001 - dropped, bounded
            return exc

    def _flags(self, failed: bool, open_from: int) -> Optional[list]:
        """Whether each slot of the round failed on any rank (this rank's
        own when it is at or past ``open_from``), or None when a rank is
        closing."""
        t = torch.zeros(self.world + 1, dtype=torch.int64)
        if self.rank >= open_from:
            t[self.rank] = int(failed)
        t[self.world] = int(self._stop.is_set())
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        if t[self.world]:
            return None
        return [bool(f) for f in t[:self.world].tolist()]

    def _round(self, plans: list, failures: int) -> Optional[tuple]:
        """One round of ``world`` slots from the plans ahead (``plans``,
        consumed in place; more are sampled as needed): ``(items,
        failures)``, where the last item is the terminal error when the
        budget ran out; None when a rank is closing."""
        items: list = []
        while len(items) < self.world:
            open_from = len(items)
            while len(plans) < self.world - open_from:
                plans.append(self._sample())
            mine = self.rank - open_from
            episode, exc = (self._decode(plans[mine]) if mine >= 0
                            and not self._stop.is_set() else (None, None))
            flags = self._flags(exc is not None, open_from)
            if flags is None:
                return None
            for slot in range(open_from, self.world):
                plan = plans.pop(0)
                if not flags[slot]:
                    failures = 0
                    items.append(episode if slot == self.rank else None)
                    continue
                failures += 1
                if failures >= 100:
                    # a raise here would end the producer silently and
                    # leave the consumer blocked on the queue: hand the
                    # error over
                    last = (exc if slot == self.rank else plan
                            if isinstance(plan, Exception) else RuntimeError(
                                f"slot {slot}'s plan failed on its rank"))
                    err = RuntimeError("episode pipeline failed 100 times "
                                       f"in a row; last error: {last!r}")
                    err.__cause__ = last
                    items.append(err)
                    return items, failures
                # the later slots of the round take the next plans
                break
        return items, failures

    def _producer(self):
        plans: list = []
        failures = 0
        while True:
            got = self._round(plans, failures)
            if got is None:
                return
            items, failures = got
            for item in items:
                if isinstance(item, Exception):
                    self._error = item
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if isinstance(item, Exception):
                    return

    def __iter__(self) -> Iterator[Optional[Episode]]:
        while True:
            try:
                item = self._queue.get(timeout=0.5)
            except queue.Empty:
                if self._error is not None:
                    raise self._error
                if self._stop.is_set():
                    return
                continue
            if isinstance(item, Exception):
                raise item
            yield item

    def close(self):
        """End the stream. Over a group every rank's producer ends at the
        round in which the first of them sees a ``close()``, so every rank
        closes its loaders in the same order; this waits for its own (at
        most ``CLOSE_WAIT_S``: a rank that ends on an error must not wait
        on peers that never close)."""
        self._stop.set()
        if self.group is not None:
            self._thread.join(timeout=CLOSE_WAIT_S)
        self._pool.shutdown(wait=False, cancel_futures=True)
