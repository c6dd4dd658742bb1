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

from .episode import Episode
from .sampler import EpisodePlan, EpisodeSampler
from .splits import SplitCatalog


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
    (missing or corrupt frames, a sampler error) is dropped and resampled;
    after 100 failures in a row the error is surfaced to the consumer and
    kept, so every later iterator raises it too. ``close()`` ends iteration.
    """

    def __init__(self, sampler: EpisodeSampler, num_workers: int = 8,
                 prefetch: int = 4, use_native: bool = True):
        self.sampler = sampler
        self.catalog = sampler.catalog
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

    def _producer(self):
        failures = 0
        while not self._stop.is_set():
            try:
                item = decode_plan(self.sampler.sample(), self.catalog,
                                   self._pool, frame_size=self.frame_size,
                                   native_threads=self.native_threads)
                failures = 0
            except Exception as exc:  # noqa: BLE001 - resample, bounded
                failures += 1
                if failures < 100:
                    continue
                # a raise here would end this thread silently and leave the
                # consumer blocked on the queue: hand the error over instead
                item = RuntimeError("episode pipeline failed 100 times in a "
                                    f"row; last error: {exc!r}")
                item.__cause__ = exc
                self._error = item
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if isinstance(item, Exception):
                return

    def __iter__(self) -> Iterator[Episode]:
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
        self._stop.set()
        self._pool.shutdown(wait=False, cancel_futures=True)
