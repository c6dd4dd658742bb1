"""Host-side frame decode: frame-path lists -> uint8 ``[N, T, H, W, 3]``.

Port of the decode half of ``clipspm_tpu/data/pipeline.py``
(``decode_path_lists``, ``probe_frame_size``). The prefetching
``EpisodeLoader`` is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import List, Optional

import numpy as np

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
