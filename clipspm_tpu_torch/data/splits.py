"""Split catalogs: parse the benchmark split lists and scan frame dirs.

A copy of ``clipspm_tpu/data/splits.py`` (the port imports nothing of the
JAX package).

Behavioral parity with the reference's catalog construction
(reference: video_reader.py:113-164): each line of
``{train,test}list03.txt`` is ``<class>/<video_id>``; the video's frame dir is
scanned for images; videos with fewer than ``seq_len`` frames are dropped;
class ids come from first-appearance order except the SSv2 variants, which
encode the id in the class dir name (``trainN``/``testN``), with CMN train ids
offset by -24 (reference: video_reader.py:145-148).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional


@dataclasses.dataclass
class VideoRecord:
    frame_paths: List[str]
    class_id: int


class SplitCatalog:
    """All videos of one split (train or test)."""

    def __init__(self, records: Optional[List[VideoRecord]] = None):
        self.records: List[VideoRecord] = records or []
        self._by_class: Dict[int, List[int]] = {}
        for i, r in enumerate(self.records):
            self._by_class.setdefault(r.class_id, []).append(i)

    def add(self, record: VideoRecord) -> None:
        self._by_class.setdefault(record.class_id, []).append(len(self.records))
        self.records.append(record)

    def __len__(self) -> int:
        return len(self.records)

    @property
    def classes(self) -> List[int]:
        return sorted(self._by_class)

    def videos_for_class(self, class_id: int) -> List[int]:
        return self._by_class[class_id]

    def num_videos_for_class(self, class_id: int) -> int:
        return len(self._by_class[class_id])


_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def load_split(annotation_dir: str, data_dir: str, mode: str,
               dataset: str, seq_len: int, split_num: int = 3) -> SplitCatalog:
    """Build the catalog for one split.

    Args:
        annotation_dir: directory containing ``{mode}list{split:02d}.txt``.
        data_dir: frame root; frames live at ``{data_dir}/{mode}/{line}/``.
        mode: "train" or "test".
        dataset: dataset key; 'ssv2'/'ssv2_cmn' trigger dirname-encoded ids.
        seq_len: videos with fewer frames are dropped
            (reference: video_reader.py:142-143).
    """
    fname = f"{mode}list{split_num:02d}.txt"
    path = os.path.join(annotation_dir, fname)
    mode_root = os.path.join(data_dir, mode)
    catalog = SplitCatalog()
    cls_ids: Dict[str, int] = {}

    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("/")
            if len(parts) != 2:
                raise ValueError(f"malformed split line: {line!r}")
            cls, _vid = parts
            vid_path = os.path.join(mode_root, line)
            try:
                frames = [os.path.join(vid_path, e) for e in os.listdir(vid_path)
                          if e.lower().endswith(_IMG_EXTS)]
            except FileNotFoundError:
                continue
            if len(frames) < seq_len:
                continue
            frames.sort()
            if dataset in ("ssv2", "ssv2_cmn"):
                class_id = int(cls.split(mode)[-1])
                if dataset == "ssv2_cmn" and mode == "train":
                    class_id -= 24
            else:
                if cls not in cls_ids:
                    cls_ids[cls] = len(cls_ids)
                class_id = cls_ids[cls]
            catalog.add(VideoRecord(frames, class_id))
    return catalog
