"""Scalar logging and profiling.

Port of ``clipspm_tpu/utils/metrics.py``:

- :class:`MetricsWriter` appends one ``{"step", "tag", "value", "ts"}``
  JSON object per line, with the JAX trainer's scalar set, and mirrors each
  scalar into TensorBoard event files when the ``tensorboard`` package
  imports (it is optional: without it the JSONL is the record);
- :func:`host_rss_gb`, logged with every train line;
- :class:`TestAccuracies`, the results formatter;
- :func:`profile_trace`, a ``torch.profiler`` trace of a block written as a
  Chrome trace under a directory.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterable, Optional


def host_rss_gb() -> float:
    """Resident-set size of this process in GB (0.0 if unreadable)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    return 0.0


def _open_event_writer(tb_dir: str):
    """A TensorBoard event-file writer, or None without ``tensorboard``."""
    try:
        from tensorboard.summary.writer.event_file_writer import \
            EventFileWriter
    except ImportError:
        return None
    return EventFileWriter(tb_dir)


def _scalar_event(tag: str, value: float, step: int, wall_time: float):
    from tensorboard.compat.proto.event_pb2 import Event
    from tensorboard.compat.proto.summary_pb2 import Summary

    summary = Summary(value=[Summary.Value(tag=tag,
                                           simple_value=float(value))])
    return Event(wall_time=wall_time, step=int(step), summary=summary)


class MetricsWriter:
    """Append-only JSONL scalar writer, mirrored to TensorBoard event files
    under ``tb_dir`` when ``tensorboard`` is installed."""

    def __init__(self, path: str, flush_every: int = 20,
                 tb_dir: Optional[str] = None):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a")
        self._n = 0
        self._flush_every = flush_every
        self._tb = _open_event_writer(tb_dir) if tb_dir else None

    def scalar(self, tag: str, value: float, step: int) -> None:
        now = time.time()
        self._f.write(json.dumps({
            "step": int(step), "tag": tag, "value": float(value),
            "ts": round(now, 3)}) + "\n")
        if self._tb is not None:
            self._tb.add_event(_scalar_event(tag, value, step, now))
        self._n += 1
        if self._n % self._flush_every == 0:
            self._f.flush()

    def scalars(self, values: Dict[str, float], step: int) -> None:
        for tag, v in values.items():
            self.scalar(tag, v, step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class TestAccuracies:
    """Results formatter: ``<dataset>: <acc>+/-<ci>`` per dataset."""

    def __init__(self, datasets: Iterable[str]):
        self.datasets = list(datasets)

    def format(self, accuracy_dict: Dict[str, Dict[str, float]]) -> str:
        lines = [""]
        for ds in self.datasets:
            if ds in accuracy_dict:
                d = accuracy_dict[ds]
                lines.append(f"{ds}: {d['accuracy']:.1f}+/-"
                             f"{d['confidence']:.1f}")
        lines.append("")
        return "\n".join(lines)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """``torch.profiler`` (CPU and, when present, CUDA activity) over the
    block, written to ``log_dir/trace.json``; a no-op without a dir."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
