"""Scalar logging and profiling.

Port of ``clipspm_tpu/utils/metrics.py``:

- :class:`MetricsWriter` appends one ``{"step", "tag", "value", "ts"}``
  JSON object per line, with the JAX trainer's scalar set, and mirrors each
  scalar into TensorBoard event files when the ``tensorboard`` package
  imports (it is optional: without it the JSONL is the record);
- :func:`jsonl_to_tensorboard`, which writes such a JSONL's scalars into
  TensorBoard event files after the run;
- :func:`host_rss_gb`, logged with every train line;
- :class:`TestAccuracies`, the results formatter;
- :func:`profile_trace`, a ``torch.profiler`` trace of a block written as a
  Chrome trace under a directory;
- the span recorder: :func:`span` and :func:`timed` around the program's
  layers, kept only inside :func:`recording`.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterable, NamedTuple, Optional


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


def jsonl_to_tensorboard(jsonl_path: str, tb_dir: str) -> int:
    """Write the scalars of a ``metrics.jsonl`` made by
    :class:`MetricsWriter` into TensorBoard event files under ``tb_dir``;
    returns how many. Raises without the ``tensorboard`` package."""
    writer = _open_event_writer(tb_dir)
    if writer is None:
        raise RuntimeError("tensorboard package not available")
    n = 0
    try:
        with open(jsonl_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                writer.add_event(_scalar_event(
                    rec["tag"], rec["value"], rec["step"],
                    rec.get("ts", time.time())))
                n += 1
    finally:
        writer.close()
    return n


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


# The span recorder. A span's start is stamped with ``time.time_ns``
# (Unix-epoch nanoseconds), the clock of the profiler's events (a
# ``record_function`` range's ``start_ns()``), so spans lay over a device
# trace; its duration is a ``perf_counter_ns`` pair, which no clock step
# moves, and its end the start plus the duration. At most MAX_SPANS
# records a recording; the rest are counted as dropped.
MAX_SPANS = 1 << 20


class SpanRecord(NamedTuple):
    """One closed span. ``parent`` is the span open on the same thread when
    it began; ``call`` the ``Learner.train_episodes`` or
    ``Learner.evaluate`` span it ran under, on any thread (None outside
    one)."""
    name: str
    id: int
    parent: Optional[int]
    call: Optional[int]
    thread: int
    start_ns: int
    end_ns: int
    attrs: dict


class Spans(list):
    """The :class:`SpanRecord` s of one :func:`recording`, in the order the
    spans closed, and ``dropped``: how many past ``MAX_SPANS``."""
    dropped = 0


class _Recorder:
    """The process's recorder: the active recording (None: off), span ids,
    the open call, each thread's stack of open span ids, and the lock under
    which threads append to the recording and count what it dropped."""

    def __init__(self):
        self.records: Optional[Spans] = None
        self.ids = itertools.count(1)
        self.call: Optional[int] = None
        self.local = threading.local()
        self.lock = threading.Lock()

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_RECORDER = _Recorder()


class _NoSpan:
    """What :func:`span` returns while nothing records: one shared object
    that does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NO_SPAN = _NoSpan()


class _Span:
    """An open span: a ``record_function`` range of its name and, on exit,
    one record in the recording that was on when it began. With no
    recording (a :func:`timed` span) it only reads the clock."""
    __slots__ = ("name", "attrs", "seconds", "_records", "_starts_call",
                 "_id", "_parent", "_call", "_prev_call", "_range", "_start",
                 "_pc")

    def __init__(self, name: str, attrs: dict, records: Optional[Spans],
                 starts_call: bool = False):
        self.name, self.attrs, self._records = name, attrs, records
        self._starts_call = starts_call
        self.seconds = 0.0

    def set(self, **attrs) -> None:
        """Attributes known only inside the span (bytes staged, ...)."""
        self.attrs.update(attrs)

    def __enter__(self):
        if self._records is None:
            self._pc = time.perf_counter_ns()
            return self
        from torch.profiler import record_function

        rec = _RECORDER
        stack = rec.stack()
        self._id = next(rec.ids)
        self._parent = stack[-1] if stack else None
        stack.append(self._id)
        if self._starts_call:
            self._prev_call, rec.call = rec.call, self._id
        self._call = rec.call
        self._range = record_function(self.name)
        # the stamps enclose the profiler range, whose exit can take
        # 0.2 ms under a profiler: a range around the span ends with it
        self._start = time.time_ns()
        self._pc = time.perf_counter_ns()
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        records = self._records
        if records is None:
            self.seconds = (time.perf_counter_ns() - self._pc) / 1e9
            return False
        self._range.__exit__(*exc)
        duration = time.perf_counter_ns() - self._pc
        self.seconds = duration / 1e9
        rec = _RECORDER
        rec.stack().pop()
        if self._starts_call:
            rec.call = self._prev_call
        # a callable attr is a count taken only here, while recording
        record = SpanRecord(
            self.name, self._id, self._parent, self._call,
            threading.get_ident(), self._start, self._start + duration,
            {k: v() if callable(v) else v for k, v in self.attrs.items()})
        with rec.lock:
            if len(records) < MAX_SPANS:
                records.append(record)
            else:
                records.dropped += 1
        return False


def span(name: str, call: bool = False, **attrs):
    """A span of the program's work called ``name``, with ``attrs``
    (counts: frames, bytes, shapes; a count that costs work to take is
    passed as a callable, called only when the span is recorded).
    ``call``: it is a whole ``train_episodes`` or ``evaluate`` call, whose
    id every span inside it carries. Outside :func:`recording` it is
    :data:`NO_SPAN`."""
    records = _RECORDER.records
    if records is None:
        return NO_SPAN
    return _Span(name, attrs, records, call)


def timed(name: str, **attrs) -> _Span:
    """A span that reads the clock whether or not a recording is on: its
    ``seconds`` after exit (a ``perf_counter_ns`` pair) are the record's
    duration when one is (the host-stall timers)."""
    return _Span(name, attrs, _RECORDER.records)


@contextlib.contextmanager
def recording():
    """Record every span begun inside the block; yields its
    :class:`Spans`. Nothing is written anywhere: a ``torch.profiler``
    trace of the block carries the spans' names as its user ranges."""
    records = Spans()
    rec = _RECORDER
    previous, rec.records = rec.records, records
    try:
        yield records
    finally:
        rec.records = previous
