"""Traced segments: ``torch.profiler`` over the card alone, or over the
host and the card with the benchmark's own spans, each reduced to plain
lists that the per-layer readers (``metrics/``) read.

The profiler's host activity (a record of every op on the host) slows
host-bound steps two- to threefold, so what the host's pace sets (idle
share, device ops) is read from a trace of the card alone, and the host
trace serves the readers that need host ops or spans.

Spans are opened from this file only: ``portbench.window`` around the
segment, and ``portbench.tower`` around every call of the model's vision
tower (forward hooks on ``model.backbone``). On the card a segment starts
and ends with a one-element marker kernel, launched with the card idle:
the window runs from the first marker's start to the last one's, so it
holds the host's work before the first op and after the last.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW, TOWER = "portbench.window", "portbench.tower"
# idle gaps named by the host op at their middle, longest first
NAMED_GAPS = 200


@dataclasses.dataclass
class Trace:
    """A traced window, in nanoseconds of the profiler's clock.

    ``device``: ``(name, start, end, linked op id)`` of every kernel, copy
    and set on the card; ``cpu``: ``(name, start, end, thread, op id,
    shapes)`` of every host op and span; ``window``: ``(start, end)``."""
    device: List[Tuple[str, int, int, int]]
    cpu: List[Tuple[str, int, int, int, int, list]]
    window: Tuple[int, int]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device's intervals inside the window."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e, _ in self.device
                       if e > lo and s < hi)
        out: List[Tuple[int, int]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def spans(self, name: str) -> List[Tuple[int, int, int]]:
        """``(start, end, thread)`` of the host spans called ``name``."""
        return [(s, e, t) for n, s, e, t, _, _ in self.cpu if n == name]

    def device_under(self, name: str) -> List[Tuple[str, int, int, int]]:
        """Device events launched from inside a span ``name``: their host op
        started within it, on its thread."""
        spans = self.spans(name)
        ops = {i: (s, t) for _, s, _, t, i, _ in self.cpu if i > 0}
        out = []
        for ev in self.device:
            op = ops.get(ev[3])
            if op is not None and any(s <= op[0] <= e and t == op[1]
                                      for s, e, t in spans):
                out.append(ev)
        return out

    @staticmethod
    def _host_at(t: int, tid, threads, starts) -> str:
        """The innermost host op running at ``t``: on the window's thread,
        else on whichever thread was busy (the autograd engine's, the
        staging thread's)."""
        order = [tid] + [k for k in threads if k != tid]
        for k in order:
            ops_ = threads.get(k)
            if not ops_:
                continue
            i = bisect.bisect_right(starts[k], t) - 1
            for j in range(i, max(i - 5000, -1), -1):
                if ops_[j][1] >= t:
                    return ops_[j][2]
        return "host: outside any op"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest idle
        gaps, summed by the innermost host op running on the window's
        thread at the middle of each gap."""
        by_name: Dict[str, float] = {}
        for n, s, e, _ in self.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        window = self.spans(WINDOW)
        tid = window[0][2] if window else None
        threads: Dict[int, list] = {}
        for n, s, e, t, _, _ in self.cpu:
            if n != WINDOW:
                threads.setdefault(t, []).append((s, e, n))
        for ops_ in threads.values():
            ops_.sort()
        starts = {t: [h[0] for h in ops_] for t, ops_ in threads.items()}
        busy = self.busy_intervals()
        edges = [self.window[0]] + [x for iv in busy for x in iv] \
            + [self.window[1]]
        all_gaps = sorted(((e - s, s, e) for s, e in zip(edges[::2],
                                                         edges[1::2])
                           if e > s), reverse=True)
        gaps: Dict[str, float] = {}
        for length, s, e in all_gaps[:NAMED_GAPS]:
            name = self._host_at((s + e) // 2, tid, threads, starts)
            gaps[name] = gaps.get(name, 0.0) + length / 1e9
        rest = sum(g[0] for g in all_gaps[NAMED_GAPS:]) / 1e9
        if rest:
            gaps[f"the {len(all_gaps) - NAMED_GAPS} shorter gaps"] = rest
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], v] for n, v in ops],
                "idle_gaps": [[n[:120], v] for n, v in idle]}


class _TowerSpans:
    """``portbench.tower`` around each forward of ``module``."""

    def __init__(self, module: torch.nn.Module):
        self._open: List[record_function] = []
        self._handles = [
            module.register_forward_pre_hook(self._enter),
            module.register_forward_hook(self._exit)]

    def _enter(self, module, args):
        rf = record_function(TOWER)
        rf.__enter__()
        self._open.append(rf)

    def _exit(self, module, args, out):
        self._open.pop().__exit__(None, None, None)

    def close(self) -> None:
        for h in self._handles:
            h.remove()


@contextlib.contextmanager
def traced(model: torch.nn.Module, holder: dict, host: bool):
    """Profile the body (the card alone, or with ``host`` the host too and
    the tower's spans); on exit ``holder["trace"]`` is its ``Trace`` and
    ``holder["reduce_s"]`` the seconds taken to reduce it."""
    on_cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CUDA] if on_cuda else []
    if host or not on_cuda:
        acts.append(ProfilerActivity.CPU)
    backbone = getattr(model, "backbone", None)
    spans = _TowerSpans(backbone) if host and backbone is not None else None
    marker = (lambda: torch.zeros((), device="cuda")) if on_cuda else (
        lambda: None)
    if on_cuda:
        torch.cuda.synchronize()
    try:
        with profile(activities=acts) as prof:
            marker()
            with record_function(WINDOW):
                yield
                if on_cuda:
                    torch.cuda.synchronize()
            marker()
            if on_cuda:
                torch.cuda.synchronize()
    finally:
        if spans is not None:
            spans.close()
    t1 = time.perf_counter()
    holder["trace"] = reduce(prof, marked=on_cuda)
    holder["reduce_s"] = time.perf_counter() - t1


def reduce(prof, marked: bool) -> Trace:
    """The profiler's events as a ``Trace``: device events without the
    device copies of host ranges, host events with their op ids and
    shapes. With ``marked`` the first and last device events are the
    segment's markers, which give the window and are dropped; otherwise
    the window is the ``portbench.window`` span."""
    device, cpu = [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                device.append((ev.name(), s, e, ev.linked_correlation_id()))
        elif ev.device_type() == DeviceType.CPU:
            cpu.append((ev.name(), s, e, ev.start_thread_id(),
                        ev.correlation_id(), ev.shapes()))
    device.sort(key=lambda d: d[1])
    if marked and len(device) >= 2:
        window = (device[0][1], device[-1][1])
        device = device[1:-1]
    else:
        spans = [(s, e) for n, s, e, _, _, _ in cpu if n == WINDOW]
        window = spans[0] if spans else (0, 0)
    return Trace(device=device, cpu=cpu, window=window)


def memory_window_start() -> None:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def memory_window_peak() -> Optional[int]:
    return int(torch.cuda.max_memory_allocated())
