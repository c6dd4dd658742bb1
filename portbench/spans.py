"""The program's own spans over a cell, and the readings they give.

The port records spans around its layers (``clipspm_tpu_torch/utils/
metrics.py``: ``recording``, each a ``SpanRecord`` stamped on the
profiler's clock). After a cell's untraced window, ``passes`` runs two more
segments of ``trace_steps`` steps each:

- **spans**: recording on, no profiler; host times stretched only by the
  spans themselves, so every host-milliseconds reading reads this pass;
- **spans+card**: recording on, the card alone under the profiler with the
  segment's marker kernels (``trace.traced(host=False)``); its idle gaps
  are laid over the spans. A card-only trace slows host-bound launches by a
  quarter to two fifths, so no host time is read from it.

``idle_spans`` puts every idle gap of the spans+card pass down to the
innermost program span open at the gap's middle (the open span that
started last, on any thread). ``READINGS`` holds the per-layer readings of
a ``SpanPasses``; each is None where its pass holds no such span.
``COUNTERS`` reads the spans' counters and fields: bytes staged a second,
the tower's ms a frame, each span's own time less its children's, each
call's and each thread's time, the kernel backwards' shapes and the
staging thread's lead on the evaluation loop.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

runs a cell's set-up, its untraced window, a segment as long as a pass
with recording off, and both passes on the card, and prints one JSON line:
the window's, the segment's and each pass's episodes a second, the
readings, ``idle_spans`` against the pass's idle seconds, and how long
after the card's last event each ``learner.fetch`` and ``eval.harvest``
span ended (the two clocks' agreement).
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

OUTSIDE = "outside any span"
# spans that end when the host has waited for the card
FETCHES = ("learner.fetch", "eval.harvest")


@dataclasses.dataclass
class SpanPasses:
    """The records, episodes and wall of the spans pass and of the
    spans+card pass, the latter's ``trace.Trace`` of the card alone, and
    the records dropped past the recorder's cap in both."""
    spans: list
    spans_episodes: int
    spans_wall_s: float
    card_spans: list
    card_episodes: int
    card_wall_s: float
    card: object
    dropped: int


def passes(ent, learner, pool: list, traffic: dict,
           state: dict) -> SpanPasses:
    """The two passes of ``ent.segment`` over ``learner``."""
    from clipspm_tpu_torch.utils.metrics import recording

    from .trace import traced

    with recording() as host:
        seg = ent.segment(learner, pool, traffic, state)
    holder: dict = {}
    with recording() as card, traced(learner.model, holder, host=False):
        card_seg = ent.segment(learner, pool, traffic, state)
    return SpanPasses(list(host), seg["episodes"], seg["wall_s"],
                      list(card), card_seg["episodes"], card_seg["wall_s"],
                      holder["trace"], host.dropped + card.dropped)


def host_ms(records: Sequence, name: str, episodes: int) -> Optional[float]:
    """Milliseconds an episode in the spans called ``name``."""
    durations = [r.end_ns - r.start_ns for r in records if r.name == name]
    if not durations or not episodes:
        return None
    return sum(durations) / 1e6 / episodes


def _gaps(trace) -> List[tuple]:
    """``(start, end)`` of every stretch of the trace's window in which the
    card ran nothing."""
    busy = trace.busy_intervals()
    edges = [trace.window[0]] + [x for iv in busy for x in iv] \
        + [trace.window[1]]
    return [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]


def _innermost(records: Sequence, times: Sequence[int]) -> List[str]:
    """The innermost span open at each of the ascending ``times`` (of the
    spans with start <= t <= end, the one that started last, on any
    thread), or ``OUTSIDE``."""
    spans = sorted(records, key=lambda r: r.start_ns)
    heap: list = []
    out, i = [], 0
    for t in times:
        while i < len(spans) and spans[i].start_ns <= t:
            heapq.heappush(heap, (-spans[i].start_ns, i))
            i += 1
        # a span that ended before t ended before every later time too
        while heap and spans[heap[0][1]].end_ns < t:
            heapq.heappop(heap)
        out.append(spans[heap[0][1]].name if heap else OUTSIDE)
    return out


def idle_by_span(records: Sequence, trace) -> Dict[str, float]:
    """The trace's idle seconds summed by the innermost span open at each
    gap's middle; they sum to the window's idle time."""
    gaps = sorted(_gaps(trace), key=lambda g: g[0] + g[1])
    names = _innermost(records, [(s + e) // 2 for s, e in gaps])
    out: Dict[str, float] = {}
    for (s, e), name in zip(gaps, names):
        out[name] = out.get(name, 0.0) + (e - s) / 1e9
    return out


def idle_spans(records: Sequence, trace, top: int = 10) -> List[list]:
    """``[name, idle seconds]`` of the ``top`` spans the card waited under
    most, the rest of the spans as one ``other spans`` entry, and last
    ``outside any span``: the breakdown's ``idle_spans``."""
    by = idle_by_span(records, trace)
    outside = by.pop(OUTSIDE, 0.0)
    ranked = sorted(by.items(), key=lambda kv: -kv[1])
    out = [[n, v] for n, v in ranked[:top]]
    rest = sum(v for _, v in ranked[top:])
    if rest:
        out.append(["other spans", rest])
    return out + [[OUTSIDE, outside]]


def idle_share(records: Sequence, trace, name: str) -> Optional[float]:
    """The card's idle time under an innermost span ``name`` over all its
    idle time, in %."""
    if not any(r.name == name for r in records):
        return None
    by = idle_by_span(records, trace)
    total = sum(by.values())
    return 100.0 * by.get(name, 0.0) / total if total else None


def fetch_lags_ms(records: Sequence, trace,
                  names: Sequence[str] = FETCHES) -> Dict[str, List[float]]:
    """For each span of ``names``: milliseconds from the end of the last
    card event that ended before the span did to the span's end. A span
    that ends when the host has waited for the card reads just above 0 when
    the spans' clock is the trace's."""
    ends = sorted(e for _, _, e, _ in trace.device)
    out: Dict[str, List[float]] = {}
    for r in records:
        if r.name in names:
            i = bisect.bisect_right(ends, r.end_ns)
            if i:
                out.setdefault(r.name, []).append(
                    (r.end_ns - ends[i - 1]) / 1e6)
    return out


def _ms(r) -> float:
    return (r.end_ns - r.start_ns) / 1e6


def stage_gb_per_s(records: Sequence, name: str) -> Optional[float]:
    """The ``bytes`` of the spans ``name`` over their seconds: how fast
    staging stacks, pins and copies (``learner.stage``: the caller;
    ``eval.stage``: the staging thread)."""
    rs = [r for r in records if r.name == name and "bytes" in r.attrs]
    ns = sum(r.end_ns - r.start_ns for r in rs)
    return sum(r.attrs["bytes"] for r in rs) / ns if ns else None


def tower_ms_per_frame(records: Sequence) -> Optional[float]:
    """``model.tower`` milliseconds over the ``frames`` encoded."""
    rs = [r for r in records if r.name == "model.tower"]
    frames = sum(r.attrs["frames"] for r in rs)
    return sum(_ms(r) for r in rs) / frames if frames else None


def self_ms(records: Sequence, episodes: int) -> Dict[str, float]:
    """Each span's milliseconds an episode less its children's (the spans
    whose ``parent`` it is): the time no inner span names."""
    out: Dict[str, float] = {}
    by_id = {r.id: r for r in records}
    for r in records:
        out[r.name] = out.get(r.name, 0.0) + _ms(r) / episodes
        if r.parent in by_id:
            p = by_id[r.parent].name
            out[p] = out.get(p, 0.0) - _ms(r) / episodes
    return out


def by_call(records: Sequence) -> List[dict]:
    """Each ``train_episodes`` or ``evaluate`` call (the spans sharing its
    ``call`` id, on any thread): its name, ``episodes``, milliseconds, and
    its spans' milliseconds by name."""
    calls = {r.id: r for r in records if r.call == r.id}
    out = {i: {"call": c.name, "episodes": c.attrs.get("episodes"),
               "ms": _ms(c), "spans": {}} for i, c in calls.items()}
    for r in records:
        if r.call in out and r.id != r.call:
            spans = out[r.call]["spans"]
            spans[r.name] = spans.get(r.name, 0.0) + _ms(r)
    return [out[i] for i in sorted(out)]


def by_thread(records: Sequence, episodes: int) -> Dict[str, float]:
    """Milliseconds an episode in the outermost spans of each thread,
    named by those spans' names (the caller, the staging thread, autograd's
    device thread)."""
    roots: Dict[int, list] = {}
    for r in records:
        if r.parent is None:
            roots.setdefault(r.thread, []).append(r)
    return {"+".join(sorted({r.name for r in rs})):
            sum(_ms(r) for r in rs) / episodes for rs in roots.values()}


def backward_shapes(records: Sequence, episodes: int) -> Dict[str, list]:
    """``[calls an episode, ms a call]`` of each kernel backward by the
    shapes it replayed: the sizes a backward kernel has to serve."""
    groups: Dict[str, list] = {}
    for r in records:
        if r.name in ("otam.backward", "softdtw.backward"):
            key = r.name + " " + " ".join(
                f"{k}={'x'.join(map(str, v))}"
                for k, v in sorted(r.attrs.items()))
            groups.setdefault(key, []).append(_ms(r))
    return {k: [len(v) / episodes, sum(v) / len(v)]
            for k, v in sorted(groups.items())}


def stage_lead_ms(records: Sequence) -> List[float]:
    """For each batch an evaluation staged: milliseconds from the end of
    its ``eval.stage`` (the ``batch`` index in its call) to the start of
    the loop's ``eval.wait`` for it, the i-th of the call. Above 0 the
    staging thread was that far ahead; below, the loop waited."""
    stages: Dict[tuple, object] = {}
    waits: Dict[int, list] = {}
    for r in records:
        if r.name == "eval.stage":
            stages[r.call, r.attrs["batch"]] = r
        elif r.name == "eval.wait":
            waits.setdefault(r.call, []).append(r)
    out = []
    for call, ws in waits.items():
        for i, w in enumerate(sorted(ws, key=lambda r: r.start_ns)):
            st = stages.get((call, i))
            if st is not None:
                out.append((w.start_ns - st.end_ns) / 1e6)
    return out


COUNTERS = {
    "learner_stage_gb_per_s": lambda p: stage_gb_per_s(p.spans,
                                                       "learner.stage"),
    "eval_stage_gb_per_s": lambda p: stage_gb_per_s(p.spans, "eval.stage"),
    "tower_ms_per_frame": lambda p: tower_ms_per_frame(p.spans),
    "self_ms": lambda p: self_ms(p.spans, p.spans_episodes),
    "by_call": lambda p: by_call(p.spans),
    "by_thread_ms": lambda p: by_thread(p.spans, p.spans_episodes),
    "backward_shapes": lambda p: backward_shapes(p.spans,
                                                 p.spans_episodes),
    "stage_lead_ms": lambda p: stage_lead_ms(p.spans),
}


READINGS = {
    "tower_host_ms.eval": lambda p: host_ms(p.spans, "model.tower",
                                            p.spans_episodes),
    "head_host_ms.eval": lambda p: host_ms(p.spans, "model.head",
                                           p.spans_episodes),
    "tower_idle_share.eval": lambda p: idle_share(p.card_spans, p.card,
                                                  "model.tower"),
    "k1_backward_ms.train": lambda p: host_ms(p.spans, "otam.backward",
                                              p.spans_episodes),
    "stage_ms.train": lambda p: host_ms(p.spans, "learner.stage",
                                        p.spans_episodes),
    "k1_backward_idle_share.train": lambda p: idle_share(
        p.card_spans, p.card, "otam.backward"),
}


def measure(workload: str, seed: int, seconds: float,
            device: str = "cuda") -> dict:
    """A cell's set-up and untraced window, then both passes: what the
    module's command prints."""
    import torch

    from . import harness, inputs, program

    cell = harness.find_cell(workload)
    harness.check_layout(cell)
    t = cell.traffic
    ent = harness.entry(t["entry"])
    pool = inputs.make_episodes(
        t, len(inputs.class_names(cell.config, ent.SPLIT)), seed, device)
    learner = program.build(cell.config, seed, device)
    state = ent.setup(learner, pool, t)
    window = ent.window(learner, pool, t, seconds, state)
    # a segment as long as the passes, recording off: the like-for-like
    # base of the spans' cost (a short evaluation call stages its first
    # step with nothing to overlap, which the long window hides)
    plain = ent.segment(learner, pool, t, state)
    p = passes(ent, learner, pool, t, state)
    rate = window["episodes"] / window["wall_s"]
    plain_rate = plain["episodes"] / plain["wall_s"]
    out = {"workload": workload, "seed": seed,
           "device": (torch.cuda.get_device_name(0)
                      if torch.device(device).type == "cuda" else "cpu"),
           "window": {"episodes": window["episodes"],
                      "wall_s": window["wall_s"], "episodes_per_s": rate}}
    card_idle = p.card.window_s - p.card.busy_s()
    spans_rate = p.spans_episodes / p.spans_wall_s
    out.update({
        "spans": {"spans": {"episodes": p.spans_episodes,
                            "wall_s": p.spans_wall_s,
                            "episodes_per_s": spans_rate},
                  "spans+card": {"episodes": p.card_episodes,
                                 "wall_s": p.card_wall_s,
                                 "episodes_per_s":
                                     p.card_episodes / p.card_wall_s},
                  "dropped": p.dropped},
        "plain_segment": {"episodes": plain["episodes"],
                          "wall_s": plain["wall_s"],
                          "episodes_per_s": plain_rate},
        "tracing_cost": {"against_window": 1.0 - spans_rate / rate,
                         "against_plain_segment":
                             1.0 - spans_rate / plain_rate},
        "readings": {n: f(p) for n, f in READINGS.items()},
        "counters": {n: f(p) for n, f in COUNTERS.items()},
        "idle_spans": idle_spans(p.card_spans, p.card),
        "card_idle_s": card_idle,
        "card_window_s": p.card.window_s,
        "fetch_lag_ms": fetch_lags_ms(p.card_spans, p.card),
        "spans_host_ms": {n: host_ms(p.spans, n, p.spans_episodes)
                          for n in sorted({r.name for r in p.spans})}})
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.spans: needs a CUDA device", file=sys.stderr)
        return 3
    t0 = time.perf_counter()
    out = measure(args.workload, args.seed, args.seconds)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    # run.py's import sets the checkout's build caches, as a cell's run has
    import portbench.run  # noqa: F401,E402
    from portbench import spans  # noqa: E402
    sys.exit(spans.main())
