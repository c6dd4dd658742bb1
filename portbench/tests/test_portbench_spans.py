"""``spans.py``: the six span readings, the counters and ``idle_spans`` on
hand-built passes, where every number is known; the two passes over the
port at its test sizes on the CPU."""

import pytest

from conftest import tiny_cell
from portbench import harness, inputs, program, spans
from portbench.trace import Trace

from clipspm_tpu_torch.utils.metrics import SpanRecord

MS = 1_000_000


def _rec(name, i, start_ms, end_ms, parent=None, thread=1):
    return SpanRecord(name, i, parent, 1, thread, start_ms * MS, end_ms * MS,
                      {})


def _trace(busy_ms, window_ms=(0, 100)):
    """A card trace whose events are ``busy_ms`` (start, end) pairs."""
    device = [("k", s * MS, e * MS, 0) for s, e in busy_ms]
    return Trace(device=device, cpu=[],
                 window=(window_ms[0] * MS, window_ms[1] * MS))


# a step [0, 100] ms: a tower [10, 40] with a nested call [20, 30], a head
# [50, 60], K1's backward [70, 90] on another thread, which a stage
# [80, 85] on a third overlaps; the card busy at [0, 10], [25, 35],
# [55, 75] and [88, 95]
RECORDS = [
    _rec("learner.step", 1, 0, 100),
    _rec("model.tower", 2, 10, 40, parent=1),
    _rec("model.tower", 3, 20, 30, parent=2),
    _rec("model.head", 4, 50, 60, parent=1),
    _rec("otam.backward", 5, 70, 90, thread=2),
    _rec("learner.stage", 6, 80, 85, thread=3),
]
TRACE = _trace([(0, 10), (25, 35), (55, 75), (88, 95)])
# gaps: [10, 25] mid 17.5 tower; [35, 55] mid 45 step; [75, 88] mid 81.5
# stage (it started after otam.backward); [95, 100] mid 97.5 step
IDLE = {"model.tower": 0.015, "learner.step": 0.025, "learner.stage": 0.013}


def test_idle_goes_to_the_innermost_open_span():
    by = spans.idle_by_span(RECORDS, TRACE)
    assert by == pytest.approx(IDLE)
    assert sum(by.values()) == pytest.approx(TRACE.window_s - TRACE.busy_s())


def test_idle_spans_top_rest_and_outside():
    # the last gap, [95, 120], has its middle past the step's end
    trace = _trace([(0, 10), (25, 35), (55, 75), (88, 95)], (0, 120))
    out = spans.idle_spans(RECORDS, trace)
    assert out[-1] == [spans.OUTSIDE, pytest.approx(0.025)]
    assert out[:-1] == [["learner.step", pytest.approx(0.020)],
                        ["model.tower", pytest.approx(0.015)],
                        ["learner.stage", pytest.approx(0.013)]]
    top1 = spans.idle_spans(RECORDS, trace, top=1)
    assert top1 == [["learner.step", pytest.approx(0.020)],
                    ["other spans", pytest.approx(0.028)],
                    [spans.OUTSIDE, pytest.approx(0.025)]]
    assert sum(v for _, v in top1) == pytest.approx(
        trace.window_s - trace.busy_s())


def test_the_six_readings():
    p = spans.SpanPasses(RECORDS, 2, 1.0, RECORDS, 2, 1.0, TRACE, 0)
    idle = sum(IDLE.values())
    want = {"tower_host_ms.eval": (30 + 10) / 2,
            "head_host_ms.eval": 10 / 2,
            "tower_idle_share.eval": 100 * 0.015 / idle,
            "k1_backward_ms.train": 20 / 2,
            "stage_ms.train": 5 / 2,
            "k1_backward_idle_share.train": 0.0}
    got = {n: f(p) for n, f in spans.READINGS.items()}
    assert got == pytest.approx(want)


def test_a_reading_without_its_span_is_none():
    step = [_rec("learner.step", 1, 0, 100)]
    p = spans.SpanPasses(step, 2, 1.0, step, 2, 1.0, TRACE, 0)
    assert all(f(p) is None for f in spans.READINGS.values())


# one evaluation call of 4 episodes [0, 100] ms on the caller (thread 1):
# two batches staged on thread 2 ([0, 10]: 20 MB, [12, 22]: 30 MB), the
# loop's waits for them [1, 10] and [50, 51], a forward [10, 40] with a
# tower call of 40 frames [12, 32] inside, and two K1 backwards on
# thread 3 ([60, 62], [70, 74])
SHAPE = {"query": (5, 8, 1024), "support": (5, 8, 1024)}
COUNTED = [
    SpanRecord("learner.evaluate", 1, None, 1, 1, 0, 100 * MS,
               {"episodes": 4}),
    SpanRecord("eval.stage", 2, None, 1, 2, 0, 10 * MS,
               {"batch": 0, "bytes": 20_000_000}),
    SpanRecord("eval.wait", 3, 1, 1, 1, 1 * MS, 10 * MS, {}),
    SpanRecord("eval.stage", 4, None, 1, 2, 12 * MS, 22 * MS,
               {"batch": 1, "bytes": 30_000_000}),
    SpanRecord("model.tower", 6, 5, 1, 1, 12 * MS, 32 * MS, {"frames": 40}),
    SpanRecord("learner.forward", 5, 1, 1, 1, 10 * MS, 40 * MS, {}),
    SpanRecord("eval.wait", 7, 1, 1, 1, 50 * MS, 51 * MS, {}),
    SpanRecord("otam.backward", 8, None, 1, 3, 60 * MS, 62 * MS, SHAPE),
    SpanRecord("otam.backward", 9, None, 1, 3, 70 * MS, 74 * MS, SHAPE),
]


def test_the_counters():
    p = spans.SpanPasses(COUNTED, 4, 1.0, COUNTED, 4, 1.0, TRACE, 0)
    got = {n: f(p) for n, f in spans.COUNTERS.items()}
    assert got == {
        "learner_stage_gb_per_s": None,
        "eval_stage_gb_per_s": pytest.approx(50e6 / 20e6),
        "tower_ms_per_frame": pytest.approx(20 / 40),
        "self_ms": pytest.approx({
            "learner.evaluate": (100 - 30 - 9 - 1) / 4,
            "eval.stage": 20 / 4, "eval.wait": 10 / 4,
            "learner.forward": (30 - 20) / 4, "model.tower": 20 / 4,
            "otam.backward": 6 / 4}),
        "by_call": [{"call": "learner.evaluate", "episodes": 4,
                     "ms": pytest.approx(100),
                     "spans": pytest.approx({
                         "eval.stage": 20, "eval.wait": 10,
                         "learner.forward": 30, "model.tower": 20,
                         "otam.backward": 6})}],
        "by_thread_ms": pytest.approx({"learner.evaluate": 25,
                                       "eval.stage": 5,
                                       "otam.backward": 1.5}),
        "backward_shapes": {
            "otam.backward query=5x8x1024 support=5x8x1024":
                pytest.approx([0.5, 3.0])},
        "stage_lead_ms": pytest.approx([1 - 10, 50 - 22])}
    # the own times and the outermost spans' add up to the same time
    assert sum(got["self_ms"].values()) == pytest.approx(
        sum(got["by_thread_ms"].values()))


def test_fetch_lag_reads_from_the_last_card_event():
    records = [_rec("learner.fetch", 7, 92, 96), _rec("eval.harvest", 8, 5,
                                                      9)]
    lags = spans.fetch_lags_ms(records, TRACE)
    assert lags == {"learner.fetch": [pytest.approx(1.0)]}


# on the CPU K1's Function is not on the path (a CPU tensor takes the plain
# version), so neither K1 reading has a span to read there
@pytest.mark.parametrize("workload,backbone,calls,names,counters", [
    ("rn50-eval", "test-tiny-rn", ("learner.evaluate", 1),
     ("tower_host_ms.eval", "head_host_ms.eval", "tower_idle_share.eval"),
     ("eval_stage_gb_per_s", "tower_ms_per_frame")),
    ("rn50-train", "test-tiny-rn", ("learner.step", 1),
     ("stage_ms.train",), ("learner_stage_gb_per_s", "tower_ms_per_frame"))])
def test_passes_over_the_port_on_the_cpu(workload, backbone, calls, names,
                                         counters):
    cell = tiny_cell(workload, backbone)
    t = cell.traffic
    ent = harness.entry(t["entry"])
    pool = inputs.make_episodes(
        t, len(inputs.class_names(cell.config, ent.SPLIT)), 5, "cpu")
    learner = program.build(cell.config, 5, "cpu")
    state = ent.setup(learner, pool, t)
    p = spans.passes(ent, learner, pool, t, state)
    episodes = t["episodes_per_step"] * t["trace_steps"]
    assert p.spans_episodes == p.card_episodes == episodes
    assert p.dropped == 0
    name, n = calls
    for records in (p.spans, p.card_spans):
        assert sum(r.name == name for r in records) == n
    got = {n: spans.READINGS[n](p) for n in names}
    assert all(v is not None and v >= 0 for v in got.values()), got
    got = {n: spans.COUNTERS[n](p) for n in counters}
    assert all(v is not None and v > 0 for v in got.values()), got
    (call,) = spans.COUNTERS["by_call"](p)
    assert (call["call"], call["episodes"]) == (name, episodes // n)
    if workload.endswith("-eval"):
        # a lead for every batch the call staged
        assert len(spans.COUNTERS["stage_lead_ms"](p)) == t["trace_steps"]
    assert sum(v for _, v in spans.idle_spans(p.card_spans, p.card)) == \
        pytest.approx(p.card.window_s - p.card.busy_s())
