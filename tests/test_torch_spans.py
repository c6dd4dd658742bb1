"""The port's span recorder (``clipspm_tpu_torch/utils/metrics.py``) and the
spans the trainer, the evaluator, the model and K1's backward carry.

1. Recording off: nothing is recorded and ``span`` is the shared no-op;
   the stall timers still read the clock.
2. ``Learner.train_episodes`` and ``Learner.evaluate`` on clipspm at
   test-tiny with a chunked tower (several tower calls an episode, the
   train encode in remat chunks): the span tree, one call id a call,
   ``eval.stage`` on the staging thread with the batch it staged, one
   ``model.tower`` per backbone call, ``host_stall_seconds`` the sum of
   the ``eval.wait`` spans.
3. ``otam.backward`` under ``learner.backward``, with ``_OtamDistance`` run
   on the CPU (its kernel swapped for the plain version).
4. The clock: a span and a ``record_function`` range around one block
   agree, in a CPU ``torch.profiler`` trace, at both ends; a step of the
   wall clock moves no duration.
5. The cap, threads recording at once (below and past the cap), and
   ``Learner.run``'s profiled step.
"""

import collections
import json
import os
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from clipspm_tpu_torch.data.synthetic import SyntheticEpisodeSource
from clipspm_tpu_torch.data.transforms import TransformSpec
from clipspm_tpu_torch.models.fsar import build_model
from clipspm_tpu_torch.ops import otam_cuda
from clipspm_tpu_torch.ops.otam import otam_distance_plain
from clipspm_tpu_torch.train.learner import Learner
from clipspm_tpu_torch.utils import metrics
from clipspm_tpu_torch.utils.config import SPM_DEFAULT_PARAMS, ConfigNode
from clipspm_tpu_torch.utils.metrics import (NO_SPAN, recording, span,
                                             timed)
from clipspm_tpu_torch.weights import random_init_

# 2-way 1-shot 1-query, T=3, 32-px crops of 40-px frames: 12 frames an
# episode through the tower 5 at a time (3 calls; in training 3 remat
# chunks, each run again in the backward)
WAY, SHOT, QUERIES, SEQ_LEN, PX, IMG, CLASSES = 2, 1, 1, 3, 40, 32, 4
CHUNK = 5


def _learner(train_source=None) -> Learner:
    cfg = ConfigNode({
        "MODEL": {"NAME": "clipspm", "BACKBONE": "test-tiny", "SEED": 0,
                  "ENCODE_CHUNK": CHUNK, "TRAIN_ENCODE_CHUNK": CHUNK},
        "TRAIN": {"WAY": WAY, "SHOT": SHOT, "QUERY_PER_CLASS": QUERIES,
                  "TASKS_PER_BATCH": 2, "TRAIN_EPISODES": 6, "VAL_FREQ": 100,
                  "PRINT_FREQ": 2},
        "TEST": {"QUERY_PER_CLASS": QUERIES, "TEST_EPISODES": 2},
        "DATA": {"DATASET": "generic", "IMG_SIZE": IMG, "SEQ_LEN": SEQ_LEN},
        "SOLVER": {"LR": 1e-3, "LR_SCH": 10 ** 6, "OPTIM_METHOD": "adam",
                   "WEIGHT_DECAY": 1e-4, "MOMENTUM": 0.9},
        "USE_AMP": False,
        "params": SPM_DEFAULT_PARAMS["hmdb"],
    })
    model = random_init_(build_model(cfg), torch.Generator().manual_seed(2))
    text = torch.randn(CLASSES, model.arch.embed_dim,
                       generator=torch.Generator().manual_seed(3))
    return Learner(cfg, model, text, text, torch.device("cpu"),
                   transform=TransformSpec(img_size=IMG, resize_to=PX),
                   train_source=train_source, log_fn=lambda *_: None)


def _source(seed=1):
    return SyntheticEpisodeSource(way=WAY, shot=SHOT, queries=QUERIES,
                                  seq_len=SEQ_LEN, img_size=PX,
                                  num_classes=CLASSES, seed=seed)


class _Calls:
    """Counts the calls of a module's forward (remat recomputes included)."""

    def __init__(self, module):
        self.n = 0
        self._h = module.register_forward_pre_hook(self._count)

    def _count(self, *_):
        self.n += 1

    def close(self):
        self._h.remove()


def _by_name(records):
    out = collections.defaultdict(list)
    for r in records:
        out[r.name].append(r)
    return out


def _never():
    raise AssertionError("a count taken with recording off")


def test_recording_off_records_nothing():
    learner = _learner()
    src = _source()
    assert span("learner.step", call=True, episodes=2) is NO_SPAN
    with span("x", frames=_never) as sp:
        sp.set(bytes=_never)
    with timed("eval.wait") as wait:
        sum(range(1000))
    assert wait.seconds > 0
    learner.train_episodes([src.sample() for _ in range(2)])
    learner.evaluate(2, source=iter(src.sample, None), batch_size=2)
    with recording() as records:
        pass
    assert records == [] and records.dropped == 0


def test_train_episodes_span_tree():
    learner = _learner()
    src = _source()
    episodes = [src.sample() for _ in range(2)]
    calls = _Calls(learner.model.backbone)
    try:
        with recording() as records:
            learner.train_episodes(episodes)
    finally:
        calls.close()
    by = _by_name(records)
    (step,) = by["learner.step"]
    assert step.parent is None and step.call == step.id
    assert step.attrs == {"episodes": 2}
    assert {r.call for r in records} == {step.id}
    assert {r.thread for r in records} == {threading.get_ident()}
    ids = {r.id: r for r in records}
    assert len(ids) == len(records)
    for name in ("learner.stage", "learner.forward", "learner.backward",
                 "learner.optimizer", "learner.fetch"):
        assert by[name] and all(r.parent == step.id for r in by[name]), name
    (stage,) = by["learner.stage"]
    assert stage.attrs["bytes"] == sum(ep.nbytes() for ep in episodes)
    assert [r.attrs for r in by["learner.forward"]] == [{}, {}]
    forwards = {r.id for r in by["learner.forward"]}
    backwards = {r.id for r in by["learner.backward"]}
    assert len(by["learner.transform"]) == 2 and all(
        r.parent in forwards for r in by["learner.transform"])
    assert len(by["model.head"]) == 2 and all(
        r.parent in forwards for r in by["model.head"])
    # one span a backbone call: 3 remat chunks an episode in the forward,
    # each run again under the backward
    towers = by["model.tower"]
    assert len(towers) == calls.n == 2 * 2 * 3
    assert sum(r.attrs["frames"] for r in towers) == 2 * 2 * 3 * CHUNK
    assert sum(r.parent in forwards for r in towers) == 6
    assert sum(r.parent in backwards for r in towers) == 6
    for r in records:
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = ids[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    # the fetch is the call's last span
    assert by["learner.fetch"][0].start_ns >= max(
        r.end_ns for r in by["learner.optimizer"])


def test_evaluate_span_tree_and_host_stall():
    learner = _learner()
    src = _source()
    episodes = [src.sample() for _ in range(5)]
    calls = _Calls(learner.model.backbone)
    try:
        with recording() as records:
            res = learner.evaluate(5, source=iter(episodes), batch_size=2)
    finally:
        calls.close()
    by = _by_name(records)
    (ev,) = by["learner.evaluate"]
    assert ev.parent is None and ev.call == ev.id
    assert ev.attrs == {"episodes": 5}
    assert {r.call for r in records} == {ev.id}
    me = threading.get_ident()
    stages = sorted(by["eval.stage"], key=lambda r: r.attrs["batch"])
    assert [r.attrs["batch"] for r in stages] == [0, 1, 2]
    assert me not in {r.thread for r in stages}
    assert all(r.parent is None for r in stages)
    assert [r.attrs["bytes"] for r in stages] == [
        sum(ep.nbytes() for ep in episodes[i:i + 2]) for i in (0, 2, 4)]
    for name, n in (("eval.wait", 3), ("eval.harvest", 3),
                    ("learner.forward", 5)):
        assert len(by[name]) == n, name
        assert all(r.parent == ev.id and r.thread == me for r in by[name])
    assert all(r.attrs == {} for r in by["learner.forward"])
    towers = by["model.tower"]
    assert len(towers) == calls.n == 5 * 3
    assert [r.attrs["frames"] for r in towers] == [5, 5, 2] * 5
    assert res["host_stall_seconds"] == pytest.approx(sum(
        (r.end_ns - r.start_ns) / 1e9 for r in by["eval.wait"]), rel=1e-12)


def test_otam_backward_is_under_the_backward(monkeypatch):
    def through_k1_function(support, query, lbda, bidirectional, epsilon):
        return otam_cuda._OtamDistance.apply(
            support.float().contiguous(), query.float().contiguous(),
            float(lbda), bool(bidirectional), float(epsilon))

    monkeypatch.setattr(otam_cuda, "otam_distance", through_k1_function)
    monkeypatch.setattr(otam_cuda, "otam_distance_cuda", otam_distance_plain)
    learner = _learner()
    src = _source()
    with recording() as records:
        learner.train_episodes([src.sample() for _ in range(2)])
    by = _by_name(records)
    backwards = {r.id for r in by["learner.backward"]}
    replays = by["otam.backward"]
    # clipspm's head: class distances, then the two task distances
    assert len(replays) == 2 * 3
    assert all(r.parent in backwards for r in replays)
    D = learner.model.arch.embed_dim
    for r in replays:
        assert r.attrs["support"][1:] == (SEQ_LEN, D)
        assert r.attrs["query"][1:] == (SEQ_LEN, D)


def test_span_clock_is_the_profilers():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recording() as records:
            with record_function("clock.reference"), span("clock.span"):
                torch.randn(256, 256) @ torch.randn(256, 256)
    (rec,) = records
    (ref,) = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "clock.reference"]
    start, end = ref.start_ns(), ref.start_ns() + ref.duration_ns()
    assert abs(rec.start_ns - start) < 200_000
    assert abs(rec.end_ns - end) < 200_000
    # the span's own range is in the trace under its name
    assert any(e.name() == "clock.span"
               for e in prof.profiler.kineto_results.events())


def test_a_wall_clock_step_moves_no_duration(monkeypatch):
    """The wall clock stepped back an hour inside a span: the record keeps
    its start on the wall clock and a duration from the monotonic one."""
    wall = iter([10 ** 18, 10 ** 18 - 3600 * 10 ** 9])
    monkeypatch.setattr(metrics.time, "time_ns", lambda: next(wall))
    with recording() as records:
        with timed("eval.wait") as wait:
            sum(range(1000))
    (rec,) = records
    assert rec.start_ns == 10 ** 18
    assert 0 < rec.end_ns - rec.start_ns == round(wait.seconds * 1e9)


def test_records_past_the_cap_are_counted(monkeypatch):
    monkeypatch.setattr(metrics, "MAX_SPANS", 3)
    with recording() as records:
        for _ in range(5):
            with span("s"):
                pass
    assert len(records) == 3 and records.dropped == 2


def test_threads_record_at_once():
    """Eight threads each open a call and nested spans with a short switch
    interval: no record is lost, ids are unique, and each span's parent
    and call are its own thread's."""
    threads, depth = 8, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(depth):
            with span("outer"):
                with span("inner"):
                    pass

    try:
        with recording() as records:
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    assert len(records) == threads * depth * 2
    ids = {r.id: r for r in records}
    assert len(ids) == len(records)
    for r in records:
        if r.name == "inner":
            assert ids[r.parent].name == "outer"
            assert ids[r.parent].thread == r.thread
        else:
            assert r.parent is None


def test_threads_past_the_cap_lose_no_count(monkeypatch):
    """Eight threads close spans past a small cap at once: every span is
    either kept or counted as dropped."""
    monkeypatch.setattr(metrics, "MAX_SPANS", 100)
    threads, depth = 8, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(depth):
            with span("s"):
                pass

    try:
        with recording() as records:
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    assert len(records) == 100
    assert len(records) + records.dropped == threads * depth


def test_run_profiles_one_step_with_the_spans(tmp_path, monkeypatch):
    monkeypatch.setenv("CLIPSPM_PROFILE_DIR", str(tmp_path))
    learner = _learner(train_source=_source())
    with recording() as records:
        learner.run(train_episodes=4, val_freq=100, print_freq=2)
    with open(os.path.join(tmp_path, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"learner.forward", "learner.backward", "model.tower",
            "learner.optimizer"} <= names
    # the loop's two waits on the staging thread, timed and recorded
    assert len([r for r in records if r.name == "learner.wait"]) == 2
