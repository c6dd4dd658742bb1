"""The port's checkpoints and metrics: ``CheckpointManager`` round trip and
refusals, and ``utils/metrics.py`` against the JAX package's writer and
formatter."""

import json
import os

import numpy as np
import pytest
import torch

from clipspm_tpu.utils import metrics as jmetrics
from clipspm_tpu.utils.config import SPM_DEFAULT_PARAMS
from clipspm_tpu_torch.data.episode import Episode
from clipspm_tpu_torch.models.backbones.clip import CLIP_ARCHS
from clipspm_tpu_torch.models.fsar import CLIPSPMModel
from clipspm_tpu_torch.train.checkpoint import CheckpointManager
from clipspm_tpu_torch.train.learner import Learner
from clipspm_tpu_torch.utils import metrics as tmetrics
from clipspm_tpu_torch.utils.config import ConfigNode
from clipspm_tpu_torch.weights import random_init_

torch.set_num_threads(2)

WAY, SHOT, QUERIES, T, PX, CLASSES = 2, 1, 1, 4, 40, 4


def _cfg(spm_key="hmdb"):
    return ConfigNode({
        "MODEL": {"NAME": "clipspm", "BACKBONE": "test-tiny-rn", "SEED": 1},
        "TRAIN": {"WAY": WAY, "SHOT": SHOT, "QUERY_PER_CLASS": QUERIES,
                  "TASKS_PER_BATCH": 2},
        "DATA": {"DATASET": "hmdb", "IMG_SIZE": 32, "SEQ_LEN": T},
        "SOLVER": {"LR": 1e-3, "LR_SCH": 2, "OPTIM_METHOD": "adam",
                   "WEIGHT_DECAY": 1e-4, "MOMENTUM": 0.9},
        "params": SPM_DEFAULT_PARAMS[spm_key]})


def _learner(seed=0, spm_key="hmdb"):
    cfg = _cfg(spm_key)
    model = CLIPSPMModel(arch=CLIP_ARCHS["test-tiny-rn"], way=WAY, shot=SHOT,
                         spm=dict(cfg.params))
    random_init_(model, torch.Generator().manual_seed(seed))
    text = torch.randn(CLASSES, 64, generator=torch.Generator().manual_seed(
        seed + 1))
    return Learner(cfg, model, text, -text, torch.device("cpu"),
                   log_fn=lambda *_: None)


def _episode(rng):
    classes = rng.choice(CLASSES, WAY, replace=False).astype(np.int32)
    lab = np.arange(WAY, dtype=np.int32)
    return Episode(
        support_images=rng.integers(0, 256, (WAY, T, PX, PX, 3), np.uint8),
        support_labels=lab,
        target_images=rng.integers(0, 256, (WAY, T, PX, PX, 3), np.uint8),
        target_labels=lab, real_support_labels=classes[lab],
        real_target_labels=classes[lab], batch_class_list=classes)


def _equal(a, b, path="") -> None:
    """Bit-equal nested state (tensors, numbers, containers)."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_round_trip_restores_every_part_bit_for_bit(tmp_path):
    rng = np.random.default_rng(0)
    a = _learner()
    for _ in range(2):      # two steps: Adam state, the LR milestone passed
        a.train_episodes([_episode(rng), _episode(rng)])
    manager = CheckpointManager(str(tmp_path))
    assert not manager.exists("best")
    path = manager.save(a, "best", best_acc=42.5)
    assert path == os.path.join(str(tmp_path), "checkpoint_best")
    assert manager.exists("best")

    b = _learner(seed=9)
    payload = manager.restore("best", b)
    assert payload["meta"] == {"iteration": 4, "acc": 42.5}
    _equal(a.state_dict(), b.state_dict())
    assert b.episode == 4
    assert b.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4)
    # both continue identically: the same next step, drawn from the same
    # transform generator and, from the restored state, the same dropout
    # generator (on the CPU one global generator that both learners share)
    nxt = [_episode(rng), _episode(rng)]
    dropout = torch.get_rng_state()
    ma = a.train_episodes(nxt)
    torch.set_rng_state(dropout)
    assert ma == b.train_episodes(nxt)
    _equal(a.model.state_dict(), b.model.state_dict())


def test_save_keeps_the_directory_and_replaces_the_payload(tmp_path):
    a = _learner()
    manager = CheckpointManager(str(tmp_path))
    path = manager.save(a, "iter_2")
    keep = os.path.join(path, "notes.txt")
    with open(keep, "w") as f:
        f.write("kept")
    a.episode = 7
    manager.save(a, "iter_2", best_acc=1.0)
    assert os.path.isfile(keep)
    assert sorted(os.listdir(path)) == ["checkpoint.pt", "notes.txt"]
    b = _learner()
    assert CheckpointManager(str(tmp_path)).restore("iter_2", b)["meta"] \
        == {"iteration": 7, "acc": 1.0}


def test_a_file_path_is_refused(tmp_path):
    f = tmp_path / "model.pt"
    torch.save({"x": torch.zeros(1)}, str(f))
    with pytest.raises(ValueError, match="is a FILE"):
        CheckpointManager(str(tmp_path)).restore_path(str(f), _learner())


def test_a_mismatched_tree_is_refused_with_the_advice(tmp_path):
    manager = CheckpointManager(str(tmp_path))
    manager.save(_learner(spm_key="hmdb"), "best")
    other = _learner(spm_key="ssv2")     # other gate widths
    before = {k: v.clone() for k, v in other.model.state_dict().items()}
    with pytest.raises(ValueError, match="does not match the current "
                       "model's parameter tree"):
        manager.restore("best", other)
    _equal(before, other.model.state_dict())


# -- metrics ------------------------------------------------------------------

def test_metrics_jsonl_matches_the_jax_writer(tmp_path):
    rows = []
    for mod, name in ((tmetrics, "port"), (jmetrics, "jax")):
        path = os.path.join(str(tmp_path), name, "metrics.jsonl")
        w = mod.MetricsWriter(path)
        w.scalar("loss/Train_loss[it]", 0.5, 16)
        w.scalars({"acc/Test_acc": 20.0, "acc/Best_acc": 21.5}, 2)
        w.close()
        with open(path) as f:
            rows.append([json.loads(line) for line in f])
    strip = lambda rs: [{k: r[k] for k in ("step", "tag", "value")}  # noqa
                        for r in rs]
    assert strip(rows[0]) == strip(rows[1])
    assert all(set(r) == {"step", "tag", "value", "ts"} for r in rows[0])


def test_test_accuracies_and_rss_match_the_jax_helpers():
    res = {"hmdb": {"accuracy": 75.25, "confidence": 0.43}}
    assert tmetrics.TestAccuracies(["hmdb", "ucf"]).format(res) == \
        jmetrics.TestAccuracies(["hmdb", "ucf"]).format(res)
    assert tmetrics.host_rss_gb() > 0.0


def test_profile_trace_writes_a_trace(tmp_path):
    with tmetrics.profile_trace(str(tmp_path)):
        torch.ones(8).sum()
    with open(os.path.join(str(tmp_path), "trace.json")) as f:
        assert "traceEvents" in json.load(f)
    with tmetrics.profile_trace(None):     # a no-op without a directory
        pass
