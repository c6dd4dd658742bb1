"""Faults of the port, repaired, each held by a CPU test that fails on the
code before the repair:

- a checkpoint whose generator states come from another kind of device (a
  CUDA state is 16 bytes) restores on the CPU (since the episode count
  seeds every draw, no generator state is saved or restored: a restored
  learner continues as the saved one does);
- ``SOLVER.ACCUM_DTYPE: bfloat16`` sums the episodes' gradients in bf16 (as
  the JAX step does) and any value but float32/bfloat16 raises;
- ``DEVICE.NUM_CHIPS`` / ``DEVICE.TP`` below 1 raise ``ValueError``, as
  does a grid of more ranks (``NUM_CHIPS x TP``) than visible CUDA devices;
  on the CPU any grid builds.

(The cached evaluator's evaluation-mode loss is held in
``tests/test_torch_eval.py``.)
"""

import numpy as np
import pytest
import torch

from clipspm_tpu.utils.config import SPM_DEFAULT_PARAMS
from clipspm_tpu_torch.data import transforms as ttf
from clipspm_tpu_torch.data.episode import Episode
from clipspm_tpu_torch.models.backbones.clip import CLIP_ARCHS
from clipspm_tpu_torch.models.fsar import CLIPSPMModel
from clipspm_tpu_torch.train import learner as tlearner_mod
from clipspm_tpu_torch.train.checkpoint import CheckpointManager
from clipspm_tpu_torch.train.learner import Learner
from clipspm_tpu_torch.train.setup import check_num_chips
from clipspm_tpu_torch.utils.config import ConfigNode
from clipspm_tpu_torch.weights import random_init_

torch.set_num_threads(2)

WAY, SHOT, QUERIES, T, PX, CLASSES = 2, 1, 2, 4, 40, 8
LR = 1e-3


def _cfg(backbone="test-tiny-rn", accum=None):
    solver = {"LR": LR, "LR_SCH": 2, "OPTIM_METHOD": "adam",
              "WEIGHT_DECAY": 5e-5, "MOMENTUM": 0.9}
    if accum is not None:
        solver["ACCUM_DTYPE"] = accum
    return ConfigNode({
        "MODEL": {"NAME": "clipspm", "BACKBONE": backbone, "SEED": 1},
        "TRAIN": {"WAY": WAY, "SHOT": SHOT, "QUERY_PER_CLASS": QUERIES,
                  "TASKS_PER_BATCH": 4},
        "DATA": {"DATASET": "hmdb", "IMG_SIZE": 32, "SEQ_LEN": T},
        "SOLVER": solver, "params": SPM_DEFAULT_PARAMS["hmdb"]})


def _learner(cfg, seed=0, log_fn=lambda *_: None):
    arch = CLIP_ARCHS[cfg.MODEL.BACKBONE]
    model = CLIPSPMModel(arch=arch, way=WAY, shot=SHOT,
                         spm=dict(cfg.params))
    random_init_(model, torch.Generator().manual_seed(seed))
    text = torch.randn(CLASSES, arch.embed_dim,
                       generator=torch.Generator().manual_seed(seed + 1))
    return Learner(cfg, model, text, text, torch.device("cpu"),
                   transform=ttf.TransformSpec(img_size=32, resize_to=PX),
                   log_fn=log_fn)


def _episode(rng):
    classes = rng.choice(CLASSES, WAY, replace=False).astype(np.int32)
    sl = np.arange(WAY, dtype=np.int32)
    tl = rng.permutation(np.repeat(np.arange(WAY), QUERIES)).astype(np.int32)
    return Episode(
        support_images=rng.integers(0, 256, (WAY, T, PX, PX, 3), np.uint8),
        support_labels=sl,
        target_images=rng.integers(0, 256, (WAY * QUERIES, T, PX, PX, 3),
                                   np.uint8),
        target_labels=tl, real_support_labels=classes[sl],
        real_target_labels=classes[tl], batch_class_list=classes)


# -- checkpoints across devices ----------------------------------------------

def test_a_card_checkpoint_restores_on_the_cpu(tmp_path):
    """Generator states as the card wrote them (16 bytes of CUDA Philox
    seed and offset), which do not fit the CPU's generators: everything
    else is restored and the states are ignored, because the episode count
    alone seeds every later draw. Two learners built from other weights
    restore it and continue exactly as the saved one does."""
    rng = np.random.default_rng(0)
    a = _learner(_cfg())
    for _ in range(2):          # Adam state, the LR milestone passed
        a.train_episodes([_episode(rng), _episode(rng)])
    payload = a.state_dict()
    for key in ("transform_rng", "dropout_rng"):
        payload[key] = torch.arange(16, dtype=torch.uint8)
    payload["meta"] = {"iteration": a.episode, "acc": 0.0}
    path = tmp_path / "checkpoint_best"
    path.mkdir()
    torch.save(payload, str(path / "checkpoint.pt"))

    nxt = [_episode(rng), _episode(rng)]
    restored = []
    for seed in (9, 10):
        logs = []
        b = _learner(_cfg(), seed=seed, log_fn=logs.append)
        CheckpointManager(str(tmp_path)).restore("best", b)
        mine = b.state_dict()
        assert "transform_rng" not in mine and "dropout_rng" not in mine
        for part in ("model", "optimizer", "scheduler"):
            torch.testing.assert_close(mine[part], payload[part], rtol=0,
                                       atol=0, msg=part)
        assert b.episode == a.episode == 4
        assert b.optimizer.param_groups[0]["lr"] == pytest.approx(LR / 10)
        assert logs == []
        restored.append((b.train_episodes(nxt), b.model.state_dict()))
    want = a.train_episodes(nxt)
    for metrics, state in restored:
        assert metrics == want
        for k, v in a.model.state_dict().items():
            assert torch.equal(state[k], v), k


# -- SOLVER.ACCUM_DTYPE -------------------------------------------------------

def _eval_transform(images, *, train, gen=None, **kw):
    return ttf.episode_device_transform(images, train=False, **kw)


def test_bf16_accumulation_sums_in_bf16_and_rejects_garbage(monkeypatch):
    """Mirrors ``tests/test_accum_dtype.py``: the same episodes from the
    same weights (test-tiny) under float32 and bfloat16 give the same loss,
    parameters within Adam's 2 * LR ceiling and far closer on average; and
    the optimizer's gradient is exactly the bf16 running sum of the
    episodes' fp32 gradients (dropout off, center crops)."""
    monkeypatch.setattr(tlearner_mod, "episode_device_transform",
                        _eval_transform)
    rng = np.random.default_rng(3)
    eps = [_episode(rng) for _ in range(4)]
    learners = {}
    for accum in ("float32", "bfloat16"):
        lrn = _learner(_cfg("test-tiny", accum))
        for m in lrn.model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        learners[accum] = (lrn, lrn.train_episodes(eps))
    (lf, mf), (lb, mb) = learners["float32"], learners["bfloat16"]
    np.testing.assert_allclose(mf["loss"], mb["loss"], rtol=1e-5)
    for (name, pa), pb in zip(lf.model.named_parameters(),
                              lb.model.parameters()):
        d = (pa - pb).abs()
        assert float(d.max()) <= 2.0 * LR + 1e-6, name
        assert float(d.mean()) < 0.2 * LR, name

    # the bf16 sum, replayed from each episode's fp32 gradient
    ref = _learner(_cfg("test-tiny"))
    for m in ref.model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    ref.model.train()
    batch = ref._ready(*ref._to_device(eps))
    total = None
    for e in range(len(eps)):
        ref.model.zero_grad(set_to_none=True)
        ref._episode_loss(batch[e])[0].backward()
        g = [torch.zeros_like(p, dtype=torch.bfloat16) if p.grad is None
             else p.grad.to(torch.bfloat16) for p in ref.model.parameters()]
        total = g if total is None else [x + y for x, y in zip(total, g)]
    for (name, p), want in zip(lb.model.named_parameters(), total):
        assert torch.equal(p.grad, want.float()), name

    with pytest.raises(ValueError, match="ACCUM_DTYPE"):
        _learner(_cfg(accum="float16"))


# -- DEVICE.NUM_CHIPS / DEVICE.TP --------------------------------------------

@pytest.mark.parametrize("device,error", [
    ({"NUM_CHIPS": 0, "TP": 1}, ValueError),
    ({"NUM_CHIPS": 1, "TP": 0}, ValueError),
    ({"NUM_CHIPS": -2, "TP": 1}, ValueError),
    ({"NUM_CHIPS": 1, "TP": 2}, ValueError),     # one CUDA device visible
    ({"NUM_CHIPS": 2, "TP": 1}, ValueError),
    ({"NUM_CHIPS": 2, "TP": 2}, ValueError),
    ({"NUM_CHIPS": 1, "TP": 1}, None),
    ({}, None),
])
def test_device_counts_are_checked(device, error, monkeypatch):
    """The JAX ``build_device_mesh`` checks: a grid of more ranks than
    visible CUDA devices raises its ``ValueError`` (here one device is made
    visible); on the CPU any grid runs."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cfg = ConfigNode({"DEVICE": device, "TRAIN": {"TASKS_PER_BATCH": 4},
                      "TEST": {"ONLY_TEST": False}})
    if device.get("NUM_CHIPS", 1) * device.get("TP", 1) > 1:
        check_num_chips(cfg, "cpu")
    if error is None:
        check_num_chips(cfg, "cuda")
        return
    with pytest.raises(error, match="DEVICE"):
        check_num_chips(cfg, "cuda")
