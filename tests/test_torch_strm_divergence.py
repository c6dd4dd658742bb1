"""strm from random weights diverges under its shipped SGD in the JAX
package as in the port: a witness outside the port for ``chip_smoke.py``'s
strm-train, whose step losses run from ~1.9e3 to ~2e6 on the card.

``configs/strm/ucf.yaml`` at its widths (the ResNet-50 trunk, 2048-wide
features, TRANS_LINEAR_OUT_DIM 1152, TEMP_SET [2], 5-way 1-shot 4-query,
T=8, SGD at LR 1e-4 with momentum 0.9), cut to 32-px crops and one
episode a step, at fp32 on the CPU, dropout off and the eval transform on
both sides: the JAX ``Learner`` from the JAX package's own initialisation
(``init_model_variables`` at the config's seed), and the port's
``Learner`` from the same weights (``weights.model_state_dict``), two
steps each over the same seeded noise episodes. Measured: JAX 1935.5 then
2.5e5, the port 1936.3 then 3.4e5 (the second step, after one update with
gradients of that size, is chaotic in both).
"""

import os

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from clipspm_tpu.data import transforms as jtf
from clipspm_tpu.data.episode import Episode as JEpisode
from clipspm_tpu.models.fsar import build_model as jax_build_model
from clipspm_tpu.train import learner as jlearner_mod
from clipspm_tpu.train.setup import init_model_variables
from clipspm_tpu.utils.config import load_config as jax_load
from clipspm_tpu_torch import weights
from clipspm_tpu_torch.data import transforms as ttf
from clipspm_tpu_torch.data.episode import Episode
from clipspm_tpu_torch.models.fsar import build_model
from clipspm_tpu_torch.train import learner as tlearner_mod
from clipspm_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "strm", "ucf.yaml")
IMG, STEPS = 32, 2
OPTS = ["USE_AMP=false", f"DATA.IMG_SIZE={IMG}", "TRAIN.TASKS_PER_BATCH=1"]
# the first step's loss, from the same weights and frames: the two
# packages' fp32 roundings through the train-mode trunk (measured 3.9e-4)
FIRST_LOSS_REL = 2e-3
# a loss this large at random weights, and a second step this much worse
# than the first, is divergence (measured 1.9e3, and 130 and 176 times)
FIRST_LOSS_MIN, GROWTH_MIN = 1e3, 30.0


def _episodes(cfg, seed=7):
    """Seeded uint8 noise episodes of the config's layout (70 UCF train
    classes)."""
    way, shot = int(cfg.TRAIN.WAY), int(cfg.TRAIN.SHOT)
    queries, T = int(cfg.TRAIN.QUERY_PER_CLASS), int(cfg.DATA.SEQ_LEN)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        classes = rng.choice(70, way, replace=False).astype(np.int32)
        sl = rng.permutation(np.repeat(np.arange(way), shot)).astype(np.int32)
        tl = rng.permutation(np.repeat(np.arange(way), queries)
                             ).astype(np.int32)
        frames = rng.integers(0, 256, (way * (shot + queries), T, IMG, IMG,
                                       3)).astype(np.uint8)
        out.append(dict(
            support_images=frames[:way * shot], support_labels=sl,
            target_images=frames[way * shot:], target_labels=tl,
            real_support_labels=classes[sl], real_target_labels=classes[tl],
            batch_class_list=classes))
    return out


def _jax_losses(cfg, variables, eps):
    zeros = np.zeros((1, 1), np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(jlearner_mod, "episode_device_transform",
                   lambda images, rng, *, train, **kw:
                   jtf.episode_device_transform(images, rng, train=False,
                                                **kw))
        learner = jlearner_mod.Learner(
            cfg, jax_build_model(cfg), variables, text_train=zeros,
            text_test=zeros,
            transform=jlearner_mod.TransformSpec(img_size=IMG,
                                                 resize_to=IMG))
        return [float(learner.train_episodes([JEpisode(**e)],
                                             n_valid=1)["loss"])
                for e in eps]


def _port_losses(cfg, variables, eps):
    model = build_model(cfg)
    model.load_state_dict(weights.model_state_dict(variables), strict=True)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    zeros = torch.zeros(1, 1)
    learner = tlearner_mod.Learner(
        cfg, model, zeros, zeros, torch.device("cpu"),
        transform=ttf.TransformSpec(img_size=IMG, resize_to=IMG),
        log_fn=lambda *_: None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlearner_mod, "episode_device_transform",
                   lambda images, *, train, gen=None, **kw:
                   ttf.episode_device_transform(images, train=False, **kw))
        return [float(learner.train_episodes([Episode(**e)],
                                             n_valid=1)["loss"])
                for e in eps]


def test_strm_diverges_from_random_weights_in_both_packages():
    jcfg, cfg = jax_load(CFG, opts=OPTS), load_config(CFG, opts=OPTS)
    assert str(cfg.SOLVER.OPTIM_METHOD) == "sgd"
    assert float(cfg.SOLVER.LR) == 1e-4
    model = jax_build_model(jcfg)
    variables = jax.tree_util.tree_map(np.asarray, dict(init_model_variables(
        jcfg, model, jax.random.PRNGKey(int(jcfg.MODEL.SEED)))))
    eps = _episodes(cfg)
    want = _jax_losses(jcfg, variables, eps)
    got = _port_losses(cfg, variables, eps)
    assert all(np.isfinite(want)) and all(np.isfinite(got))
    np.testing.assert_allclose(got[0], want[0], rtol=FIRST_LOSS_REL)
    for losses in (want, got):
        assert losses[0] > FIRST_LOSS_MIN, losses
        assert losses[1] > GROWTH_MIN * losses[0], losses
