"""The port's ViT slice as a whole, against the JAX package (``test-tiny``,
the ViT tower at width 64).

- Feature-cached CLIP-SPM evaluation: the JAX package's ``build_learner`` +
  ``evaluate_cached`` on a synthetic split; its variables and text tables
  carried into the port, whose evaluator runs on the same split with the same
  seed: equal accuracy and CI, the loss within 1e-4.
- One accumulated ``train_episodes`` step (TASKS_PER_BATCH=2, the second
  episode padding) of the JAX ``Learner`` and of the port's, both with the
  remat-chunked train encode (eval chunks of 3, train chunks of 5 over 32
  frames, so 3 frames of padding), dropout off and the eval transform on both
  sides, from identical weights.
- The port's CLI trains with the train chunk, validates, checkpoints, and an
  ONLY_TEST run restores the checkpoint; an RN-tower model refuses it.
"""

import os
import re
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from make_synthetic_dataset import make_dataset  # noqa: E402

from clipspm_tpu.data import transforms as jtf  # noqa: E402
from clipspm_tpu.data.episode import Episode as JEpisode  # noqa: E402
from clipspm_tpu.models.backbones.clip import CLIP_ARCHS as J_ARCHS  # noqa: E402
from clipspm_tpu.models.fsar import CLIPSPMModel as JModel  # noqa: E402
from clipspm_tpu.train import learner as jlearner_mod  # noqa: E402
from clipspm_tpu.train.feature_cache import evaluate_cached as jax_evaluate  # noqa: E402
from clipspm_tpu.train.learner import TransformSpec as JSpec  # noqa: E402
from clipspm_tpu.train.setup import build_learner as jax_build  # noqa: E402
from clipspm_tpu.utils.config import ConfigNode as JConfig  # noqa: E402
from clipspm_tpu.utils.config import SPM_DEFAULT_PARAMS  # noqa: E402
from clipspm_tpu.utils.config import load_config as jax_load  # noqa: E402
from clipspm_tpu_torch import weights  # noqa: E402
from clipspm_tpu_torch.cli.run import main as port_cli  # noqa: E402
from clipspm_tpu_torch.data import transforms as ttf  # noqa: E402
from clipspm_tpu_torch.data.episode import Episode  # noqa: E402
from clipspm_tpu_torch.models.backbones.clip import CLIP_ARCHS  # noqa: E402
from clipspm_tpu_torch.models.fsar import CLIPSPMModel  # noqa: E402
from clipspm_tpu_torch.train import learner as tlearner_mod  # noqa: E402
from clipspm_tpu_torch.train.feature_cache import evaluate_cached  # noqa: E402
from clipspm_tpu_torch.train.learner import Learner  # noqa: E402
from clipspm_tpu_torch.train.setup import build_learner  # noqa: E402
from clipspm_tpu_torch.utils.config import ConfigNode  # noqa: E402
from clipspm_tpu_torch.utils.config import load_config  # noqa: E402

pytest.importorskip("PIL.Image")
torch.set_num_threads(2)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


# -- cached evaluation --------------------------------------------------------

EPISODES = 12
EVAL_OPTS = ["MODEL.BACKBONE=test-tiny", "TRAIN.SHOT=2", "TEST.ONLY_TEST=true",
             "TEST.CACHE_FEATURES=true", f"TEST.TEST_EPISODES={EPISODES}",
             "TEST.QUERY_PER_CLASS=2", "TEST.CACHE_EVAL_BATCH=5",
             "TEST.CACHE_ENCODE_VIDEOS=8", "DATA.NUM_WORKERS=2",
             "DATA.IMG_NORM=true", "MODEL.ENCODE_CHUNK=5"]


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("slice_vit"))
    cfg_path = make_dataset(root, classes=4, videos=5, frames=6, size=96,
                            img_size=32, seq_len=4)
    return root, cfg_path


def test_cached_eval_matches_jax(split):
    """test-tiny, 2-way 2-shot 2-query, T=4, eval chunks of 5 frames."""
    root, cfg_path = split
    jcfg = jax_load(cfg_path, opts=EVAL_OPTS, splits_root=root)
    jl = jax_build(jcfg, log_fn=lambda *_: None, allow_random_weights=True)
    jl.test_source.close()
    want = jax_evaluate(jcfg, jl, log_fn=lambda *_: None)
    st = jl.state
    cfg = load_config(cfg_path, opts=EVAL_OPTS, splits_root=root)
    learner = build_learner(cfg, log_fn=lambda *_: None, device="cpu",
                            allow_random_weights=True)
    assert learner.model.encode_chunk == 5
    learner.model.load_state_dict(weights.model_state_dict(
        {"params": _np_tree(st.params)}), strict=True)
    learner.text_train = torch.from_numpy(np.array(st.text_train))
    learner.text_test = torch.from_numpy(np.array(st.text_test))
    got = evaluate_cached(cfg, learner, log_fn=lambda *_: None)
    assert got["unique_videos"] == want["unique_videos"]
    assert want["confidence"] > 0
    assert got["accuracy"] == want["accuracy"]
    assert got["confidence"] == want["confidence"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-4)


# -- one masked train step with the remat-chunked encode ----------------------

WAY, SHOT, QUERIES, T, IMG, PX, CLASSES = 2, 2, 2, 4, 32, 40, 6
S, Q = WAY * SHOT, WAY * QUERIES
CFG = {
    "MODEL": {"NAME": "clipspm", "BACKBONE": "test-tiny", "SEED": 3,
              "ENCODE_CHUNK": 3, "TRAIN_ENCODE_CHUNK": 5},
    "TRAIN": {"WAY": WAY, "SHOT": SHOT, "QUERY_PER_CLASS": QUERIES,
              "TASKS_PER_BATCH": 2, "TRAIN_EPISODES": 2, "VAL_FREQ": 0,
              "PRINT_FREQ": 100},
    "TEST": {"QUERY_PER_CLASS": 1, "TEST_EPISODES": 2},
    "DATA": {"DATASET": "hmdb", "IMG_SIZE": IMG, "SEQ_LEN": T},
    "SOLVER": {"LR": 1e-3, "LR_SCH": 10 ** 6, "OPTIM_METHOD": "adam",
               "WEIGHT_DECAY": 1e-4, "MOMENTUM": 0.9},
    "USE_AMP": False,
    "params": SPM_DEFAULT_PARAMS["hmdb"],
}
# Tolerances, fp32 on the CPU, sums in other orders. The ViT tower has no
# BatchNorm, so the summed gradient is well conditioned: the loss to 1e-5
# relative, each of Adam's moments to 1e-3 relative a tensor. One Adam step
# moves each parameter by about LR * sign(g + wd * p); where that sign is
# decided (|mu| > 0.1 rms of its tensor, 79% of the elements) the
# parameters agree to 1e-5, elsewhere within 2 * LR.
LOSS_REL, GRAD_REL, PARAM_ABS = 1e-5, 1e-3, 1e-5


def _episodes(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        classes = rng.choice(CLASSES, WAY, replace=False).astype(np.int32)
        sl = rng.permutation(np.repeat(np.arange(WAY), SHOT)).astype(np.int32)
        tl = rng.permutation(np.repeat(np.arange(WAY), QUERIES)).astype(
            np.int32)
        out.append(dict(
            support_images=rng.integers(0, 256, (S, T, PX, PX, 3),
                                        dtype=np.uint8),
            support_labels=sl,
            target_images=rng.integers(0, 256, (Q, T, PX, PX, 3),
                                       dtype=np.uint8),
            target_labels=tl, real_support_labels=classes[sl],
            real_target_labels=classes[tl], batch_class_list=classes))
    return out


@pytest.fixture(scope="module")
def steps():
    eps = _episodes(0, 2)
    arch = J_ARCHS["test-tiny"]
    model = JModel(arch=arch, way=WAY, shot=SHOT, spm=dict(CFG["params"]),
                   encode_chunk=3, train_encode_chunk=5,
                   train_remat_policy="attn_out")
    D = arch.embed_dim
    dummy = (jnp.zeros((S, T, IMG, IMG, 3)), jnp.zeros((Q, T, IMG, IMG, 3)),
             jnp.arange(S, dtype=jnp.int32) % WAY,
             jnp.zeros((S,), jnp.int32), jnp.zeros((Q,), jnp.int32),
             jnp.zeros((CLASSES, D)), jnp.zeros((CLASSES, D)))
    variables = model.init(jax.random.PRNGKey(0), *dummy)
    text = np.random.default_rng(1).normal(size=(CLASSES, D)).astype(
        np.float32)
    before = weights.model_state_dict({"params": _np_tree(
        variables["params"])})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(jlearner_mod, "episode_device_transform",
                   lambda images, rng, *, train, **kw:
                   jtf.episode_device_transform(images, rng, train=False,
                                                **kw))
        jl = jlearner_mod.Learner(
            JConfig(CFG), model, variables, text_train=text, text_test=text,
            transform=JSpec(img_size=IMG, resize_to=PX))
        jmetrics = jl.train_episodes([JEpisode(**e) for e in eps], n_valid=1)
    st = jl.state
    adam = next(s for s in st.opt_state if hasattr(s, "mu"))
    want = dict(metrics=jmetrics, episode=int(st.episode), before=before,
                after=weights.model_state_dict({"params": _np_tree(
                    st.params)}),
                mu=weights.model_state_dict({"params": _np_tree(adam.mu)}),
                nu=weights.model_state_dict({"params": _np_tree(adam.nu)}))

    tmodel = CLIPSPMModel(arch=CLIP_ARCHS["test-tiny"], way=WAY, shot=SHOT,
                          spm=dict(CFG["params"]), encode_chunk=3,
                          train_encode_chunk=5)
    tmodel.load_state_dict(before, strict=True)
    for m in tmodel.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    t = torch.from_numpy(text)
    tl = Learner(ConfigNode(CFG), tmodel, t, t, torch.device("cpu"),
                 transform=ttf.TransformSpec(img_size=IMG, resize_to=PX))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlearner_mod, "episode_device_transform",
                   lambda images, *, train, gen=None, **kw:
                   ttf.episode_device_transform(images, train=False, **kw))
        got = tl.train_episodes([Episode(**e) for e in eps], n_valid=1)
    return want, tl, got


def test_one_masked_chunked_step_loss_and_acc_match_jax(steps):
    want, learner, got = steps
    assert learner.model.train_remat_policy == "attn_out"
    np.testing.assert_allclose(got["loss"], want["metrics"]["loss"],
                               rtol=LOSS_REL)
    assert got["acc"] == want["metrics"]["acc"]
    assert learner.episode == want["episode"] == 1


def test_one_masked_chunked_step_adam_and_params_match_jax(steps):
    want, learner, _ = steps
    got = learner.model.state_dict()
    decided = total = 0
    for key, p in learner.model.named_parameters():
        state = learner.optimizer.state[p]
        for mine, theirs in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            assert _rel(state[mine], want[theirs][key]) <= GRAD_REL, \
                (key, mine)
        w = want["after"][key]
        assert not torch.equal(w, want["before"][key]), key
        mu = want["mu"][key]
        sure = mu.abs() > 0.1 * mu.pow(2).mean().sqrt()
        diff = (got[key] - w).abs()
        assert float((diff * sure).max()) <= PARAM_ABS, key
        assert float(diff.max()) <= 2 * CFG["SOLVER"]["LR"] + PARAM_ABS, key
        decided += int(sure.sum())
        total += sure.numel()
    assert decided >= 0.7 * total           # 79% here


# -- the CLI ------------------------------------------------------------------

def test_cli_trains_vit_with_remat_checkpoints_and_restores(split, tmp_path):
    root, cfg_path = split
    ckpt = str(tmp_path / "ckpt")
    flags = ["--cfg", cfg_path, "--splits-root", root, "--device", "cpu"]
    common = ["MODEL.BACKBONE=test-tiny", "TEST.CACHE_FEATURES=true",
              "TEST.TEST_EPISODES=4", "DATA.NUM_WORKERS=2",
              f"CHECKPOINT.CHECKPOINT_DIR={ckpt}"]
    res = port_cli([*flags, "--allow-random-weights", *common,
                    "MODEL.TRAIN_ENCODE_CHUNK=5", "TRAIN.TRAIN_EPISODES=8",
                    "TRAIN.VAL_FREQ=4", "TRAIN.PRINT_FREQ=4"])
    assert res["episodes"] == 8
    with open(os.path.join(ckpt, "log.txt")) as f:
        log = f.read()
    tasks = re.findall(r"Task \[(\d+)/8\], Train Loss: (\S+),", log)
    assert [int(t) for t, _ in tasks] == [4, 8]
    assert all(np.isfinite(float(v)) for _, v in tasks)
    assert "Val @ 4: acc" in log
    best = os.path.join(ckpt, "checkpoint_best")
    saved = torch.load(os.path.join(best, "checkpoint.pt"),
                       weights_only=True)
    assert "backbone.class_embedding" in saved["model"]

    test_dir = str(tmp_path / "test")
    out = port_cli([*flags, *common, "TEST.ONLY_TEST=true",
                    f"TEST.TEST_MODEL_PATH={best}",
                    f"CHECKPOINT.CHECKPOINT_DIR={test_dir}"])
    assert np.isfinite(out["loss"])
    # a ViT checkpoint does not restore into an RN-tower model
    with pytest.raises(ValueError, match="does not match"):
        port_cli([*flags, *common, "MODEL.BACKBONE=test-tiny-rn",
                  "TEST.ONLY_TEST=true", f"TEST.TEST_MODEL_PATH={best}",
                  f"CHECKPOINT.CHECKPOINT_DIR={test_dir}"])
