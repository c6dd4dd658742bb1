"""The port's training slice as a whole, against the JAX package.

One accumulated ``train_episodes`` step (TASKS_PER_BATCH=2, the second
episode padding: ``n_valid=1``) of the JAX ``Learner`` and of the port's,
from identical ``test-tiny-rn`` weights carried across by ``weights.py``.
Dropout is off on both sides (flax's ``nn.Dropout`` patched to the identity
here, the port's dropout rates set to 0) and both transforms take the eval
branch (the JAX learner module's ``episode_device_transform`` name patched),
so the step is deterministic. JAX's updated variables go back through
``weights.model_state_dict``. Then the port's CLI trains on a tiny
synthetic split, validates, checkpoints, and an ONLY_TEST run restores the
checkpoint.
"""

import json
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
from clipspm_tpu.train.learner import TransformSpec as JSpec  # noqa: E402
from clipspm_tpu.utils.config import ConfigNode as JConfig  # noqa: E402
from clipspm_tpu.utils.config import SPM_DEFAULT_PARAMS  # noqa: E402
from clipspm_tpu_torch import weights  # noqa: E402
from clipspm_tpu_torch.cli.run import main as port_cli  # noqa: E402
from clipspm_tpu_torch.data import transforms as ttf  # noqa: E402
from clipspm_tpu_torch.data.episode import Episode  # noqa: E402
from clipspm_tpu_torch.models.backbones.clip import CLIP_ARCHS  # noqa: E402
from clipspm_tpu_torch.models.fsar import CLIPSPMModel  # noqa: E402
from clipspm_tpu_torch.train import learner as tlearner_mod  # noqa: E402
from clipspm_tpu_torch.train.learner import Learner  # noqa: E402
from clipspm_tpu_torch.utils.config import ConfigNode  # noqa: E402

torch.set_num_threads(2)

WAY, SHOT, QUERIES, T, IMG, PX, CLASSES = 2, 2, 2, 4, 32, 40, 6
S, Q = WAY * SHOT, WAY * QUERIES
CFG = {
    "MODEL": {"NAME": "clipspm", "BACKBONE": "test-tiny-rn", "SEED": 3},
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
# Tolerances. fp32 on the CPU, sums in other orders. The loss to 1e-4
# relative (the tower in train mode carries ~1e-5 relative differences to
# its output). BatchNorm running stats to 1e-5 relative (measured <= 4e-6;
# torch's unbiased variance would be 1/n, 1e-2 to 3e-2, off). The summed
# gradient (Adam's moments) is ill-conditioned: every convolution feeds a
# BatchNorm, so BatchNorm's own gradients and the convolutions' before it
# are small residues of large cancelling sums, which another summation
# order moves far more than one rounding; each tensor is held to 1e-2
# relative; a gradient that is
# zero in exact arithmetic (the attention pool's key bias: a constant added
# to every key's logit) is held to 1e-6 absolute. One Adam step moves each
# parameter by about LR * sign(g + wd * p); where that sign is decided
# (|mu| > 0.1 rms of its tensor, 90% of the elements) the parameters agree
# to 1e-5, elsewhere within 2 * LR.
LOSS_REL, STATS_REL, GRAD_REL, ZERO_ABS, PARAM_ABS = 1e-4, 1e-5, 1e-2, \
    1e-6, 1e-5


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


def _jax_eval_transform(images, rng, *, train, **kw):
    return jtf.episode_device_transform(images, rng, train=False, **kw)


def _port_eval_transform(images, *, train, gen=None, **kw):
    return ttf.episode_device_transform(images, train=False, **kw)


@pytest.fixture(scope="module")
def jax_step():
    """Initial variables and text table, and the JAX learner after one
    masked step (one shared compile for the file)."""
    eps = _episodes(0, 2)
    model = JModel(arch=J_ARCHS["test-tiny-rn"], way=WAY, shot=SHOT,
                   spm=dict(CFG["params"]))
    D = J_ARCHS["test-tiny-rn"].embed_dim
    dummy = (jnp.zeros((S, T, IMG, IMG, 3)), jnp.zeros((Q, T, IMG, IMG, 3)),
             jnp.arange(S, dtype=jnp.int32) % WAY,
             jnp.zeros((S,), jnp.int32), jnp.zeros((Q,), jnp.int32),
             jnp.zeros((CLASSES, D)), jnp.zeros((CLASSES, D)))
    variables = model.init(jax.random.PRNGKey(0), *dummy)
    text = np.random.default_rng(1).normal(size=(CLASSES, D)).astype(
        np.float32)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    init = {"params": to_np(variables["params"]),
            "batch_stats": to_np(variables["batch_stats"])}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(jlearner_mod, "episode_device_transform",
                   _jax_eval_transform)
        learner = jlearner_mod.Learner(
            JConfig(CFG), model, variables, text_train=text, text_test=text,
            transform=JSpec(img_size=IMG, resize_to=PX))
        metrics = learner.train_episodes([JEpisode(**e) for e in eps],
                                         n_valid=1)
    st = learner.state
    adam = next(s for s in st.opt_state if hasattr(s, "mu"))
    stats = to_np(st.batch_stats)
    return dict(init=init, text=text, eps=eps, metrics=metrics,
                episode=int(st.episode),
                after=weights.model_state_dict(
                    {"params": to_np(st.params), "batch_stats": stats}),
                mu=weights.model_state_dict(
                    {"params": to_np(adam.mu), "batch_stats": stats}),
                nu=weights.model_state_dict(
                    {"params": to_np(adam.nu), "batch_stats": stats}))


@pytest.fixture(scope="module")
def port_step(jax_step):
    model = CLIPSPMModel(arch=CLIP_ARCHS["test-tiny-rn"], way=WAY, shot=SHOT,
                         spm=dict(CFG["params"]))
    model.load_state_dict(weights.model_state_dict(jax_step["init"]),
                          strict=True)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    text = torch.from_numpy(jax_step["text"])
    learner = Learner(ConfigNode(CFG), model, text, text,
                      torch.device("cpu"),
                      transform=ttf.TransformSpec(img_size=IMG, resize_to=PX))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlearner_mod, "episode_device_transform",
                   _port_eval_transform)
        metrics = learner.train_episodes(
            [Episode(**e) for e in jax_step["eps"]], n_valid=1)
    return learner, metrics


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def test_one_masked_step_loss_and_acc_match_jax(jax_step, port_step):
    learner, got = port_step
    want = jax_step["metrics"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_REL)
    assert got["acc"] == want["acc"]
    # the padding episode counts for nothing
    assert learner.episode == jax_step["episode"] == 1


def test_one_masked_step_params_and_bn_stats_match_jax(jax_step, port_step):
    learner, _ = port_step
    got = learner.model.state_dict()
    want, mu = jax_step["after"], jax_step["mu"]
    before = weights.model_state_dict(jax_step["init"])
    assert set(want) == set(got)
    decided = total = 0
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        # every parameter and running stat moved (weight decay reaches the
        # unused parameters too)
        assert not torch.equal(w, before[key]), key
        if "running_" in key:
            assert _rel(got[key], w) <= STATS_REL, key
            continue
        sure = mu[key].abs() > 0.1 * mu[key].pow(2).mean().sqrt()
        if key == "backbone.attnpool.k_proj.bias":
            sure = torch.zeros_like(sure)      # its gradient is rounding
        diff = (got[key] - w).abs()
        assert float((diff * sure).max()) <= PARAM_ABS, key
        assert float(diff.max()) <= 2 * CFG["SOLVER"]["LR"] + PARAM_ABS, key
        decided += int(sure.sum())
        total += sure.numel()
    assert decided >= 0.85 * total


def test_one_masked_step_adam_moments_match_jax(jax_step, port_step):
    learner, _ = port_step
    for key, p in learner.model.named_parameters():
        state = learner.optimizer.state[p]
        for mine, theirs in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            want = jax_step[theirs][key]
            if key == "backbone.attnpool.k_proj.bias":
                assert float(state[mine].norm()) <= ZERO_ABS
                assert float(want.norm()) <= ZERO_ABS
                continue
            assert _rel(state[mine], want) <= GRAD_REL, (key, mine)


def test_cli_trains_checkpoints_and_restores(tmp_path):
    root = str(tmp_path)
    cfg_path = make_dataset(root, classes=4, videos=5, frames=6, size=40,
                            img_size=IMG, seq_len=T)
    ckpt = os.path.join(root, "ckpt")
    flags = ["--cfg", cfg_path, "--splits-root", root, "--device", "cpu"]
    common = ["MODEL.BACKBONE=test-tiny-rn", "TEST.CACHE_FEATURES=true",
              "TEST.TEST_EPISODES=4", "DATA.NUM_WORKERS=2"]
    res = port_cli([*flags, "--allow-random-weights", *common,
                    "TRAIN.TRAIN_EPISODES=10", "TRAIN.VAL_FREQ=4",
                    "TRAIN.PRINT_FREQ=4", "CHECKPOINT.SAVE_FREQ=8",
                    f"CHECKPOINT.CHECKPOINT_DIR={ckpt}"])
    assert res["episodes"] == 10
    with open(os.path.join(ckpt, "log.txt")) as f:
        log = f.read()
    assert "Conduct Training:" in log
    tasks = re.findall(r"Task \[(\d+)/10\], Train Loss: (\S+),.*"
                       r"\(host-stall \d+%\)", log)
    # steps of 4, 4 and the 2 real episodes of the partial last batch
    assert [int(t) for t, _ in tasks] == [4, 8, 10]
    assert all(np.isfinite(float(v)) for _, v in tasks)
    assert len(re.findall(r"Val @ \d+: acc", log)) == 2
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if r["tag"] == "loss/Train_loss[it]"] \
        == [4, 8, 10]
    assert sum(r["tag"] == "acc/Test_acc" for r in recs) == 2
    for tag in ("best", "iter_8"):
        assert os.path.isfile(os.path.join(ckpt, f"checkpoint_{tag}",
                                           "checkpoint.pt"))
    saved = torch.load(os.path.join(ckpt, "checkpoint_best",
                                    "checkpoint.pt"), weights_only=True)

    # ONLY_TEST from the explicit path: needs no --allow-random-weights
    test_dir = os.path.join(root, "test_ckpt")
    out = port_cli([*flags, *common, "TEST.ONLY_TEST=true",
                    f"TEST.TEST_MODEL_PATH={ckpt}/checkpoint_best",
                    f"CHECKPOINT.CHECKPOINT_DIR={test_dir}"])
    assert np.isfinite(out["loss"])
    with open(os.path.join(test_dir, "log.txt")) as f:
        log = f.read()
    assert (f"Loaded checkpoint from {ckpt}/checkpoint_best ==> iter: "
            f"[{saved['meta']['iteration']}]") in log
    assert "FRESH" not in log
