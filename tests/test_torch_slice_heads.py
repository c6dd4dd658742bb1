"""The port's clipfsar, cpm2c and sten training slices against the JAX
package.

One accumulated ``train_episodes`` step (TASKS_PER_BATCH=2, the second
episode padding: ``n_valid=1``) of the JAX ``Learner`` and of the port's,
from identical ``test-tiny`` weights carried by ``weights.model_state_dict``
(clipfsar and cpm2c under Adam, sten under SGD with momentum). Dropout is
off on both sides and both transforms take the eval branch, so the step is
deterministic. Then the port's CLI trains clipfsar (cached validation) and
cpm2c (uncached validation) on a tiny synthetic split, checkpoints, and an
``ONLY_TEST`` run restores ``checkpoint_best``.
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
from clipspm_tpu.models.heads.clipfsar import CLIPFSARModel as JCLIPFSAR  # noqa: E402
from clipspm_tpu.models.heads.cpm2c import CPM2CModel as JCPM2C  # noqa: E402
from clipspm_tpu.models.heads.sten import STENModel as JSTEN  # noqa: E402
from clipspm_tpu.train import learner as jlearner_mod  # noqa: E402
from clipspm_tpu.train.learner import TransformSpec as JSpec  # noqa: E402
from clipspm_tpu.utils.config import ConfigNode as JConfig  # noqa: E402
from clipspm_tpu.utils.config import SPM_DEFAULT_PARAMS  # noqa: E402
from clipspm_tpu_torch import weights  # noqa: E402
from clipspm_tpu_torch.cli.run import main as port_cli  # noqa: E402
from clipspm_tpu_torch.data import transforms as ttf  # noqa: E402
from clipspm_tpu_torch.data.episode import Episode  # noqa: E402
from clipspm_tpu_torch.models.fsar import build_model  # noqa: E402
from clipspm_tpu_torch.train import learner as tlearner_mod  # noqa: E402
from clipspm_tpu_torch.train.learner import Learner  # noqa: E402
from clipspm_tpu_torch.utils.config import ConfigNode  # noqa: E402

torch.set_num_threads(2)

WAY, SHOT, QUERIES, T, IMG, PX, CLASSES = 2, 2, 2, 4, 32, 40, 6
S, Q = WAY * SHOT, WAY * QUERIES
D = J_ARCHS["test-tiny"].embed_dim
PARAMS = dict(SPM_DEFAULT_PARAMS["hmdb"])
JAX_MODELS = {
    "clipfsar": lambda: JCLIPFSAR(arch=J_ARCHS["test-tiny"], way=WAY,
                                  shot=SHOT),
    "cpm2c": lambda: JCPM2C(arch=J_ARCHS["test-tiny"], way=WAY, shot=SHOT,
                            params=PARAMS),
    "sten": lambda: JSTEN(arch=J_ARCHS["test-tiny"], way=WAY, shot=SHOT),
}
OPTIM = {"clipfsar": "adam", "cpm2c": "adam", "sten": "sgd"}
# SGD's step is LR times the gradient (about 1e-3 here): a large LR makes it
# stand far above the parameters' fp32 rounding
LR = {"adam": 1e-3, "sgd": 0.5}


def _cfg(name):
    return {
        "MODEL": {"NAME": name, "BACKBONE": "test-tiny", "SEED": 3,
                  "USE_CLASSIFICATION_VALUE": 1.5, "LMD": [0.5, 1, 0.5]},
        "TRAIN": {"WAY": WAY, "SHOT": SHOT, "QUERY_PER_CLASS": QUERIES,
                  "TASKS_PER_BATCH": 2, "TRAIN_EPISODES": 2, "VAL_FREQ": 0,
                  "PRINT_FREQ": 100},
        "TEST": {"QUERY_PER_CLASS": 1, "TEST_EPISODES": 2},
        "DATA": {"DATASET": "hmdb", "IMG_SIZE": IMG, "SEQ_LEN": T},
        "SOLVER": {"LR": LR[OPTIM[name]], "LR_SCH": 10 ** 6, "OPTIM_METHOD": OPTIM[name],
                   "WEIGHT_DECAY": 1e-4, "MOMENTUM": 0.9},
        "USE_AMP": False,
        "params": PARAMS,
    }


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


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _steps(name):
    """One masked step of each package from the same weights: the JAX
    side's metrics, parameters and first moments after the step (in the
    port's keys), and the port's learner and metrics."""
    eps = _episodes(0, 2)
    model = JAX_MODELS[name]()
    dummy = (jnp.zeros((S, T, IMG, IMG, 3)), jnp.zeros((Q, T, IMG, IMG, 3)),
             jnp.arange(S, dtype=jnp.int32) % WAY,
             jnp.zeros((S,), jnp.int32), jnp.zeros((Q,), jnp.int32),
             jnp.zeros((CLASSES, D)), jnp.zeros((CLASSES, D)))
    key = jax.random.PRNGKey(0)
    variables = model.init({"params": key, "dropout": key}, *dummy,
                           train=True)
    text = np.random.default_rng(1).normal(size=(CLASSES, D)).astype(
        np.float32)
    init = {"params": _to_np(variables["params"])}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(jlearner_mod, "episode_device_transform",
                   _jax_eval_transform)
        learner = jlearner_mod.Learner(
            JConfig(_cfg(name)), model, variables, text_train=text,
            text_test=text, transform=JSpec(img_size=IMG, resize_to=PX))
        want = learner.train_episodes([JEpisode(**e) for e in eps],
                                      n_valid=1)
    st = learner.state
    moment = next((s.mu for s in st.opt_state if hasattr(s, "mu")),
                  next((s.trace for s in st.opt_state if hasattr(s, "trace")),
                       None))
    jax_side = dict(metrics=want, episode=int(st.episode),
                    before=weights.model_state_dict(init),
                    after=weights.model_state_dict(
                        {"params": _to_np(st.params)}),
                    moment=weights.model_state_dict(
                        {"params": _to_np(moment)}))

    tm = build_model(ConfigNode(_cfg(name)))
    tm.load_state_dict(jax_side["before"], strict=True)
    for m in tm.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    tt = torch.from_numpy(text)
    port = Learner(ConfigNode(_cfg(name)), tm, tt, tt, torch.device("cpu"),
                   transform=ttf.TransformSpec(img_size=IMG, resize_to=PX))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlearner_mod, "episode_device_transform",
                   _port_eval_transform)
        got = port.train_episodes([Episode(**e) for e in eps], n_valid=1)
    return jax_side, port, got


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


@pytest.mark.parametrize("name", sorted(JAX_MODELS))
def test_one_masked_step_matches_jax(name):
    """Loss and accuracy of the step, the episode count (the padding
    episode counts for nothing), the optimizer's first moment (Adam's mu,
    SGD's momentum trace: the weight-decayed gradient) per tensor to 1e-3
    relative (a bias's gradient sums its upstream gradient over every token
    and frame, and partly cancels: clipfsar's ``context2.ff_0.fc2.bias``
    measured 1.2e-4, every other tensor of the three models at most 5e-5),
    and the parameters after the step: Adam moves each by about
    LR * sign(mu), so where that sign is decided (|mu| above 0.01 rms of
    its tensor: 94-97% of the elements here, which the moments' 1e-3 cannot
    flip) to 1e-5 and elsewhere within 2 * LR; SGD's update to 1e-3
    relative."""
    want, port, got = _steps(name)
    np.testing.assert_allclose(got["loss"], want["metrics"]["loss"],
                               rtol=1e-5)
    assert got["acc"] == want["metrics"]["acc"]
    assert port.episode == want["episode"] == 1
    state = port.model.state_dict()
    assert set(state) == set(want["after"])
    buffer = "exp_avg" if OPTIM[name] == "adam" else "momentum_buffer"
    decided = total = 0
    for key, p in port.model.named_parameters():
        mu, w = want["moment"][key], want["after"][key]
        assert _rel(port.optimizer.state[p][buffer], mu) <= 1e-3, key
        if OPTIM[name] == "sgd":
            assert _rel(p.detach() - want["before"][key],
                        w - want["before"][key]) <= 1e-3, key
            continue
        sure = mu.abs() > 0.01 * mu.pow(2).mean().sqrt()
        diff = (p.detach() - w).abs()
        assert float((diff * sure).max()) <= 1e-5, key
        assert float(diff.max()) <= 2 * LR["adam"] + 1e-5, key
        decided += int(sure.sum())
        total += sure.numel()
    assert OPTIM[name] == "sgd" or decided >= 0.9 * total


@pytest.fixture(scope="module")
def cli_split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("headcli"))
    return root, make_dataset(root, classes=4, videos=5, frames=6, size=40,
                              img_size=32, seq_len=4)


@pytest.mark.parametrize("name,backbone,cached", [
    ("clipfsar", "test-tiny", True), ("cpm2c", "test-tiny-rn", False)])
def test_cli_trains_validates_checkpoints_and_restores(cli_split, tmp_path,
                                                       name, backbone,
                                                       cached):
    root, cfg_path = cli_split
    ckpt = str(tmp_path / "ckpt")
    flags = ["--cfg", cfg_path, "--splits-root", root, "--device", "cpu"]
    common = [f"MODEL.NAME={name}", f"MODEL.BACKBONE={backbone}",
              "MODEL.USE_CLASSIFICATION_VALUE=1.5",
              f"TEST.CACHE_FEATURES={str(cached).lower()}",
              "TEST.TEST_EPISODES=3", "TEST.EVAL_BATCH=2",
              "DATA.NUM_WORKERS=2", "TRAIN.TASKS_PER_BATCH=2"]
    res = port_cli([*flags, "--allow-random-weights", *common,
                    "TRAIN.TRAIN_EPISODES=6", "TRAIN.VAL_FREQ=4",
                    "TRAIN.PRINT_FREQ=2", "CHECKPOINT.SAVE_FREQ=4",
                    f"CHECKPOINT.CHECKPOINT_DIR={ckpt}"])
    assert res["episodes"] == 6
    with open(os.path.join(ckpt, "log.txt")) as f:
        log = f.read()
    tasks = re.findall(r"Task \[(\d+)/6\], Train Loss: (\S+),", log)
    assert [int(t) for t, _ in tasks] == [2, 4, 6]
    assert all(np.isfinite(float(v)) for _, v in tasks)
    assert len(re.findall(r"Val @ 4: acc", log)) == 1
    val_line = ("feature-cached eval: 3 episodes" if cached
                else "uncached eval: 3 episodes in batches of 2")
    assert log.count(val_line) == 1
    for tag in ("best", "iter_4"):
        assert os.path.isfile(os.path.join(ckpt, f"checkpoint_{tag}",
                                           "checkpoint.pt"))
    saved = torch.load(os.path.join(ckpt, "checkpoint_best",
                                    "checkpoint.pt"), weights_only=True)

    test_dir = str(tmp_path / "test_ckpt")
    out = port_cli([*flags, *common, "TEST.ONLY_TEST=true",
                    f"TEST.TEST_MODEL_PATH={ckpt}/checkpoint_best",
                    f"CHECKPOINT.CHECKPOINT_DIR={test_dir}"])
    assert np.isfinite(out["loss"])
    with open(os.path.join(test_dir, "log.txt")) as f:
        log = f.read()
    assert (f"Loaded checkpoint from {ckpt}/checkpoint_best ==> iter: "
            f"[{saved['meta']['iteration']}]") in log
    assert log.count(val_line) == 1 and "FRESH" not in log
