"""TA2N training in the port against the JAX package.

``test-tiny-resnet`` (ResNet-18 at width 8) at a 64-px crop, 2x2 maps, T=4.
BatchNorm3d's train-mode statistics in TTM and ACM against flax's; the head's
train-mode gradients (dropout off) at both metrics; one masked
TASKS_PER_BATCH=2 SGD step of the JAX ``Learner`` and of the port's, from
identical weights; then the port's CLI trains ``configs/ta2n/ucf.yaml`` on a
tiny synthetic UCF-layout split, validates, checkpoints, and an ONLY_TEST run
restores the checkpoint. fp32 on both sides, sums in other orders; each
tolerance is stated where it is used.
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
from clipspm_tpu.models.fsar import build_model as jax_build_model  # noqa: E402
from clipspm_tpu.models.heads import ta2n as jta2n  # noqa: E402
from clipspm_tpu.train import learner as jlearner_mod  # noqa: E402
from clipspm_tpu.train.learner import TransformSpec as JSpec  # noqa: E402
from clipspm_tpu.utils.config import ConfigNode as JConfig  # noqa: E402
from clipspm_tpu.utils.config import load_config as jax_load  # noqa: E402
from clipspm_tpu_torch import weights  # noqa: E402
from clipspm_tpu_torch.cli.run import main as port_cli  # noqa: E402
from clipspm_tpu_torch.data import transforms as ttf  # noqa: E402
from clipspm_tpu_torch.data.episode import Episode  # noqa: E402
from clipspm_tpu_torch.models.fsar import build_model  # noqa: E402
from clipspm_tpu_torch.models.heads import ta2n as tta2n  # noqa: E402
from clipspm_tpu_torch.train import learner as tlearner_mod  # noqa: E402
from clipspm_tpu_torch.train.learner import Learner  # noqa: E402
from clipspm_tpu_torch.utils.config import ConfigNode  # noqa: E402
from clipspm_tpu_torch.utils.config import load_config  # noqa: E402

from test_torch_ta2n import _apply, _jax_variables  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UCF_TA2N = os.path.join(REPO, "configs", "ta2n", "ucf.yaml")
T, C = 4, 16


def _rel(got, want) -> float:
    got = torch.as_tensor(np.array(got), dtype=torch.float64)
    want = torch.as_tensor(np.array(want), dtype=torch.float64)
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


# -- BatchNorm3d in train mode (the repair) -----------------------------------

def _ttm_case(rng):
    feats = rng.normal(1.0, 2.0, size=(3, T, 2, 2, C)).astype(np.float32)
    return jta2n.TTM(seq_len=T), tta2n.TTM(T, C), (feats,)


def _acm_case(rng):
    sup = rng.normal(1.0, 2.0, size=(3, T, 2, 2, C)).astype(np.float32)
    qry = rng.normal(1.0, 2.0, size=(2, T, 2, 2, C)).astype(np.float32)
    return jta2n.ACM(seq_len=T, dim=C), tta2n.ACM(C), (sup, qry)


@pytest.mark.parametrize("case", [_ttm_case, _acm_case],
                         ids=["ttm", "acm"])
def test_batchnorm3d_train_stats_match_flax(case):
    """One train-mode forward: flax's updated ``batch_stats`` against the
    port's running stats. The second BatchNorm of each sees few elements a
    channel (TTM: n = N*T*H*W = 3*2*1*1 = 6 after its 2x2x2 pool; ACM: 6
    pairs * 4 * 1 * 1 = 24), where torch's unbiased variance is n/(n-1)
    (20% and 4%) off flax's biased one. Stats to 1e-5 relative, the output
    to 1e-4."""
    jmod, tmod, args = case(np.random.default_rng(0))
    variables = _jax_variables(jmod, *args)
    want, upd = _apply(jmod, variables, *args, train=True,
                       mutable=["batch_stats"])
    tmod.load_state_dict(weights.head_state_dict(
        variables["params"], stats=variables["batch_stats"]), strict=True)
    tmod.train()
    with torch.no_grad():
        got = tmod(*[torch.from_numpy(a) for a in args])
    if isinstance(got, tuple):
        got, want = got[0], want[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    after = weights.head_state_dict(
        variables["params"],
        stats=jax.tree_util.tree_map(np.asarray, upd["batch_stats"]))
    running = [k for k in after if "running_" in k]
    assert len(running) == 4
    sd = tmod.state_dict()
    for k in running:
        assert not torch.equal(after[k], weights.head_state_dict(
            variables["params"], stats=variables["batch_stats"])[k]), k
        assert _rel(sd[k], after[k]) <= 1e-5, k
    assert all(int(sd[k.replace("running_mean", "num_batches_tracked")]) == 1
               for k in running if k.endswith("running_mean"))


# -- the head in train mode ---------------------------------------------------

# a conv's bias right before a BatchNorm in train mode: the batch mean takes
# it out again, so its gradient is zero in exact arithmetic (rounding only)
ZERO_GRAD = ("acm.mv_conv1.bias", "acm.mv_conv2.bias")


@pytest.mark.parametrize("metric", ["cos", "otam"])
def test_head_gradients_in_train_mode_match_jax(metric):
    """``match_features`` in train mode (ACM's BatchNorm on batch
    statistics; the head has no dropout) from post-TTM maps: the gradient of
    a random weighting of the logits for every head parameter and both
    inputs, and the updated BatchNorm stats. fp32: gradients to 1e-3
    relative a tensor (ACM's BatchNorm makes its convolutions' gradients
    residues of cancelling sums), stats to 1e-5."""
    way, Q = 3, 6
    rng = np.random.default_rng(1)
    su = rng.normal(size=(way, T, 2, 2, 64)).astype(np.float32)
    qu = rng.normal(size=(Q, T, 2, 2, 64)).astype(np.float32)
    labels = rng.permutation(way).astype(np.int32)
    R = rng.normal(size=(1, Q, way)).astype(np.float32)
    jmodel = jta2n.TA2NModel(way=way, shot=1, seq_len=T, arch="resnet18",
                             backbone_width=8, metric=metric)
    frames = np.zeros((way, T, 64, 64, 3), np.float32)
    variables = _jax_variables(jmodel, frames, frames, labels)

    def loss(params, su, qu):
        out, upd = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            su, qu, jnp.asarray(labels), train=True,
            method="match_features", mutable=["batch_stats"])
        return jnp.sum(out["logits"] * R), upd

    (_, upd), (gp, gsu, gqu) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        variables["params"], jnp.asarray(su), jnp.asarray(qu))

    tmodel = tta2n.TA2NModel(way=way, shot=1, seq_len=T, arch="resnet18",
                             backbone_width=8, metric=metric)
    tmodel.load_state_dict(weights.model_state_dict(variables), strict=True)
    tmodel.train()
    tsu = torch.from_numpy(su).requires_grad_(True)
    tqu = torch.from_numpy(qu).requires_grad_(True)
    out = tmodel.match_features(tsu, tqu, torch.from_numpy(labels))
    (out["logits"] * torch.from_numpy(R)).sum().backward()
    assert _rel(tsu.grad, gsu) <= 1e-3 and _rel(tqu.grad, gqu) <= 1e-3
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    gsd = weights.model_state_dict({"params": np_tree(gp),
                                    "batch_stats": variables["batch_stats"]})
    after = weights.model_state_dict({"params": variables["params"],
                                      "batch_stats": np_tree(
                                          upd["batch_stats"])})
    sd = tmodel.state_dict()
    largest = max(float(gsd[k].norm()) for k, _ in
                  tmodel.named_parameters() if k.startswith("acm."))
    n = 0
    for k, p in tmodel.named_parameters():
        if not k.startswith("acm."):
            assert p.grad is None, k        # the trunk and TTM: not used
            continue
        if k in ZERO_GRAD:
            assert float(p.grad.norm()) <= 1e-6 * largest, k
            assert float(gsd[k].norm()) <= 1e-6 * largest, k
        else:
            assert _rel(p.grad, gsd[k]) <= 1e-3, k
        n += 1
    assert n == 15
    for k in (k for k in sd if k.startswith("acm.") and "running_" in k):
        assert _rel(sd[k], after[k]) <= 1e-5, k


# -- one masked SGD step against the JAX Learner ------------------------------

WAY, SHOT, QUERIES, IMG, PX, CLASSES = 2, 1, 2, 64, 96, 6
S, Q = WAY * SHOT, WAY * QUERIES
CFG = {
    "MODEL": {"NAME": "ta2n", "BACKBONE": "test-tiny-resnet", "SEED": 3,
              "METRIC": "otam", "DROPOUT": 0.5},
    "TRAIN": {"WAY": WAY, "SHOT": SHOT, "QUERY_PER_CLASS": QUERIES,
              "TASKS_PER_BATCH": 2, "TRAIN_EPISODES": 2, "VAL_FREQ": 0,
              "PRINT_FREQ": 100},
    "TEST": {"QUERY_PER_CLASS": 1, "TEST_EPISODES": 2},
    "DATA": {"DATASET": "ucf", "IMG_SIZE": IMG, "SEQ_LEN": T},
    "SOLVER": {"LR": 1e-3, "LR_SCH": 10 ** 6, "OPTIM_METHOD": "sgd",
               "WEIGHT_DECAY": 1e-3, "MOMENTUM": 0.9},
    "USE_AMP": False,
}
# Tolerances, fp32 on the CPU. The loss to 1e-4 relative; BatchNorm running
# stats (the trunk's, TTM's twice, ACM's) to 1e-4 relative (their inputs
# carry the trunk's fp32 differences; measured <= 1.3e-5); the summed
# gradient (SGD's momentum buffer, g + wd * p after one step) is
# ill-conditioned, as every convolution feeds a BatchNorm: each tensor to
# 1e-2 relative, the parameters' update (-LR * buffer) the same.
LOSS_REL, STATS_REL, GRAD_REL = 1e-4, 1e-4, 1e-2


def _episodes(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        classes = rng.choice(CLASSES, WAY, replace=False).astype(np.int32)
        sl = rng.permutation(np.repeat(np.arange(WAY), SHOT)).astype(np.int32)
        tl = rng.permutation(np.repeat(np.arange(WAY), QUERIES)).astype(
            np.int32)
        base = rng.integers(0, 256, (S + Q, 1, 1, 1, 3))
        noise = rng.integers(0, 256, (S + Q, T, PX, PX, 3))
        frames = (0.8 * base + 0.2 * noise).astype(np.uint8)
        out.append(dict(
            support_images=frames[:S], support_labels=sl,
            target_images=frames[S:], target_labels=tl,
            real_support_labels=classes[sl], real_target_labels=classes[tl],
            batch_class_list=classes))
    return out


@pytest.fixture(scope="module")
def sgd_steps():
    """The JAX learner's and the port's learner after one masked step from
    the same weights (dropout off, the eval transform on both sides)."""
    eps = _episodes(0, 2)
    model = jta2n.TA2NModel(way=WAY, shot=SHOT, seq_len=T, arch="resnet18",
                            backbone_width=8, metric="otam")
    variables = _jax_variables(
        model, np.zeros((S, T, IMG, IMG, 3), np.float32),
        np.zeros((Q, T, IMG, IMG, 3), np.float32),
        np.arange(S, dtype=np.int32) % WAY)
    # a small warp (a = tanh(1), |b| < 0.1): every warped frame stays inside
    # the clip. A frame warped out of it is all zeros, where the norm's
    # gradient is 0/0: NaN in JAX, 0 in torch
    loc = variables["params"]["ttm"]["loc_fc2"]
    loc["kernel"] = np.random.default_rng(7).normal(
        0, 0.01, loc["kernel"].shape).astype(np.float32)
    loc["bias"] = np.asarray([1.0, 0.0], np.float32)
    zeros = np.zeros((1, 1), np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(jlearner_mod, "episode_device_transform",
                   lambda images, rng, *, train, **kw:
                   jtf.episode_device_transform(images, rng, train=False,
                                                **kw))
        jl = jlearner_mod.Learner(
            JConfig(CFG), model, jax.tree_util.tree_map(jnp.asarray,
                                                        variables),
            text_train=zeros, text_test=zeros,
            transform=JSpec(img_size=IMG, resize_to=PX))
        jmetrics = jl.train_episodes([JEpisode(**e) for e in eps],
                                     n_valid=1)
    st = jl.state
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    stats = np_tree(st.batch_stats)
    trace = next(s for s in st.opt_state if hasattr(s, "trace")).trace
    want = dict(metrics=jmetrics, episode=int(st.episode),
                before=weights.model_state_dict(variables),
                after=weights.model_state_dict(
                    {"params": np_tree(st.params), "batch_stats": stats}),
                trace=weights.model_state_dict(
                    {"params": np_tree(trace), "batch_stats": stats}))

    tmodel = build_model(ConfigNode(CFG))
    tmodel.load_state_dict(want["before"], strict=True)
    tmodel.feat_dropout.p = 0.0
    tl = Learner(ConfigNode(CFG), tmodel, torch.zeros(1, 1),
                 torch.zeros(1, 1), torch.device("cpu"),
                 transform=ttf.TransformSpec(img_size=IMG, resize_to=PX))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlearner_mod, "episode_device_transform",
                   lambda images, *, train, gen=None, **kw:
                   ttf.episode_device_transform(images, train=False, **kw))
        got = tl.train_episodes([Episode(**e) for e in eps], n_valid=1)
    return want, tl, got


def test_one_masked_sgd_step_loss_and_stats_match_jax(sgd_steps):
    want, learner, got = sgd_steps
    np.testing.assert_allclose(got["loss"], want["metrics"]["loss"],
                               rtol=LOSS_REL)
    assert got["acc"] == want["metrics"]["acc"]
    assert learner.episode == want["episode"] == 1
    sd = learner.model.state_dict()
    running = [k for k in want["after"] if "running_" in k]
    assert len(running) == 2 * (20 + 4)      # trunk 20, TTM 2, ACM 2
    for k in running:
        assert not torch.equal(want["after"][k], want["before"][k]), k
        assert _rel(sd[k], want["after"][k]) <= STATS_REL, k


def test_one_masked_sgd_step_momentum_and_params_match_jax(sgd_steps):
    want, learner, _ = sgd_steps
    n = 0
    for k, p in learner.model.named_parameters():
        buf = learner.optimizer.state[p]["momentum_buffer"]
        assert _rel(buf, want["trace"][k]) <= GRAD_REL, k
        assert _rel(p.detach() - want["before"][k],
                    want["after"][k] - want["before"][k]) <= GRAD_REL, k
        n += 1
    assert n == len([k for k in want["trace"] if "running_" not in k
                     and not k.endswith("num_batches_tracked")])


# -- the CLI: train, checkpoint, restore --------------------------------------

@pytest.mark.parametrize("metric", ["cos", "otam"])
def test_cli_trains_ta2n_checkpoints_and_restores(metric, tmp_path):
    root = str(tmp_path)
    make_dataset(root, classes=4, videos=4, frames=6, size=PX,
                 dataset="ucf", img_size=IMG, seq_len=T)
    ckpt = os.path.join(root, "ckpt")
    flags = ["--cfg", UCF_TA2N, "--splits-root", root, "--device", "cpu"]
    common = [f"DATA.DATA_DIR={root}", "MODEL.BACKBONE=test-tiny-resnet",
              f"MODEL.METRIC={metric}", "USE_AMP=false", f"DATA.IMG_SIZE={IMG}",
              f"DATA.SEQ_LEN={T}", "TRAIN.WAY=2", "TRAIN.QUERY_PER_CLASS=2",
              "TEST.TEST_EPISODES=4", "DATA.NUM_WORKERS=2",
              f"CHECKPOINT.CHECKPOINT_DIR={ckpt}"]
    res = port_cli([*flags, *common, "TRAIN.TASKS_PER_BATCH=4",
                    "TRAIN.TRAIN_EPISODES=8", "TRAIN.VAL_FREQ=4",
                    "TRAIN.PRINT_FREQ=4"])
    assert res["episodes"] == 8
    with open(os.path.join(ckpt, "log.txt")) as f:
        log = f.read()
    tasks = re.findall(r"Task \[(\d+)/8\], Train Loss: (\S+),", log)
    assert [int(t) for t, _ in tasks] == [4, 8]
    assert all(np.isfinite(float(v)) for _, v in tasks)
    assert len(re.findall(r"Val @ 4: acc", log)) == 1
    best = os.path.join(ckpt, "checkpoint_best", "checkpoint.pt")
    saved = torch.load(best, weights_only=True)
    assert any("ttm.loc_bn2.running_var" in k for k in saved["model"])

    out = port_cli([*flags, *common, "TEST.ONLY_TEST=true"])
    assert np.isfinite(out["loss"])
    with open(os.path.join(ckpt, "log.txt")) as f:
        log = f.read()
    assert f"Loaded checkpoint_best from {ckpt}" in log


def test_train_encode_chunk_on_a_batchnorm_trunk_raises():
    opts = ["MODEL.TRAIN_ENCODE_CHUNK=40"]
    with pytest.raises(ValueError, match="BatchNorm"):
        build_model(load_config(UCF_TA2N, opts=opts))
    with pytest.raises(ValueError, match="BatchNorm"):
        jax_build_model(jax_load(UCF_TA2N, opts=opts))
    with pytest.raises(ValueError, match="BatchNorm"):
        port_cli(["--cfg", UCF_TA2N, "--device", "cpu", *opts])
