"""The port's temporal-excitation blocks and temporal ResNets against the
JAX package (fp32), weights carried through ``weights.py``.

Each branch (CE, GTE, LTE, SE), ``Blk`` and the temporal bottleneck on
``[N*T, H, W, C]`` frames: the eval forward with random BatchNorm
parameters and statistics, then a train-mode forward (outputs, the
BatchNorm running statistics after it) and its gradients against a random
cotangent. Forwards and statistics within 1e-5 of the largest value;
gradients 1e-4 relative L2 a tensor, 1e-2 where the gradient runs through
a train-mode BatchNorm (every branch but CE). ``TorchResNet`` (ResNet-50
at width 8) with ``temporal_blocks`` ``"bottleneck"`` and ``"stage"``: the
eval forward within 1e-5 of the largest value, and a train-mode forward
with its running statistics, relative L2 1e-2 (the bound of a gradient
through BatchNorm): the trunk's train-mode BatchNorms normalise 8 to 32
values a channel, which makes its train forward ill-conditioned. Measured
against the port's fp64 forward (bottleneck, stage): the port's fp32 is
9.6e-4 and 1.0e-4 from it, the JAX package's fp32 3.9e-3 and 4.9e-4; the
two fp32 forwards 3.6e-3 and 5.0e-4 apart. A wrong layout or axis is off
by O(1).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipspm_tpu.models.backbones import temporal_excitation as jte
from clipspm_tpu.models.backbones.resnet import TVBottleneck as JBottleneck
from clipspm_tpu.models.backbones.resnet import TorchResNet as JResNet
from clipspm_tpu_torch import weights
from clipspm_tpu_torch.models.backbones import temporal_excitation as tte
from clipspm_tpu_torch.models.backbones.resnet import (TorchResNet,
                                                       TVBottleneck)

torch.set_num_threads(2)

T = 4
BRANCHES = {"CE": 1e-4, "GTE": 1e-2, "LTE": 1e-2, "SE": 1e-2, "Blk": 1e-2}


def _random(tree, rng):
    """Seeded values of the shapes of a flax tree: kernels N(0, 1/fan_in),
    biases N(0, 0.1), BatchNorm scales U(0.5, 1.5), running means N(0,
    0.2) and variances U(0.5, 2)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random(v, rng)
            continue
        shape = v.shape
        if k == "kernel":
            a = rng.normal(0, math.prod(shape[:-1]) ** -0.5, shape)
        elif k == "var":
            a = rng.uniform(0.5, 2.0, shape)
        elif k == "scale":
            a = rng.uniform(0.5, 1.5, shape)
        elif k == "mean":
            a = rng.normal(0, 0.2, shape)
        else:
            a = rng.normal(0, 0.1, shape)
        out[k] = a.astype(np.float32)
    return out


def _variables(module, x, seed=0):
    """Random variables of ``module``'s tree (``jax.eval_shape`` of its
    init: no compute)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    rng = np.random.default_rng(seed + 100)
    return {"params": _random(shapes["params"], rng),
            "batch_stats": _random(shapes.get("batch_stats", {}), rng)}


def _close_of_max(got, want, tol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _rel(got, want) -> float:
    got, want = torch.as_tensor(np.asarray(got)), torch.as_tensor(
        np.asarray(want))
    return float((got - want).norm() / want.norm())


def _stats(model) -> dict:
    return {k: v for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _check_train_step(jm, variables, tm, to_state, x, grad_tol):
    """One train-mode forward of both (outputs, BatchNorm statistics after
    it) and the gradients of ``sum(y * ct)`` for every parameter and the
    input."""
    ct = np.random.default_rng(9).normal(size=x.shape[:1] + tuple(
        tm.eval()(torch.from_numpy(x)).shape[1:])).astype(np.float32)

    def loss(params, xx):
        y, upd = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          xx, train=True, mutable=["batch_stats"])
        return (y * ct).sum(), (y, upd.get("batch_stats", {}))

    (_, (want, upd)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables["params"],
                                             jnp.asarray(x))
    tm.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tm(xt)
    _close_of_max(got.detach().numpy(), want, 1e-5, "train forward")
    (got * torch.from_numpy(ct)).sum().backward()
    want_state = to_state(jax.tree_util.tree_map(np.asarray,
                                                 variables["params"]),
                          jax.tree_util.tree_map(np.asarray, upd))
    stats = _stats(tm)
    assert bool(stats) == bool(variables["batch_stats"])
    for k, v in stats.items():
        _close_of_max(v.numpy(), want_state[k].numpy(), 1e-5, k)
    grads = to_state(jax.tree_util.tree_map(np.asarray, gp),
                     jax.tree_util.tree_map(np.asarray,
                                            variables["batch_stats"]))
    named = dict(tm.named_parameters())
    assert named
    for k, p in named.items():
        assert _rel(p.grad, grads[k]) <= grad_tol, (k, _rel(p.grad,
                                                            grads[k]))
    assert _rel(xt.grad, gx) <= grad_tol


def _branch(name, c):
    return getattr(jte, name)(c, seq_len=T), getattr(tte, name)(c, seq_len=T)


def _branch_state(params, stats):
    return weights.head_state_dict(params, stats=stats)


@pytest.mark.parametrize("name", sorted(BRANCHES))
def test_branch_eval_and_train_match_jax(name):
    C = 10 if name == "Blk" else 3     # Blk: quarters 2, 2, 2 and SE's 4
    x = np.random.default_rng(1).normal(size=(2 * T, 5, 5, C)).astype(
        np.float32)
    jm, tm = _branch(name, C)
    variables = _variables(jm, x)
    tm.load_state_dict(_branch_state(variables["params"],
                                     variables["batch_stats"]), strict=True)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert got.shape == x.shape
    _close_of_max(got.numpy(), want, 1e-5, "eval forward")
    _check_train_step(jm, variables, tm, _branch_state, x, BRANCHES[name])


def test_frames_that_are_not_whole_clips_raise():
    with pytest.raises(ValueError, match="whole clips"):
        tte.Blk(8, seq_len=T)(torch.zeros(2 * T + 1, 3, 3, 8))


def test_temporal_bottleneck_matches_jax():
    """``TVBottleneck(temporal=True)``: its ``blk`` and ``bn4`` between the
    3x3 and the last 1x1 convolution, with a strided downsample."""
    x = np.random.default_rng(3).normal(size=(2 * T, 8, 8, 8)).astype(
        np.float32)
    jm = JBottleneck(4, stride=2, temporal=True, seq_len=T)
    variables = _variables(jm, x)
    tm = TVBottleneck(8, 4, stride=2, temporal=True, seq_len=T)
    state = weights.head_state_dict(variables["params"],
                                    stats=variables["batch_stats"])
    state = {k.replace("down_conv", "downsample.0").replace(
        "down_bn", "downsample.1"): v for k, v in state.items()}
    tm.load_state_dict(state, strict=True)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close_of_max(got.permute(0, 2, 3, 1).numpy(), want, 1e-5, "eval")

    class NHWC(torch.nn.Module):
        def __init__(self, block):
            super().__init__()
            self.block = block

        def forward(self, x):
            return self.block(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def to_state(params, stats):
        return {f"block.{k}": v for k, v in weights.head_state_dict(
            params, stats=stats).items()}

    wrapped = NHWC(tm)
    wrapped.load_state_dict({f"block.{k}": v for k, v in state.items()})
    _check_train_step(jm, variables, wrapped,
                      lambda p, s: {k.replace("down_conv", "downsample.0")
                                    .replace("down_bn", "downsample.1"): v
                                    for k, v in to_state(p, s).items()},
                      x, 1e-2)


def _trunk_state(params, stats):
    return weights.torchvision_resnet_state_dict(params, stats)


@pytest.mark.parametrize("mode", ["bottleneck", "stage"])
def test_temporal_trunk_matches_jax(mode):
    x = np.random.default_rng(2).uniform(size=(2 * T, 64, 64, 3)).astype(
        np.float32)
    jm = JResNet(arch="resnet50", width=8, temporal_blocks=mode, seq_len=T)
    variables = _variables(jm, x)
    tm = TorchResNet(arch="resnet50", width=8, temporal_blocks=mode,
                     seq_len=T)
    tm.load_state_dict(_trunk_state(variables["params"],
                                    variables["batch_stats"]), strict=True)
    blks = [k for k in tm.state_dict() if ".blk." in k or "blk_" in k]
    if mode == "bottleneck":
        assert "layer1.0.blk.gte.conv1.weight" in blks
        assert "layer4.2.bn4.running_var" in tm.state_dict()
    else:
        assert {k.split(".")[0] for k in blks} == {"blk_1", "blk_2"}
        assert "layer1.0.bn4.weight" not in tm.state_dict()
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
        assert got.shape == want.shape == (2 * T, 2, 2, tm.feature_dim)
        _close_of_max(got.numpy(), want, 1e-5, "eval forward")
        want, upd = jax.jit(lambda v, xx: jm.apply(
            v, xx, train=True, mutable=["batch_stats"]))(variables,
                                                          jnp.asarray(x))
        got = tm.train()(torch.from_numpy(x))
    assert _rel(got, want) <= 1e-2
    after = _trunk_state(variables["params"], jax.tree_util.tree_map(
        np.asarray, upd["batch_stats"]))
    stats = _stats(tm)
    assert len(stats) == len([k for k in after if "running" in k])
    for k, v in stats.items():
        assert _rel(v, after[k]) <= 1e-2, k


def test_unknown_temporal_mode_raises():
    with pytest.raises(ValueError, match="temporal_blocks"):
        TorchResNet(temporal_blocks="frames")
