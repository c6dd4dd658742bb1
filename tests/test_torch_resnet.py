"""Port torchvision ResNet trunk against the JAX package's ``TorchResNet``
(fp32, eval BatchNorm), weights carried through ``weights.py``.

The JAX BatchNorm parameters and running statistics are set to random
non-trivial values so the eval-mode normalisation is really exercised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipspm_tpu.models.backbones.resnet import TorchResNet as JResNet
from clipspm_tpu_torch import weights
from clipspm_tpu_torch.models.backbones.resnet import TorchResNet

torch.set_num_threads(2)

# fp32 on both sides; the sums run in another order (XLA vs oneDNN)
TOL = dict(rtol=1e-4, atol=1e-4)


def _randomize_norms(tree, rng, stats=False):
    """BatchNorm scale/bias (params) or mean/var (batch_stats) at random."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_norms(v, rng, stats)
        elif stats and k == "var":
            out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif stats and k == "mean":
            out[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
        elif not stats and k == "scale":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif not stats and k == "bias" and v.ndim == 1:
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def jax_variables(module, x, seed=0):
    """flax init, then random BatchNorm parameters and statistics; returns
    numpy trees ``{params, batch_stats}``."""
    variables = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    rng = np.random.default_rng(seed + 100)
    return {"params": _randomize_norms(to_np(variables["params"]), rng),
            "batch_stats": _randomize_norms(to_np(variables["batch_stats"]),
                                            rng, stats=True)}


@pytest.mark.parametrize("output", ["spatial", "pooled"])
@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_trunk_matches_jax(arch, output):
    x = np.random.default_rng(1).uniform(size=(2, 64, 64, 3)).astype(
        np.float32)
    jnet = JResNet(arch=arch, output=output, width=8)
    variables = jax_variables(jnet, x)
    want = np.asarray(jnet.apply(variables, jnp.asarray(x), train=False))

    tnet = TorchResNet(arch=arch, output=output, width=8).eval()
    tnet.load_state_dict(weights.torchvision_resnet_state_dict(
        variables["params"], variables["batch_stats"]), strict=True)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    assert tnet.feature_dim == jnet.feature_dim
    expect_shape = (2, 2, 2, jnet.feature_dim) if output == "spatial" \
        else (2, jnet.feature_dim)
    assert got.shape == want.shape == expect_shape
    np.testing.assert_allclose(got, want, **TOL)


def test_state_dict_keys_are_torchvisions():
    keys = set(TorchResNet(arch="resnet50", width=8).state_dict())
    for k in ("conv1.weight", "bn1.running_var", "layer1.0.conv3.weight",
              "layer1.0.downsample.0.weight",
              "layer2.0.downsample.1.running_mean", "layer4.2.bn3.bias"):
        assert k in keys
    basic = set(TorchResNet(arch="resnet18", width=8).state_dict())
    assert "layer2.0.downsample.0.weight" in basic
    assert "layer1.0.downsample.0.weight" not in basic
    assert "layer1.0.conv3.weight" not in basic
