"""Port clipspm head and episodic blocks against the JAX package (fp32, eval).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipspm_tpu.models import blocks as jblocks
from clipspm_tpu.models.heads.clipspm import CLIPSPM as JCLIPSPM
from clipspm_tpu.utils.config import SPM_DEFAULT_PARAMS
from clipspm_tpu_torch import weights
from clipspm_tpu_torch.models import blocks as tblocks
from clipspm_tpu_torch.models.heads.clipspm import CLIPSPM as TCLIPSPM

torch.set_num_threads(2)

D, WAY, SHOT, QUERIES, T = 64, 2, 2, 2, 4
S, Q = WAY * SHOT, WAY * QUERIES


def _episode(seed):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    labels = rng.permutation(np.repeat(np.arange(WAY), SHOT)).astype(np.int32)
    return (f32(S, T, D), f32(Q, T, D), labels, f32(S, 1, D), f32(Q, 1, D))


@pytest.mark.parametrize("spm_key", ["hmdb", "ucf"])
def test_head_logits_and_dists_match_jax(spm_key):
    spm = SPM_DEFAULT_PARAMS[spm_key]
    ep = _episode(0)
    jhead = JCLIPSPM(dim=D, way=WAY, shot=SHOT, spm=spm)
    jargs = [jnp.asarray(a) for a in ep]
    variables = jhead.init(jax.random.PRNGKey(1), *jargs)
    want = jhead.apply(variables, *jargs, train=False)

    thead = TCLIPSPM(dim=D, way=WAY, shot=SHOT, spm=spm)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    thead.load_state_dict(weights.head_state_dict(params), strict=True)
    thead.eval()
    with torch.no_grad():
        got = thead(*[torch.from_numpy(a) for a in ep])
    assert got["logits"].shape == (1, Q, WAY)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got["dists"].numpy(),
                               np.asarray(want["dists"]), rtol=1e-4,
                               atol=1e-4)


def test_class_prototypes_and_grouping_with_shuffled_labels():
    rng = np.random.default_rng(4)
    way, shot = 3, 4
    feats = rng.normal(size=(way * shot, 5, 7)).astype(np.float32)
    labels = rng.permutation(np.repeat(np.arange(way), shot)).astype(np.int32)
    np.testing.assert_allclose(
        tblocks.class_prototypes(torch.from_numpy(feats),
                                 torch.from_numpy(labels), way).numpy(),
        np.asarray(jblocks.class_prototypes(jnp.asarray(feats),
                                            jnp.asarray(labels), way)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        tblocks.group_by_class(torch.from_numpy(feats),
                               torch.from_numpy(labels), way, shot).numpy(),
        np.asarray(jblocks.group_by_class(jnp.asarray(feats),
                                          jnp.asarray(labels), way, shot)))


@pytest.mark.parametrize("name", ["clipspm", "otam", "ta2n"])
def test_loss_and_accuracy_match_jax(name):
    from clipspm_tpu.train import losses as jlosses
    from clipspm_tpu_torch.train import losses as tlosses

    rng = np.random.default_rng(6)
    logits = rng.normal(size=(1, 6, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 6).astype(np.int32)
    dists = np.float32(rng.uniform(1, 5))
    zeros = np.zeros(6, np.int32)
    jl, ja = jlosses.loss_and_acc(
        name, {"logits": jnp.asarray(logits), "dists": jnp.asarray(dists)},
        jnp.asarray(labels), jnp.asarray(zeros), jnp.asarray(zeros), 16,
        train=False)
    tl, ta = tlosses.loss_and_acc(
        name, {"logits": torch.from_numpy(logits),
               "dists": torch.tensor(dists)}, torch.from_numpy(labels),
        torch.from_numpy(zeros), torch.from_numpy(zeros), 16, train=False)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6, atol=1e-6)
    assert ta.item() == float(ja)


def test_cos_sim_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 6, 8)).astype(np.float32)
    y = rng.normal(size=(3, 5, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tblocks.cos_sim(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(jblocks.cos_sim(jnp.asarray(x), jnp.asarray(y))),
        rtol=1e-5, atol=1e-5)
