"""Port TA2N head against the JAX package (fp32, eval): the temporal warp,
the masks, TTM, ACM and the whole model at both metrics.

``test-tiny-resnet`` (ResNet-18 at width 8) at a 64-px crop gives 2x2 maps,
so ``gen_mask``'s real branch runs. The JAX initialisation leaves TTM's and
ACM's last Dense kernels at zero, which would make the warp and the offsets
constant; the parity tests draw those kernels, every bias and every
BatchNorm at random so that each path matters. Tolerance: fp32 on both
sides, sums in another order (XLA vs oneDNN), 1e-4 relative and absolute;
1e-3 after ``DIST_NORM``'s LayerNorm (see the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipspm_tpu.models.heads import ta2n as jta2n
from clipspm_tpu_torch import weights
from clipspm_tpu_torch.models.heads import ta2n as tta2n

from test_torch_resnet import _randomize_norms

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
LN_TOL = dict(rtol=1e-3, atol=1e-3)
WAY, T, PX, C = 3, 4, 64, 16


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _jax_variables(module, *args, seed=0, **kwargs):
    """flax init, then random norms, biases and the zero-initialised
    offset/warp kernels; numpy trees ``{params, batch_stats}``."""
    v = _np_tree(module.init(jax.random.PRNGKey(seed),
                             *[jnp.asarray(a) for a in args], **kwargs))
    rng = np.random.default_rng(seed + 100)
    params = _randomize_norms(v["params"], rng)

    def draw(node):
        for k, sub in node.items():
            if k in ("loc_fc2", "mv_fc2"):
                sub["kernel"] = rng.normal(0, 0.5, sub["kernel"].shape
                                           ).astype(np.float32)
            elif isinstance(sub, dict):
                draw(sub)

    draw(params)
    out = {"params": params}
    if "batch_stats" in v:
        out["batch_stats"] = _randomize_norms(v["batch_stats"], rng,
                                              stats=True)
    return out


def _apply(module, variables, *args, **kwargs):
    return module.apply(variables, *[jnp.asarray(a) for a in args],
                        **kwargs)


def test_temporal_grid_sample_matches_jax():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(3, 6, 2, 2, 5)).astype(np.float32)
    # beyond [-1, 1] too: the zero padding outside the clip
    coords = rng.uniform(-1.4, 1.4, size=(3, 6)).astype(np.float32)
    coords[0] = np.linspace(-1, 1, 6)      # the exact frame positions
    got = tta2n.temporal_grid_sample(torch.from_numpy(feats),
                                     torch.from_numpy(coords)).numpy()
    want = np.asarray(jta2n.temporal_grid_sample(jnp.asarray(feats),
                                                 jnp.asarray(coords)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("L", [1, 3])
def test_gen_mask_matches_jax(L):
    off = np.random.default_rng(1).uniform(-1.2, 1.2, size=(4, 5, 2)).astype(
        np.float32)
    got = tta2n.gen_mask(torch.from_numpy(off), L).numpy()
    want = np.asarray(jta2n.gen_mask(jnp.asarray(off), L))
    assert got.shape == want.shape == (4, 5, L, L)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_ttm_matches_jax():
    feats = np.random.default_rng(2).normal(size=(3, T, 2, 2, C)).astype(
        np.float32)
    jttm = jta2n.TTM(seq_len=T)
    variables = _jax_variables(jttm, feats)
    want = np.asarray(_apply(jttm, variables, feats, train=False))
    tttm = tta2n.TTM(T, C).eval()
    tttm.load_state_dict(weights.head_state_dict(
        variables["params"], stats=variables["batch_stats"]), strict=True)
    with torch.no_grad():
        got = tttm(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_acm_matches_jax():
    rng = np.random.default_rng(3)
    sup = rng.normal(size=(WAY, T, 2, 2, C)).astype(np.float32)
    qry = rng.normal(size=(2, T, 2, 2, C)).astype(np.float32)
    jacm = jta2n.ACM(seq_len=T, dim=C)
    variables = _jax_variables(jacm, sup, qry)
    want_pairs, want_off = _apply(jacm, variables, sup, qry, train=False)
    tacm = tta2n.ACM(C).eval()
    tacm.load_state_dict(weights.head_state_dict(
        variables["params"], stats=variables["batch_stats"]), strict=True)
    with torch.no_grad():
        pairs, off = tacm(torch.from_numpy(sup), torch.from_numpy(qry))
    assert pairs.shape == (WAY, 2, T, 2 * C)
    # the drawn mv_fc2 kernel makes the offsets, hence the masks, matter
    assert np.abs(np.asarray(want_off)).max() > 0.05
    np.testing.assert_allclose(off.numpy(), np.asarray(want_off), **TOL)
    np.testing.assert_allclose(pairs.numpy(), np.asarray(want_pairs), **TOL)


def _episode(shot, queries, seed):
    rng = np.random.default_rng(seed)
    S, Q = WAY * shot, WAY * queries

    def frames(n):
        # a colour per video plus noise: videos of i.i.d. noise alone give
        # near-collinear features, whose 1 - cos is all rounding
        base = rng.uniform(size=(n, 1, 1, 1, 3))
        noise = rng.uniform(size=(n, T, PX, PX, 3))
        return (0.8 * base + 0.2 * noise).astype(np.float32)

    labels = rng.permutation(np.repeat(np.arange(WAY), shot)).astype(np.int32)
    return frames(S), frames(Q), labels


def _models(shot, metric, dist_norm, ep):
    jmodel = jta2n.TA2NModel(way=WAY, shot=shot, seq_len=T, arch="resnet18",
                             backbone_width=8, dist_norm=dist_norm,
                             metric=metric)
    variables = _jax_variables(jmodel, *ep)
    tmodel = tta2n.TA2NModel(way=WAY, shot=shot, seq_len=T, arch="resnet18",
                             backbone_width=8, dist_norm=dist_norm,
                             metric=metric).eval()
    tmodel.load_state_dict(weights.model_state_dict(variables), strict=True)
    return jmodel, variables, tmodel


@pytest.mark.parametrize("dist_norm", [False, True])
@pytest.mark.parametrize("shot", [1, 2])
@pytest.mark.parametrize("metric", ["cos", "otam"])
def test_model_forward_and_cached_route_match_jax(metric, shot, dist_norm):
    ep = _episode(shot, queries=2 if shot == 1 else 1, seed=4 + shot)
    jmodel, variables, tmodel = _models(shot, metric, dist_norm, ep)
    want = np.asarray(_apply(jmodel, variables, *ep, train=False)["logits"])
    sup, tgt, labels = (torch.from_numpy(a) for a in ep)
    with torch.no_grad():
        got = tmodel(sup, tgt, labels)["logits"].numpy()
        su, qu = tmodel.encode(sup), tmodel.encode(tgt)
        cached = tmodel.match_features(su, qu, labels)["logits"].numpy()
    assert got.shape == want.shape == (1, tgt.shape[0], WAY)
    if dist_norm:
        # the LayerNorm divides by the spread of WAY logits (a few 1e-3 on
        # random weights), which scales fp32 rounding up ~200x: hold the
        # logits before it at TOL and after it at LN_TOL
        raw = tta2n.TA2NModel(way=WAY, shot=shot, seq_len=T, arch="resnet18",
                              backbone_width=8, metric=metric).eval()
        sd = tmodel.state_dict()
        raw.load_state_dict({k: v for k, v in sd.items()
                             if not k.startswith("norm_layer")}, strict=True)
        jraw = jta2n.TA2NModel(way=WAY, shot=shot, seq_len=T,
                               arch="resnet18", backbone_width=8,
                               metric=metric)
        jvars = {"params": {k: v for k, v in variables["params"].items()
                            if k != "norm_layer"},
                 "batch_stats": variables["batch_stats"]}
        with torch.no_grad():
            got_raw = raw(sup, tgt, labels)["logits"].numpy()
        np.testing.assert_allclose(
            got_raw, np.asarray(_apply(jraw, jvars, *ep,
                                       train=False)["logits"]), **TOL)
        np.testing.assert_allclose(got, want, **LN_TOL)
    else:
        np.testing.assert_allclose(got, want, **TOL)
    # the cached route: encode + match_features, the table's [N, T, h, w, D]
    want_su = np.asarray(_apply(jmodel, variables, ep[0], train=False,
                                method="encode"))
    assert su.shape == want_su.shape == (sup.shape[0], T, 2, 2, 64)
    np.testing.assert_allclose(su.numpy(), want_su, **TOL)
    np.testing.assert_allclose(cached, got, **(LN_TOL if dist_norm else
                                               dict(rtol=1e-5, atol=1e-5)))
    assert tmodel.feature_cacheable()


def test_random_init_gives_the_jax_initial_values():
    ep = _episode(2, 1, seed=9)
    jinit = _np_tree(jta2n.TA2NModel(
        way=WAY, shot=2, seq_len=T, arch="resnet18", backbone_width=8,
        dist_norm=True).init(jax.random.PRNGKey(0),
                             *[jnp.asarray(a) for a in ep]))["params"]
    model = tta2n.TA2NModel(way=WAY, shot=2, seq_len=T, arch="resnet18",
                            backbone_width=8, dist_norm=True)
    weights.random_init_(model, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    for path in (("ttm", "loc_fc2"), ("acm", "mv_fc2")):
        jp = jinit[path[0]][path[1]]
        key = ".".join(path)
        np.testing.assert_array_equal(sd[f"{key}.weight"].numpy(),
                                      jp["kernel"].T)
        np.testing.assert_array_equal(sd[f"{key}.bias"].numpy(), jp["bias"])
    np.testing.assert_array_equal(sd["ttm.loc_fc2.bias"].numpy(), [2.0, 0.0])
    # flax defaults elsewhere: zero conv/dense biases, identity norms, and
    # lecun-scaled conv kernels
    for key in ("ttm.loc_conv1.bias", "acm.mv_conv2.bias", "acm.mv_fc1.bias",
                "norm_layer.bias", "acm.mv_bn1.running_mean"):
        assert not sd[key].any(), key
    for key in ("norm_layer.weight", "ttm.loc_bn2.weight",
                "acm.mv_bn1.running_var"):
        assert (sd[key] == 1).all(), key
    w = sd["acm.mv_conv1.weight"]
    assert w.std().item() == pytest.approx(w[0].numel() ** -0.5, rel=0.05)
    assert jinit["acm"]["mv_conv1"]["kernel"].std() == pytest.approx(
        w[0].numel() ** -0.5, rel=0.15)
