"""The port's clipfsar, sten and cpm2c models against the JAX package at
``test-tiny`` (the ViT tower at 32 px), weights carried by
``weights.model_state_dict``: the eval forward in every branch (fp32,
1e-5), ``encode`` + ``match_features`` against ``forward``, the head's
train-mode parameter and feature gradients with dropout off (1e-4
relative), and each loss branch of the dispatch in both modes."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipspm_tpu.models.backbones.clip import CLIP_ARCHS as J_ARCHS
from clipspm_tpu.models.heads.clipfsar import CLIPFSARModel as JCLIPFSAR
from clipspm_tpu.models.heads.cpm2c import CPM2CModel as JCPM2C
from clipspm_tpu.models.heads.sten import STENModel as JSTEN
from clipspm_tpu.train import losses as jlosses
from clipspm_tpu.utils.config import ConfigNode as JConfig
from clipspm_tpu.utils.config import SPM_DEFAULT_PARAMS
from clipspm_tpu_torch import weights
from clipspm_tpu_torch.models.backbones.clip import CLIP_ARCHS
from clipspm_tpu_torch.models.heads.clipfsar import CLIPFSARModel
from clipspm_tpu_torch.models.heads.cpm2c import CPM2CModel
from clipspm_tpu_torch.models.heads.sten import STENModel
from clipspm_tpu_torch.train import losses as tlosses
from clipspm_tpu_torch.utils.config import ConfigNode

torch.set_num_threads(2)

WAY, QUERIES, T, IMG, CLASSES = 2, 2, 4, 32, 6
D = J_ARCHS["test-tiny"].embed_dim
PARAMS = dict(SPM_DEFAULT_PARAMS["hmdb"])
MODELS = {"clipfsar": (JCLIPFSAR, CLIPFSARModel),
          "cpm2c": (JCPM2C, CPM2CModel), "sten": (JSTEN, STENModel)}
# (head, constructor flags, shot): every branch the configs can reach.
# cpm2c's MERGE_BEFORE needs 1 shot: its global distance gathers class-merged
# rows by the support labels (a permutation at 1 shot, an error at more, in
# both packages)
CASES = [
    ("clipfsar", {}, 2),
    ("clipfsar", {"eval_text": True}, 2),
    ("clipfsar", {"combine": True, "text_coff": 0.7}, 2),
    ("clipfsar", {"merge_before": True}, 2),
    ("clipfsar", {"single_direct": True}, 2),
    ("cpm2c", {}, 2),
    ("cpm2c", {"merge_before": True}, 1),
    ("cpm2c", {"use_contrastive": True}, 2),
    ("cpm2c", {"motion_coeff": 0.0, "normal_coeff": 1.0}, 2),
    ("sten", {}, 2),
]
# the train-mode gradient cases (EVAL_TEXT and COMBINE are eval-only)
GRAD_CASES = [c for c in CASES
              if not ({"eval_text", "combine"} & set(c[1]))]
# the loss dispatch's cfg: clipfsar's classification weight, cpm2c's LMD
# with the global stream on (so every cpm2c output reaches the loss)
CFG = {"MODEL": {"USE_CLASSIFICATION_VALUE": 1.5, "LMD": [0.5, 1.0, 0.5]},
       "params": PARAMS}


def _ids(case):
    name, flags, shot = case
    return "-".join([name, *(sorted(flags) or ["default"]), f"shot{shot}"])


def _models(name, flags, shot):
    jcls, tcls = MODELS[name]
    extra = {"params": PARAMS} if name == "cpm2c" else {}
    jm = jcls(arch=J_ARCHS["test-tiny"], way=WAY, shot=shot, **extra,
              **flags)
    tm = tcls(arch=CLIP_ARCHS["test-tiny"], way=WAY, shot=shot, **extra,
              **flags)
    return jm, tm


def _inputs(shot, seed=0):
    """frames, labels and text tables of one episode (numpy)."""
    rng = np.random.default_rng(seed)
    S, Q = WAY * shot, WAY * QUERIES
    sl = rng.permutation(np.repeat(np.arange(WAY), shot)).astype(np.int32)
    tl = rng.permutation(np.repeat(np.arange(WAY), QUERIES)).astype(np.int32)
    classes = rng.choice(CLASSES, WAY, replace=False).astype(np.int32)
    text = rng.normal(size=(2, CLASSES, D)).astype(np.float32)
    return dict(
        frames=(rng.uniform(size=(S, T, IMG, IMG, 3)).astype(np.float32),
                rng.uniform(size=(Q, T, IMG, IMG, 3)).astype(np.float32)),
        labels=(sl, classes[sl], classes[tl]), target=tl,
        text=(text[0], text[1]))


def _jax_args(x):
    return [jnp.asarray(a) for a in (*x["frames"], *x["labels"],
                                     *x["text"])]


def _port_args(x):
    return [torch.from_numpy(a) for a in (*x["frames"], *x["labels"],
                                          *x["text"])]


def _carried(name, flags, shot):
    """The JAX model, its variables, and the port's model holding them."""
    jm, tm = _models(name, flags, shot)
    # in train mode, where every branch builds its parameters (flax creates
    # them where they are first called: EVAL_TEXT's eval forward never
    # calls context2)
    key = jax.random.PRNGKey(1)
    variables = jm.init({"params": key, "dropout": key},
                        *_jax_args(_inputs(shot)), train=True)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tm.load_state_dict(weights.model_state_dict({"params": params}),
                       strict=True)
    return jm, variables, tm


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_eval_forward_matches_jax(case):
    name, flags, shot = case
    jm, variables, tm = _carried(*case)
    x = _inputs(shot, seed=3)
    want = jm.apply(variables, *_jax_args(x), train=False)
    with torch.no_grad():
        got = tm.eval()(*_port_args(x))
    assert set(got) == set(want)
    assert got["logits"].shape == (1, WAY * QUERIES, WAY)
    for key in want:
        _close(got[key].numpy(), want[key], 1e-5, key)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_encode_then_match_features_is_forward(name):
    _, _, tm = _carried(name, {}, 2)
    x = _port_args(_inputs(2, seed=4))
    tm.eval()
    with torch.no_grad():
        want = tm(*x)
        su, qu = tm.encode(x[0]), tm.encode(x[1])
        assert su.shape == (WAY * 2, T, D) and tm.feature_cacheable()
        got = tm.match_features(su, qu, *x[2:])
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=1e-6, atol=1e-6)


def _rel(got, want) -> float:
    got, want = torch.as_tensor(np.asarray(got)), torch.as_tensor(
        np.asarray(want))
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("case", GRAD_CASES, ids=_ids)
def test_train_gradients_match_jax(case):
    """The head in train mode over per-frame features, dropout off on both
    sides (flax's Dropout the identity, the port's rates 0): the gradient
    of the dispatch's train loss for every head parameter and both feature
    inputs, to 1e-4 relative (fp32)."""
    name, flags, shot = case
    jm, variables, tm = _carried(*case)
    x = _inputs(shot, seed=5)
    rng = np.random.default_rng(6)
    feats = [rng.normal(size=(n, T, D)).astype(np.float32)
             for n in (WAY * shot, WAY * QUERIES)]
    labels, text, tl = x["labels"], x["text"], x["target"]
    jcfg = JConfig(CFG)

    def loss(params, su, qu):
        out = jm.apply({"params": params}, su, qu,
                       *[jnp.asarray(a) for a in (*labels, *text)],
                       train=True, method="match_features",
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return jlosses.loss_and_acc(
            name, out, jnp.asarray(tl), jnp.asarray(labels[1]),
            jnp.asarray(labels[2]), 2, cfg=jcfg, train=True)[0]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        want_loss, (gp, gsu, gqu) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2)))(variables["params"],
                                      *map(jnp.asarray, feats))

    tm.train()
    drops = [m for m in tm.modules() if isinstance(m, torch.nn.Dropout)]
    assert len(drops) == (0 if name == "sten" else 2)
    for m in drops:
        m.p = 0.0
    su, qu = [torch.from_numpy(f).requires_grad_(True) for f in feats]
    out = tm.match_features(su, qu, *[torch.from_numpy(a)
                                      for a in (*labels, *text)])
    got_loss, _ = tlosses.loss_and_acc(
        name, out, torch.from_numpy(tl), torch.from_numpy(labels[1]),
        torch.from_numpy(labels[2]), 2, cfg=ConfigNode(CFG), train=True)
    got_loss.backward()
    _close(got_loss.item(), want_loss, 1e-5, "loss")
    assert _rel(su.grad, gsu) <= 1e-4 and _rel(qu.grad, gqu) <= 1e-4
    grads = weights.model_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, gp)})
    head = [(k, p) for k, p in tm.named_parameters()
            if not k.startswith("backbone.")]
    assert len(head) == len([k for k in grads
                             if not k.startswith("backbone.")])
    for k, p in head:
        if not grads[k].any():
            # a stream weighted 0 (hmdb's MOTION_COFF): no gradient in both
            assert not p.grad.any(), k
            continue
        assert _rel(p.grad, grads[k]) <= 1e-4, k


def _outputs(name, rng, n_sup, n_tgt):
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    if name == "cpm2c":
        return {"logits_local": f32(1, n_tgt, WAY),
                "logits_global": f32(1, n_tgt, WAY),
                "logits": f32(1, n_tgt, WAY),
                "class_logits": f32(1, n_sup + n_tgt, CLASSES),
                "target_consist_distance": np.float32(rng.uniform(1, 9))}
    out = {"logits": f32(1, n_tgt, WAY)}
    if name == "clipfsar":
        out["class_logits"] = f32(1, n_sup + n_tgt, CLASSES)
    return out


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name,cfg", [
    ("clipfsar", CFG),
    ("cpm2c", CFG),
    ("cpm2c", {"MODEL": {}, "params": {**PARAMS, "lambdas0": 0.3,
                                       "lambdas2": 0.25}}),
    ("sten", {"MODEL": {}}),
], ids=["clipfsar", "cpm2c-LMD", "cpm2c-params-lambdas", "sten"])
def test_loss_branches_match_jax(name, cfg, train):
    rng = np.random.default_rng(7)
    n_sup, n_tgt = 4, 6
    outs = _outputs(name, rng, n_sup, n_tgt)
    tl = rng.integers(0, WAY, n_tgt).astype(np.int32)
    rs = rng.integers(0, CLASSES, n_sup).astype(np.int32)
    rt = rng.integers(0, CLASSES, n_tgt).astype(np.int32)
    jl, ja = jlosses.loss_and_acc(
        name, {k: jnp.asarray(v) for k, v in outs.items()}, jnp.asarray(tl),
        jnp.asarray(rs), jnp.asarray(rt), 16, cfg=JConfig(cfg), train=train)
    tl_, ta = tlosses.loss_and_acc(
        name, {k: torch.as_tensor(v) for k, v in outs.items()},
        torch.from_numpy(tl), torch.from_numpy(rs), torch.from_numpy(rt), 16,
        cfg=ConfigNode(cfg), train=train)
    np.testing.assert_allclose(tl_.item(), float(jl), rtol=1e-6, atol=1e-6)
    assert ta.item() == float(ja)
