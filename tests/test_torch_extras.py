"""The port's last modules against the JAX package: cpm2c's visual prompts
and video adapter, the dormant blocks of ``models/blocks_extra.py``, the
new leaves' weight maps and the tensor-parallel layout of the adapter.

cpm2c at ``test-tiny`` (32 px, way 2, shot 2, T=4) with prompts alone, the
adapter alone and both, weights carried by ``weights.model_state_dict``:
the eval forward (1e-5 of the largest output), the train loss with dropout
off and the gradients of every parameter and both clips (1e-4 relative L2),
``feature_cacheable`` and ``encode``'s refusal, the cached evaluator's loud
fallback to ``Learner.evaluate`` over a ``SyntheticEpisodeSource``, and one
masked TPB=2 Adam step against the JAX ``Learner``'s. Each
``blocks_extra`` module at width 32, forward 1e-5 of the largest output
and gradients 1e-4 relative L2, with ``GroupGLKA``'s ``scale`` and the
motion tokens nonzero.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipspm_tpu.data import transforms as jtf
from clipspm_tpu.data.episode import Episode as JEpisode
from clipspm_tpu.data.synthetic import SyntheticEpisodeSource as JSource
from clipspm_tpu.models import blocks_extra as jbx
from clipspm_tpu.models.backbones.clip import CLIP_ARCHS as J_ARCHS
from clipspm_tpu.models.heads.cpm2c import CPM2CModel as JCPM2C
from clipspm_tpu.parallel.tensor import megatron_specs as jax_specs
from clipspm_tpu.train import learner as jlearner_mod
from clipspm_tpu.train import losses as jlosses
from clipspm_tpu.train.learner import TransformSpec as JSpec
from clipspm_tpu.utils.config import ConfigNode as JConfig
from clipspm_tpu.utils.config import SPM_DEFAULT_PARAMS
from clipspm_tpu_torch import weights
from clipspm_tpu_torch.cli.run import _cached_evaluator
from clipspm_tpu_torch.data import transforms as ttf
from clipspm_tpu_torch.data.episode import Episode
from clipspm_tpu_torch.data.synthetic import SyntheticEpisodeSource
from clipspm_tpu_torch.models import blocks_extra as tbx
from clipspm_tpu_torch.models.backbones.clip import (CLIP_ARCHS,
                                                     ResidualAttentionBlock,
                                                     _Attention)
from clipspm_tpu_torch.models.heads.cpm2c import CPM2CModel
from clipspm_tpu_torch.parallel import tensor as ptensor
from clipspm_tpu_torch.train import learner as tlearner_mod
from clipspm_tpu_torch.train import losses as tlosses
from clipspm_tpu_torch.train.learner import Learner
from clipspm_tpu_torch.utils.config import ConfigNode

torch.set_num_threads(2)

WAY, SHOT, QUERIES, T, IMG, PX, CLASSES = 2, 2, 2, 4, 32, 40, 6
S, Q = WAY * SHOT, WAY * QUERIES
D = J_ARCHS["test-tiny"].embed_dim
PARAMS = {**SPM_DEFAULT_PARAMS["hmdb"], "prompt_patch": 8, "hid_dim": 8}
FLAGS = {"prompts": {"use_visual_prompts": True},
         "adapter": {"use_video_adapter": True},
         "both": {"use_visual_prompts": True, "use_video_adapter": True}}
CFG = {"MODEL": {"USE_CLASSIFICATION_VALUE": 1.5, "LMD": [0.5, 1.0, 0.5]},
       "params": PARAMS}


def _rel(got, want) -> float:
    got, want = torch.as_tensor(np.asarray(got)), torch.as_tensor(
        np.asarray(want))
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def _close_of_max(got, want, tol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random(tree, rng):
    """Seeded values of the shapes of a flax tree (``jax.eval_shape`` of its
    init; flax's own init runs op by op, seconds a module): kernels N(0,
    1/fan_in), norm scales and learned scalars U(0.5, 1.5), the rest (biases,
    embeddings, tokens) N(0, 0.5)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _random(v, rng)
        elif k == "kernel":
            out[k] = rng.normal(0, float(np.prod(v.shape[:-1])) ** -0.5,
                                v.shape).astype(np.float32)
        elif k == "scale":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            out[k] = rng.normal(0, 0.5, v.shape).astype(np.float32)
    return out


def _init(module, *args, seed=0, **kw):
    """Random ``{"params": ...}`` of ``module`` called on ``args``."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": key, "dropout": key}, *args, **kw))
    return {"params": _random(shapes.get("params", {}),
                              np.random.default_rng(seed))}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    sl = rng.permutation(np.repeat(np.arange(WAY), SHOT)).astype(np.int32)
    tl = rng.permutation(np.repeat(np.arange(WAY), QUERIES)).astype(np.int32)
    classes = rng.choice(CLASSES, WAY, replace=False).astype(np.int32)
    text = rng.normal(size=(2, CLASSES, D)).astype(np.float32)
    return dict(
        frames=(rng.uniform(size=(S, T, IMG, IMG, 3)).astype(np.float32),
                rng.uniform(size=(Q, T, IMG, IMG, 3)).astype(np.float32)),
        labels=(sl, classes[sl], classes[tl]), target=tl,
        text=(text[0], text[1]))


def _args(x, lib):
    arrays = (*x["frames"], *x["labels"], *x["text"])
    return [jnp.asarray(a) if lib == "jax" else torch.from_numpy(a)
            for a in arrays]


def _carried(flags):
    jm = JCPM2C(arch=J_ARCHS["test-tiny"], way=WAY, shot=SHOT,
                params=PARAMS, **flags)
    tm = CPM2CModel(arch=CLIP_ARCHS["test-tiny"], way=WAY, shot=SHOT,
                    params=PARAMS, **flags)
    variables = _init(jm, *_args(_inputs(), "jax"), train=True)
    tm.load_state_dict(weights.model_state_dict(variables), strict=True)
    return jm, variables, tm


def _train_loss_jax(jm, x):
    def loss(params, su, qu):
        out = jm.apply({"params": params}, su, qu,
                       *[jnp.asarray(a) for a in (*x["labels"],
                                                  *x["text"])],
                       train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return jlosses.loss_and_acc(
            "cpm2c", out, jnp.asarray(x["target"]),
            jnp.asarray(x["labels"][1]), jnp.asarray(x["labels"][2]), 2,
            cfg=JConfig(CFG), train=True)[0]
    return loss


def _train_loss_port(tm, x, su, qu):
    tm.train()
    for m in tm.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    out = tm(su, qu, *_args(x, "torch")[2:])
    return tlosses.loss_and_acc(
        "cpm2c", out, torch.from_numpy(x["target"]),
        torch.from_numpy(x["labels"][1]), torch.from_numpy(x["labels"][2]),
        2, cfg=ConfigNode(CFG), train=True)[0]


@pytest.mark.parametrize("case", sorted(FLAGS))
def test_cpm2c_extras_forward_and_train_loss_match_jax(case):
    """The eval forward's every output (1e-5 of the largest) and the train
    loss with dropout off (1e-5 relative)."""
    flags = FLAGS[case]
    jm, variables, tm = _carried(flags)
    names = {k.split(".")[0] for k, _ in tm.named_parameters()}
    assert ("meta_conv2" in names) == ("use_visual_prompts" in flags)
    assert ("temporal_transformer" in names) == ("use_video_adapter" in flags)
    x = _inputs(seed=3)
    loss = _train_loss_jax(jm, x)

    def both(v, *a):
        return (jm.apply(v, *a, train=False),
                loss(v["params"], *a[:2]))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, v, *a, **k: v)
        want, want_loss = jax.jit(both)(variables, *_args(x, "jax"))
    with torch.no_grad():
        got = tm.eval()(*_args(x, "torch"))
        got_loss = _train_loss_port(tm, x, *_args(x, "torch")[:2])
    assert set(got) == set(want)
    for key in want:
        _close_of_max(got[key].numpy(), want[key], 1e-5, key)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)


def test_cpm2c_extras_gradients_match_jax():
    """Both switches on, train mode with dropout off: the gradient of the
    train loss for every parameter (the prompt layers and the adapter's
    included) and both clips, 1e-4 relative L2."""
    jm, variables, tm = _carried(FLAGS["both"])
    x = _inputs(seed=5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, v, *a, **k: v)
        want_loss, (gp, gsu, gqu) = jax.jit(jax.value_and_grad(
            _train_loss_jax(jm, x), argnums=(0, 1, 2)))(
            variables["params"], *map(jnp.asarray, x["frames"]))
    su, qu = [torch.from_numpy(f).requires_grad_(True) for f in x["frames"]]
    got_loss = _train_loss_port(tm, x, su, qu)
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    assert _rel(su.grad, gsu) <= 1e-4 and _rel(qu.grad, gqu) <= 1e-4
    grads = weights.model_state_dict({"params": _to_np(gp)})
    for k, p in tm.named_parameters():
        if not grads[k].any():
            assert p.grad is None or not p.grad.any(), k
            continue
        assert _rel(p.grad, grads[k]) <= 1e-4, (k, _rel(p.grad, grads[k]))


def test_prompts_refuse_the_feature_cache():
    _, _, tm = _carried(FLAGS["both"])
    assert not tm.feature_cacheable()
    with pytest.raises(ValueError, match="not cacheable"):
        tm.encode(torch.zeros(1, T, IMG, IMG, 3))
    _, _, plain = _carried(FLAGS["adapter"])
    assert plain.feature_cacheable()
    assert plain.encode(torch.zeros(1, T, IMG, IMG, 3)).shape == (1, T, D)


def test_a_tree_without_the_switches_leaves_is_refused():
    """flax creates the prompt layers where they are called: a tree from a
    model without them does not load into one with them."""
    _, variables, _ = _carried({})
    tm = CPM2CModel(arch=CLIP_ARCHS["test-tiny"], way=WAY, shot=SHOT,
                    params=PARAMS, **FLAGS["both"])
    with pytest.raises(RuntimeError, match="meta_fc1"):
        tm.load_state_dict(weights.model_state_dict(variables), strict=True)


def _cfg():
    return {
        "MODEL": {"NAME": "cpm2c", "BACKBONE": "test-tiny", "SEED": 3,
                  "USE_CLASSIFICATION_VALUE": 1.5, "LMD": [0.5, 1, 0.5]},
        "TRAIN": {"WAY": WAY, "SHOT": SHOT, "QUERY_PER_CLASS": QUERIES,
                  "TASKS_PER_BATCH": 2, "TRAIN_EPISODES": 2, "VAL_FREQ": 0,
                  "PRINT_FREQ": 100},
        "TEST": {"QUERY_PER_CLASS": QUERIES, "TEST_EPISODES": 3,
                 "CACHE_FEATURES": True},
        "DATA": {"DATASET": "hmdb", "IMG_SIZE": IMG, "SEQ_LEN": T,
                 "NUM_WORKERS": 1},
        "SOLVER": {"LR": 1e-3, "LR_SCH": 10 ** 6, "OPTIM_METHOD": "adam",
                   "WEIGHT_DECAY": 1e-4, "MOMENTUM": 0.9},
        "USE_AMP": False,
        "params": PARAMS,
    }


def _source(lib, seed):
    cls = JSource if lib == "jax" else SyntheticEpisodeSource
    return cls(way=WAY, shot=SHOT, queries=QUERIES, seq_len=T, img_size=PX,
               num_classes=CLASSES, seed=seed)


@pytest.fixture(scope="module")
def learners():
    """The JAX and the port's ``Learner`` over cpm2c with both switches,
    from the same weights, both transforms on the eval branch."""
    jm, variables, tm = _carried(FLAGS["both"])
    for m in tm.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    text = np.random.default_rng(1).normal(size=(CLASSES, D)).astype(
        np.float32)
    init = weights.model_state_dict(variables)
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__", lambda self, v, *a, **k: v)
    mp.setattr(jlearner_mod, "episode_device_transform",
               lambda images, rng, *, train, **kw:
               jtf.episode_device_transform(images, rng, train=False, **kw))
    mp.setattr(tlearner_mod, "episode_device_transform",
               lambda images, *, train, gen=None, **kw:
               ttf.episode_device_transform(images, train=False, **kw))
    jl = jlearner_mod.Learner(JConfig(_cfg()), jm, variables,
                              text_train=text, text_test=text,
                              transform=JSpec(img_size=IMG, resize_to=PX))
    tt = torch.from_numpy(text)
    log = []
    tl = Learner(ConfigNode(_cfg()), tm, tt, tt, torch.device("cpu"),
                 transform=ttf.TransformSpec(img_size=IMG, resize_to=PX),
                 log_fn=log.append)
    yield jl, tl, init, log
    mp.undo()


def test_uncached_evaluation_after_the_caches_loud_fallback(learners):
    jl, tl, _, log = learners
    assert _cached_evaluator(tl.cfg, tl, None, None, log.append, "") is None
    assert log[-1].startswith(
        "WARNING: TEST.CACHE_FEATURES ignored — model 'cpm2c' does not "
        "support eval feature caching")
    got = tl.evaluate(3, source=_source("torch", 5), batch_size=2)
    want = jl.evaluate(3, source=iter(_source("jax", 5)))
    assert "uncached eval: 3 episodes in batches of 2" in log[-1]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-9)


def test_one_masked_step_matches_the_jax_learner(learners):
    """One accumulated step of two episodes, the second padding
    (``n_valid=1``): the loss, and Adam's first moment per tensor to 1e-3
    relative (as ``test_torch_slice_heads.py`` holds cpm2c's)."""
    jl, tl, init, _ = learners
    eps = [_source("torch", 7).sample() for _ in range(2)]
    want = jl.train_episodes([JEpisode(**vars(e)) for e in eps], n_valid=1)
    got = tl.train_episodes(eps, n_valid=1)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["acc"] == want["acc"]
    mu = next(s.mu for s in jl.state.opt_state if hasattr(s, "mu"))
    mu = weights.model_state_dict({"params": _to_np(mu)})
    assert set(mu) == set(init)
    for k, p in tl.model.named_parameters():
        assert _rel(tl.optimizer.state[p]["exp_avg"], mu[k]) <= 1e-3, k


def test_only_cpm2c_takes_head_flags():
    """``build_model``'s head flags reach cpm2c's constructor; another
    head refuses them (no config key sets them)."""
    from clipspm_tpu_torch.models.fsar import build_model
    from clipspm_tpu_torch.utils.config import load_config

    opts = ["MODEL.BACKBONE=test-tiny", f"DATA.IMG_SIZE={IMG}",
            "USE_AMP=false"]
    cfg = load_config("configs/cpm2c/hmdb.yaml", opts=opts)
    model = build_model(cfg, **FLAGS["both"])
    assert model.use_visual_prompts and model.use_video_adapter
    assert not build_model(cfg).use_visual_prompts
    with pytest.raises(ValueError, match="head flags"):
        build_model(load_config("configs/clipfsar/hmdb.yaml", opts=opts),
                    use_visual_prompts=True)


def test_synthetic_episodes_are_the_port_episode():
    ep = _source("torch", 0).sample()
    assert isinstance(ep, Episode)
    assert ep.support_images.shape == (S, T, PX, PX, 3)


# -- the dormant blocks ------------------------------------------------------

BD, BT = 32, 8
NQ, NS = 3, 4


def _block_cases():
    rng = np.random.default_rng(11)
    qu = rng.normal(size=(NQ * BT, BD)).astype(np.float32)
    su = rng.normal(size=(NS * BT, BD)).astype(np.float32)
    labels = np.asarray([0, 1, 1, 0], np.int32)
    tok = rng.normal(size=(2, 5, BD)).astype(np.float32)
    maps = rng.normal(size=(2, 12, 12, 12)).astype(np.float32)
    kw = dict(way=2, seq_len=BT)
    return {
        "AttentionV3": (jbx.AttentionV3(BD), tbx.AttentionV3(BD),
                        (tok, np.ascontiguousarray(tok[::-1]), tok)),
        "Mo1": (jbx.Mo1(BD, **kw), tbx.Mo1(BD, **kw), (qu, su, labels)),
        "Mo2": (jbx.Mo2(BD, **kw), tbx.Mo2(BD, **kw), (qu, su, labels)),
        "Mo22": (jbx.Mo22(BD, seq_len=BT), tbx.Mo22(BD, seq_len=BT),
                 (qu, su)),
        "TGroup": (jbx.TGroup(BD, **kw), tbx.TGroup(BD, **kw),
                   (qu, su, labels)),
        "PositionalEncoderV2": (jbx.PositionalEncoderV2(BD),
                                tbx.PositionalEncoderV2(BD), (tok,)),
        "GroupGLKA": (jbx.GroupGLKA(12), tbx.GroupGLKA(12), (maps,)),
    }


@pytest.mark.parametrize("name", sorted(_block_cases()))
def test_dormant_block_matches_jax(name):
    jm, tm, inputs = _block_cases()[name]
    jin = [jnp.asarray(a) for a in inputs]
    # GroupGLKA's scale nonzero: flax starts it at 0, where the block is
    # its input
    params = _init(jm, *jin, seed=2)["params"]
    tm.load_state_dict(weights.head_state_dict(params), strict=True)
    for leaf in ("scale", "mo"):
        if leaf in params:
            assert torch.equal(getattr(tm, leaf),
                               torch.from_numpy(params[leaf]))
            assert getattr(tm, leaf).abs().min() > 0
    floats = [i for i, a in enumerate(inputs) if a.dtype == np.float32]
    # a random weighting of the outputs (Mo1's and Mo2's softmax rows sum
    # to 1: their plain sum has no gradient)
    shapes = jax.eval_shape(lambda: jm.apply({"params": params}, *jin))
    rng = np.random.default_rng(6)
    cts = [rng.normal(size=o.shape).astype(np.float32)
           for o in (shapes if isinstance(shapes, tuple) else (shapes,))]

    def scalar(out):
        outs = out if isinstance(out, tuple) else (out,)
        return sum((o * (torch.from_numpy(c) if torch.is_tensor(o) else c)
                    ).sum() for o, c in zip(outs, cts))

    def f(p, *xs):
        full = list(jin)
        for i, xx in zip(floats, xs):
            full[i] = xx
        out = jm.apply({"params": p}, *full)
        return scalar(out), out

    (_, want), grads = jax.jit(jax.value_and_grad(
        f, argnums=tuple(range(len(floats) + 1)), has_aux=True))(
        params, *[jin[i] for i in floats])
    tm.eval()
    tin = [torch.from_numpy(a).requires_grad_(i in floats)
           for i, a in enumerate(inputs)]
    got = tm(*tin)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.shape == w.shape
        _close_of_max(g.detach().numpy(), w, 1e-5, name)
    scalar(got).backward()
    gp = weights.head_state_dict(_to_np(grads[0]))
    named = dict(tm.named_parameters())
    assert set(named) == set(gp)
    for k, p in named.items():
        assert _rel(p.grad, gp[k]) <= 1e-4, (k, _rel(p.grad, gp[k]))
    for i, g in zip(floats, grads[1:]):
        assert _rel(tin[i].grad, g) <= 1e-4, i


# -- the new leaves' weight maps and the adapter's tensor parallelism ----------

def _cpm2c_shapes():
    jm = JCPM2C(arch=J_ARCHS["test-tiny"], way=WAY, shot=SHOT,
                params=PARAMS, **FLAGS["both"])
    key = jax.random.PRNGKey(0)
    return jax.eval_shape(lambda: jm.init({"params": key, "dropout": key},
                                          *_args(_inputs(), "jax"),
                                          train=True))["params"]


def test_new_leaves_round_trip_through_jax_paths():
    """Every parameter of cpm2c with both switches, of the temporal trunk
    and of each dormant block is the JAX leaf ``weights.jax_paths`` names:
    a leaf marked with its index lands on the parameter of that path."""
    from clipspm_tpu.models.backbones.resnet import TorchResNet as JResNet
    from clipspm_tpu_torch.models.backbones.resnet import TorchResNet

    x = jnp.zeros((2 * 4, 32, 32, 3))
    trunk = jax.eval_shape(JResNet(arch="resnet50", width=8,
                                   temporal_blocks="bottleneck",
                                   seq_len=4).init, jax.random.PRNGKey(0), x)
    stage = jax.eval_shape(JResNet(arch="resnet50", width=8,
                                   temporal_blocks="stage", seq_len=4).init,
                           jax.random.PRNGKey(0), x)
    cases = [
        (CPM2CModel(arch=CLIP_ARCHS["test-tiny"], way=WAY, shot=SHOT,
                    params=PARAMS, **FLAGS["both"]),
         {"params": _cpm2c_shapes()}, weights.model_state_dict),
        (TorchResNet(arch="resnet50", width=8, temporal_blocks="bottleneck",
                     seq_len=4), trunk,
         lambda v: weights.torchvision_resnet_state_dict(
             v["params"], v["batch_stats"])),
        (TorchResNet(arch="resnet50", width=8, temporal_blocks="stage",
                     seq_len=4), stage,
         lambda v: weights.torchvision_resnet_state_dict(
             v["params"], v["batch_stats"])),
    ]
    for name, (jm, tm, inputs) in _block_cases().items():
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                *[jnp.asarray(a) for a in inputs])
        if "params" in shapes:
            cases.append((tm, shapes, lambda v: weights.head_state_dict(
                v["params"])))
    for model, shapes, carry in cases:
        leaves, treedef = jax.tree_util.tree_flatten_with_path(
            shapes["params"])
        marked = jax.tree_util.tree_unflatten(treedef, [
            np.full(leaf.shape, i + 1.0, np.float32)
            for i, (_, leaf) in enumerate(leaves)])
        stats = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32),
            shapes.get("batch_stats", {}))
        state = carry({"params": marked, "batch_stats": stats})
        by_path = {tuple(getattr(k, "key", str(k)) for k in p): i
                   for i, (p, _) in enumerate(leaves)}
        paths = weights.jax_paths(model)
        named = dict(model.named_parameters())
        assert len(named) == len(leaves)
        for name, p in named.items():
            assert state[name].shape == p.shape, name
            i = int(round(float(state[name].flatten()[0]))) - 1
            assert by_path[paths[name]] == i, name


def test_adapter_tp_layout_matches_jax():
    """``megatron_specs`` of cpm2c with the adapter at tp=2 equals the JAX
    ``megatron_specs`` of its tree leaf by leaf (through
    ``weights.jax_paths``): the adapter's six blocks shard like the
    tower's, the rest of the head is replicated; ``shard_model_`` gives
    each adapter block and attention its ``TPContext``."""
    import jax.sharding

    shapes = _cpm2c_shapes()
    jspecs = {tuple(getattr(k, "key", str(k)) for k in path): spec
              for path, spec in jax.tree_util.tree_leaves_with_path(
                  jax_specs(shapes, 2),
                  is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))}
    tm = CPM2CModel(arch=CLIP_ARCHS["test-tiny"], way=WAY, shot=SHOT,
                    params=PARAMS, **FLAGS["both"])
    paths = weights.jax_paths(tm)
    specs = ptensor.megatron_specs(tm, 2)
    assert set(paths.values()) == set(jspecs)
    heads = {n: m.n_head for n, m in tm.named_modules()
             if isinstance(m, _Attention)}
    sharded = 0
    for name, p in tm.named_parameters():
        axes = [i for i, a in enumerate(jspecs[paths[name]]) if a == "tp"]
        want = None if not axes else p.dim() - 1 - axes[0]
        owner = name.rsplit(".", 1)[0].removesuffix(".out_proj")
        if heads.get(owner, 2) % 2 and name.endswith((
                "in_proj_weight", "in_proj_bias", "out_proj.weight")):
            # the port's head rule: a tower whose heads tp does not divide
            # keeps its attention replicated (tests/test_torch_tp.py)
            assert want is not None and specs[name] is None, name
            continue
        assert specs[name] == want, (name, jspecs[paths[name]])
        sharded += name.startswith("temporal_transformer.") and \
            want is not None
    # in_proj weight and bias, out_proj weight, c_fc weight and bias, c_proj
    # weight in each of the six blocks
    assert sharded == 6 * 6

    class Mesh:
        tp, tp_rank, tp_group = 2, 0, None

    ptensor.shard_model_(tm, Mesh())
    blocks = [m for n, m in tm.named_modules()
              if n.startswith("temporal_transformer.")
              and isinstance(m, (ResidualAttentionBlock, _Attention))]
    assert len(blocks) == 12 and all(m.tp is not None for m in blocks)
    assert tm.temporal_transformer.resblocks[0].mlp.c_fc.weight.shape[0] \
        == 4 * D // 2
