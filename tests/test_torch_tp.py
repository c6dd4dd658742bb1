"""Tensor parallelism (``parallel/tensor.py``, ``DEVICE.TP``) on the CPU:
four gloo ranks on a dp=2 x tp=2 grid started by
``torch.multiprocessing.spawn``, one thread each, at the JAX tests' sizes
(way 2, shot 1, T=2, 32 px), for ``test-tiny`` (one vision head: its
attention stays replicated, its MLP shards) and a two-head ViT of width 128
that the test builds for both packages (its attention shards by heads).

One spawn (``_ranks``) runs the rank side of (ii)-(vii); the one-process
sides run here, on one thread as the ranks do:

- (i) placement: the port's ``megatron_specs`` against the JAX
  ``megatron_specs`` through ``weights.py``'s name map, at tp 2 and 4, for
  the test archs and ViT-B/16 and RN50 at full width: the conv tower
  replicated, the attention pool's ``c_proj`` sharded on its input
  features, the attention's head rule;
- (ii) clipspm on ``test-tiny-rn`` at tp=2 (each dp index's two ranks): the
  logits against JAX ``model.apply`` within rtol 1e-4, atol 1e-5;
- (iii) one Adam step over 4 episodes at dp=2 x tp=2 for both ViT archs
  (dropout off, the eval transform): against the JAX ``Learner``'s
  sequential step, the loss within rtol 1e-3 and the gathered parameters
  and Adam moments within rtol 1e-3, atol 1e-4; against the port's
  one-process step, within 1e-5;
- (iv) the remat-chunked encode under the policies ``attn_out`` and
  ``mlp`` at dp=2 x tp=2 against the unchunked one-process step;
- (v) in each step the replicated parameters' gradients are bit-identical
  across the tp ranks before the learner's broadcast from tp rank 0
  (Megatron's *f* hands every rank the same bits; the broadcast is there
  for a GPU's atomic adds), and after two steps the replicated parameters
  are bit-identical and each shard is its slice of the gathered tensor;
- (vi) ``INT8_EVAL`` at tp=2: each int8 projection's codes (the rank's
  slice where the layer is sharded), scales and outputs, and the tower's
  output, equal TP=1's;
- (vii) a checkpoint saved at dp=2 x tp=2 is the one-process payload key
  for key and resumes in one process, and one saved in one process resumes
  at dp=2 x tp=2: each continues as the uninterrupted run that saved it.

After an Adam step the moments are held elementwise, and so are the
parameters, but where the reference's first moment lies within its
tolerance of zero: there each parameter is held to Adam's update from its
own side's moments (``_assert_state_close``).

The CLI at ``DEVICE.TP=2`` is ``tests/test_torch_tp_cli.py``.
"""

import contextlib
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from clipspm_tpu_torch import weights
from clipspm_tpu_torch.data import transforms as ttf
from clipspm_tpu_torch.data.episode import Episode
from clipspm_tpu_torch.models.backbones import clip as tclip
from clipspm_tpu_torch.models.backbones.clip import CLIP_ARCHS, CLIPArch
from clipspm_tpu_torch.models.fsar import CLIPSPMModel
from clipspm_tpu_torch.ops import quant
from clipspm_tpu_torch.parallel import mesh as pmesh
from clipspm_tpu_torch.parallel import tensor as ptensor
from clipspm_tpu_torch.train import learner as tlearner_mod
from clipspm_tpu_torch.train.checkpoint import CheckpointManager
from clipspm_tpu_torch.train.learner import Learner
from clipspm_tpu_torch.utils.config import SPM_DEFAULT_PARAMS, ConfigNode

torch.set_num_threads(2)

SPM = SPM_DEFAULT_PARAMS["hmdb"]
DP, TP = 2, 2
WAY, SHOT, QUERIES, T, IMG, PX, CLASSES = 2, 1, 1, 2, 32, 40, 8
TWO_HEAD = dict(embed_dim=32, image_resolution=32, vision_layers=2,
                vision_width=128, vision_patch_size=8, context_length=16,
                vocab_size=600, transformer_width=32, transformer_heads=2,
                transformer_layers=2)
ARCHS = {"test-tiny": CLIP_ARCHS["test-tiny"], "two-head": CLIPArch(**TWO_HEAD)}


def _cfg(tpb=4):
    return {
        "MODEL": {"NAME": "clipspm", "BACKBONE": "test-tiny", "SEED": 0},
        "TRAIN": {"WAY": WAY, "SHOT": SHOT, "QUERY_PER_CLASS": QUERIES,
                  "TASKS_PER_BATCH": tpb, "TRAIN_EPISODES": tpb,
                  "VAL_FREQ": 10 ** 6, "PRINT_FREQ": 10 ** 6},
        "TEST": {"QUERY_PER_CLASS": 1, "TEST_EPISODES": 2},
        "DATA": {"DATASET": "synthetic", "IMG_SIZE": IMG, "SEQ_LEN": T},
        "SOLVER": {"LR": 1e-3, "LR_SCH": 10 ** 6, "OPTIM_METHOD": "adam",
                   "WEIGHT_DECAY": 1e-4, "MOMENTUM": 0.9},
        "USE_AMP": False,
        "params": dict(SPM),
    }


def _episodes(seed, n):
    rng = np.random.default_rng(seed)
    S, Q = WAY * SHOT, WAY * QUERIES
    out = []
    for _ in range(n):
        classes = rng.choice(CLASSES, WAY, replace=False).astype(np.int32)
        sl = rng.permutation(np.repeat(np.arange(WAY), SHOT)).astype(np.int32)
        tl = rng.permutation(np.repeat(np.arange(WAY), QUERIES)).astype(
            np.int32)
        base = rng.integers(0, 256, (S + Q, 1, 1, 1, 3))
        noise = rng.integers(0, 256, (S + Q, T, PX, PX, 3))
        frames = (0.8 * base + 0.2 * noise).astype(np.uint8)
        out.append(Episode(
            support_images=frames[:S], support_labels=sl,
            target_images=frames[S:], target_labels=tl,
            real_support_labels=classes[sl], real_target_labels=classes[tl],
            batch_class_list=classes))
    return out


def _text(dim):
    return torch.from_numpy(np.random.default_rng(1).normal(
        size=(CLASSES, dim)).astype(np.float32))


def _mine(episodes, mesh):
    """The step as a rank's source gives it: None in the other dp
    indices' places."""
    if mesh is None:
        return list(episodes)
    return [ep if i % mesh.dp_world == mesh.dp_rank else None
            for i, ep in enumerate(episodes)]


@contextlib.contextmanager
def _fp64_frames():
    """The transform's frames in float64 (for the fp64 witness)."""
    transform = tlearner_mod.episode_device_transform
    tlearner_mod.episode_device_transform = (
        lambda *args, **kw: transform(*args, **kw).double())
    try:
        yield
    finally:
        tlearner_mod.episode_device_transform = transform


@contextlib.contextmanager
def _eval_transform():
    """The deterministic eval transform in the train step (both packages
    then see the same frames)."""
    transform = tlearner_mod.episode_device_transform
    tlearner_mod.episode_device_transform = (
        lambda images, *, train, gen=None, **kw:
        ttf.episode_device_transform(images, train=False, **kw))
    try:
        yield
    finally:
        tlearner_mod.episode_device_transform = transform


def _learner(arch, state, mesh=None, parallel=None, **model_kw):
    model = CLIPSPMModel(arch=ARCHS[arch], way=WAY, shot=SHOT, spm=dict(SPM),
                         **model_kw)
    model.load_state_dict(state, strict=True)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    text = _text(ARCHS[arch].embed_dim)
    return Learner(ConfigNode(_cfg()), model, text, text, torch.device("cpu"),
                   transform=ttf.TransformSpec(img_size=IMG, resize_to=PX),
                   mesh=mesh, parallel_episodes=parallel)


def _snapshot(learner):
    """The canonical state (gathered over the tp ranks): parameters and
    buffers, and each parameter's Adam moments by name."""
    state = learner.state_dict()
    names = [n for n, _ in learner.model.named_parameters()]
    return {"model": {k: v.clone() for k, v in state["model"].items()},
            "moments": _moments(state["optimizer"], names), "names": names}


def _moments(optimizer_state, names):
    """Each parameter's Adam moments, by name, of an optimizer
    ``state_dict`` (``names``: the parameter names in its order)."""
    return {names[i]: (e["exp_avg"].clone(), e["exp_avg_sq"].clone())
            for i, e in optimizer_state["state"].items()}


class _Int8Record:
    """Each ``quantize_rows`` call's (codes, scales) and each int8
    projection's output, in call order."""

    def __init__(self):
        self.codes, self.outs = [], []

    def __enter__(self):
        self._q, self._lin = quant.quantize_rows, tclip.int8_linear

        def quantize_rows(x, tp=None):
            got = self._q(x, tp)
            self.codes.append(tuple(t.clone() for t in got))
            return got

        def int8_linear(*args, **kwargs):
            y = self._lin(*args, **kwargs)
            self.outs.append(y.clone())
            return y

        quant.quantize_rows, tclip.int8_linear = quantize_rows, int8_linear
        return self

    def __exit__(self, *exc):
        quant.quantize_rows, tclip.int8_linear = self._q, self._lin


def _int8_tower(state, mesh=None):
    tower = tclip.make_clip_visual(dataclasses.replace(ARCHS["two-head"],
                                                       int8_eval=True))
    tower.load_state_dict({k[len("backbone."):]: v for k, v in state.items()
                           if k.startswith("backbone.")})
    if mesh is not None:
        ptensor.shard_model_(tower, mesh)
    x = torch.from_numpy(np.random.default_rng(4).random(
        (3, IMG, IMG, 3)).astype(np.float32))
    with _Int8Record() as rec, torch.no_grad():
        y = tower.eval()(x)
    return {"codes": rec.codes, "outs": rec.outs, "y": y}


def _rn_logits(state, inputs, mesh=None):
    model = CLIPSPMModel(arch=CLIP_ARCHS["test-tiny-rn"], way=WAY, shot=SHOT,
                         spm=dict(SPM))
    model.load_state_dict(state, strict=True)
    if mesh is not None:
        ptensor.shard_model_(model, mesh)
    with torch.no_grad():
        return model.eval()(*(torch.from_numpy(a) for a in inputs))["logits"]


def _steps(learner, eps, mesh=None, save=None):
    """Two steps of 4 episodes, the canonical state after each; ``save``: a
    checkpoint directory written after the first."""
    out = {"m1": learner.train_episodes(_mine(eps[:4], mesh))}
    out["s1"] = _snapshot(learner)
    if save is not None:
        CheckpointManager(save, mesh).save(learner, "step1")
    out["m2"] = learner.train_episodes(_mine(eps[4:], mesh))
    out["s2"] = _snapshot(learner)
    return out


def _ranks(mesh, spec):
    """The rank side of (ii)-(vii); each rank saves what it got as
    ``rank<r>.pt`` under ``spec['out']``."""
    torch.set_num_threads(1)
    eps = spec["eps"]
    out = {}
    # the tensors of each tp broadcast, as this rank computed them
    sent = []
    broadcast = pmesh.EpisodeMesh.tp_broadcast_

    def recorded(self, tensors):
        sent.append([t.detach().clone() for t in tensors])
        broadcast(self, tensors)

    pmesh.EpisodeMesh.tp_broadcast_ = recorded
    with _eval_transform():
        for arch in ARCHS:
            a = _learner(arch, spec["init"][arch], mesh=mesh)
            out[arch] = _steps(a, eps, mesh, save=spec["ckpt"][arch])
            out[arch]["sent"] = sent[:]
            sent.clear()
            out[arch]["local"] = {k: v.clone() for k, v
                                  in a.model.state_dict().items()}
            out[arch]["shards"] = a.shards
        for policy in ("attn_out", "mlp"):
            c = _learner("two-head", spec["init"]["two-head"], mesh=mesh,
                         encode_chunk=3, train_encode_chunk=4,
                         train_remat_policy=policy)
            c.train_episodes(_mine(eps[:4], mesh))
            out[("chunked", policy)] = _snapshot(c)
        r = _learner("two-head", spec["init"]["two-head"], mesh=mesh)
        CheckpointManager(spec["tp1_ckpt"], mesh).restore("step1", r)
        assert r.episode == 4
        r.train_episodes(_mine(eps[4:], mesh))
        out["resumed"] = _snapshot(r)
    out["int8"] = _int8_tower(spec["init"]["two-head"], mesh)
    out["rn"] = _rn_logits(spec["rn_init"], spec["rn_inputs"], mesh)
    torch.save(out, os.path.join(spec["out"], f"rank{mesh.rank}.pt"))


# -- the JAX side -------------------------------------------------------------

def _jax_model(arch, backbone):
    import jax
    import jax.numpy as jnp

    from clipspm_tpu.models.backbones.clip import CLIP_ARCHS as J_ARCHS
    from clipspm_tpu.models.backbones.clip import CLIPArch as JArch
    from clipspm_tpu.models.fsar import CLIPSPMModel as JModel

    jarch = J_ARCHS[backbone] if backbone in J_ARCHS else JArch(**TWO_HEAD)
    model = JModel(arch=jarch, way=WAY, shot=SHOT, spm=dict(SPM))
    S, Q, px = WAY * SHOT, WAY * QUERIES, arch.image_resolution
    dummy = (jnp.zeros((S, T, px, px, 3)), jnp.zeros((Q, T, px, px, 3)),
             jnp.arange(S, dtype=jnp.int32) % WAY,
             jnp.zeros((S,), jnp.int32), jnp.zeros((Q,), jnp.int32),
             jnp.zeros((CLASSES, arch.embed_dim)),
             jnp.zeros((CLASSES, arch.embed_dim)))
    return model, dummy, jax.random.PRNGKey(0)


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_steps():
    """(iii): the JAX ``Learner``'s sequential Adam step over 4 episodes
    (dropout off, the eval transform) for both ViT archs, from variables
    carried into the port's tree; and (ii)'s RN logits."""
    import flax.linen as fnn
    import jax
    import optax

    from clipspm_tpu.data import transforms as jtf
    from clipspm_tpu.data.episode import Episode as JEpisode
    from clipspm_tpu.train import learner as jlearner_mod
    from clipspm_tpu.train.learner import TransformSpec as JSpec
    from clipspm_tpu.utils.config import ConfigNode as JConfig

    eps = _episodes(5, 8)
    out = {"eps": eps, "init": {}, "jax": {}}
    for arch, parch in ARCHS.items():
        model, dummy, key = _jax_model(parch, arch)
        variables = jax.jit(model.init)(key, *dummy)
        out["init"][arch] = weights.model_state_dict(
            {"params": _np_tree(variables["params"])})
        text = _text(parch.embed_dim).numpy()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
            mp.setattr(jlearner_mod, "episode_device_transform",
                       lambda images, rng, *, train, **kw:
                       jtf.episode_device_transform(images, rng,
                                                    train=False, **kw))
            learner = jlearner_mod.Learner(
                JConfig(_cfg()), model, variables, text_train=text,
                text_test=text, transform=JSpec(img_size=IMG, resize_to=PX))
            metrics = learner.train_episodes([JEpisode(**{
                f: getattr(e, f) for f in (
                    "support_images", "support_labels", "target_images",
                    "target_labels", "real_support_labels",
                    "real_target_labels", "batch_class_list")})
                for e in eps[:4]])
        adam = [s for s in _flat_states(learner.state.opt_state)
                if isinstance(s, optax.ScaleByAdamState)][0]
        out["jax"][arch] = dict(
            metrics=metrics,
            model=weights.model_state_dict(
                {"params": _np_tree(learner.state.params)}),
            mu=weights.model_state_dict({"params": _np_tree(adam.mu)}),
            nu=weights.model_state_dict({"params": _np_tree(adam.nu)}))
    # (ii): the RN tower's clipspm logits on seeded inputs
    parch = CLIP_ARCHS["test-tiny-rn"]
    model, dummy, key = _jax_model(parch, "test-tiny-rn")
    variables = jax.jit(model.init)(key, *dummy)
    rng = np.random.default_rng(9)
    S, Q = WAY * SHOT, WAY * QUERIES
    inputs = (rng.random((S, T, IMG, IMG, 3)).astype(np.float32),
              rng.random((Q, T, IMG, IMG, 3)).astype(np.float32),
              np.arange(S, dtype=np.int32) % WAY,
              rng.integers(0, CLASSES, S).astype(np.int32),
              rng.integers(0, CLASSES, Q).astype(np.int32),
              rng.normal(size=(CLASSES, parch.embed_dim)).astype(np.float32),
              rng.normal(size=(CLASSES, parch.embed_dim)).astype(np.float32))
    out["rn_inputs"] = inputs
    out["rn_init"] = weights.model_state_dict(
        {"params": _np_tree(variables["params"]),
         "batch_stats": _np_tree(variables["batch_stats"])})
    out["rn_logits"] = np.asarray(jax.jit(
        lambda v, *a: model.apply(v, *a, train=False)["logits"])(
            variables, *inputs))
    return out


def _flat_states(state):
    if isinstance(state, tuple) and not hasattr(state, "_fields"):
        for s in state:
            yield from _flat_states(s)
    else:
        yield state


@contextlib.contextmanager
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def oracle(jax_steps, tmp_path_factory):
    """The same steps in one process (``parallel_episodes=2``, the plain
    version of the dp ranks; TP=1), a checkpoint after the first, the same
    steps in float64 (the witness of their rounding), and (vi)'s TP=1 int8
    tower."""
    tmp = tmp_path_factory.mktemp("tp_oracle")
    out = {"ckpt": {}}
    with _one_thread(), _eval_transform():
        for arch in ARCHS:
            out["ckpt"][arch] = str(tmp / arch)
            one = _learner(arch, jax_steps["init"][arch], parallel=DP)
            out[arch] = _steps(one, jax_steps["eps"],
                               save=out["ckpt"][arch])
            with _fp64_frames():
                w = _learner(arch, jax_steps["init"][arch], parallel=DP)
                w.model.double()
                w.text_train, w.text_test = (w.text_train.double(),
                                             w.text_test.double())
                witness = _steps(w, jax_steps["eps"])
            out[arch]["noise"] = {s: _noise(out[arch][s], witness[s])
                                  for s in ("s1", "s2")}
        out["int8"] = _int8_tower(jax_steps["init"]["two-head"])
    return out


@pytest.fixture(scope="module")
def ranks(jax_steps, oracle, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp_ranks"))
    spec = dict(out=out, eps=jax_steps["eps"], init=jax_steps["init"],
                ckpt={arch: os.path.join(out, arch) for arch in ARCHS},
                tp1_ckpt=oracle["ckpt"]["two-head"],
                rn_init=jax_steps["rn_init"],
                rn_inputs=jax_steps["rn_inputs"])
    pmesh.spawn(_ranks, DP * TP, "cpu", args=(spec,), tp=TP, timeout_s=300)
    return spec, [torch.load(os.path.join(out, f"rank{r}.pt"),
                             weights_only=False) for r in range(DP * TP)]


# -- (i) placement ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_shapes(backbone):
    """The JAX model's variables' shapes (``jax.eval_shape``: no compute,
    so full widths are cheap)."""
    import jax

    model, dummy, key = _jax_model(ARCHS.get(backbone)
                                   or CLIP_ARCHS[backbone], backbone)
    return jax.eval_shape(model.init, key, *dummy)


def _port_and_jax_specs(backbone, tp):
    import jax
    import jax.tree_util as jtu

    from clipspm_tpu.parallel.tensor import megatron_specs as jax_specs

    shapes = _jax_shapes(backbone)["params"]
    jspecs = {tuple(getattr(k, "key", str(k)) for k in path): spec
              for path, spec in jtu.tree_leaves_with_path(
                  jax_specs(shapes, tp),
                  is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}
    with torch.device("meta"):
        port = CLIPSPMModel(arch=ARCHS.get(backbone) or CLIP_ARCHS[backbone],
                            way=WAY, shot=SHOT, spm=dict(SPM))
    return port, jspecs, shapes


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("backbone", ["test-tiny", "two-head", "test-tiny-rn",
                                      "ViT-B/16", "RN50"])
def test_megatron_specs_match_the_jax_placement(backbone, tp):
    """Each port parameter's sharded dimension is the JAX spec's, mapped
    through ``weights.jax_paths`` (a Dense kernel ``[in, out]`` is the
    port's ``[out, in]``), but where tp does not divide an attention's
    heads: there the port keeps ``in_proj`` and ``out_proj`` replicated."""
    port, jspecs, _ = _port_and_jax_specs(backbone, tp)
    paths = weights.jax_paths(port)
    specs = ptensor.megatron_specs(port, tp)
    shards = ptensor.layout(port, tp)
    heads = {n: m.n_head for n, m in port.named_modules()
             if isinstance(m, tclip._Attention)}
    n_sharded = 0
    for name, p in port.named_parameters():
        jspec = jspecs[paths[name]]
        axes = [i for i, a in enumerate(jspec) if a == "tp"]
        want = None if not axes else p.dim() - 1 - axes[0]
        owner = name.rsplit(".attn.", 1)[0] + ".attn" \
            if ".attn." in name else None
        if owner in heads and heads[owner] % tp and name.endswith((
                "in_proj_weight", "in_proj_bias", "out_proj.weight")):
            assert want is not None and specs[name] is None, name
            continue
        assert specs[name] == want, (name, jspec)
        n_sharded += want is not None
        if name.endswith(("in_proj_weight", "in_proj_bias")) and want is \
                not None:
            # the head rule: rank r holds the q, k and v rows of its heads
            D, h = p.shape[0] // 3, heads[owner]
            hd = D // h
            for r in range(tp):
                mine = range(r * h // tp, (r + 1) * h // tp)
                rows = [part * D + head * hd + j for part in range(3)
                        for head in mine for j in range(hd)]
                assert shards[name].index(p.shape[0], r, tp).tolist() == rows
    assert n_sharded
    if backbone in ("test-tiny-rn", "RN50"):
        convs = [k for k in specs if "conv" in k or "bn" in k
                 or "downsample" in k]
        assert convs and all(specs[k] is None for k in convs)
        assert specs["backbone.attnpool.c_proj.weight"] == 1
        assert specs["backbone.attnpool.c_proj.bias"] is None
        assert all(specs[f"backbone.attnpool.{p}_proj.weight"] is None
                   for p in "qkv")
    assert not any(specs[k] is not None for k in specs
                   if k.startswith("head."))


@pytest.mark.parametrize("backbone", ["test-tiny", "two-head",
                                      "test-tiny-rn"])
def test_jax_paths_invert_the_weight_maps(backbone):
    """``weights.jax_paths`` names, for every port parameter, the JAX leaf
    ``weights.model_state_dict`` carries into it; and a leaf sharded on a
    JAX axis lands sharded on the port's dimension the specs name."""
    import jax

    from clipspm_tpu.parallel.tensor import megatron_specs as jax_specs

    port, _, shapes = _port_and_jax_specs(backbone, 2)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    specs = jax.tree_util.tree_leaves(
        jax_specs(shapes, 2),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    marked = []
    for i, ((path, leaf), spec) in enumerate(zip(leaves, specs)):
        a = np.full(leaf.shape, i + 1.0, np.float32)
        axes = [d for d, ax in enumerate(spec) if ax == "tp"]
        if axes:
            # the index along the sharded axis, on top of the leaf's mark
            shape = [1] * len(leaf.shape)
            shape[axes[0]] = leaf.shape[axes[0]]
            a = a + 1e-3 * np.arange(leaf.shape[axes[0]]).reshape(shape)
        marked.append(a)
    tree = jax.tree_util.tree_unflatten(treedef, marked)
    stats = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   _jax_shapes(backbone).get("batch_stats",
                                                             {}))
    state = weights.model_state_dict({"params": tree, "batch_stats": stats})
    paths = weights.jax_paths(port)
    specs_port = ptensor.megatron_specs(port, 2)
    by_path = {tuple(getattr(k, "key", str(k)) for k in p): i
               for i, (p, _) in enumerate(leaves)}
    for name, _ in port.named_parameters():
        t = state[name]
        i = int(round(float(t.flatten()[0])) - 1)
        assert by_path[paths[name]] == i, name
        varies = [d for d in range(t.dim())
                  if t.shape[d] > 1 and not torch.equal(
                      t, t.narrow(d, 0, 1).expand_as(t))]
        if specs_port[name] is not None:
            assert varies == [specs_port[name]], name


# -- (ii) the RN tower -----------------------------------------------------------

def test_rn_tower_at_tp2_matches_jax(jax_steps, ranks):
    want = jax_steps["rn_logits"]
    for got in (r["rn"] for r in ranks[1]):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


# -- (iii) one Adam step ---------------------------------------------------------

# Adam (betas 0.5 and 0.999, eps 1e-8, the L2 decay inside the gradient)
# moves an element by LR * m_hat / (sqrt(v_hat) + eps): by about LR, with
# the first moment's sign. Where that moment lies within its tolerance of
# zero (a gradient that is a residue of cancelling sums: an attention's key
# bias has a zero gradient in exact arithmetic), either sign is right to
# rounding, and the two sides' steps may go opposite ways. So the moments
# are held elementwise everywhere, and the parameters too but at those
# elements: there each side's parameter is held to Adam's update from its
# own moments and the state before the step, computed in float64. Such
# elements stay under NEAR_ZERO_SHARE of the model's moments (measured:
# 6.6% for test-tiny and 5.3% for the two-head ViT against JAX at atol
# 1e-4; 0.6-0.7% after one step and 1.9% after two against one process).
#
# Against the port's one-process step, a moment's atol is 1e-5, or NOISE
# times that step's own fp32 error in the tensor against the same steps in
# float64 where that is larger: a gradient's rounding is relative to its
# terms, not to its result. (Measured: the one tensor whose moments move
# more than 1e-5 between the ranks and one process, the two-head ViT's
# head bias ``token_tr.fc2.bias``, moves 1.74e-5, and one process alone
# rounds it 1.71e-5 from float64.)
B1, B2, EPS, LR = 0.5, 0.999, 1e-8, 1e-3
NEAR_ZERO_SHARE = 0.1
NOISE = 4.0


def _noise(fp32, fp64):
    """Each parameter's moments' largest rounding error in the fp32
    snapshot ``fp32`` against the same run in float64: ``{name: (first,
    second)}``."""
    return {k: tuple(float((a.double() - b).abs().max())
                     for a, b in zip(pair, fp64["moments"][k]))
            for k, pair in fp32["moments"].items()}


def _adam(before, mu, nu, step):
    """Adam's parameter after step ``step`` from ``before`` and the moments
    after it, in float64."""
    m_hat = mu.double() / (1 - B1 ** step)
    v_hat = nu.double() / (1 - B2 ** step)
    return before.double() - LR * m_hat / (v_hat.sqrt() + EPS)


def _assert_state_close(got, want, rtol, atol, before, step=1, noise=None):
    """The snapshot ``got`` (parameters, buffers and moments) against the
    snapshot ``want`` after optimizer step ``step``, ``before`` the state
    both stepped from: every moment and buffer elementwise within ``rtol``
    and ``atol`` (a moment's atol raised to ``NOISE`` times its tensor's
    rounding error ``noise``, where given), every parameter too but where
    ``want``'s first moment is within its tolerance of zero, where ``got``'s
    parameter must be Adam's update from ``got``'s moments."""
    near_zero = total = 0
    for key, w in want["model"].items():
        g = got["model"][key]
        if key not in want["moments"]:
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol, msg=key)
            continue
        (mu, nu), (w_mu, w_nu) = got["moments"][key], want["moments"][key]
        m_atol, v_atol = (max(atol, NOISE * e) for e in (
            noise[key] if noise else (0.0, 0.0)))
        torch.testing.assert_close(mu, w_mu, rtol=rtol, atol=m_atol,
                                   msg=lambda m: f"{key} first moment: {m}")
        torch.testing.assert_close(nu, w_nu, rtol=rtol, atol=v_atol,
                                   msg=lambda m: f"{key} second moment: {m}")
        torch.testing.assert_close(g.double(), _adam(before[key], mu, nu,
                                                     step),
                                   rtol=1e-6, atol=1e-9,
                                   msg=lambda m: f"{key}, Adam's step: {m}")
        near = w_mu.abs() * (1 - rtol) <= m_atol
        torch.testing.assert_close(g[~near], w[~near], rtol=rtol, atol=atol,
                                   msg=lambda m: f"{key}: {m}")
        near_zero += int(near.sum())
        total += near.numel()
    assert near_zero <= NEAR_ZERO_SHARE * total, (near_zero, total)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_tp_step_matches_jax_and_one_process(arch, jax_steps, oracle, ranks):
    want = jax_steps["jax"][arch]
    one = oracle[arch]
    init = jax_steps["init"][arch]
    for got in (r[arch] for r in ranks[1]):
        np.testing.assert_allclose(got["m1"]["loss"],
                                   want["metrics"]["loss"], rtol=1e-3)
        np.testing.assert_allclose(got["m1"]["loss"], one["m1"]["loss"],
                                   rtol=1e-5)
        model, moments = got["s1"]["model"], got["s1"]["moments"]
        assert set(model) == set(one["s1"]["model"])
        assert set(moments) == set(one["s1"]["moments"])
        _assert_state_close(got["s1"], {"model": want["model"], "moments": {
            k: (want["mu"][k], want["nu"][k]) for k in moments}}, 1e-3, 1e-4,
            init)
        _assert_state_close(got["s1"], one["s1"], 1e-5, 1e-5, init,
                            noise=one["noise"]["s1"])


# -- (iv) the remat-chunked encode -----------------------------------------------

@pytest.mark.parametrize("policy", ["attn_out", "mlp"])
def test_chunked_encode_under_tp_matches_unchunked(policy, oracle, ranks):
    want = oracle["two-head"]["s1"]
    for got in (r[("chunked", policy)] for r in ranks[1]):
        _assert_state_close(got, want, 1e-5, 1e-5,
                            ranks[0]["init"]["two-head"],
                            noise=oracle["two-head"]["noise"]["s1"])


# -- (v) two steps ---------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS))
def test_replicas_stay_identical_and_shards_are_slices(arch, ranks):
    got = [r[arch] for r in ranks[1]]
    shards = got[0]["shards"]
    assert any(s is not None for s in shards.values())
    n_replicated = sum(s is None for s in shards.values())
    for d in range(DP):
        row = got[d * TP:(d + 1) * TP]
        # one broadcast a step, of every replicated gradient
        assert [len(s) for s in row[0]["sent"]] == [n_replicated] * 2
        for r in row[1:]:
            for step, tensors in enumerate(r["sent"]):
                for i, t in enumerate(tensors):
                    assert torch.equal(t, row[0]["sent"][step][i]), (step, i)
        for key, shard in shards.items():
            if shard is None:
                for r in row[1:]:
                    assert torch.equal(r["local"][key], row[0]["local"][key]),\
                        key
                continue
            full = row[0]["s2"]["model"][key]
            for t, r in enumerate(row):
                assert torch.equal(r["s2"]["model"][key], full), key
                assert torch.equal(r["local"][key], full.index_select(
                    shard.dim, shard.index(full.shape[shard.dim], t, TP))), key


# -- (vi) INT8_EVAL ---------------------------------------------------------------

def test_int8_codes_and_outputs_equal_tp1(oracle, ranks):
    """Per block the quantised operands come in the order in_proj (x, w),
    out_proj (x, w), c_fc (x, w), c_proj (x, w); a sharded operand is the
    rank's slice of TP=1's, by the layer's shard (in_proj's weight by
    heads), and every scale is the whole row's."""
    want = oracle["int8"]
    D = ARCHS["two-head"].vision_width
    # the shard of each operand in a block's order: (dim, parts) or None
    order = [None, (0, 3), (-1, 1), (1, 1), None, (0, 1), (-1, 1), (1, 1)]
    for t, got in enumerate(r["int8"] for r in ranks[1][:TP]):
        assert len(got["codes"]) == len(want["codes"]) == 8 * 2
        for i, ((q, s), (wq, ws)) in enumerate(zip(got["codes"],
                                                   want["codes"])):
            cut = order[i % 8]
            if cut is not None:
                dim, parts = cut
                idx = ptensor.Shard(dim % wq.dim(), parts).index(
                    wq.shape[dim], t, TP)
                wq = wq.index_select(dim % wq.dim(), idx)
                if dim == 0:
                    ws = ws.index_select(0, idx)
            assert torch.equal(q, wq), i
            assert torch.equal(s, ws), i
        assert len(got["outs"]) == len(want["outs"]) == 8
        for i, (y, wy) in enumerate(zip(got["outs"], want["outs"])):
            if i % 4 in (0, 2):    # column-parallel: the rank's features
                cut = (3, 3 * D) if i % 4 == 0 else (1, 4 * D)
                wy = wy.index_select(-1, ptensor.Shard(
                    wy.dim() - 1, cut[0]).index(cut[1], t, TP))
            assert torch.equal(y, wy), i
        assert torch.equal(got["y"], want["y"])


# -- (vii) checkpoints -----------------------------------------------------------

def test_tp_checkpoint_is_the_one_process_payload_and_resumes(oracle, ranks):
    """The payload saved at dp=2 x tp=2 holds the one-process payload's keys
    and shapes; its values are the dp=2 x tp=2 run's gathered state bit for
    bit, and the one-process run's within the step's tolerance. Resumed, each
    continues as the uninterrupted run that saved the same state: the
    dp=2 x tp=2 payload in one process as the dp=2 x tp=2 run's second
    step, the one-process payload at dp=2 x tp=2 as the one-process run's
    (from different step-1 states the two runs' second steps would differ
    by Adam's amplified rounding, ``_assert_state_close``)."""
    spec, got = ranks
    load = lambda d: torch.load(  # noqa: E731
        os.path.join(d, "checkpoint_step1", "checkpoint.pt"),
        weights_only=False)
    for arch in ARCHS:
        tp, one = load(spec["ckpt"][arch]), load(oracle["ckpt"][arch])
        assert set(tp) == set(one)
        assert set(tp["model"]) == set(one["model"])
        for key, v in one["model"].items():
            assert tp["model"][key].shape == v.shape, key
        assert tp["optimizer"]["param_groups"] == \
            one["optimizer"]["param_groups"]
        assert set(tp["optimizer"]["state"]) == set(one["optimizer"]["state"])
        for i, entry in one["optimizer"]["state"].items():
            assert set(tp["optimizer"]["state"][i]) == set(entry)
            for k, v in entry.items():
                assert tp["optimizer"]["state"][i][k].shape == v.shape
        saved = {"model": tp["model"], "moments": _moments(
            tp["optimizer"], got[0][arch]["s1"]["names"])}
        for key, v in got[0][arch]["s1"]["model"].items():
            assert torch.equal(saved["model"][key], v), key
        for key, pair in got[0][arch]["s1"]["moments"].items():
            assert all(map(torch.equal, saved["moments"][key], pair)), key
        _assert_state_close(saved, oracle[arch]["s1"], 1e-5, 1e-5,
                            spec["init"][arch],
                            noise=oracle[arch]["noise"]["s1"])
    eps = spec["eps"]
    with _one_thread(), _eval_transform():
        one = _learner("two-head", spec["init"]["two-head"], parallel=DP)
        CheckpointManager(spec["ckpt"]["two-head"]).restore("step1", one)
        assert one.episode == 4
        one.train_episodes(eps[4:])
        resumed = _snapshot(one)
    for state, run in [(resumed, got[0]["two-head"])] + [
            (r["resumed"], oracle["two-head"]) for r in got]:
        _assert_state_close(state, run["s2"], 1e-5, 1e-5,
                            run["s1"]["model"], step=2,
                            noise=oracle["two-head"]["noise"]["s2"])
