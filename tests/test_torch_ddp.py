"""Episode parallelism over ranks (``parallel/mesh.py``, ``DEVICE.NUM_CHIPS``)
on the CPU: two gloo ranks started by ``torch.multiprocessing.spawn``, one
thread each, at the JAX tests' sizes (way 2, shot 1, T=2, 32 px; ta2n at
64 px and T=4, as ``tests/test_torch_ta2n_train.py``).

One spawn of two ranks (``_ranks``) runs the rank side of (a)-(e) and of the
randomness check; the single-process sides run here, on one thread as the
ranks do (the BatchNorm-fed gradients move by 1e-5 between one and two
threads' kernels):

- (a) the ranks' step against the JAX ``Learner`` on a 2-device mesh (the
  conftest's virtual CPU devices), ``test-tiny``, weights carried by
  ``weights.py``, dropout off and the eval transform on both sides, SGD:
  the loss rtol 1e-4 and every parameter rtol 1e-4 and atol 1e-5; and the
  BatchNorm mean against the JAX step's expression;
- (b) the ranks against ``parallel_episodes=2`` in one process (the plain
  version of the multi-rank step), clipspm and ta2n, dropout and random
  crops on: a full step, then (c) a masked step (3 of 4 episodes, the
  padding on rank 1): loss, gradients, parameters and every BatchNorm
  buffer; the gradient is the *sum* over the ranks (averaged gradients
  would be half); ``parallel_episodes=1`` chains the statistics instead,
  and lands elsewhere;
- ``SOLVER.ACCUM_DTYPE=bfloat16``: the one-process step and the ranks
  round by the JAX rule (each microstep's fp32 sum, over the ranks one
  all-reduce a microstep), bit for bit as replayed from the episodes' fp32
  gradients;
- (d) ``evaluate(3, batch_size=3)`` at N=2 (rounded to 4) against N=1;
- (e) the feature-cached evaluator at N=2 against N=1: the gathered table,
  accuracy, CI and loss;
- randomness: episode 1's crop offsets and dropout mask on rank 1 equal
  those episode 1 draws at N=1;
- (g) a rank that raises ends the run; (h) a missing frame file on one
  rank's episode, and a corrupt one: the JAX loader's stream at N=1 and
  N=2.

(f), the CLI at ``DEVICE.NUM_CHIPS=2`` against 1, is
``tests/test_torch_ddp_cli.py``: apart, each file stays within about a
minute on one worker.
"""

import contextlib
import os
import shutil
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from make_synthetic_dataset import make_dataset  # noqa: E402

from clipspm_tpu_torch import weights  # noqa: E402
from clipspm_tpu_torch.data import pipeline  # noqa: E402
from clipspm_tpu_torch.data import transforms as ttf  # noqa: E402
from clipspm_tpu_torch.data.episode import Episode  # noqa: E402
from clipspm_tpu_torch.models.backbones.clip import CLIP_ARCHS  # noqa: E402
from clipspm_tpu_torch.models.fsar import CLIPSPMModel, build_model  # noqa: E402
from clipspm_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from clipspm_tpu_torch.train import learner as tlearner_mod  # noqa: E402
from clipspm_tpu_torch.train.feature_cache import cached_evaluator  # noqa: E402
from clipspm_tpu_torch.train.learner import Learner  # noqa: E402
from clipspm_tpu_torch.train.setup import (build_catalog_and_sampler,  # noqa: E402
                                           build_learner)
from clipspm_tpu_torch.utils.config import SPM_DEFAULT_PARAMS  # noqa: E402
from clipspm_tpu_torch.utils.config import ConfigNode, load_config  # noqa: E402

pytest.importorskip("PIL.Image")
torch.set_num_threads(2)

SPM = SPM_DEFAULT_PARAMS["hmdb"]
N = 2
WAY, SHOT, QUERIES, T, IMG, PX, CLASSES = 2, 1, 1, 2, 32, 40, 8
TA2N = dict(T=4, IMG=64, PX=72, QUERIES=2)


def _cfg(backbone, optim="sgd", tpb=4, accum="float32"):
    return {
        "MODEL": {"NAME": "clipspm", "BACKBONE": backbone, "SEED": 0},
        "TRAIN": {"WAY": WAY, "SHOT": SHOT, "QUERY_PER_CLASS": QUERIES,
                  "TASKS_PER_BATCH": tpb, "TRAIN_EPISODES": tpb,
                  "VAL_FREQ": 10 ** 6, "PRINT_FREQ": 10 ** 6},
        "TEST": {"QUERY_PER_CLASS": 1, "TEST_EPISODES": 2},
        "DATA": {"DATASET": "synthetic", "IMG_SIZE": IMG, "SEQ_LEN": T},
        "SOLVER": {"LR": 1e-3, "LR_SCH": 10 ** 6, "OPTIM_METHOD": optim,
                   "WEIGHT_DECAY": 1e-4, "MOMENTUM": 0.9,
                   "ACCUM_DTYPE": accum},
        "USE_AMP": False,
        "params": dict(SPM),
    }


TA2N_CFG = {
    "MODEL": {"NAME": "ta2n", "BACKBONE": "test-tiny-resnet", "SEED": 3,
              "METRIC": "otam", "DROPOUT": 0.5},
    "TRAIN": {"WAY": WAY, "SHOT": SHOT, "QUERY_PER_CLASS": TA2N["QUERIES"],
              "TASKS_PER_BATCH": 4, "TRAIN_EPISODES": 4, "VAL_FREQ": 0,
              "PRINT_FREQ": 100},
    "TEST": {"QUERY_PER_CLASS": 1, "TEST_EPISODES": 2},
    "DATA": {"DATASET": "ucf", "IMG_SIZE": TA2N["IMG"], "SEQ_LEN": TA2N["T"]},
    "SOLVER": {"LR": 1e-3, "LR_SCH": 10 ** 6, "OPTIM_METHOD": "sgd",
               "WEIGHT_DECAY": 1e-3, "MOMENTUM": 0.9},
    "USE_AMP": False,
}


def _episodes(seed, n, queries=QUERIES, t=T, px=PX):
    rng = np.random.default_rng(seed)
    S, Q = WAY * SHOT, WAY * queries
    out = []
    for _ in range(n):
        classes = rng.choice(CLASSES, WAY, replace=False).astype(np.int32)
        sl = rng.permutation(np.repeat(np.arange(WAY), SHOT)).astype(np.int32)
        tl = rng.permutation(np.repeat(np.arange(WAY), queries)).astype(
            np.int32)
        base = rng.integers(0, 256, (S + Q, 1, 1, 1, 3))
        noise = rng.integers(0, 256, (S + Q, t, px, px, 3))
        frames = (0.8 * base + 0.2 * noise).astype(np.uint8)
        out.append(Episode(
            support_images=frames[:S], support_labels=sl,
            target_images=frames[S:], target_labels=tl,
            real_support_labels=classes[sl], real_target_labels=classes[tl],
            batch_class_list=classes))
    return out


def _mine(episodes, mesh):
    """The step as a rank's source gives it: None in the others' places."""
    if mesh is None:
        return list(episodes)
    return [ep if i % mesh.world == mesh.rank else None
            for i, ep in enumerate(episodes)]


def _eval_transform(images, *, train, gen=None, **kw):
    return ttf.episode_device_transform(images, train=False, **kw)


def _clipspm(backbone, state, optim="sgd", mesh=None, parallel=None,
             dropout=True, accum="float32"):
    model = CLIPSPMModel(arch=CLIP_ARCHS[backbone], way=WAY, shot=SHOT,
                         spm=dict(SPM))
    model.load_state_dict(state, strict=True)
    if not dropout:
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
    text = torch.from_numpy(np.random.default_rng(1).normal(
        size=(CLASSES, CLIP_ARCHS[backbone].embed_dim)).astype(np.float32))
    return Learner(ConfigNode(_cfg(backbone, optim, accum=accum)), model,
                   text, text,
                   torch.device("cpu"),
                   transform=ttf.TransformSpec(img_size=IMG, resize_to=PX),
                   mesh=mesh, parallel_episodes=parallel)


def _ta2n(state, mesh=None, parallel=None):
    model = build_model(ConfigNode(TA2N_CFG))
    model.load_state_dict(state, strict=True)
    return Learner(ConfigNode(TA2N_CFG), model, torch.zeros(1, 1),
                   torch.zeros(1, 1), torch.device("cpu"),
                   transform=ttf.TransformSpec(img_size=TA2N["IMG"],
                                               resize_to=TA2N["PX"]),
                   mesh=mesh, parallel_episodes=parallel)


def _random_state(model, seed):
    weights.random_init_(model, torch.Generator().manual_seed(seed))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _two_steps(learner, episodes, mesh=None):
    """A full step of 4 and a masked one (3 of 4 real, the padding in
    rank 1's place): each step's metrics, its summed gradient and the
    state after it."""
    out = []
    for eps, n_valid in ((episodes[:4], None), (episodes[4:], 3)):
        m = learner.train_episodes(_mine(eps, mesh), n_valid=n_valid)
        out.append(dict(
            metrics=m, episode=learner.episode,
            grads={k: p.grad.clone() for k, p
                   in learner.model.named_parameters()},
            state={k: v.clone() for k, v
                   in learner.model.state_dict().items()}))
    return out


class _Draws:
    """Records each training episode's draws in the order the episodes
    run: its two crop draws (support, query: flips, tops, lefts) and the
    masks of the first dropout module."""

    def __init__(self, model):
        self.episodes = []
        self._draw = ttf.draw_train_offsets
        drop = next(m for m in model.modules()
                    if isinstance(m, torch.nn.Dropout) and m.p > 0)
        self._hook = drop.register_forward_hook(
            lambda mod, inp, out: self.episodes[-1]["masks"].append(
                (out == 0) & (inp[0] != 0)))

    def __enter__(self):
        def draw(*args, **kwargs):
            got = self._draw(*args, **kwargs)
            if not self.episodes or len(self.episodes[-1]["crops"]) == 2:
                self.episodes.append({"crops": [], "masks": []})
            self.episodes[-1]["crops"].append([t.clone() for t in got])
            return got
        ttf.draw_train_offsets = draw
        return self

    def __exit__(self, *exc):
        ttf.draw_train_offsets = self._draw
        self._hook.remove()


def _cached_eval(root, cfg_path, mesh=None, n=6):
    """The tiny split's cached evaluator: its table and result."""
    cfg = load_config(cfg_path, opts=[
        "TEST.ONLY_TEST=true", "TEST.CACHE_FEATURES=true",
        "TEST.CACHE_EVAL_BATCH=3", "TEST.CACHE_ENCODE_VIDEOS=5",
        "DATA.NUM_WORKERS=1", f"DEVICE.NUM_CHIPS={mesh.world if mesh else 1}"],
        splits_root=root)
    learner = build_learner(cfg, log_fn=lambda *_: None, device="cpu",
                            mesh=mesh, allow_random_weights=True)
    catalog, sampler = build_catalog_and_sampler(
        cfg, "test", False, int(cfg.TEST.QUERY_PER_CLASS))
    ev = cached_evaluator(cfg, learner, catalog, sampler,
                          log_fn=lambda *_: None)
    try:
        _, plan_sampler = build_catalog_and_sampler(
            cfg, "test", False, int(cfg.TEST.QUERY_PER_CLASS))
        table, row_of = ev.build_table([plan_sampler.sample()
                                        for _ in range(n)])
        res = ev.evaluate(n)
    finally:
        ev.close()
        learner.close()
    return table, row_of, res


def _ranks(mesh, spec):
    """The rank side of (a)-(e) and of the randomness check; each rank
    saves what it got as ``rank<r>.pt`` under ``spec['out']``."""
    torch.set_num_threads(1)
    out = {}
    transform = tlearner_mod.episode_device_transform
    tlearner_mod.episode_device_transform = _eval_transform
    try:
        for backbone, init in spec["jax_init"].items():
            a = _clipspm(backbone, init, mesh=mesh, dropout=False)
            out[backbone] = (a.train_episodes(_mine(spec["a_eps"], mesh)),
                             a.model.state_dict())
    finally:
        tlearner_mod.episode_device_transform = transform

    b = _clipspm("test-tiny-rn", spec["clipspm_init"], mesh=mesh)
    with _Draws(b.model) as draws:
        out["clipspm"] = _two_steps(b, spec["eps"], mesh)
    out["draws"] = draws.episodes
    out["ta2n"] = _two_steps(_ta2n(spec["ta2n_init"], mesh=mesh),
                             spec["ta2n_eps"], mesh)

    bf = _clipspm("test-tiny-rn", spec["clipspm_init"], mesh=mesh,
                  accum="bfloat16")
    bf.train_episodes(_mine(spec["eps"][:4], mesh))
    out["bf16_grads"] = {k: p.grad.clone()
                         for k, p in bf.model.named_parameters()}

    d = _clipspm("test-tiny-rn", spec["clipspm_init"], mesh=mesh)
    out["d"] = d.evaluate(3, source=iter(_mine(spec["eval_eps"], mesh)),
                          batch_size=3)
    out["e"] = _cached_eval(spec["root"], spec["cfg_path"], mesh)
    torch.save(out, os.path.join(spec["out"], f"rank{mesh.rank}.pt"))
    return out


# -- fixtures -------------------------------------------------------------------

@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ddp_split"))
    return root, make_dataset(root)


@pytest.fixture(scope="module")
def jax_mesh_step():
    """(a): the JAX Learner's SGD step over 4 episodes on a 2-device mesh
    (dropout off, the eval transform) for ``test-tiny``, from variables
    carried into the port's tree."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from clipspm_tpu.data import transforms as jtf
    from clipspm_tpu.data.episode import Episode as JEpisode
    from clipspm_tpu.models.backbones.clip import CLIP_ARCHS as J_ARCHS
    from clipspm_tpu.models.fsar import CLIPSPMModel as JModel
    from clipspm_tpu.parallel import make_mesh
    from clipspm_tpu.train import learner as jlearner_mod
    from clipspm_tpu.train.learner import TransformSpec as JSpec
    from clipspm_tpu.utils.config import ConfigNode as JConfig

    devices = jax.devices("cpu")
    assert len(devices) >= N, "the conftest's virtual CPU devices"
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    eps = _episodes(5, 4)
    S, Q = WAY * SHOT, WAY * QUERIES
    out = {"eps": eps}
    for backbone in ("test-tiny",):
        arch = J_ARCHS[backbone]
        model = JModel(arch=arch, way=WAY, shot=SHOT, spm=dict(SPM))
        dummy = (jnp.zeros((S, T, IMG, IMG, 3)),
                 jnp.zeros((Q, T, IMG, IMG, 3)),
                 jnp.arange(S, dtype=jnp.int32) % WAY,
                 jnp.zeros((S,), jnp.int32), jnp.zeros((Q,), jnp.int32),
                 jnp.zeros((CLASSES, arch.embed_dim)),
                 jnp.zeros((CLASSES, arch.embed_dim)))
        variables = model.init(jax.random.PRNGKey(0), *dummy)
        tree = lambda v: {"params": to_np(v["params"]),  # noqa: E731
                          "batch_stats": to_np(v.get("batch_stats", {}))}
        text = np.random.default_rng(1).normal(
            size=(CLASSES, arch.embed_dim)).astype(np.float32)
        mesh = make_mesh(n_dp=N, devices=devices[:N])
        with pytest.MonkeyPatch.context() as mp, mesh:
            mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
            mp.setattr(jlearner_mod, "episode_device_transform",
                       lambda images, rng, *, train, **kw:
                       jtf.episode_device_transform(images, rng,
                                                    train=False, **kw))
            learner = jlearner_mod.Learner(
                JConfig(_cfg(backbone)), model, variables,
                text_train=text, text_test=text,
                transform=JSpec(img_size=IMG, resize_to=PX), mesh=mesh,
                parallel_episodes=N)
            metrics = learner.train_episodes([JEpisode(**{
                f: getattr(e, f) for f in (
                    "support_images", "support_labels", "target_images",
                    "target_labels", "real_support_labels",
                    "real_target_labels", "batch_class_list")})
                for e in eps])
        st = learner.state
        out[backbone] = dict(
            init=weights.model_state_dict(tree(variables)), metrics=metrics,
            after=weights.model_state_dict(
                tree({"params": st.params, "batch_stats": st.batch_stats})))
    return out


@pytest.fixture(scope="module")
def ranks(split, jax_mesh_step, tmp_path_factory):
    """Both ranks' results, and the inputs they were given."""
    root, cfg_path = split
    out = str(tmp_path_factory.mktemp("ddp_ranks"))
    spec = dict(
        out=out, root=root, cfg_path=cfg_path,
        jax_init={"test-tiny": jax_mesh_step["test-tiny"]["init"]},
        a_eps=jax_mesh_step["eps"],
        clipspm_init=_random_state(CLIPSPMModel(
            arch=CLIP_ARCHS["test-tiny-rn"], way=WAY, shot=SHOT,
            spm=dict(SPM)), 7),
        ta2n_init=_random_state(build_model(ConfigNode(TA2N_CFG)), 8),
        eps=_episodes(0, 8),
        ta2n_eps=_episodes(1, 8, queries=TA2N["QUERIES"], t=TA2N["T"],
                           px=TA2N["PX"]),
        eval_eps=_episodes(2, 3))
    t0 = time.perf_counter()
    pmesh.spawn(_ranks, N, "cpu", args=(spec,), timeout_s=300)
    spec["seconds"] = time.perf_counter() - t0
    got = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
           for r in range(N)]
    return spec, got


@contextlib.contextmanager
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def oracle(ranks):
    """The same steps in one process: ``parallel_episodes=2`` (the plain
    version of the ranks) and 1 (the sequential step)."""
    spec, _ = ranks
    out = {}
    with _one_thread():
        for parallel in (N, 1):
            b = _clipspm("test-tiny-rn", spec["clipspm_init"],
                         parallel=parallel)
            with _Draws(b.model) as draws:
                out[("clipspm", parallel)] = _two_steps(b, spec["eps"])
            out[("draws", parallel)] = draws.episodes
            out[("ta2n", parallel)] = _two_steps(
                _ta2n(spec["ta2n_init"], parallel=parallel),
                spec["ta2n_eps"])
        bf = _clipspm("test-tiny-rn", spec["clipspm_init"], parallel=N,
                      accum="bfloat16")
        bf.train_episodes(spec["eps"][:4])
        out["bf16_grads"] = {k: p.grad.clone()
                             for k, p in bf.model.named_parameters()}
        # each episode of the first step alone, at its own index
        out["episode_grads"] = []
        for e, ep in enumerate(spec["eps"][:4]):
            one = _clipspm("test-tiny-rn", spec["clipspm_init"])
            one.episode = e
            one.train_episodes([ep])
            out["episode_grads"].append(
                {k: p.grad.clone() for k, p in one.model.named_parameters()
                 if k in out["bf16_grads"]})
    return out


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).norm()
                 / max(float(want.double().norm()), 1e-30))


# -- (a) the ranks against the JAX Learner on a 2-device mesh --------------------

def test_ranks_match_the_jax_learner_on_a_two_device_mesh(jax_mesh_step,
                                                          ranks):
    want = jax_mesh_step["test-tiny"]
    for metrics, state in (r["test-tiny"] for r in ranks[1]):
        np.testing.assert_allclose(metrics["loss"], want["metrics"]["loss"],
                                   rtol=1e-4)
        assert metrics["acc"] == want["metrics"]["acc"]
        assert set(state) == set(want["after"])
        for key, w in want["after"].items():
            # SGD's decay moves every parameter
            assert not torch.equal(w, want["init"][key]), key
            torch.testing.assert_close(state[key], w, rtol=1e-4, atol=1e-5,
                                       msg=key)


@pytest.mark.parametrize("weights_", [(1.0, 1.0), (1.0, 0.0)])
def test_episode_mean_is_the_jax_steps_mean(weights_):
    """``episode_mean_`` over a microstep's real episodes (a padding one
    is not run, so it adds nothing) against the JAX step's
    ``tensordot(ws, s_new) / max(sum(ws), 1)`` (``learner.py:274-280``)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    new = rng.normal(size=(2, 5)).astype(np.float32)
    ws = np.asarray(weights_, np.float32)
    want = np.asarray(jnp.tensordot(jnp.asarray(ws), jnp.asarray(new),
                                    axes=(0, 0)) / jnp.maximum(ws.sum(), 1.0))
    buf = torch.zeros(5)
    sums = sum(torch.from_numpy(new[e]) for e in range(2) if ws[e])
    pmesh.episode_mean_([buf], sums, int(ws.sum()))
    np.testing.assert_array_equal(buf.numpy(), want)


# -- (b), (c) the ranks against parallel_episodes=2 in one process --------------

# The ranks sum the same per-episode gradients in another order (rank 0's
# two, rank 1's two, then the all-reduce): in the first step each gradient
# tensor to 1e-6 relative (measured <= 1.2e-7). The second starts from
# parameters that far apart, which the BatchNorm-fed cancelling sums
# amplify: each tensor to 1e-3 (measured <= 4.8e-5). The loss to 1e-6, the
# parameters and the BatchNorm buffers to rtol 1e-4, atol 1e-5, as (a).
GRAD_REL = (1e-6, 1e-3)


@pytest.mark.parametrize("model", ["clipspm", "ta2n"])
def test_ranks_match_parallel_episodes_in_one_process(model, ranks, oracle):
    want = oracle[(model, N)]
    for got in (r[model] for r in ranks[1]):
        for step, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g["metrics"]["loss"],
                                       w["metrics"]["loss"], rtol=1e-6)
            np.testing.assert_allclose(g["metrics"]["acc"],
                                       w["metrics"]["acc"], rtol=1e-6)
            assert g["episode"] == w["episode"] == (4, 7)[step]
            for key, grad in w["grads"].items():
                if float(grad.norm()) > 1e-6:
                    assert _rel(g["grads"][key], grad) <= GRAD_REL[step], \
                        (step, key)
            for key, v in w["state"].items():
                torch.testing.assert_close(g["state"][key], v, rtol=1e-4,
                                           atol=1e-5, msg=(step, key))


@pytest.mark.parametrize("model", ["clipspm", "ta2n"])
def test_batchnorm_buffers_are_the_microsteps_mean(model, ranks, oracle):
    """Every BatchNorm buffer after both steps is the ranks' mean, which
    the oracle computes in one process; the sequential step
    (``parallel_episodes=1``) chains them and lands elsewhere; the masked
    step's last microstep (one real episode) keeps that episode's."""
    names = [k for k in oracle[(model, N)][0]["state"]
             if "running_" in k or k.endswith("num_batches_tracked")]
    assert names
    chained = oracle[(model, 1)][-1]["state"]
    for got in (r[model] for r in ranks[1]):
        after = got[-1]["state"]
        for key in names:
            want = oracle[(model, N)][-1]["state"][key]
            assert torch.equal(after[key], want) or _rel(
                after[key], want) <= 1e-6, key
        assert any(_rel(chained[k], after[k]) > 1e-3 for k in names
                   if "running_" in k)


def test_the_gradient_is_the_sum_over_the_ranks(ranks, oracle):
    """Averaged over the ranks (``DistributedDataParallel``'s default) the
    summed gradient would be half the one-process sum."""
    want = oracle[("clipspm", N)][0]["grads"]
    got = ranks[1][0]["clipspm"][0]["grads"]
    key = max(want, key=lambda k: float(want[k].norm()))
    assert _rel(got[key], want[key]) <= GRAD_REL[0]
    assert _rel(got[key] / N, want[key]) > 0.4


# SOLVER.ACCUM_DTYPE=bfloat16. The one-process step and the ranks keep the
# JAX rule: a microstep's M fp32 gradients summed (over the ranks, one fp32
# all-reduce a microstep), then rounded into the bf16 sum (learner.py:271,
# :297-298). At N=2 two fp32 addends sum alike in either order, so the
# ranks equal the one-process oracle bit for bit, and both the rule replayed
# from each episode's own fp32 gradient; the bf16 sum is within BF16_TOL of
# the fp32 one (Frobenius over the whole gradient; four bf16 ulps at unit
# scale, the bound the remat policies' bf16 gradients are held to).
BF16_TOL = 4 * 2.0 ** -8


def test_bf16_accumulation_over_ranks(ranks, oracle):
    bf16 = torch.bfloat16
    g = oracle["episode_grads"]
    jax_rule = {k: ((g[0][k] + g[1][k]).to(bf16)
                    + (g[2][k] + g[3][k]).to(bf16)).float() for k in g[0]}
    for k in jax_rule:
        assert torch.equal(oracle["bf16_grads"][k], jax_rule[k]), k
        for got in (r["bf16_grads"] for r in ranks[1]):
            assert torch.equal(got[k], oracle["bf16_grads"][k]), k

    def rel(a, b):
        num = sum(float((a[k].double() - b[k].double()).pow(2).sum())
                  for k in b)
        return (num / sum(float(b[k].double().pow(2).sum())
                          for k in b)) ** 0.5

    fp32 = oracle[("clipspm", N)][0]["grads"]
    assert 0 < rel(oracle["bf16_grads"], fp32) <= BF16_TOL


# -- randomness ------------------------------------------------------------------

def test_an_episodes_draws_do_not_depend_on_the_ranks(ranks, oracle):
    """Each episode draws the same flips, crop offsets (support and query
    clips) and dropout masks on its rank at N=2 as at N=1 and in the
    oracle: episode 1, for one, runs on rank 1 and second at N=1. Over
    the two steps (7 real episodes) rank 0 runs 0, 2, 4, 6 and rank 1
    runs 1, 3, 5."""
    for parallel in (1, N):
        want = oracle[("draws", parallel)]
        assert len(want) == 7
        for rank, got in enumerate(r["draws"] for r in ranks[1]):
            episodes = list(range(rank, 7, N))
            assert len(got) == len(episodes)
            for g, e in zip(got, episodes):
                w = want[e]
                assert len(g["masks"]) == len(w["masks"]) >= 1
                for a, b in zip(g["crops"] + g["masks"],
                                w["crops"] + w["masks"]):
                    for x, y in zip(a if isinstance(a, list) else [a],
                                    b if isinstance(b, list) else [b]):
                        assert torch.equal(x, y), (parallel, rank, e)
    # distinct episodes draw differently
    assert not torch.equal(want[0]["masks"][0], want[1]["masks"][0])


# -- (d), (e) evaluation ---------------------------------------------------------

def test_eval_batch_rounds_up_to_the_ranks_and_matches_one_rank(ranks):
    spec, got = ranks
    one = _clipspm("test-tiny-rn", spec["clipspm_init"])
    with _one_thread():
        want = one.evaluate(3, source=iter(spec["eval_eps"]), batch_size=3)
    for res in (r["d"] for r in got):
        np.testing.assert_allclose(res["loss_acc"], want["loss_acc"],
                                   rtol=1e-6, atol=0)
        for key in ("accuracy", "confidence", "loss"):
            np.testing.assert_allclose(res[key], want[key], rtol=1e-6)


def test_cached_evaluator_gathers_the_table_and_matches_one_rank(split,
                                                                 ranks):
    with _one_thread():
        table, row_of, res = _cached_eval(*split)
    for got_table, got_rows, got in (r["e"] for r in ranks[1]):
        assert got_rows == row_of
        assert got_table.shape == table.shape
        torch.testing.assert_close(got_table, table, rtol=1e-5, atol=1e-6)
        for key in ("accuracy", "confidence", "loss"):
            np.testing.assert_allclose(got[key], res[key], rtol=1e-5)
        assert got["unique_videos"] == res["unique_videos"]


# -- (g) a rank that raises ------------------------------------------------------

def _rank_raises(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    mesh.barrier()      # rank 0 waits on a collective rank 1 never joins


def test_a_rank_that_raises_ends_the_run():
    """Rank 1 raises while rank 0 waits on a collective: the run raises
    (the error of whichever rank ends first: rank 1's, or rank 0's lost
    connection) well inside the group's timeout, and no rank is left."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    with pytest.raises(mp.ProcessRaisedException):
        pmesh.spawn(_rank_raises, N, "cpu", timeout_s=120)
    assert time.perf_counter() - t0 < 60
    assert not mp.active_children()


# -- (h) a missing frame file ------------------------------------------------------

def _loader_stream(mesh, root, cfg_path, n, missing=None):
    """The first ``n`` items of the train stream's loader (rank ``mesh``'s
    share, or the whole); ``missing=(video, frame)``: that frame file is
    gone since the catalog was read."""
    cfg = load_config(cfg_path, splits_root=root)
    catalog, sampler = build_catalog_and_sampler(
        cfg, "train", True, int(cfg.TRAIN.QUERY_PER_CLASS))
    if missing is not None:
        catalog.records[missing[0]].frame_paths[missing[1]] += ".gone"
    loader = pipeline.EpisodeLoader(
        sampler, num_workers=1, prefetch=2,
        shard=(mesh.dp_rank, mesh.dp_world) if mesh else (0, 1),
        group=mesh.loader_group() if mesh else None)
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        loader.close()


def _rank_stream(mesh, root, cfg_path, missing, out):
    torch.set_num_threads(1)
    torch.save(_loader_stream(mesh, root, cfg_path, 6, missing),
               os.path.join(out, f"stream{mesh.rank}.pt"))


def _plans(root, cfg_path, n):
    cfg = load_config(cfg_path, splits_root=root)
    catalog, sampler = build_catalog_and_sampler(
        cfg, "train", True, int(cfg.TRAIN.QUERY_PER_CLASS))
    return catalog, [sampler.sample() for _ in range(n)]


def _frames(plan):
    return {(int(v), int(i)) for vids, idx in (
        (plan.support_video_idx, plan.support_frame_idx),
        (plan.target_video_idx, plan.target_frame_idx))
        for v, row in zip(vids, idx) for i in row}


def test_a_missing_frame_is_dropped_alike_on_every_rank(split, tmp_path):
    """A frame file of the stream's second episode (rank 1's) is missing:
    one rank alone drops that plan and decodes the next in its place; both
    ranks drop it too and decode N=1's episodes in their places."""
    root, cfg_path = split
    catalog, plans = _plans(root, cfg_path, 8)
    # a frame of that episode alone among the first eight
    missing = sorted(_frames(plans[1]).difference(*(
        _frames(p) for i, p in enumerate(plans) if i != 1)))[0]
    want = _loader_stream(None, root, cfg_path, 6, missing)
    kept = [p for i, p in enumerate(plans) if i != 1]
    for w, plan in zip(want, kept):
        np.testing.assert_array_equal(
            w.support_images, pipeline.decode_plan(plan, catalog)
            .support_images)
    pmesh.spawn(_rank_stream, N, "cpu",
                args=(root, cfg_path, missing, str(tmp_path)), timeout_s=120)
    for rank in range(N):
        got = torch.load(str(tmp_path / f"stream{rank}.pt"),
                         weights_only=False)
        assert len(got) == len(want)
        for slot, (g, w) in enumerate(zip(got, want)):
            if slot % N != rank:
                assert g is None
                continue
            for f in ("support_images", "target_images", "target_labels",
                      "batch_class_list"):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


def _jax_stream(root, cfg_path, n):
    """The first ``n`` episodes of the JAX loader over the same split."""
    from clipspm_tpu.data.pipeline import EpisodeLoader as JLoader
    from clipspm_tpu.data.sampler import EpisodeSampler as JSampler
    from clipspm_tpu.data.splits import load_split as jload_split

    cfg = load_config(cfg_path, splits_root=root)
    catalog = jload_split(cfg.traintestlist, cfg.path, "train",
                          cfg.DATA.DATASET, int(cfg.DATA.SEQ_LEN),
                          int(cfg.DATA.get("SPLIT", 3)))
    loader = JLoader(JSampler(
        catalog, way=int(cfg.TRAIN.WAY), shot=int(cfg.TRAIN.SHOT),
        queries=int(cfg.TRAIN.QUERY_PER_CLASS), seq_len=int(cfg.DATA.SEQ_LEN),
        train=True, seed=int(cfg.MODEL.SEED)), num_workers=1, prefetch=2)
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        loader.close()


def test_a_rank_whose_own_frame_fails_to_decode_stops(split, tmp_path):
    """A frame that exists but does not decode, in the stream's second
    episode (rank 1's slot at N=2): the JAX loader drops the episode and the
    next plan takes its slot. One rank alone and both ranks (which exchange
    a decode flag a slot) give that stream: the run goes on, rank 1 decodes
    the next plan in slot 1, and every later slot shifts by one plan."""
    root = str(tmp_path / "split")
    shutil.copytree(split[0], root)
    cfg_path = os.path.join(root, "tiny.yaml")
    with open(split[1]) as f:
        text = f.read().replace(split[0], root)
    with open(cfg_path, "w") as f:
        f.write(text)
    catalog, plans = _plans(root, cfg_path, 8)
    # a frame of that episode alone among the first eight
    video, frame = sorted(_frames(plans[1]).difference(*(
        _frames(p) for i, p in enumerate(plans) if i != 1)))[0]
    with open(catalog.records[video].frame_paths[frame], "wb") as f:
        f.write(b"not a jpeg")
    want = _jax_stream(root, cfg_path, 6)
    kept = [p for i, p in enumerate(plans) if i != 1]
    for w, plan in zip(want, kept):
        np.testing.assert_array_equal(
            w.support_images, pipeline.decode_plan(plan, catalog)
            .support_images)
    streams = [_loader_stream(None, root, cfg_path, 6)]
    out = tmp_path / "streams"
    out.mkdir()
    pmesh.spawn(_rank_stream, N, "cpu",
                args=(root, cfg_path, None, str(out)), timeout_s=120)
    streams += [torch.load(str(out / f"stream{r}.pt"), weights_only=False)
                for r in range(N)]
    for world, rank, got in ((1, 0, streams[0]), (N, 0, streams[1]),
                             (N, 1, streams[2])):
        assert len(got) == len(want)
        for slot, (g, w) in enumerate(zip(got, want)):
            if slot % world != rank:
                assert g is None
                continue
            for f in ("support_images", "target_images", "target_labels",
                      "batch_class_list"):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
