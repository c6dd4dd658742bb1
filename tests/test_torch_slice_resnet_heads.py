"""The port's five ResNet heads as a slice: both evaluators against the
JAX package's, and the CLI's train -> ONLY_TEST round trip.

On a synthetic UCF-layout split (8 test classes x 3 videos of 6 frames at
96 px, 64-px crops so the trunk's maps are 2x2, T=4, 5-way 1-shot 2-query,
``DATA.IMG_NORM``), ``test-tiny-resnet`` (ResNet-18 at width 8) weights
drawn once per head are carried into the port. otam, trx and strm run the
feature-cached evaluator (``evaluate_cached``), soap and molo the uncached
one (``Learner.evaluate``, 2 episodes a step over the test
``EpisodeLoader``), each against its JAX twin on the same split, seed and
episode count: accuracy and CI equal, the loss within 1e-4 (and 2e-6
relative). Then one masked TASKS_PER_BATCH=2 train step per head (the
second episode padding) of the JAX ``Learner`` and of the port's from the
same weights, dropout off and the eval transform on both sides (SGD as
shipped, molo under Adam); and the port's CLI trains otam (cached
validation) and molo (uncached validation) on the split's train side,
checkpoints, and an ONLY_TEST run restores ``checkpoint_best``.
"""

import os
import re
import sys

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from make_synthetic_dataset import make_dataset  # noqa: E402

from clipspm_tpu.data import transforms as jtf  # noqa: E402
from clipspm_tpu.data.episode import Episode as JEpisode  # noqa: E402
from clipspm_tpu.data.pipeline import EpisodeLoader as JLoader  # noqa: E402
from clipspm_tpu.models.fsar import build_model as jax_build_model  # noqa: E402
from clipspm_tpu.train.feature_cache import evaluate_cached as jax_cached  # noqa: E402
from clipspm_tpu.train import learner as jlearner_mod  # noqa: E402
from clipspm_tpu.train.learner import Learner as JLearner  # noqa: E402
from clipspm_tpu.train.learner import TransformSpec as JSpec  # noqa: E402
from clipspm_tpu.train.setup import \
    build_catalog_and_sampler as jax_sampler  # noqa: E402
from clipspm_tpu.utils.config import load_config as jax_load  # noqa: E402
from clipspm_tpu_torch import weights  # noqa: E402
from clipspm_tpu_torch.cli.run import main as port_cli  # noqa: E402
from clipspm_tpu_torch.data import transforms as ttf  # noqa: E402
from clipspm_tpu_torch.data.episode import Episode  # noqa: E402
from clipspm_tpu_torch.data.pipeline import EpisodeLoader  # noqa: E402
from clipspm_tpu_torch.models.fsar import build_model  # noqa: E402
from clipspm_tpu_torch.train.feature_cache import evaluate_cached  # noqa: E402
from clipspm_tpu_torch.train import learner as tlearner_mod  # noqa: E402
from clipspm_tpu_torch.train.learner import Learner  # noqa: E402
from clipspm_tpu_torch.train.setup import \
    build_catalog_and_sampler  # noqa: E402
from clipspm_tpu_torch.utils.config import load_config  # noqa: E402

from test_torch_resnet_heads import _variables, jax_tree  # noqa: E402

pytest.importorskip("PIL.Image")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPISODES, WAY, T, IMG = 6, 5, 4, 64
OPTS = ["MODEL.BACKBONE=test-tiny-resnet", "USE_AMP=false",
        f"DATA.IMG_SIZE={IMG}", f"DATA.SEQ_LEN={T}", f"TRAIN.WAY={WAY}",
        "TEST.ONLY_TEST=true", f"TEST.TEST_EPISODES={EPISODES}",
        "TEST.QUERY_PER_CLASS=2", "TEST.EVAL_BATCH=2",
        "TEST.CACHE_EVAL_BATCH=4", "TEST.CACHE_ENCODE_VIDEOS=8",
        "DATA.NUM_WORKERS=2", "DATA.IMG_NORM=true"]
CACHED, UNCACHED = ("otam", "trx", "strm"), ("soap", "molo")


def _cfg_path(name):
    return os.path.join(REPO, "configs", name, "ucf.yaml")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """The synthetic split, its test frames redrawn: a colour per video
    (not per class) plus noise. With the class hues the random models are
    right in every episode (the CI is 0 and the equality vacuous); frames
    of noise alone make the videos' features nearly collinear, where the
    argmax is rounding."""
    from PIL import Image

    root = str(tmp_path_factory.mktemp("slice_resnet_heads"))
    make_dataset(root, classes=8, videos=3, frames=6, size=96,
                 dataset="ucf", img_size=IMG, seq_len=T)
    rng = np.random.default_rng(5)
    test = os.path.join(root, "ucf_256x256q5_l8", "test")
    for cls in sorted(os.listdir(test)):
        for vid in sorted(os.listdir(os.path.join(test, cls))):
            vdir = os.path.join(test, cls, vid)
            base = rng.uniform(0, 255, 3)
            for f in sorted(os.listdir(vdir)):
                img = base + rng.normal(0, 24, (96, 96, 3))
                Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                    os.path.join(vdir, f), quality=90)
    return root


def _learners(name, root):
    """The JAX learner and the port's, holding the same drawn weights, and
    each package's config."""
    opts = [*OPTS, f"DATA.DATA_DIR={root}"]
    jcfg = jax_load(_cfg_path(name), opts=opts, splits_root=root)
    cfg = load_config(_cfg_path(name), opts=opts, splits_root=root)
    jmodel = jax_build_model(jcfg)
    S = WAY * int(cfg.TRAIN.SHOT)
    variables = _variables(jmodel, np.zeros((S, T, IMG, IMG, 3), np.float32),
                           np.zeros((WAY, T, IMG, IMG, 3), np.float32),
                           np.arange(S, dtype=np.int32) % WAY, seed=1)
    zeros = np.zeros((1, 1), np.float32)
    jl = JLearner(jcfg, jmodel, jax_tree(variables), text_train=zeros, text_test=zeros, log_fn=lambda *_: None)
    model = build_model(cfg)
    model.load_state_dict(weights.model_state_dict(variables), strict=True)
    tz = torch.zeros(1, 1)
    pl = Learner(cfg, model, tz, tz, torch.device("cpu"),
                 log_fn=lambda *_: None)
    return jl, pl, jcfg, cfg


def _assert_same(got, want):
    # a degenerate stream (every episode the same accuracy) would make the
    # equality vacuous
    assert want["confidence"] > 0
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], atol=1e-3)
    np.testing.assert_allclose(got["confidence"], want["confidence"],
                               atol=1e-3)
    # strm's random-weight loss is about 800, where an fp32 ulp is 6e-5
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-6,
                               atol=1e-4)


@pytest.mark.parametrize("name", CACHED)
def test_cached_eval_matches_jax(split, name):
    jl, pl, jcfg, cfg = _learners(name, split)
    want = jax_cached(jcfg, jl, log_fn=lambda *_: None)
    got = evaluate_cached(cfg, pl, log_fn=lambda *_: None)
    assert got["unique_videos"] == want["unique_videos"]
    _assert_same(got, want)


@pytest.mark.parametrize("name", CACHED)
def test_cached_eval_equals_uncached(split, name):
    """The port's two evaluators over the same seeded test stream: the
    cached one's loss and accuracy are the uncached one's."""
    _, pl, _, cfg = _learners(name, split)
    src = EpisodeLoader(build_catalog_and_sampler(
        cfg, "test", False, int(cfg.TEST.QUERY_PER_CLASS))[1],
        num_workers=2, prefetch=2, use_native=False)
    try:
        want = pl.evaluate(EPISODES, source=src, batch_size=2)
    finally:
        src.close()
    got = evaluate_cached(cfg, pl, log_fn=lambda *_: None)
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], atol=1e-3)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("name", UNCACHED)
def test_uncached_eval_matches_jax(split, name):
    """Two episodes a step over each package's test loader; the partial
    last step of the JAX evaluator's padding is not run by the port's."""
    jl, pl, jcfg, cfg = _learners(name, split)
    assert not hasattr(pl.model, "feature_cacheable")
    queries = int(cfg.TEST.QUERY_PER_CLASS)
    jsrc = JLoader(jax_sampler(jcfg, "test", False, queries)[1],
                   num_workers=2, prefetch=2, use_native=False)
    tsrc = EpisodeLoader(build_catalog_and_sampler(cfg, "test", False,
                                                   queries)[1],
                         num_workers=2, prefetch=2, use_native=False)
    try:
        want = jl.evaluate(EPISODES - 1, source=jsrc, batch_size=2)
        got = pl.evaluate(EPISODES - 1, source=tsrc, batch_size=2)
    finally:
        jsrc.close()
        tsrc.close()
    assert not pl.model.training
    _assert_same(got, want)


@pytest.mark.parametrize("name,cached", [("otam", True), ("molo", False)])
def test_cli_trains_checkpoints_and_restores(split, tmp_path, name, cached):
    """Train 6 episodes in steps of 2 (validation at 4, cached for otam,
    uncached for molo, whose config sets no cache), checkpoint, then
    ONLY_TEST from ``checkpoint_best``: the restored weights are the saved
    ones."""
    ckpt = str(tmp_path / "ckpt")
    flags = ["--cfg", _cfg_path(name), "--splits-root", split, "--device",
             "cpu"]
    common = [*OPTS, f"DATA.DATA_DIR={split}", "TRAIN.QUERY_PER_CLASS=1",
              "TRAIN.TASKS_PER_BATCH=2", "TEST.TEST_EPISODES=3",
              f"CHECKPOINT.CHECKPOINT_DIR={ckpt}"]
    res = port_cli([*flags, *common, "TEST.ONLY_TEST=false",
                    "TRAIN.TRAIN_EPISODES=6", "TRAIN.VAL_FREQ=4",
                    "TRAIN.PRINT_FREQ=2", "CHECKPOINT.SAVE_FREQ=4"])
    assert res["episodes"] == 6
    with open(os.path.join(ckpt, "log.txt")) as f:
        log = f.read()
    tasks = re.findall(r"Task \[(\d+)/6\], Train Loss: (\S+),", log)
    assert [int(t) for t, _ in tasks] == [2, 4, 6]
    assert all(np.isfinite(float(v)) for _, v in tasks)
    val_line = ("feature-cached eval: 3 episodes" if cached
                else "uncached eval: 3 episodes in batches of 2")
    assert log.count(val_line) == 1
    assert len(re.findall(r"Val @ 4: acc", log)) == 1
    for tag in ("best", "iter_4"):
        assert os.path.isfile(os.path.join(ckpt, f"checkpoint_{tag}",
                                           "checkpoint.pt"))
    saved = torch.load(os.path.join(ckpt, "checkpoint_best",
                                    "checkpoint.pt"), weights_only=True)

    from clipspm_tpu_torch.train import setup

    built = []
    build = setup.build_learner

    def recording(*args, **kwargs):
        built.append(build(*args, **kwargs))
        return built[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(setup, "build_learner", recording)
        out = port_cli([*flags, *common])
    assert np.isfinite(out["loss"])
    with open(os.path.join(ckpt, "log.txt")) as f:
        log = f.read()
    assert f"Loaded checkpoint_best from {ckpt}" in log
    assert log.count(val_line) == 2 and "FRESH" not in log
    restored = built[0].model.state_dict()
    assert restored.keys() == saved["model"].keys()
    assert all(torch.equal(restored[k], v) for k, v in saved["model"].items())


# -- one masked train step against the JAX Learner -----------------------------

STEP_WAY, STEP_QUERIES, PX = 2, 2, 72
# The step's gradient is ill-conditioned (every convolution of the trunk
# feeds a train-mode BatchNorm), and the JAX package's fp32 is the less
# accurate side: flax's BatchNorm takes the batch variance as E[x^2] -
# E[x]^2 in one pass. So each fp32 step is held against the port's step
# in fp64 from the same weights (the witness: with BatchNorm on its running
# statistics the models' gradients agree with JAX's to 1e-4 per tensor,
# test_torch_resnet_heads.py, so the math is the same), each
# within its own rounding as measured here: the loss to 1e-4 relative
# (port; measured <= 3.7e-5) and 1e-3 (JAX; 4.3e-4 on strm); the
# optimizer's first moment (SGD's momentum trace g + wd*p, Adam's mu) per
# tensor to 1e-2 and all tensors together to 2e-3 (port; <= 2.8e-3 and
# 9.5e-4), 1e-1 and 5e-2 (JAX; <= 3.4e-2 and 1.5e-2). A wrong gradient
# path or weight layout is off by O(1). The running statistics agree
# better: port against JAX to 1e-4 relative (JAX's <= 1.7e-5 from the
# witness). The port's parameters after the step against the witness's:
# SGD's update per tensor to 1e-2 relative; Adam's (about LR * sign(mu))
# to 1e-2 * LR where the witness's moment sign is decided (|mu| above 0.01
# rms of its tensor), else within 2 * LR.
PORT_LOSS_REL, JAX_LOSS_REL, STATS_REL = 1e-4, 1e-3, 1e-4
PORT_GRAD_REL, PORT_GRAD_ALL, JAX_GRAD_REL, JAX_GRAD_ALL = \
    1e-2, 2e-3, 1e-1, 5e-2
# SGD's update is LR times the moment: a large LR makes it stand far above
# the parameters' fp32 rounding
STEP_LR = {"sgd": 0.05, "adam": 5e-5}


def _step_episodes(shot, seed, n=2):
    """uint8 episodes: a colour per video under strong noise (frames of
    one flat colour make the trunk's batch statistics, and with them the
    gradient, worse conditioned still)."""
    rng = np.random.default_rng(seed)
    S, Q = STEP_WAY * shot, STEP_WAY * STEP_QUERIES
    out = []
    for _ in range(n):
        classes = rng.choice(6, STEP_WAY, replace=False).astype(np.int32)
        sl = rng.permutation(np.repeat(np.arange(STEP_WAY), shot)).astype(
            np.int32)
        tl = rng.permutation(np.repeat(np.arange(STEP_WAY), STEP_QUERIES)
                             ).astype(np.int32)
        base = rng.integers(0, 256, (S + Q, 1, 1, 1, 3))
        noise = rng.integers(0, 256, (S + Q, T, PX, PX, 3))
        frames = (0.3 * base + 0.7 * noise).astype(np.uint8)
        out.append(dict(
            support_images=frames[:S], support_labels=sl,
            target_images=frames[S:], target_labels=tl,
            real_support_labels=classes[sl], real_target_labels=classes[tl],
            batch_class_list=classes))
    return out


def _rel(got, want) -> float:
    got = torch.as_tensor(np.array(got), dtype=torch.float64)
    want = torch.as_tensor(np.array(want), dtype=torch.float64)
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_step(cfg, state, eps, dtype):
    """The port's learner after one masked step from ``state`` in
    ``dtype``, dropout off, the eval transform."""
    model = build_model(cfg).to(dtype)
    model.load_state_dict(state, strict=True)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    tz = torch.zeros(1, 1, dtype=dtype)
    learner = Learner(cfg, model, tz, tz, torch.device("cpu"),
                      transform=ttf.TransformSpec(img_size=IMG, resize_to=PX),
                      log_fn=lambda *_: None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlearner_mod, "episode_device_transform",
                   lambda images, *, train, gen=None, **kw:
                   ttf.episode_device_transform(images, train=False,
                                                dtype=dtype, **kw))
        metrics = learner.train_episodes([Episode(**e) for e in eps],
                                         n_valid=1)
    return learner, metrics


def _step(name):
    """The JAX learner's step (metrics, and its state in the port's keys)
    and the port's in fp32 and in fp64, from the same weights."""
    shot = 2 if name in ("otam", "strm") else 1
    cfgs = [load(_cfg_path(name), opts=[
        "MODEL.BACKBONE=test-tiny-resnet", "USE_AMP=false",
        f"DATA.IMG_SIZE={IMG}", f"DATA.SEQ_LEN={T}", f"TRAIN.WAY={STEP_WAY}",
        f"TRAIN.SHOT={shot}", f"TRAIN.QUERY_PER_CLASS={STEP_QUERIES}",
        "TRAIN.TASKS_PER_BATCH=2", "MODEL.TRANS_LINEAR_OUT_DIM=32",
        "MODEL.USE_CLASSIFICATION_VALUE=1.5", "MODEL.RECONS_COFF=0.5"])
        for load in (jax_load, load_config)]
    method = str(cfgs[1].SOLVER.OPTIM_METHOD)
    for cfg in cfgs:
        cfg.SOLVER.LR = STEP_LR[method]
    eps = _step_episodes(shot, seed=3)
    jmodel = jax_build_model(cfgs[0])
    S, Q = STEP_WAY * shot, STEP_WAY * STEP_QUERIES
    variables = _variables(jmodel, np.zeros((S, T, IMG, IMG, 3), np.float32),
                           np.zeros((Q, T, IMG, IMG, 3), np.float32),
                           np.arange(S, dtype=np.int32) % STEP_WAY, seed=4)
    zeros = np.zeros((1, 1), np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(jlearner_mod, "episode_device_transform",
                   lambda images, rng, *, train, **kw:
                   jtf.episode_device_transform(images, rng, train=False,
                                                **kw))
        jl = JLearner(cfgs[0], jmodel, jax_tree(variables), text_train=zeros,
                      text_test=zeros, transform=JSpec(img_size=IMG,
                                                       resize_to=PX))
        jmetrics = jl.train_episodes([JEpisode(**e) for e in eps], n_valid=1)
    st = jl.state
    stats = _np(st.batch_stats)
    moment = next(s for s in st.opt_state
                  if hasattr(s, "mu") or hasattr(s, "trace"))
    moment = moment.mu if hasattr(moment, "mu") else moment.trace
    before = weights.model_state_dict(variables)
    want = dict(metrics=jmetrics, episode=int(st.episode), method=method,
                before=before,
                after=weights.model_state_dict(
                    {"params": _np(st.params), "batch_stats": stats}),
                moment=weights.model_state_dict(
                    {"params": _np(moment), "batch_stats": stats}))
    port = _port_step(cfgs[1], before, eps, torch.float32)
    witness = _port_step(cfgs[1], {k: v.double() if v.is_floating_point()
                                   else v for k, v in before.items()},
                         eps, torch.float64)
    return want, port, witness


@pytest.mark.parametrize("name", CACHED + UNCACHED)
def test_one_masked_step_matches_jax(name):
    """Loss, accuracy, the episode count (the padding episode counts for
    nothing), every BatchNorm's running statistics (the trunk's; molo's
    decoder's too), the optimizer's first moment and the parameters after
    the step (SGD: otam, trx, strm, soap as shipped; molo: Adam with weight
    decay 5e-4), each to the tolerances above."""
    want, (learner, got), (wit, wit_got) = _step(name)
    for loss, tol in ((got["loss"], PORT_LOSS_REL),
                      (want["metrics"]["loss"], JAX_LOSS_REL)):
        np.testing.assert_allclose(loss, wit_got["loss"], rtol=tol)
    assert got["acc"] == want["metrics"]["acc"] == wit_got["acc"]
    assert learner.episode == want["episode"] == 1
    sd = learner.model.state_dict()
    assert set(sd) == set(want["after"])
    running = [k for k in want["after"] if "running_" in k]
    assert len(running) == 2 * (20 + (3 if name == "molo" else 0))
    for k in running:
        assert not torch.equal(want["after"][k], want["before"][k]), k
        assert _rel(sd[k], want["after"][k]) <= STATS_REL, k
    adam = want["method"] == "adam"
    buffer = "exp_avg" if adam else "momentum_buffer"
    lr = STEP_LR[want["method"]]
    wit_params = dict(wit.model.named_parameters())
    names = [k for k, _ in learner.model.named_parameters()]
    moments = {"port": [], "jax": [], "witness": []}
    for key, p in learner.model.named_parameters():
        w = wit_params[key]
        mu = wit.optimizer.state[w][buffer]
        port_mu = learner.optimizer.state[p][buffer]
        for side, m in (("port", port_mu), ("jax", want["moment"][key]),
                        ("witness", mu)):
            moments[side].append(torch.as_tensor(m).double().flatten())
        assert _rel(port_mu, mu) <= PORT_GRAD_REL, key
        assert _rel(want["moment"][key], mu) <= JAX_GRAD_REL, key
        w0 = want["before"][key].double()
        if not adam:
            assert _rel(p.detach() - w0, w.detach() - w0) <= PORT_GRAD_REL, \
                key
            continue
        sure = mu.abs() > 0.01 * mu.pow(2).mean().sqrt()
        diff = (p.detach().double() - w.detach()).abs()
        assert float((diff * sure).max()) <= 1e-2 * lr + 1e-7, key
        assert float(diff.max()) <= 2 * lr + 1e-7, key
    every = {side: torch.cat(v) for side, v in moments.items()}
    assert len(names) == len(moments["port"])
    assert _rel(every["port"], every["witness"]) <= PORT_GRAD_ALL
    assert _rel(every["jax"], every["witness"]) <= JAX_GRAD_ALL
