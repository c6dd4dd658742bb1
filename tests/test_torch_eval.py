"""The port's uncached evaluator and its routes.

1. ``Learner.evaluate`` against the JAX ``Learner.evaluate`` on one on-disk
   split, seed and set of weights (clipspm on ``test-tiny``, ta2n on
   ``test-tiny-resnet``), one and two episodes a step, 5 episodes so the
   last batch is partial;
2. the feature-cached evaluator equal to the uncached one for every ported
   head, and cpm2c's cached loss equal to the JAX ``FeatureCachedEvaluator``'s
   (evaluation mode: no consistency term);
3. the CLI's uncached ``ONLY_TEST`` run, its loud fallback from the cache,
   ``Learner.run`` validating uncached, and ``close()`` ending the loaders'
   workers.
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from make_synthetic_dataset import make_dataset  # noqa: E402

from clipspm_tpu.data.pipeline import EpisodeLoader as JLoader  # noqa: E402
from clipspm_tpu.data.sampler import EpisodeSampler as JSampler  # noqa: E402
from clipspm_tpu.data.splits import load_split as j_load_split  # noqa: E402
from clipspm_tpu.models.backbones.clip import CLIP_ARCHS as J_ARCHS  # noqa: E402
from clipspm_tpu.train.feature_cache import \
    FeatureCachedEvaluator as JCached  # noqa: E402
from clipspm_tpu.train.learner import Learner as JLearner  # noqa: E402
from clipspm_tpu.train.learner import TransformSpec as JSpec  # noqa: E402
from clipspm_tpu.utils.config import ConfigNode as JConfig  # noqa: E402
from clipspm_tpu.utils.config import SPM_DEFAULT_PARAMS  # noqa: E402
from clipspm_tpu_torch import weights  # noqa: E402
from clipspm_tpu_torch.cli.run import main as port_cli  # noqa: E402
from clipspm_tpu_torch.data.pipeline import EpisodeLoader  # noqa: E402
from clipspm_tpu_torch.data.sampler import EpisodeSampler  # noqa: E402
from clipspm_tpu_torch.data.splits import load_split  # noqa: E402
from clipspm_tpu_torch.data.transforms import TransformSpec  # noqa: E402
from clipspm_tpu_torch.models.fsar import build_model  # noqa: E402
from clipspm_tpu_torch.train.feature_cache import \
    FeatureCachedEvaluator  # noqa: E402
from clipspm_tpu_torch.train.learner import Learner  # noqa: E402
from clipspm_tpu_torch.train.setup import build_learner  # noqa: E402
from clipspm_tpu_torch.utils.config import ConfigNode, load_config  # noqa: E402
from clipspm_tpu_torch.weights import random_init_  # noqa: E402

PIL = pytest.importorskip("PIL.Image")
torch.set_num_threads(2)

# 2-way 2-shot 1-query, T=3 over 3 test classes x 4 videos of 5-8 frames at
# 72 px: the resize is the identity (resize_to 72) in both packages, the
# crop 32 px for the CLIP tower and 64 for the ResNet trunk (2x2 maps)
WAY, SHOT, QUERIES, SEQ_LEN, PX, CLASSES = 2, 2, 1, 3, 72, 3
IMG = {"clipspm": 32, "clipfsar": 32, "sten": 32, "cpm2c": 32, "ta2n": 64}
BACKBONE = {"ta2n": "test-tiny-resnet"}
N_EPISODES = 5


@pytest.fixture(scope="module")
def disk_split(tmp_path_factory):
    root = tmp_path_factory.mktemp("evalds")
    splits = root / "splits"
    splits.mkdir()
    rng = np.random.default_rng(3)
    lines = []
    for cls in ["a", "b", "c"]:
        for v in range(4):
            d = root / "frames" / "test" / cls / f"v{v}"
            d.mkdir(parents=True)
            for f in range(5 + v):
                arr = rng.integers(0, 255, size=(PX, PX, 3)).astype(np.uint8)
                PIL.fromarray(arr).save(str(d / f"{f:05d}.jpg"))
            lines.append(f"{cls}/v{v}")
    (splits / "testlist03.txt").write_text("\n".join(lines) + "\n")
    return str(splits), str(root / "frames")


def _cfg(name):
    return {
        "MODEL": {"NAME": name, "BACKBONE": BACKBONE.get(name, "test-tiny"),
                  "SEED": 0, "USE_CLASSIFICATION_VALUE": 1.5,
                  "LMD": [0.5, 1.0, 0.5], "MOTION_COFF": 0.5,
                  "NORMAL_COFF": 0.5},
        "TRAIN": {"WAY": WAY, "SHOT": SHOT, "QUERY_PER_CLASS": QUERIES,
                  "TASKS_PER_BATCH": 2},
        "TEST": {"QUERY_PER_CLASS": QUERIES, "TEST_EPISODES": N_EPISODES},
        "DATA": {"DATASET": "generic", "IMG_SIZE": IMG[name],
                 "SEQ_LEN": SEQ_LEN, "NUM_WORKERS": 2},
        "SOLVER": {"LR": 1e-3, "LR_SCH": 10 ** 6, "OPTIM_METHOD": "adam",
                   "WEIGHT_DECAY": 1e-4, "MOMENTUM": 0.9},
        "USE_AMP": False,
        "params": SPM_DEFAULT_PARAMS["hmdb"],
    }


def _sampler(split, port=True):
    splits, data = split
    load, cls = (load_split, EpisodeSampler) if port else (j_load_split,
                                                           JSampler)
    catalog = load(splits, data, "test", "generic", seq_len=SEQ_LEN)
    return catalog, cls(catalog, way=WAY, shot=SHOT, queries=QUERIES,
                        seq_len=SEQ_LEN, train=False, seed=1)


def _loader(split, port=True):
    cls = EpisodeLoader if port else JLoader
    return cls(_sampler(split, port)[1], num_workers=2, prefetch=2,
               use_native=False)


def _jax_model(name):
    if name == "clipspm":
        from clipspm_tpu.models.fsar import CLIPSPMModel

        arch = J_ARCHS["test-tiny"]
        return CLIPSPMModel(arch=arch, way=WAY, shot=SHOT,
                            spm=SPM_DEFAULT_PARAMS["hmdb"]), arch.embed_dim
    if name == "cpm2c":
        from clipspm_tpu.models.heads.cpm2c import CPM2CModel

        arch = J_ARCHS["test-tiny"]
        return CPM2CModel(arch=arch, way=WAY, shot=SHOT,
                          params=SPM_DEFAULT_PARAMS["hmdb"]), arch.embed_dim
    from clipspm_tpu.models.heads.ta2n import TA2NModel

    return TA2NModel(way=WAY, shot=SHOT, seq_len=SEQ_LEN, arch="resnet18",
                     backbone_width=8), None


@pytest.fixture(scope="module")
def carry():
    """``carry(name)``: a JAX learner of ``name`` without a test stream, and
    a port learner holding the same weights and text tables (built once a
    name)."""
    built = {}

    def get(name):
        if name not in built:
            built[name] = _carry(name)
        return built[name]

    return get


def _carry(name):
    model, dim = _jax_model(name)
    img = IMG[name]
    S, Q = WAY * SHOT, WAY * QUERIES
    key = jax.random.PRNGKey(0)
    variables = model.init(
        {"params": key, "dropout": key},
        jnp.zeros((S, SEQ_LEN, img, img, 3)),
        jnp.zeros((Q, SEQ_LEN, img, img, 3)),
        jnp.arange(S, dtype=jnp.int32) % WAY, jnp.zeros((S,), jnp.int32),
        jnp.zeros((Q,), jnp.int32), jnp.zeros((CLASSES, dim or 1)),
        jnp.zeros((CLASSES, dim or 1)), train=True)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    text = (np.random.default_rng(1).normal(size=(CLASSES, dim))
            .astype(np.float32) if dim else np.zeros((1, 1), np.float32))
    jl = JLearner(JConfig(_cfg(name)), model, variables, text_train=text,
                  text_test=text, transform=JSpec(img_size=img, resize_to=PX,
                                                  flip=True))
    tm = build_model(ConfigNode(_cfg(name)))
    tm.load_state_dict(weights.model_state_dict(variables), strict=True)
    tt = torch.from_numpy(text)
    pl = Learner(ConfigNode(_cfg(name)), tm, tt, tt, torch.device("cpu"),
                 transform=TransformSpec(img_size=img, resize_to=PX),
                 log_fn=lambda *_: None)
    return jl, pl


@pytest.mark.parametrize("batch_size", [1, 2])
@pytest.mark.parametrize("name", ["clipspm", "ta2n"])
def test_evaluate_matches_jax_learner(disk_split, carry, name, batch_size):
    jl, pl = carry(name)
    jsrc, tsrc = _loader(disk_split, port=False), _loader(disk_split)
    try:
        want = jl.evaluate(N_EPISODES, source=jsrc, batch_size=batch_size)
        got = pl.evaluate(N_EPISODES, source=tsrc, batch_size=batch_size)
    finally:
        jsrc.close()
        tsrc.close()
    assert not pl.model.training
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], atol=1e-3)
    np.testing.assert_allclose(got["confidence"], want["confidence"],
                               atol=1e-3)
    np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-4)
    assert got["seconds"] >= got["host_stall_seconds"] >= 0.0


def test_cpm2c_cached_loss_matches_jax_evaluator(disk_split, carry):
    """The cached evaluator calls the loss dispatch in evaluation mode: its
    cpm2c loss is the JAX evaluator's, without the consistency term that
    the training mode adds."""
    jl, pl = carry("cpm2c")
    jcat, jsamp = _sampler(disk_split, port=False)
    jev = JCached(jl, jcat, jsamp, encode_videos_per_step=5, eval_batch=4,
                  log_fn=lambda *_: None)
    cat, samp = _sampler(disk_split)
    ev = FeatureCachedEvaluator(pl, cat, samp, encode_videos_per_step=5,
                                eval_batch=4, log_fn=lambda *_: None)
    try:
        want = jev.evaluate(N_EPISODES)
        got = ev.evaluate(N_EPISODES)
        table, row_of = ev.build_table(
            [_sampler(disk_split)[1].sample()])
    finally:
        jev.close()
        ev.close()
    assert got["unique_videos"] == want["unique_videos"]
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], atol=1e-3)
    np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-4)
    # the term train mode would add is far outside that tolerance
    plan = _sampler(disk_split)[1].sample()
    rows = [torch.tensor([row_of[int(v)] for v in vids])
            for vids in (plan.support_video_idx, plan.target_video_idx)]
    with torch.no_grad():
        out = pl.model.eval().match_features(
            table[rows[0]], table[rows[1]],
            *[torch.from_numpy(x) for x in (
                plan.support_labels, plan.real_support_labels,
                plan.real_target_labels)], pl.text_train, pl.text_test)
    assert 0.001 * float(out["target_consist_distance"]) > 1e-2


@pytest.mark.parametrize("name", ["clipspm", "ta2n", "clipfsar", "sten",
                                  "cpm2c"])
def test_cached_evaluation_equals_uncached(disk_split, name):
    cfg = ConfigNode(_cfg(name))
    model = random_init_(build_model(cfg), torch.Generator().manual_seed(2))
    dim = model.arch.embed_dim if hasattr(model, "arch") else 1
    text = torch.randn(CLASSES, dim, generator=torch.Generator()
                       .manual_seed(3))
    learner = Learner(cfg, model, text, text, torch.device("cpu"),
                      transform=TransformSpec(img_size=IMG[name],
                                              resize_to=PX),
                      test_source=_loader(disk_split), log_fn=lambda *_: None)
    try:
        want = learner.evaluate(6, batch_size=4)
    finally:
        learner.close()
    cat, samp = _sampler(disk_split)
    ev = FeatureCachedEvaluator(learner, cat, samp, encode_videos_per_step=5,
                                eval_batch=4, log_fn=lambda *_: None)
    try:
        got = ev.evaluate(6)
    finally:
        ev.close()
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], atol=1e-3)
    np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-4)


# -- the CLI and the trainer ---------------------------------------------------

@pytest.fixture(scope="module")
def cli_split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("evalcli"))
    return root, make_dataset(root, classes=4, videos=5, frames=6, size=40,
                              img_size=32, seq_len=4)


def _cli(cli_split, ckpt, *opts):
    root, cfg_path = cli_split
    res = port_cli(["--cfg", cfg_path, "--splits-root", root,
                    "--allow-random-weights", "--device", "cpu",
                    "MODEL.BACKBONE=test-tiny-rn", "DATA.NUM_WORKERS=2",
                    f"CHECKPOINT.CHECKPOINT_DIR={ckpt}", *opts])
    with open(os.path.join(ckpt, "log.txt")) as f:
        return res, f.read()


RESULT_LINE = r"^\S+ \S+ hmdb: (\d+\.\d\d) \+/- (\d+\.\d\d) \(loss (\S+)\)$"


def test_cli_only_test_runs_uncached(cli_split, tmp_path):
    res, log = _cli(cli_split, str(tmp_path), "TEST.ONLY_TEST=true",
                    "TEST.CACHE_FEATURES=false", "TEST.TEST_EPISODES=3",
                    "TEST.EVAL_BATCH=2")
    assert "Conduct Testing:" in log
    assert "uncached eval: 3 episodes in batches of 2" in log
    assert "feature-cached eval" not in log and "WARNING: TEST." not in log
    line = re.search(RESULT_LINE, log, re.M)
    assert line is not None, log[-2000:]
    assert float(line.group(1)) == pytest.approx(res["accuracy"], abs=0.006)
    assert np.isfinite(res["loss"])


def test_cli_falls_back_loudly_from_the_cache(cli_split, tmp_path):
    """A protocol the cache cannot serve (one frame a video) evaluates
    uncached after a warning line; sten (no temporal ops) at T=1."""
    res, log = _cli(cli_split, str(tmp_path), "MODEL.NAME=sten",
                    "DATA.SEQ_LEN=1", "TEST.ONLY_TEST=true",
                    "TEST.CACHE_FEATURES=true", "TEST.TEST_EPISODES=3",
                    "TEST.EVAL_BATCH=2")
    assert ("WARNING: TEST.CACHE_FEATURES ignored — feature caching "
            "requires DATA.SEQ_LEN >= 2") in log
    assert "uncached eval: 3 episodes in batches of 2" in log
    assert re.search(RESULT_LINE, log, re.M) is not None
    assert np.isfinite(res["loss"])


def test_run_validates_uncached_on_a_continuing_test_stream(cli_split):
    """``run`` without a ``val_fn`` validates through ``evaluate`` at
    ``eval_batch_size`` in eval mode, trains in train mode again after, and
    the second validation takes the test stream's next episodes."""
    from clipspm_tpu_torch.train.setup import build_catalog_and_sampler

    root, cfg_path = cli_split
    cfg = load_config(cfg_path, splits_root=root, opts=[
        "MODEL.BACKBONE=test-tiny-rn", "TRAIN.TASKS_PER_BATCH=2"])
    learner = build_learner(cfg, log_fn=lambda *_: None, device="cpu",
                            allow_random_weights=True)
    seen, modes = [], []
    step, eval_batch = learner._step, learner._eval_batch

    def recording_step(batch, n):
        modes.append(("step", learner.model.training))
        return step(batch, n)

    def recording_eval(batch, n):
        modes.append(("eval", learner.model.training))
        seen.extend(batch.real_support_labels[:n].tolist())
        return eval_batch(batch, n)

    learner._step, learner._eval_batch = recording_step, recording_eval
    try:
        out = learner.run(train_episodes=6, val_freq=2, test_episodes=3,
                          print_freq=2, eval_batch_size=2)
    finally:
        learner.close()
    assert out["episodes"] == 6
    # validations at episodes 2 and 4, each 3 episodes in batches of 2, 1
    assert [m for m in modes] == [("step", True), ("eval", False),
                                  ("eval", False), ("step", True),
                                  ("eval", False), ("eval", False),
                                  ("step", True)]
    _, sampler = build_catalog_and_sampler(cfg, "test", False,
                                           int(cfg.TEST.QUERY_PER_CLASS))
    assert seen == [sampler.sample().real_support_labels.tolist()
                    for _ in range(6)]


def test_close_ends_both_loaders_workers(cli_split):
    root, cfg_path = cli_split
    cfg = load_config(cfg_path, splits_root=root,
                      opts=["MODEL.BACKBONE=test-tiny-rn"])
    learner = build_learner(cfg, log_fn=lambda *_: None, device="cpu",
                            allow_random_weights=True)
    loaders = [learner.train_source, learner.test_source]
    assert all(isinstance(x, EpisodeLoader) for x in loaders)
    assert all(x._thread.is_alive() for x in loaders)
    learner.close()
    for x in loaders:
        x._thread.join(timeout=10)
        assert not x._thread.is_alive()
        assert x._pool._shutdown
