"""The port's second slice as a whole: feature-cached TA2N evaluation with
the soft-DTW metric (``MODEL.METRIC=otam``).

On a synthetic on-disk split, the JAX package's ``build_learner`` +
``evaluate_cached`` run ``ta2n`` on ``test-tiny-resnet`` (ResNet-18 at width
8, 64-px crops, so the trunk's maps are 2x2); its variables are carried into
the port, whose evaluator then runs on the same split with the same seed and
episode count. Accuracy and CI must be equal and the loss within 1e-4. The
port's CLI must run the same route to its result line.
"""

import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from make_synthetic_dataset import make_dataset  # noqa: E402

from clipspm_tpu.train.feature_cache import evaluate_cached as jax_evaluate  # noqa: E402
from clipspm_tpu.train.setup import build_learner as jax_build  # noqa: E402
from clipspm_tpu.utils.config import load_config as jax_load  # noqa: E402
from clipspm_tpu_torch import weights  # noqa: E402
from clipspm_tpu_torch.cli.run import main as port_cli  # noqa: E402
from clipspm_tpu_torch.train.feature_cache import evaluate_cached  # noqa: E402
from clipspm_tpu_torch.train.setup import build_learner  # noqa: E402
from clipspm_tpu_torch.utils.config import load_config  # noqa: E402

pytest.importorskip("PIL.Image")
torch.set_num_threads(2)

EPISODES = 12
# ta2n on test-tiny-resnet, 4-way 1-shot 2-query over 8 test classes, T=4,
# 64-px crops of 96-px frames (96 is TransformSpec's resize_to for 64, so
# the host crop is exercised); IMG_NORM centres the frames so the random
# trunk's features vary per video. With fewer, farther-apart class hues the
# random model is right in every episode and the CI is 0.
OPTS = ["MODEL.NAME=ta2n", "MODEL.BACKBONE=test-tiny-resnet",
        "MODEL.METRIC=otam", "TRAIN.WAY=4", "DATA.IMG_SIZE=64",
        "TEST.ONLY_TEST=true",
        "TEST.CACHE_FEATURES=true", f"TEST.TEST_EPISODES={EPISODES}",
        "TEST.QUERY_PER_CLASS=2", "TEST.CACHE_EVAL_BATCH=5",
        "TEST.CACHE_ENCODE_VIDEOS=8", "DATA.NUM_WORKERS=2",
        "DATA.IMG_NORM=true"]


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("slice_ta2n"))
    cfg_path = make_dataset(root, classes=8, videos=4, frames=6, size=96,
                            img_size=64, seq_len=4)
    return root, cfg_path


@pytest.fixture(scope="module")
def jax_run(split):
    root, cfg_path = split
    cfg = jax_load(cfg_path, opts=OPTS, splits_root=root)
    learner = jax_build(cfg, log_fn=lambda *_: None)
    learner.test_source.close()
    res = jax_evaluate(cfg, learner, log_fn=lambda *_: None)
    st = learner.state
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return res, {"params": to_np(st.params),
                 "batch_stats": to_np(st.batch_stats)}


def test_cached_eval_matches_jax(split, jax_run):
    root, cfg_path = split
    want, variables = jax_run
    cfg = load_config(cfg_path, opts=OPTS, splits_root=root)
    learner = build_learner(cfg, log_fn=lambda *_: None, device="cpu")
    # not a CLIP head: no CLIP model, [1, 1] zero text tables
    assert learner.text_train.shape == learner.text_test.shape == (1, 1)
    learner.model.load_state_dict(weights.model_state_dict(variables),
                                  strict=True)
    got = evaluate_cached(cfg, learner, log_fn=lambda *_: None)
    assert got["unique_videos"] == want["unique_videos"]
    # a degenerate stream (every episode the same accuracy) would make the
    # equality below vacuous
    assert want["confidence"] > 0
    assert got["accuracy"] == want["accuracy"]
    assert got["confidence"] == want["confidence"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-4)


def test_cli_runs_cached_route_to_result_line(split, capsys):
    root, cfg_path = split
    res = port_cli(["--cfg", cfg_path, "--splits-root", root, "--device",
                    "cpu", *OPTS,
                    f"CHECKPOINT.CHECKPOINT_DIR={root}/port_ckpt"])
    out = capsys.readouterr().out
    assert "Conduct Testing:" in out
    assert "CLIP tower init" not in out
    assert "feature-cached eval: 12 episodes" in out
    line = re.search(r"^hmdb: (\d+\.\d\d) \+/- (\d+\.\d\d) \(loss (\S+)\)$",
                     out, re.M)
    assert line is not None, out[-2000:]
    assert float(line.group(1)) == pytest.approx(res["accuracy"], abs=0.006)
    assert np.isfinite(res["loss"])
