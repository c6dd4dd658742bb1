"""(viii) of tensor parallelism (``tests/test_torch_tp.py``): the port's CLI
with ``--device cpu`` on ``scripts/make_synthetic_dataset.py``'s split at
``DEVICE.NUM_CHIPS=1, DEVICE.TP=2`` (``test-tiny-rn``: the attention pool's
``c_proj`` sharded) and at ``NUM_CHIPS=2, TP=2`` (``test-tiny``: the MLPs
sharded) against one process: training with a feature-cached validation,
then ``ONLY_TEST`` from ``checkpoint_best``, feature-cached and uncached.
The train losses, the validation's and both tests' accuracies equal the
one-process run's (losses within 1e-3, accuracies within 1e-3), and rank 0
alone writes one log, one ``metrics.jsonl`` and one checkpoint.

Each grid's three runs share one start of the ranks, each rank running
the CLI's per-rank entry (``cli/run.py:_rank``, what ``main`` starts the
ranks with) once for each: a start pays TensorBoard's import in rank 0
(about 13 s). That ``main`` starts ``NUM_CHIPS x TP`` ranks on a grid of
``TP`` is held on its own.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from make_synthetic_dataset import make_dataset  # noqa: E402

from clipspm_tpu_torch.cli import run as cli  # noqa: E402
from clipspm_tpu_torch.parallel import mesh as pmesh  # noqa: E402

pytest.importorskip("PIL.Image")
torch.set_num_threads(2)

GRIDS = {"test-tiny-rn": (1, 2), "test-tiny": (2, 2)}
TOL = 1e-3


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp_cli_split"))
    return root, make_dataset(root)


def _argv(root, cfg_path, ckdir, backbone, grid, *opts):
    return ["--cfg", cfg_path, "--splits-root", root, "--device", "cpu",
            "--allow-random-weights", f"CHECKPOINT.CHECKPOINT_DIR={ckdir}",
            "DATA.NUM_WORKERS=1", f"MODEL.BACKBONE={backbone}",
            f"DEVICE.NUM_CHIPS={grid[0]}", f"DEVICE.TP={grid[1]}",
            "TEST.TEST_EPISODES=6", *opts]


TRAIN = ("TRAIN.VAL_FREQ=4", "TEST.CACHE_FEATURES=true",
         "TEST.CACHE_EVAL_BATCH=3", "TEST.CACHE_ENCODE_VIDEOS=5")
TESTS = {"cached": ("TEST.ONLY_TEST=true", "TEST.CACHE_FEATURES=true",
                    "TEST.CACHE_EVAL_BATCH=3", "TEST.CACHE_ENCODE_VIDEOS=5"),
         "uncached": ("TEST.ONLY_TEST=true", "TEST.CACHE_FEATURES=false",
                      "TEST.EVAL_BATCH=2")}


def _cli_runs(mesh, argvs):
    return [cli._rank(mesh, argv) for argv in argvs]


def _jsonl(ckdir, tag):
    with open(os.path.join(ckdir, "metrics.jsonl")) as f:
        return [r["value"] for r in map(json.loads, f) if r["tag"] == tag]


@pytest.fixture(scope="module")
def runs(split, tmp_path_factory):
    """Each backbone in one process and on its grid: train, then the two
    ``ONLY_TEST`` runs; the run's checkpoint directory and results."""
    root, cfg_path = split
    tmp = tmp_path_factory.mktemp("tp_cli_runs")
    out = {}
    for backbone, grid in GRIDS.items():
        for g in ((1, 1), grid):
            ck = str(tmp / f"{backbone}-{g[0]}x{g[1]}")
            argvs = [_argv(root, cfg_path, ck, backbone, g, *opts)
                     for opts in (TRAIN, *TESTS.values())]
            if g == (1, 1):
                got = [cli.main(a) for a in argvs]
            else:
                got = pmesh.spawn(_cli_runs, g[0] * g[1], "cpu",
                                  args=(argvs,), tp=g[1])
            out[backbone, g] = (ck, dict(zip(TESTS, got[1:])))
    return out


def test_main_starts_the_grid(split, tmp_path, monkeypatch):
    """``main`` at ``NUM_CHIPS=2, TP=2`` starts 4 ranks on a grid of tp=2,
    each running the CLI's per-rank entry with the same arguments."""
    root, cfg_path = split
    calls = []
    monkeypatch.setattr(pmesh, "spawn", lambda fn, world, device, args=(),
                        **kw: calls.append((fn, world, device, args, kw))
                        or {"ok": True})
    argv = _argv(root, cfg_path, str(tmp_path), "test-tiny", (2, 2))
    assert cli.main(argv) == {"ok": True}
    assert calls == [(cli._rank, 4, torch.device("cpu"), (argv,),
                      {"tp": 2})]


@pytest.mark.parametrize("backbone", list(GRIDS))
def test_cli_tp_grid_reproduces_one_process(backbone, runs):
    grid = GRIDS[backbone]
    (ck1, t1), (ck2, t2) = runs[backbone, (1, 1)], runs[backbone, grid]
    losses = [_jsonl(ck, "loss/Train_loss[it]") for ck in (ck1, ck2)]
    assert len(losses[0]) == len(losses[1]) == 2
    np.testing.assert_allclose(losses[1], losses[0], rtol=TOL)
    for tag in ("acc/Test_acc", "TEST/hmdb_acc"):
        got, want = _jsonl(ck2, tag), _jsonl(ck1, tag)
        assert len(got) == len(want) >= 1, tag
        np.testing.assert_allclose(got, want, atol=TOL)
    for kind in TESTS:
        assert abs(t2[kind]["accuracy"] - t1[kind]["accuracy"]) <= TOL
        np.testing.assert_allclose(t2[kind]["loss"], t1[kind]["loss"],
                                   rtol=TOL)
    # the cached and uncached protocols agree with each other, too
    assert t2["cached"]["accuracy"] == pytest.approx(
        t2["uncached"]["accuracy"], abs=TOL)
    assert sorted(os.listdir(ck2)) == sorted(os.listdir(ck1))
    with open(os.path.join(ck2, "log.txt")) as f:
        log = f.read()
    world = grid[0] * grid[1]
    assert log.count("Options:") == 3
    assert log.count(f"device mesh: dp={grid[0]} x tp={grid[1]} "
                     f"({world} devices)") == 3
    assert log.count("Task [8/8]") == 1
    assert sorted(os.listdir(os.path.join(ck2, "checkpoint_best"))) == \
        ["checkpoint.pt"]
    # the checkpoint is the one-process payload, key for key
    load = lambda ck: torch.load(os.path.join(  # noqa: E731
        ck, "checkpoint_best", "checkpoint.pt"), weights_only=True)
    a, b = load(ck1), load(ck2)
    assert {k: v.shape for k, v in a["model"].items()} == \
        {k: v.shape for k, v in b["model"].items()}
