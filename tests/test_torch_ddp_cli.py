"""(f) of the episode parallelism over ranks (``tests/test_torch_ddp.py``):
the port's CLI with ``--device cpu DEVICE.NUM_CHIPS=2`` against ``=1`` on
``scripts/make_synthetic_dataset.py``'s split, as ``tests/test_cli_mesh.py``
holds the JAX CLI: the same train losses within 1e-3 and the same
``ONLY_TEST`` accuracy within 1e-3, with rank 0 alone writing one
``log.txt``, one ``metrics.jsonl`` and one checkpoint; then two ranks that
``torchrun`` starts join its group and test the same checkpoint.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from make_synthetic_dataset import make_dataset  # noqa: E402

from clipspm_tpu_torch.cli.run import main as port_cli  # noqa: E402

pytest.importorskip("PIL.Image")
torch.set_num_threads(2)

N = 2


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ddp_cli_split"))
    return root, make_dataset(root)


def _cli(root, cfg_path, ckdir, *opts):
    return port_cli(["--cfg", cfg_path, "--splits-root", root, "--device",
                     "cpu", "--allow-random-weights",
                     f"CHECKPOINT.CHECKPOINT_DIR={ckdir}", "DATA.NUM_WORKERS=1",
                     *opts])


def _jsonl(ckdir, tag):
    with open(os.path.join(ckdir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["tag"] == tag]


@pytest.fixture(scope="module")
def runs(split, tmp_path_factory):
    """Train, then ONLY_TEST from checkpoint_best, at 1 and at N ranks."""
    root, cfg_path = split
    tmp = tmp_path_factory.mktemp("ddp_cli_runs")
    runs = {}
    for n in (1, N):
        ck = str(tmp / f"ck{n}")
        _cli(root, cfg_path, ck, "TRAIN.VAL_FREQ=0", f"DEVICE.NUM_CHIPS={n}")
        test = _cli(root, cfg_path, ck, "TEST.ONLY_TEST=true",
                    "TEST.TEST_EPISODES=8", "TEST.EVAL_BATCH=4",
                    f"DEVICE.NUM_CHIPS={n}")
        runs[n] = (ck, _jsonl(ck, "loss/Train_loss[it]"), test)
    return runs


def test_cli_two_ranks_reproduce_one(runs):
    (ck1, l1, t1), (ck2, l2, t2) = runs[1], runs[N]
    assert [r["step"] for r in l1] == [r["step"] for r in l2] == [4, 8]
    for a, b in zip(l1, l2):
        assert abs(a["value"] - b["value"]) <= 1e-3 * max(1.0,
                                                          abs(a["value"]))
    acc = [_jsonl(ck, "TEST/hmdb_acc") for ck in (ck1, ck2)]
    assert len(acc[1]) == 1
    np.testing.assert_allclose(acc[1][0]["value"], acc[0][0]["value"],
                               atol=1e-3)
    assert t2["accuracy"] == acc[1][0]["value"]
    # rank 0 alone writes: one log, one JSONL, one checkpoint
    assert sorted(os.listdir(ck2)) == sorted(os.listdir(ck1))
    with open(os.path.join(ck2, "log.txt")) as f:
        log = f.read()
    assert log.count("Options:") == 2
    assert log.count("device mesh: dp=2 x tp=1 (2 devices)") == 2
    assert log.count("Task [8/8]") == 1
    assert sorted(os.listdir(os.path.join(ck2, "checkpoint_best"))) == \
        ["checkpoint.pt"]
    assert len(_jsonl(ck2, "loss/Train_loss[it]")) == 2


def test_torchrun_ranks_join_its_group(split, runs, tmp_path):
    """``torchrun`` starts two ranks, each runs the CLI, which joins
    torchrun's group instead of starting ranks of its own: N=1's
    checkpoint tested at the same accuracy, one log."""
    root, cfg_path = split
    ck = str(tmp_path / "torchrun")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={N}", "-m", "clipspm_tpu_torch.cli.run",
         "--cfg", cfg_path, "--splits-root", root, "--device", "cpu",
         "--allow-random-weights", f"CHECKPOINT.CHECKPOINT_DIR={ck}",
         "DATA.NUM_WORKERS=1", "TEST.ONLY_TEST=true",
         "TEST.TEST_EPISODES=8", "TEST.EVAL_BATCH=4",
         f"TEST.TEST_MODEL_PATH={runs[1][0]}/checkpoint_best",
         f"DEVICE.NUM_CHIPS={N}"],
        cwd=repo, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": repo, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    acc = _jsonl(ck, "TEST/hmdb_acc")
    assert len(acc) == 1
    assert acc[0]["value"] == runs[1][2]["accuracy"]
    with open(os.path.join(ck, "log.txt")) as f:
        log = f.read()
    assert log.count("Options:") == 1
    assert log.count("device mesh: dp=2 x tp=1 (2 devices)") == 1
