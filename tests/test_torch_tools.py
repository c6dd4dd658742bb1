"""The port's tools (``clipspm_tpu_torch/tools/``) against the JAX package's
scripts, on the CPU: ``jsonl_to_tensorboard`` and ``jsonl_to_tb``,
``train_convergence``, ``repro_accuracy`` and ``int8_ab``.

The JAX scripts are loaded from their files; where running one would train
or evaluate a JAX model, its CLI runs are recorded instead and the port's
are held against the recording. The smoke runs go through the port's CLI
in this process (the TensorBoard writer's first import costs ~16 s a
process here).
"""

import glob
import importlib.util
import json
import os
import re
import sys
import tempfile
import types

import numpy as np
import pytest
import torch

from clipspm_tpu.utils.metrics import \
    jsonl_to_tensorboard as jax_jsonl_to_tensorboard
from clipspm_tpu_torch.tools import int8_ab, jsonl_to_tb, repro_accuracy
from clipspm_tpu_torch.tools import train_convergence as tc
from clipspm_tpu_torch.utils import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_script(name: str):
    return _load(os.path.join(SCRIPTS, f"{name}.py"), f"jax_script_{name}")


def _jax_json_keys(name: str) -> list:
    """The keys of the dict a JAX script prints with ``json.dumps``, read
    as ``chip_smoke.py`` reads them."""
    smoke = _load(os.path.join(REPO, "chip_smoke.py"), "chip_smoke")
    return smoke._jax_tool_json_keys(f"{name}.py")


def _read_events(tb_dir):
    # the legacy loader returns events verbatim (the default one migrates
    # simple_value scalars into tensor protos)
    from tensorboard.backend.event_processing.event_file_loader import \
        LegacyEventFileLoader

    out = []
    for path in sorted(glob.glob(os.path.join(tb_dir, "events.out.*"))):
        for event in LegacyEventFileLoader(path).Load():
            for v in event.summary.value:
                out.append((event.wall_time, event.step, v.tag,
                            v.simple_value))
    return out


@pytest.fixture
def own_tmpdir(tmp_path, monkeypatch):
    """``tempfile.gettempdir()`` inside the test's directory (the tools'
    smoke datasets go there)."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# -- jsonl_to_tensorboard and jsonl_to_tb -------------------------------------

def _write_jsonl(path):
    w = metrics.MetricsWriter(str(path))
    w.scalars({"loss/Train_loss[it]": 1.5, "acc/Train_acc[it]": 0.25}, 4)
    w.scalar("acc/Test_acc", 62.5, 8)
    w.scalar("sys/host_stall_pct", 12.0, 8)
    w.close()
    with open(path, "a") as f:   # a record without a timestamp, a blank line
        f.write(json.dumps({"step": 9, "tag": "loss/Test_loss",
                            "value": 0.75}) + "\n\n")


def test_jsonl_to_tensorboard_writes_the_jax_events(tmp_path):
    pytest.importorskip("tensorboard")
    jsonl = tmp_path / "metrics.jsonl"
    _write_jsonl(jsonl)
    t = str(tmp_path / "torch")
    j = str(tmp_path / "jax")
    assert metrics.jsonl_to_tensorboard(str(jsonl), t) == \
        jax_jsonl_to_tensorboard(str(jsonl), j) == 5
    got, want = _read_events(t), _read_events(j)
    # a record without "ts" takes the converter's clock
    assert [e[1:] for e in got] == [e[1:] for e in want]
    assert [e[0] for e in got[:4]] == [e[0] for e in want[:4]]
    assert (9, "loss/Test_loss", 0.75) == got[4][1:]


def test_jsonl_to_tensorboard_raises_without_tensorboard(tmp_path,
                                                         monkeypatch):
    jsonl = tmp_path / "metrics.jsonl"
    _write_jsonl(jsonl)
    monkeypatch.setattr(metrics, "_open_event_writer", lambda d: None)
    with pytest.raises(RuntimeError, match="tensorboard package"):
        metrics.jsonl_to_tensorboard(str(jsonl), str(tmp_path / "tb"))


def test_jsonl_to_tb_tool_as_the_jax_script(tmp_path, capsys):
    pytest.importorskip("tensorboard")
    jax_tool = _load_script("jsonl_to_tb")
    jsonl = tmp_path / "metrics.jsonl"
    _write_jsonl(jsonl)
    out = str(tmp_path / "tb")
    assert jsonl_to_tb.main(["--device", "cpu", str(jsonl), out]) == 0
    ours = capsys.readouterr().out
    assert jax_tool.main([str(jsonl), out + "_jax"]) == 0
    theirs = capsys.readouterr().out
    assert ours == theirs.replace(out + "_jax", out)
    assert ours == f"wrote 5 scalars to {out}\n"
    # the wrong number of paths: the usage text and exit code 2
    assert jsonl_to_tb.main(["--device", "cpu", str(jsonl)]) == 2
    assert jax_tool.main([str(jsonl)]) == 2
    assert "Usage" in capsys.readouterr().out


@pytest.mark.parametrize("tool, argv", [
    (jsonl_to_tb.main, ["a.jsonl", "tb"]),
    (tc.main, ["--smoke"]),
    (repro_accuracy.main, ["--data-root", "/nonexistent"]),
    (int8_ab.main, ["--smoke"]),
], ids=["jsonl_to_tb", "train_convergence", "repro_accuracy", "int8_ab"])
def test_tools_raise_without_a_gpu(no_gpu, own_tmpdir, tool, argv):
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        tool(argv)


# -- train_convergence --------------------------------------------------------

# what the CLI prints, as far as the tools read it
_TRAIN_OUT = ("Task [16/32], Train Loss: 1.5000000, Train Accuracy: 0.2\n"
              "Val @ 16: acc 40.00 +/- 3.00\n"
              "Task [32/32], Train Loss: 0.7500000, Train Accuracy: 0.6\n")
_TEST_OUT = "Conduct Testing:\nhmdb: 62.50 +/- 2.25 (loss 0.9000)\n"


def _recording_cli(calls):
    def run(argv):
        calls.append(list(argv))
        return _TRAIN_OUT if "TEST.ONLY_TEST=true" not in argv else _TEST_OUT
    return run


def _as_the_jax_tool_runs_it(argv):
    """A port CLI run without ``--device`` and without the
    ``TEST.CACHE_FEATURES=false`` of its uncached restores (the JAX tool
    leaves them to the config)."""
    i = argv.index("--device")
    return [a for a in argv[:i] + argv[i + 2:]
            if a != "TEST.CACHE_FEATURES=false"]


@pytest.mark.parametrize("flags", [
    ["--smoke"],
    ["--arch", "RN50", "--episodes", "640", "--lr", "1e-4", "--keep"],
    ["--dataset", "ucf", "--cfg", os.path.join(REPO, "configs/molo/ucf.yaml"),
     "--classes", "5", "--videos", "7", "--lr-sch", "320",
     "--tasks-per-batch", "8", "--val-freq", "16", "--val-eps", "8",
     "--final-eps", "40"],
], ids=["smoke", "rn50", "molo-ucf"])
def test_convergence_runs_the_jax_tools_sequence(tmp_path, monkeypatch,
                                                 capsys, flags):
    """The same dataset arguments, the same CLI runs (the port's add
    ``--device``, and its uncached restores say so) and the same JSON from
    the same CLI output."""
    root = str(tmp_path / "ds")
    jax_tool = _load_script("train_convergence")
    made, jax_calls = [], []
    monkeypatch.setitem(sys.modules, "make_synthetic_dataset",
                        types.SimpleNamespace(make_dataset=lambda *a, **k:
                                              made.append((a, k))))

    def jax_sh(args, env=None):
        return _recording_cli(jax_calls)(args)

    monkeypatch.setattr(jax_tool, "sh", jax_sh)
    monkeypatch.setattr(sys, "argv", ["train_convergence.py", "--root", root,
                                      *flags])
    # what the JAX tool sets on its way is put back after the test
    monkeypatch.setenv("CLIPSPM_PLATFORM", "cpu")
    monkeypatch.setattr(sys, "path", list(sys.path))
    jax_tool.main()
    jax_json = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    monkeypatch.setattr(tc, "load_make_dataset",
                        lambda: lambda *a, **k: made.append((a, k)))
    calls = []
    args = tc.parse_args(["--root", root, "--device", "cpu", *flags])
    ours = tc.convergence(args, run_cli=_recording_cli(calls))
    assert made[0] == made[1]
    assert [_as_the_jax_tool_runs_it(c) for c in calls] == jax_calls
    assert all(c[c.index("--device") + 1] == "cpu" for c in calls)
    assert ["TEST.CACHE_FEATURES=false" in c for c in calls] == \
        [False, True, True, False]
    assert list(ours) == _jax_json_keys("train_convergence")
    walls = ("train_wall_s", "final_eval_wall_s", "cached_eval_wall_s")
    assert json.loads(json.dumps(ours)) == {
        **jax_json, **{k: ours[k] for k in walls}}
    assert ours["val_curve"] == [(16, 40.0)]
    assert ours["final_acc"] == ours["restore_acc"] == 62.5


def test_convergence_smoke_on_cpu(own_tmpdir, monkeypatch, capsys):
    """``--smoke --device cpu`` end to end through the port's CLI (in this
    process, at fp32): the restores equal the final accuracy and the
    cached one, the curves parse."""
    def fp32_cli(argv):
        return tc.run_cli_in_process(argv + ["USE_AMP=false"])

    monkeypatch.setattr(tc, "run_cli_subprocess", fp32_cli)
    out = tc.main(["--smoke", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(out))
    assert list(out) == _jax_json_keys("train_convergence")
    assert out["arch"] == "test-tiny" and out["episodes"] == 16
    assert out["train_loss_curve"] and out["val_curve"]
    assert [ep for ep, _ in out["train_loss_curve"]] == [16]
    assert [ep for ep, _ in out["val_curve"]] == [8]
    assert all(np.isfinite(v) for _, v in out["train_loss_curve"])
    assert out["restore_acc"] == out["final_acc"] == out["cached_eval_acc"]
    assert 0.0 <= out["final_acc"] <= 100.0
    # the checkpoint directory is removed without --keep, the dataset stays
    root = str(own_tmpdir / "conv_ds_smoke")
    assert not os.path.exists(os.path.join(root, "ckpt_test-tiny"))
    assert os.path.isdir(os.path.join(root, "hmdb_256x256q5_l8"))


# -- repro_accuracy -----------------------------------------------------------

def _dataset_root(tmp_path, dataset: str, frames=True, split=True) -> str:
    from clipspm_tpu_torch.utils.config import DATASET_PATHS

    split_rel, frame_rel = DATASET_PATHS[dataset]
    root = tmp_path / f"{dataset}_{int(frames)}{int(split)}"
    root.mkdir()
    if frames:
        (root / frame_rel).mkdir()
    if split:
        (root / split_rel).mkdir(parents=True)
        (root / split_rel / "testlist03.txt").write_text("c/v\n")
    return str(root)


@pytest.mark.parametrize("backbone, dataset, frames, split, weights", [
    ("ViT-B/16", "hmdb", False, False, False),
    ("RN50", "ucf", True, False, False),
    ("RN50", "kinetics", False, True, True),
    ("ViT-B/16", "ssv2", True, True, True),
    ("ViT-B/16", "ssv2_cmn", True, True, False),
])
def test_check_assets_as_the_jax_script(tmp_path, monkeypatch, backbone,
                                        dataset, frames, split, weights):
    jax_tool = _load_script("repro_accuracy")
    wdir = tmp_path / "weights"
    wdir.mkdir()
    if weights:
        (wdir / {"RN50": "RN50.pt", "ViT-B/16": "ViT-B-16.pt"}[backbone]
         ).write_bytes(b"")
    monkeypatch.setenv("CLIP_WEIGHTS_DIR", str(wdir))
    monkeypatch.setenv("HOME", str(tmp_path))
    root = _dataset_root(tmp_path, dataset, frames, split)
    ours = repro_accuracy.check_assets(backbone, root, dataset)
    assert ours == jax_tool.check_assets(backbone, root, dataset)
    assert len(ours) == (not weights) + (not frames) + (not split)


def test_repro_accuracy_not_ready_as_the_jax_script(tmp_path, monkeypatch,
                                                    capsys):
    jax_tool = _load_script("repro_accuracy")
    monkeypatch.setenv("CLIP_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path))
    argv = ["--dataset", "ucf", "--backbone", "RN50", "--data-root",
            str(tmp_path / "missing")]
    assert repro_accuracy.main(argv + ["--device", "cpu"]) == 1
    ours = capsys.readouterr().out
    assert jax_tool.main(argv) == 1
    assert ours == capsys.readouterr().out
    assert ours.startswith("NOT READY — missing assets:\n  - missing CLIP")
    assert repro_accuracy.PUBLISHED == jax_tool.PUBLISHED
    assert repro_accuracy.DATASET_CFG == jax_tool.DATASET_CFG


def test_repro_accuracy_smoke_on_cpu(own_tmpdir, capsys):
    assert repro_accuracy.main(["--smoke", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("smoke repro path OK")
    assert re.fullmatch(r"hmdb: \d+\.\d\d \+/- \d+\.\d\d \(loss [\d.]+\)",
                        lines[-2])
    assert os.path.isfile(own_tmpdir / "repro_smoke_ds" / "tiny.yaml")


# -- int8_ab ------------------------------------------------------------------

# the JAX script's smoke root, a literal path
_JAX_INT8_ROOT = "/tmp/int8_ab_smoke"


def _run_jax_int8_ab(monkeypatch, capsys, root: str):
    """``scripts/int8_ab.py --smoke`` with its fixed root read as ``root``
    (the dataset the port's smoke wrote; no dataset is written). Returns
    its JSON, its float learner and the concrete logits each of its two
    learners gave, in call order."""
    import jax

    import clipspm_tpu.train.learner as jlearner
    import clipspm_tpu.train.setup as jsetup
    import clipspm_tpu.utils.config as jconfig

    monkeypatch.setenv("CLIPSPM_PLATFORM", "cpu")
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setitem(sys.modules, "make_synthetic_dataset",
                        types.SimpleNamespace(make_dataset=lambda *a, **k:
                                              None))
    jax_tool = _load_script("int8_ab")

    def mapped(x):
        return x.replace(_JAX_INT8_ROOT, root) if isinstance(x, str) else x

    real_load = jconfig.load_config
    monkeypatch.setattr(jconfig, "load_config",
                        lambda path, opts=(), splits_root=None: real_load(
                            path, opts=[mapped(o) for o in opts],
                            splits_root=mapped(splits_root)))

    logits = {"float": [], "int8": []}

    def recorded(learner, kind):
        apply = learner._apply

        def _apply(*a, **k):
            out, stats = apply(*a, **k)
            # evaluate's jitted steps trace it; the script's own calls do
            # not
            if not isinstance(out["logits"], jax.core.Tracer):
                logits[kind].append(np.asarray(out["logits"], np.float32))
            return out, stats
        learner._apply = _apply
        return learner

    built = []
    real_build = jsetup.build_learner
    monkeypatch.setattr(jsetup, "build_learner", lambda *a, **k: built.append(
        recorded(real_build(*a, **k), "float")) or built[-1])

    class Int8Learner(jlearner.Learner):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            recorded(self, "int8")

    monkeypatch.setattr(jlearner, "Learner", Int8Learner)
    jax_tool.main(["--smoke", "--episodes", str(INT8_AB_EPISODES),
                   *INT8_AB_OPTS])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return out, built[0], logits


def _port_checkpoint_of(jax_learner, root: str, opts: list):
    """The JAX learner's weights, BatchNorm statistics and class-text
    tables written through ``weights.py`` as the port's ``checkpoint_best``
    under ``root``'s smoke config; returns the port learner that saved it."""
    from clipspm_tpu_torch import weights
    from clipspm_tpu_torch.train.checkpoint import CheckpointManager
    from clipspm_tpu_torch.train.setup import build_learner
    from clipspm_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "configs/clipspm/hmdb.yaml"),
                      opts=opts, splits_root=root)
    learner = build_learner(cfg, log_fn=lambda m: None, device="cpu",
                            allow_random_weights=True)
    st = jax_learner.state
    variables = {"params": st.params}
    if st.batch_stats:
        variables["batch_stats"] = st.batch_stats
    learner.model.load_state_dict(weights.model_state_dict(variables),
                                  strict=True)
    learner.text_train = torch.from_numpy(np.array(st.text_train))
    learner.text_test = torch.from_numpy(np.array(st.text_test))
    CheckpointManager(str(cfg.CHECKPOINT.CHECKPOINT_DIR)).save(learner, "best")
    return learner


# The JAX script and the port's tool on one set of weights (the JAX
# learner's seeded init, carried into the port's checkpoint_best): the same
# 4 seeded episodes (the JAX script's logits run eagerly, a few seconds an
# episode), both at fp32 (under the config's USE_AMP the two
# packages' bf16 roundings alone move the logits by 2e-3 of their size).
# The float logits agree to fp32 rounding; the int8 ones to that and the
# odd code a rounding boundary moves; a wrong episode, order or reshape
# moves them by the logits' own spread.
INT8_AB_EPISODES = 4
INT8_AB_OPTS = ["USE_AMP=false"]
INT8_AB_LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def test_int8_ab_smoke_on_cpu(own_tmpdir, monkeypatch, capsys):
    root, opts = int8_ab.smoke_setup()
    jax_out, jax_learner, jax_logits = _run_jax_int8_ab(monkeypatch, capsys,
                                                        root)
    learner = _port_checkpoint_of(jax_learner, root, opts + INT8_AB_OPTS)

    logits = {"float": [], "int8": []}
    real_logits = int8_ab.episode_logits

    def recorded(lrn, ep, way):
        out = real_logits(lrn, ep, way)
        logits["int8" if lrn.cfg.MODEL.get("INT8_EVAL", False)
               else "float"].append(out)
        return out

    monkeypatch.setattr(int8_ab, "episode_logits", recorded)
    out = int8_ab.main(["--smoke", "--device", "cpu", "--episodes",
                        str(INT8_AB_EPISODES), *INT8_AB_OPTS])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    assert list(out) == _jax_json_keys("int8_ab")
    assert out["episodes"] == jax_out["episodes"] == INT8_AB_EPISODES
    assert out["restored_checkpoint"] is True
    assert jax_out["restored_checkpoint"] is False

    # the same episodes in the same order, [queries, way] on both sides
    way = int(learner.cfg.TRAIN.WAY)
    for kind in ("float", "int8"):
        assert len(logits[kind]) == len(jax_logits[kind]) == \
            INT8_AB_EPISODES
        for ours, theirs in zip(logits[kind], jax_logits[kind]):
            np.testing.assert_allclose(ours, theirs.reshape(-1, way),
                                       **INT8_AB_LOGIT_TOL)
    assert not np.allclose(logits["float"][0], logits["float"][1],
                           **INT8_AB_LOGIT_TOL)
    # the summary: accuracies and agreement equal, the deltas within the
    # logits' tolerance
    for key in ("acc_bf16", "ci_bf16", "acc_int8", "ci_int8", "acc_delta",
                "argmax_agreement_pct"):
        assert out[key] == jax_out[key], key
    for key in ("mean_abs_logit_delta", "max_abs_logit_delta"):
        assert out[key] == pytest.approx(jax_out[key], rel=1e-2, abs=2e-4)
    assert out["max_abs_logit_delta"] > 0.0

    # the float side is Learner.evaluate over the same seeded episodes
    try:
        it = iter(learner.test_source)
        eps = [next(it) for _ in range(INT8_AB_EPISODES)]
    finally:
        learner.close()
    res = learner.evaluate(INT8_AB_EPISODES, source=iter(eps), batch_size=4)
    assert round(res["accuracy"], 2) == out["acc_bf16"]
    assert round(res["confidence"], 2) == out["ci_bf16"]
