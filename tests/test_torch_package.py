"""Guards of the port package: no JAX imports, the GPU default, the models
it builds, and the loud refusals of the routes it does not carry yet."""

import ast
import importlib
import os
import pkgutil

import pytest
import torch

import clipspm_tpu_torch
from clipspm_tpu_torch import resolve_device
from clipspm_tpu_torch.cli.run import main as port_cli
from clipspm_tpu_torch.models.fsar import build_model
from clipspm_tpu_torch.models.heads.ta2n import TA2NModel
from clipspm_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "clipspm_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "clipspm_tpu")
HMDB = os.path.join(REPO, "configs", "clipspm", "hmdb.yaml")
UCF_TA2N = os.path.join(REPO, "configs", "ta2n", "ucf.yaml")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_package_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_every_module_imports_without_building_kernels():
    built = os.path.join(PKG, "build")
    before = set(os.listdir(built)) if os.path.isdir(built) else set()
    for mod in pkgutil.walk_packages(clipspm_tpu_torch.__path__,
                                     "clipspm_tpu_torch."):
        importlib.import_module(mod.name)
    after = set(os.listdir(built)) if os.path.isdir(built) else set()
    # a library (or its temporary) of any CUDA source under csrc/; the JPEG
    # decoder, which other tests build into the same directory, is not one
    kernels = {os.path.splitext(f)[0]
               for f in os.listdir(os.path.join(PKG, "csrc"))}
    assert kernels >= {"otam_dp", "softdtw_dp"}
    assert not {f for f in after - before
                if any(f.startswith(f"lib{k}-") for k in kernels)}


def test_device_defaults_to_cuda_and_refuses_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_without_device_refuses_to_run_on_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["--cfg", HMDB, "--allow-random-weights",
                  "TEST.ONLY_TEST=true",
                  f"CHECKPOINT.CHECKPOINT_DIR={tmp_path}"])
    assert not os.path.exists(os.path.join(tmp_path, "log.txt"))


@pytest.mark.parametrize("opts,error", [
    (["MODEL.NAME=ta2n"], NotImplementedError),              # ta2n training
    (["TEST.ONLY_TEST=true", "TEST.CACHE_FEATURES=false"],
     NotImplementedError),                                    # uncached
    (["TEST.ONLY_TEST=true", "TEST.TEST_MODEL_PATH=/nonexistent/ckpt"],
     FileNotFoundError),
    (["TEST.ONLY_TEST=true", "DEVICE.NUM_CHIPS=2"],
     NotImplementedError),                                    # DDP
])
def test_cli_routes_not_carried_raise_before_model_build(opts, error,
                                                         tmp_path):
    with pytest.raises(error):
        port_cli(["--cfg", HMDB, "--device", "cpu", *opts,
                  f"CHECKPOINT.CHECKPOINT_DIR={tmp_path}"])
    assert not os.path.exists(os.path.join(tmp_path, "log.txt"))


def test_existing_test_model_path_is_refused(tmp_path):
    """A TEST_MODEL_PATH that exists but holds no checkpoint (an empty
    directory, or a file) is refused before the model is built."""
    ckpt = tmp_path / "checkpoint_best"
    ckpt.mkdir()
    with pytest.raises(FileNotFoundError, match="holds no checkpoint.pt"):
        port_cli(["--cfg", HMDB, "--device", "cpu", "TEST.ONLY_TEST=true",
                  f"TEST.TEST_MODEL_PATH={ckpt}",
                  f"CHECKPOINT.CHECKPOINT_DIR={tmp_path}"])
    (tmp_path / "head.pt").write_bytes(b"")
    with pytest.raises(ValueError, match="is a FILE"):
        port_cli(["--cfg", HMDB, "--device", "cpu", "TEST.ONLY_TEST=true",
                  f"TEST.TEST_MODEL_PATH={tmp_path / 'head.pt'}",
                  f"CHECKPOINT.CHECKPOINT_DIR={tmp_path}"])
    assert not os.path.exists(os.path.join(tmp_path, "log.txt"))


@pytest.mark.parametrize("name", ["otam", "trx", "clipfsar", "molo", "strm",
                                  "soap", "sten", "cpm2c"])
def test_other_heads_raise_not_implemented(name):
    cfg = load_config(HMDB, opts=[f"MODEL.NAME={name}"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg)


def test_build_model_builds_ta2n_at_full_width():
    cfg = load_config(UCF_TA2N, opts=["MODEL.METRIC=otam"])
    model = build_model(cfg)
    assert isinstance(model, TA2NModel)
    assert (model.way, model.shot, model.seq_len) == (5, 1, 8)
    assert model.metric == "otam" and not model.dist_norm
    assert model.compute_dtype == torch.bfloat16         # USE_AMP: true
    assert model.backbone.arch == "resnet50" and model.dim == 2048
    assert model.backbone.layer3[5].conv3.out_channels == 1024
    assert model.acm.mv_conv1.in_channels == 4096
    # the test-size trunk: ResNet-18 at width 8
    tiny = build_model(load_config(UCF_TA2N, opts=[
        "MODEL.BACKBONE=test-tiny-resnet", "USE_AMP=false"]))
    assert tiny.backbone.arch == "resnet18" and tiny.dim == 64
    assert tiny.metric == "cos" and tiny.compute_dtype is None
