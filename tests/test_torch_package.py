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
from clipspm_tpu_torch.models.heads.clipfsar import CLIPFSARModel
from clipspm_tpu_torch.models.heads.cpm2c import CPM2CModel
from clipspm_tpu_torch.models.heads.sten import STENModel
from clipspm_tpu_torch.models.heads.ta2n import TA2NModel
from clipspm_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "clipspm_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "clipspm_tpu")
HMDB = os.path.join(REPO, "configs", "clipspm", "hmdb.yaml")
UCF_TA2N = os.path.join(REPO, "configs", "ta2n", "ucf.yaml")
CONFIGS = os.path.join(REPO, "configs")


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
    (["MODEL.NAME=otam"], NotImplementedError),     # an unported head
    (["TEST.ONLY_TEST=true", "TEST.TEST_MODEL_PATH=/nonexistent/ckpt"],
     FileNotFoundError),
    (["TEST.ONLY_TEST=true", "DEVICE.NUM_CHIPS=2"],
     NotImplementedError),                                    # DDP
    (["DEVICE.TP=2"], NotImplementedError),          # tensor parallelism
    (["DEVICE.NUM_CHIPS=0"], ValueError),
    (["SOLVER.ACCUM_DTYPE=float16"], ValueError),
    (["MODEL.BACKBONE=ViT-B/16", "MODEL.TRAIN_REMAT_POLICY=attn"],
     NotImplementedError),                          # remat policies not
    (["MODEL.BACKBONE=ViT-B/16", "MODEL.TRAIN_REMAT_POLICY=mlp"],
     NotImplementedError),                          # ported
    (["MODEL.BACKBONE=ViT-B/16", "MODEL.TRAIN_REMAT_POLICY=everything"],
     ValueError),
    (["MODEL.TRAIN_ENCODE_CHUNK=40"], ValueError),  # BatchNorm tower
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


UNPORTED_HEADS = ["otam", "trx", "molo", "strm", "soap"]


@pytest.mark.parametrize("name", UNPORTED_HEADS)
def test_other_heads_raise_not_implemented(name):
    cfg = load_config(HMDB, opts=[f"MODEL.NAME={name}"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg)


@pytest.mark.parametrize("name", UNPORTED_HEADS)
@pytest.mark.parametrize("only_test", ["true", "false"])
def test_cli_refuses_unported_heads_before_model_build(name, only_test,
                                                       tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_cli(["--cfg", HMDB, "--device", "cpu", f"MODEL.NAME={name}",
                  f"TEST.ONLY_TEST={only_test}",
                  f"CHECKPOINT.CHECKPOINT_DIR={tmp_path}"])
    assert not os.path.exists(os.path.join(tmp_path, "log.txt"))


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


def test_build_model_builds_clipfsar_at_full_width():
    cfg = load_config(os.path.join(CONFIGS, "clipfsar", "hmdb.yaml"))
    model = build_model(cfg)
    assert isinstance(model, CLIPFSARModel)
    assert (model.way, model.shot) == (5, 1)
    assert model.arch.embed_dim == 1024 and not model.arch.is_vit
    assert model.context2.depth == 1
    attn = model.context2.attn_0
    assert (attn.heads, attn.dim_head) == (8, 128)
    assert model.context2.ff_0.fc1.out_features == 2048
    assert model.use_classification and not model.merge_before
    assert not (model.eval_text or model.combine or model.single_direct)
    assert model.text_coff == 0.9                         # TEXT_COFF unset
    assert model.compute_dtype == torch.bfloat16
    assert (model.encode_chunk, model.train_encode_chunk) == (0, 0)
    vit = build_model(load_config(
        os.path.join(CONFIGS, "clipfsar", "hmdb.yaml"),
        opts=["MODEL.BACKBONE=ViT-B/16", "MODEL.TRANSFORMER_DEPTH=2"]))
    assert vit.arch.embed_dim == 512 and vit.context2.depth == 2
    assert (vit.encode_chunk, vit.train_encode_chunk,
            vit.train_remat_policy) == (30, 40, "attn_out")


def test_build_model_builds_cpm2c_at_full_width():
    cfg = load_config(os.path.join(CONFIGS, "cpm2c", "hmdb.yaml"))
    model = build_model(cfg)
    assert isinstance(model, CPM2CModel)
    assert (model.motion_coeff, model.normal_coeff) == (0.0, 1.0)
    assert list(cfg.MODEL.LMD) == [0.5, 1, 0]
    d = 1024
    assert model.arch.embed_dim == d
    assert model.class_token.shape == model.class_token_motion.shape \
        == (1, 1, d)
    # hmdb's SPM widths over the cpm2c defaults: 1.5 d and 0.5 d
    assert model.gate_text_fc1.out_features == 1536
    assert model.gate_vision_fc1.out_features == 512
    assert model.p["negative_slope"] == 0.0025
    convs = [(c.kernel_size, c.padding, c.dilation, c.in_channels)
             for c in (model.motion_conv1_1, model.motion_conv1_3,
                       model.motion_conv1_5, model.scale_conv)]
    assert convs == [((1,), (0,), (1,), d), ((3,), (1,), (1,), d),
                     ((3,), (2,), (2,), d), ((1,), (0,), (1,), 3 * d)]
    assert (model.context2.attn_0.heads,
            model.context2.attn_0.dim_head) == (8, 128)
    assert not (model.use_contrastive or model.merge_before)
    # the JAX build passes cpm2c no remat policy: "full", whatever is set
    vit = build_model(load_config(
        os.path.join(CONFIGS, "cpm2c", "hmdb.yaml"),
        opts=["MODEL.BACKBONE=ViT-B/16",
              "MODEL.TRAIN_REMAT_POLICY=attn"]))
    assert (vit.train_encode_chunk, vit.train_remat_policy) == (40, "full")


def test_build_model_builds_sten_at_full_width():
    model = build_model(load_config(os.path.join(CONFIGS, "sten",
                                                 "ucf.yaml")))
    assert isinstance(model, STENModel)
    assert (model.way, model.shot) == (5, 1)
    assert model.arch.embed_dim == 1024
    # the tower's parameters and nothing else
    assert {k.split(".")[0] for k, _ in model.named_parameters()} \
        == {"backbone"}
