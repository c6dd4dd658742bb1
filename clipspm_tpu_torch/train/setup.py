"""Construction: config -> (model, weights, text tables, data, learner).

Port of ``clipspm_tpu/train/setup.py``. Pretrained CLIP
weights load from a local OpenAI ``.pt`` (``$CLIP_WEIGHTS_DIR`` or
``~/.cache/clip``) straight into the port's OpenAI-named modules, never from
the network; without one the towers start from a seeded random init and an
evaluation refuses to run unless random weights are explicitly allowed.
Heads on the torchvision ResNet trunk (ta2n, otam, trx, strm, soap, molo)
build no CLIP model and no text tables: their tables are ``[1, 1]`` zeros
and their trunk starts from the seeded random init, as in the JAX package
(which loads no ImageNet weights).
Every run gets the test split's prefetching ``EpisodeLoader``, seeded with
``MODEL.SEED + 1`` (the uncached evaluator's stream); a training run
(``TEST.ONLY_TEST`` false) also gets the train split's, seeded with
``MODEL.SEED``.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Optional, Tuple

import torch

from .. import resolve_device, set_matmul_precision
from ..data.pipeline import EpisodeLoader
from ..data.sampler import EpisodeSampler
from ..data.splits import load_split
from ..models.backbones.clip import CLIP_ARCHS, CLIPArch, CLIPModel
from ..models.backbones.tokenizer import get_tokenizer
from ..models.fsar import build_model
from ..models.text_features import (PROMPT_TEMPLATES, SINGLE_TEMPLATE,
                                    encode_class_text_tables)
from ..parallel.mesh import EpisodeMesh
from ..weights import random_init_
from .learner import Learner

# model files named as in the OpenAI release, with their SHA-256 digests
_CLIP_FILES = {"RN50": "RN50.pt", "ViT-B/16": "ViT-B-16.pt"}
CLIP_CHECKPOINT_SHA256 = {
    "RN50.pt":
        "afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762",
    "ViT-B-16.pt":
        "5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f",
}

CLIP_HEADS = ("clipspm", "clipfsar", "cpm2c", "sten")
SINGLE_PROMPT_HEADS = ("clipfsar", "sten")


class DegradedModeError(RuntimeError):
    """A CLIP head would run with meaningless weights or vocab."""


def find_clip_checkpoint(backbone: str) -> Optional[str]:
    fname = _CLIP_FILES.get(backbone)
    if fname is None:
        return None
    for root in (os.environ.get("CLIP_WEIGHTS_DIR"),
                 os.path.expanduser("~/.cache/clip")):
        if root and os.path.isfile(os.path.join(root, fname)):
            return os.path.join(root, fname)
    return None


def _verify_sha256(path: str) -> None:
    expected = CLIP_CHECKPOINT_SHA256.get(os.path.basename(path))
    if expected is None:
        return
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    if h.hexdigest() != expected:
        raise RuntimeError(
            f"checkpoint integrity failure: {path} is not the official "
            f"{os.path.basename(path)} release (SHA-256 mismatch). Re-fetch "
            "it, or set CLIPSPM_SKIP_WEIGHT_VERIFY=1 for a custom file.")


def infer_arch_from_state_dict(sd) -> CLIPArch:
    """The CLIP architecture (ViT or RN family) from an OpenAI state
    dict's shapes, as ``clipspm_tpu/models/backbones/torch_import.py``
    infers it."""
    if "visual.proj" in sd:
        vision_width = sd["visual.conv1.weight"].shape[0]
        vision_layers = len([k for k in sd if k.startswith("visual.")
                             and k.endswith(".attn.in_proj_weight")])
        patch = sd["visual.conv1.weight"].shape[-1]
        grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        image_resolution = patch * grid
    else:
        vision_layers = tuple(len({k.split(".")[2] for k in sd
                                   if k.startswith(f"visual.layer{b}")})
                              for b in (1, 2, 3, 4))
        vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
        patch = None
        out_width = round(
            (sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
        image_resolution = out_width * 32
    width = sd["ln_final.weight"].shape[0]
    return CLIPArch(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=image_resolution, vision_layers=vision_layers,
        vision_width=vision_width, vision_patch_size=patch,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=width, transformer_heads=max(1, width // 64),
        transformer_layers=len({k.split(".")[2] for k in sd
                                if k.startswith("transformer.resblocks")}))


def load_clip_checkpoint(path: str, verify: bool = True) -> CLIPModel:
    """An OpenAI CLIP ``.pt`` (TorchScript archive or state dict) loaded
    into the port's OpenAI-named modules."""
    if verify:
        _verify_sha256(path)
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu")
    for key in ("input_resolution", "context_length", "vocab_size"):
        sd.pop(key, None)
    model = CLIPModel(infer_arch_from_state_dict(sd))
    missing, unexpected = model.load_state_dict(
        {k: v.float() for k, v in sd.items()}, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise RuntimeError(f"{path}: missing keys {missing[:5]}, unexpected "
                           f"keys {unexpected[:5]}")
    return model


def build_clip_variables(backbone: str, gen: torch.Generator
                         ) -> Tuple[CLIPModel, bool]:
    """The full CLIP model (visual + text) on the CPU: pretrained when a
    local checkpoint exists, else a seeded random init. Returns
    ``(model, pretrained)``."""
    ckpt = find_clip_checkpoint(backbone)
    if ckpt is not None:
        verify = os.environ.get("CLIPSPM_SKIP_WEIGHT_VERIFY", "0") != "1"
        return load_clip_checkpoint(ckpt, verify=verify), True
    model = CLIPModel(CLIP_ARCHS[backbone])
    return random_init_(model, gen), False


def build_text_tables(cfg, clip_model: CLIPModel
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Template-ensemble text features for train/test class names, in fp32
    (one padded-batch stream for both tables)."""
    templates = (SINGLE_TEMPLATE if cfg.MODEL.NAME in SINGLE_PROMPT_HEADS
                 else PROMPT_TEMPLATES)
    return tuple(encode_class_text_tables(
        clip_model, [list(cfg.TRAIN.CLASS_NAME), list(cfg.TEST.CLASS_NAME)],
        templates))


def loader_prefetch(cfg, train: bool) -> int:
    """Prefetch-queue depth: at least one consumer batch
    (``TASKS_PER_BATCH`` in training, ``TEST.EVAL_BATCH`` in evaluation),
    so staging a batch does not wait on per-episode decode;
    ``DATA.PREFETCH`` overrides."""
    explicit = int(cfg.DATA.get("PREFETCH", 0) or 0)
    if explicit:
        return explicit
    batch = int(cfg.TRAIN.TASKS_PER_BATCH) if train else \
        int(cfg.TEST.get("EVAL_BATCH", 1) or 1)
    return max(4, batch)


def has_restorable_checkpoint(cfg) -> bool:
    """True when an ONLY_TEST run will restore a trained state over the
    fresh weights: ``checkpoint_best`` under ``CHECKPOINT.CHECKPOINT_DIR``,
    or a ``TEST.TEST_MODEL_PATH`` (cli/run.py restores either)."""
    from .checkpoint import CheckpointManager

    ckdir = str(cfg.CHECKPOINT.CHECKPOINT_DIR)
    return bool(str(cfg.TEST.get("TEST_MODEL_PATH", "") or "")) or (
        bool(ckdir) and CheckpointManager(ckdir).exists("best"))


def _device_key(cfg, key: str) -> int:
    n = (cfg.get("DEVICE", {}) or {}).get(key)
    return int(1 if n is None else n)


def num_chips(cfg) -> int:
    """``DEVICE.NUM_CHIPS``, the dp width (1 when unset)."""
    return _device_key(cfg, "NUM_CHIPS")


def num_tp(cfg) -> int:
    """``DEVICE.TP``, the tp width (1 when unset)."""
    return _device_key(cfg, "TP")


def check_num_chips(cfg, device=None) -> None:
    """``DEVICE.NUM_CHIPS`` (dp) and ``DEVICE.TP`` (tp), with the JAX
    ``build_device_mesh``'s errors: below 1 raises ``ValueError`` (its
    ``or 1`` reads 0 as 1, the port refuses it); a grid of more ranks
    (``NUM_CHIPS x TP``) than visible CUDA devices raises ``ValueError``
    when ``device`` is ``cuda`` (on the CPU any grid runs); a training run
    whose ``TASKS_PER_BATCH`` the dp width does not divide raises
    ``ValueError`` (TP takes no part in it)."""
    n_dp, n_tp = num_chips(cfg), num_tp(cfg)
    if n_dp < 1 or n_tp < 1:
        raise ValueError(f"DEVICE.NUM_CHIPS={n_dp} / DEVICE.TP={n_tp} must "
                         "be >= 1")
    if n_dp * n_tp == 1:
        return
    if device is not None and torch.device(device).type == "cuda":
        n_avail = torch.cuda.device_count()
        if n_dp * n_tp > n_avail:
            raise ValueError(
                f"DEVICE.NUM_CHIPS={n_dp} x DEVICE.TP={n_tp} needs "
                f"{n_dp * n_tp} devices but only {n_avail} are visible — "
                "fix the config or run on a host with enough chips")
    tpb = int(cfg.TRAIN.TASKS_PER_BATCH)
    if not bool(cfg.TEST.ONLY_TEST) and tpb % n_dp:
        raise ValueError(
            f"TRAIN.TASKS_PER_BATCH={tpb} is not divisible by "
            f"DEVICE.NUM_CHIPS={n_dp}: the optimizer step shards "
            f"{n_dp} concurrent episodes per microstep, so the episode "
            "batch must split evenly across chips")


def build_catalog_and_sampler(cfg, mode: str, train: bool, queries: int
                              ) -> Tuple[object, EpisodeSampler]:
    """Split catalog + seeded episodic sampler for one split. The eval seed
    is ``MODEL.SEED + 1``, the JAX package's test stream."""
    catalog = load_split(cfg.traintestlist, cfg.path, mode,
                         cfg.DATA.DATASET, int(cfg.DATA.SEQ_LEN),
                         int(cfg.DATA.get("SPLIT", 3)))
    sampler = EpisodeSampler(
        catalog, way=int(cfg.TRAIN.WAY), shot=int(cfg.TRAIN.SHOT),
        queries=queries, seq_len=int(cfg.DATA.SEQ_LEN), train=train,
        seed=int(cfg.MODEL.SEED) + (0 if train else 1))
    return catalog, sampler


def build_learner(cfg, log_fn=print, allow_random_weights: bool = False,
                  device=None, mesh: Optional[EpisodeMesh] = None
                  ) -> Learner:
    """Model + weights + text tables (CLIP heads only) + transform, the test
    ``EpisodeLoader`` and, for a training run, the train one, on ``device``
    (``cuda`` unless the caller asks for the CPU). On a grid of more than
    one rank (``DEVICE.NUM_CHIPS x DEVICE.TP``) each rank builds its own on
    its ``mesh`` (whose device is the rank's): loaders that decode its dp
    index's share of each stream and a learner that runs that share of each
    step, its tower sharded over the tp ranks once the weights are in place
    (``Learner``).

    ``allow_random_weights`` (CLI ``--allow-random-weights`` or cfg
    ``MODEL.ALLOW_RANDOM_WEIGHTS``) permits evaluating a CLIP head without
    pretrained weights or the OpenAI BPE vocab; otherwise that raises
    :class:`DegradedModeError`, unless a checkpoint will be restored over
    them.
    """
    check_num_chips(cfg)
    grid = (num_chips(cfg), num_tp(cfg))
    if grid != ((mesh.dp_world, mesh.tp) if mesh is not None else (1, 1)):
        raise ValueError(
            f"DEVICE.NUM_CHIPS x DEVICE.TP = {grid[0]} x {grid[1]} runs as "
            "that grid of ranks, each building its learner on its mesh (the "
            "CLI starts them); this one was given "
            f"{f'{mesh.dp_world} x {mesh.tp}' if mesh else 'no'} mesh")
    dev = resolve_device(mesh.device if mesh is not None else device)
    if mesh is not None:
        log_fn(f"device mesh: dp={mesh.dp_world} x tp={mesh.tp} "
               f"({mesh.world} devices)")
    use_amp = bool(cfg.get("USE_AMP", False))
    set_matmul_precision(use_amp)
    t0 = time.perf_counter()
    build_seconds = {}

    def mark(stage):
        nonlocal t0
        now = time.perf_counter()
        build_seconds[stage] = now - t0
        log_fn(f"build_learner: {stage} in {now - t0:.1f}s")
        t0 = now

    def make_loader(mode: str, train: bool, queries: int) -> EpisodeLoader:
        _, sampler = build_catalog_and_sampler(cfg, mode, train, queries)
        return EpisodeLoader(sampler, num_workers=int(cfg.DATA.NUM_WORKERS),
                             prefetch=loader_prefetch(cfg, train),
                             shard=((mesh.dp_rank, mesh.dp_world) if mesh
                                    else (0, 1)),
                             group=mesh.loader_group() if mesh else None)

    def learner(text_train, text_test):
        test_loader = make_loader("test", False,
                                  int(cfg.TEST.QUERY_PER_CLASS))
        train_loader = None if bool(cfg.TEST.ONLY_TEST) else make_loader(
            "train", True, int(cfg.TRAIN.QUERY_PER_CLASS))
        mark("loaders")
        return Learner(cfg, model, text_train, text_test, dev,
                       build_seconds=build_seconds,
                       train_source=train_loader, test_source=test_loader,
                       log_fn=log_fn, mesh=mesh)

    gen = torch.Generator().manual_seed(int(cfg.MODEL.SEED))
    model = random_init_(build_model(cfg), gen)
    mark("model init")
    if cfg.MODEL.NAME not in CLIP_HEADS:
        zeros = torch.zeros(1, 1)
        return learner(zeros, zeros)
    allow_random_weights = (allow_random_weights
                            or bool(cfg.MODEL.get("ALLOW_RANDOM_WEIGHTS",
                                                  False)))
    clip_model, pretrained = build_clip_variables(cfg.MODEL.BACKBONE, gen)
    degraded = []
    if not pretrained:
        degraded.append("no local CLIP checkpoint (set CLIP_WEIGHTS_DIR or "
                        "place weights in ~/.cache/clip) — backbone weights "
                        "are RANDOM")
    if not get_tokenizer().using_openai_vocab:
        degraded.append("OpenAI BPE vocab asset missing (expected at "
                        "clipspm_tpu/assets/bpe_simple_vocab_16e6.txt.gz or "
                        "$CLIP_BPE_PATH) — text features use a SYNTHETIC "
                        "vocabulary, not CLIP's")
    if degraded:
        msg = "; ".join(degraded)
        if bool(cfg.TEST.ONLY_TEST) and not allow_random_weights \
                and not has_restorable_checkpoint(cfg):
            raise DegradedModeError(
                f"refusing to evaluate CLIP head {cfg.MODEL.NAME!r} in a "
                f"degraded state: {msg}. Pass --allow-random-weights to "
                "override.")
        log_fn(f"WARNING: degraded CLIP setup — {msg}")
    model.backbone.load_state_dict(clip_model.visual.state_dict())
    mark("CLIP tower init")
    clip_model.to(dev).eval()
    text_train, text_test = build_text_tables(cfg, clip_model)
    del clip_model
    mark("text tables")
    return learner(text_train, text_test)
