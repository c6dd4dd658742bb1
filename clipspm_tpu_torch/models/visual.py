"""Visual-tower helpers (leaf module: no head imports): the compute
contexts, the chunked and rematerialised encode, the ResNet heads' per-frame
encode (``encode_frames``), ``ResNetVideoModel``, the torchvision trunk
that the cacheable ResNet heads share, and ``CLIPVideoModel``, the CLIP
tower plus per-frame features that every CLIP head's model shares."""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops import tags
from ..utils.metrics import span
from .backbones.clip import make_clip_visual  # noqa: F401 (re-export)
from .backbones.resnet import TorchResNet
from .tower_graph import last_mode

# What each remat policy of the chunked train encode keeps across the
# recompute, as the JAX package names it (clipspm_tpu/models/visual.py:
# encode_chunked). "full" keeps nothing; "dots" every matmul without batch
# dimensions (the projections and the MLP, not the attention's batched
# products); the others the tensors of their tags (ops/tags.py): each
# block's attention output ("attn_out"), with the attention probabilities
# ("attn"), or with the MLP's gelu output ("mlp"). Inside a tag policy's
# contexts the blocks make each tagged tensor with its own operator.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_TAGS_BY_POLICY = {"full": (), "dots": (),
                   "attn_out": ("attn_out",),
                   "attn": ("attn_probs", "attn_out"),
                   "mlp": ("attn_out", "mlp_gelu")}
POLICIES = tuple(sorted(_TAGS_BY_POLICY))


def check_remat_policy(policy: str) -> None:
    """Refuse a ``MODEL.TRAIN_REMAT_POLICY`` the JAX package does not
    know (``ValueError``, as it raises it)."""
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; expected one of "
                         f"{list(POLICIES)}")


@contextmanager
def _tagged(names, context):
    with tags.tagging(names), context:
        yield


def _remat_context(policy: str):
    """The ``context_fn`` of a chunk's checkpoint under ``policy``, or None
    (``full``)."""
    check_remat_policy(policy)
    if policy == "full":
        return None
    names = _TAGS_BY_POLICY[policy]

    def policy_fn(ctx, op, *args, **kwargs):
        keep = op in _DOTS if policy == "dots" else tags.makes(op, names)
        return (CheckpointPolicy.MUST_SAVE if keep
                else CheckpointPolicy.PREFER_RECOMPUTE)

    def context_fn():
        forward, recompute = create_selective_checkpoint_contexts(policy_fn)
        return _tagged(names, forward), _tagged(names, recompute)

    return context_fn


def _no_cast_cache(device: torch.device):
    """Autocast as it is, without its cache of weight casts, around the
    checkpointed chunks. With the cache a chunk's forward takes the casts
    an earlier chunk made while its recompute, in the backward, makes them
    afresh, so a selective checkpoint meets operators its forward did not
    run (torch 2.13 raises for it); and each weight's gradient is summed
    over the chunks in bf16 before its cast back. Without it each chunk's
    gradient reaches the fp32 weight on its own, as the JAX package's scan
    sums them."""
    if not torch.is_autocast_enabled(device.type):
        return nullcontext()
    return torch.autocast(device.type,
                          dtype=torch.get_autocast_dtype(device.type),
                          cache_enabled=False)


def compute_autocast(device: torch.device,
                     compute_dtype: Optional[torch.dtype]):
    """The model's compute context: autocast to ``compute_dtype`` on
    ``device``, or nothing when it is None (fp32)."""
    if compute_dtype is None:
        return nullcontext()
    return torch.autocast(device.type, dtype=compute_dtype)


def fp32_context(device: torch.device):
    """Autocast off: what the JAX package computes from fp32 casts (cosine
    tables, class logits, the DPs' inputs) stays fp32 under ``USE_AMP``."""
    return torch.autocast(device.type, enabled=False)


def _tower(backbone: nn.Module, frames: torch.Tensor) -> torch.Tensor:
    """One call of the tower, a ``model.tower`` span (in a remat chunk's
    recompute too, on the thread that runs the backward) whose ``graph``
    says how the call ran: ``replay``, ``capture`` or ``eager``
    (``tower_graph.py``: a tower in evaluation on the card replays a CUDA
    graph from inside its own call)."""
    with span("model.tower", frames=lambda: frames.shape[0],
              graph=last_mode):
        return backbone(frames)


def encode_chunked(backbone: nn.Module, frames: torch.Tensor, chunk: int,
                   train_chunk: int = 0,
                   remat_policy: str = "attn_out") -> torch.Tensor:
    """Encode ``[N, ...]`` frames through ``backbone``, ``chunk`` frames per
    call (0 or >= N: one call).

    In eval mode a memory knob only: it caps the activations held at once;
    per-frame results are those of one batched call. In train mode it is
    one call unless ``train_chunk`` is set (1 reuses ``chunk``, more is the
    width): then each chunk runs under ``torch.utils.checkpoint`` and its
    backward recomputes the chunk's activations, keeping only what
    ``remat_policy`` names (``check_remat_policy``). The frames are padded
    with leading frames to whole chunks and the output cut to ``N``, as in
    the JAX package's scan. Remat changes what is stored, not the
    arithmetic; only towers without BatchNorm take it (``build_model``
    refuses the rest: per-chunk batch statistics would differ).
    """
    N = frames.shape[0]
    if backbone.training:
        chunk = chunk if train_chunk == 1 else int(train_chunk)
        if not chunk or chunk >= N:
            return _tower(backbone, frames)
        pad = (-N) % chunk
        if pad:
            frames = torch.cat([frames, frames[:pad]], dim=0)
        context = _remat_context(remat_policy)
        kw = {} if context is None else {"context_fn": context}
        with _no_cast_cache(frames.device):
            feats = torch.cat([
                checkpoint(_tower, backbone, frames[i:i + chunk],
                           use_reentrant=False, **kw)
                for i in range(0, frames.shape[0], chunk)])
        return feats[:N]
    if not chunk or chunk >= N:
        return _tower(backbone, frames)
    return torch.cat([_tower(backbone, frames[i:i + chunk])
                      for i in range(0, N, chunk)], dim=0)


def encode_frames(backbone: nn.Module, images: torch.Tensor, chunk: int,
                  compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``[N, T, H, W, 3]`` frames through a per-frame trunk (``chunk``
    frames a call in evaluation) under the compute autocast: ``[N, T,
    ...]``, the trunk's output per frame (the ResNet heads' encode)."""
    N, T = images.shape[:2]
    flat = images.reshape((N * T,) + tuple(images.shape[2:]))
    with compute_autocast(images.device, compute_dtype):
        feats = encode_chunked(backbone, flat, chunk)
    return feats.reshape((N, T) + tuple(feats.shape[1:]))


class ResNetVideoModel(nn.Module):
    """A torchvision ResNet trunk (``backbone``) feeding a matching head
    over per-video features, which the feature cache can hold; the head is
    the subclass's ``match_features``, and ``encode`` gives the trunk's
    output per frame unless the subclass refines it (otam, trx, strm).

    Shapes (S=way*shot, Q=way*queries, T=seq_len): images ``[S|Q, T, H, W,
    3]`` float (0-1); support_labels ``[S]`` episode-relative. The real
    labels and text tables are accepted and not read.
    """

    def __init__(self, way: int, shot: int, arch: str, backbone_width: int,
                 output: str, encode_chunk: int = 0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.way, self.shot = way, shot
        self.encode_chunk, self.compute_dtype = encode_chunk, compute_dtype
        self.backbone = TorchResNet(arch=arch, output=output,
                                    width=backbone_width)

    def forward(self, support_images, target_images, support_labels,
                real_support_labels=None, real_target_labels=None,
                text_train=None, text_test=None) -> Dict[str, torch.Tensor]:
        S = support_images.shape[0]
        feats = self.encode(torch.cat([support_images, target_images]))
        with span("model.head"):
            return self.match_features(feats[:S], feats[S:], support_labels)

    def feature_cacheable(self) -> bool:
        """Per-video features fully determine the head's inputs
        (train/feature_cache.py)."""
        return True

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """``[N, T, H, W, 3]`` frames -> ``[N, T, ...]`` trunk outputs."""
        return encode_frames(self.backbone, images, self.encode_chunk,
                             self.compute_dtype)

    def match_features(self, su, qu, support_labels, real_support_labels=None,
                       real_target_labels=None, text_train=None,
                       text_test=None) -> Dict[str, torch.Tensor]:
        """The head over precomputed features ``su [S,T,...]`` /
        ``qu [Q,T,...]``."""
        raise NotImplementedError


class CLIPVideoModel(nn.Module):
    """A CLIP visual tower (``backbone``) feeding a matching head over
    per-frame features; the head is the subclass's ``match_features``.

    Shapes (S=way*shot, Q=way*queries, T=seq_len, C=classes in the split):
        support_images: ``[S, T, H, W, 3]`` float (0-1)
        target_images: ``[Q, T, H, W, 3]``
        support_labels: ``[S]`` episode-relative
        real_support_labels / real_target_labels: ``[S]`` / ``[Q]``
            dataset-level (text-table rows)
        text_train / text_test: ``[C, D]`` class-text tables
    The train/test table follows ``self.training``.
    """

    def __init__(self, arch, encode_chunk: int = 0,
                 train_encode_chunk: int = 0,
                 train_remat_policy: str = "attn_out",
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.arch = arch
        # frames per tower call in evaluation; in training (a ViT tower
        # only) frames per rematerialised chunk: 0 off, 1 the eval width
        self.encode_chunk = encode_chunk
        self.train_encode_chunk = train_encode_chunk
        self.train_remat_policy = train_remat_policy
        self.compute_dtype = compute_dtype
        self.backbone = make_clip_visual(arch)

    def forward(self, support_images, target_images, support_labels,
                real_support_labels, real_target_labels, text_train,
                text_test) -> Dict[str, torch.Tensor]:
        S, Q = support_images.shape[0], target_images.shape[0]
        feats = self.encode(torch.cat([support_images, target_images], dim=0))
        with span("model.head"):
            return self.match_features(feats[:S], feats[S:S + Q],
                                       support_labels, real_support_labels,
                                       real_target_labels, text_train,
                                       text_test)

    def feature_cacheable(self) -> bool:
        """Per-video features fully determine the head's inputs
        (train/feature_cache.py)."""
        return True

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """``[N, T, H, W, 3]`` frames -> ``[N, T, D]`` per-frame features."""
        N, T = images.shape[:2]
        flat = images.reshape((N * T,) + tuple(images.shape[2:]))
        with compute_autocast(images.device, self.compute_dtype):
            feats = encode_chunked(self.backbone, flat, self.encode_chunk,
                                   self.train_encode_chunk,
                                   self.train_remat_policy)
        return feats.reshape(N, T, feats.shape[-1])

    def match_features(self, su, qu, support_labels, real_support_labels,
                       real_target_labels, text_train, text_test
                       ) -> Dict[str, torch.Tensor]:
        """The head over precomputed features ``su [S,T,D]`` /
        ``qu [Q,T,D]``."""
        raise NotImplementedError
