"""Full FSAR models: backbone + matching head.

Port of ``clipspm_tpu/models/fsar.py``. The backbone encodes the support and
query frames; the head consumes per-frame features; text tables are inputs
gathered per episode. Under ``USE_AMP`` the forward runs under bf16 autocast
(convolutions and matmuls in bf16; norms in fp32; the OTAM and soft-DTW DPs
in fp32). ``build_model`` builds ``clipspm`` (``CLIPSPMModel`` below) and
``ta2n`` (``heads/ta2n.py:TA2NModel``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from .backbones.clip import CLIP_ARCHS, CLIPArch
from .backbones.resnet import RESNET_LAYERS
from .heads.clipspm import CLIPSPM
from .heads.ta2n import TA2NModel
from .visual import compute_autocast, encode_chunked, make_clip_visual


class CLIPSPMModel(nn.Module):
    """CLIP visual tower + CLIPSPM head.

    Shapes (S=way*shot, Q=way*queries, T=seq_len, C=classes in the split):
        support_images: ``[S, T, H, W, 3]`` float (0-1)
        target_images: ``[Q, T, H, W, 3]``
        support_labels: ``[S]`` episode-relative
        real_support_labels / real_target_labels: ``[S]`` / ``[Q]``
            dataset-level (text-table rows)
        text_train / text_test: ``[C, D]`` class-text tables
    The train/test table follows ``self.training``. Returns
    dict(logits=``[1, Q, way]``, dists=scalar).
    """

    def __init__(self, arch: CLIPArch, way: int, shot: int,
                 spm: Mapping[str, float], single_direct: bool = False,
                 encode_chunk: int = 0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.arch = arch
        self.encode_chunk = encode_chunk
        self.compute_dtype = compute_dtype
        self.backbone = make_clip_visual(arch)
        self.head = CLIPSPM(dim=arch.embed_dim, way=way, shot=shot, spm=spm,
                            single_direct=single_direct)

    def forward(self, support_images, target_images, support_labels,
                real_support_labels, real_target_labels, text_train,
                text_test) -> Dict[str, torch.Tensor]:
        S, Q = support_images.shape[0], target_images.shape[0]
        feats = self.encode(torch.cat([support_images, target_images], dim=0))
        return self.match_features(feats[:S], feats[S:S + Q], support_labels,
                                   real_support_labels, real_target_labels,
                                   text_train, text_test)

    def feature_cacheable(self) -> bool:
        """Per-video features fully determine this head's inputs
        (train/feature_cache.py)."""
        return True

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """``[N, T, H, W, 3]`` frames -> ``[N, T, D]`` per-frame features."""
        N, T = images.shape[:2]
        flat = images.reshape((N * T,) + tuple(images.shape[2:]))
        with compute_autocast(images.device, self.compute_dtype):
            feats = encode_chunked(self.backbone, flat, self.encode_chunk)
        return feats.reshape(N, T, feats.shape[-1])

    def match_features(self, su, qu, support_labels, real_support_labels,
                       real_target_labels, text_train, text_test
                       ) -> Dict[str, torch.Tensor]:
        """Head over precomputed features ``su [S,T,D]`` / ``qu [Q,T,D]``."""
        table = text_train if self.training else text_test
        context_support = table[real_support_labels.long()][:, None, :]
        target_context = table[real_target_labels.long()][:, None, :]
        with compute_autocast(su.device, self.compute_dtype):
            return self.head(su, qu, support_labels, context_support,
                             target_context)


def build_model(cfg) -> nn.Module:
    """Construct the model named by ``cfg.MODEL.NAME``: ``clipspm`` or
    ``ta2n``; the other heads raise ``NotImplementedError``.
    ``MODEL.OTAM_BACKEND`` is not read (on a GPU the OTAM DP is always
    kernel K1, the soft-DTW DP kernel K2)."""
    name = cfg.MODEL.NAME
    if name not in ("clipspm", "ta2n"):
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP.md, open items "
            "'the other CLIP heads' and 'the remaining ResNet heads'); the "
            "port builds 'clipspm' and 'ta2n'")
    for knob in ("FAST_SOFTMAX", "BF16_NORMS", "INT8_EVAL"):
        if cfg.MODEL.get(knob, False):
            raise NotImplementedError(
                f"MODEL.{knob} is a JAX-package numerics option the port "
                "does not carry")
    backbone = cfg.MODEL.BACKBONE
    chunk_cfg = cfg.MODEL.get("ENCODE_CHUNK", None)
    if chunk_cfg is True:
        chunk = 30
    else:
        chunk = int(chunk_cfg or 0)
    compute_dtype = (torch.bfloat16 if cfg.get("USE_AMP", False) else None)
    way, shot = int(cfg.TRAIN.WAY), int(cfg.TRAIN.SHOT)
    if name == "ta2n":
        # test-size resnet trunks use a narrow width
        rn_width = 8 if backbone == "test-tiny-resnet" else 64
        rn_arch = "resnet18" if backbone == "test-tiny-resnet" else backbone
        if rn_arch not in RESNET_LAYERS:
            raise ValueError(f"unknown ResNet backbone {backbone!r}")
        m = cfg.MODEL
        return TA2NModel(
            way=way, shot=shot, seq_len=int(cfg.DATA.SEQ_LEN), arch=rn_arch,
            backbone_width=rn_width, encode_chunk=chunk,
            dropout=float(m.get("DROPOUT", 0.5)),
            dist_norm=bool(m.get("DIST_NORM", False)),
            metric=str(m.get("METRIC", "cos")), compute_dtype=compute_dtype)
    if backbone not in CLIP_ARCHS:
        raise ValueError(f"unknown CLIP backbone {backbone!r}")
    return CLIPSPMModel(
        arch=CLIP_ARCHS[backbone], way=way, shot=shot, spm=dict(cfg.params),
        single_direct=bool(cfg.MODEL.get("SINGLE_DIRECT", False)),
        encode_chunk=chunk, compute_dtype=compute_dtype)
