"""Full FSAR models: backbone + matching head.

Port of ``clipspm_tpu/models/fsar.py``. The backbone encodes the support and
query frames; the head consumes per-frame features; text tables are inputs
gathered per episode. Under ``USE_AMP`` the forward runs under bf16 autocast
(convolutions and matmuls in bf16; norms in fp32; the OTAM and soft-DTW DPs
in fp32). ``build_model`` builds ``clipspm`` (``CLIPSPMModel`` below),
``clipfsar``, ``sten`` and ``cpm2c`` (``heads/{clipfsar,sten,cpm2c}.py``, on
``visual.py:CLIPVideoModel``) and ``ta2n`` (``heads/ta2n.py:TA2NModel``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from .backbones.clip import CLIP_ARCHS, CLIPArch
from .backbones.resnet import RESNET_LAYERS
from .heads.clipspm import CLIPSPM
from .heads.ta2n import TA2NModel
from .heads.clipfsar import CLIPFSARModel
from .heads.cpm2c import CPM2CModel
from .heads.sten import STENModel
from .visual import CLIPVideoModel, check_remat_policy, compute_autocast


class CLIPSPMModel(CLIPVideoModel):
    """CLIP visual tower + CLIPSPM head (shapes: ``CLIPVideoModel``).
    Returns dict(logits=``[1, Q, way]``, dists=scalar)."""

    def __init__(self, arch: CLIPArch, way: int, shot: int,
                 spm: Mapping[str, float], single_direct: bool = False,
                 encode_chunk: int = 0, train_encode_chunk: int = 0,
                 train_remat_policy: str = "attn_out",
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(arch, encode_chunk, train_encode_chunk,
                         train_remat_policy, compute_dtype)
        self.head = CLIPSPM(dim=arch.embed_dim, way=way, shot=shot, spm=spm,
                            single_direct=single_direct)

    def match_features(self, su, qu, support_labels, real_support_labels,
                       real_target_labels, text_train, text_test
                       ) -> Dict[str, torch.Tensor]:
        table = text_train if self.training else text_test
        context_support = table[real_support_labels.long()][:, None, :]
        target_context = table[real_target_labels.long()][:, None, :]
        with compute_autocast(su.device, self.compute_dtype):
            return self.head(su, qu, support_labels, context_support,
                             target_context)


PORTED_MODELS = ("clipspm", "clipfsar", "sten", "cpm2c", "ta2n")


def check_model_config(cfg) -> None:
    """Raise for a model config the port does not build, before anything
    is built: a head other than ``PORTED_MODELS`` or a JAX-package
    numerics knob (``NotImplementedError``, naming the ROADMAP item), a
    remat policy the port does not honour, a train chunk on a BatchNorm
    backbone (``ValueError``, as the JAX package raises it)."""
    name = cfg.MODEL.NAME
    if name not in PORTED_MODELS:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP.md, open item 'the "
            f"remaining ResNet heads'); the port builds {PORTED_MODELS}")
    for knob in ("FAST_SOFTMAX", "BF16_NORMS", "INT8_EVAL"):
        if cfg.MODEL.get(knob, False):
            raise NotImplementedError(
                f"MODEL.{knob} is a JAX-package numerics option the port "
                "does not carry")
    _chunking(cfg.MODEL, cfg.MODEL.BACKBONE, name)


def build_model(cfg) -> nn.Module:
    """Construct the model named by ``cfg.MODEL.NAME`` (``PORTED_MODELS``),
    wired as the JAX package's ``build_model`` wires it; what
    ``check_model_config`` refuses raises.
    ``MODEL.OTAM_BACKEND`` is not read (on a GPU the OTAM DP is always
    kernel K1, the soft-DTW DP kernel K2)."""
    check_model_config(cfg)
    name, backbone = cfg.MODEL.NAME, cfg.MODEL.BACKBONE
    chunk, train_chunk, remat_policy = _chunking(cfg.MODEL, backbone, name)
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
    arch, m = CLIP_ARCHS[backbone], cfg.MODEL
    tower = dict(encode_chunk=chunk, train_encode_chunk=train_chunk,
                 compute_dtype=compute_dtype)
    depth = int(m.get("TRANSFORMER_DEPTH", 1) or 1)
    if name == "clipfsar":
        return CLIPFSARModel(
            arch=arch, way=way, shot=shot, transformer_depth=depth,
            use_classification=bool(m.get("USE_CLASSIFICATION", True)),
            single_direct=bool(m.get("SINGLE_DIRECT", False)),
            merge_before=bool(m.get("MERGE_BEFORE", False)),
            eval_text=bool(m.get("EVAL_TEXT", False)),
            combine=bool(m.get("COMBINE", False)),
            text_coff=float(m.get("TEXT_COFF", 0) or 0.9),
            train_remat_policy=remat_policy, **tower)
    if name == "sten":
        return STENModel(arch=arch, way=way, shot=shot,
                         train_remat_policy=remat_policy, **tower)
    if name == "cpm2c":
        # the JAX build passes cpm2c no remat policy: it trains under "full"
        return CPM2CModel(
            arch=arch, way=way, shot=shot, params=dict(cfg.params),
            motion_coeff=float(m.get("MOTION_COFF", 0.5)),
            normal_coeff=float(m.get("NORMAL_COFF", 0.5)),
            transformer_depth=depth,
            use_classification=bool(m.get("USE_CLASSIFICATION", True)),
            use_contrastive=bool(m.get("USE_CONTRASTIVE", False)),
            single_direct=bool(m.get("SINGLE_DIRECT", False)),
            merge_before=bool(m.get("MERGE_BEFORE", False)), **tower)
    return CLIPSPMModel(
        arch=arch, way=way, shot=shot, spm=dict(cfg.params),
        single_direct=bool(m.get("SINGLE_DIRECT", False)),
        train_remat_policy=remat_policy, **tower)


def _chunking(m, backbone: str, name: str = "clipspm"):
    """``(ENCODE_CHUNK, TRAIN_ENCODE_CHUNK, TRAIN_REMAT_POLICY)`` with the
    JAX package's defaults (``clipspm_tpu/models/fsar.py:build_model``): a
    full-size CLIP ViT encodes 30 frames a call in evaluation and trains in
    rematerialised chunks of 40 keeping the attention outputs; every other
    backbone encodes in one call. ``ENCODE_CHUNK: true`` is 30;
    ``TRAIN_ENCODE_CHUNK: true`` reuses the eval width, or 40 when that is
    0; a train chunk on a BatchNorm backbone raises ``ValueError``. cpm2c
    reads no policy (it trains under ``"full"``)."""
    is_vit = backbone in CLIP_ARCHS and CLIP_ARCHS[backbone].is_vit
    is_full_vit = is_vit and backbone != "test-tiny"
    chunk_cfg = m.get("ENCODE_CHUNK", None)
    if chunk_cfg is None:
        chunk = 30 if is_full_vit else 0
    elif chunk_cfg is True:
        chunk = 30
    else:
        chunk = int(chunk_cfg or 0)
    tec_cfg = m.get("TRAIN_ENCODE_CHUNK", None)
    train_chunk = (40 if is_full_vit else 0) if tec_cfg is None else int(
        tec_cfg or 0)
    if train_chunk == 1 and not chunk:
        train_chunk = 40
    if train_chunk and not is_vit:
        raise ValueError(
            "MODEL.TRAIN_ENCODE_CHUNK requires a CLIP ViT backbone: "
            f"{backbone!r} has BatchNorm batch statistics, which per-chunk "
            "training would compute per chunk instead of per episode")
    remat_policy = ("full" if name == "cpm2c" else
                    str(m.get("TRAIN_REMAT_POLICY", "attn_out")
                        or "attn_out"))
    if train_chunk:
        check_remat_policy(remat_policy)
    return chunk, train_chunk, remat_policy
