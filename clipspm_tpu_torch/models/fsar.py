"""Full FSAR models: backbone + matching head.

Port of ``clipspm_tpu/models/fsar.py``. The backbone encodes the support and
query frames; the head consumes per-frame features; text tables are inputs
gathered per episode. Under ``USE_AMP`` the forward runs under bf16 autocast
(convolutions and matmuls in bf16; norms in fp32 unless
``MODEL.BF16_NORMS``; the OTAM and soft-DTW DPs in fp32). The CLIP towers
take the JAX package's switches ``MODEL.FAST_SOFTMAX``, ``MODEL.BF16_NORMS``
and ``MODEL.INT8_EVAL`` (``clip_arch``). ``build_model`` builds all ten
heads of ``configs/``: ``clipspm`` (``CLIPSPMModel`` below), ``clipfsar``,
``sten`` and ``cpm2c`` (``heads/{clipfsar,sten,cpm2c}.py``, on
``visual.py:CLIPVideoModel``), and on the torchvision ResNet trunk
``ta2n``, ``otam``, ``trx``, ``strm``, ``soap`` and ``molo``
(``heads/<name>.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from .backbones.clip import CLIP_ARCHS, CLIPArch
from .backbones.resnet import RESNET_LAYERS
from .heads.clipfsar import CLIPFSARModel
from .heads.clipspm import CLIPSPM
from .heads.cpm2c import CPM2CModel
from .heads.molo import MoLoModel
from .heads.otam import OTAMModel
from .heads.soap import SOAPModel
from .heads.sten import STENModel
from .heads.strm import STRMModel
from .heads.ta2n import TA2NModel
from .heads.trx import TRXModel
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


# the heads on the torchvision ResNet trunk (the rest are CLIP heads)
RESNET_HEADS = ("ta2n", "otam", "trx", "strm", "soap", "molo")
PORTED_MODELS = ("clipspm", "clipfsar", "sten", "cpm2c") + RESNET_HEADS


def check_model_config(cfg) -> None:
    """Raise for a model config the port does not build, before anything
    is built: a name outside ``PORTED_MODELS`` (``NotImplementedError``, as
    the JAX ``build_model`` raises it); an unknown CLIP backbone,
    ``MODEL.INT8_EVAL`` on a ResNet tower, an unknown remat policy or a
    train chunk on a BatchNorm backbone (``ValueError``, as the JAX package
    raises them)."""
    name = cfg.MODEL.NAME
    if name not in PORTED_MODELS:
        raise NotImplementedError(
            f"model {name!r} is not one of the system's heads "
            f"{PORTED_MODELS}")
    if name not in RESNET_HEADS:
        clip_arch(cfg)
    _chunking(cfg.MODEL, cfg.MODEL.BACKBONE, name)


def clip_arch(cfg) -> CLIPArch:
    """``MODEL.BACKBONE``'s CLIP architecture with the vision tower's
    switches ``MODEL.FAST_SOFTMAX``, ``MODEL.BF16_NORMS`` and
    ``MODEL.INT8_EVAL`` (ViT towers only), as the JAX ``build_model`` sets
    them for every CLIP head; the ResNet heads read none of them."""
    backbone, m = cfg.MODEL.BACKBONE, cfg.MODEL
    if backbone not in CLIP_ARCHS:
        raise ValueError(f"unknown CLIP backbone {backbone!r}")
    arch = CLIP_ARCHS[backbone]
    int8 = bool(m.get("INT8_EVAL", False))
    if int8 and not arch.is_vit:
        raise ValueError(
            "MODEL.INT8_EVAL currently covers the ViT tower's "
            "projection/MLP matmuls only (the RN50 conv tower has no int8 "
            "path)")
    return dataclasses.replace(
        arch, fast_softmax=bool(m.get("FAST_SOFTMAX", False)),
        bf16_norms=bool(m.get("BF16_NORMS", False)), int8_eval=int8)


def build_model(cfg, **head_flags) -> nn.Module:
    """Construct the model named by ``cfg.MODEL.NAME`` (``PORTED_MODELS``),
    wired as the JAX package's ``build_model`` wires it; what
    ``check_model_config`` refuses raises.
    ``MODEL.OTAM_BACKEND`` is not read (on a GPU the OTAM DP is always
    kernel K1, the soft-DTW DP kernel K2). ``head_flags``: constructor
    flags that no config key sets, as in the JAX package (cpm2c's
    ``use_visual_prompts`` and ``use_video_adapter``); another head
    refuses them."""
    check_model_config(cfg)
    if head_flags and cfg.MODEL.NAME != "cpm2c":
        raise ValueError(f"{cfg.MODEL.NAME} takes no head flags, got "
                         f"{sorted(head_flags)}")
    name, backbone = cfg.MODEL.NAME, cfg.MODEL.BACKBONE
    chunk, train_chunk, remat_policy = _chunking(cfg.MODEL, backbone, name)
    compute_dtype = (torch.bfloat16 if cfg.get("USE_AMP", False) else None)
    way, shot = int(cfg.TRAIN.WAY), int(cfg.TRAIN.SHOT)
    if name in RESNET_HEADS:
        return _resnet_head(cfg, name, way, shot, chunk, compute_dtype)
    arch, m = clip_arch(cfg), cfg.MODEL
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
            merge_before=bool(m.get("MERGE_BEFORE", False)), **head_flags,
            **tower)
    return CLIPSPMModel(
        arch=arch, way=way, shot=shot, spm=dict(cfg.params),
        single_direct=bool(m.get("SINGLE_DIRECT", False)),
        train_remat_policy=remat_policy, **tower)


def _resnet_head(cfg, name: str, way: int, shot: int, chunk: int,
                 compute_dtype: Optional[torch.dtype]) -> nn.Module:
    """A head of ``RESNET_HEADS`` on the torchvision trunk, wired as the
    JAX ``build_model`` wires it: ``test-tiny-resnet`` is ResNet-18 at
    width 8, any other backbone the ResNet of its name at width 64."""
    backbone, m = cfg.MODEL.BACKBONE, cfg.MODEL
    tiny = backbone == "test-tiny-resnet"
    arch = "resnet18" if tiny else backbone
    if arch not in RESNET_LAYERS:
        raise ValueError(f"unknown ResNet backbone {backbone!r}")
    seq_len = int(cfg.DATA.SEQ_LEN)
    common = dict(way=way, shot=shot, arch=arch,
                  backbone_width=8 if tiny else 64, encode_chunk=chunk,
                  compute_dtype=compute_dtype)
    if name == "ta2n":
        return TA2NModel(
            seq_len=seq_len, dropout=float(m.get("DROPOUT", 0.5)),
            dist_norm=bool(m.get("DIST_NORM", False)),
            metric=str(m.get("METRIC", "cos")), **common)
    if name == "otam":
        return OTAMModel(**common)
    if name == "molo":
        return MoLoModel(
            seq_len=seq_len, num_class=int(cfg.DATA.get("NUM_CLASS", 64)),
            use_classification=bool(m.get("USE_CLASSIFICATION", True)),
            use_local=bool(m.get("USE_LOCAL", False)),
            use_contrastive=bool(m.get("USE_CONTRASTIVE", True)),
            temp_coff=float(m.get("TEMP_COFF", 0) or 0),
            logit_balance=float(m.get("LOGIT_BALANCE_COFF", 0) or 0.3),
            single_direct=bool(m.get("SINGLE_DIRECT", False)),
            heads=int(m.get("HEAD", 0) or 8),
            position_a=float(m.get("POSITION_A", 10.0)),
            position_b=float(m.get("POSITION_B", 1.0)), **common)
    # trx, strm and soap: TRX cross-transformers over frame tuples
    tuples = dict(seq_len=seq_len,
                  temp_set=tuple(m.get("TEMP_SET",
                                       (2, 3) if name == "trx" else (2,))),
                  out_dim=int(m.get("TRANS_LINEAR_OUT_DIM", 1152)),
                  dropout=float(m.get("TRANS_DROPOUT", 0.1)), **common)
    if name == "trx":
        return TRXModel(**tuples)
    if name == "strm":
        return STRMModel(**tuples)
    return SOAPModel(horizons=tuple(m.get("O", (2, 3))),
                     cr=int(m.get("cr", 16)), **tuples)


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
