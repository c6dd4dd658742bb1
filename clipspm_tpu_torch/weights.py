"""Where the port's weights come from.

- ``random_init_``: a seeded random initialisation with the JAX package's
  distributions (flax defaults plus CLIP's own embedding scales), drawn from
  an explicit ``torch.Generator``.
- The JAX package's variables, as numpy trees of ``{params, batch_stats}``,
  turned into the port's ``state_dict``. CLIP keys are OpenAI's: this is the
  inverse of ``clipspm_tpu/models/backbones/torch_import.py:
  convert_clip_state_dict``. A flax conv kernel ``[kh, kw, in, out]``
  becomes ``[out, in, kh, kw]``, a Dense kernel ``[in, out]`` becomes
  ``[out, in]``, BatchNorm ``scale/bias/mean/var`` become
  ``weight/bias/running_mean/running_var``, and ``resblock_i`` becomes
  ``resblocks.i``. The clipspm head's Conv1D kernel ``[3, in, out]`` becomes
  ``[out, in, 3]``, a Conv3d kernel ``[kt, kh, kw, in, out]`` becomes
  ``[out, in, kt, kh, kw]``. The ViT tower's patch kernel ``[p, p, 3, W]``
  becomes ``[W, 3, p, p]``; its ``class_embedding``,
  ``positional_embedding`` and ``proj`` carry across unchanged. The
  torchvision ResNet trunk takes
  torchvision's keys (the inverse of ``clipspm_tpu/models/backbones/
  resnet.py:convert_torchvision_resnet``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .models.backbones.clip import (AttentionPool2d, CLIPModel,
                                    VisionTransformer, _Attention)
from .models.heads.ta2n import ACM, TTM

StateDict = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# random initialisation
# ---------------------------------------------------------------------------

def _normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    t.copy_(torch.randn(t.shape, generator=gen) * std)


@torch.no_grad()
def random_init_(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Initialise ``model`` (on the CPU) in place from ``gen``: Linear/Conv
    weights ``N(0, 1/fan_in)`` and zero biases (flax's lecun-normal
    default), norms at identity with running stats (0, 1), embeddings and
    CLIP's extra parameters at the JAX package's scales (the ViT tower's
    class and positional embeddings and ``proj`` at ``width**-0.5 N(0,
    1)``), scalar gains at 1, cpm2c's class tokens at ``N(0, 1)``;
    TA2N's ``loc_fc2`` at a zero kernel and bias ``[2, 0]`` and ``mv_fc2``
    at zero, as the JAX package initialises them.
    """
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)):
            fan_in = mod.weight[0].numel()
            _normal_(mod.weight, fan_in ** -0.5, gen)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d, nn.BatchNorm3d)):
            mod.reset_parameters()
        elif isinstance(mod, nn.Embedding):
            _normal_(mod.weight, mod.weight.shape[1] ** -0.5, gen)
        elif isinstance(mod, _Attention):
            _normal_(mod.in_proj_weight, mod.in_proj_weight.shape[1] ** -0.5,
                     gen)
            mod.in_proj_bias.zero_()
        elif isinstance(mod, AttentionPool2d):
            pe = mod.positional_embedding
            _normal_(pe, pe.shape[1] ** -0.5, gen)
        elif isinstance(mod, VisionTransformer):
            scale = mod.class_embedding.shape[0] ** -0.5
            for p in (mod.class_embedding, mod.positional_embedding,
                      mod.proj):
                _normal_(p, scale, gen)
        if isinstance(mod, CLIPModel):
            _normal_(mod.positional_embedding, 0.01, gen)
            _normal_(mod.text_projection,
                     mod.arch.transformer_width ** -0.5, gen)
            mod.logit_scale.fill_(math.log(1 / 0.07))
    for mod in model.modules():
        if isinstance(mod, TTM):
            mod.loc_fc2.weight.zero_()
            mod.loc_fc2.bias.copy_(torch.tensor([2.0, 0.0]))
        elif isinstance(mod, ACM):
            mod.mv_fc2.weight.zero_()
            mod.mv_fc2.bias.zero_()
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.dim() == 0 and leaf in ("mo_alpha1", "scale"):
            p.fill_(1.0)
        elif leaf in ("class_token", "class_token_motion"):
            _normal_(p, 1.0, gen)
    return model


# ---------------------------------------------------------------------------
# JAX variables -> port state dict
# ---------------------------------------------------------------------------

def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(p: Mapping[str, Any], out: StateDict, key: str) -> None:
    out[f"{key}.weight"] = _t(p["kernel"]).T.contiguous()
    if "bias" in p:
        out[f"{key}.bias"] = _t(p["bias"])


def _conv2d(p: Mapping[str, Any], out: StateDict, key: str) -> None:
    out[f"{key}.weight"] = _t(p["kernel"]).permute(3, 2, 0, 1).contiguous()


def _norm(p: Mapping[str, Any], out: StateDict, key: str) -> None:
    out[f"{key}.weight"] = _t(p["scale"])
    out[f"{key}.bias"] = _t(p["bias"])


def _bn(p, stats, out: StateDict, key: str) -> None:
    _norm(p, out, key)
    out[f"{key}.running_mean"] = _t(stats["mean"])
    out[f"{key}.running_var"] = _t(stats["var"])
    out[f"{key}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def visual_state_dict(params: Mapping[str, Any], stats: Mapping[str, Any],
                      prefix: str = "") -> StateDict:
    """A JAX CLIP visual tree (``VisionTransformer`` or
    ``ModifiedResNet``, by its keys) -> OpenAI ``visual.*`` keys, without
    the ``visual.`` part (``prefix`` is prepended)."""
    if "class_embedding" in params:
        return vit_visual_state_dict(params, prefix)
    return resnet_visual_state_dict(params, stats, prefix)


def vit_visual_state_dict(params: Mapping[str, Any],
                          prefix: str = "") -> StateDict:
    """A JAX ``VisionTransformer`` tree -> OpenAI ``visual.*`` keys: the
    inverse of ``clipspm_tpu/models/backbones/torch_import.py:
    convert_clip_state_dict``'s ViT branch."""
    out: StateDict = {}
    _conv2d(params["conv1"], out, f"{prefix}conv1")
    for key in ("class_embedding", "positional_embedding", "proj"):
        out[f"{prefix}{key}"] = _t(params[key])
    for ln in ("ln_pre", "ln_post"):
        _norm(params[ln]["ln"], out, f"{prefix}{ln}")
    tr = params["transformer"]
    for i in range(len(tr)):
        _resblock(tr[f"resblock_{i}"], out,
                  f"{prefix}transformer.resblocks.{i}")
    return out


def resnet_visual_state_dict(params: Mapping[str, Any],
                             stats: Mapping[str, Any],
                             prefix: str = "") -> StateDict:
    """A JAX ``ModifiedResNet`` tree -> OpenAI ``visual.*`` keys (without
    the ``visual.`` part; ``prefix`` is prepended)."""
    out: StateDict = {}
    for i in (1, 2, 3):
        _conv2d(params[f"conv{i}"], out, f"{prefix}conv{i}")
        _bn(params[f"bn{i}"], stats[f"bn{i}"], out, f"{prefix}bn{i}")
    blocks = sorted((k for k in params if k.startswith("layer")),
                    key=lambda k: tuple(int(n) for n in k[5:].split("_")))
    for blk in blocks:
        stage, b = blk[5:].split("_")
        key = f"{prefix}layer{stage}.{b}"
        bp, bs = params[blk], stats[blk]
        for i in (1, 2, 3):
            _conv2d(bp[f"conv{i}"], out, f"{key}.conv{i}")
            _bn(bp[f"bn{i}"], bs[f"bn{i}"], out, f"{key}.bn{i}")
        if "down_conv" in bp:
            _conv2d(bp["down_conv"], out, f"{key}.downsample.0")
            _bn(bp["down_bn"], bs["down_bn"], out, f"{key}.downsample.1")
    pool = params["attnpool"]
    out[f"{prefix}attnpool.positional_embedding"] = _t(
        pool["positional_embedding"])
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _dense(pool[proj], out, f"{prefix}attnpool.{proj}")
    return out


def torchvision_resnet_state_dict(params: Mapping[str, Any],
                                  stats: Mapping[str, Any],
                                  prefix: str = "") -> StateDict:
    """A JAX ``TorchResNet`` tree -> torchvision keys (``conv1``, ``bn1``,
    ``layerS.B.convI``, ``layerS.B.downsample.0/1``), ``prefix``
    prepended."""
    out: StateDict = {}
    _conv2d(params["conv1"], out, f"{prefix}conv1")
    _bn(params["bn1"], stats["bn1"], out, f"{prefix}bn1")
    for blk in (k for k in params if k.startswith("layer")):
        stage, b = blk[5:].split("_")
        key = f"{prefix}layer{stage}.{b}"
        bp, bs = params[blk], stats[blk]
        for name in bp:
            if name.startswith("conv"):
                _conv2d(bp[name], out, f"{key}.{name}")
            elif name.startswith("bn"):
                _bn(bp[name], bs[name], out, f"{key}.{name}")
        if "down_conv" in bp:
            _conv2d(bp["down_conv"], out, f"{key}.downsample.0")
            _bn(bp["down_bn"], bs["down_bn"], out, f"{key}.downsample.1")
    return out


def _resblock(p: Mapping[str, Any], out: StateDict, key: str) -> None:
    _norm(p["ln_1"]["ln"], out, f"{key}.ln_1")
    _norm(p["ln_2"]["ln"], out, f"{key}.ln_2")
    out[f"{key}.attn.in_proj_weight"] = _t(p["in_proj"]["kernel"]).T.contiguous()
    out[f"{key}.attn.in_proj_bias"] = _t(p["in_proj"]["bias"])
    _dense(p["out_proj"], out, f"{key}.attn.out_proj")
    _dense(p["c_fc"], out, f"{key}.mlp.c_fc")
    _dense(p["c_proj"], out, f"{key}.mlp.c_proj")


def clip_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """JAX ``CLIPModel`` variables -> an OpenAI-keyed state dict for
    ``models.backbones.clip.CLIPModel``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out = visual_state_dict(params["visual"], stats.get("visual", {}),
                            prefix="visual.")
    tr = params["transformer"]
    for i in range(len(tr)):
        _resblock(tr[f"resblock_{i}"], out, f"transformer.resblocks.{i}")
    out["token_embedding.weight"] = _t(params["token_embedding"]["embedding"])
    out["positional_embedding"] = _t(params["positional_embedding"])
    _norm(params["ln_final"]["ln"], out, "ln_final")
    out["text_projection"] = _t(params["text_projection"])
    out["logit_scale"] = _t(params["logit_scale"])
    return out


def head_state_dict(params: Mapping[str, Any], prefix: str = "",
                    stats: Optional[Mapping[str, Any]] = None) -> StateDict:
    """A JAX head tree -> the port's head keys. Names map one to one (path
    joined by dots); Dense, Conv1D and Conv3d kernels are transposed; a
    norm with ``batch_stats`` (from ``stats``, the same tree shape) is a
    BatchNorm, one without is a LayerNorm (``scale`` becomes ``weight``)."""
    out: StateDict = {}

    def walk(node: Mapping[str, Any], st: Mapping[str, Any],
             path: str) -> None:
        for name, v in node.items():
            key = f"{path}{name}"
            if not isinstance(v, Mapping):
                out[key] = _t(v)
            elif "kernel" in v:
                k = _t(v["kernel"])
                perm = {2: (1, 0), 3: (2, 1, 0), 5: (4, 3, 0, 1, 2)}[k.dim()]
                out[f"{key}.weight"] = k.permute(*perm).contiguous()
                if "bias" in v:
                    out[f"{key}.bias"] = _t(v["bias"])
            elif "scale" in v:
                if name in st:
                    _bn(v, st[name], out, key)
                else:
                    _norm(v, out, key)
            else:
                walk(v, st.get(name, {}), f"{key}.")

    walk(params, stats or {}, prefix)
    return out


def ta2n_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """JAX ``TA2NModel`` variables -> ``models.heads.ta2n.TA2NModel`` state
    dict (``backbone.*`` in torchvision's keys, the rest by name)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out = torchvision_resnet_state_dict(params["backbone"], stats["backbone"],
                                        prefix="backbone.")
    rest = {k: v for k, v in params.items() if k != "backbone"}
    out.update(head_state_dict(rest, stats=stats))
    return out


def model_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """JAX model variables -> the port's state dict, by the model the tree
    is of: ``TA2NModel`` (``backbone`` + ``ttm`` + ``acm``), or a CLIP
    model: ``backbone`` (the CLIP tower) plus ``head`` (``CLIPSPMModel``)
    or the head's own top-level parameters (clipfsar, sten, cpm2c)."""
    params = variables["params"]
    if "ttm" in params:
        return ta2n_state_dict(variables)
    if "backbone" not in params:
        raise NotImplementedError(
            f"no port of a model with parameters {sorted(params)}; the port "
            "carries clipspm, clipfsar, sten, cpm2c and ta2n")
    stats = variables.get("batch_stats", {})
    out = visual_state_dict(params["backbone"], stats.get("backbone", {}),
                            prefix="backbone.")
    if "head" in params:
        out.update(head_state_dict(params["head"], prefix="head."))
    else:
        out.update(head_state_dict(
            {k: v for k, v in params.items() if k != "backbone"}))
    return out
