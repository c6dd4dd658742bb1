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
  ``[out, in, kt, kh, kw]``; a head's Conv2d kernel ``[kh, kw, in, out]``
  becomes ``[out, in, kh, kw]`` too. The ViT tower's patch kernel ``[p, p, 3, W]``
  becomes ``[W, 3, p, p]``; its ``class_embedding``,
  ``positional_embedding`` and ``proj`` carry across unchanged. The
  torchvision ResNet trunk takes
  torchvision's keys (the inverse of ``clipspm_tpu/models/backbones/
  resnet.py:convert_torchvision_resnet``); its temporal blocks (``blk``,
  ``bn4``, ``blk_1``, ``blk_2``) keep their JAX names. A CLIP transformer
  outside a tower (cpm2c's video adapter) takes the tower's block keys, an
  ``Embed`` table becomes an embedding's ``weight``. flax creates a
  module's parameters where it is first called, so a tree may lack a
  switch's leaves (cpm2c's prompts, its adapter): the port's model holds
  exactly the tree's, and a strict ``load_state_dict`` refuses a tree that
  does not match its flags.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .models.backbones.clip import (AttentionPool2d, CLIPModel,
                                    FP32LayerNorm, ModifiedResNet,
                                    TransformerStack, VisionTransformer,
                                    _Attention)
from .models.backbones.resnet import TorchResNet
from .models.blocks_extra import GroupGLKA, Mo1, _MotionToken
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
    1)``), scalar gains at 1 (molo's ``scale_motion`` too), cpm2c's and
    molo's class tokens at ``N(0, 1)``; TA2N's ``loc_fc2`` at a zero kernel
    and bias ``[2, 0]`` and ``mv_fc2`` at zero, otam's token bank ``mo``
    xavier-normal, strm's ``gamma`` at 0 and soap's ``lmd`` at 0.5, the
    dormant blocks' motion tokens at U[0, 1) and ``GroupGLKA``'s ``scale``
    at 0, as the JAX package initialises them.
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
        elif isinstance(mod, GroupGLKA):
            mod.scale.zero_()
    uniform = {id(m.mo) for m in model.modules()
               if isinstance(m, (Mo1, _MotionToken))}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.dim() == 0 and leaf in ("mo_alpha1", "scale", "scale_motion"):
            p.fill_(1.0)
        elif p.dim() == 0 and leaf == "lmd":
            p.fill_(0.5)
        elif leaf == "gamma":
            p.zero_()
        elif leaf in ("class_token", "class_token_motion"):
            _normal_(p, 1.0, gen)
        elif id(p) in uniform:
            p.copy_(torch.rand(p.shape, generator=gen))
        elif leaf == "mo" and p.dim() == 3:
            # xavier-normal over (fan_in, fan_out) = the last two axes
            _normal_(p, (2.0 / (p.shape[-2] + p.shape[-1])) ** 0.5, gen)
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
    for blk in (k for k in params if k.startswith("blk_")):
        out.update(head_state_dict(params[blk], f"{prefix}{blk}.",
                                   stats[blk]))
    for blk in (k for k in params if k.startswith("layer")):
        stage, b = blk[5:].split("_")
        key = f"{prefix}layer{stage}.{b}"
        bp, bs = params[blk], stats[blk]
        for name in bp:
            if name.startswith("conv"):
                _conv2d(bp[name], out, f"{key}.{name}")
            elif name.startswith("bn"):
                _bn(bp[name], bs[name], out, f"{key}.{name}")
            elif name == "blk":
                out.update(head_state_dict(bp[name], f"{key}.blk.",
                                           bs[name]))
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
    joined by dots); Dense, Conv1D, Conv2d and Conv3d kernels are
    transposed; a
    norm with ``batch_stats`` (from ``stats``, the same tree shape) is a
    BatchNorm, one without is a LayerNorm (``scale`` becomes ``weight``);
    an ``Embed``'s ``embedding`` is the ``weight``; a CLIP
    ``TransformerStack`` (``resblock_i``) takes the tower's block keys."""
    out: StateDict = {}

    def walk(node: Mapping[str, Any], st: Mapping[str, Any],
             path: str) -> None:
        for name, v in node.items():
            key = f"{path}{name}"
            if not isinstance(v, Mapping):
                out[key] = _t(v)
            elif "kernel" in v:
                k = _t(v["kernel"])
                perm = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1),
                        5: (4, 3, 0, 1, 2)}[k.dim()]
                out[f"{key}.weight"] = k.permute(*perm).contiguous()
                if "bias" in v:
                    out[f"{key}.bias"] = _t(v["bias"])
            elif "scale" in v:
                if name in st:
                    _bn(v, st[name], out, key)
                else:
                    _norm(v, out, key)
            elif "embedding" in v:
                out[f"{key}.weight"] = _t(v["embedding"])
            elif "resblock_0" in v:
                for i in range(len(v)):
                    _resblock(v[f"resblock_{i}"], out,
                              f"{key}.resblocks.{i}")
            else:
                walk(v, st.get(name, {}), f"{key}.")

    walk(params, stats or {}, prefix)
    return out


def resnet_model_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """JAX variables of a head on the torchvision ResNet trunk (ta2n, otam,
    trx, strm, soap, molo) -> the port's state dict (``backbone.*`` in
    torchvision's keys, the rest by name, BatchNorm statistics included)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out = torchvision_resnet_state_dict(params["backbone"], stats["backbone"],
                                        prefix="backbone.")
    rest = {k: v for k, v in params.items() if k != "backbone"}
    out.update(head_state_dict(rest, stats=stats))
    return out


def model_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """JAX model variables -> the port's state dict, by the model the tree
    is of: a torchvision ResNet trunk (``backbone`` with ``bn1`` and no
    attention pool) and its head, or a CLIP model: ``backbone`` (the CLIP
    tower) plus ``head`` (``CLIPSPMModel``) or the head's own top-level
    parameters (clipfsar, sten, cpm2c)."""
    params = variables["params"]
    if "backbone" not in params:
        raise NotImplementedError(
            f"no port of a model with parameters {sorted(params)}; the port "
            "carries every head of the JAX package")
    trunk = params["backbone"]
    if "bn1" in trunk and "attnpool" not in trunk:
        return resnet_model_state_dict(variables)
    stats = variables.get("batch_stats", {})
    out = visual_state_dict(trunk, stats.get("backbone", {}),
                            prefix="backbone.")
    if "head" in params:
        out.update(head_state_dict(params["head"], prefix="head."))
    else:
        out.update(head_state_dict(
            {k: v for k, v in params.items() if k != "backbone"}))
    return out


# ---------------------------------------------------------------------------
# port parameter name -> JAX path (the inverse of the maps above)
# ---------------------------------------------------------------------------

# the port's containers inside a trunk that the JAX paths do not have
_DROPPED = ("attn", "mlp")
_DOWNSAMPLE = {"0": "down_conv", "1": "down_bn"}


def _trunk_segments(parts) -> list:
    """The JAX segments of a port module path inside a trunk (a CLIP tower,
    the text transformer, the torchvision ResNet): ``resblocks.i`` ->
    ``resblock_i``, ``layerS.B`` -> ``layerS_B``, ``downsample.0/1`` ->
    ``down_conv/down_bn``, the ``attn``/``mlp`` containers dropped."""
    out, i = [], 0
    while i < len(parts):
        p = parts[i]
        if p == "resblocks":
            out.append(f"resblock_{parts[i + 1]}")
            i += 2
        elif p.startswith("layer") and p[5:].isdigit() and \
                i + 1 < len(parts):
            out.append(f"{p}_{parts[i + 1]}")
            i += 2
        elif p == "downsample":
            out.append(_DOWNSAMPLE[parts[i + 1]])
            i += 2
        else:
            if p not in _DROPPED:
                out.append(p)
            i += 1
    return out


def jax_paths(model: nn.Module) -> Dict[str, Tuple[str, ...]]:
    """Each parameter name of a port model -> the path of the JAX parameter
    it is carried from (the inverse of :func:`model_state_dict`,
    :func:`clip_state_dict` and the head maps): a Linear's or a
    convolution's ``weight`` is ``kernel``, a norm's ``scale`` (a CLIP
    LayerNorm's ``ln/scale``), an embedding's ``embedding``; the trunks'
    containers as :func:`_trunk_segments` names them; a head's path is its
    own, one to one."""
    roots = tuple(name for name, mod in model.named_modules()
                  if isinstance(mod, (CLIPModel, VisionTransformer,
                                      ModifiedResNet, TorchResNet,
                                      TransformerStack)))
    out: Dict[str, Tuple[str, ...]] = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        owner = model.get_submodule(".".join(parts[:-1]))
        leaf = parts[-1]
        in_trunk = any(name.startswith(f"{r}.") or r == "" for r in roots)
        mods = _trunk_segments(parts[:-1]) if in_trunk else parts[:-1]
        if leaf in ("in_proj_weight", "in_proj_bias"):
            tail = ["in_proj", "kernel" if leaf.endswith("weight")
                    else "bias"]
        elif isinstance(owner, FP32LayerNorm) and in_trunk:
            tail = ["ln", "scale" if leaf == "weight" else leaf]
        elif isinstance(owner, (nn.LayerNorm, nn.modules.batchnorm._NormBase,
                                nn.GroupNorm)):
            tail = ["scale" if leaf == "weight" else leaf]
        elif isinstance(owner, nn.Embedding):
            tail = ["embedding"]
        elif leaf == "weight":
            tail = ["kernel"]
        else:
            tail = [leaf]
        out[name] = tuple(mods + tail)
    return out
