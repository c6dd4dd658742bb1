"""Plain CLIP towers: the ModifiedResNet and ViT vision towers and the
causal text transformer of OpenAI CLIP (github.com/openai/CLIP,
``clip/model.py``), written as functions of an OpenAI-keyed state dict
(``visual.layer1.0.conv1.weight``, ``transformer.resblocks.0.attn.
in_proj_weight`` ...).

Everything runs in float32 (the caller turns TF32 off). ``prec`` rounds the
operands of every convolution and matrix product: the identity for the
reference, a coarser format for the control (``precision.py``). BatchNorm
uses its running statistics in evaluation and the batch's (biased) ones in
training; the running statistics are not updated, as nothing here reads
them after a training forward.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]
Prec = Callable[[torch.Tensor], torch.Tensor]


def _ident(x: torch.Tensor) -> torch.Tensor:
    return x


def conv2d(x, w, prec: Prec, stride: int = 1, padding: int = 0):
    return F.conv2d(prec(x), prec(w), stride=stride, padding=padding)


def linear(x, w, b, prec: Prec):
    y = torch.matmul(prec(x), prec(w).t())
    return y if b is None else y + b


def batch_norm(x, P: Params, key: str, train: bool):
    if train:
        return F.batch_norm(x, None, None, P[f"{key}.weight"],
                            P[f"{key}.bias"], True, 0.0, 1e-5)
    return F.batch_norm(x, P[f"{key}.running_mean"], P[f"{key}.running_var"],
                        P[f"{key}.weight"], P[f"{key}.bias"], False, 0.0,
                        1e-5)


def layer_norm(x, P: Params, key: str):
    return F.layer_norm(x, x.shape[-1:], P[f"{key}.weight"], P[f"{key}.bias"],
                        1e-5)


# ---------------------------------------------------------------------------
# ModifiedResNet
# ---------------------------------------------------------------------------

def _bottleneck(x, P: Params, key: str, stride: int, train: bool,
                prec: Prec):
    h = F.relu(batch_norm(conv2d(x, P[f"{key}.conv1.weight"], prec),
                          P, f"{key}.bn1", train))
    h = F.relu(batch_norm(conv2d(h, P[f"{key}.conv2.weight"], prec,
                                 padding=1), P, f"{key}.bn2", train))
    if stride > 1:
        h = F.avg_pool2d(h, stride)
    h = batch_norm(conv2d(h, P[f"{key}.conv3.weight"], prec), P,
                   f"{key}.bn3", train)
    identity = x
    if f"{key}.downsample.0.weight" in P:
        if stride > 1:
            identity = F.avg_pool2d(identity, stride)
        identity = batch_norm(conv2d(identity, P[f"{key}.downsample.0.weight"],
                                     prec), P, f"{key}.downsample.1", train)
    return F.relu(h + identity)


def _stem(x, P: Params, train: bool, prec: Prec):
    x = F.relu(batch_norm(conv2d(x, P["visual.conv1.weight"], prec, 2, 1),
                          P, "visual.bn1", train))
    x = F.relu(batch_norm(conv2d(x, P["visual.conv2.weight"], prec,
                                 padding=1), P, "visual.bn2", train))
    x = F.relu(batch_norm(conv2d(x, P["visual.conv3.weight"], prec,
                                 padding=1), P, "visual.bn3", train))
    return F.avg_pool2d(x, 2)


def _attnpool(x, P: Params, heads: int, prec: Prec):
    N, C, H, W = x.shape
    key = "visual.attnpool"
    t = x.flatten(2).transpose(1, 2)
    t = torch.cat([t.mean(dim=1, keepdim=True), t], dim=1)
    t = t + P[f"{key}.positional_embedding"][None]
    hd = C // heads

    def split(u):
        return u.reshape(N, u.shape[1], heads, hd).transpose(1, 2)

    q = split(linear(t[:, :1], P[f"{key}.q_proj.weight"],
                     P[f"{key}.q_proj.bias"], prec))
    k = split(linear(t, P[f"{key}.k_proj.weight"], P[f"{key}.k_proj.bias"],
                     prec))
    v = split(linear(t, P[f"{key}.v_proj.weight"], P[f"{key}.v_proj.bias"],
                     prec))
    a = torch.softmax(torch.matmul(prec(q), prec(k).transpose(-1, -2))
                      * hd ** -0.5, dim=-1)
    out = torch.matmul(prec(a), prec(v)).transpose(1, 2).reshape(N, 1, C)
    return linear(out, P[f"{key}.c_proj.weight"], P[f"{key}.c_proj.bias"],
                  prec)[:, 0]


def modified_resnet(x, P: Params, layers: Sequence[int], heads: int,
                    train: bool = False, prec: Prec = _ident,
                    remat: bool = False):
    """``x``: ``[N, H, W, 3]`` float frames -> ``[N, embed]``. ``remat``
    recomputes each block in the backward (memory only: the same
    arithmetic, and no running statistics to update twice)."""

    def run(fn, *args):
        if remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    x = run(lambda u: _stem(u, P, train, prec), x.permute(0, 3, 1, 2))
    for stage, blocks in enumerate(layers):
        for b in range(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            key = f"visual.layer{stage + 1}.{b}"
            x = run(lambda u, key=key, stride=stride:
                    _bottleneck(u, P, key, stride, train, prec), x)
    return _attnpool(x, P, heads, prec)


# ---------------------------------------------------------------------------
# Transformers
# ---------------------------------------------------------------------------

def _block(x, P: Params, key: str, heads: int, causal: bool, prec: Prec):
    B, L, D = x.shape
    hd = D // heads
    h = layer_norm(x, P, f"{key}.ln_1")
    qkv = linear(h, P[f"{key}.attn.in_proj_weight"],
                 P[f"{key}.attn.in_proj_bias"], prec)
    q, k, v = (t.reshape(B, L, heads, hd).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    s = torch.matmul(prec(q), prec(k).transpose(-1, -2)) * hd ** -0.5
    if causal:
        mask = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    a = torch.softmax(s, dim=-1)
    o = torch.matmul(prec(a), prec(v)).transpose(1, 2).reshape(B, L, D)
    x = x + linear(o, P[f"{key}.attn.out_proj.weight"],
                   P[f"{key}.attn.out_proj.bias"], prec)
    h = layer_norm(x, P, f"{key}.ln_2")
    h = linear(h, P[f"{key}.mlp.c_fc.weight"], P[f"{key}.mlp.c_fc.bias"],
               prec)
    h = h * torch.sigmoid(1.702 * h)
    return x + linear(h, P[f"{key}.mlp.c_proj.weight"],
                      P[f"{key}.mlp.c_proj.bias"], prec)


def vision_transformer(x, P: Params, layers: int, heads: int,
                       prec: Prec = _ident, remat: bool = False):
    """``x``: ``[N, H, W, 3]`` -> ``[N, embed]``."""
    x = conv2d(x.permute(0, 3, 1, 2), P["visual.conv1.weight"], prec,
               stride=P["visual.conv1.weight"].shape[-1])
    N, C = x.shape[:2]
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([P["visual.class_embedding"].expand(N, 1, C), x], dim=1)
    x = layer_norm(x + P["visual.positional_embedding"][None], P,
                   "visual.ln_pre")
    for i in range(layers):
        key = f"visual.transformer.resblocks.{i}"
        if remat:
            x = checkpoint(lambda u, key=key: _block(u, P, key, heads, False,
                                                     prec),
                           x, use_reentrant=False)
        else:
            x = _block(x, P, key, heads, False, prec)
    x = layer_norm(x[:, 0], P, "visual.ln_post")
    return torch.matmul(prec(x), prec(P["visual.proj"]))


def encode_text(tokens: torch.Tensor, P: Params, layers: int, heads: int,
                prec: Prec = _ident) -> torch.Tensor:
    """``[B, context]`` int tokens -> ``[B, embed]``, pooled at the end
    token (the highest id of each row)."""
    x = P["token_embedding.weight"][tokens.long()]
    x = x + P["positional_embedding"][None, : x.shape[1]]
    for i in range(layers):
        x = _block(x, P, f"transformer.resblocks.{i}", heads, True, prec)
    x = layer_norm(x, P, "ln_final")
    pooled = x[torch.arange(x.shape[0], device=x.device),
               tokens.argmax(dim=-1)]
    return torch.matmul(prec(pooled), prec(P["text_projection"]))


def visual(x, P: Params, arch: dict, train: bool = False, prec: Prec = _ident,
           remat: bool = False):
    """The vision tower of ``arch`` (a config's ``published`` block)."""
    if arch["vision"] == "vit":
        return vision_transformer(x, P, arch["vision_layers"],
                                  arch["vision_width"] // 64, prec, remat)
    return modified_resnet(x, P, arch["vision_layers"],
                           arch["vision_width"] * 32 // 64, train, prec,
                           remat)


# ---------------------------------------------------------------------------
# Parameter layout (OpenAI keys) and the initial distributions
# ---------------------------------------------------------------------------

# (name, shape, kind, std): kind "normal" draws N(0, std), "zeros", "ones"
Spec = Tuple[str, Tuple[int, ...], str, float]


def _lin(out: list, key: str, cin: int, cout: int, bias: bool = True):
    out.append((f"{key}.weight", (cout, cin), "normal", cin ** -0.5))
    if bias:
        out.append((f"{key}.bias", (cout,), "zeros", 0.0))


def _conv(out: list, key: str, cin: int, cout: int, k: int):
    out.append((f"{key}.weight", (cout, cin, k, k), "normal",
                (cin * k * k) ** -0.5))


def _norm(out: list, key: str, c: int, bn: bool = False):
    out.append((f"{key}.weight", (c,), "ones", 0.0))
    out.append((f"{key}.bias", (c,), "zeros", 0.0))
    if bn:
        out.append((f"{key}.running_mean", (c,), "zeros", 0.0))
        out.append((f"{key}.running_var", (c,), "ones", 0.0))
        out.append((f"{key}.num_batches_tracked", (), "count", 0.0))


def _resblock(out: list, key: str, d: int):
    out.append((f"{key}.attn.in_proj_weight", (3 * d, d), "normal",
                d ** -0.5))
    out.append((f"{key}.attn.in_proj_bias", (3 * d,), "zeros", 0.0))
    _lin(out, f"{key}.attn.out_proj", d, d)
    _norm(out, f"{key}.ln_1", d)
    _lin(out, f"{key}.mlp.c_fc", d, 4 * d)
    _lin(out, f"{key}.mlp.c_proj", 4 * d, d)
    _norm(out, f"{key}.ln_2", d)


def visual_specs(arch: dict) -> list:
    """The vision tower's OpenAI keys, shapes and initial distributions
    (lecun-normal kernels, norms at identity, CLIP's embedding scales)."""
    out: list = []
    w, embed, res = arch["vision_width"], arch["embed_dim"], arch["image"]
    if arch["vision"] == "vit":
        p = arch["patch"]
        grid = res // p
        _conv(out, "visual.conv1", 3, w, p)
        out.append(("visual.class_embedding", (w,), "normal", w ** -0.5))
        out.append(("visual.positional_embedding", (grid * grid + 1, w),
                    "normal", w ** -0.5))
        _norm(out, "visual.ln_pre", w)
        for i in range(arch["vision_layers"]):
            _resblock(out, f"visual.transformer.resblocks.{i}", w)
        _norm(out, "visual.ln_post", w)
        out.append(("visual.proj", (w, embed), "normal", w ** -0.5))
        return out
    _conv(out, "visual.conv1", 3, w // 2, 3)
    _norm(out, "visual.bn1", w // 2, bn=True)
    _conv(out, "visual.conv2", w // 2, w // 2, 3)
    _norm(out, "visual.bn2", w // 2, bn=True)
    _conv(out, "visual.conv3", w // 2, w, 3)
    _norm(out, "visual.bn3", w, bn=True)
    inplanes = w
    for stage, blocks in enumerate(arch["vision_layers"]):
        planes = w * 2 ** stage
        for b in range(blocks):
            key = f"visual.layer{stage + 1}.{b}"
            _conv(out, f"{key}.conv1", inplanes, planes, 1)
            _norm(out, f"{key}.bn1", planes, bn=True)
            _conv(out, f"{key}.conv2", planes, planes, 3)
            _norm(out, f"{key}.bn2", planes, bn=True)
            _conv(out, f"{key}.conv3", planes, planes * 4, 1)
            _norm(out, f"{key}.bn3", planes * 4, bn=True)
            stride = 2 if (stage > 0 and b == 0) else 1
            if stride > 1 or inplanes != planes * 4:
                _conv(out, f"{key}.downsample.0", inplanes, planes * 4, 1)
                _norm(out, f"{key}.downsample.1", planes * 4, bn=True)
            inplanes = planes * 4
    c = w * 32
    spacial = res // 32
    out.append(("visual.attnpool.positional_embedding",
                (spacial * spacial + 1, c), "normal", c ** -0.5))
    for name in ("k_proj", "q_proj", "v_proj"):
        _lin(out, f"visual.attnpool.{name}", c, c)
    _lin(out, "visual.attnpool.c_proj", c, embed)
    return out


def text_specs(arch: dict) -> list:
    """The text tower's OpenAI keys, shapes and initial distributions."""
    out: list = []
    d, embed = arch["text_width"], arch["embed_dim"]
    out.append(("token_embedding.weight", (arch["vocab_size"], d), "normal",
                d ** -0.5))
    out.append(("positional_embedding", (arch["context_length"], d),
                "normal", 0.01))
    for i in range(arch["text_layers"]):
        _resblock(out, f"transformer.resblocks.{i}", d)
    _norm(out, "ln_final", d)
    out.append(("text_projection", (d, embed), "normal", d ** -0.5))
    out.append(("logit_scale", (), "log_inv_temp", 0.0))
    return out
