"""CLIP backbones in PyTorch: the RN50-family ModifiedResNet and the
ViT visual towers, and the causal text transformer.

Port of ``clipspm_tpu/models/backbones/clip.py``. Modules and parameters
carry OpenAI's state-dict key names (``visual.layer1.0.conv1.weight``,
``transformer.resblocks.0.attn.in_proj_weight`` ...), so an OpenAI ``.pt``
loads straight into them. Frames are NHWC ``[N, H, W, 3]`` at the public
functions and NCHW only inside the tower (the permuted view keeps NHWC
strides, which cuDNN runs as channels-last). LayerNorm and BatchNorm compute
in fp32 whatever the compute dtype, or in it with ``bf16_norms``. The vision
transformer's attention is one ``scaled_dot_product_attention`` call (on the
card a fused flash or memory-efficient kernel; the JAX package has no
attention kernel, XLA fuses its einsums), spelled out as in the JAX package
where a switch needs its probabilities (``fast_softmax``, the ``attn`` remat
policy: ``ops/tags.py``); the text tower's causal attention is spelled out.
The vision tower's switches (``CLIPArch``) are the JAX package's; the text
tower takes none, as there. Both vision towers are ``GraphedTower`` s
(``models/tower_graph.py``): in evaluation on the card a call replays a
CUDA graph of ``tower_forward``, the eager body.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import tags
from ...ops.quant import int8_linear
from ...utils.precision import fp32_or_wider
from ..tower_graph import GraphedTower


@dataclasses.dataclass(frozen=True)
class CLIPArch:
    """Architecture hyperparameters, as inferred from checkpoint shapes."""
    embed_dim: int
    image_resolution: int
    vision_layers: Union[Tuple[int, int, int, int], int]
    vision_width: int
    vision_patch_size: Optional[int]
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12
    # the vision tower's switches (MODEL.FAST_SOFTMAX, MODEL.BF16_NORMS,
    # MODEL.INT8_EVAL): the max-shifted softmax in the compute dtype; the
    # norms in the compute dtype; the ViT blocks' four projections in
    # dynamic int8 outside training (ops/quant.py). Parameters and their
    # names are the same either way.
    fast_softmax: bool = False
    bf16_norms: bool = False
    int8_eval: bool = False

    @property
    def is_vit(self) -> bool:
        return isinstance(self.vision_layers, int)

    @property
    def vision_heads(self) -> int:
        if self.is_vit:
            return self.vision_width // 64
        return self.vision_width * 32 // 64


CLIP_ARCHS = {
    "RN50": CLIPArch(1024, 224, (3, 4, 6, 3), 64, None),
    "RN101": CLIPArch(512, 224, (3, 4, 23, 3), 64, None),
    "RN50x4": CLIPArch(640, 288, (4, 6, 10, 6), 80, None,
                       transformer_width=640, transformer_heads=10),
    "RN50x16": CLIPArch(768, 384, (6, 8, 18, 8), 96, None,
                        transformer_width=768, transformer_heads=12),
    "RN50x64": CLIPArch(1024, 448, (3, 15, 36, 10), 128, None,
                        transformer_width=1024, transformer_heads=16),
    "ViT-B/32": CLIPArch(512, 224, 12, 768, 32),
    "ViT-B/16": CLIPArch(512, 224, 12, 768, 16),
    "ViT-L/14": CLIPArch(768, 224, 24, 1024, 14, transformer_width=768,
                         transformer_heads=12),
    "ViT-L/14@336px": CLIPArch(768, 336, 24, 1024, 14, transformer_width=768,
                               transformer_heads=12),
    # tiny configs for the CPU tests
    "test-tiny": CLIPArch(32, 32, 2, 64, 8, context_length=16, vocab_size=600,
                          transformer_width=32, transformer_heads=2,
                          transformer_layers=2),
    "test-tiny-rn": CLIPArch(64, 32, (1, 1, 1, 1), 8, None, context_length=16,
                             vocab_size=600, transformer_width=32,
                             transformer_heads=2, transformer_layers=2),
}


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class FP32LayerNorm(nn.LayerNorm):
    """LayerNorm computed in fp32 and cast back to the input dtype; with
    ``fp32=False`` (``MODEL.BF16_NORMS``) computed in the input dtype, the
    fp32 parameters cast to it at use and autocast off (torch's bf16
    LayerNorm sums its statistics in fp32, as flax's does)."""

    def __init__(self, *args, fp32: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.fp32 = fp32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fp32:
            return super().forward(fp32_or_wider(x)).to(x.dtype)
        with torch.autocast(x.device.type, enabled=False):
            return F.layer_norm(x, self.normalized_shape,
                                self.weight.to(x.dtype),
                                self.bias.to(x.dtype), self.eps)


class FP32BatchNorm:
    """BatchNorm computed in fp32 (its output stays fp32; fp64 stays fp64),
    mixed into ``nn.BatchNorm2d`` and ``nn.BatchNorm3d``. With ``fp32=False``
    (``MODEL.BF16_NORMS``) the input keeps its dtype and so does the output,
    the statistics and parameters fp32 (flax's ``BatchNorm(dtype=bf16)``).

    In train mode the running variance takes the *biased* batch variance,
    as flax's ``nn.BatchNorm`` does (momentum 0.9 there is 0.1 here), over
    ``n`` = every element of a channel (``N*H*W``, ``N*T*H*W``). torch's
    BatchNorm folds in the unbiased one, ``n / (n - 1)`` times larger. So
    the op updates a copy of the ``[C]`` buffer (the copy is what its
    backward keeps), and the buffer takes the corrected value: the batch
    statistics stay one fused pass."""

    def __init__(self, *args, fp32: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.fp32 = fp32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fp32:
            x = fp32_or_wider(x)
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        n = x.numel() // x.shape[1]
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                         True, self.momentum, self.eps)
        with torch.no_grad():
            # var = (1 - m) old + m s2 n/(n-1); the biased update is
            # var - m s2 / (n - 1) = var - (var - (1 - m) old) / n
            self.running_var.copy_(
                var - (var - (1.0 - self.momentum) * self.running_var) / n)
        return y


class FP32BatchNorm2d(FP32BatchNorm, nn.BatchNorm2d):
    """BatchNorm over ``[N, C, H, W]`` (:class:`FP32BatchNorm`)."""


class FP32BatchNorm3d(FP32BatchNorm, nn.BatchNorm3d):
    """BatchNorm over ``[N, C, T, H, W]`` (:class:`FP32BatchNorm`), the
    running variance biased over ``N*T*H*W``."""


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


# ---------------------------------------------------------------------------
# ModifiedResNet visual tower
# ---------------------------------------------------------------------------

class Bottleneck(nn.Module):
    """CLIP anti-aliased bottleneck: every conv has stride 1; an avgpool does
    the downsampling after conv2, and before the downsample conv on the
    identity path."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 fp32_norms: bool = True):
        super().__init__()
        out_ch = planes * self.expansion
        bn = functools.partial(FP32BatchNorm2d, fp32=fp32_norms)
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = bn(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = bn(planes)
        self.avgpool = nn.AvgPool2d(stride) if stride > 1 else nn.Identity()
        self.conv3 = _conv(planes, out_ch, 1)
        self.bn3 = bn(out_ch)
        self.downsample = None
        if stride > 1 or inplanes != out_ch:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride) if stride > 1 else nn.Identity()),
                ("0", _conv(inplanes, out_ch, 1)),
                ("1", bn(out_ch))]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(self.avgpool(h)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class AttentionPool2d(nn.Module):
    """Multi-head attention pooling: the mean token is prepended, the
    positional embedding added, and token 0 alone queries (``spatial=False``).
    ``tp`` (``parallel/tensor.py:TPContext``, set by ``shard_model_``):
    ``c_proj`` is row-parallel over the attention output's features, which
    every tp rank computes whole."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.tp = None
        self.positional_embedding = nn.Parameter(
            torch.zeros(spacial_dim ** 2 + 1, embed_dim))
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, C, H, W = x.shape
        tokens = x.flatten(2).transpose(1, 2)                 # [N, HW, C]
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding[None].to(tokens.dtype)
        hd = C // self.num_heads

        def split(t):
            return t.reshape(N, t.shape[1], self.num_heads, hd).transpose(1, 2)

        q = split(self.q_proj(tokens[:, :1]))
        k, v = split(self.k_proj(tokens)), split(self.v_proj(tokens))
        attn = fp32_or_wider(torch.matmul(q, k.transpose(-1, -2))) * hd ** -0.5
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(N, 1, C)
        if self.tp is None:
            return self.c_proj(out)[:, 0]
        width = C // self.tp.world
        out = self.tp.copy_to(out)[..., self.tp.rank * width:
                                   (self.tp.rank + 1) * width]
        return _row_dense(out, self.c_proj.weight, self.c_proj.bias, False,
                          self.tp)[:, 0]


class ModifiedResNet(GraphedTower):
    """3-conv stem + avgpool + 4 stages + attention pooling."""

    graph_switches = ("fp32", "affine", "track_running_stats", "ceil_mode",
                      "count_include_pad", "transposed")

    def __init__(self, layers: Tuple[int, int, int, int], output_dim: int,
                 heads: int, input_resolution: int = 224, width: int = 64,
                 fp32_norms: bool = True):
        super().__init__()
        w = width
        bn = functools.partial(FP32BatchNorm2d, fp32=fp32_norms)
        self.conv1 = _conv(3, w // 2, 3, stride=2)
        self.bn1 = bn(w // 2)
        self.conv2 = _conv(w // 2, w // 2, 3)
        self.bn2 = bn(w // 2)
        self.conv3 = _conv(w // 2, w, 3)
        self.bn3 = bn(w)
        self.avgpool = nn.AvgPool2d(2)
        inplanes = w
        for stage, (blocks, planes, stride) in enumerate(zip(
                layers, (w, w * 2, w * 4, w * 8), (1, 2, 2, 2))):
            mods = []
            for b in range(blocks):
                mods.append(Bottleneck(inplanes, planes,
                                       stride if b == 0 else 1, fp32_norms))
                inplanes = planes * Bottleneck.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*mods))
        self.attnpool = AttentionPool2d(input_resolution // 32, w * 32, heads,
                                        output_dim)

    def tower_forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``[N, H, W, 3]`` -> ``[N, output_dim]``."""
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = self.avgpool(x)
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
        return self.attnpool(x)


# ---------------------------------------------------------------------------
# Transformer (the ViT tower's and the text tower's)
# ---------------------------------------------------------------------------

def _dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           int8: bool) -> torch.Tensor:
    return int8_linear(x, weight, bias) if int8 else F.linear(x, weight, bias)


def _row_dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               int8: bool, tp) -> torch.Tensor:
    """``_dense`` of a row-parallel layer: ``x`` and ``weight`` hold this tp
    rank's share of the input features. The partial products are summed
    over the tp ranks in fp32 (int32 under int8) and the bias added once,
    after the sum, then cast to the product's dtype."""
    if tp is None:
        return _dense(x, weight, bias, int8)
    if int8:
        return int8_linear(x, weight, bias, tp=tp)
    part = F.linear(x, weight)
    return (tp.reduce_from(part) + bias).to(part.dtype)


class _Attention(nn.Module):
    """Fused-in-projection multi-head self-attention with
    ``nn.MultiheadAttention``'s parameter names.

    The vision attention is one ``scaled_dot_product_attention`` call,
    whose output is the ``attn_out`` tensor the remat policies name. It is
    spelled out as the JAX block computes it where a switch needs its
    probabilities (``fast_softmax``, or the ``attn_probs`` tag of the
    ``attn`` remat policy): fp32 scores times ``hd**-0.5``, the
    probabilities (``tags.attn_probs``, cast to v's dtype), then
    ``tags.attn_out``, ``probs @ v``.

    ``tp`` (``parallel/tensor.py:TPContext``, set by ``shard_model_``):
    this rank holds the q, k and v rows of ``n_head / tp`` heads of
    ``in_proj`` (column-parallel) and their columns of ``out_proj``
    (row-parallel), and attends over those heads alone."""

    def __init__(self, d_model: int, n_head: int, causal: bool,
                 fast_softmax: bool = False):
        super().__init__()
        self.n_head, self.causal = n_head, causal
        self.tp = None
        self.fast_softmax = fast_softmax
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor, int8: bool = False) -> torch.Tensor:
        B, L, D = x.shape
        hd = D // self.n_head
        tp = self.tp
        heads = self.n_head // (1 if tp is None else tp.world)
        if tp is not None:
            x = tp.copy_to(x)
        qkv = _dense(x, self.in_proj_weight, self.in_proj_bias, int8)
        q, k, v = (t.reshape(B, L, heads, hd).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        if self.causal:
            attn = fp32_or_wider(torch.matmul(q, k.transpose(-1, -2))) \
                * hd ** -0.5
            mask = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
            attn = attn.masked_fill(~mask, float("-inf"))
            attn = torch.softmax(attn, dim=-1).to(v.dtype)
            out = torch.matmul(attn, v)
        elif self.fast_softmax or "attn_probs" in tags.active():
            with torch.autocast(x.device.type, enabled=False):
                scores = torch.matmul(
                    fp32_or_wider(q), fp32_or_wider(k).transpose(-1, -2)) \
                    * hd ** -0.5
                probs = tags.attn_probs(scores, self.fast_softmax, v.dtype)
                out = tags.attn_out(probs, v)
        else:
            out = F.scaled_dot_product_attention(q, k, v)
        return _row_dense(out.transpose(1, 2).reshape(B, L, heads * hd),
                          self.out_proj.weight, self.out_proj.bias, int8, tp)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN attention + QuickGELU MLP. ``int8_eval``: the four
    projections in dynamic int8 outside training (``ops/quant.py``; the
    same parameters). The gelu is ``tags.mlp_gelu`` where the ``mlp`` remat
    policy names its output. ``tp`` (``parallel/tensor.py:TPContext``, set
    by ``shard_model_``): ``c_fc`` column-parallel and ``c_proj``
    row-parallel, the gelu on this rank's slice of the hidden features."""

    def __init__(self, d_model: int, n_head: int, causal: bool = False,
                 fast_softmax: bool = False, fp32_norms: bool = True,
                 int8_eval: bool = False):
        super().__init__()
        self.int8_eval = int8_eval
        self.tp = None
        self.ln_1 = FP32LayerNorm(d_model, eps=1e-5, fp32=fp32_norms)
        self.attn = _Attention(d_model, n_head, causal, fast_softmax)
        self.ln_2 = FP32LayerNorm(d_model, eps=1e-5, fp32=fp32_norms)
        self.mlp = nn.ModuleDict({"c_fc": nn.Linear(d_model, 4 * d_model),
                                  "c_proj": nn.Linear(4 * d_model, d_model)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        int8 = self.int8_eval and not self.training
        x = x + self.attn(self.ln_1(x), int8)
        c_fc, c_proj = self.mlp.c_fc, self.mlp.c_proj
        h = self.ln_2(x)
        if self.tp is not None:
            h = self.tp.copy_to(h)
        h = _dense(h, c_fc.weight, c_fc.bias, int8)
        h = tags.mlp_gelu(h) if "mlp_gelu" in tags.active() else quick_gelu(h)
        return x + _row_dense(h, c_proj.weight, c_proj.bias, int8, self.tp)


class TransformerStack(nn.Module):
    def __init__(self, width: int, layers: int, heads: int,
                 causal: bool = False, **switches):
        super().__init__()
        self.resblocks = nn.Sequential(*[
            ResidualAttentionBlock(width, heads, causal, **switches)
            for _ in range(layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resblocks(x)


class VisionTransformer(GraphedTower):
    """Patch conv (no bias, stride = patch) -> class token first, then the
    positional embedding -> ``ln_pre`` -> pre-LN transformer -> ``ln_post``
    on token 0 -> ``@ proj`` (no bias). ``fast_softmax``, ``fp32_norms`` and
    ``int8_eval``: ``ResidualAttentionBlock``'s switches (the norms
    ``ln_pre`` and ``ln_post`` too)."""

    graph_switches = ("int8_eval", "fast_softmax", "causal", "fp32",
                      "elementwise_affine", "transposed")

    def __init__(self, input_resolution: int, patch_size: int, width: int,
                 layers: int, heads: int, output_dim: int,
                 fast_softmax: bool = False, fp32_norms: bool = True,
                 int8_eval: bool = False):
        super().__init__()
        grid = input_resolution // patch_size
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size,
                               bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(
            torch.zeros(grid * grid + 1, width))
        self.ln_pre = FP32LayerNorm(width, eps=1e-5, fp32=fp32_norms)
        self.transformer = TransformerStack(
            width, layers, heads, fast_softmax=fast_softmax,
            fp32_norms=fp32_norms, int8_eval=int8_eval)
        self.ln_post = FP32LayerNorm(width, eps=1e-5, fp32=fp32_norms)
        self.proj = nn.Parameter(torch.zeros(width, output_dim))

    def tower_forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``[N, H, W, 3]`` -> ``[N, output_dim]``."""
        x = self.conv1(x.permute(0, 3, 1, 2))               # [N, C, gh, gw]
        N, C = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)                    # [N, gh*gw, C]
        cls = self.class_embedding.to(x.dtype).expand(N, 1, C)
        x = torch.cat([cls, x], dim=1) \
            + self.positional_embedding[None].to(x.dtype)
        x = self.transformer(self.ln_pre(x))
        x = self.ln_post(x[:, 0])
        return x @ self.proj.to(x.dtype)


# ---------------------------------------------------------------------------
# Full CLIP
# ---------------------------------------------------------------------------

def make_clip_visual(arch: CLIPArch) -> nn.Module:
    """The visual tower of ``arch`` with its switches (``INT8_EVAL`` covers
    the ViT blocks only: ``models/fsar.py`` refuses it on a ResNet)."""
    if arch.is_vit:
        return VisionTransformer(
            input_resolution=arch.image_resolution,
            patch_size=arch.vision_patch_size, width=arch.vision_width,
            layers=arch.vision_layers, heads=arch.vision_heads,
            output_dim=arch.embed_dim, fast_softmax=arch.fast_softmax,
            fp32_norms=not arch.bf16_norms, int8_eval=arch.int8_eval)
    return ModifiedResNet(layers=arch.vision_layers, output_dim=arch.embed_dim,
                          heads=arch.vision_heads,
                          input_resolution=arch.image_resolution,
                          width=arch.vision_width,
                          fp32_norms=not arch.bf16_norms)


class CLIPModel(nn.Module):
    """Joint image/text model with OpenAI's state-dict layout."""

    def __init__(self, arch: CLIPArch):
        super().__init__()
        self.arch = arch
        self.visual = make_clip_visual(arch)
        self.transformer = TransformerStack(
            arch.transformer_width, arch.transformer_layers,
            arch.transformer_heads, causal=True)
        self.token_embedding = nn.Embedding(arch.vocab_size,
                                            arch.transformer_width)
        self.positional_embedding = nn.Parameter(
            torch.zeros(arch.context_length, arch.transformer_width))
        self.ln_final = FP32LayerNorm(arch.transformer_width, eps=1e-5)
        self.text_projection = nn.Parameter(
            torch.zeros(arch.transformer_width, arch.embed_dim))
        self.logit_scale = nn.Parameter(torch.zeros(()))

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        """``[N, H, W, 3]`` -> ``[N, embed_dim]``."""
        return self.visual(image)

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        """``[B, context_length]`` int tokens -> ``[B, embed_dim]``, pooled
        at the EOT token (the highest token id of each row)."""
        x = self.token_embedding(text.long())
        x = x + self.positional_embedding[None, : x.shape[1]].to(x.dtype)
        x = self.ln_final(self.transformer(x))
        eot = text.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection.to(pooled.dtype)
