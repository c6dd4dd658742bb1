"""CLIP backbones in PyTorch: the RN50-family ModifiedResNet visual tower and
the causal text transformer.

Port of ``clipspm_tpu/models/backbones/clip.py``. Modules and parameters
carry OpenAI's state-dict key names (``visual.layer1.0.conv1.weight``,
``transformer.resblocks.0.attn.in_proj_weight`` ...), so an OpenAI ``.pt``
loads straight into them. Frames are NHWC ``[N, H, W, 3]`` at the public
functions and NCHW only inside the tower (the permuted view keeps NHWC
strides, which cuDNN runs as channels-last). LayerNorm and BatchNorm compute
in fp32 whatever the compute dtype. The ViT tower waits for a later slice.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.precision import fp32_or_wider


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
    """LayerNorm computed in fp32 and cast back to the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(fp32_or_wider(x)).to(x.dtype)


class FP32BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm computed in fp32 (its output stays fp32; fp64 stays fp64).

    In train mode the running variance takes the *biased* batch variance,
    as flax's ``nn.BatchNorm`` does (momentum 0.9 there is 0.1 here).
    ``nn.BatchNorm2d`` folds in the unbiased one, ``n / (n - 1)`` times
    larger. So the op updates a copy of the ``[C]`` buffer (the copy is
    what its backward keeps), and the buffer takes the corrected value: the
    batch statistics stay one fused pass."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = FP32BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = FP32BatchNorm2d(planes)
        self.avgpool = nn.AvgPool2d(stride) if stride > 1 else nn.Identity()
        self.conv3 = _conv(planes, out_ch, 1)
        self.bn3 = FP32BatchNorm2d(out_ch)
        self.downsample = None
        if stride > 1 or inplanes != out_ch:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride) if stride > 1 else nn.Identity()),
                ("0", _conv(inplanes, out_ch, 1)),
                ("1", FP32BatchNorm2d(out_ch))]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(self.avgpool(h)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class AttentionPool2d(nn.Module):
    """Multi-head attention pooling: the mean token is prepended, the
    positional embedding added, and token 0 alone queries (``spatial=False``).
    """

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: int):
        super().__init__()
        self.num_heads = num_heads
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
        return self.c_proj(out)[:, 0]


class ModifiedResNet(nn.Module):
    """3-conv stem + avgpool + 4 stages + attention pooling."""

    def __init__(self, layers: Tuple[int, int, int, int], output_dim: int,
                 heads: int, input_resolution: int = 224, width: int = 64):
        super().__init__()
        w = width
        self.conv1 = _conv(3, w // 2, 3, stride=2)
        self.bn1 = FP32BatchNorm2d(w // 2)
        self.conv2 = _conv(w // 2, w // 2, 3)
        self.bn2 = FP32BatchNorm2d(w // 2)
        self.conv3 = _conv(w // 2, w, 3)
        self.bn3 = FP32BatchNorm2d(w)
        self.avgpool = nn.AvgPool2d(2)
        inplanes = w
        for stage, (blocks, planes, stride) in enumerate(zip(
                layers, (w, w * 2, w * 4, w * 8), (1, 2, 2, 2))):
            mods = []
            for b in range(blocks):
                mods.append(Bottleneck(inplanes, planes, stride if b == 0 else 1))
                inplanes = planes * Bottleneck.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*mods))
        self.attnpool = AttentionPool2d(input_resolution // 32, w * 32, heads,
                                        output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
# Text transformer
# ---------------------------------------------------------------------------

class _Attention(nn.Module):
    """Fused-in-projection multi-head self-attention with
    ``nn.MultiheadAttention``'s parameter names."""

    def __init__(self, d_model: int, n_head: int, causal: bool):
        super().__init__()
        self.n_head, self.causal = n_head, causal
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        hd = D // self.n_head
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.reshape(B, L, self.n_head, hd).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        attn = torch.matmul(q, k.transpose(-1, -2)).float() * hd ** -0.5
        if self.causal:
            mask = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
            attn = attn.masked_fill(~mask, float("-inf"))
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, L, D)
        return self.out_proj(out)


class QuickGELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quick_gelu(x)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN attention + QuickGELU MLP."""

    def __init__(self, d_model: int, n_head: int, causal: bool = False):
        super().__init__()
        self.ln_1 = FP32LayerNorm(d_model, eps=1e-5)
        self.attn = _Attention(d_model, n_head, causal)
        self.ln_2 = FP32LayerNorm(d_model, eps=1e-5)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(d_model, 4 * d_model)),
            ("gelu", QuickGELU()),
            ("c_proj", nn.Linear(4 * d_model, d_model))]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class TransformerStack(nn.Module):
    def __init__(self, width: int, layers: int, heads: int,
                 causal: bool = False):
        super().__init__()
        self.resblocks = nn.Sequential(*[
            ResidualAttentionBlock(width, heads, causal) for _ in range(layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resblocks(x)


# ---------------------------------------------------------------------------
# Full CLIP
# ---------------------------------------------------------------------------

def make_clip_visual(arch: CLIPArch) -> ModifiedResNet:
    if arch.is_vit:
        raise NotImplementedError(
            "the ViT visual tower is not ported yet (ROADMAP.md, open item "
            "'ViT-B/16'); the port runs the RN-family ModifiedResNet")
    return ModifiedResNet(layers=arch.vision_layers, output_dim=arch.embed_dim,
                          heads=arch.vision_heads,
                          input_resolution=arch.image_resolution,
                          width=arch.vision_width)


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
