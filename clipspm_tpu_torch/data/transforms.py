"""Frame transforms on the device, batched over whole clips.

Port of ``clipspm_tpu/data/transforms.py`` (eval center crop; train
per-video flip then random crop) and of ``TransformSpec``
(``clipspm_tpu/train/learner.py``). Frames stay NHWC at the public boundary:
``[N, T, H, W, 3]`` uint8 in, float in the same layout out. Train offsets
and flips are drawn per video from an explicit ``torch.Generator`` on the
frames' device (``draw_train_offsets``); ``horizontal_flip`` and
``random_crop`` take them as arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

# CLIP preprocessing constants; applied only under DATA.IMG_NORM (the
# episodic path feeds plain 0-1 frames to the backbone).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass
class TransformSpec:
    img_size: int = 224
    resize_to: int = 256
    flip: bool = True            # False for SSv2
    normalize: bool = False

    @classmethod
    def from_config(cls, cfg) -> "TransformSpec":
        dataset = cfg.DATA.DATASET
        img = int(cfg.DATA.IMG_SIZE)
        # 224 -> 256, 84 -> 96; any other size scales by the same 8/7
        if img == 224:
            resize_to = 256
        elif img == 84:
            resize_to = 96
        else:
            resize_to = max(96, -(-img * 8 // 7))
        return cls(img_size=img, resize_to=resize_to,
                   flip=dataset not in ("ssv2", "ssv2_cmn"),
                   normalize=bool(cfg.DATA.get("IMG_NORM", False)))


def resize_short_side(x: torch.Tensor, size: int) -> torch.Tensor:
    """Resize ``[..., H, W, 3]`` so the short side equals ``size``; an
    identity when it already does (the 256x256 benchmark dumps). Otherwise
    antialiased bilinear, which differs from the JAX resize at the subpixel
    level."""
    h, w = x.shape[-3], x.shape[-2]
    if h <= w:
        new_h, new_w = size, max(1, round(w * size / h))
    else:
        new_h, new_w = max(1, round(h * size / w)), size
    if (new_h, new_w) == (h, w):
        return x
    lead = x.shape[:-3]
    flat = x.reshape((-1, h, w, x.shape[-1])).permute(0, 3, 1, 2).float()
    out = F.interpolate(flat, size=(new_h, new_w), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1).reshape(lead + (new_h, new_w, x.shape[-1]))


def center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    h, w = x.shape[-3], x.shape[-2]
    top, left = (h - size) // 2, (w - size) // 2
    return x[..., top: top + size, left: left + size, :]


def draw_train_offsets(n: int, h: int, w: int, size: int,
                       gen: torch.Generator) -> tuple:
    """Per-video ``(flips [n] bool, tops [n], lefts [n])`` for a flip then a
    ``size`` crop of ``h x w`` frames, drawn from ``gen`` on its device in
    that order (the flips first, as the JAX transform splits its key)."""
    dev = gen.device
    flips = torch.rand(n, generator=gen, device=dev) < 0.5
    tops = torch.randint(0, h - size + 1, (n,), generator=gen, device=dev)
    lefts = torch.randint(0, w - size + 1, (n,), generator=gen, device=dev)
    return flips, tops, lefts


def horizontal_flip(x: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """Mirror the ``[N, T, H, W, C]`` clips whose ``flips[n]`` is set."""
    return torch.where(flips.to(x.device)[:, None, None, None, None],
                       x.flip(-2), x)


def random_crop(x: torch.Tensor, size: int, tops: torch.Tensor,
                lefts: torch.Tensor) -> torch.Tensor:
    """Per-video ``size x size`` crop of ``[N, T, H, W, C]`` clips at
    ``(tops[n], lefts[n])``: one gather, no host sync."""
    ar = torch.arange(size, device=x.device)
    rows = (tops.to(x.device)[:, None] + ar)[:, :, None]         # [N, s, 1]
    cols = (lefts.to(x.device)[:, None] + ar)[:, None, :]        # [N, 1, s]
    n = torch.arange(x.shape[0], device=x.device)[:, None, None]
    # advanced indices around a slice put their [N, s, s] dims first
    return x[n, :, rows, cols, :].permute(0, 3, 1, 2, 4)


def to_float(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    # times the reciprocal: XLA compiles the JAX package's x / 255 to this,
    # so the model input is bit-identical
    return x.to(dtype) * (1.0 / 255.0)


def clip_normalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def episode_device_transform(images: torch.Tensor, *, train: bool,
                             img_size: int = 224, resize_to: int = 256,
                             flip: bool = True, normalize: bool = False,
                             dtype=torch.float32,
                             gen: Optional[torch.Generator] = None
                             ) -> torch.Tensor:
    """Decode-to-model transform for one episode side.

    Args:
        images: ``[N, T, H, W, 3]`` uint8 frames.
        train: per-video flip (when ``flip``) then random crop, drawn from
            ``gen``; else the center crop.
    Returns:
        ``[N, T, img_size, img_size, 3]`` float frames in 0-1 (optionally
        CLIP-normalized).
    """
    x = resize_short_side(images, resize_to)
    if train:
        n, _, h, w, _ = x.shape
        flips, tops, lefts = draw_train_offsets(n, h, w, img_size, gen)
        if flip:
            x = horizontal_flip(x, flips)
        x = random_crop(x, img_size, tops, lefts)
    else:
        x = center_crop(x, img_size)
    x = to_float(x, dtype)
    if normalize:
        x = clip_normalize(x)
    return x
