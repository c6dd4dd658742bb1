"""The benchmark's inputs, made from ``--seed``: the weights of a
configuration and the episodes of a traffic mix. Both sides (the program
and the reference) are handed the same.

Weights: every key of the configuration's towers (OpenAI CLIP's state-dict
keys) and head (the port's keys), drawn on the device from one
``torch.Generator`` in one call per distribution, in float32, as the
program serves them (its autocast casts them).

Episodes: uint8 RGB frames at the decode stage's output size, made on the
device in bulk and held in host memory as numpy episodes with the episodic
label layout (``way`` distinct classes of the split, ``shot`` support and
``queries`` query videos a class, each side shuffled). Each class has a
smooth colour field of its own, each video a smooth perturbation of it and
each frame fine noise, so the classes differ and the features do too.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .reference.clip import text_specs, visual_specs
from .reference.head import head_specs


def weight_specs(config: dict) -> list:
    """``(name, shape, kind, std)`` of every tensor of the configuration:
    vision tower, text tower, head."""
    arch = config["published"]
    spm = config["port_config"]["params"]
    return visual_specs(arch) + text_specs(arch) + head_specs(
        arch["embed_dim"], spm)


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's weights from ``seed`` on ``device``: one normal
    draw for all the random tensors, scaled per tensor."""
    specs = weight_specs(config)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, "weights"))
    normal = [s for s in specs if s[2] == "normal"]
    total = sum(math.prod(s[1]) for s in normal)
    flat = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for name, shape, kind, std in specs:
        if kind == "normal":
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape).mul_(std)
            off += n
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
        elif kind == "log_inv_temp":
            out[name] = torch.full(shape, math.log(1 / 0.07), device=device)
        else:
            raise ValueError(f"unknown initial distribution {kind!r}")
    return out


def seed_of(seed: int, what: str) -> int:
    """A 63-bit generator seed for one kind of input, from the run's seed
    (any whole number, beyond 32 bits too)."""
    tag = int.from_bytes(what.encode(), "little") % (2 ** 32)
    lo, hi = np.random.SeedSequence([int(seed) % (2 ** 128), tag]
                                    ).generate_state(2, np.uint32).tolist()
    return (lo | (hi << 32)) % (2 ** 63)


def class_names(config: dict, split: str) -> List[str]:
    """The class names of ``split`` (``train`` or ``test``), whose rows the
    text tables hold."""
    return list(config["port_config"]["TRAIN" if split == "train"
                                      else "TEST"]["CLASS_NAME"])


def make_episodes(traffic: dict, n_classes: int, seed: int, device
                  ) -> list:
    """``traffic["pool"]`` episodes of the mix from ``seed``: numpy leaves
    in the port's ``Episode`` layout, as a list of dicts."""
    way, shot, q = traffic["way"], traffic["shot"], traffic["queries"]
    T, px, pool = traffic["seq_len"], traffic["frame_px"], traffic["pool"]
    rng = np.random.default_rng(seed_of(seed, "episodes"))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, "frames"))
    # one smooth colour field per class, 16x16 upsampled to the frame size
    fields = F.interpolate(
        torch.rand(n_classes, 3, 16, 16, generator=gen, device=device) * 255,
        size=(px, px), mode="bilinear", align_corners=False)
    episodes = []
    per = way * (shot + q)
    for _ in range(pool):
        classes = rng.choice(n_classes, size=way, replace=False)
        sup_rl, tgt_rl = np.repeat(classes, shot), np.repeat(classes, q)
        sup_l, tgt_l = np.repeat(np.arange(way), shot), np.repeat(
            np.arange(way), q)
        sperm, tperm = rng.permutation(way * shot), rng.permutation(way * q)
        rl = np.concatenate([sup_rl[sperm], tgt_rl[tperm]])
        base = fields[torch.as_tensor(rl, device=device)]        # [V,3,H,W]
        wobble = F.interpolate(
            torch.randn(per, 3, 8, 8, generator=gen, device=device) * 40,
            size=(px, px), mode="bilinear", align_corners=False)
        noise = torch.randn(per, T, 3, px, px, generator=gen,
                            device=device) * 12
        frames = ((base + wobble)[:, None] + noise).clamp_(0, 255)
        frames = frames.round_().to(torch.uint8).permute(0, 1, 3, 4, 2)
        frames = frames.contiguous().cpu().numpy()
        episodes.append(dict(
            support_images=frames[:way * shot],
            support_labels=sup_l[sperm].astype(np.int32),
            target_images=frames[way * shot:],
            target_labels=tgt_l[tperm].astype(np.int32),
            real_support_labels=sup_rl[sperm].astype(np.int32),
            real_target_labels=tgt_rl[tperm].astype(np.int32),
            batch_class_list=classes.astype(np.int32)))
    return episodes
