"""The reference's top-level functions: class-text tables, one evaluation
episode, and the first optimizer steps of training, each worked out from
the benchmark's inputs alone (weights, episodes, the configuration and the
seed). Imports nothing of the program.

What the program derives is derived again here: the text tables from the
class names, the evaluation centre crop, and each training episode's flips
and crops and dropout masks, drawn as the configuration's trainer draws
them (a generator on the device seeded from ``MODEL.SEED`` and the
episode's index before each episode; the dropout masks from the device's
default generator, seeded the same, in the head's order and in the dtype
of the computation the configuration states).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import clip, head
from .tokenizer import SimpleTokenizer, tokenize

# the 16-template prompt ensemble of the clipspm head
PROMPT_TEMPLATES = [
    "a photo of action {}", "a picture of action {}", "Human action of {}",
    "{}, an action", "{} this is an action", "{}, a video of action",
    "Playing action of {}", "{}", "Playing a kind of action, {}",
    "Doing a kind of action, {}", "Look, the human is {}",
    "Can you recognize the action of {}?", "Video classification of {}",
    "A video of {}", "The man is {}", "The woman is {}",
]


@torch.no_grad()
def text_table(P, arch: dict, names: Sequence[str], device,
               block: int = 512) -> torch.Tensor:
    """``[C, embed]``: each class name through every template, the text
    tower, and the mean over the templates."""
    tk = SimpleTokenizer(vocab_size=arch["vocab_size"])
    prompts = [t.format(n) for t in PROMPT_TEMPLATES for n in names]
    tokens = torch.from_numpy(tokenize(prompts, arch["context_length"],
                                       truncate=True, tokenizer=tk))
    feats = torch.cat([clip.encode_text(tokens[i:i + block].to(device), P,
                                        arch["text_layers"],
                                        arch["text_heads"])
                       for i in range(0, len(prompts), block)])
    return feats.reshape(len(PROMPT_TEMPLATES), len(names), -1).mean(dim=0)


def _frames(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _check_size(frames: torch.Tensor, transform: dict) -> None:
    if frames.shape[-3:-1] != (transform["resize_to"],) * 2:
        raise ValueError(f"frames of {tuple(frames.shape[-3:-1])} need a "
                         f"resize to {transform['resize_to']}, which the "
                         "reference does not do")


def eval_frames(x: torch.Tensor, transform: dict) -> torch.Tensor:
    """Centre crop of ``[N, T, H, W, 3]`` uint8 frames, to 0-1 floats."""
    _check_size(x, transform)
    s = transform["img_size"]
    top, left = (x.shape[-3] - s) // 2, (x.shape[-2] - s) // 2
    return x[..., top:top + s, left:left + s, :].float() * (1.0 / 255.0)


def train_frames(x: torch.Tensor, transform: dict,
                 gen: torch.Generator) -> torch.Tensor:
    """Per-video flip, then a random crop, drawn from ``gen`` in that order
    (flips, tops, lefts), to 0-1 floats."""
    _check_size(x, transform)
    n, _, h, w, _ = x.shape
    s = transform["img_size"]
    dev = gen.device
    flips = torch.rand(n, generator=gen, device=dev) < 0.5
    tops = torch.randint(0, h - s + 1, (n,), generator=gen, device=dev)
    lefts = torch.randint(0, w - s + 1, (n,), generator=gen, device=dev)
    if transform["flip"]:
        x = torch.where(flips[:, None, None, None, None], x.flip(-2), x)
    out = torch.stack([x[i, :, tops[i]:tops[i] + s, lefts[i]:lefts[i] + s]
                       for i in range(n)])
    return out.float() * (1.0 / 255.0)


def _features(frames: torch.Tensor, P, arch, train: bool, prec,
              chunk: int = 0, remat: bool = False) -> torch.Tensor:
    N, T = frames.shape[:2]
    flat = frames.reshape((N * T,) + tuple(frames.shape[2:]))
    if chunk and not train:
        feats = torch.cat([clip.visual(flat[i:i + chunk], P, arch, False,
                                       prec) for i in range(0, N * T, chunk)])
    else:
        feats = clip.visual(flat, P, arch, train, prec, remat)
    return feats.reshape(N, T, -1)


@torch.no_grad()
def eval_episode(P, config: dict, ep: dict, table: torch.Tensor,
                 transform: dict, prec=clip._ident, chunk: int = 30
                 ) -> Dict[str, torch.Tensor]:
    """One evaluation episode: ``logits [Q, way]`` and ``loss``."""
    arch, cfg = config["published"], config["port_config"]
    dev = table.device
    way, shot = int(cfg["TRAIN"]["WAY"]), int(cfg["TRAIN"]["SHOT"])
    su_img = eval_frames(_frames(ep["support_images"], dev), transform)
    qu_img = eval_frames(_frames(ep["target_images"], dev), transform)
    S = su_img.shape[0]
    feats = _features(torch.cat([su_img, qu_img]), P, arch, False, prec,
                      chunk)
    rs = torch.as_tensor(ep["real_support_labels"], device=dev).long()
    rq = torch.as_tensor(ep["real_target_labels"], device=dev).long()
    h = head.Head(P, cfg["params"], way, shot, train=False, prec=prec)
    logits, aux = h.forward(feats[:S], feats[S:], torch.as_tensor(
        ep["support_labels"], device=dev), table[rs][:, None],
        table[rq][:, None])
    loss, acc = head.episode_loss(
        logits, torch.as_tensor(ep["target_labels"], device=dev), aux,
        int(cfg["TRAIN"]["TASKS_PER_BATCH"]))
    return {"logits": logits, "loss": loss, "acc": acc}


def episode_seed(seed: int, episode: int) -> int:
    """The generator seed of training episode ``episode`` under the
    configuration's seed."""
    return int(np.random.SeedSequence([seed, episode]).generate_state(1)[0])


def _seed_all(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if torch.device(device).type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.manual_seed(seed)
    else:
        torch.manual_seed(seed)
    return gen


def trainable(P) -> List[str]:
    """The keys the optimizer updates: the vision tower's and the head's
    parameters (not BatchNorm's running statistics, not the text tower)."""
    return [k for k in P if (k.startswith("visual.") or k.startswith("head."))
            and not k.endswith(("running_mean", "running_var",
                                "num_batches_tracked"))]


def train_steps(P0, config: dict, episodes: Sequence[dict],
                table: torch.Tensor, transform: dict, seed: int, steps: int,
                prec=clip._ident, mask_dtype=torch.float32
                ) -> Dict[str, object]:
    """The first ``steps`` optimizer steps from ``P0`` over ``episodes``
    (``TASKS_PER_BATCH`` a step, in order; each episode's index its
    position). Returns each episode's loss, each leaf's gradient norm as
    the optimizer got it at step 1 (with its weight decay), and each leaf's
    change after the last step."""
    arch, cfg = config["published"], config["port_config"]
    dev = table.device
    way, shot = int(cfg["TRAIN"]["WAY"]), int(cfg["TRAIN"]["SHOT"])
    tpb = int(cfg["TRAIN"]["TASKS_PER_BATCH"])
    sol = cfg["SOLVER"]
    if sol["OPTIM_METHOD"] != "adam":
        raise ValueError("the reference follows Adam only")
    lr, wd = float(sol["LR"]), float(sol["WEIGHT_DECAY"])
    b1, b2, eps = 0.5, 0.999, 1e-8
    keys = trainable(P0)
    P = dict(P0)
    for k in keys:
        P[k] = P0[k].detach().clone().requires_grad_(True)
    m = {k: torch.zeros_like(P[k]) for k in keys}
    v = {k: torch.zeros_like(P[k]) for k in keys}
    losses, g1 = [], {}

    def masks(shape, p):
        ones = torch.ones(shape, dtype=mask_dtype, device=dev)
        return F.dropout(ones, p, training=True) != 0

    for step in range(steps):
        for pos in range(tpb):
            idx = step * tpb + pos
            ep = episodes[idx]
            gen = _seed_all(episode_seed(seed, idx), dev)
            su = train_frames(_frames(ep["support_images"], dev), transform,
                              gen)
            qu = train_frames(_frames(ep["target_images"], dev), transform,
                              gen)
            S = su.shape[0]
            feats = _features(torch.cat([su, qu]), P, arch, True, prec,
                              remat=True)
            rs = torch.as_tensor(ep["real_support_labels"], device=dev).long()
            rq = torch.as_tensor(ep["real_target_labels"], device=dev).long()
            h = head.Head(P, cfg["params"], way, shot, train=True, prec=prec,
                          masks=masks)
            logits, aux = h.forward(feats[:S], feats[S:], torch.as_tensor(
                ep["support_labels"], device=dev), table[rs][:, None],
                table[rq][:, None])
            loss, _ = head.episode_loss(
                logits, torch.as_tensor(ep["target_labels"], device=dev), aux,
                tpb)
            loss.backward()
            losses.append(float(loss.detach()))
        t = step + 1
        rate = lr * 0.1 ** int(step * tpb >= int(sol["LR_SCH"]))
        with torch.no_grad():
            for k in keys:
                p = P[k]
                g = (torch.zeros_like(p) if p.grad is None else p.grad) \
                    + wd * p
                if step == 0:
                    g1[k] = float(torch.linalg.vector_norm(g))
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = v[k].sqrt() / math.sqrt(1 - b2 ** t) + eps
                p.addcdiv_(m[k], denom, value=-rate / (1 - b1 ** t))
                p.grad = None
    change = {k: float(torch.linalg.vector_norm(P[k].detach() - P0[k]))
              for k in keys}
    return {"losses": losses, "grad_norms": g1, "change_norms": change}
