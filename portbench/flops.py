"""Operations, bytes and peaks: the yardstick of the per-layer metrics.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its
700 W limit): 989 TFLOP/s in bf16, 67 TFLOP/s in fp32 outside the tensor
cores, 3.35 TB/s of HBM3.

Model FLOPs count each product of the forward pass once, two operations a
multiply-add: convolutions, projections and attention's two batched
products. Norms, activations and the soft-min DPs are left out (below a
percent of either tower). A training step's model FLOPs are three times
its forward pass, recomputation not counted.
"""

from __future__ import annotations

from typing import Dict

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def _conv(cin: int, cout: int, k: int, hw: int) -> int:
    return 2 * cin * cout * k * k * hw * hw


def rn_frame_flops(arch: dict) -> int:
    """Forward FLOPs of one frame through CLIP's ModifiedResNet."""
    w, res = arch["vision_width"], arch["image"]
    h = res // 2
    f = _conv(3, w // 2, 3, h) + _conv(w // 2, w // 2, 3, h) \
        + _conv(w // 2, w, 3, h)
    h //= 2
    inplanes = w
    for stage, blocks in enumerate(arch["vision_layers"]):
        planes = w * 2 ** stage
        for b in range(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            f += _conv(inplanes, planes, 1, h) + _conv(planes, planes, 3, h)
            h2 = h // stride
            f += _conv(planes, 4 * planes, 1, h2)
            if stride > 1 or inplanes != 4 * planes:
                f += _conv(inplanes, 4 * planes, 1, h2)
            h, inplanes = h2, 4 * planes
    c, n = w * 32, h * h + 1
    # q of the mean token alone, k and v of every token, one query's
    # scores and weighted sum over n tokens, the output projection
    f += 2 * c * c + 2 * 2 * n * c * c + 2 * 2 * n * c \
        + 2 * c * arch["embed_dim"]
    return f


def vit_frame_flops(arch: dict) -> int:
    """Forward FLOPs of one frame through CLIP's vision transformer:
    the patch projection, per layer ``24 N d^2 + 4 N^2 d`` (N tokens of
    width d), and the output projection."""
    d, p, res = arch["vision_width"], arch["patch"], arch["image"]
    patches = (res // p) ** 2
    N = patches + 1
    f = 2 * patches * 3 * p * p * d
    f += arch["vision_layers"] * (24 * N * d * d + 4 * N * N * d)
    return f + 2 * d * arch["embed_dim"]


def frame_flops(arch: dict) -> int:
    return vit_frame_flops(arch) if arch["vision"] == "vit" \
        else rn_frame_flops(arch)


def head_flops(config: dict, queries: int) -> int:
    """Forward FLOPs of the clipspm head over one episode's features,
    counted by ``torch.utils.flop_counter`` over the plain head at the
    configuration's widths on the CPU (its products, as above)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .inputs import weight_specs
    from .reference import head

    cfg, arch = config["port_config"], config["published"]
    way, shot = int(cfg["TRAIN"]["WAY"]), int(cfg["TRAIN"]["SHOT"])
    T, D = int(cfg["DATA"]["SEQ_LEN"]), arch["embed_dim"]
    P = {n: torch.zeros(s) for n, s, _, _ in weight_specs(config)
         if n.startswith("head.")}
    gen = torch.Generator().manual_seed(0)
    S, Q = way * shot, way * queries
    labels = torch.arange(way).repeat_interleave(shot)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        head.Head(P, cfg["params"], way, shot).forward(
            torch.rand(S, T, D, generator=gen), torch.rand(Q, T, D,
                                                           generator=gen),
            labels, torch.rand(S, 1, D, generator=gen),
            torch.rand(Q, 1, D, generator=gen))
    return int(counter.get_total_flops())


def episode_flops(config: dict, traffic: dict) -> int:
    """Forward model FLOPs of one episode of ``traffic``: every frame of
    its videos through the tower, then the head."""
    videos = traffic["way"] * (traffic["shot"] + traffic["queries"])
    frames = videos * int(config["port_config"]["DATA"]["SEQ_LEN"])
    return frames * frame_flops(config["published"]) + head_flops(
        config, traffic["queries"])


# -- kernel K1 (the OTAM DP, fused mode): copied from chip_smoke.py --------

def bound_ms(bytes_: float, ops: float) -> Dict[str, object]:
    """Least time on the card: the larger of bytes over the HBM rate and
    fp32 operations over the fp32 peak (the DPs' exp/log arithmetic is
    fp32 outside the tensor cores)."""
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return {"ms": max(t_bytes, t_ops),
            "by": "bytes" if t_bytes >= t_ops else "operations"}


def otam_dp_ops(B: int, L: int, Ms: int) -> int:
    """fp32 operations of B OTAM DPs: row 0 one add per cell; per written
    cell about 15 (soft-min: subtract, scale, clamp and exp per argument, a
    sum, log, scale, shift, plus the table value)."""
    return B * (Ms + (L - 1) * (Ms + 1) * 15)


def otam_fused_bound_ms(Q: int, S: int, L: int, D: int,
                        bidirectional: bool = True) -> float:
    """Least time of one fused K1 launch: each feature byte read once, each
    result written once; the gram's ``2 Q S L^2 D`` FLOPs, each frame
    vector's norm once (``2 D``), and the DPs'."""
    ops = (2 * Q * S * L * L * D + 2 * (Q + S) * L * D
           + otam_dp_ops(Q * S, L, L) * (2 if bidirectional else 1))
    return bound_ms(4 * (Q + S) * L * D + 4 * Q * S, ops)["ms"]
