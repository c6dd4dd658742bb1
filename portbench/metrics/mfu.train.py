"""The untraced window's model FLOP/s over the card's bf16 peak, in %:
three times each episode's forward FLOPs (``flops.episode_flops``),
recomputation not counted, times the window's episodes, over its wall
seconds times 989 TFLOP/s. The rate that ``train_episodes_per_s`` reads,
in FLOPs. Layer: the whole step."""

from portbench import flops


def read(run):
    w = run.window
    if not w.get("episodes") or w.get("wall_s", 0) <= 0:
        return None
    work = 3 * flops.episode_flops(run.config, run.traffic) * w["episodes"]
    return 100.0 * work / (w["wall_s"] * flops.PEAK_BF16_FLOPS)
