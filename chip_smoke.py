"""Chip smoke test of the PyTorch / CUDA port (``clipspm_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit:

1. device: a CUDA device must be visible; prints the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build: compiles every CUDA source of the port (one ``nvcc`` per source,
   all started together) and prints the build seconds;
3. kernels against their plain PyTorch versions on the card, forward and
   gradient, at the main paths' shapes, with CUDA-event timings: K1 (OTAM
   DP) and K2 (soft-DTW DP);
4. the main paths at full width, each through the port's CLI on random
   weights over a synthetic split, with every kernel launch counter set to
   0 just before the path and read just after:
   - clipspm: CLIP-SPM RN50 (224 crop, T=8, 5-way 5-shot, bf16)
     feature-cached evaluation over an HMDB-layout split (K1, 6 launches
     per episode);
   - ta2n: TA2N on a torchvision ResNet-50 (224 crop, T=8, 5-way 1-shot,
     bf16) with ``MODEL.METRIC=otam``, feature-cached evaluation over a
     UCF-layout split (K2, 2 launches per episode).

It prints a ``{"kernels": [...]}`` line and, last, the device line
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

# every CUDA source under clipspm_tpu_torch/csrc/
SOURCES = ("otam_dp", "softdtw_dp")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and fp32
# non-tensor-core FLOP/s; the DPs' exp/log/div arithmetic is fp32 SIMT.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12

OTAM_LAMBDAS = (0.5, 0.1)
# main-path table batches: class prototypes and task prototypes (Q*way =
# 5*5) and task tokens (1*way); 1600 = 64 episodes x 25 pairs, not a
# multiple of the 128-thread block
OTAM_BATCHES = (25, 5, 1600)
OTAM_T = 8
TOL = 2e-5   # fp32, both sides round the same soft-min differently
GRAD_TOL = 2e-4

# K2 on the TA2N head: way*Q = 25 padded tables [T+2, T] per launch; 5 and
# 1600 as for K1; gamma 0.1 is the head's, 1.0 the function's default
SDTW_BATCHES = (25, 5, 1600)
SDTW_N, SDTW_M = 10, 8
SDTW_GAMMAS = (0.1, 1.0)
SDTW_BANDS = (0.0, 2.0)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    from clipspm_tpu_torch.ops import build

    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        paths = list(pool.map(build.build, SOURCES))
    log(f"build: {len(paths)} CUDA source(s) in "
        f"{time.perf_counter() - t0:.2f} s")


def _time_ms(fn, iters: int = 200) -> float:
    """Per-call time of ``fn`` launched eagerly, from CUDA events after
    warm-up (the host's launch rate included where it is slower than the
    device)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _otam_bound_ms(B: int, L: int, Ms: int) -> tuple:
    """Least time of one launch: tables read once, results written once;
    per written cell about 15 fp32 operations (soft-min: subtract, divide,
    clamp and exp per argument, a sum, log, scale, shift, plus the table
    value), row 0 one add per cell."""
    bytes_ = 4 * B * L * Ms + 4 * B
    ops = B * (Ms + (L - 1) * (Ms + 1) * 15)
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels() -> dict:
    from clipspm_tpu_torch.ops import otam_cuda
    from clipspm_tpu_torch.ops.otam import otam_cum_dist as plain
    from clipspm_tpu_torch.tools.k1_variants import graph_ms

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    worst_abs = 0.0
    timings = {}
    for B in OTAM_BATCHES:
        for lbda in OTAM_LAMBDAS:
            tables = (torch.rand(B, OTAM_T, OTAM_T, generator=gen) * 2.0).to(dev)
            got = otam_cuda.otam_dp_cuda(tables, lbda)
            want = plain(tables, lbda)
            torch.cuda.synchronize()
            err = (got - want).abs()
            rel = (err / want.abs().clamp_min(1e-6)).max().item()
            if not torch.allclose(got, want, rtol=TOL, atol=TOL):
                raise AssertionError(
                    f"K1 forward disagrees at B={B} lambda={lbda}: max abs "
                    f"{err.max().item():.3e}")
            # gradient through the autograd.Function vs plain autograd
            t1 = tables.clone().requires_grad_(True)
            t2 = tables.clone().requires_grad_(True)
            w = torch.rand(B, generator=gen).to(dev)
            (otam_cuda.otam_cum_dist(t1, lbda) * w).sum().backward()
            (plain(t2, lbda) * w).sum().backward()
            gerr = (t1.grad - t2.grad).abs().max().item()
            if not torch.allclose(t1.grad, t2.grad, rtol=2e-4, atol=2e-4):
                raise AssertionError(
                    f"K1 gradient disagrees at B={B} lambda={lbda}: max abs "
                    f"{gerr:.3e}")
            worst_abs = max(worst_abs, err.max().item())
            k_ms = _time_ms(lambda: otam_cuda.otam_dp_cuda(tables, lbda))
            k_dev = graph_ms(lambda: otam_cuda.otam_dp_cuda(tables, lbda))
            p_ms = _time_ms(lambda: plain(tables, lbda), iters=20)
            p_dev = graph_ms(lambda: plain(tables, lbda), iters=20)
            bound_ms, bound_by = _otam_bound_ms(B, OTAM_T, OTAM_T)
            timings[(B, lbda)] = (k_ms, k_dev, p_ms, p_dev, bound_ms,
                                  bound_by)
            log(f"K1 otam_dp B={B} lambda={lbda}: max abs err "
                f"{err.max().item():.3e}, max rel err {rel:.3e}, grad max "
                f"abs err {gerr:.3e}; kernel_ms {k_ms:.5f} (device "
                f"{k_dev:.5f}), plain_ms {p_ms:.4f} (device {p_dev:.4f}), "
                f"bound_ms {bound_ms:.3e} ({bound_by})")
    log("K1 library_ms: none -- no single PyTorch call computes the OTAM "
        "soft-min DP")
    k_ms, k_dev, p_ms, p_dev, bound_ms, bound_by = timings[(25, 0.5)]
    return {"name": "otam_dp (K1)", "status": "ported", "route": "cuda",
            "source": "clipspm_tpu_torch/csrc/otam_dp.cu",
            "replaces": "clipspm_tpu/ops/otam_pallas.py:54",
            "max_abs_err": worst_abs, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "device_ms": k_dev, "plain_device_ms": p_dev,
            "shape": [25, OTAM_T, OTAM_T], "lambda": 0.5}


def _sdtw_bound_ms(B: int, N: int, M: int, bandwidth: float) -> tuple:
    """Least time of one K2 launch: tables read once, results written once;
    per cell the DP computes (those in the band when ``bandwidth > 0``)
    about 20 fp32 operations (3-way soft-min: two mins, and per argument a
    subtract, divide, clamp and exp; two adds, log, scale, shift; plus the
    table value)."""
    cells = sum(1 for i in range(1, N + 1) for j in range(1, M + 1)
                if bandwidth <= 0 or abs(i - j) <= bandwidth)
    bytes_ = 4 * B * N * M + 4 * B
    ops = B * cells * 20
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_k2() -> dict:
    from clipspm_tpu_torch.ops import softdtw_cuda
    from clipspm_tpu_torch.ops.softdtw import softdtw_from_dists as plain
    from clipspm_tpu_torch.tools.k1_variants import graph_ms

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    worst_abs, worst_grad = 0.0, 0.0
    timings = {}
    for B in SDTW_BATCHES:
        for gamma in SDTW_GAMMAS:
            for bw in SDTW_BANDS:
                tables = (torch.rand(B, SDTW_N, SDTW_M, generator=gen)
                          * 2.0).to(dev)
                got = softdtw_cuda.softdtw_dp_cuda(tables, gamma, bw)
                want = plain(tables, gamma, bw)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                if not torch.allclose(got, want, rtol=TOL, atol=TOL):
                    raise AssertionError(
                        f"K2 forward disagrees at B={B} gamma={gamma} "
                        f"bandwidth={bw}: max abs {err:.3e}")
                t1 = tables.clone().requires_grad_(True)
                t2 = tables.clone().requires_grad_(True)
                w = torch.rand(B, generator=gen).to(dev)
                (softdtw_cuda.softdtw_from_dists(t1, gamma, bw)
                 * w).sum().backward()
                (plain(t2, gamma, bw) * w).sum().backward()
                gerr = (t1.grad - t2.grad).abs().max().item()
                if not torch.allclose(t1.grad, t2.grad, rtol=GRAD_TOL,
                                      atol=GRAD_TOL):
                    raise AssertionError(
                        f"K2 gradient disagrees at B={B} gamma={gamma} "
                        f"bandwidth={bw}: max abs {gerr:.3e}")
                worst_abs = max(worst_abs, err)
                worst_grad = max(worst_grad, gerr)
                k_ms = _time_ms(
                    lambda: softdtw_cuda.softdtw_dp_cuda(tables, gamma, bw))
                k_dev = graph_ms(
                    lambda: softdtw_cuda.softdtw_dp_cuda(tables, gamma, bw))
                p_ms = _time_ms(lambda: plain(tables, gamma, bw), iters=20)
                p_dev = graph_ms(lambda: plain(tables, gamma, bw), iters=20)
                bound_ms, bound_by = _sdtw_bound_ms(B, SDTW_N, SDTW_M, bw)
                timings[(B, gamma, bw)] = (k_ms, k_dev, p_ms, p_dev,
                                           bound_ms, bound_by)
                log(f"K2 softdtw_dp B={B} gamma={gamma} bandwidth={bw}: max "
                    f"abs err {err:.3e}, grad max abs err {gerr:.3e}; "
                    f"kernel_ms {k_ms:.5f} (device {k_dev:.5f}), plain_ms "
                    f"{p_ms:.4f} (device {p_dev:.4f}), bound_ms "
                    f"{bound_ms:.3e} ({bound_by})")
    # a band narrower than |N - M| prunes the corner: exactly the sentinel
    corner = softdtw_cuda.softdtw_dp_cuda(
        (torch.rand(3, SDTW_N, 4, generator=gen) * 2.0).to(dev), 0.1, 2.0)
    if not bool((corner == 1e30).all()):
        raise AssertionError(f"K2 pruned corner is not the sentinel: "
                             f"{corner.tolist()}")
    log("K2 library_ms: none -- no single PyTorch call computes the soft-DTW "
        "DP")
    k_ms, k_dev, p_ms, p_dev, bound_ms, bound_by = timings[(25, 0.1, 0.0)]
    return {"name": "softdtw_dp (K2)", "status": "ported", "route": "cuda",
            "source": "clipspm_tpu_torch/csrc/softdtw_dp.cu",
            "replaces": "clipspm_tpu/ops/softdtw_pallas.py:40",
            "max_abs_err": worst_abs, "max_abs_grad_err": worst_grad,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "device_ms": k_dev,
            "plain_device_ms": p_dev, "shape": [25, SDTW_N, SDTW_M],
            "gamma": 0.1, "bandwidth": 0.0}


# The main paths, each a shipped config at full width on random weights, a
# few hundred episodes over a synthetic split in its dataset's layout
# (frames of 256x256, 10 per video):
# - clipspm: hmdb.yaml (RN50 CLIP tower, 224 crop, T=8, 5-way 5-shot
#   1-query, bf16), 10 test classes x 12 videos; three bidirectional OTAM
#   distances per episode (6 K1 launches);
# - ta2n: ucf.yaml with MODEL.METRIC=otam (ResNet-50 trunk, 224 crop, T=8,
#   5-way 1-shot 1-query, bf16), 21 test classes x 6 videos; one
#   forward/reverse soft-DTW per episode (2 K2 launches). The table does not
#   depend on METRIC, so the card-vs-CPU head check runs both metrics.
PATHS = {
    "clipspm": dict(cfg="configs/clipspm/hmdb.yaml", opts=(),
                    frame_dir="hmdb_256x256q5_l8", split_dir="hmdb_ARN",
                    classes=10, videos=12, launches={"K1": 6, "K2": 0},
                    metrics=(None,)),
    "ta2n": dict(cfg="configs/ta2n/ucf.yaml", opts=("MODEL.METRIC=otam",),
                 frame_dir="ucf_256x256q5_l8", split_dir="ucf_ARN",
                 classes=21, videos=6, launches={"K1": 0, "K2": 2},
                 metrics=("otam", "cos")),
}
MAIN_EPISODES = 300
SPLIT_FRAMES, SPLIT_PX = 10, 256
SEQ_LEN = 8
# the head on the card (fp32, no TF32) against the head on the CPU (fp32):
# sums in another order, so 1e-4 relative and absolute on the logits
HEAD_TOL = 1e-4
KERNEL_NAMES = {"K1": "otam_dp_kernel", "K2": "softdtw_dp_kernel"}


def write_split(root: str, frame_dir: str, split_dir: str, classes: int,
                videos: int, frames: int, px: int) -> None:
    """A synthetic split in a dataset's on-disk layout (test side only):
    ``<frame_dir>/test/<class>/<vid>/NNNNN.jpg`` and
    ``splits/<split_dir>/testlist03.txt``."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    lines = []
    for c in range(classes):
        for v in range(videos):
            rel = f"class{c:02d}/v{v:03d}"
            vdir = os.path.join(root, frame_dir, "test", rel)
            os.makedirs(vdir)
            color = tuple(int(x) for x in rng.integers(0, 256, 3))
            img = Image.new("RGB", (px, px), color)
            for f in range(frames):
                img.save(os.path.join(vdir, f"{f + 1:05d}.jpg"), quality=90)
            lines.append(rel)
    sdir = os.path.join(root, "splits", split_dir)
    os.makedirs(sdir)
    with open(os.path.join(sdir, "testlist03.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")


def seeded_frames(path_lists, *args, **kwargs):
    """Stands in for ``data/pipeline.py:decode_path_lists``: uint8 frames
    of the split's geometry, seeded per frame path (so a video's frames are
    the same in every episode, as decoded JPEGs would be)."""
    import zlib

    import numpy as np

    out = np.empty((len(path_lists), len(path_lists[0]), SPLIT_PX, SPLIT_PX,
                    3), np.uint8)
    for i, clip in enumerate(path_lists):
        for t, path in enumerate(clip):
            rng = np.random.default_rng(zlib.crc32(path.encode()))
            out[i, t] = rng.integers(0, 256, out.shape[2:], dtype=np.uint8)
    return out


class _Recorder:
    """Wraps the main path's entry points to read what they built."""

    def __init__(self):
        self.learner = None
        self.table = None
        self.row_of = None

    @contextlib.contextmanager
    def installed(self):
        from clipspm_tpu_torch.train import feature_cache, setup

        build_learner = setup.build_learner
        build_table = feature_cache.FeatureCachedEvaluator.build_table
        decode = feature_cache.decode_path_lists

        def rec_build_learner(*a, **kw):
            self.learner = build_learner(*a, **kw)
            return self.learner

        def rec_build_table(ev, plans):
            self.table, self.row_of = build_table(ev, plans)
            return self.table, self.row_of

        setup.build_learner = rec_build_learner
        feature_cache.FeatureCachedEvaluator.build_table = rec_build_table
        feature_cache.decode_path_lists = seeded_frames
        try:
            yield self
        finally:
            setup.build_learner = build_learner
            feature_cache.FeatureCachedEvaluator.build_table = build_table
            feature_cache.decode_path_lists = decode


def _first_episodes(rec: _Recorder, argv, n: int) -> list:
    """The first ``n`` episodes of the main path's seeded test stream, as
    (support rows, query rows, support labels, real support labels, real
    target labels, target labels) gathered from the recorded table."""
    from clipspm_tpu_torch.cli.run import parse_args
    from clipspm_tpu_torch.train.setup import build_catalog_and_sampler
    from clipspm_tpu_torch.utils.config import load_config

    args = parse_args(argv)
    cfg = load_config(args.cfg_file, opts=args.opts,
                      splits_root=args.splits_root)
    _, sampler = build_catalog_and_sampler(cfg, "test", False,
                                           int(cfg.TEST.QUERY_PER_CLASS))
    dev = rec.table.device
    out = []
    for _ in range(n):
        p = sampler.sample()
        rows = [torch.tensor([rec.row_of[int(v)] for v in vids], device=dev)
                for vids in (p.support_video_idx, p.target_video_idx)]
        out.append((rec.table[rows[0]], rec.table[rows[1]],
                    *[torch.from_numpy(x).to(dev) for x in (
                        p.support_labels, p.real_support_labels,
                        p.real_target_labels, p.target_labels)]))
    return out


def check_head_against_cpu(rec: _Recorder, argv, metrics) -> dict:
    """The head on the card (fp32, its kernels) against the head on the CPU
    (fp32, the plain versions) over the first episodes of the same stream
    and the same table rows, once per ``MODEL.METRIC`` value in ``metrics``
    (None: the model has one); returns the max abs logit difference of
    each."""
    import copy

    learner = rec.learner
    gpu_model = learner.model
    cpu_model = copy.deepcopy(gpu_model).cpu().float()
    dtype, gpu_model.compute_dtype = gpu_model.compute_dtype, None
    cpu_model.compute_dtype = None
    metric0 = getattr(gpu_model, "metric", None)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = {}
    try:
        with torch.no_grad():
            episodes = _first_episodes(rec, argv, 2)
            for metric in metrics:
                if metric is not None:
                    gpu_model.metric = cpu_model.metric = metric
                key = metric or "logits"
                worst[key] = 0.0
                for ep in episodes:
                    outs = []
                    for model, dev in ((gpu_model, learner.device),
                                       (cpu_model, torch.device("cpu"))):
                        su, qu, *labels = [x.to(dev) for x in ep]
                        outs.append(model.match_features(
                            su.float(), qu.float(), *labels[:3],
                            learner.text_train.to(dev),
                            learner.text_test.to(dev))["logits"].cpu())
                    worst[key] = max(worst[key],
                                     (outs[0] - outs[1]).abs().max().item())
                    if not torch.allclose(outs[0], outs[1], rtol=HEAD_TOL,
                                          atol=HEAD_TOL):
                        raise AssertionError(
                            f"head on the card vs the CPU ({key}): max abs "
                            f"logit diff {worst[key]:.3e}")
    finally:
        gpu_model.compute_dtype = dtype
        if metric0 is not None:
            gpu_model.metric = metric0
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return worst


def profile_head(rec: _Recorder, argv, episodes: int = 20) -> dict:
    """Where the head's time goes: ``episodes`` head forwards of the main
    path (bf16, as evaluated) under ``torch.profiler``. Device busy time is
    the sum of the device events' durations (one stream: they do not
    overlap); wall time is under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from clipspm_tpu_torch.train.losses import loss_and_acc

    learner = rec.learner
    eps = _first_episodes(rec, argv, episodes)

    def run(ep):
        su, qu, sl, rs, rt, tl = ep
        out = learner.model.match_features(su, qu, sl, rs, rt,
                                           learner.text_train,
                                           learner.text_test)
        return loss_and_acc(learner.model_name, out, tl,
                            learner.tasks_per_batch)

    with torch.no_grad():
        for ep in eps[:2]:
            run(ep)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for ep in eps:
                run(ep)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in dev)
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = {"episodes": episodes,
           "wall_ms_per_episode": wall_us / episodes / 1e3,
           "device_busy_ms_per_episode": busy_us / episodes / 1e3,
           "device_idle_share": 1.0 - busy_us / wall_us,
           "device_ops_per_episode": len(dev) / episodes}
    for k, kname in KERNEL_NAMES.items():
        k_us = sum(t for n, t in by_name.items() if kname in n)
        out[f"{k.lower()}_device_ms_per_episode"] = k_us / episodes / 1e3
        out[f"{k.lower()}_share_of_device_busy"] = (k_us / busy_us
                                                    if busy_us else None)
    out["top_device_ms_per_episode"] = [[n[:60], t / episodes / 1e3]
                                        for n, t in top]
    return out


def phase_main_path(name: str, device: str = "cuda", extra_opts=(),
                    episodes: int = MAIN_EPISODES) -> dict:
    import gc

    from clipspm_tpu_torch.cli.run import main as cli_main
    from clipspm_tpu_torch.ops import otam_cuda, softdtw_cuda

    spec = PATHS[name]
    log(f"main path {name}: frames come from a seeded uint8 source right "
        "after the decode stage, in place of the JPEG decode; the disk decode "
        "(native/frame_decoder.cc, which needs libjpeg, or PIL) is held "
        "against the JAX package by the CPU tests")
    on_gpu = torch.device(device).type == "cuda"
    counters = {"K1": otam_cuda, "K2": softdtw_cuda}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_split(root, spec["frame_dir"], spec["split_dir"],
                    spec["classes"], spec["videos"], SPLIT_FRAMES, SPLIT_PX)
        log(f"main path {name}: wrote {spec['classes'] * spec['videos']} "
            f"videos in {time.perf_counter() - t0:.1f} s")
        argv = ["--cfg", spec["cfg"], "--splits-root", root,
                "--allow-random-weights", "--device", device,
                "TEST.ONLY_TEST=true", f"TEST.TEST_EPISODES={episodes}",
                f"DATA.DATA_DIR={root}",
                f"CHECKPOINT.CHECKPOINT_DIR={os.path.join(root, 'ckpt')}",
                *spec["opts"], *extra_opts]
        rec = _Recorder()
        if on_gpu:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        with rec.installed():
            for mod in counters.values():
                mod.launches = 0
            t0 = time.perf_counter()
            res = cli_main(argv)
            wall = time.perf_counter() - t0
            launches = {k: mod.launches for k, mod in counters.items()}
        peak = torch.cuda.max_memory_allocated() if on_gpu else 0
        head_err = check_head_against_cpu(rec, argv, spec["metrics"])
        head_profile = profile_head(rec, argv) if on_gpu else None

    V = res["unique_videos"]
    for k, per_episode in spec["launches"].items():
        expect = per_episode * episodes if on_gpu else 0
        if launches[k] != expect:
            raise AssertionError(f"{k} launched {launches[k]} times on the "
                                 f"{name} path; expected {expect}")
    for key in ("accuracy", "confidence", "loss"):
        if not math.isfinite(res[key]):
            raise AssertionError(f"{name} path {key} is not finite: {res}")
    model = rec.learner.model
    tail = ((7, 7, model.dim) if name == "ta2n"
            else (model.arch.embed_dim,))
    want_shape = (V, SEQ_LEN) + tail
    if tuple(rec.table.shape) != want_shape or not bool(
            torch.isfinite(rec.table).all()):
        raise AssertionError(f"feature table {tuple(rec.table.shape)} is not "
                             f"a finite {list(want_shape)}")
    out = {"path": name, "episodes": episodes, "unique_videos": V,
           "table_shape": list(rec.table.shape),
           "table_dtype": str(rec.table.dtype),
           "accuracy": res["accuracy"], "confidence": res["confidence"],
           "loss": res["loss"], "launches": launches,
           "encode_frames_per_s": V * SEQ_LEN / res["encode_seconds"],
           "head_episodes_per_s": episodes / res["head_seconds"],
           "encode_seconds": res["encode_seconds"],
           "head_seconds": res["head_seconds"], "cli_seconds": wall,
           "build_seconds": rec.learner.build_seconds,
           "peak_memory_bytes": peak,
           "head_vs_cpu_max_abs_logit_diff": head_err,
           "head_vs_cpu_tol": HEAD_TOL}
    log(json.dumps({"main_path": out}))
    log(json.dumps({"head_profile": {"path": name, **(head_profile or {})}}))
    return out


def main() -> int:
    device = phase_device()
    phase_build()
    k1 = phase_kernels()
    k2 = phase_k2()
    clipspm = phase_main_path("clipspm")
    ta2n = phase_main_path("ta2n")
    k1["launches"] = clipspm["launches"]["K1"]
    k2["launches"] = ta2n["launches"]["K2"]
    log(json.dumps({"kernels": [k1, k2]}))
    log(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
