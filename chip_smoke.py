"""Chip smoke test of the PyTorch / CUDA port (``clipspm_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit:

1. device: a CUDA device must be visible; prints the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build: compiles every CUDA source of the port (one ``nvcc`` per source,
   all started together), prints the build seconds and what ``ptxas -v``
   says of each kernel (registers, spills);
3. kernels against their plain PyTorch versions on the card, forward and
   gradient, at the main paths' shapes and the widest tables, with eager
   and CUDA-graph timings from CUDA events: K1 (OTAM DP) and K2 (soft-DTW
   DP), each in table mode and in fused mode (cosine table and both DP
   directions in one launch), the fused modes also against the op chain
   each launch replaces; K1 also at cpm2c's motion stream (L=7) and at the
   otam head's D=2048, lambda 0.1;
   quant: MODEL.INT8_EVAL's int8 GEMM (``torch._int_mm``) at ViT-B/16's
   four projection shapes, its int32 sums bit-equal to the plain float64
   product, timed beside the bf16 matmul; a refused shape raises; the
   bf16 BatchNorm of MODEL.BF16_NORMS on the card against the CPU;
4. the main paths at full width, each through the port's CLI on random
   weights over a synthetic split, with every kernel launch counter set to
   0 just before the path and read just after:
   - clipspm: CLIP-SPM RN50 (224 crop, T=8, 5-way 5-shot, bf16)
     feature-cached evaluation over an HMDB-layout split (K1's fused
     mode, 3 launches per episode);
   - ta2n: TA2N on a torchvision ResNet-50 (224 crop, T=8, 5-way 1-shot,
     bf16) with ``MODEL.METRIC=otam``, feature-cached evaluation over a
     UCF-layout split (K2's fused mode, 1 launch per episode);
   - clipspm-vit: the same on the ViT-B/16 tower (feature width 512),
     whose fp32 features on the card are also held against the CPU's;
     clipspm-vit-switched: the same with MODEL.INT8_EVAL, FAST_SOFTMAX and
     BF16_NORMS (30 episodes; every block's four projections through the
     int8 GEMM);
   - clipfsar, cpm2c (HMDB layout, RN50, 5-way 1-shot, bf16; 1 and 2 K1
     launches per episode, cpm2c's second at L=7) and sten (UCF layout; no
     kernel): feature-cached evaluation, each head's fp32 logits on the
     card held against the CPU's;
   - otam, trx, strm: the torchvision ResNet-50 heads (UCF layout, 5-way
     1-shot, bf16), feature-cached evaluation (otam: 1 K1 launch per
     episode at D=2048, lambda 0.1; trx, strm: none), each head's fp32
     logits on the card held against the CPU's;
   - clipspm-uncached and clipspm-vit-uncached: the clipspm and clipspm-vit
     paths with ``TEST.CACHE_FEATURES=false``, the uncached evaluator at
     ``TEST.EVAL_BATCH`` 32 episodes a step over the test EpisodeLoader (3
     K1 launches per episode); soap-uncached and molo-uncached, the two
     heads that only the uncached evaluator serves (no kernel), each
     model's fp32 logits over one episode on the card held against the
     CPU's; then the same 8 episodes of clipspm through the uncached and
     the cached evaluator at fp32, whose losses and accuracies must agree;
   - extras: the JAX package's last modules. cpm2c-extras, cpm2c RN50
     with the visual prompts and the video adapter (built directly, as no
     config sets them) over SyntheticEpisodeSource streams: the cached
     route's loud fallback, 32 uncached episodes in one step of 32 and one
     8-episode AMP train step (K1's fused mode, 2 launches per episode,
     held against the plain version on the path's inputs), the model's
     fp32 outputs and the head's gradients on the card against the CPU;
     the temporal ResNet-50 in both modes on 40 frames (eval forward, and
     a train-mode forward and backward against the CPU and an fp64
     witness); each module of models/blocks_extra.py at D=2048;
   - clipspm-train and clipspm-vit-train: CLIP-SPM training on the RN50 and
     the ViT-B/16 towers (5-way 5-shot 4-query, 16 episodes an Adam step,
     bf16; the ViT in rematerialised chunks of 40 frames keeping the
     attention outputs) over an HMDB-layout train split, one cached
     validation, checkpoints, then an ONLY_TEST run from
     ``checkpoint_best`` (K1's fused mode, 3 launches per episode; K2
     none);
   - ta2n-train: TA2N training with ``MODEL.METRIC=otam`` (5-way 1-shot
     4-query, SGD, bf16) over a UCF-layout train split, the same stages
     (K2's fused mode, 1 launch per episode, its backward the plain
     version's replay in fp32; K1 none);
   - clipfsar-train (cached validation, 1 K1 launch per episode) and
     cpm2c-train (uncached validation and test, 2 K1 launches per episode):
     clipfsar/hmdb.yaml and cpm2c/hmdb.yaml training (5-way 1-shot 4-query,
     Adam, bf16), the same stages;
   - otam-train (otam/ucf.yaml, SGD, cached validation, 1 K1 launch per
     episode, Q=20 in training) and molo-train (molo/ucf.yaml, Adam, steps
     of 4, the decoder's BatchNorm in training mode, uncached validation
     and test; no kernel), the same stages;
   each train path also profiles one optimizer step (clipspm-vit-train
   also times a step and reads the peak memory under each of the five
   remat policies); the clipspm and ta2n ones hold one fp32 train step on
   the card and on the CPU against an fp64 step on the CPU, the other
   heads' hold the head's fp32 gradients (and its inputs') on the card
   against the CPU's (molo's also in fp64 on the card against the CPU's
   fp64);
   - sten-train, trx-train, strm-train and soap-train: the four heads with
     no kernel (sten/ucf.yaml on the CLIP RN50 tower, trx, strm and
     soap/ucf.yaml on the torchvision ResNet-50; UCF layout, 5-way 1-shot
     4-query, bf16), two 4-episode optimizer steps through the CLI with a
     4-episode validation between them (soap's uncached), step seconds
     and peak memory, and the head's fp32 gradients on the card against
     the CPU's (K1 and K2: no launch);
   - clipspm-vit-train-attn and clipspm-vit-train-mlp: clipspm-vit-train
     under MODEL.TRAIN_REMAT_POLICY attn and mlp, one 4-episode Adam step
     through the CLI (3 K1 launches an episode), then one fp32 step's
     gradients on the card under the policy against "full"'s;
5. ddp: DEVICE.NUM_CHIPS episode parallelism. Two ranks share cuda:0 over
   gloo (NCCL refuses two ranks on one device), each a process of its own,
   held against the single-process oracle (parallel_episodes=2, its own
   process, run first): clipspm-vit-train and ta2n-train (an 8-episode and
   a masked 4-episode step at fp32, TF32 off: each episode's loss, the
   parameters and every BatchNorm buffer after each step, K1/K2 launches
   over the ranks; then an AMP step timed at N=2 on one card beside N=1,
   the all-reduces' seconds, each process's peak memory) and clipspm RN50
   evaluation (the uncached evaluator's per-episode results and the
   feature-cached evaluator's gathered table, accuracy and CI at N=2 equal
   to N=1's); with one card the CLI's refusal of DEVICE.NUM_CHIPS=2, with
   two or more the train paths and ONLY_TEST through the CLI at
   NUM_CHIPS=2 over NCCL against 1;
6. tp: DEVICE.TP Megatron tensor parallelism, on phase ddp's splits and
   against its oracle's process: clipspm-vit-train at dp=2 x tp=2, four
   ranks sharing cuda:0 over gloo, one 4-episode step (two microsteps)
   at fp32 with TF32 off (each episode's loss, the gathered parameters
   and Adam moments against the same step in the oracle's process, the
   replicated gradients across the tp ranks before the broadcast from tp
   rank 0 and the replicated parameters bit-identical after it, 6 K1
   launches on each rank, each rank's peak memory and the tp
   all-reduces' seconds), and
   clipspm RN50 uncached evaluation at dp=1 x tp=2 against one process at
   fp32 (each episode's loss and accuracy);
   with one card the CLI's refusal of DEVICE.TP=2, with two or more the
   train path through the CLI at TP=2 over NCCL against 1;
7. convergence: clipspm_tpu_torch/tools/train_convergence.py's steps in
   this process: its JPEG dataset written to disk at the production
   geometry (in a thread beside phases ddp and tp), CLIP-SPM RN50 trained
   from random weights through the CLI (one 16-episode step), frames
   decoded from disk by the port's loaders (which decoder ran is
   printed), three ONLY_TEST restores of 8 episodes at fp32 (the two
   uncached and the cached one must agree), 3 K1 launches an episode in
   training and in every evaluation, and the tool's JSON keys against the
   JAX tool's.

It prints a ``{"kernels": [...]}`` line and, last, the device line
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

# every CUDA source under clipspm_tpu_torch/csrc/
SOURCES = ("otam_dp", "softdtw_dp")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and fp32
# non-tensor-core FLOP/s; the DPs' exp/log/div arithmetic is fp32 SIMT.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12

OTAM_LAMBDAS = (0.5, 0.1)
# K1's table mode: main-path-sized batches of [8, 8] tables (class
# prototypes and task prototypes, Q*way = 5*5; task tokens, 1*way; 1600 = 64
# episodes x 25 pairs), plus the widest table it takes (Ms + 2 = 34)
OTAM_TABLES = ((25, 8, 8), (5, 8, 8), (1600, 8, 8), (25, 8, 32))
# K1's fused mode: (Q, S, L, D, bidirectional, lambda); the first is the
# clipspm head's class and task distances in evaluation (RN50 width 1024,
# L = T = 8, 5 queries; clipfsar's and cpm2c's appearance distance too), then
# its task tokens (Q=1), single direction, a width that is not a multiple of
# 4 (4-byte copies), the otam head's lambda, and the class and task
# distances in training (4 queries a class: Q=20); then the same three
# shapes at the ViT-B/16 tower's width 512; then cpm2c's motion distance
# (one frame fewer: L=7) in evaluation and in training; last the otam head's
# distance (ResNet-50 width 2048, lambda 0.1) in evaluation and in training
OTAM_FUSED = ((5, 5, 8, 1024, True, 0.5), (5, 5, 8, 1024, False, 0.5),
              (1, 5, 8, 1024, True, 0.5), (1, 5, 8, 1024, False, 0.5),
              (5, 5, 8, 1021, True, 0.5), (5, 5, 8, 1024, True, 0.1),
              (20, 5, 8, 1024, True, 0.5), (5, 5, 8, 512, True, 0.5),
              (1, 5, 8, 512, True, 0.5), (20, 5, 8, 512, True, 0.5),
              (5, 5, 7, 1024, True, 0.5), (20, 5, 7, 1024, True, 0.5),
              (5, 5, 8, 2048, True, 0.1), (20, 5, 8, 2048, True, 0.1))
OTAM_T = 8
TOL = 2e-5   # fp32 table mode: the same soft-min, rounded in another order
# fp32 fused modes: 1024- and 2048-long dot products summed in another order
# than cuBLAS (a few ulps of each table entry), carried through up to 17
# soft-min steps
FUSED_TOL = 1e-4
GRAD_TOL = 2e-4

# K2's table mode: the TA2N head's way*Q = 25 padded tables [T+2, T], 5 and
# 1600 as for K1, plus the widest table it takes (M = 32); gamma 0.1 is the
# head's, 1.0 the function's default
SDTW_TABLES = ((25, 10, 8), (5, 10, 8), (1600, 10, 8), (25, 10, 32))
SDTW_GAMMAS = (0.1, 1.0)
SDTW_BANDS = (0.0, 2.0)
# K2's fused mode: B pairs of [8, 2048] ResNet-50 sequences (the head's 25
# in evaluation, 5 ways x 20 queries = 100 in training)
SDTW_FUSED_B = (25, 100, 1600)
SDTW_T, SDTW_D = 8, 2048


def log(msg: str) -> None:
    print(msg, flush=True)


# the card's name and power limit as nvidia-smi reports them (phase_device),
# written beside the measurements of the int8 GEMM and the remat policies
CARD = None


def phase_device() -> dict:
    global CARD
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    CARD = smi
    # fp32 matmuls in full fp32 (PyTorch's default, stated): the plain
    # versions' cosine tables are held against the kernels' FMA dot products
    torch.backends.cuda.matmul.allow_tf32 = False
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    from clipspm_tpu_torch.ops import build

    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        paths = list(pool.map(build.build, SOURCES))
    log(f"build: {len(paths)} CUDA source(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    for path in paths:
        with open(f"{path}.ptxas.txt") as f:
            for line in f:
                if "Used" in line or "spill" in line or "Function" in line:
                    log(f"ptxas {os.path.basename(path)}: {line.strip()}")


def _bound(bytes_: float, ops: float) -> tuple:
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _otam_dp_ops(B: int, L: int, Ms: int) -> int:
    """fp32 operations of B OTAM DPs: row 0 one add per cell; per written
    cell about 15 (soft-min: subtract, scale, clamp and exp per argument, a
    sum, log, scale, shift, plus the table value)."""
    return B * (Ms + (L - 1) * (Ms + 1) * 15)


def _otam_bound_ms(B: int, L: int, Ms: int) -> tuple:
    """Least time of one table-mode launch: tables read once, results
    written once, and the DP's operations."""
    return _bound(4 * B * L * Ms + 4 * B, _otam_dp_ops(B, L, Ms))


def _otam_fused_bound_ms(Q: int, S: int, L: int, D: int,
                         bidirectional: bool) -> tuple:
    """Least time of one fused launch: each feature byte read once, each
    result written once; the gram's 2 * pairs * L^2 * D FLOPs, the norms
    of each frame vector once (2 * D each), and the DPs'."""
    ops = (2 * Q * S * L * L * D + 2 * (Q + S) * L * D
           + _otam_dp_ops(Q * S, L, L) * (2 if bidirectional else 1))
    return _bound(4 * (Q + S) * L * D + 4 * Q * S, ops)


def _sdtw_cells(N: int, M: int, bandwidth: float) -> int:
    return sum(1 for i in range(1, N + 1) for j in range(1, M + 1)
               if bandwidth <= 0 or abs(i - j) <= bandwidth)


def _sdtw_bound_ms(B: int, N: int, M: int, bandwidth: float) -> tuple:
    """Least time of one table-mode launch: tables read once, results
    written once; per DP cell in the band about 20 fp32 operations (3-way
    soft-min: two mins, and per argument a subtract, scale, clamp and exp;
    two adds, log, scale, shift; plus the table value)."""
    return _bound(4 * B * N * M + 4 * B,
                  B * _sdtw_cells(N, M, bandwidth) * 20)


def _sdtw_fused_bound_ms(B: int, T: int, D: int, bandwidth: float) -> tuple:
    """Least time of one fused launch: each feature byte read once, each
    result written once; the gram's 2 * B * T^2 * D FLOPs, each vector's
    norm once, and both padded DPs' cells."""
    ops = (2 * B * T * T * D + 2 * B * 2 * T * D
           + 2 * B * _sdtw_cells(T + 2, T, bandwidth) * 20)
    return _bound(4 * B * 2 * T * D + 4 * B, ops)


def _check_close(what: str, got, want, tol: float) -> float:
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        raise AssertionError(f"{what} disagrees with its plain version: max "
                             f"abs {err:.3e} (tolerance {tol})")
    return err


def _check_grads(what: str, kernel_fn, plain_fn, inputs, gen) -> float:
    """Gradients of a random weighting of the outputs, through the
    autograd.Function of a kernel entry and through plain autograd."""
    ks = [x.clone().requires_grad_(True) for x in inputs]
    ps = [x.clone().requires_grad_(True) for x in inputs]
    out_k = kernel_fn(*ks)
    w = torch.rand(out_k.shape, generator=gen).to(out_k.device)
    (out_k * w).sum().backward()
    (plain_fn(*ps) * w).sum().backward()
    worst = 0.0
    for k, p in zip(ks, ps):
        worst = max(worst, (k.grad - p.grad).abs().max().item())
        if not torch.allclose(k.grad, p.grad, rtol=GRAD_TOL, atol=GRAD_TOL):
            raise AssertionError(f"{what} gradient disagrees: max abs "
                                 f"{worst:.3e}")
    return worst


def _times(fn, iters: int = 50) -> tuple:
    """(eager ms, CUDA-graph device ms) per call."""
    from clipspm_tpu_torch.tools.timing import eager_ms, graph_ms

    return eager_ms(fn, iters), graph_ms(fn, iters)


def phase_k1() -> dict:
    from clipspm_tpu_torch.ops import otam_cuda
    from clipspm_tpu_torch.ops.otam import frame_distance_cos
    from clipspm_tpu_torch.ops.otam import otam_cum_dist as plain
    from clipspm_tpu_torch.ops.otam import otam_distance_plain

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    worst, worst_grad = 0.0, 0.0
    table, fused = {}, {}
    for B, L, Ms in OTAM_TABLES:
        for lbda in OTAM_LAMBDAS:
            tables = (torch.rand(B, L, Ms, generator=gen) * 2.0).to(dev)
            what = f"K1 table mode [{B}, {L}, {Ms}] lambda={lbda}"
            err = _check_close(what, otam_cuda.otam_dp_cuda(tables, lbda),
                               plain(tables, lbda), TOL)
            gerr = _check_grads(what, lambda t: otam_cuda.otam_cum_dist(
                t, lbda), lambda t: plain(t, lbda), [tables], gen)
            worst, worst_grad = max(worst, err), max(worst_grad, gerr)
            k_ms, k_dev = _times(lambda: otam_cuda.otam_dp_cuda(tables, lbda))
            p_ms, p_dev = _times(lambda: plain(tables, lbda), iters=20)
            bound_ms, bound_by = _otam_bound_ms(B, L, Ms)
            table[(B, L, Ms, lbda)] = dict(
                ms=k_ms, device_ms=k_dev, plain_ms=p_ms, plain_device_ms=p_dev,
                bound_ms=bound_ms, bound_by=bound_by)
            log(f"{what}: max abs err {err:.3e}, grad max abs err "
                f"{gerr:.3e}; kernel_ms {k_ms:.5f} (device {k_dev:.5f}), "
                f"plain_ms {p_ms:.4f} (device {p_dev:.4f}), bound_ms "
                f"{bound_ms:.3e} ({bound_by})")
    for Q, S, L, D, bidir, lbda in OTAM_FUSED:
        sup = torch.randn(S, L, D, generator=gen).to(dev)
        qry = torch.randn(Q, L, D, generator=gen).to(dev)
        what = (f"K1 fused mode Q={Q} S={S} L={L} D={D} bidirectional="
                f"{bidir} lambda={lbda}")
        err = _check_close(
            what, otam_cuda.otam_distance_cuda(sup, qry, lbda, bidir, 0.01),
            otam_distance_plain(sup, qry, lbda, bidir), FUSED_TOL)
        gerr = _check_grads(
            what, lambda s, q: otam_cuda.otam_distance(s, q, lbda, bidir),
            lambda s, q: otam_distance_plain(s, q, lbda, bidir), [sup, qry],
            gen)
        worst, worst_grad = max(worst, err), max(worst_grad, gerr)

        def chain():
            # what the fused launch replaces: the cosine ops, the copies
            # and the table-mode launches
            t = frame_distance_cos(qry, sup)
            out = otam_cuda.otam_dp_cuda(t.reshape(-1, L, L).contiguous(),
                                         lbda)
            if bidir:
                out = out + otam_cuda.otam_dp_cuda(
                    t.transpose(-2, -1).reshape(-1, L, L).contiguous(), lbda)
            return out.reshape(Q, S)

        k_ms, k_dev = _times(lambda: otam_cuda.otam_distance_cuda(
            sup, qry, lbda, bidir, 0.01))
        c_ms, c_dev = _times(chain)
        p_ms, p_dev = _times(lambda: otam_distance_plain(sup, qry, lbda,
                                                         bidir), iters=20)
        bound_ms, bound_by = _otam_fused_bound_ms(Q, S, L, D, bidir)
        fused[(Q, S, L, D, bidir, lbda)] = dict(
            ms=k_ms, device_ms=k_dev, replaced_chain_ms=c_ms,
            replaced_chain_device_ms=c_dev, plain_ms=p_ms,
            plain_device_ms=p_dev, bound_ms=bound_ms, bound_by=bound_by)
        log(f"{what}: max abs err {err:.3e}, grad max abs err {gerr:.3e}; "
            f"kernel_ms {k_ms:.5f} (device {k_dev:.5f}), replaced chain "
            f"(cosine ops + table-mode launches) {c_ms:.5f} (device "
            f"{c_dev:.5f}), plain_ms {p_ms:.4f} (device {p_dev:.4f}), "
            f"bound_ms {bound_ms:.3e} ({bound_by})")
        if k_ms >= c_ms or k_dev >= c_dev:
            raise AssertionError(f"{what}: the fused launch is not faster "
                                 f"than the chain it replaces")
    log("K1 library_ms: none -- no single PyTorch call computes the OTAM "
        "soft-min DP")
    main = fused[(5, 5, 8, 1024, True, 0.5)]

    def shapes(qs, L, D, lbda=0.5):
        return {f"Q={q} S=5 L={L} D={D} bidirectional lambda={lbda}": {
            "library_ms": None, **fused[(q, 5, L, D, True, lbda)]}
            for q in qs}
    return {"name": "otam_dp (K1)", "status": "ported", "route": "cuda",
            "source": "clipspm_tpu_torch/csrc/otam_dp.cu",
            "replaces": "clipspm_tpu/ops/otam_pallas.py:54",
            "max_abs_err": worst, "max_abs_grad_err": worst_grad,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "fused": {"shape": "Q=5 S=5 L=8 D=1024 bidirectional lambda=0.5",
                      **main},
            "train_shapes": shapes((20, 1), 8, 1024),
            "vit_shapes": shapes((5, 1, 20), 8, 512),
            "motion_shapes": shapes((5, 20), 7, 1024),
            "otam_head_shapes": shapes((5, 20), 8, 2048, 0.1),
            "table": {"shape": [25, OTAM_T, OTAM_T], "lambda": 0.5,
                      **table[(25, OTAM_T, OTAM_T, 0.5)]}}


def phase_k2() -> dict:
    from clipspm_tpu_torch.ops import softdtw_cuda
    from clipspm_tpu_torch.ops.softdtw import pairwise_cos_dist
    from clipspm_tpu_torch.ops.softdtw import softdtw_cos_padded_plain
    from clipspm_tpu_torch.ops.softdtw import softdtw_from_dists as plain

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    worst, worst_grad = 0.0, 0.0
    table, fused = {}, {}
    for B, N, M in SDTW_TABLES:
        for gamma in SDTW_GAMMAS:
            for bw in SDTW_BANDS:
                tables = (torch.rand(B, N, M, generator=gen) * 2.0).to(dev)
                what = (f"K2 table mode [{B}, {N}, {M}] gamma={gamma} "
                        f"bandwidth={bw}")
                err = _check_close(
                    what, softdtw_cuda.softdtw_dp_cuda(tables, gamma, bw),
                    plain(tables, gamma, bw), TOL)
                gerr = _check_grads(
                    what, lambda t: softdtw_cuda.softdtw_from_dists(
                        t, gamma, bw), lambda t: plain(t, gamma, bw),
                    [tables], gen)
                worst, worst_grad = max(worst, err), max(worst_grad, gerr)
                k_ms, k_dev = _times(
                    lambda: softdtw_cuda.softdtw_dp_cuda(tables, gamma, bw))
                p_ms, p_dev = _times(lambda: plain(tables, gamma, bw),
                                     iters=20)
                bound_ms, bound_by = _sdtw_bound_ms(B, N, M, bw)
                table[(B, N, M, gamma, bw)] = dict(
                    ms=k_ms, device_ms=k_dev, plain_ms=p_ms,
                    plain_device_ms=p_dev, bound_ms=bound_ms,
                    bound_by=bound_by)
                log(f"{what}: max abs err {err:.3e}, grad max abs err "
                    f"{gerr:.3e}; kernel_ms {k_ms:.5f} (device {k_dev:.5f}), "
                    f"plain_ms {p_ms:.4f} (device {p_dev:.4f}), bound_ms "
                    f"{bound_ms:.3e} ({bound_by})")
    # a band narrower than |N - M| prunes the corner: exactly the sentinel
    corner = softdtw_cuda.softdtw_dp_cuda(
        (torch.rand(3, 10, 4, generator=gen) * 2.0).to(dev), 0.1, 2.0)
    if not bool((corner == 1e30).all()):
        raise AssertionError(f"K2 pruned corner is not the sentinel: "
                             f"{corner.tolist()}")
    T, D = SDTW_T, SDTW_D
    for B in SDTW_FUSED_B:
        x = torch.randn(B, T, D, generator=gen).to(dev)
        y = torch.randn(B, T, D, generator=gen).to(dev)
        for gamma in SDTW_GAMMAS:
            for bw in SDTW_BANDS:
                what = (f"K2 fused mode B={B} N=M={T} D={D} gamma={gamma} "
                        f"bandwidth={bw}")
                err = _check_close(
                    what, softdtw_cuda.softdtw_cos_padded_cuda(x, y, gamma,
                                                               bw),
                    softdtw_cos_padded_plain(x, y, gamma, bw), FUSED_TOL)
                gerr = _check_grads(
                    what, lambda a, b: softdtw_cuda.softdtw_cos_padded(
                        a, b, gamma, bw),
                    lambda a, b: softdtw_cos_padded_plain(a, b, gamma, bw),
                    [x, y], gen)
                worst, worst_grad = max(worst, err), max(worst_grad, gerr)

                def chain():
                    # what the fused launch replaces: the cosine ops, the
                    # pads and the table-mode launches
                    def padded(a, b):
                        return softdtw_cuda.softdtw_dp_cuda(
                            F.pad(pairwise_cos_dist(a, b), (0, 0, 1, 1))
                            .contiguous(), gamma, bw)
                    return 0.5 * (padded(x, y) + padded(y, x))

                k_ms, k_dev = _times(lambda: softdtw_cuda
                                     .softdtw_cos_padded_cuda(x, y, gamma,
                                                              bw))
                c_ms, c_dev = _times(chain)
                p_ms, p_dev = _times(lambda: softdtw_cos_padded_plain(
                    x, y, gamma, bw), iters=20)
                bound_ms, bound_by = _sdtw_fused_bound_ms(B, T, D, bw)
                fused[(B, gamma, bw)] = dict(
                    ms=k_ms, device_ms=k_dev, replaced_chain_ms=c_ms,
                    replaced_chain_device_ms=c_dev, plain_ms=p_ms,
                    plain_device_ms=p_dev, bound_ms=bound_ms,
                    bound_by=bound_by)
                log(f"{what}: max abs err {err:.3e}, grad max abs err "
                    f"{gerr:.3e}; kernel_ms {k_ms:.5f} (device {k_dev:.5f}), "
                    f"replaced chain (cosine ops + pads + table-mode "
                    f"launches) {c_ms:.5f} (device {c_dev:.5f}), plain_ms "
                    f"{p_ms:.4f} (device {p_dev:.4f}), bound_ms "
                    f"{bound_ms:.3e} ({bound_by})")
                if k_ms >= c_ms or k_dev >= c_dev:
                    raise AssertionError(f"{what}: the fused launch is not "
                                         f"faster than the chain it replaces")
    log("K2 library_ms: none -- no single PyTorch call computes the soft-DTW "
        "DP")
    main = fused[(25, 0.1, 0.0)]
    return {"name": "softdtw_dp (K2)", "status": "ported", "route": "cuda",
            "source": "clipspm_tpu_torch/csrc/softdtw_dp.cu",
            "replaces": "clipspm_tpu/ops/softdtw_pallas.py:40",
            "max_abs_err": worst, "max_abs_grad_err": worst_grad,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "fused": {"shape": f"B=25 N=M={T} D={D} gamma=0.1 bandwidth=0",
                      **main},
            "train_shape": {
                "shape": f"B=100 N=M={T} D={D} gamma=0.1 bandwidth=0",
                "library_ms": None, **fused[(100, 0.1, 0.0)]},
            "table": {"shape": [25, 10, 8], "gamma": 0.1, "bandwidth": 0.0,
                      **table[(25, 10, 8, 0.1, 0.0)]}}


# The int8 GEMM of MODEL.INT8_EVAL (ops/quant.py: torch._int_mm, cuBLASLt's
# int8 tensor-core product; no hand kernel, as the JAX package leaves this
# product to XLA) at ViT-B/16's four projection shapes in the eval encode:
# rows = one eval chunk of 30 frames x 197 tokens, K -> N of in_proj,
# out_proj, c_fc and c_proj. Its int32 sums must equal the plain version's
# (the codes multiplied in float64, exact) bit for bit; timed beside the
# same-shape bf16 matmul, and the whole dynamic-int8 projection (both
# quantisations, the GEMM, the rescale) beside the bf16 F.linear.
QUANT_ROWS = 30 * 197
QUANT_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768))


def phase_quant() -> dict:
    from clipspm_tpu_torch.ops import quant
    from clipspm_tpu_torch.tools.timing import eager_ms, graph_ms

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(9)
    out = {"card": CARD, "rows": QUANT_ROWS, "shapes": []}
    for K, N in QUANT_SHAPES:
        a = torch.randint(-127, 128, (QUANT_ROWS, K), generator=gen,
                          dtype=torch.int8).to(dev)
        b = torch.randint(-127, 128, (N, K), generator=gen,
                          dtype=torch.int8).to(dev)
        before = quant.launches
        got = quant.int8_mm(a, b)
        if quant.launches != before + 1 or got.dtype != torch.int32:
            raise AssertionError(f"int8 GEMM [{QUANT_ROWS}, {K}] x [{K}, "
                                 f"{N}] did not run as one int32 launch")
        want = quant.int8_mm_plain(a, b)
        if not torch.equal(got, want):
            diff = (got.long() - want.long()).abs().max().item()
            raise AssertionError(f"int8 GEMM [{QUANT_ROWS}, {K}] x [{K}, "
                                 f"{N}]: int32 sums differ from the plain "
                                 f"float64 product by up to {diff}")
        x = torch.randn(QUANT_ROWS, K, generator=gen).to(dev, torch.bfloat16)
        w = (torch.randn(N, K, generator=gen) * K ** -0.5).to(dev)
        bias = torch.randn(N, generator=gen).to(dev)
        wb, bb = w.to(torch.bfloat16), bias.to(torch.bfloat16)
        # the whole int8 projection on the same fp32 inputs, card vs CPU:
        # the same IEEE elementwise steps around an exact product
        xf = torch.randn(QUANT_ROWS, K, generator=gen).to(dev)
        lin_err = check_int8_projection(xf, w, bias,
                                        quant.int8_linear(xf, w, bias))
        row = {"K": K, "N": N, "int32_sums": "bit-equal to float64",
               "int8_linear_vs_cpu_max_abs_diff": lin_err,
               "int8_gemm_ms": eager_ms(lambda: quant.int8_mm(a, b), 50),
               "int8_gemm_device_ms": graph_ms(lambda: quant.int8_mm(a, b),
                                               50),
               "bf16_matmul_ms": eager_ms(lambda: torch.matmul(
                   x, wb.t()), 50),
               "bf16_matmul_device_ms": graph_ms(lambda: torch.matmul(
                   x, wb.t()), 50),
               "int8_linear_ms": eager_ms(lambda: quant.int8_linear(
                   x, w, bias), 50),
               "bf16_linear_ms": eager_ms(lambda: F.linear(x, wb, bb), 50)}
        ops = 2.0 * QUANT_ROWS * K * N
        row["int8_gemm_tops"] = ops / row["int8_gemm_device_ms"] / 1e9
        row["bf16_matmul_tflops"] = ops / row["bf16_matmul_device_ms"] / 1e9
        log(f"int8 GEMM [{QUANT_ROWS}, {K}] x [{K}, {N}]: int32 sums "
            f"bit-equal to the float64 product; {row['int8_gemm_ms']:.4f} ms "
            f"(device {row['int8_gemm_device_ms']:.4f}) against bf16 "
            f"matmul {row['bf16_matmul_ms']:.4f} ms (device "
            f"{row['bf16_matmul_device_ms']:.4f}); whole int8 projection "
            f"{row['int8_linear_ms']:.4f} ms against bf16 F.linear "
            f"{row['bf16_linear_ms']:.4f}")
        out["shapes"].append(row)
    # a shape the int8 GEMM refuses (16 rows) raises: no float fallback
    a = torch.ones(16, 64, dtype=torch.int8, device=dev)
    try:
        quant.int8_mm(a, a)
    except RuntimeError as e:
        out["refused_16_rows"] = str(e).splitlines()[0][:120]
    else:
        raise AssertionError("the int8 GEMM took 16 rows without raising")
    out["bf16_batchnorm"] = check_bf16_batchnorm()
    log(json.dumps({"quant": out}))
    return out


def check_bf16_batchnorm() -> dict:
    """MODEL.BF16_NORMS' BatchNorm (``FP32BatchNorm2d(fp32=False)``) on the
    card takes bf16 input with fp32 statistics and parameters and returns
    bf16, in evaluation and in training, as on the CPU: outputs within 2
    bf16 ulps of the largest, running variance (flax's biased fold) within
    1e-5 relative."""
    from clipspm_tpu_torch.models.backbones.clip import FP32BatchNorm2d

    gen = torch.Generator().manual_seed(10)
    x = torch.randn(8, 256, 14, 14, generator=gen).to(torch.bfloat16)
    bn = FP32BatchNorm2d(256, fp32=False)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(256, generator=gen) + 0.5)
        bn.bias.copy_(torch.randn(256, generator=gen))
    out = {}
    for mode in ("eval", "train"):
        cpu, card = bn, FP32BatchNorm2d(256, fp32=False).cuda()
        card.load_state_dict(bn.state_dict())
        cpu.train(mode == "train")
        card.train(mode == "train")
        with torch.no_grad():
            want, got = cpu(x), card(x.cuda()).cpu()
        if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16:
            raise AssertionError(f"bf16 BatchNorm ({mode}) returned "
                                 f"{got.dtype} on the card, {want.dtype} on "
                                 "the CPU")
        err = (got.float() - want.float()).abs().max().item()
        largest = want.float().abs().max().item()
        ulp = 2.0 ** (math.floor(math.log2(largest)) - 7)
        var_rel = ((card.running_var.cpu() - cpu.running_var).norm()
                   / cpu.running_var.norm()).item()
        if err > 2 * ulp or var_rel > 1e-5:
            raise AssertionError(f"bf16 BatchNorm ({mode}) on the card vs "
                                 f"the CPU: {err:.3e} (ulp {ulp:.3e}), "
                                 f"running var {var_rel:.3e}")
        out[mode] = {"max_abs_diff": err, "bf16_ulp_of_largest": ulp,
                     "running_var_rel": var_rel}
    return out


# The main paths, each a shipped config at full width on random weights, a
# few hundred episodes over a synthetic split in its dataset's layout
# (frames of 256x256, 10 per video):
# - clipspm: hmdb.yaml (RN50 CLIP tower, 224 crop, T=8, 5-way 5-shot
#   1-query, bf16), 10 test classes x 12 videos; three bidirectional OTAM
#   distances per episode (3 fused K1 launches);
# - ta2n: ucf.yaml with MODEL.METRIC=otam (ResNet-50 trunk, 224 crop, T=8,
#   5-way 1-shot 1-query, bf16), 21 test classes x 6 videos; one
#   forward/reverse soft-DTW per episode (1 fused K2 launch). The table does not
#   depend on METRIC, so the card-vs-CPU head check runs both metrics;
# - clipspm-vit: hmdb.yaml with MODEL.BACKBONE=ViT-B/16 (the shipped configs'
#   second tower: width 768, 12 layers, 16-px patches, feature width 512;
#   30 frames a tower call), the clipspm path's split; 3 fused K1 launches
#   per episode at D=512. Its tower's fp32 features are held against the
#   CPU's too;
# - clipspm-vit-switched: the same with the tower's three switches,
#   MODEL.INT8_EVAL (the blocks' four projections through the int8 GEMM in
#   evaluation: 4 GEMMs a block and no float projection, counted per tower
#   call), MODEL.FAST_SOFTMAX (the attention spelled out, its softmax the
#   max-shifted one in bf16) and MODEL.BF16_NORMS (LayerNorms in bf16);
#   3 fused K1 launches an episode. Its tower on the card is held
#   against the CPU's (``check_tower_against_cpu``): its fp32 features
#   without int8 as the clipspm-vit path's are, and with int8 each of its
#   48 projections against the plain version on the input it got;
# - clipfsar: configs/clipfsar/hmdb.yaml (RN50, 5-way 1-shot 1-query, bf16),
#   the clipspm path's split; one bidirectional OTAM per episode (1 fused K1
#   launch);
# - cpm2c: configs/cpm2c/hmdb.yaml (RN50, 5-way 1-shot, MOTION_COFF 0,
#   NORMAL_COFF 1, LMD [0.5, 1, 0]), the same split; two OTAMs per episode,
#   the appearance stream at L=8 and the motion stream at L=7 (2 fused K1
#   launches; the motion one is computed at weight 0, as in the JAX head);
# - sten: configs/sten/ucf.yaml (RN50, 5-way 1-shot) over the UCF-layout
#   split; no DP, so no kernel;
# - otam, trx, strm: configs/{otam,trx,strm}/ucf.yaml (the torchvision
#   ResNet-50 trunk, 224 crop, T=8, 5-way 1-shot, bf16) over the UCF-layout
#   split: otam's table holds each frame's 7x7 = 49 spatial tokens and its
#   head one bidirectional OTAM at lambda 0.1 and D=2048 per episode (1
#   fused K1 launch); trx (tuples of 2 and 3 frames) and strm (patch-attended
#   frames in the table) no kernel;
# - soap, molo: configs/{soap,molo}/ucf.yaml, the same layout; no cached
#   route (soap's priors run on pixels, molo's reconstruction needs them),
#   so they run only as uncached paths (below); no kernel.
PATHS = {
    "clipspm": dict(cfg="configs/clipspm/hmdb.yaml", opts=(),
                    frame_dir="hmdb_256x256q5_l8", split_dir="hmdb_ARN",
                    classes=10, videos=12, launches={"K1": 3, "K2": 0},
                    metrics=(None,)),
    "ta2n": dict(cfg="configs/ta2n/ucf.yaml", opts=("MODEL.METRIC=otam",),
                 frame_dir="ucf_256x256q5_l8", split_dir="ucf_ARN",
                 classes=21, videos=6, launches={"K1": 0, "K2": 1},
                 metrics=("otam", "cos")),
    "clipspm-vit": dict(cfg="configs/clipspm/hmdb.yaml",
                        opts=("MODEL.BACKBONE=ViT-B/16",),
                        frame_dir="hmdb_256x256q5_l8", split_dir="hmdb_ARN",
                        classes=10, videos=12, launches={"K1": 3, "K2": 0},
                        metrics=(None,), tower_check=True),
    "clipspm-vit-switched": dict(
        cfg="configs/clipspm/hmdb.yaml",
        opts=("MODEL.BACKBONE=ViT-B/16", "MODEL.INT8_EVAL=true",
              "MODEL.FAST_SOFTMAX=true", "MODEL.BF16_NORMS=true"),
        frame_dir="hmdb_256x256q5_l8", split_dir="hmdb_ARN", classes=10,
        videos=12, launches={"K1": 3, "K2": 0}, metrics=(None,),
        tower_check=True, int8=True),
    "clipfsar": dict(cfg="configs/clipfsar/hmdb.yaml", opts=(),
                     frame_dir="hmdb_256x256q5_l8", split_dir="hmdb_ARN",
                     classes=10, videos=12, launches={"K1": 1, "K2": 0},
                     metrics=(None,)),
    "cpm2c": dict(cfg="configs/cpm2c/hmdb.yaml", opts=(),
                  frame_dir="hmdb_256x256q5_l8", split_dir="hmdb_ARN",
                  classes=10, videos=12, launches={"K1": 2, "K2": 0},
                  metrics=(None,)),
    "sten": dict(cfg="configs/sten/ucf.yaml", opts=(),
                 frame_dir="ucf_256x256q5_l8", split_dir="ucf_ARN",
                 classes=21, videos=6, launches={"K1": 0, "K2": 0},
                 metrics=(None,)),
    "otam": dict(cfg="configs/otam/ucf.yaml", opts=(),
                 frame_dir="ucf_256x256q5_l8", split_dir="ucf_ARN",
                 classes=21, videos=6, launches={"K1": 1, "K2": 0},
                 metrics=(None,), table_tail=(49, 2048)),
    "trx": dict(cfg="configs/trx/ucf.yaml", opts=(),
                frame_dir="ucf_256x256q5_l8", split_dir="ucf_ARN",
                classes=21, videos=6, launches={"K1": 0, "K2": 0},
                metrics=(None,), table_tail=(2048,)),
    "strm": dict(cfg="configs/strm/ucf.yaml", opts=(),
                 frame_dir="ucf_256x256q5_l8", split_dir="ucf_ARN",
                 classes=21, videos=6, launches={"K1": 0, "K2": 0},
                 metrics=(None,), table_tail=(2048,)),
    "soap": dict(cfg="configs/soap/ucf.yaml", opts=(),
                 frame_dir="ucf_256x256q5_l8", split_dir="ucf_ARN",
                 classes=21, videos=6, launches={"K1": 0, "K2": 0},
                 cached=False, model_check=True),
    "molo": dict(cfg="configs/molo/ucf.yaml", opts=(),
                 frame_dir="ucf_256x256q5_l8", split_dir="ucf_ARN",
                 classes=21, videos=6, launches={"K1": 0, "K2": 0},
                 cached=False, model_check=True),
}
CACHED_PATHS = tuple(n for n, spec in PATHS.items()
                     if spec.get("cached", True))
# episodes of each cached eval path (cut from 300, then to 200 and 100, then
# to 50 to make room for the tower's switches and the remat policies, then
# to 30 for phase extras, within the script's time; the head rate is read
# over them, the rest of a path's time hardly depends on them)
MAIN_EPISODES = 30
SPLIT_FRAMES, SPLIT_PX = 10, 256
SEQ_LEN = 8
# the head on the card (fp32, no TF32) against the head on the CPU (fp32):
# sums in another order, so 1e-4 relative and absolute on the logits
HEAD_TOL = 1e-4
# the ViT tower on the card (fp32, no TF32; its attention the fused SDPA
# kernel) against the CPU's over 4 frames: max abs diff <= this times the
# largest feature magnitude
TOWER_TOL, TOWER_FRAMES = 1e-4, 4
# an int8 projection (MODEL.INT8_EVAL) on the card against the plain
# version on the CPU from the same input: the same codes around an exact
# product, then the same IEEE elementwise steps, so 1e-6 of the largest
# output (phase quant, and each projection of the switched tower)
INT8_LINEAR_TOL = 1e-6
# a whole model (soap, molo) on the card against the CPU over one episode,
# fp32: max abs logit diff <= this times the largest logit, or than 1.
# molo's logits are sums of 1 - cos over frame pairs, whose unit is 1: on
# random weights the frames are nearly collinear and the logits about
# 4e-3, and the two sides' 2.5e-6 apart (measured on an H100 80GB HBM3 at
# 700 W) is the cosines' fp32 rounding, not a share of the logits
MODEL_TOL = 1e-4
# the device kernels of each, as the profiler names them (both modes)
KERNEL_NAMES = {"K1": ("otam_dp_kernel", "otam_fused_kernel"),
                "K2": ("softdtw_dp_kernel", "softdtw_fused_kernel")}
# the port's span around each kernel's backward replay (train profile)
REPLAYS = {"K1": "otam.backward", "K2": "softdtw.backward"}


def _counters() -> dict:
    """Each kernel's wrapper module, whose ``launches`` counts its
    launches."""
    from clipspm_tpu_torch.ops import otam_cuda, softdtw_cuda

    return {"K1": otam_cuda, "K2": softdtw_cuda}


def _zero_counters(counters: dict) -> None:
    for mod in counters.values():
        mod.launches = 0


def _read_counters(counters: dict) -> dict:
    return {k: mod.launches for k, mod in counters.items()}


def _device_events(prof, spans=()) -> list:
    """The device's kernels and copies: the profiler's GPU copies of user
    ranges (``gpu_user_annotation``, spans that cover idle time; the port's
    ``spans`` by name) left out."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and e.name not in spans
            and not getattr(e, "is_user_annotation", False)]


def _summarize(prof, wall_us: float, n: int, top: int = 6,
               spans=()) -> tuple:
    """The device side of a profile over ``n`` episodes: wall and device
    busy ms an episode (busy is the sum of the device events' durations; one
    stream, so they do not overlap), idle share, device ops an episode, each
    kernel's ms and share, and the top device ops. Returns the summary and
    the busy microseconds."""
    dev = _device_events(prof, spans)
    busy_us = sum(e.device_time_total for e in dev)
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    out = {"episodes": n,
           "wall_ms_per_episode": wall_us / n / 1e3,
           "device_busy_ms_per_episode": busy_us / n / 1e3,
           "device_idle_share": 1.0 - busy_us / wall_us,
           "device_ops_per_episode": len(dev) / n}
    for k, knames in KERNEL_NAMES.items():
        k_us = sum(t for name, t in by_name.items()
                   if any(kname in name for kname in knames))
        out[f"{k.lower()}_device_ms_per_episode"] = k_us / n / 1e3
        out[f"{k.lower()}_share_of_device_busy"] = (k_us / busy_us
                                                    if busy_us else None)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    out["top_device_ms_per_episode"] = [[name[:60], t / n / 1e3]
                                        for name, t in ranked]
    return out, busy_us


def write_split(root: str, frame_dir: str, split_dir: str, classes: int,
                videos: int, frames: int, px: int, mode: str = "test") -> None:
    """One side of a synthetic split in a dataset's on-disk layout:
    ``<frame_dir>/<mode>/<class>/<vid>/NNNNN.jpg`` and
    ``splits/<split_dir>/<mode>list03.txt``."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0 if mode == "test" else 1)
    lines = []
    for c in range(classes):
        for v in range(videos):
            rel = f"{'class' if mode == 'test' else mode}{c:02d}/v{v:03d}"
            vdir = os.path.join(root, frame_dir, mode, rel)
            os.makedirs(vdir)
            color = tuple(int(x) for x in rng.integers(0, 256, 3))
            img = Image.new("RGB", (px, px), color)
            for f in range(frames):
                img.save(os.path.join(vdir, f"{f + 1:05d}.jpg"), quality=90)
            lines.append(rel)
    sdir = os.path.join(root, "splits", split_dir)
    os.makedirs(sdir, exist_ok=True)
    with open(os.path.join(sdir, f"{mode}list03.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")


_SPLIT_ROOTS: dict = {}


def split_root(spec: dict, train=None) -> str:
    """A directory holding ``spec``'s test split (and a train split of
    ``train`` = (classes, videos)), written once a run and shared, read
    only, by every path of that layout (their checkpoints go elsewhere);
    removed at exit."""
    import atexit
    import shutil

    key = (spec["frame_dir"], spec["split_dir"], spec["classes"],
           spec["videos"], train)
    if key not in _SPLIT_ROOTS:
        t0 = time.perf_counter()
        root = tempfile.mkdtemp(prefix="chip_smoke_split_")
        atexit.register(shutil.rmtree, root, True)
        write_split(root, spec["frame_dir"], spec["split_dir"],
                    spec["classes"], spec["videos"], SPLIT_FRAMES, SPLIT_PX)
        if train is not None:
            write_split(root, spec["frame_dir"], spec["split_dir"], *train,
                        SPLIT_FRAMES, SPLIT_PX, mode="train")
        log(f"wrote the split {key} in {time.perf_counter() - t0:.1f} s")
        _SPLIT_ROOTS[key] = root
    return _SPLIT_ROOTS[key]


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


def _seeded_episodes(cfg, train: bool, n: int) -> list:
    """The first ``n`` episodes of the train or the test stream, seeded
    frames after the decode stage, as host ``Episode``s."""
    from clipspm_tpu_torch.data import pipeline
    from clipspm_tpu_torch.train.setup import build_catalog_and_sampler

    queries = cfg.TRAIN.QUERY_PER_CLASS if train else \
        cfg.TEST.QUERY_PER_CLASS
    catalog, sampler = build_catalog_and_sampler(
        cfg, "train" if train else "test", train, int(queries))
    decode = pipeline.decode_path_lists
    pipeline.decode_path_lists = seeded_frames
    try:
        return [pipeline.decode_plan(sampler.sample(), catalog)
                for _ in range(n)]
    finally:
        pipeline.decode_path_lists = decode


class _Recorder:
    """Wraps the main path's entry points to read what they built."""

    def __init__(self):
        self.learner = None
        self.table = None
        self.row_of = None

    @contextlib.contextmanager
    def installed(self):
        from clipspm_tpu_torch.data import pipeline
        from clipspm_tpu_torch.train import feature_cache, setup

        build_learner = setup.build_learner
        build_table = feature_cache.FeatureCachedEvaluator.build_table
        decode = feature_cache.decode_path_lists
        loader_decode = pipeline.decode_path_lists

        def rec_build_learner(*a, **kw):
            self.learner = build_learner(*a, **kw)
            return self.learner

        def rec_build_table(ev, plans):
            self.table, self.row_of = build_table(ev, plans)
            return self.table, self.row_of

        setup.build_learner = rec_build_learner
        feature_cache.FeatureCachedEvaluator.build_table = rec_build_table
        # the table's decode and the episode loaders' (data/pipeline.py)
        feature_cache.decode_path_lists = seeded_frames
        pipeline.decode_path_lists = seeded_frames
        try:
            yield self
        finally:
            setup.build_learner = build_learner
            feature_cache.FeatureCachedEvaluator.build_table = build_table
            feature_cache.decode_path_lists = decode
            pipeline.decode_path_lists = loader_decode


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


def check_int8_projection(x, weight, bias, y) -> float:
    """One int8 projection ``y`` of the card against the plain version on
    the CPU from the same input: the same codes and scales, int32 sums
    bit-equal to the float64 product, ``y`` within INT8_LINEAR_TOL of the
    largest output. Returns the max abs diff."""
    from clipspm_tpu_torch.ops import quant

    K = x.shape[-1]
    xq, sx = quant.quantize_rows(x.float())
    wq, sw = quant.quantize_rows(weight.float())
    cx, csx = quant.quantize_rows(x.float().cpu())
    cw, csw = quant.quantize_rows(weight.float().cpu())
    if not all(torch.equal(a.cpu(), b) for a, b in
               ((xq, cx), (sx, csx), (wq, cw), (sw, csw))):
        raise AssertionError(f"int8 projection {list(x.shape)} -> "
                             f"{weight.shape[0]}: codes or scales differ "
                             f"from the CPU's")
    if not torch.equal(quant.int8_mm(xq.reshape(-1, K), wq).cpu(),
                       quant.int8_mm_plain(cx.reshape(-1, K), cw)):
        raise AssertionError(f"int8 projection {list(x.shape)} -> "
                             f"{weight.shape[0]}: int32 sums differ from "
                             f"the float64 product")
    want = quant.int8_linear(x.cpu(), weight.cpu(),
                             None if bias is None else bias.cpu())
    err = (y.cpu() - want).abs().max().item()
    if not err <= INT8_LINEAR_TOL * want.abs().max().item():
        raise AssertionError(f"int8 projection {list(x.shape)} -> "
                             f"{weight.shape[0]} on the card vs the CPU: "
                             f"{err:.3e}")
    return err


def check_tower_against_cpu(rec: _Recorder, int8: bool = False) -> dict:
    """The visual tower on the card (fp32 weights, no autocast, no TF32 in
    cuBLAS or cuDNN) against a CPU copy on the same seeded frames: max abs
    diff within TOWER_TOL of the largest feature. With ``int8`` (a ViT
    under MODEL.INT8_EVAL) that comparison runs with the int8 projections
    off, and the card's int8 forward of the same frames is then held
    projection by projection, each against the plain version from the very
    input it got on the card (``check_int8_projection``): the float steps
    and the int8 steps of the switched tower are each held tight. The int8
    features of the two sides are reported beside the CPU's own int8
    error, not held: where the two sides' fp32 activations straddle a
    rounding boundary of a row's scale, one takes the next code, and the
    flip carries on block after block."""
    import copy

    from clipspm_tpu_torch.models.backbones import clip

    tower = rec.learner.model.backbone
    cpu = copy.deepcopy(tower).cpu().float().eval()
    R = rec.learner.model.arch.image_resolution
    x = torch.rand(TOWER_FRAMES, R, R, 3,
                   generator=torch.Generator().manual_seed(7))
    blocks = ([b for m in (tower, cpu) for b in m.transformer.resblocks]
              if int8 else [])
    int8_linear, projections = clip.int8_linear, []

    def held(x, weight, bias=None):
        y = int8_linear(x, weight, bias)
        projections.append(check_int8_projection(x, weight, bias, y))
        return y

    def switch(on):
        for block in blocks:
            block.int8_eval = on

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            switch(False)
            got = tower(x.to(rec.learner.device)).cpu()
            want = cpu(x)
            if int8:
                switch(True)
                clip.int8_linear = held
                card_q = tower(x.to(rec.learner.device)).cpu()
                clip.int8_linear = int8_linear
                cpu_q = cpu(x)
    finally:
        clip.int8_linear = int8_linear
        switch(True)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    if not err <= TOWER_TOL * scale:
        raise AssertionError(f"the tower on the card vs the CPU: max abs "
                             f"diff {err:.3e}, largest feature {scale:.3e}")
    res = {"frames": TOWER_FRAMES, "max_abs_diff": err,
           "max_abs_feature": scale, "tol_of_max": TOWER_TOL}
    if int8:
        want_n = 4 * len(tower.transformer.resblocks)
        if len(projections) != want_n:
            raise AssertionError(f"the int8 tower ran {len(projections)} "
                                 f"int8 projections; expected {want_n}")
        res.update({
            "int8_projections_held": len(projections),
            "int8_projection_max_abs_diff": max(projections),
            "int8_projection_tol_of_max": INT8_LINEAR_TOL,
            "card_int8_vs_cpu_int8_max_abs_diff":
                (card_q - cpu_q).abs().max().item(),
            "cpu_int8_vs_float_max_abs_diff":
                (cpu_q - want).abs().max().item()})
    return res


def profile_head(rec: _Recorder, argv, episodes: int = 10) -> dict:
    """Where the head's time goes: ``episodes`` head forwards of the main
    path (bf16, as evaluated) under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from clipspm_tpu_torch.train.losses import loss_and_acc

    learner = rec.learner
    eps = _first_episodes(rec, argv, episodes)

    def run(ep):
        su, qu, sl, rs, rt, tl = ep
        out = learner.model.match_features(su, qu, sl, rs, rt,
                                           learner.text_train,
                                           learner.text_test)
        return loss_and_acc(learner.model_name, out, tl, rs, rt,
                            learner.tasks_per_batch, cfg=learner.cfg,
                            train=False)

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
    return _summarize(prof, wall_us, episodes)[0]


def k2_on_path_inputs(rec: _Recorder, argv) -> dict:
    """Is K2's time data-dependent? Its device time on the ta2n head's own
    inputs (the first episode's aligned sequences, caught at the fused
    entry) against random inputs of the same shape, and the table mode's on
    the padded tables of the head's inputs against uniform tables in
    [0, 2) of the same shape."""
    from clipspm_tpu_torch.ops import softdtw_cuda
    from clipspm_tpu_torch.ops.softdtw import pairwise_cos_dist
    from clipspm_tpu_torch.tools.timing import graph_ms

    learner = rec.learner
    entry = softdtw_cuda.softdtw_cos_padded_cuda
    seen = []

    def recording(x, y, gamma, bandwidth=0.0):
        seen.append((x.clone(), y.clone(), gamma, bandwidth))
        return entry(x, y, gamma, bandwidth)

    softdtw_cuda.softdtw_cos_padded_cuda = recording
    try:
        with torch.no_grad():
            su, qu, sl, rs, rt, _ = _first_episodes(rec, argv, 1)[0]
            learner.model.match_features(su, qu, sl, rs, rt,
                                         learner.text_train,
                                         learner.text_test)
    finally:
        softdtw_cuda.softdtw_cos_padded_cuda = entry
    x, y, gamma, bw = seen[0]
    gen = torch.Generator().manual_seed(2)
    rx = torch.randn(x.shape, generator=gen).to(x.device)
    ry = torch.randn(y.shape, generator=gen).to(y.device)
    path_tables = F.pad(pairwise_cos_dist(x, y), (0, 0, 1, 1)).contiguous()
    uniform = (torch.rand(path_tables.shape, generator=gen)
               * 2.0).to(x.device)
    return {
        "shape": [list(x.shape), list(y.shape)], "gamma": gamma,
        "fused_path_inputs_device_ms": graph_ms(
            lambda: entry(x, y, gamma, bw)),
        "fused_random_inputs_device_ms": graph_ms(
            lambda: entry(rx, ry, gamma, bw)),
        "table_path_tables_device_ms": graph_ms(
            lambda: softdtw_cuda.softdtw_dp_cuda(path_tables, gamma, bw)),
        "table_uniform_tables_device_ms": graph_ms(
            lambda: softdtw_cuda.softdtw_dp_cuda(uniform, gamma, bw))}


@contextlib.contextmanager
def _counted_tower_calls():
    """Counts the ViT tower's calls (a list holding the count)."""
    from clipspm_tpu_torch.models.backbones import clip

    forward, calls = clip.VisionTransformer.forward, [0]

    def counted(tower, x):
        calls[0] += 1
        return forward(tower, x)

    clip.VisionTransformer.forward = counted
    try:
        yield calls
    finally:
        clip.VisionTransformer.forward = forward


def phase_main_path(name: str, device: str = "cuda", extra_opts=(),
                    episodes: int = None) -> dict:
    import gc

    from clipspm_tpu_torch.cli.run import main as cli_main
    from clipspm_tpu_torch.ops import quant

    spec = PATHS[name]
    episodes = episodes or spec.get("episodes", MAIN_EPISODES)
    log(f"main path {name}: frames come from a seeded uint8 source right "
        "after the decode stage, in place of the JPEG decode; the disk decode "
        "(native/frame_decoder.cc, which needs libjpeg, or PIL) is held "
        "against the JAX package by the CPU tests")
    on_gpu = torch.device(device).type == "cuda"
    counters = _counters()
    data = split_root(spec)
    with tempfile.TemporaryDirectory() as root:
        argv = ["--cfg", spec["cfg"], "--splits-root", data,
                "--allow-random-weights", "--device", device,
                "TEST.ONLY_TEST=true", f"TEST.TEST_EPISODES={episodes}",
                f"DATA.DATA_DIR={data}",
                f"CHECKPOINT.CHECKPOINT_DIR={os.path.join(root, 'ckpt')}",
                *spec["opts"], *extra_opts]
        rec = _Recorder()
        if on_gpu:
            gc.collect()
            # the cuBLAS workspaces that phase 3's timed matmuls left on
            # their streams (32 MB each) are not the path's memory
            if hasattr(torch._C, "_cuda_clearCublasWorkspaces"):
                torch._C._cuda_clearCublasWorkspaces()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        with rec.installed(), _counted_tower_calls() as tower_calls:
            _zero_counters(counters)
            quant.launches = 0
            t0 = time.perf_counter()
            res = cli_main(argv)
            wall = time.perf_counter() - t0
            launches = _read_counters(counters)
            int8_gemms = quant.launches
        peak = torch.cuda.max_memory_allocated() if on_gpu else 0
        head_err = check_head_against_cpu(rec, argv, spec["metrics"])
        tower_err = None
        if spec.get("tower_check"):
            tower_err = check_tower_against_cpu(rec, bool(spec.get("int8")))
        head_profile = profile_head(rec, argv) if on_gpu else None
        if on_gpu and name == "ta2n":
            head_profile["k2_data_dependence"] = k2_on_path_inputs(rec, argv)

    V = res["unique_videos"]
    if spec.get("int8") and on_gpu:
        # every block of every tower call: its four projections through the
        # int8 GEMM, and so none through a float product
        want_gemms = 4 * rec.learner.model.arch.vision_layers * tower_calls[0]
        if not tower_calls[0] or int8_gemms != want_gemms:
            raise AssertionError(f"{name}: {int8_gemms} int8 GEMMs over "
                                 f"{tower_calls[0]} tower calls; expected "
                                 f"{want_gemms}")
    elif int8_gemms:
        raise AssertionError(f"{name} ran {int8_gemms} int8 GEMMs")
    for k, per_episode in spec["launches"].items():
        expect = per_episode * episodes if on_gpu else 0
        if launches[k] != expect:
            raise AssertionError(f"{k} launched {launches[k]} times on the "
                                 f"{name} path; expected {expect}")
    for key in ("accuracy", "confidence", "loss"):
        if not math.isfinite(res[key]):
            raise AssertionError(f"{name} path {key} is not finite: {res}")
    model = rec.learner.model
    tail = spec.get("table_tail") or (
        (model.arch.embed_dim,) if hasattr(model, "arch") else (7, 7, model.dim))
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
    if spec.get("int8"):
        out["int8_gemms"] = int8_gemms
        out["tower_calls"] = tower_calls[0]
    if tower_err is not None:
        out["tower_vs_cpu"] = tower_err
    log(json.dumps({"main_path": out}))
    log(json.dumps({"head_profile": {"path": name, **(head_profile or {})}}))
    return out


# The uncached eval paths: the JAX package's default test route
# (TEST.CACHE_FEATURES false) and its benchmark's primary measurement, through
# the port's CLI: the test EpisodeLoader's episodes (seeded frames after the
# decode stage, as above), TEST.EVAL_BATCH (32, as shipped) a step, each
# episode's 240 frames transformed and encoded afresh, the episodes of a step
# run one after another. UNCACHED_EPISODES is one full step (cut from two
# to make room for phase convergence). Each path runs
# its eval path's config and split with TEST.CACHE_FEATURES=false. soap and
# molo (UCF layout, ResNet-50, 5-way 1-shot, E=32 as shipped) have no other
# evaluator; their whole model's fp32 logits over one episode on the card
# are also held against the CPU's (MODEL_TOL).
UNCACHED_PATHS = {"clipspm-uncached": "clipspm",
                  "clipspm-vit-uncached": "clipspm-vit",
                  "soap-uncached": "soap", "molo-uncached": "molo"}
UNCACHED_EPISODES = 32
# uncached = cached on the card: the first EQUAL_EPISODES episodes of the
# clipspm path's stream through both evaluators, fp32 (USE_AMP false, TF32
# off in cuBLAS and cuDNN): mean losses within EQUAL_LOSS_REL of each other,
# accuracies equal
EQUAL_EPISODES, EQUAL_LOSS_REL = 8, 1e-4


class _EvalRecorder(_Recorder):
    """Also times each step of the uncached evaluator with CUDA events."""

    def __init__(self):
        super().__init__()
        self.batches = []        # (n episodes, start event, end event)

    @contextlib.contextmanager
    def installed(self):
        from clipspm_tpu_torch.train import learner

        eval_batch = learner.Learner._eval_batch

        def timed_batch(lrn, batch, n):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = eval_batch(lrn, batch, n)
            ev[1].record()
            self.batches.append((n, *ev))
            return out

        learner.Learner._eval_batch = timed_batch
        try:
            with super().installed():
                yield self
        finally:
            learner.Learner._eval_batch = eval_batch


def _frames_per_episode(cfg) -> int:
    return (int(cfg.TRAIN.WAY) * (int(cfg.TRAIN.SHOT)
                                  + int(cfg.TEST.QUERY_PER_CLASS))
            * int(cfg.DATA.SEQ_LEN))


def profile_uncached(learner, cfg, episodes: int = 4) -> dict:
    """Where an uncached step's time goes: ``episodes`` fresh test
    episodes (seeded frames), staged as the evaluator stages them, through
    ``Learner._eval_batch`` (transform, encode, head, loss; bf16, as
    evaluated) under ``torch.profiler``, after one unprofiled pass."""
    from torch.profiler import ProfilerActivity, profile

    eps = _seeded_episodes(cfg, False, episodes)
    batch = learner._ready(*learner._to_device(eps))
    learner.model.eval()
    learner._eval_batch(batch, episodes)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        learner._eval_batch(batch, episodes)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return _summarize(prof, wall_us, episodes)[0]


def phase_uncached_path(name: str) -> dict:
    from clipspm_tpu_torch.cli.run import main as cli_main

    spec = PATHS[UNCACHED_PATHS[name]]
    counters = _counters()
    data = split_root(spec)
    with tempfile.TemporaryDirectory() as root:
        argv = ["--cfg", spec["cfg"], "--splits-root", data,
                "--allow-random-weights", "--device", "cuda",
                "TEST.ONLY_TEST=true", "TEST.CACHE_FEATURES=false",
                f"TEST.TEST_EPISODES={UNCACHED_EPISODES}",
                f"DATA.DATA_DIR={data}",
                f"CHECKPOINT.CHECKPOINT_DIR={os.path.join(root, 'ckpt')}",
                *spec["opts"]]
        rec = _EvalRecorder()
        _fresh_peak()
        with rec.installed():
            _zero_counters(counters)
            t0 = time.perf_counter()
            res = cli_main(argv)
            wall = time.perf_counter() - t0
            launches = _read_counters(counters)
        peak = torch.cuda.max_memory_allocated()
        cfg = rec.learner.cfg
        step_profile = profile_uncached(rec.learner, cfg)
        model_err = (check_model_against_cpu(rec.learner, cfg)
                     if spec.get("model_check") else None)
    E = int(cfg.TEST.EVAL_BATCH)
    batches = [(n, a.elapsed_time(b) / 1e3) for n, a, b in rec.batches]
    want_batches = [E] * (UNCACHED_EPISODES // E) + (
        [UNCACHED_EPISODES % E] if UNCACHED_EPISODES % E else [])
    if [n for n, _ in batches] != want_batches:
        raise AssertionError(f"{name}: batches {batches}, expected "
                             f"{want_batches}")
    for k, per_episode in spec["launches"].items():
        if launches[k] != per_episode * UNCACHED_EPISODES:
            raise AssertionError(f"{k} launched {launches[k]} times on the "
                                 f"{name} path; expected "
                                 f"{per_episode * UNCACHED_EPISODES}")
    for key in ("accuracy", "confidence", "loss"):
        if not math.isfinite(res[key]):
            raise AssertionError(f"{name} path {key} is not finite: {res}")
    frames = _frames_per_episode(cfg) * UNCACHED_EPISODES
    out = {"path": name, "episodes": UNCACHED_EPISODES, "eval_batch": E,
           "accuracy": res["accuracy"], "confidence": res["confidence"],
           "loss": res["loss"], "launches": launches,
           "episodes_per_s": UNCACHED_EPISODES / res["seconds"],
           "encode_frames_per_s": frames / res["seconds"],
           "batch_device_seconds": [t for _, t in batches],
           "batch_device_seconds_p50": statistics.median(
               t for _, t in batches),
           "host_stall_pct": 100.0 * res["host_stall_seconds"]
           / res["seconds"],
           "evaluate_seconds": res["seconds"], "cli_seconds": wall,
           "build_seconds": rec.learner.build_seconds,
           "peak_memory_bytes": peak}
    if model_err is not None:
        out["model_vs_cpu"] = model_err
    log(json.dumps({"main_path": out}))
    log(json.dumps({"uncached_profile": {"path": name, **step_profile}}))
    return out


def check_model_against_cpu(learner, cfg, ep=None,
                            keys=("logits",)) -> dict:
    """The whole model in evaluation mode on the card (fp32 weights, no
    autocast, no TF32 in cuBLAS or cuDNN) against a CPU copy over one test
    episode (``ep``, or the first of the seeded test stream; the eval
    transform on each side): for each output of ``keys`` the max abs
    difference <= MODEL_TOL times its largest value, or than 1."""
    import copy

    import numpy as np

    from clipspm_tpu_torch.data.transforms import episode_device_transform

    ep = ep or _seeded_episodes(cfg, False, 1)[0]
    gpu = learner.model.eval()
    cpu_model = copy.deepcopy(gpu).cpu().float()
    dtype, gpu.compute_dtype = gpu.compute_dtype, None
    cpu_model.compute_dtype = None
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = learner.transform
    outs = []
    try:
        with torch.no_grad():
            for model, dev in ((gpu, learner.device),
                               (cpu_model, torch.device("cpu"))):
                frames = [episode_device_transform(
                    torch.from_numpy(x).to(dev), train=False,
                    img_size=t.img_size, resize_to=t.resize_to,
                    normalize=t.normalize)
                    for x in (ep.support_images, ep.target_images)]
                labels = [torch.from_numpy(np.asarray(x)).to(dev) for x in (
                    ep.support_labels, ep.real_support_labels,
                    ep.real_target_labels)]
                res = model(*frames, *labels, learner.text_train.to(dev),
                            learner.text_test.to(dev))
                outs.append({k: res[k].cpu() for k in keys})
    finally:
        gpu.compute_dtype = dtype
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    out, bad = {"episodes": 1, "tol_of_max_or_1": MODEL_TOL}, []
    for k in keys:
        err, scale = (outs[0][k] - outs[1][k]).abs().max().item(), \
            outs[1][k].abs().max().item()
        # the logits under their earlier names, any other output by its own
        names = (("logits_shape", "max_abs_diff", "max_abs_logit")
                 if k == "logits" else
                 (f"{k}_shape", f"{k}_max_abs_diff", f"{k}_max_abs"))
        out.update(zip(names, (list(outs[1][k].shape), err, scale)))
        if not err <= MODEL_TOL * max(scale, 1.0):
            bad.append(k)
    if bad:
        raise AssertionError(f"the model on the card vs the CPU ({bad}): "
                             f"{out}")
    return out


def phase_uncached_equals_cached() -> dict:
    """The clipspm path's first EQUAL_EPISODES episodes through the uncached
    and the feature-cached evaluator of one learner on the card, fp32."""
    from clipspm_tpu_torch.train.feature_cache import FeatureCachedEvaluator
    from clipspm_tpu_torch.train.setup import (build_catalog_and_sampler,
                                               build_learner)
    from clipspm_tpu_torch.utils.config import load_config

    spec = PATHS["clipspm"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    data = split_root(spec)
    with tempfile.TemporaryDirectory() as root:
        cfg = load_config(spec["cfg"], splits_root=data, opts=[
            *spec["opts"], "USE_AMP=false", "TEST.ONLY_TEST=true",
            f"DATA.DATA_DIR={data}",
            f"CHECKPOINT.CHECKPOINT_DIR={os.path.join(root, 'ckpt')}"])
        with _Recorder().installed():
            learner = build_learner(cfg, log_fn=log, device="cuda",
                                    allow_random_weights=True)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            try:
                uncached = learner.evaluate(
                    EQUAL_EPISODES, batch_size=int(cfg.TEST.EVAL_BATCH))
                catalog, sampler = build_catalog_and_sampler(
                    cfg, "test", False, int(cfg.TEST.QUERY_PER_CLASS))
                ev = FeatureCachedEvaluator(
                    learner, catalog, sampler,
                    num_decode_workers=int(cfg.DATA.NUM_WORKERS), log_fn=log)
                try:
                    cached = ev.evaluate(EQUAL_EPISODES)
                finally:
                    ev.close()
            finally:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = tf32
                learner.close()
    rel = abs(uncached["loss"] - cached["loss"]) / abs(cached["loss"])
    out = {"path": "clipspm", "episodes": EQUAL_EPISODES,
           "loss": {"uncached": uncached["loss"], "cached": cached["loss"]},
           "loss_rel_diff": rel, "loss_rel_tol": EQUAL_LOSS_REL,
           "accuracy": {"uncached": uncached["accuracy"],
                        "cached": cached["accuracy"]}}
    log(json.dumps({"uncached_equals_cached": out}))
    if rel > EQUAL_LOSS_REL or uncached["accuracy"] != cached["accuracy"]:
        raise AssertionError(f"uncached and cached evaluation disagree: "
                             f"{out}")
    return out


# (cut from 40 train episodes, a validation and a checkpoint at 32 and 100
# validation and ONLY_TEST episodes, to make room for the tower's switches
# and the remat policies, then the validation and ONLY_TEST to 20 episodes
# for phase ddp, then to 10 and the training to 20 for phase extras: still
# one full step and one masked partial step where TASKS_PER_BATCH is 16)
# A train path's depth, with a profiled step and an ONLY_TEST run from
# checkpoint_best (a path's ``depth`` overrides these, and a path that
# overrides them runs neither)
TRAIN_DEPTH = dict(episodes=20, tasks_per_batch=None, val_freq=16,
                   val_episodes=10, save_freq=16, print_freq=8)
# the four heads without a kernel: the least that trains and validates
# through the CLI (its loop validates before its last step only): two full
# steps of 4 episodes (TASKS_PER_BATCH 16 cut to 4) with a 4-episode
# validation between them, no periodic checkpoint
HEAD_DEPTH = dict(episodes=8, tasks_per_batch=4, val_freq=4,
                  val_episodes=4, save_freq=0, print_freq=4)


# The train paths: a shipped config's training run through the port's CLI
# on random weights, over a synthetic train split of the dataset's layout
# (the train split's class count; videos a class = shot + queries) and its
# eval path's test split, cut to a few optimizer steps (TASKS_PER_BATCH=16:
# full steps of 16 and one of the rest), one cached validation of 100
# episodes, a periodic checkpoint; then an ONLY_TEST run from
# checkpoint_best. ``launches``: each kernel's launches an episode, in
# training, validation and the ONLY_TEST run alike (a backward replays the
# plain version and launches nothing).
# - clipspm-train: hmdb.yaml as shipped (RN50, 224 crop, T=8, 5-way 5-shot
#   4-query, bf16, Adam at LR 1e-5), 31 train classes x 9 videos (HMDB51's
#   train split has 31 classes);
# - clipspm-vit-train: the same on the ViT-B/16 tower, trained in
#   rematerialised chunks of 40 frames keeping each block's attention
#   output (the defaults);
# - ta2n-train: ucf.yaml with MODEL.METRIC=otam (ResNet-50 trunk, 224 crop,
#   T=8, 5-way 1-shot 4-query, bf16, SGD at LR 1e-3, momentum 0.9, WD
#   1e-3), 70 train classes x 5 videos (UCF101's ARN train split has 70
#   classes). K2 at B = 5 x 20 = 100 pairs in training, 25 in evaluation.
# - clipfsar-train: clipfsar/hmdb.yaml as shipped (RN50, 5-way 1-shot
#   4-query, 200 frames an episode, bf16, Adam at LR 2e-6, TASKS_PER_BATCH
#   4: ten steps), 31 train classes x 5 videos; cached validation. 1 K1
#   launch an episode;
# - cpm2c-train: cpm2c/hmdb.yaml as shipped (the same episode layout,
#   TASKS_PER_BATCH 16, Adam at LR 1e-5, the consistency term on), the same
#   split, validating and testing uncached (TEST.CACHE_FEATURES=false). 2
#   K1 launches an episode (L=8 and L=7);
# - otam-train: otam/ucf.yaml as shipped (ResNet-50, 5-way 1-shot 4-query,
#   SGD at LR 1e-4, TASKS_PER_BATCH 16, bf16), 70 train classes x 5 videos;
#   cached validation. 1 K1 launch an episode (Q=20 in training, 5 after),
#   its backward the plain replay;
# - molo-train: molo/ucf.yaml as shipped (Adam at LR 5e-5, weight decay
#   5e-4, TASKS_PER_BATCH 4: ten steps; the decoder and its BatchNorms in
#   training mode), the same split; validation and test uncached (the
#   config sets no cache). No kernel.
# Each runs 40 episodes (steps of TASKS_PER_BATCH and the rest), validation
# and a periodic checkpoint at episode 32.
# ``check``: the one fp32 train step held against fp64 (below): its episodes
# and shape (one 5-way 1-shot 1-query episode, 80 frames: the CPU's fp64
# step sets the script's length), the per-tensor factor, and the tensors
# whose gradient is zero in exact arithmetic. None: the head's gradients on
# the card against the CPU's instead (``check_head_grads_against_cpu``; the
# clipfsar, cpm2c and otam heads hold no BatchNorm; molo's decoder does,
# held like every other tensor against the fp64 witness).
TRAIN_PATHS = {
    "clipspm-train": dict(
        eval_path="clipspm", train_classes=31, train_videos=9,
        launches={"K1": 3, "K2": 0},
        check=dict(factor=1.0, zero_grad=("backbone.attnpool.k_proj.bias",))),
    "clipspm-vit-train": dict(
        eval_path="clipspm-vit", train_classes=31, train_videos=9,
        launches={"K1": 3, "K2": 0}, check=dict(factor=1.0, zero_grad=())),
    "ta2n-train": dict(
        eval_path="ta2n", train_classes=70, train_videos=5,
        launches={"K1": 0, "K2": 1},
        check=dict(factor=2.0,
                   zero_grad=("ttm.loc_conv1.bias", "ttm.loc_conv2.bias",
                              "acm.mv_conv1.bias", "acm.mv_conv2.bias"))),
    "clipfsar-train": dict(
        eval_path="clipfsar", train_classes=31, train_videos=5,
        launches={"K1": 1, "K2": 0}, check=None),
    "cpm2c-train": dict(
        eval_path="cpm2c", train_classes=31, train_videos=5,
        opts=("TEST.CACHE_FEATURES=false",), launches={"K1": 2, "K2": 0},
        check=None),
    "otam-train": dict(
        eval_path="otam", train_classes=70, train_videos=5,
        launches={"K1": 1, "K2": 0}, check=None),
    "molo-train": dict(
        eval_path="molo", train_classes=70, train_videos=5,
        launches={"K1": 0, "K2": 0}, check=None, grad_factor=10.0,
        fp64_on_card=True, conditioned=True),
    # the four heads with no kernel (sten: the CLIP RN50 tower, its only
    # config UCF's; trx, strm, soap: the torchvision ResNet-50), each at
    # HEAD_DEPTH with its head's gradients against the CPU's; soap
    # validates uncached (its config sets no cache) and its head starts
    # after the pixel priors and the trunk (models/heads/soap.py: head).
    # In a TRX cross-transformer (trx, strm, soap) the keys' LayerNorm
    # feeds a softmax over a class's support tuples, so its gradients are
    # residues of cancelling sums, like molo's scales: on the card
    # tct_3.norm_k's fp32 error measured 5.9 times the CPU's in one run
    # (1.53e-4 against 2.60e-5; 1.0 to 1.5 times in the next; H100 80GB
    # HBM3 at 700 W), so these heads are held against the fp64 witness on
    # the card and their conditioning as molo's are
    # strm from random weights diverges under its config's SGD (its loss
    # 1.8e3 in the first step of 4 and 3.7e5 to 9.0e5 in the second; the
    # first step's weights give 3.3e32 and no finite gradient in fp64
    # either, H100 80GB HBM3 at 700 W): its check runs on the seeded random
    # weights the CLI starts from (check_at_init)
    **{f"{head}-train": dict(
        eval_path=head, train_classes=70, train_videos=5,
        launches={"K1": 0, "K2": 0}, check=None, depth=HEAD_DEPTH,
        zero_grad=tuple(f"tct_{n}.v_linear.bias" for n in temp_set),
        fp64_on_card=bool(temp_set), conditioned=bool(temp_set),
        check_at_init=head == "strm")
       for head, temp_set in (("sten", ()), ("trx", (2, 3)), ("strm", (2,)),
                              ("soap", (2, 3)))},
}
# the profiled optimizer step's episodes (per-episode figures; cut from 2
# for phase ddp)
PROFILE_EPISODES = 1
# the remat policies each timed over the profiled step's episodes on a
# remat-chunked tower (clipspm-vit-train), the JAX package's five
REMAT_POLICIES = ("attn_out", "full", "attn", "mlp", "dots")
# The train step on the card against the CPU: ``check``'s episodes at full
# width and 224, TF32 off, cuDNN's deterministic algorithms, dropout off,
# center crops, from one set of weights, three times: fp32 on the card,
# fp32 on the CPU, and fp64 on the CPU, the witness both fp32 runs are held
# against. Where every convolution feeds a BatchNorm (RN50, ResNet-50) the
# summed gradient is ill-conditioned: BatchNorm's own gradients and the
# convolutions' before it are small residues of large cancelling sums, and
# fp32 rounding alone moves them by percents. The CPU's fp32 error against
# fp64 measures that for each tensor; the card's, summed by other algorithms
# in other orders, may be no larger (``check["factor"]`` times it), or
# TRAIN_CHECK_FLOOR where the CPU's is smaller; all gradients together the
# same. Measured on an H100 80GB HBM3 at 700 W: RN50, all gradients 1.9%
# from fp64 on the card and 4.9% on the CPU, no tensor's card error above
# 0.54 of the CPU's; ViT-B/16 (no BatchNorm), 1.1e-6 and 6.0e-5; ta2n, 2.3%
# and 4.8%, every tensor's card error below 0.61 of the CPU's but TTM's
# 2-element loc_fc2 bias, 1.19 (1.28e-3 and 1.08e-3: the gradient of the
# warp's offset is a sum of cancelling frame differences, where either side
# may round closer), so ta2n's factor is 2. A wrong gradient path or weight
# layout is off by O(1).
# A gradient that is zero in exact arithmetic (the attention pool's key
# bias; a conv bias right before a train-mode BatchNorm) is held to 1e-5 of
# the largest gradient norm. BatchNorm running stats and the loss: 1e-4
# relative to the witness.
TRAIN_CHECK_FLOOR = 1e-4
TRAIN_CHECK_TOL = 1e-4
# The head's parameter and input gradients (clipfsar, cpm2c, otam, molo)
# over the same features: fp32 on the card (TF32 off, PyTorch's own CUDA
# convolutions in place of cuDNN's, K1's replay), fp32 on the CPU (the
# plain versions) and the fp64 witness on the CPU. Each tensor's card error
# against the witness may be twice the CPU's own, or HEAD_GRAD_TOL where
# that is smaller: most tensors agree to 1e-6, but context2's last bias
# sums its upstream gradient over every token, and cancels (the card and
# the CPU fp32 1.55e-4 apart on cpm2c's, measured on an H100 80GB HBM3 at
# 700 W). A wrong gradient path is off by O(1). molo's factor is 10
# (``grad_factor``): its learned scales multiply sums of 1 - cos over
# nearly collinear frames (random weights) against softmax residuals that
# sum to 0 over the classes, so their gradients are residues of the
# classes' distance differences, whose fp32 rounding depends on the
# summation order. In two runs (the trained weights differ from run to
# run) the card's error on scale_motion measured 2.7 and 3.8 times the
# CPU's (1.9e-2 and 4.8e-2 against 7.0e-3 and 1.2e-2) with cuDNN's
# convolutions, whose own fp32 error (above) the factor now need not
# carry.
HEAD_GRAD_TOL, HEAD_GRAD_FACTOR = 1e-4, 2.0
# A head tensor whose gradient is zero in exact arithmetic: in a TRX
# cross-transformer (trx, strm, soap) the value projection's bias reaches
# both a query's values and its class prototype, whose softmax weights sum
# to 1, so it cancels in their difference. fp32 leaves a rounding residue
# (on the CPU at test size 5e8 times the fp64 one), so such a tensor is held
# to this share of the largest gradient norm instead.
HEAD_ZERO_GRAD_TOL = 1e-5
# molo's head gradients in fp32 are set by their conditioning, not by the
# CPU's luck: its learned scales multiply sums of 1 - cos over nearly
# collinear frames against softmax residuals that cancel over the classes,
# and its motion stream is built from frame differences, so fp32 rounding
# anywhere upstream moves them by up to tens of percent (on an H100 80GB
# HBM3 at 700 W, scale_motion's fp32 gradient 0.19 from fp64 on the card
# and 5.5 on the CPU in one run, the motion convolutions' 2e-4 and 8e-6 in
# another), and a single CPU run may be far luckier than the card's (scale
# 7.7e-3 on the card against 3.0e-4 on the CPU in one run, where others
# passed). So each molo tensor may also take COND_FACTOR times its
# conditioning: the largest spread of the card's fp64 gradient over
# COND_DRAWS runs in which every op rounds as fp32 rounds (_Fp32Rounding:
# each result by one rounding, a reduction's inputs by one and its result
# by sqrt(K) for K terms), from the unrounded fp64 gradient; the card's
# fp32 error measured at most 1.09 times that spread over six runs
# (PERF.md). Faults stay caught by the card's fp64 gradients, which must
# equal the CPU's within CARD_FP64_TOL (a copy whose head detaches scale
# on the card fails there), and by every well-conditioned tensor's fp32
# bound. (A draw for each kind of op alone, which said where the
# conditioning comes from, was cut for time: PERF.md keeps its finding.)
COND_DRAWS, COND_FACTOR = 2, 30.0


# ops whose result fp32 gives exactly (selections, moves, fills): not
# rounded (a min's backward finds its argument by equality with it)
_EXACT_OPS = ("amin", "amax", "max", "min", "sort", "topk", "median",
              "where", "clamp", "relu", "threshold", "abs", "neg", "copy",
              "clone", "_to_copy", "cat", "stack", "index_select", "gather",
              "select", "slice", "fill", "zero", "empty", "ones", "full",
              "new_", "constant_pad", "masked_fill", "scatter", "expand",
              "repeat", "t", "transpose", "permute", "view", "reshape",
              "detach", "alias", "unsqueeze", "squeeze")


def _op_kind(func):
    """The kind of an aten op for _Fp32Rounding: None (exact in fp32),
    conv, matmul, reduction or elementwise."""
    name = func.__name__.split(".")[0]
    if name.startswith(_EXACT_OPS) and not name.startswith("index_add"):
        return None
    if "conv" in name:
        return "conv"
    if name in ("mm", "bmm", "addmm", "baddbmm", "addbmm", "dot"):
        return "matmul"
    if any(r in name for r in ("sum", "mean", "norm", "softmax", "var",
                               "std", "cumsum", "index_add")):
        return "reduction"
    return "elementwise"


try:
    from torch.utils._python_dispatch import TorchDispatchMode
except ImportError:      # very old torch: the conditioning draws need it
    TorchDispatchMode = object


class _Fp32Rounding(TorchDispatchMode):
    """fp64 arithmetic rounded as fp32 rounds (relative 2^-24 steps, random
    signs; seeded): every floating op's result by one step, a reduction's
    (sum, norm, matmul, convolution) inputs by one and its result by
    sqrt(K) for K terms; views and exact ops are left alone, in-place ops
    move their result in place."""

    def __init__(self, device, seed: int):
        super().__init__()
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def _move(self, t, k: float = 1.0):
        """The factors ``1 +- sqrt(k) 2^-24`` of ``t``'s elements."""
        sign = torch.randint(0, 2, t.shape, device=t.device,
                             generator=self.gen, dtype=t.dtype) * 2 - 1
        return sign.mul_(math.sqrt(k) * 2.0 ** -24).add_(1)

    def _moved(self, x):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float64 \
                and x.numel():
            return x * self._move(x)
        return x

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        schema = func._schema
        kind = _op_kind(func)
        active = kind is not None and schema.returns and not any(
                r.alias_info is not None and not r.alias_info.is_write
                for r in schema.returns)
        if active and kind != "elementwise":
            # a sum of K terms rounds its partial sums: to first order the
            # terms each rounded (the inputs it reads, not those it writes)
            written = {a.name for a in schema.arguments
                       if a.alias_info is not None and a.alias_info.is_write}
            names = [a.name for a in schema.arguments]
            args = tuple(a if i < len(names) and names[i] in written
                         else self._moved(a) for i, a in enumerate(args))
            kwargs = {k: v if k in written else self._moved(v)
                      for k, v in kwargs.items()}
        out = func(*args, **kwargs)
        if not active:
            return out
        # a reduction of K terms rounds K partial sums: sqrt(K) roundings of
        # its result in a random walk, K from the sizes (a product's inner
        # dimension, a sum's terms an output)
        sizes = sorted((a.numel() for a in (*args, *kwargs.values())
                        if isinstance(a, torch.Tensor)
                        and a.is_floating_point()), reverse=True)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        moved = []
        for i, t in enumerate(outs):
            if not (isinstance(t, torch.Tensor) and t.dtype == torch.float64
                    and t.numel()):
                moved.append(t)
                continue
            k = 1.0
            if kind != "elementwise" and sizes:
                k = max(1.0, (sizes[0] * sizes[1] / t.numel()) ** 0.5
                        if len(sizes) > 1 else sizes[0] / t.numel())
            if schema.returns[i].alias_info is not None:
                moved.append(t.mul_(self._move(t, k)))    # in place
            else:
                moved.append(t * self._move(t, k))
        return type(out)(moved) if isinstance(out, (tuple, list)) \
            else moved[0]
# molo (no kernel) also runs its head in fp64 on the card: each gradient
# equal to the CPU's fp64 one within this (relative L2 per tensor). fp64
# rounding, amplified by the cancelling sums above, stays far below it; a
# different gradient path would be off by O(1).
CARD_FP64_TOL = 1e-8


class _TrainRecorder(_Recorder):
    """Also times each optimizer step with CUDA events, and counts the
    kernels' launches of each validation apart from training's."""

    def __init__(self):
        super().__init__()
        self.steps = []          # (n episodes, start event, end event)
        self.val_launches = []   # {kernel: launches} of each validation

    @contextlib.contextmanager
    def installed(self):
        from clipspm_tpu_torch.train import learner

        step = learner.Learner._step

        def timed_step(lrn, batch, n_valid):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = step(lrn, batch, n_valid)
            ev[1].record()
            self.steps.append((n_valid, *ev))
            return out

        learner.Learner._step = timed_step
        try:
            with _validations_apart(self.val_launches), super().installed():
                yield self
        finally:
            learner.Learner._step = step


@contextlib.contextmanager
def _validations_apart(val_launches: list):
    """Counts each evaluation's kernel launches (cached or uncached) apart
    from training's: the counts set to 0 just before it, read into
    ``val_launches`` just after, and training's put back."""
    from clipspm_tpu_torch.train import feature_cache, learner

    evaluators = {cls: cls.evaluate for cls in (
        feature_cache.FeatureCachedEvaluator, learner.Learner)}
    counters = _counters()

    def counted(evaluate):
        def counted_evaluate(ev, n, *args, **kwargs):
            train_counts = _read_counters(counters)
            _zero_counters(counters)
            try:
                return evaluate(ev, n, *args, **kwargs)
            finally:
                val_launches.append(_read_counters(counters))
                for k, mod in counters.items():
                    mod.launches = train_counts[k]
        return counted_evaluate

    for cls, evaluate in evaluators.items():
        cls.evaluate = counted(evaluate)
    try:
        yield val_launches
    finally:
        for cls, evaluate in evaluators.items():
            cls.evaluate = evaluate


def _fresh_peak() -> None:
    import gc

    gc.collect()
    # cuBLAS workspaces left by earlier phases' timed matmuls (32 MB a
    # stream) are not the path's memory
    if hasattr(torch._C, "_cuda_clearCublasWorkspaces"):
        torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def _kernels_under(event) -> int:
    """Device kernels launched by ``event``'s CPU subtree."""
    n, todo = 0, [event]
    while todo:
        e = todo.pop()
        n += len(e.kernels)
        todo.extend(e.cpu_children)
    return n


def profile_train_step(learner, cfg) -> dict:
    """``torch.profiler`` over one accumulated optimizer step of the trained
    model (PROFILE_EPISODES fresh episodes of the train stream, bf16, as
    trained): the shared summary (per episode), and each kernel's backward,
    the plain version's replay (the port's span around each backward call,
    recorded for the profiled step). For a remat-chunked tower, also one
    unprofiled step of the same episodes under each remat policy
    (``REMAT_POLICIES``): its seconds an episode and its peak device
    memory."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from clipspm_tpu_torch.utils.metrics import recording

    tpb = PROFILE_EPISODES
    eps = _seeded_episodes(cfg, True, tpb)
    batch = learner._ready(*learner._to_device(eps))
    learner._step(batch, tpb)          # warm-up
    torch.cuda.synchronize()
    with recording() as spans, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        learner._step(batch, tpb)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out, busy_us = _summarize(prof, wall_us, tpb, top=8,
                              spans={r.name for r in spans})
    model = learner.model
    if getattr(model, "train_encode_chunk", 0):
        policy, seconds, peaks = model.train_remat_policy, {}, {}
        for p in REMAT_POLICIES:
            model.train_remat_policy = p
            _fresh_peak()
            t0 = time.perf_counter()
            learner._step(batch, tpb)
            torch.cuda.synchronize()
            seconds[p] = (time.perf_counter() - t0) / tpb
            peaks[p] = torch.cuda.max_memory_allocated()
        model.train_remat_policy = policy
        out["remat_policy_step_seconds_per_episode"] = seconds
        out["remat_policy_train_episodes_per_s"] = {
            p: 1.0 / t for p, t in seconds.items()}
        out["remat_policy_peak_memory_bytes"] = peaks
        out["card"] = CARD
    for k, name in REPLAYS.items():
        replays = [e for e in prof.events() if e.name == name
                   and e.device_type == DeviceType.CPU]
        replay_us = sum(e.device_time_total for e in replays)
        pre = f"{k.lower()}_backward_replay"
        out.update({
            f"{pre}s_per_episode": len(replays) / tpb,
            f"{pre}_device_ms_per_episode": replay_us / tpb / 1e3,
            f"{pre}_wall_ms_per_episode":
                sum(e.cpu_time_total for e in replays) / tpb / 1e3,
            f"{pre}_device_ops_per_episode":
                sum(_kernels_under(e) for e in replays) / tpb,
            f"{pre}_share_of_device_busy": replay_us / busy_us,
            f"{pre}_share_of_wall":
                sum(e.cpu_time_total for e in replays) / wall_us})
    return out


def check_train_step_against_cpu(cfg_path: str, opts, check: dict) -> dict:
    """One train step of one episode at full width and 224 (2-way 1-shot
    1-query, T=8: cut from 5-way for phase ddp's time, 32 frames where it
    was 80) from identical weights: fp32 on the card, fp32 on the CPU
    and the fp64 witness on the CPU (TF32 off, dropout's modules in eval and
    BatchNorm in train mode, center crops). Summed gradients, BatchNorm
    running stats and the loss are held to the tolerances above."""
    import copy

    import numpy as np

    from clipspm_tpu_torch.data import transforms
    from clipspm_tpu_torch.data.episode import Episode
    from clipspm_tpu_torch.models.fsar import build_model
    from clipspm_tpu_torch.train import learner as learner_mod
    from clipspm_tpu_torch.utils.config import load_config
    from clipspm_tpu_torch.weights import random_init_

    n_eps, way, shot, queries = 1, 2, 1, 1
    cfg = load_config(cfg_path, opts=[
        *opts, "USE_AMP=false", f"TRAIN.WAY={way}", f"TRAIN.SHOT={shot}",
        f"TRAIN.QUERY_PER_CLASS={queries}", "TRAIN.TASKS_PER_BATCH=2"])
    T = int(cfg.DATA.SEQ_LEN)
    base = random_init_(build_model(cfg), torch.Generator().manual_seed(4))
    width = base.arch.embed_dim if hasattr(base, "arch") else 1
    text = torch.randn(len(cfg.TRAIN.CLASS_NAME), width,
                       generator=torch.Generator().manual_seed(5))
    rng = np.random.default_rng(6)
    eps = []
    for _ in range(n_eps):
        classes = rng.choice(len(cfg.TRAIN.CLASS_NAME), way,
                             replace=False).astype(np.int32)
        lab = rng.permutation(np.repeat(np.arange(way), shot)).astype(
            np.int32)
        tgt = rng.permutation(np.repeat(np.arange(way), queries)).astype(
            np.int32)
        eps.append(Episode(
            support_images=rng.integers(0, 256, (way * shot, T, SPLIT_PX,
                                                 SPLIT_PX, 3), dtype=np.uint8),
            support_labels=lab,
            target_images=rng.integers(0, 256, (way * queries, T, SPLIT_PX,
                                                SPLIT_PX, 3), dtype=np.uint8),
            target_labels=tgt, real_support_labels=classes[lab],
            real_target_labels=classes[tgt], batch_class_list=classes))

    def step(dev, dtype):
        def center(images, *, train, gen=None, **kw):
            return transforms.episode_device_transform(
                images, train=False, dtype=dtype, **kw)

        learner_mod.episode_device_transform = center
        model = copy.deepcopy(base).to(dtype)
        lrn = learner_mod.Learner(cfg, model, text.to(dtype), text.to(dtype),
                                  torch.device(dev), log_fn=log)
        lrn.model.train()
        for m in lrn.model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.eval()
        t0 = time.perf_counter()
        out = lrn.train_episodes(eps)
        out["seconds"] = time.perf_counter() - t0
        out["grads"] = {k: p.grad.detach().cpu().double()
                        for k, p in lrn.model.named_parameters()}
        out["stats"] = {k: v.detach().cpu().double() for k, v in
                        lrn.model.state_dict().items() if "running_" in k}
        return out

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    transform = learner_mod.episode_device_transform
    torch.set_num_threads(os.cpu_count() or 8)
    try:
        card = step("cuda", torch.float32)
        cpu = step("cpu", torch.float32)
        ref = step("cpu", torch.float64)
    finally:
        learner_mod.episode_device_transform = transform
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = saved

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    def limit(cpu_err):
        return max(check["factor"] * cpu_err, TRAIN_CHECK_FLOOR)

    g, c, r = card["grads"], cpu["grads"], ref["grads"]
    zero_grad = check["zero_grad"]
    largest = max(float(v.norm()) for v in r.values())
    rows, bad = [], []
    for k in r:
        if not r[k].any():          # unused by the forward (the head's scale)
            if g[k].any() or c[k].any():
                bad.append(f"{k}: no gradient in fp64, some in fp32")
            continue
        if k in zero_grad:
            err = max(float((x[k] - r[k]).norm()) for x in (g, c)) / largest
            if err > 1e-5:
                bad.append(f"{k} (zero in exact arithmetic) {err:.3e}")
            continue
        err, cpu_err = rel(g[k], r[k]), rel(c[k], r[k])
        rows.append((err / max(cpu_err, TRAIN_CHECK_FLOOR), err, cpu_err, k))
        if err > limit(cpu_err):
            bad.append(f"{k} {err:.3e} (CPU fp32 {cpu_err:.3e})")
    names = [k for k in r if k not in zero_grad and r[k].any()]
    flat = lambda d: torch.cat([d[k].flatten() for k in names])  # noqa
    total, cpu_total = rel(flat(g), flat(r)), rel(flat(c), flat(r))
    stats = {x: max((rel(d["stats"][k], v) for k, v in ref["stats"].items()),
                    default=0.0)
             for x, d in (("card", card), ("cpu", cpu))}
    loss = {x: abs(d["loss"] - ref["loss"]) / abs(ref["loss"])
            for x, d in (("card", card), ("cpu", cpu))}
    rows.sort(reverse=True)
    by_err = sorted(rows, key=lambda row: -row[1])
    out = {"episodes": n_eps,
           "frames_per_episode": way * (shot + queries) * T,
           "grad_tensors": len(rows),
           "grad_rel_l2_vs_fp64_all": {"card": total, "cpu": cpu_total},
           "grad_rel_l2_vs_fp64_median": {
               "card": sorted(e for _, e, _, _ in rows)[len(rows) // 2],
               "cpu": sorted(e for _, _, e, _ in rows)[len(rows) // 2]},
           "grad_worst_card_to_cpu": [[k, q, e, ce]
                                      for q, e, ce, k in rows[:6]],
           "grad_worst_card": [[k, e, ce] for _, e, ce, k in by_err[:6]],
           "grad_factor": check["factor"],
           "grad_floor": TRAIN_CHECK_FLOOR,
           "bn_running_stats_rel_max_vs_fp64": stats,
           "loss_rel_vs_fp64": loss, "loss_fp64": ref["loss"],
           "stats_loss_tol": TRAIN_CHECK_TOL,
           "seconds": {"card": card["seconds"], "cpu": cpu["seconds"],
                       "cpu_fp64": ref["seconds"]}}
    log(json.dumps({"train_step_vs_cpu": out}))
    if total > limit(cpu_total):
        bad.append(f"all gradients {total:.3e} (CPU fp32 {cpu_total:.3e})")
    if stats["card"] > TRAIN_CHECK_TOL or loss["card"] > TRAIN_CHECK_TOL:
        bad.append(f"running stats {stats['card']:.3e}, loss "
                   f"{loss['card']:.3e}")
    if bad:
        raise AssertionError("train step on the card vs the fp64 witness: "
                             + "; ".join(bad[:8]))
    return out


def check_head_grads_against_cpu(learner, cfg,
                                 factor: float = HEAD_GRAD_FACTOR,
                                 fp64_on_card: bool = False, ep=None,
                                 conditioned: bool = False,
                                 zero_grad=()) -> dict:
    """The trained head's parameter and input gradients on the card (fp32,
    TF32 off) and on a CPU copy (fp32) against the CPU copy's in fp64, over
    one train episode's features (``ep``, or the first of the seeded train
    stream; the tower in eval mode on the card, each role's pixels with
    cpm2c's prompts where they are on; for molo, which has no cacheable
    features, the trunk's maps and the clips; for soap, the trunk's
    features of the pixel priors' clips), train mode
    with dropout's modules in eval mode, the dispatch's train loss; a tensor
    whose gradient is 0 in fp64 (a stream weighted 0, a branch no loss
    reads) must be 0 on the card too. With ``fp64_on_card`` (a head with no
    fp32 kernel) the card also runs in fp64, and each of its gradients must
    equal the CPU's fp64 one within CARD_FP64_TOL: the same function on
    both devices, whatever fp32 rounding does to a cancelling sum. With
    ``conditioned`` (and ``fp64_on_card``) every tensor may also take the
    bound its conditioning sets (COND_FACTOR). A tensor in ``zero_grad``
    (its gradient zero in exact arithmetic, rounding's residue in fp64 too)
    is held on the card and on the CPU to HEAD_ZERO_GRAD_TOL of the largest
    gradient norm, as the train-step check holds such tensors."""
    import copy

    import numpy as np

    from clipspm_tpu_torch.data.transforms import episode_device_transform
    from clipspm_tpu_torch.models.visual import encode_frames
    from clipspm_tpu_torch.train.losses import loss_and_acc

    ep = ep or _seeded_episodes(cfg, True, 1)[0]
    gpu = learner.model
    dtype, gpu.compute_dtype = gpu.compute_dtype, None
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grads, losses = {}, {}
    try:
        cpu_model = copy.deepcopy(gpu).cpu().float()
        t = learner.transform
        cached = hasattr(gpu, "match_features")
        # molo's head takes the trunk's maps and the clips; the others' the
        # support's and the queries' features
        maps_and_clips = not cached and not hasattr(gpu, "tripel_prior")
        with torch.no_grad():
            gpu.eval()
            frames = [episode_device_transform(
                torch.from_numpy(x).to(learner.device), train=False,
                img_size=t.img_size, resize_to=t.resize_to,
                normalize=t.normalize)
                for x in (ep.support_images, ep.target_images)]
            if hasattr(gpu, "encode_episode"):
                feats = [f.float() for f in gpu.encode_episode(*frames)]
            elif cached:
                feats = [gpu.encode(f).float() for f in frames]
            elif hasattr(gpu, "tripel_prior"):
                # soap: its head starts after the pixel priors and the trunk
                feats = [encode_frames(gpu.backbone, gpu.tripel_prior(f), 0,
                                       None).float() for f in frames]
            else:
                both = torch.cat(frames)
                feats = [encode_frames(gpu.backbone, both, 0, None).float(),
                         both.float()]
        labels = [torch.from_numpy(np.asarray(x)) for x in (
            ep.support_labels, ep.real_support_labels,
            ep.real_target_labels, ep.target_labels)]
        cpu = torch.device("cpu")
        card64 = copy.deepcopy(gpu).double() if fp64_on_card else None
        # the conditioning draws: the card's fp64 head with every op's
        # result rounded as fp32 would round it
        rounded = ([f"card fp64 rounded {i}" for i in range(COND_DRAWS)]
                   if conditioned else [])
        for side, model, dev, dt in (
                ("card", gpu, learner.device, torch.float32),
                ("cpu", cpu_model, cpu, torch.float32),
                ("fp64", copy.deepcopy(cpu_model).double(), cpu,
                 torch.float64),
                *([("card fp64", card64, learner.device, torch.float64)]
                  if fp64_on_card else []),
                *[(side, card64, learner.device, torch.float64)
                  for side in rounded]):
            model.train()
            for m in model.modules():
                if isinstance(m, torch.nn.Dropout):
                    m.eval()
            model.zero_grad(set_to_none=True)
            a, b = [f.detach().to(dev, dt).clone().requires_grad_(True)
                    for f in feats]
            sl, rs, rt, tl = [x.to(dev) for x in labels]
            noise = (_Fp32Rounding(dev, len(grads))
                     if side.startswith("card fp64 rounded")
                     else contextlib.nullcontext())
            # PyTorch's own CUDA convolutions (im2col and a cuBLAS GEMM),
            # not cuDNN's: the fp32 algorithms cuDNN picks for molo's
            # convolutions put the trunk maps' gradient 7.6e-4 from fp64
            # where the CPU's was 1.4e-6 (the path itself runs cuDNN)
            with torch.backends.cudnn.flags(enabled=False, allow_tf32=False), \
                    noise:
                out = (model.match_features(a, b, sl, rs, rt,
                                            learner.text_train.to(dev, dt),
                                            learner.text_test.to(dev, dt))
                       if cached else model.head(a, b, sl))
                loss, _ = loss_and_acc(learner.model_name, out, tl, rs, rt,
                                       learner.tasks_per_batch, cfg=cfg,
                                       train=True)
                loss.backward()
            losses[side] = loss.item()
            grads[side] = {k: p.grad.detach().cpu().double()
                           for k, p in model.named_parameters()
                           if p.grad is not None
                           and not k.startswith("backbone.")}
            # and the head's inputs' (the only gradient of otam's head,
            # whose loss reads no head parameter: K1's replay)
            inputs = (("trunk maps", "clips") if maps_and_clips
                      else ("support features", "query features"))
            grads[side].update({f"input: {n}": x.grad.detach().cpu().double()
                                for n, x in zip(inputs, (a, b))
                                if x.grad is not None})
    finally:
        gpu.compute_dtype = dtype
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    card, cpu, ref = grads["card"], grads["cpu"], grads["fp64"]
    rows, bad, zero, cond = [], [], 0, {}
    if not set(card) == set(cpu) == set(ref) or not ref:
        bad.append(f"gradient tensors differ: {sorted(set(card) ^ set(ref))}")
    if not set(zero_grad) <= set(ref):
        bad.append(f"no gradient of {sorted(set(zero_grad) - set(ref))}")
    largest = max((float(v.norm()) for v in ref.values()), default=1.0)
    residues = {}
    for k in sorted(set(card) & set(cpu) & set(ref)):
        if k in zero_grad:
            residues[k] = max(float((x[k] - ref[k]).norm())
                              for x in (card, cpu)) / largest
            if not residues[k] <= HEAD_ZERO_GRAD_TOL:
                bad.append(f"{k} (zero in exact arithmetic) "
                           f"{residues[k]:.3e} of the largest gradient")
            continue
        if not ref[k].any():
            zero += 1
            if card[k].any() or cpu[k].any():
                bad.append(f"{k}: zero in fp64, not in fp32")
            continue
        err, cpu_err = rel(card[k], ref[k]), rel(cpu[k], ref[k])
        rows.append((err, cpu_err, rel(card[k], cpu[k]), k))
        bound = max(factor * cpu_err, HEAD_GRAD_TOL)
        if conditioned:
            exact = grads["card fp64"][k]
            spread = max(rel(grads[f"card fp64 rounded {i}"][k], exact)
                         for i in range(COND_DRAWS))
            bound = max(bound, COND_FACTOR * spread)
            cond[k] = {"card": err, "cpu": cpu_err, "spread": spread,
                       "bound": bound}
        if not err <= bound:
            bad.append(f"{k} {err:.3e} (CPU fp32 {cpu_err:.3e}, bound "
                       f"{bound:.3e})")
    # (a tensor zero in exact arithmetic: its residue, over the largest
    # gradient's norm)
    fp64_errs = sorted((((float((grads["card fp64"][k] - ref[k]).norm())
                          / largest) if k in zero_grad
                         else rel(grads["card fp64"][k], ref[k]), k)
                        for k in ref if ref[k].any()), reverse=True) \
        if fp64_on_card else []
    bad += [f"{k}: card fp64 {e:.3e} from the CPU's" for e, k in fp64_errs
            if not e <= CARD_FP64_TOL]
    rows.sort(reverse=True)
    out = {"frames": int(cfg.TRAIN.WAY) * int(cfg.DATA.SEQ_LEN) * (
               int(cfg.TRAIN.SHOT) + int(cfg.TRAIN.QUERY_PER_CLASS)),
           "grad_tensors": len(rows), "zero_grad_tensors": zero,
           "grad_rel_l2_vs_fp64_worst": [[k, e, ce, cc]
                                         for e, ce, cc, k in rows[:6]],
           "grad_rel_l2_card_vs_cpu_max": max(
               (cc for _, _, cc, _ in rows), default=0.0),
           "loss": losses, "factor": factor, "floor": HEAD_GRAD_TOL}
    if zero_grad:
        out["zero_in_exact_arithmetic"] = residues
        out["zero_grad_tol"] = HEAD_ZERO_GRAD_TOL
    if fp64_on_card:
        out["card_fp64_vs_cpu_fp64_worst"] = [[k, e] for e, k in
                                              fp64_errs[:4]]
        out["card_fp64_tol"] = CARD_FP64_TOL
    if conditioned:
        # the tensors whose fp32 error is most of their bound
        out["conditioned_worst"] = dict(sorted(
            cond.items(), key=lambda kv: -kv[1]["card"] / kv[1]["bound"])[:6])
        out["cond_factor"] = COND_FACTOR
    log(json.dumps({"head_grads_vs_cpu": out}))
    if bad:
        raise AssertionError("head gradients on the card vs the CPU: "
                             + "; ".join(bad[:8]))
    return out


def _same_state(name: str, what: str, restored: dict, saved: dict) -> None:
    """``restored`` (a model's state_dict) is checkpoint_best's bit for
    bit."""
    if set(restored) != set(saved["model"]) or not all(
            torch.equal(restored[k].cpu(), v)
            for k, v in saved["model"].items()):
        raise AssertionError(f"{name}: {what}'s restored state_dict differs "
                             "from checkpoint_best's")


def phase_train_path(name: str) -> dict:
    from clipspm_tpu_torch.cli.run import main as cli_main
    from clipspm_tpu_torch.utils.config import load_config

    run = TRAIN_PATHS[name]
    spec = PATHS[run["eval_path"]]
    full = "depth" not in run
    depth = {**TRAIN_DEPTH, **run.get("depth", {})}
    episodes, val_episodes = depth["episodes"], depth["val_episodes"]
    counters = _counters()
    log(f"train path {name}: frames come from the same seeded uint8 "
        "source after the decode stage as the eval paths")
    data = split_root(spec, (run["train_classes"], run["train_videos"]))
    with tempfile.TemporaryDirectory() as root:
        ckpt = os.path.join(root, "ckpt")
        flags = ["--cfg", spec["cfg"], "--splits-root", data]
        opts = [*spec["opts"], *run.get("opts", ()), f"DATA.DATA_DIR={data}",
                f"CHECKPOINT.CHECKPOINT_DIR={ckpt}"]
        train_opts = [*opts, "TEST.ONLY_TEST=false",
                      f"TRAIN.TRAIN_EPISODES={episodes}",
                      f"TRAIN.VAL_FREQ={depth['val_freq']}",
                      f"TRAIN.PRINT_FREQ={depth['print_freq']}",
                      f"TEST.TEST_EPISODES={val_episodes}",
                      f"CHECKPOINT.SAVE_FREQ={depth['save_freq']}",
                      *([f"TRAIN.TASKS_PER_BATCH={depth['tasks_per_batch']}"]
                        if depth["tasks_per_batch"] else [])]
        stage_seconds = {}
        rec = _TrainRecorder()
        _fresh_peak()
        with rec.installed():
            _zero_counters(counters)
            t0 = time.perf_counter()
            res = cli_main([*flags, "--allow-random-weights", *train_opts])
            wall = time.perf_counter() - t0
            train_launches = _read_counters(counters)
        stage_seconds["cli"] = wall
        peak = torch.cuda.max_memory_allocated()
        learner, val_launches = rec.learner, rec.val_launches
        build_seconds = learner.build_seconds
        cfg = load_config(spec["cfg"], opts=train_opts, splits_root=data)
        tpb = learner.tasks_per_batch

        recs = _read_jsonl(os.path.join(ckpt, "metrics.jsonl"))
        losses = [r["value"] for r in recs
                  if r["tag"] == "loss/Train_loss[it]"]
        val_acc = [r["value"] for r in recs if r["tag"] == "acc/Test_acc"]
        with open(os.path.join(ckpt, "log.txt")) as f:
            stalls = [float(x) for x in
                      re.findall(r"host-stall (\d+)%", f.read())]
        steps = [(n, a.elapsed_time(b) / 1e3) for n, a, b in rec.steps]
        want_steps = [tpb] * (episodes // tpb)
        if episodes % tpb:
            want_steps.append(episodes % tpb)
        if [n for n, _ in steps] != want_steps \
                or len(losses) != len(want_steps) \
                or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"train path {name}: steps {steps}, losses "
                                 f"{losses}")
        if res["episodes"] != episodes:
            raise AssertionError(f"train path {name} ran {res['episodes']} "
                                 "episodes")
        per = run["launches"]
        want = {"train": {k: n * episodes for k, n in per.items()},
                "val": [{k: n * val_episodes for k, n in per.items()}]}
        if train_launches != want["train"] or val_launches != want["val"]:
            raise AssertionError(f"{name}: launches {train_launches} in "
                                 f"training and {val_launches} in "
                                 f"validation; expected {want}")
        tags = ["best"] + ([f"iter_{depth['save_freq']}"]
                           if depth["save_freq"] else [])
        for tag in tags:
            if not os.path.isfile(os.path.join(ckpt, f"checkpoint_{tag}",
                                               "checkpoint.pt")):
                raise AssertionError(f"{name}: no checkpoint_{tag}")

        if full:
            t0 = time.perf_counter()
            profile = profile_train_step(learner, cfg)
            stage_seconds["profile"] = time.perf_counter() - t0
            log(json.dumps({"train_profile": {"path": name, **profile}}))
        best = os.path.join(ckpt, "checkpoint_best")
        saved = torch.load(os.path.join(best, "checkpoint.pt"),
                           map_location="cpu", weights_only=True)
        if run.get("check_at_init"):
            from clipspm_tpu_torch.models.fsar import build_model
            from clipspm_tpu_torch.weights import random_init_

            learner.model.load_state_dict(random_init_(
                build_model(cfg), torch.Generator().manual_seed(
                    int(cfg.MODEL.SEED))).state_dict())
        if run["check"] is None:
            t0 = time.perf_counter()
            check = check_head_grads_against_cpu(
                learner, cfg, run.get("grad_factor", HEAD_GRAD_FACTOR),
                fp64_on_card=run.get("fp64_on_card", False),
                conditioned=run.get("conditioned", False),
                zero_grad=run.get("zero_grad", ()))
            stage_seconds["check"] = time.perf_counter() - t0
        del learner, rec

        only_test = None
        if full:
            # ONLY_TEST from checkpoint_best: the restored state is the
            # saved one bit for bit
            test_rec = _Recorder()
            with test_rec.installed():
                _zero_counters(counters)
                t0 = time.perf_counter()
                test_res = cli_main([*flags, *opts, "TEST.ONLY_TEST=true",
                                     f"TEST.TEST_EPISODES={val_episodes}",
                                     f"TEST.TEST_MODEL_PATH={best}"])
                test_wall = time.perf_counter() - t0
                test_launches = _read_counters(counters)
            stage_seconds["only_test"] = test_wall
            _same_state(name, "ONLY_TEST", test_rec.learner.model.state_dict(),
                        saved)
            if test_launches != want["val"][0]:
                raise AssertionError(f"{name}: launches {test_launches} in "
                                     "the ONLY_TEST run; expected "
                                     f"{want['val'][0]}")
            only_test = {"only_test_accuracy": test_res["accuracy"],
                         "only_test_seconds": test_wall}
            del test_rec
    if run["check"] is not None:
        t0 = time.perf_counter()
        check = check_train_step_against_cpu(spec["cfg"], spec["opts"],
                                             run["check"])
        stage_seconds["check"] = time.perf_counter() - t0
    rate_steps = steps[1:]
    out = {"path": name, "episodes": res["episodes"],
           "step_losses": losses, "step_episodes": [n for n, _ in steps],
           "step_device_seconds": [s for _, s in steps],
           f"train_episodes_per_s_steps_2_{len(steps)}":
               sum(n for n, _ in rate_steps) / sum(s for _, s in rate_steps),
           "host_stall_pct_per_log_line": stalls,
           "peak_memory_bytes": peak, "cli_seconds": wall,
           "build_seconds": build_seconds,
           "launches": {f"{k}_{stage}": n for stage, counts in (
               ("train", train_launches), ("val", val_launches[0]),
               *([("only_test", test_launches)] if only_test else []))
               for k, n in counts.items()},
           "val_accuracy_that_saved_best": val_acc[0],
           "best_meta": saved["meta"],
           **({"checkpoint_round_trip": "bit-equal", **only_test}
              if only_test else {}),
           "stage_seconds": stage_seconds,
           ("train_step_vs_cpu" if run["check"] is not None
            else "head_grads_vs_cpu"): check}
    log(json.dumps({"train_path": out}))
    return out


# The remat policies that keep more than the attention output, each a train
# path of its own: clipspm-vit-train's config (hmdb.yaml, ViT-B/16, bf16,
# remat chunks of 40 frames, 16 episodes an Adam step; 3 K1 launches an
# episode, K1's backward the plain replay) with MODEL.TRAIN_REMAT_POLICY set
# ("attn": the attention spelled out, its probabilities and output kept;
# "mlp": the attention output and the gelu output kept), REMAT_EPISODES of
# training through the port's CLI with no validation; then one small fp32
# step (TF32 off; one 5-way 1-shot 1-query episode, 80 frames, the model's
# own loss) on the card under the policy, whose loss and gradients must
# equal "full"'s on the card within REMAT_GRAD_TOL: a policy changes what
# is kept, not the arithmetic. The same step at bf16 (autocast, as the path
# trains): the policy's gradients within BF16_GRAD_TOL of those of "full"
# run with the policy's tagged operators (the same arithmetic: under
# "attn" the attention spelled out, not the fused SDPA kernel), over the
# whole gradient's Frobenius norm (four bf16 ulps at unit scale, as
# tests/test_torch_vit_switches.py holds them against the JAX package's);
# each one's distance from the fp32 gradients, and that of plain "full" at
# bf16, reported. Their rates beside the other policies': clipspm-vit-
# train's train profile.
REMAT_PATHS = {"clipspm-vit-train-attn": "attn",
               "clipspm-vit-train-mlp": "mlp"}
# one step of 4 (a trailing partial step of TASKS_PER_BATCH 16; cut from
# one full step of 16 for phase ddp, then from 8 for phase extras)
REMAT_EPISODES = 4
REMAT_GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
BF16_GRAD_TOL = 4 * 2.0 ** -8


def _rel_diff(got: dict, want: dict) -> float:
    """``|got - want| / |want|`` over all the gradients (Frobenius)."""
    num = sum(float(((got[k].float() - want[k]) ** 2).sum()) for k in want)
    return (num / sum(float((w ** 2).sum()) for w in want.values())) ** 0.5


@contextlib.contextmanager
def _full_with_tags(names):
    """The "full" policy (nothing kept, everything recomputed) running the
    tagged operators of ``names``: the tags entered in each chunk's forward
    and in its recompute, which the backward runs in its own thread on the
    card."""
    from clipspm_tpu_torch.models import visual

    remat_context = visual._remat_context

    def context_fn():
        return (visual._tagged(names, contextlib.nullcontext()),
                visual._tagged(names, contextlib.nullcontext()))

    visual._remat_context = (lambda policy: context_fn if policy == "full"
                             else remat_context(policy))
    try:
        yield
    finally:
        visual._remat_context = remat_context


def check_policy_grads(policy: str, cfg_path: str, opts) -> dict:
    """One step's loss and gradients on the card under ``policy`` against
    ``full``'s, from the same weights and episode: at fp32, and at bf16."""
    from clipspm_tpu_torch.models.fsar import build_model
    from clipspm_tpu_torch.models.visual import _TAGS_BY_POLICY
    from clipspm_tpu_torch.train.losses import loss_and_acc
    from clipspm_tpu_torch.utils.config import load_config
    from clipspm_tpu_torch.weights import random_init_

    cfg = load_config(cfg_path, opts=[*opts, "USE_AMP=false", "TRAIN.SHOT=1",
                                      "TRAIN.QUERY_PER_CLASS=1"])
    way, T = int(cfg.TRAIN.WAY), int(cfg.DATA.SEQ_LEN)
    R, C = int(cfg.DATA.IMG_SIZE), len(cfg.TRAIN.CLASS_NAME)
    dev = torch.device("cuda")
    model = random_init_(build_model(cfg), torch.Generator().manual_seed(4))
    model = model.to(dev).train()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.eval()
    gen = torch.Generator().manual_seed(6)
    sup, qry = (torch.rand(way, T, R, R, 3, generator=gen).to(dev)
                for _ in range(2))
    labels = torch.arange(way, device=dev)
    classes = torch.randperm(C, generator=gen)[:way].to(dev)
    text = torch.randn(C, model.arch.embed_dim, generator=gen).to(dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    losses, grads, seconds = {}, {}, {}
    try:
        for key, dtype, p, names in (
                ("full", None, "full", ()), (policy, None, policy, ()),
                ("full bf16", torch.bfloat16, "full", ()),
                ("full bf16 tagged", torch.bfloat16, "full",
                 _TAGS_BY_POLICY[policy]),
                (f"{policy} bf16", torch.bfloat16, policy, ())):
            model.train_remat_policy, model.compute_dtype = p, dtype
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _full_with_tags(names):
                out = model(sup, qry, labels, classes, classes, text, text)
                loss, _ = loss_and_acc("clipspm", out, labels, classes,
                                       classes, 1, cfg=cfg, train=True)
                loss.backward()
            torch.cuda.synchronize()
            seconds[key] = time.perf_counter() - t0
            losses[key] = loss.item()
            grads[key] = {k: v.grad.detach().clone()
                          for k, v in model.named_parameters()
                          if v.grad is not None}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    bf16_diff = _rel_diff(grads[f"{policy} bf16"], grads["full bf16 tagged"])
    bf16_vs_fp32 = {k: _rel_diff(grads[k], grads["full"]) for k in (
        "full bf16", "full bf16 tagged", f"{policy} bf16")}
    got, want = grads[policy], grads["full"]
    worst, bad = 0.0, []
    if set(got) != set(want):
        bad.append(f"gradients of {sorted(set(got) ^ set(want))[:4]}")
    for k in set(got) & set(want):
        worst = max(worst, (got[k] - want[k]).abs().max().item())
        if not torch.allclose(got[k], want[k], **REMAT_GRAD_TOL):
            bad.append(k)
    loss_rel = abs(losses[policy] - losses["full"]) / abs(losses["full"])
    if loss_rel > 2e-5:
        bad.append(f"loss {losses[policy]} against {losses['full']}")
    if not bf16_diff <= BF16_GRAD_TOL:
        bad.append(f"bf16 gradients {bf16_diff:.3e} from full's")
    out = {"policy": policy, "frames": 2 * way * T, "grad_tensors": len(got),
           "max_abs_grad_diff_vs_full": worst, "loss_rel_vs_full": loss_rel,
           "tol": REMAT_GRAD_TOL,
           "bf16_grad_rel_diff_vs_full_bf16_tagged": bf16_diff,
           "bf16_tol": BF16_GRAD_TOL,
           "bf16_grad_rel_diff_vs_fp32_full": bf16_vs_fp32,
           "step_seconds": seconds}
    if bad:
        raise AssertionError(f"remat policy {policy!r} on the card vs "
                             f"'full': {'; '.join(bad[:6])}")
    return out


def phase_remat_path(name: str) -> dict:
    from clipspm_tpu_torch.cli.run import main as cli_main

    policy = REMAT_PATHS[name]
    run = TRAIN_PATHS["clipspm-vit-train"]
    spec = PATHS[run["eval_path"]]
    counters = _counters()
    data = split_root(spec, (run["train_classes"], run["train_videos"]))
    with tempfile.TemporaryDirectory() as root:
        ckpt = os.path.join(root, "ckpt")
        argv = ["--cfg", spec["cfg"], "--splits-root", data,
                "--allow-random-weights", *spec["opts"],
                f"MODEL.TRAIN_REMAT_POLICY={policy}", f"DATA.DATA_DIR={data}",
                f"CHECKPOINT.CHECKPOINT_DIR={ckpt}", "TEST.ONLY_TEST=false",
                f"TRAIN.TRAIN_EPISODES={REMAT_EPISODES}", "TRAIN.VAL_FREQ=0",
                "CHECKPOINT.SAVE_FREQ=0", f"TRAIN.PRINT_FREQ={REMAT_EPISODES}"]
        rec = _TrainRecorder()
        _fresh_peak()
        with rec.installed():
            _zero_counters(counters)
            t0 = time.perf_counter()
            res = cli_main(argv)
            wall = time.perf_counter() - t0
            launches = _read_counters(counters)
        peak = torch.cuda.max_memory_allocated()
        model = rec.learner.model
        losses = [r["value"] for r in _read_jsonl(
            os.path.join(ckpt, "metrics.jsonl"))
            if r["tag"] == "loss/Train_loss[it]"]
        steps = [(n, a.elapsed_time(b) / 1e3) for n, a, b in rec.steps]
        tpb = rec.learner.tasks_per_batch
        want_launches = {k: n * REMAT_EPISODES
                         for k, n in run["launches"].items()}
        chunking = (model.train_remat_policy, model.train_encode_chunk)
        if chunking != (policy, 40):
            raise AssertionError(f"{name}: the model trains under "
                                 f"{model.train_remat_policy!r} in chunks of "
                                 f"{model.train_encode_chunk}")
        want_steps = [tpb] * (REMAT_EPISODES // tpb) + (
            [REMAT_EPISODES % tpb] if REMAT_EPISODES % tpb else [])
        if [n for n, _ in steps] != want_steps \
                or len(losses) != len(steps) \
                or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{name}: steps {steps}, losses {losses}")
        if launches != want_launches or rec.val_launches:
            raise AssertionError(f"{name}: launches {launches} (validations "
                                 f"{rec.val_launches}); expected "
                                 f"{want_launches} and no validation")
        build_seconds = rec.learner.build_seconds
        del rec, model
    t0 = time.perf_counter()
    grads = check_policy_grads(policy, spec["cfg"], spec["opts"])
    out = {"path": name, "policy": policy, "card": CARD,
           "episodes": res["episodes"],
           "step_losses": losses, "step_episodes": [n for n, _ in steps],
           "step_device_seconds": [s for _, s in steps],
           "train_episodes_per_s_step_1": sum(n for n, _ in steps)
           / sum(t for _, t in steps),
           "peak_memory_bytes": peak, "cli_seconds": wall,
           "build_seconds": build_seconds, "launches": launches,
           "grads_vs_full": grads,
           "check_seconds": time.perf_counter() - t0}
    log(json.dumps({"remat_path": out}))
    return out


# Phase ddp: DEVICE.NUM_CHIPS episode parallelism (clipspm_tpu_torch/parallel/
# mesh.py). The machine may show one card, and NCCL refuses two ranks on one
# device, so two ranks share cuda:0 over gloo (whose collectives take CUDA
# tensors), each in a process of its own, held against the single-process
# oracle (parallel_episodes=2), which runs in its own process before them
# and ends, freeing its memory, before they start; each process runs the
# checks below in turn, freeing the card's memory between them. Frames are
# the seeded source after the decode stage, as above.
# - clipspm-vit-train and ta2n-train: a step of 4 episodes and a masked
#   step of 2 (the trailing partial batch) at fp32, TF32 off (the config's
#   model with its autocast off): each episode's loss, and the parameters
#   and every BatchNorm buffer after each step, at DDP_STATE_TOL; K1 (3 an
#   episode, 12 over the ranks in the first step) and K2 (1 an episode)
#   counted over the ranks; then a 2-episode warm-up and a timed
#   4-episode step at the config's AMP (bf16, TF32 on) at N=2 on one card
#   beside N=1 (the oracle), the all-reduces' seconds and each process's
#   peak memory. clipspm-train (RN50, 44.7 GB a rank) does not fit twice.
# - clipspm RN50 evaluation: the uncached evaluator (32 episodes, one step,
#   16 a rank) and the feature-cached one (24 episodes) at N=2 against N=1
#   (the config's AMP): per-episode loss and accuracy equal, the gathered
#   table within DDP_TABLE_TOL of N=1's, accuracy and CI equal. N=1 encodes
#   DDP_ENCODE_VIDEOS a step, each rank as many (the same batch shape).
# - the CLI's refusal of DEVICE.NUM_CHIPS=2 with one card visible (the JAX
#   ValueError, before anything is built); with two or more cards, the
#   same paths' train losses and ONLY_TEST accuracy through the CLI over
#   NCCL at NUM_CHIPS=2 against 1, within 1e-3.
DDP_TRAIN_PATHS = ("clipspm-vit-train", "ta2n-train")
# (cut from steps of 16 and 8, a timed step of 8, 64 uncached and 50 cached
# episodes, to make room for phase extras, then the steps to 4 and 2 for
# phase convergence; an even count, so each of the two ranks runs half; the
# first step holds phase tp's TP_STEP_EPISODES)
DDP_STEPS = (4, 2)
# (the warm-up a multiple of the two ranks: each rank's loader shards the
# stream in rounds of one episode a rank)
DDP_TIMED = (2, 4)
DDP_STATE_TOL = dict(rtol=1e-4, atol=1e-5)
DDP_LOSS_TOL = 1e-4
DDP_EVAL_EPISODES, DDP_CACHED_EPISODES, DDP_ENCODE_VIDEOS = 32, 24, 15
# the table under AMP on the card: batches of the same shape on both sides,
# so equal but for an algorithm change between processes: two bf16 ulps of
# the largest feature
DDP_TABLE_TOL = 2.0 ** -7
DDP_CLI_TOL = 1e-3


def _ddp_cfg(spec: dict, root: str, world: int, opts=()):
    from clipspm_tpu_torch.utils.config import load_config

    return load_config(spec["cfg"], splits_root=root, opts=[
        *spec["opts"], f"DATA.DATA_DIR={root}", f"DEVICE.NUM_CHIPS={world}",
        f"CHECKPOINT.CHECKPOINT_DIR={os.path.join(root, 'ckpt')}",
        "DATA.NUM_WORKERS=4", *opts])


def _ddp_process(mesh):
    """A ddp check's set-up in its process: seeded frames after the decode
    stage, the card's memory freed, a fresh peak, counters at 0; returns
    (counters, mesh or None)."""
    import gc

    from clipspm_tpu_torch.data import pipeline
    from clipspm_tpu_torch.train import feature_cache

    pipeline.decode_path_lists = seeded_frames
    feature_cache.decode_path_lists = seeded_frames
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters = _counters()
    _zero_counters(counters)
    return counters, (mesh if mesh.world > 1 else None)


def _ddp_rank(mesh, roots, out):
    """One ddp process, the oracle and N=1 (a group of one) or a rank of
    two: every train check, then the eval check, each timed; the oracle's
    process also phase tp's one-process evaluation."""
    for name in DDP_TRAIN_PATHS:
        _ddp_train_rank(mesh, name, roots[name], out)
    _ddp_eval_rank(mesh, roots["eval"], out)
    if mesh.world == 1:
        _tp_eval_rank(mesh, roots["eval"], out)


class _Timed:
    """Times a mesh's all-reduces (each synchronised on both sides):
    gradients (one call a step, many tensors) apart from the BatchNorm
    means (one flat tensor a microstep)."""

    def __init__(self, mesh):
        self.seconds = {"gradients": 0.0, "batchnorm": 0.0}
        if mesh is None:
            return
        all_reduce = type(mesh).all_reduce_sum

        def timed(m, tensors):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce(m, tensors)
            torch.cuda.synchronize()
            self.seconds["gradients" if len(tensors) > 1 else "batchnorm"] \
                += time.perf_counter() - t0
        type(mesh).all_reduce_sum = timed


def _ddp_train_rank(mesh, name, root, out):
    """One process's ddp train check: the oracle (a group of one,
    parallel_episodes=2) or a rank. Writes its per-episode losses, launch
    counts, timings and peak; the oracle its state after each step, which
    the ranks hold themselves against."""
    from clipspm_tpu_torch import set_matmul_precision
    from clipspm_tpu_torch.train.setup import build_learner

    t_check = time.perf_counter()
    counters, group = _ddp_process(mesh)
    spec = PATHS[TRAIN_PATHS[name]["eval_path"]]
    cfg = _ddp_cfg(spec, root, mesh.world, ("TEST.ONLY_TEST=false",))
    learner = build_learner(cfg, log_fn=lambda *_: None, device="cuda:0",
                            allow_random_weights=True, mesh=group)
    if group is None:
        learner.parallel_episodes = 2
    model, dtype = learner.model, learner.model.compute_dtype
    losses = []
    episode_loss = learner._episode_loss

    def recorded(ep, train=True):
        out_ = episode_loss(ep, train)
        losses.append(float(out_[0].detach()))
        return out_

    learner._episode_loss = recorded
    it = iter(learner.train_source)
    res = {"losses": {}, "launches": [], "state_vs_oracle": []}
    model.compute_dtype = None
    set_matmul_precision(False)
    first = [next(it) for _ in range(DDP_STEPS[0])]
    if group is None and name == TP_TRAIN_PATH:
        _tp_reference_step(learner, first[:TP_STEP_EPISODES], losses, out)
    for step, n in enumerate(DDP_STEPS):
        start, before = learner.episode, len(losses)
        _zero_counters(counters)
        learner.train_episodes(first if step == 0
                               else [next(it) for _ in range(n)])
        torch.cuda.synchronize()
        res["launches"].append(_read_counters(counters))
        for e, loss in zip(learner._positions(n), losses[before:]):
            res["losses"][start + e] = loss
        path = os.path.join(out, f"{name}-oracle-step{step}.pt")
        if group is None:
            torch.save({k: v.cpu() for k, v in
                        model.state_dict().items()}, path)
            continue
        want = torch.load(path, map_location="cuda:0", weights_only=True)
        worst, bad = 0.0, []
        for k, v in model.state_dict().items():
            diff = (v.double() - want[k].double()).abs()
            worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
            if not torch.allclose(v.double(), want[k].double(),
                                  **DDP_STATE_TOL):
                bad.append(k)
        res["state_vs_oracle"].append({"max_abs_diff": worst,
                                       "off": bad[:5], "n_off": len(bad)})
    learner._episode_loss = episode_loss
    model.compute_dtype = dtype
    set_matmul_precision(True)
    timer = _Timed(group)
    warm, timed = DDP_TIMED
    learner.train_episodes([next(it) for _ in range(warm)])
    timer.seconds = {k: 0.0 for k in timer.seconds}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    learner.train_episodes([next(it) for _ in range(timed)])
    torch.cuda.synchronize()
    res["amp_step_seconds"] = time.perf_counter() - t0
    res["all_reduce_seconds"] = timer.seconds
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    learner.close()
    res["seconds"] = time.perf_counter() - t_check
    torch.save(res, os.path.join(out, f"{name}-{mesh.world}-{mesh.rank}.pt"))


def _ddp_eval_rank(mesh, root, out):
    """One process's ddp eval check (N=1 or a rank): clipspm RN50,
    uncached then feature-cached, at the config's AMP."""
    from clipspm_tpu_torch.train import feature_cache
    from clipspm_tpu_torch.train.setup import (build_catalog_and_sampler,
                                               build_learner)

    t_check = time.perf_counter()
    counters, group = _ddp_process(mesh)
    spec = PATHS["clipspm"]
    cfg = _ddp_cfg(spec, root, mesh.world, (
        "TEST.ONLY_TEST=true",
        f"TEST.CACHE_ENCODE_VIDEOS={DDP_ENCODE_VIDEOS * mesh.world}"))
    learner = build_learner(cfg, log_fn=lambda *_: None, device="cuda:0",
                            allow_random_weights=True, mesh=group)
    t0 = time.perf_counter()
    unc = learner.evaluate(DDP_EVAL_EPISODES,
                           batch_size=int(cfg.TEST.EVAL_BATCH))
    res = {"uncached": {"loss_acc": unc["loss_acc"],
                        "seconds": time.perf_counter() - t0,
                        "launches": _read_counters(counters)}}
    learner.test_source.close()
    catalog, sampler = build_catalog_and_sampler(
        cfg, "test", False, int(cfg.TEST.QUERY_PER_CLASS))
    ev = feature_cache.cached_evaluator(cfg, learner, catalog, sampler,
                                        log_fn=lambda *_: None)
    tables = []
    build_table = ev.build_table
    ev.build_table = lambda plans: tables.append(build_table(plans)) \
        or tables[-1]
    _zero_counters(counters)
    try:
        cached = ev.evaluate(DDP_CACHED_EPISODES)
    finally:
        ev.close()
        learner.close()
    res["cached"] = {k: cached[k] for k in ("accuracy", "confidence",
                                            "loss", "unique_videos")}
    res["cached"]["launches"] = _read_counters(counters)
    res["table"] = tables[0][0].cpu()
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    res["seconds"] = time.perf_counter() - t_check
    if mesh.is_main:
        torch.save(res, os.path.join(out, f"eval-{mesh.world}.pt"))


def _ddp_spawn(fn, world, args, tp=1) -> float:
    """``fn`` over ``world`` processes on cuda:0 over gloo (a grid of
    ``tp``); seconds."""
    from clipspm_tpu_torch.parallel import mesh as pmesh

    _fresh_peak()
    t0 = time.perf_counter()
    pmesh.spawn(fn, world, "cuda", args=args, backend="gloo",
                devices=["cuda:0"] * world, timeout_s=900, tp=tp)
    return time.perf_counter() - t0


def _ddp_write_train_split(root, name):
    run = TRAIN_PATHS[name]
    spec = PATHS[run["eval_path"]]
    write_split(root, spec["frame_dir"], spec["split_dir"], spec["classes"],
                spec["videos"], SPLIT_FRAMES, SPLIT_PX)
    write_split(root, spec["frame_dir"], spec["split_dir"],
                run["train_classes"], run["train_videos"], SPLIT_FRAMES,
                SPLIT_PX, mode="train")


def ddp_train_check(name: str, out: str) -> dict:
    per = TRAIN_PATHS[name]["launches"]
    oracle = torch.load(os.path.join(out, f"{name}-1-0.pt"),
                        weights_only=False)
    ranks = [torch.load(os.path.join(out, f"{name}-2-{r}.pt"),
                        weights_only=False) for r in range(2)]
    want = oracle["losses"]
    got = {e: v for r in ranks for e, v in r["losses"].items()}
    if sorted(got) != sorted(want) or len(want) != sum(DDP_STEPS):
        raise AssertionError(f"ddp {name}: episodes {sorted(got)} on the "
                             f"ranks, {sorted(want)} in the oracle")
    loss_err = max(abs(got[e] - want[e]) / max(abs(want[e]), 1e-30)
                   for e in want)
    if not loss_err <= DDP_LOSS_TOL:
        raise AssertionError(f"ddp {name}: per-episode losses {loss_err:.3e}"
                             f" from the oracle's")
    for r in ranks:
        for step in r["state_vs_oracle"]:
            if step["n_off"]:
                raise AssertionError(f"ddp {name}: state after a step off "
                                     f"the oracle's: {step}")
    for step, n in enumerate(DDP_STEPS):
        for k, per_episode in per.items():
            total = sum(r["launches"][step][k] for r in ranks)
            if total != per_episode * n or \
                    oracle["launches"][step][k] != per_episode * n:
                raise AssertionError(
                    f"ddp {name}: {k} launched {total} times over the ranks"
                    f" and {oracle['launches'][step][k]} in the oracle in "
                    f"step {step}; expected {per_episode * n}")
    out = {"path": name, "backend": "gloo, two ranks on cuda:0",
           "episodes": sum(DDP_STEPS), "step_episodes": list(DDP_STEPS),
           "loss_max_rel_diff": loss_err, "loss_tol": DDP_LOSS_TOL,
           "state_max_abs_diff": [max(r["state_vs_oracle"][s]["max_abs_diff"]
                                      for r in ranks)
                                  for s in range(len(DDP_STEPS))],
           "state_tol": DDP_STATE_TOL,
           "launches_step_1": {k: [r["launches"][0][k] for r in ranks]
                               for k in per},
           "amp_step_seconds": {"n1_oracle": oracle["amp_step_seconds"],
                                "n2_one_card": max(r["amp_step_seconds"]
                                                   for r in ranks)},
           "amp_step_episodes": DDP_TIMED[1],
           "all_reduce_seconds_step": [r["all_reduce_seconds"]
                                       for r in ranks],
           "peak_memory_bytes": {"oracle": oracle["peak_memory_bytes"],
                                 "ranks": [r["peak_memory_bytes"]
                                           for r in ranks]},
           "check_seconds": {"oracle": oracle["seconds"],
                             "ranks": [r["seconds"] for r in ranks]},
           "card": CARD}
    log(json.dumps({"ddp_train": out}))
    return out


def ddp_eval_check(out: str) -> dict:
    import numpy as np

    one, two = (torch.load(os.path.join(out, f"eval-{w}.pt"),
                           weights_only=False) for w in (1, 2))
    la1, la2 = one["uncached"]["loss_acc"], two["uncached"]["loss_acc"]
    if la1.shape != (DDP_EVAL_EPISODES, 2) or la2.shape != la1.shape \
            or not np.array_equal(la1[:, 1], la2[:, 1]) \
            or not np.allclose(la1[:, 0], la2[:, 0], rtol=1e-6, atol=0):
        raise AssertionError(
            f"ddp uncached: per-episode (loss, acc) at N=2 differ from "
            f"N=1's: max {np.abs(la1 - la2).max() if la1.shape == la2.shape else la2.shape}")
    t1, t2 = one["table"].float(), two["table"].float()
    table_err = float((t1 - t2).abs().max()) / float(t1.abs().max())
    if t1.shape != t2.shape or not table_err <= DDP_TABLE_TOL:
        raise AssertionError(f"ddp cached: table {tuple(t2.shape)} at N=2 "
                             f"vs {tuple(t1.shape)}, {table_err:.3e} of the "
                             "largest")
    c1, c2 = one["cached"], two["cached"]
    if (c1["accuracy"], c1["confidence"]) != (c2["accuracy"],
                                              c2["confidence"]):
        raise AssertionError(f"ddp cached: N=2 {c2} against N=1 {c1}")
    per = PATHS["clipspm"]["launches"]["K1"]
    want = {"uncached": per * DDP_EVAL_EPISODES,
            "cached": per * DDP_CACHED_EPISODES}
    launches = {k: [one[k]["launches"]["K1"], two[k]["launches"]["K1"]]
                for k in want}
    if any(launches[k] != [n, n // 2] for k, n in want.items()):
        raise AssertionError(f"ddp eval: K1 launches {launches} at N=1 and "
                             f"on rank 0 of 2, expected {want} and half")
    out = {"path": "clipspm (RN50)", "backend": "gloo, two ranks on cuda:0",
           "uncached_episodes": DDP_EVAL_EPISODES,
           "uncached_loss_max_abs_diff": float(np.abs(la1 - la2).max()),
           "cached_episodes": DDP_CACHED_EPISODES,
           "table_shape": list(t1.shape), "table_dtype": str(one["table"]
                                                             .dtype),
           "table_max_diff_of_largest": table_err,
           "table_tol": DDP_TABLE_TOL,
           "cached_n1": c1, "cached_n2": c2,
           "k1_launches_n1_and_rank0": launches,
           "uncached_seconds": {"n1": one["uncached"]["seconds"],
                                "n2_one_card": two["uncached"]["seconds"]},
           "peak_memory_bytes": {"n1": one["peak_memory_bytes"],
                                 "rank0": two["peak_memory_bytes"]},
           "check_seconds": {"n1": one["seconds"],
                             "rank0": two["seconds"]},
           "card": CARD}
    log(json.dumps({"ddp_eval": out}))
    return out


def ddp_cli_refusal(key: str = "NUM_CHIPS") -> str:
    """With one card: the CLI refuses ``DEVICE.<key>=2`` (the JAX
    ``ValueError``) before it writes anything."""
    from clipspm_tpu_torch.cli.run import main as cli_main

    with tempfile.TemporaryDirectory() as root:
        try:
            cli_main(["--cfg", PATHS["clipspm"]["cfg"],
                      "--allow-random-weights", f"DEVICE.{key}=2",
                      f"CHECKPOINT.CHECKPOINT_DIR={root}"])
        except ValueError as e:
            if "needs 2 devices but only 1 are visible" not in str(e):
                raise
            if os.listdir(root):
                raise AssertionError("the refusal wrote under the "
                                     f"checkpoint dir: {os.listdir(root)}")
            return str(e)
    raise AssertionError(f"DEVICE.{key}=2 ran with one card visible")


def _train_losses(ckpt: str) -> list:
    return [r["value"] for r in _read_jsonl(os.path.join(ckpt,
                                                         "metrics.jsonl"))
            if r["tag"] == "loss/Train_loss[it]"]


def ddp_nccl_cli(name: str, key: str = "NUM_CHIPS") -> dict:
    """With two or more cards: the train path through the CLI at
    ``DEVICE.<key>=2`` (NUM_CHIPS or TP) over NCCL against 1 (DDP_STEPS'
    episodes, one step of 16 and a masked one), then ONLY_TEST from each
    run's state."""
    from clipspm_tpu_torch.cli.run import main as cli_main

    run = TRAIN_PATHS[name]
    spec = PATHS[run["eval_path"]]
    res = {}
    with tempfile.TemporaryDirectory() as root:
        _ddp_write_train_split(root, name)
        for world in (1, 2):
            ckpt = os.path.join(root, f"ckpt{world}")
            flags = ["--cfg", spec["cfg"], "--splits-root", root,
                     "--allow-random-weights", *spec["opts"],
                     f"DATA.DATA_DIR={root}", f"DEVICE.{key}={world}",
                     f"CHECKPOINT.CHECKPOINT_DIR={ckpt}"]
            t0 = time.perf_counter()
            cli_main([*flags, "TEST.ONLY_TEST=false",
                      f"TRAIN.TRAIN_EPISODES={sum(DDP_STEPS)}",
                      "TRAIN.VAL_FREQ=0", f"TRAIN.PRINT_FREQ={DDP_STEPS[0]}"])
            test = cli_main([*flags, "TEST.ONLY_TEST=true",
                             f"TEST.TEST_EPISODES={DDP_CACHED_EPISODES}"])
            res[world] = {"train_losses": _train_losses(ckpt),
                          "only_test_accuracy": test["accuracy"],
                          "seconds": time.perf_counter() - t0}
    l1, l2 = res[1]["train_losses"], res[2]["train_losses"]
    if len(l1) != len(DDP_STEPS) or len(l2) != len(l1) or any(
            abs(a - b) > DDP_CLI_TOL * max(1.0, abs(a))
            for a, b in zip(l1, l2)) or abs(
            res[1]["only_test_accuracy"] - res[2]["only_test_accuracy"]) \
            > DDP_CLI_TOL:
        raise AssertionError(f"DEVICE.{key} {name} over NCCL: {res}")
    out = {"path": name, "backend": "nccl, cuda:0 and cuda:1", "key": key,
           **{f"n{w}": r for w, r in res.items()}, "card": CARD}
    log(json.dumps({"ddp_nccl" if key == "NUM_CHIPS" else "tp_nccl": out}))
    return out


def phase_ddp(tmp: str = None) -> dict:
    """Episode parallelism: the one-card gloo half always, the NCCL half
    where two or more cards are visible. Its splits and results stay under
    ``tmp`` (phase tp reads them); a directory of its own without one."""
    if tmp is None:
        with tempfile.TemporaryDirectory() as tmp:
            return phase_ddp(tmp)
    roots = _ddp_roots(tmp)
    for name in DDP_TRAIN_PATHS:
        _ddp_write_train_split(roots[name], name)
    res = os.path.join(tmp, "out")
    os.makedirs(res)
    seconds = {"oracle and N=1": _ddp_spawn(_ddp_rank, 1, (roots, res)),
               "two ranks": _ddp_spawn(_ddp_rank, 2, (roots, res))}
    log(json.dumps({"ddp_process_seconds": seconds}))
    out = {"train": {name: ddp_train_check(name, res)
                     for name in DDP_TRAIN_PATHS},
           "eval": ddp_eval_check(res)}
    cards = torch.cuda.device_count()
    if cards < 2:
        out["cli_refusal"] = ddp_cli_refusal()
        log(f"ddp: {cards} card visible: two ranks on cuda:0 over gloo "
            "(backend='gloo') ran; the NCCL half needs two cards and did "
            "not run")
    else:
        out["nccl"] = {name: ddp_nccl_cli(name) for name in DDP_TRAIN_PATHS}
        log(f"ddp: {cards} cards visible: two ranks on cuda:0 over gloo "
            "(backend='gloo') and the NCCL half over cuda:0 and cuda:1 ran")
    return out


def _ddp_roots(tmp: str) -> dict:
    roots = {name: os.path.join(tmp, name) for name in DDP_TRAIN_PATHS}
    # the eval check's clipspm split is clipspm-vit-train's test split
    roots["eval"] = roots["clipspm-vit-train"]
    return roots


# Phase tp: DEVICE.TP (parallel/tensor.py) on phase ddp's splits, against
# its oracle's process (parallel_episodes=2, TF32 off):
# - clipspm-vit-train at dp=2 x tp=2: four ranks sharing cuda:0 over gloo,
#   a step of the stream's first TP_STEP_EPISODES episodes at fp32, against
#   the same step in the oracle's process (_tp_reference_step; its losses
#   are the oracle's first step's). Each episode's loss within TP_LOSS_TOL
#   (relative), the gathered state after the step (parameters and Adam
#   moments) within DDP_STATE_TOL; the replicated parameters' gradients
#   as the tp ranks computed them, before the learner's broadcast from tp
#   rank 0, each within TP_REPLICA_GRAD_TOL of tp rank 0's (relative L2;
#   the tp all-reduce hands them the same bits, a backward kernel that
#   adds with atomics rounds them apart: the count of those not
#   bit-identical and the largest differences are logged), and after the
#   step every replicated parameter and buffer bit-identical across the
#   tp ranks; K1's launches 3 an episode on every rank
#   (the tp ranks of a dp index run its episodes, the head replicated);
#   each rank's peak memory and the seconds of the tower's tp all-reduces
#   in the step (each synchronised on both sides);
# - clipspm RN50 uncached evaluation at dp=1 x tp=2 (the attention pool's
#   c_proj sharded, the conv tower replicated) against the oracle's
#   process at fp32: TP_EVAL_EPISODES episodes, each loss within
#   TP_EVAL_TOL (relative), each accuracy equal;
# - with one card the CLI's refusal of DEVICE.TP=2; with two or more the
#   train path through the CLI at TP=2 over NCCL against 1.
TP_TRAIN_PATH = "clipspm-vit-train"
TP_GRID = (2, 2)
# (cut from the oracle's first step of 16: each tp all-reduce goes through
# host memory over gloo, and the 16-episode step took 199 s, 172 s of it in
# the tower's 5,184 all-reduces of 24 MB a rank, on an H100 80GB HBM3 at
# 700 W; a step of 4 is two microsteps of an episode on each dp index, so
# it holds the accumulation across microsteps)
TP_STEP_EPISODES = 4
TP_LOSS_TOL = 1e-6
# (tensors whose L2 norm is above 1e-6, as tests/test_torch_ddp.py holds
# gradients; a fault, such as a sum over the wrong group, is off by O(1))
TP_REPLICA_GRAD_TOL = 1e-4
# (cut from 16 for phase extras)
TP_EVAL_EPISODES, TP_EVAL_TOL = 8, 1e-5


def _cpu_tree(tree):
    if torch.is_tensor(tree):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu_tree(v) for v in tree)
    return tree


class _TPTimed:
    """Times the tower's tp all-reduces (``parallel/tensor.py``'s, each
    synchronised on both sides)."""

    def __init__(self):
        from clipspm_tpu_torch.parallel import tensor as ptensor

        self.seconds, self.calls = 0.0, 0
        real, timer = ptensor.dist, self

        class Timed:
            def __getattr__(self, key):
                return getattr(real, key)

            def all_reduce(self, t, *args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                real.all_reduce(t, *args, **kwargs)
                torch.cuda.synchronize()
                timer.seconds += time.perf_counter() - t0
                timer.calls += 1

        ptensor.dist = Timed()


def _digest(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().contiguous().reshape(-1)
                          .view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def _tp_reference_step(learner, episodes, losses, out):
    """In the oracle's process, before its first step: phase tp's
    reference, one TP_STEP_EPISODES step at fp32 from the same initial
    state over the stream's first episodes (each episode's loss, the state
    and the Adam moments after it), then the learner back to its initial
    state for the ddp steps."""
    import copy

    start = copy.deepcopy(learner.state_dict())
    before = len(losses)
    learner.train_episodes(episodes)
    torch.save({"losses": losses[before:],
                "model": _cpu_tree(learner.model.state_dict()),
                "optimizer": _cpu_tree(learner.optimizer.state_dict())},
               os.path.join(out, "tp-reference.pt"))
    del losses[before:]
    learner.load_state_dict(start)


def _tp_train_rank(mesh, root, out):
    """One rank of the dp=2 x tp=2 train check: the first step at fp32, the
    gathered state against the oracle's, digests of the replicated
    parameters, launches, peak and the tp all-reduces' seconds."""
    from clipspm_tpu_torch import set_matmul_precision
    from clipspm_tpu_torch.train.setup import build_learner

    t_check = time.perf_counter()
    counters, group = _ddp_process(mesh)
    spec = PATHS[TRAIN_PATHS[TP_TRAIN_PATH]["eval_path"]]
    cfg = _ddp_cfg(spec, root, mesh.dp_world, ("TEST.ONLY_TEST=false",
                                               f"DEVICE.TP={mesh.tp}"))
    learner = build_learner(cfg, log_fn=lambda *_: None, device="cuda:0",
                            allow_random_weights=True, mesh=group)
    losses = []
    episode_loss = learner._episode_loss

    def recorded(ep, train=True):
        out_ = episode_loss(ep, train)
        losses.append(float(out_[0].detach()))
        return out_

    learner._episode_loss = recorded
    learner.model.compute_dtype = None
    set_matmul_precision(False)
    it = iter(learner.train_source)
    n = TP_STEP_EPISODES
    episodes = [next(it) for _ in range(n)]
    # the replicated gradients as this rank computed them, before the
    # learner's broadcast from tp rank 0
    replicated_grads = []
    broadcast = type(group).tp_broadcast_

    def recorded(mesh_, tensors):
        replicated_grads.append([t.detach().cpu().clone() for t in tensors])
        broadcast(mesh_, tensors)

    type(group).tp_broadcast_ = recorded
    timer = _TPTimed()
    _zero_counters(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    learner.train_episodes(episodes)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = _read_counters(counters)
    state = learner.state_dict()
    replicas = {**{k: p for k, p in learner.model.named_parameters()
                   if learner.shards[k] is None},
                **dict(learner.model.named_buffers())}
    res = {"dp_rank": mesh.dp_rank,
           "losses": dict(zip(learner._positions(n), losses)),
           "launches": launches, "step_seconds": step_s,
           "tp_all_reduce_seconds": timer.seconds,
           "tp_all_reduce_calls": timer.calls,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "replicated": {k: _digest(t) for k, t in replicas.items()},
           "n_sharded": sum(s is not None for s in learner.shards.values())}
    torch.save(_cpu_tree(replicas),
               os.path.join(out, f"tp-replicas-{mesh.rank}.pt"))
    names = [k for k, _ in learner.model.named_parameters()
             if learner.shards[k] is None]
    if len(replicated_grads) != 1 or len(replicated_grads[0]) < len(names):
        raise AssertionError(f"tp: {len(replicated_grads)} broadcasts of "
                             "the replicated gradients in one step")
    torch.save(dict(zip(names, replicated_grads[0])),
               os.path.join(out, f"tp-grads-{mesh.rank}.pt"))
    ref = torch.load(os.path.join(out, "tp-reference.pt"),
                     map_location="cuda:0", weights_only=True)
    want, want_optim = ref["model"], ref["optimizer"]
    worst, bad = {"model": 0.0, "moments": 0.0}, []

    def held(kind, key, got, ref):
        diff = (got.double() - ref.double()).abs()
        worst[kind] = max(worst[kind], float(diff.max()) if diff.numel()
                          else 0.0)
        if got.shape != ref.shape or not torch.allclose(
                got.double(), ref.double(), **DDP_STATE_TOL):
            bad.append(key)

    for key, v in state["model"].items():
        held("model", key, v, want[key])
    for i, entry in want_optim["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            held("moments", f"{i}.{k}", state["optimizer"]["state"][i][k],
                 entry[k])
    res["state_vs_oracle"] = {"max_abs_diff": worst, "off": bad[:5],
                              "n_off": len(bad)}
    learner.close()
    res["seconds"] = time.perf_counter() - t_check
    torch.save(res, os.path.join(out, f"tp-train-{mesh.rank}.pt"))


def _tp_eval_rank(mesh, root, out):
    """clipspm RN50 uncached evaluation at fp32: in the oracle's process (a
    group of one), or a rank of dp=1 x tp=2."""
    from clipspm_tpu_torch import set_matmul_precision
    from clipspm_tpu_torch.train.setup import build_learner

    t_check = time.perf_counter()
    counters, group = _ddp_process(mesh)
    spec = PATHS["clipspm"]
    cfg = _ddp_cfg(spec, root, 1, ("TEST.ONLY_TEST=true",
                                   f"DEVICE.TP={mesh.tp}"))
    learner = build_learner(cfg, log_fn=lambda *_: None, device="cuda:0",
                            allow_random_weights=True, mesh=group)
    learner.model.compute_dtype = None
    set_matmul_precision(False)
    _zero_counters(counters)
    t0 = time.perf_counter()
    got = learner.evaluate(TP_EVAL_EPISODES,
                           batch_size=int(cfg.TEST.EVAL_BATCH))
    res = {"loss_acc": got["loss_acc"], "eval_seconds":
           time.perf_counter() - t0, "launches": _read_counters(counters),
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    learner.close()
    set_matmul_precision(True)
    res["seconds"] = time.perf_counter() - t_check
    torch.save(res, os.path.join(out, f"tp-eval-{mesh.world}-{mesh.rank}.pt"))


def _tp_ranks(mesh, roots, out):
    if mesh.world == TP_GRID[0] * TP_GRID[1]:
        _tp_train_rank(mesh, roots[TP_TRAIN_PATH], out)
    else:
        _tp_eval_rank(mesh, roots["eval"], out)


def tp_train_check(out: str) -> dict:
    world = TP_GRID[0] * TP_GRID[1]
    oracle = torch.load(os.path.join(out, f"{TP_TRAIN_PATH}-1-0.pt"),
                        weights_only=False)
    ref = torch.load(os.path.join(out, "tp-reference.pt"),
                     weights_only=False)
    ranks = [torch.load(os.path.join(out, f"tp-train-{r}.pt"),
                        weights_only=False) for r in range(world)]
    n = TP_STEP_EPISODES
    want = dict(enumerate(ref["losses"]))
    if len(want) != n or any(abs(v - oracle["losses"][e]) > TP_LOSS_TOL
                             * abs(oracle["losses"][e])
                             for e, v in want.items()):
        first = [oracle["losses"][e] for e in range(n)]
        raise AssertionError("tp: the reference step's losses "
                             f"{ref['losses']} are not the oracle's first "
                             f"step's {first}")
    loss_err = 0.0
    for r in ranks:
        if sorted(r["losses"]) != list(range(r["dp_rank"], n, TP_GRID[0])):
            raise AssertionError(f"tp: a rank of dp index {r['dp_rank']} "
                                 f"ran episodes {sorted(r['losses'])}")
        loss_err = max([loss_err] + [
            abs(v - want[e]) / max(abs(want[e]), 1e-30)
            for e, v in r["losses"].items()])
    if not loss_err <= TP_LOSS_TOL:
        raise AssertionError(f"tp {TP_TRAIN_PATH}: per-episode losses "
                             f"{loss_err:.3e} from the oracle's")
    for r in ranks:
        if r["state_vs_oracle"]["n_off"]:
            raise AssertionError(f"tp {TP_TRAIN_PATH}: the gathered state "
                                 f"off the oracle's: {r['state_vs_oracle']}")
    grad_split = {"tensors": 0, "not_bit_identical": 0, "max_abs": 0.0,
                  "max_rel_l2": 0.0}
    worst = {}
    for d in range(TP_GRID[0]):
        ranks_d = range(d * TP_GRID[1], (d + 1) * TP_GRID[1])
        row = [ranks[g] for g in ranks_d]
        grads = [torch.load(os.path.join(out, f"tp-grads-{g}.pt"),
                            weights_only=True) for g in ranks_d]
        for key, g0 in grads[0].items():
            grad_split["tensors"] += 1
            for g in grads[1:]:
                diff = g[key].double() - g0.double()
                stat = (float(diff.abs().max()),
                        float(diff.norm() / max(float(g0.double().norm()),
                                                1e-30)))
                grad_split["not_bit_identical"] += not torch.equal(g[key],
                                                                   g0)
                grad_split["max_abs"] = max(grad_split["max_abs"], stat[0])
                if float(g0.norm()) > 1e-6:
                    grad_split["max_rel_l2"] = max(grad_split["max_rel_l2"],
                                                   stat[1])
                    worst[key] = max(worst.get(key, 0.0), stat[1])
        off = sorted({k for r in row for k, h in r["replicated"].items()
                      if h != row[0]["replicated"][k]})
        if off:
            held = [torch.load(os.path.join(out, f"tp-replicas-{g}.pt"),
                               weights_only=True) for g in ranks_d]
            diff = {k: max(float((h[k].double() - held[0][k].double())
                                 .abs().max()) for h in held[1:])
                    for k in off}
            raise AssertionError(
                f"tp: {len(off)} replicated tensors differ across the tp "
                f"ranks of dp index {d} (largest differences): "
                f"{dict(sorted(diff.items(), key=lambda i: -i[1])[:8])}")
    grad_split["worst_rel_l2"] = dict(sorted(
        worst.items(), key=lambda i: -i[1])[:5])
    grad_split["tol_rel_l2"] = TP_REPLICA_GRAD_TOL
    if not grad_split["max_rel_l2"] <= TP_REPLICA_GRAD_TOL:
        raise AssertionError("tp: the replicated gradients before the "
                             f"broadcast differ across the tp ranks: "
                             f"{grad_split}")
    per = TRAIN_PATHS[TP_TRAIN_PATH]["launches"]["K1"] * n // TP_GRID[0]
    launches = [r["launches"]["K1"] for r in ranks]
    if launches != [per] * world or any(r["launches"]["K2"]
                                        for r in ranks):
        raise AssertionError(f"tp: K1 launched {launches} times on the "
                             f"ranks, expected {per} on each")
    res = {"path": TP_TRAIN_PATH,
           "grid": f"dp={TP_GRID[0]} x tp={TP_GRID[1]}",
           "backend": f"gloo, {world} ranks on cuda:0",
           "episodes": n, "loss_max_rel_diff": loss_err,
           "loss_tol": TP_LOSS_TOL,
           "state_max_abs_diff": [r["state_vs_oracle"]["max_abs_diff"]
                                  for r in ranks],
           "state_tol": DDP_STATE_TOL,
           "replicated_tensors": len(ranks[0]["replicated"]),
           "replicated_grads_before_broadcast": grad_split,
           "sharded_parameters": ranks[0]["n_sharded"],
           "k1_launches_each_rank": launches,
           "fp32_step_seconds": [r["step_seconds"] for r in ranks],
           "tp_all_reduce_seconds_step": [r["tp_all_reduce_seconds"]
                                          for r in ranks],
           "tp_all_reduce_calls_step": ranks[0]["tp_all_reduce_calls"],
           "peak_memory_bytes": [r["peak_memory_bytes"] for r in ranks],
           "oracle_peak_memory_bytes": oracle["peak_memory_bytes"],
           "check_seconds": [r["seconds"] for r in ranks], "card": CARD}
    log(json.dumps({"tp_train": res}))
    return res


def tp_eval_check(out: str) -> dict:
    import numpy as np

    one = torch.load(os.path.join(out, "tp-eval-1-0.pt"), weights_only=False)
    ranks = [torch.load(os.path.join(out, f"tp-eval-{TP_GRID[1]}-{r}.pt"),
                        weights_only=False) for r in range(TP_GRID[1])]
    want = one["loss_acc"]
    errs = []
    for r in ranks:
        got = r["loss_acc"]
        if got.shape != (TP_EVAL_EPISODES, 2) or want.shape != got.shape \
                or not np.array_equal(got[:, 1], want[:, 1]):
            raise AssertionError(f"tp eval: accuracies at tp={TP_GRID[1]} "
                                 f"{got[:, 1]} against {want[:, 1]}")
        errs.append(float(np.max(np.abs(got[:, 0] - want[:, 0])
                                 / np.maximum(np.abs(want[:, 0]), 1e-30))))
    if not max(errs) <= TP_EVAL_TOL:
        raise AssertionError(f"tp eval: per-episode losses {errs} from the "
                             "one-process run's")
    per = PATHS["clipspm"]["launches"]["K1"] * TP_EVAL_EPISODES
    launches = [r["launches"]["K1"] for r in ranks]
    if one["launches"]["K1"] != per or launches != [per] * TP_GRID[1]:
        raise AssertionError(f"tp eval: K1 launched {launches} on the ranks "
                             f"and {one['launches']['K1']} in one process; "
                             f"expected {per}")
    res = {"path": "clipspm (RN50), uncached, fp32",
           "grid": f"dp=1 x tp={TP_GRID[1]}",
           "backend": f"gloo, {TP_GRID[1]} ranks on cuda:0",
           "episodes": TP_EVAL_EPISODES, "loss_max_rel_diff": errs,
           "loss_tol": TP_EVAL_TOL, "accuracies_equal": True,
           "k1_launches": {"one_process": one["launches"]["K1"],
                           "each_rank": launches},
           "eval_seconds": {"one_process": one["eval_seconds"],
                            "ranks": [r["eval_seconds"] for r in ranks]},
           "peak_memory_bytes": {"one_process": one["peak_memory_bytes"],
                                 "ranks": [r["peak_memory_bytes"]
                                           for r in ranks]},
           "card": CARD}
    log(json.dumps({"tp_eval": res}))
    return res


def phase_tp(tmp: str) -> dict:
    """Tensor parallelism on phase ddp's splits and against its oracle's
    results under ``tmp`` (run phase ddp on it first): the train grid's
    four ranks, then the evaluation's two."""
    roots, res = _ddp_roots(tmp), os.path.join(tmp, "out")
    seconds = {f"{TP_GRID[0]}x{TP_GRID[1]} train": _ddp_spawn(
        _tp_ranks, TP_GRID[0] * TP_GRID[1], (roots, res), tp=TP_GRID[1]),
        f"1x{TP_GRID[1]} eval": _ddp_spawn(
            _tp_ranks, TP_GRID[1], (roots, res), tp=TP_GRID[1])}
    log(json.dumps({"tp_process_seconds": seconds}))
    out = {"train": tp_train_check(res), "eval": tp_eval_check(res)}
    cards = torch.cuda.device_count()
    if cards < 2:
        out["cli_refusal"] = ddp_cli_refusal("TP")
        log(f"tp: {cards} card visible: {TP_GRID[0] * TP_GRID[1]} and "
            f"{TP_GRID[1]} ranks on cuda:0 over gloo ran; the NCCL half "
            "needs two cards and did not run")
    else:
        out["nccl"] = ddp_nccl_cli(TP_TRAIN_PATH, key="TP")
        log(f"tp: {cards} cards visible: the ranks on cuda:0 over gloo and "
            "the NCCL half over cuda:0 and cuda:1 ran")
    return out


# Phase extras: the JAX package's last modules on the card.
# (a) cpm2c-extras: cpm2c built with both of the JAX package's constructor
#     flags that no config key sets (use_visual_prompts, use_video_adapter),
#     on configs/cpm2c/hmdb.yaml's
#     layout (CLIP RN50, D=1024, bf16 under USE_AMP; 5-way 1-shot, 1 test
#     and 4 train queries, 8 frames of 224), random weights from MODEL.SEED
#     and seeded random text tables, handed to the port's Learner over two
#     SyntheticEpisodeSource streams (224 px frames, resized and cropped):
#     the cached route's loud fallback (the prompts make the features
#     role-dependent), EXTRAS_EVAL_EPISODES of uncached evaluation at
#     TEST.EVAL_BATCH, then one accumulated AMP training step of
#     EXTRAS_TRAIN_EPISODES. K1 must launch 2 times an episode in both (the
#     appearance stream at L=8, the motion stream at L=7), and its first
#     launches of each are held against the plain version on their own
#     inputs; the model's fp32 logits (every output the adapter and the
#     prompts reach) on the card against the CPU (MODEL_TOL), and the head's
#     gradients against the CPU and an fp64 witness.
# (b) the temporal ResNet-50 (torchvision trunk, full width) in both modes
#     on EXTRAS_TRUNK_FRAMES frames of 224: an eval forward on the card
#     against the CPU (MODEL_TOL of the largest output), then one fp32
#     train-mode forward and backward (a random weighting of the output) on
#     the card, on the CPU and on the card in fp64 (the witness): each
#     output, running statistic and gradient on the card within
#     EXTRAS_TRUNK_FACTOR times the CPU's own error from the witness, or
#     EXTRAS_TRUNK_FLOOR. Train-mode BatchNorm makes the trunk's gradients
#     cancelling sums: on the CPU at 8 frames the fp32 gradients are up to
#     3.9e-2 (a temporal block's BatchNorm bias) from fp64, the output 2e-4.
# (c) each module of models/blocks_extra.py at the reference's width
#     (D=2048, 8 frames; GroupGLKA on 2048 channels), random weights with
#     GroupGLKA's scale nonzero, fp32 forward on the card against the CPU
#     (MODEL_TOL of the largest output, or of 1).
# (cut from 64 and 16 episodes to make room for phase convergence)
EXTRAS_EVAL_EPISODES, EXTRAS_TRAIN_EPISODES, EXTRAS_CLASSES = 32, 8, 16
# the synthetic frames' side (the eval transform resizes to 256 and crops
# 224, as for the splits' 256 px frames; 224 makes a fifth fewer draws)
EXTRAS_PX = 224
EXTRAS_TRUNK_FRAMES = 40
EXTRAS_TRUNK_FACTOR = 4.0
EXTRAS_TRUNK_FLOOR = {"output": 1e-3, "stat": 1e-3, "grad": 1e-2}
EXTRAS_BLOCK_D = 2048


def _extras_learner():
    """cpm2c with both switches, its Learner on the card and its synthetic
    streams."""
    from clipspm_tpu_torch import set_matmul_precision
    from clipspm_tpu_torch.data.synthetic import SyntheticEpisodeSource
    from clipspm_tpu_torch.models.fsar import build_model
    from clipspm_tpu_torch.train.learner import Learner
    from clipspm_tpu_torch.utils.config import load_config
    from clipspm_tpu_torch.weights import random_init_

    cfg = load_config(PATHS["cpm2c"]["cfg"], opts=[
        f"TRAIN.TASKS_PER_BATCH={EXTRAS_TRAIN_EPISODES}"])
    set_matmul_precision(bool(cfg.USE_AMP))
    gen = torch.Generator().manual_seed(int(cfg.MODEL.SEED))
    model = random_init_(build_model(cfg, use_visual_prompts=True,
                                     use_video_adapter=True), gen)
    text = torch.randn(2, EXTRAS_CLASSES, model.arch.embed_dim,
                       generator=gen)

    def source(queries: int, seed: int):
        return SyntheticEpisodeSource(
            way=int(cfg.TRAIN.WAY), shot=int(cfg.TRAIN.SHOT),
            queries=queries, seq_len=int(cfg.DATA.SEQ_LEN),
            img_size=EXTRAS_PX, num_classes=EXTRAS_CLASSES, seed=seed)

    learner = Learner(cfg, model, text[0], text[1], torch.device("cuda"),
                      train_source=source(int(cfg.TRAIN.QUERY_PER_CLASS), 1),
                      test_source=source(int(cfg.TEST.QUERY_PER_CLASS), 2),
                      log_fn=log)
    return cfg, learner, source


@contextlib.contextmanager
def _k1_inputs(seen: list, keep: int = 2):
    """Records the first ``keep`` fused K1 launches' inputs."""
    from clipspm_tpu_torch.ops import otam_cuda

    entry = otam_cuda.otam_distance_cuda

    def recording(support, query, *args):
        if len(seen) < keep:
            seen.append((support.clone(), query.clone(), *args))
        return entry(support, query, *args)

    otam_cuda.otam_distance_cuda = recording
    try:
        yield seen
    finally:
        otam_cuda.otam_distance_cuda = entry


def _k1_against_plain(seen: list) -> list:
    """K1's fused mode against the plain version on recorded inputs."""
    from clipspm_tpu_torch.ops import otam_cuda
    from clipspm_tpu_torch.ops.otam import otam_distance_plain

    rows = []
    with torch.no_grad():
        for support, query, *args in seen:
            got = otam_cuda.otam_distance_cuda(support, query, *args)
            want = otam_distance_plain(support, query, *args)
            err = (got - want).abs().max().item()
            rows.append({"support": list(support.shape),
                         "query": list(query.shape), "max_abs_err": err})
            if not err <= FUSED_TOL * max(want.abs().max().item(), 1.0):
                raise AssertionError(f"K1 on cpm2c-extras' inputs vs the "
                                     f"plain version: {rows[-1]}")
    return rows


def extras_cpm2c_path() -> dict:
    from clipspm_tpu_torch.cli.run import _cached_evaluator

    counters = _counters()
    _fresh_peak()
    t0 = time.perf_counter()
    cfg, learner, source = _extras_learner()
    build_s = time.perf_counter() - t0
    warned = []
    if _cached_evaluator(cfg, learner, None, None, warned.append, "") \
            is not None or not warned[0].startswith(
                "WARNING: TEST.CACHE_FEATURES ignored"):
        raise AssertionError(f"cpm2c-extras took the feature cache: "
                             f"{warned}")
    E = int(cfg.TEST.EVAL_BATCH)
    eval_seen, train_seen = [], []
    with _k1_inputs(eval_seen):
        _zero_counters(counters)
        res = learner.evaluate(EXTRAS_EVAL_EPISODES, batch_size=E)
        eval_launches = _read_counters(counters)
    it = iter(learner.train_source)
    episodes = [next(it) for _ in range(EXTRAS_TRAIN_EPISODES)]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with _k1_inputs(train_seen):
        _zero_counters(counters)
        ev[0].record()
        metrics = learner.train_episodes(episodes)
        ev[1].record()
        torch.cuda.synchronize()
        train_launches = _read_counters(counters)
    peak = torch.cuda.max_memory_allocated()
    # 2 an episode: the appearance stream at L=8, the motion stream at L=7
    want_eval = {"K1": 2 * EXTRAS_EVAL_EPISODES, "K2": 0}
    want_train = {"K1": 2 * EXTRAS_TRAIN_EPISODES, "K2": 0}
    if eval_launches != want_eval or train_launches != want_train:
        raise AssertionError(f"cpm2c-extras launches: {eval_launches} in "
                             f"evaluation, {train_launches} in training; "
                             f"expected {want_eval}, {want_train}")
    lengths = sorted(x[0].shape[1] for x in eval_seen + train_seen)
    if lengths != [7, 7, 8, 8]:
        raise AssertionError(f"K1's streams on cpm2c-extras: L={lengths}")
    for key in ("accuracy", "confidence", "loss"):
        if not math.isfinite(res[key]):
            raise AssertionError(f"cpm2c-extras {key} is not finite: {res}")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"cpm2c-extras train step: {metrics}")
    k1 = _k1_against_plain(eval_seen + train_seen)
    model_err = check_model_against_cpu(
        learner, cfg, ep=source(int(cfg.TEST.QUERY_PER_CLASS), 3).sample(),
        keys=("logits", "logits_global", "class_logits"))
    grads = check_head_grads_against_cpu(
        learner, cfg, ep=source(int(cfg.TRAIN.QUERY_PER_CLASS), 4).sample())
    step_s = ev[0].elapsed_time(ev[1]) / 1e3
    frames = _frames_per_episode(cfg) * EXTRAS_EVAL_EPISODES
    return {"path": "cpm2c-extras", "build_seconds": build_s,
            "fallback": warned[0], "eval_episodes": EXTRAS_EVAL_EPISODES,
            "eval_batch": E, "accuracy": res["accuracy"],
            "loss": res["loss"],
            "episodes_per_s": EXTRAS_EVAL_EPISODES / res["seconds"],
            "encode_frames_per_s": frames / res["seconds"],
            "host_stall_pct": 100.0 * res["host_stall_seconds"]
            / res["seconds"],
            "train_episodes": EXTRAS_TRAIN_EPISODES,
            "train_step_device_seconds": step_s,
            "train_loss": metrics["loss"],
            "launches": {"eval": eval_launches, "train": train_launches},
            "k1_vs_plain": k1, "model_vs_cpu": model_err,
            "head_grads_vs_cpu": grads, "peak_memory_bytes": peak}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / max(float(b.norm()), 1e-300))


def _trunk_train(model, x, ct, dev, dt) -> dict:
    """One train-mode forward and backward of ``sum(trunk(x) * ct)``: the
    output, the running statistics after it and every gradient (the
    input's too), on the CPU in float64."""
    import copy

    m = copy.deepcopy(model).to(dev, dt).train()
    xx = x.detach().to(dev, dt).clone().requires_grad_(True)
    y = m(xx)
    (y * ct.to(dev, dt)).sum().backward()
    out = {"output": y.detach().cpu().double()}
    out.update({f"stat {k}": v.detach().cpu().double()
                for k, v in m.state_dict().items() if "running_" in k})
    out.update({f"grad {k}": p.grad.detach().cpu().double()
                for k, p in m.named_parameters()})
    out["grad input"] = xx.grad.detach().cpu().double()
    return out


def extras_trunk_cpu(mode: str) -> tuple:
    """The CPU's half of the temporal ResNet-50 check (fp32; it runs in a
    thread beside the card's work): the seeded trunk, its input and output
    weighting, its eval output, and its train side (``_trunk_train``)."""
    from clipspm_tpu_torch.models.backbones.resnet import TorchResNet
    from clipspm_tpu_torch.weights import random_init_

    gen = torch.Generator().manual_seed(7)
    trunk = random_init_(TorchResNet("resnet50", temporal_blocks=mode,
                                     seq_len=SEQ_LEN), gen)
    x = torch.rand(EXTRAS_TRUNK_FRAMES, 224, 224, 3, generator=gen)
    ct = torch.randn(EXTRAS_TRUNK_FRAMES, 7, 7, trunk.feature_dim,
                     generator=gen)
    with torch.no_grad():
        want = trunk.eval()(x)
    return trunk, x, ct, want, _trunk_train(trunk, x, ct, torch.device(
        "cpu"), torch.float32)


def extras_temporal_trunk(mode: str, cpu_half: tuple) -> dict:
    import copy

    trunk, x, ct, want, cpu_side = cpu_half
    card = torch.device("cuda")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        with torch.no_grad():
            got = copy.deepcopy(trunk).to(card).eval()(x.to(card)).cpu()
        sides = {"card": _trunk_train(trunk, x, ct, card, torch.float32),
                 "cpu": cpu_side,
                 "card fp64": _trunk_train(trunk, x, ct, card,
                                           torch.float64)}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    eval_err, scale = (got - want).abs().max().item(), \
        want.abs().max().item()
    bad = [] if eval_err <= MODEL_TOL * scale else [
        f"eval forward {eval_err:.3e} of {scale:.3e}"]
    worst = {}
    ref = sides["card fp64"]
    for k in ref:
        kind = k.split(" ")[0]
        err, cpu_err = _rel(sides["card"][k], ref[k]), \
            _rel(sides["cpu"][k], ref[k])
        if not err <= max(EXTRAS_TRUNK_FACTOR * cpu_err,
                          EXTRAS_TRUNK_FLOOR[kind]):
            bad.append(f"{k} {err:.3e} (CPU {cpu_err:.3e})")
        if err > worst.get(kind, ("", 0.0))[1]:
            worst[kind] = (k, err, cpu_err)
    out = {"mode": mode, "frames": EXTRAS_TRUNK_FRAMES,
           "eval_max_abs_diff": eval_err, "eval_max_abs": scale,
           "train_worst_vs_fp64_card_cpu": {
               kind: list(v) for kind, v in worst.items()},
           "tensors": len(ref), "seconds": time.perf_counter() - t0}
    if bad:
        raise AssertionError(f"temporal ResNet-50 ({mode}) on the card vs "
                             f"the CPU: " + "; ".join(bad[:8]))
    return out


def extras_blocks() -> dict:
    import copy

    from clipspm_tpu_torch.models import blocks_extra as bx
    from clipspm_tpu_torch.weights import random_init_

    D, T, way = EXTRAS_BLOCK_D, SEQ_LEN, 5
    gen = torch.Generator().manual_seed(8)
    qu = torch.randn(way * T, D, generator=gen)
    su = torch.randn(way * T, D, generator=gen)
    labels = torch.randperm(way, generator=gen)
    tok = torch.randn(2, T, D, generator=gen)
    maps = torch.randn(2, 7, 7, D, generator=gen)
    cases = {"AttentionV3": (bx.AttentionV3(D), (tok, tok.flip(1), tok)),
             "Mo1": (bx.Mo1(D, way, T), (qu, su, labels)),
             "Mo2": (bx.Mo2(D, way, T), (qu, su, labels)),
             "Mo22": (bx.Mo22(D, T), (qu, su)),
             "TGroup": (bx.TGroup(D, way, T), (qu, su, labels)),
             "PositionalEncoderV2": (bx.PositionalEncoderV2(D), (tok,)),
             "GroupGLKA": (bx.GroupGLKA(D), (maps,))}
    tf32 = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for name, (module, inputs) in cases.items():
            module = random_init_(module, gen).eval()
            if name == "GroupGLKA":
                # 0 at init, where the block is its input
                with torch.no_grad():
                    module.scale.uniform_(0.5, 1.5, generator=gen)
            with torch.no_grad():
                want = module(*inputs)
                got = copy.deepcopy(module).cuda()(
                    *[x.cuda() for x in inputs])
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            err = max((g.cpu() - w).abs().max().item()
                      for g, w in zip(got, want))
            scale = max(w.abs().max().item() for w in want)
            out[name] = {"shape": [list(w.shape) for w in want],
                         "max_abs_diff": err, "max_abs": scale}
            if not err <= MODEL_TOL * max(scale, 1.0):
                raise AssertionError(f"{name} on the card vs the CPU: "
                                     f"{out[name]}")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return out


def phase_extras() -> dict:
    t0 = time.perf_counter()
    modes = ("bottleneck", "stage")
    # the temporal trunks' CPU halves run in a thread beside the card's
    # cpm2c path (the host's cores are idle there but for the episodes'
    # draws)
    with cf.ThreadPoolExecutor(max_workers=1) as pool:
        cpu_halves = [pool.submit(extras_trunk_cpu, mode) for mode in modes]
        out = {"cpm2c-extras": extras_cpm2c_path()}
        out["cpm2c_seconds"] = time.perf_counter() - t0
        _fresh_peak()
        out["temporal_resnet50"] = [
            extras_temporal_trunk(mode, half.result())
            for mode, half in zip(modes, cpu_halves)]
    out["blocks_extra"] = extras_blocks()
    out["trunk_and_blocks_peak_memory_bytes"] = \
        torch.cuda.max_memory_allocated()
    out["seconds"] = time.perf_counter() - t0
    log(json.dumps({"extras": out}))
    return out


# Phase convergence: clipspm_tpu_torch/tools/train_convergence.py's steps on
# the card, in this process (its CLI runs through run_cli_in_process, so
# that the counters can be read): the tool's dataset at its production
# geometry (scripts/make_synthetic_dataset.py: 256x256 JPEGs, 12 frames a
# video, 8 train classes of 10 videos and 8 test classes of disjoint hues),
# written to disk and decoded by the port's loaders and cache from there
# (the native decoder where libjpeg builds it, else PIL); CLIP-SPM RN50 at
# full width trained from random weights through the CLI (bf16, as
# configured), then the tool's three ONLY_TEST restores from
# checkpoint_best. CONVERGENCE_ARGS cut its depth: one full optimizer step
# of 16 episodes, no validation (the loop validates before its last step
# only; without one the final state is checkpoint_best) and restores of 8.
# The dataset is written in a thread beside phases ddp and tp, whose ranks
# leave this process idle. The restores run at fp32 (TF32 off), where the
# uncached and the cached
# evaluator must agree (their batches differ, so bf16 may round them
# apart), as phase uncached=cached holds them; the two uncached ones must
# agree too. K1 must launch 3 times an episode in training (its backward
# the plain replay), in the validation and in each restore; the tool's
# JSON must carry the JAX tool's keys (scripts/train_convergence.py, read
# as text).
CONVERGENCE_ARGS = ("--arch", "RN50", "--episodes", "16", "--val-freq",
                    "0", "--final-eps", "8")
CONVERGENCE_K1 = 3


def _jax_tool_json_keys(script: str) -> list:
    """The keys of the dict a script under scripts/ prints with
    ``json.dumps`` (its source parsed, nothing imported)."""
    import ast

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "scripts", script)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError(f"no json.dumps of a dict in {script}")


@contextlib.contextmanager
def _counted_decode(decoded: dict):
    """Counts the frames each route decodes from disk (the loaders' and the
    feature cache's ``decode_path_lists``): ``batch`` (the native batch
    decoder, which falls back to PIL for a whole batch it cannot read) or
    ``per_frame`` (PIL, a frame at a time)."""
    import threading

    from clipspm_tpu_torch.data import pipeline
    from clipspm_tpu_torch.train import feature_cache

    lock = threading.Lock()
    decode = pipeline.decode_path_lists

    def counted(path_lists, pool=None, frame_size=None, *args, **kwargs):
        with lock:
            decoded["batch" if frame_size is not None else "per_frame"] += \
                sum(len(clip) for clip in path_lists)
        return decode(path_lists, pool, frame_size, *args, **kwargs)

    pipeline.decode_path_lists = feature_cache.decode_path_lists = counted
    try:
        yield decoded
    finally:
        pipeline.decode_path_lists = feature_cache.decode_path_lists = decode


def _convergence_args(root: str):
    from clipspm_tpu_torch.tools import train_convergence as tc

    return tc.parse_args(["--root", root, *CONVERGENCE_ARGS])


def write_convergence_dataset(root: str) -> float:
    """The phase's dataset under ``root``; returns the seconds it took."""
    from clipspm_tpu_torch.tools import train_convergence as tc

    t0 = time.perf_counter()
    tc.make_convergence_dataset(_convergence_args(root))
    return time.perf_counter() - t0


def _in_a_thread(fn, *args) -> cf.Future:
    """``fn(*args)`` started in a thread of its own; its future."""
    pool = cf.ThreadPoolExecutor(max_workers=1)
    try:
        return pool.submit(fn, *args)
    finally:
        pool.shutdown(wait=False)


def phase_convergence(root: str = None, dataset: cf.Future = None) -> dict:
    """The phase over ``root`` (a directory of its own without one), whose
    dataset ``dataset`` is writing (``write_convergence_dataset`` in a
    thread) or is written here."""
    import shutil

    from clipspm_tpu_torch.data import native_decode
    from clipspm_tpu_torch.tools import train_convergence as tc

    t_phase = time.perf_counter()
    counters = _counters()
    runs = []
    root = root or tempfile.mkdtemp(prefix="chip_smoke_convergence_")
    try:
        args = _convergence_args(root)
        dataset_seconds = (dataset.result() if dataset is not None
                           else write_convergence_dataset(root))

        def run_cli(argv):
            restore = "TEST.ONLY_TEST=true" in argv
            val_launches, decoded = [], {"batch": 0, "per_frame": 0}
            _fresh_peak()
            with _validations_apart(val_launches), _counted_decode(decoded):
                _zero_counters(counters)
                t0 = time.perf_counter()
                out = tc.run_cli_in_process(
                    argv + (["USE_AMP=false"] if restore else []))
                seconds = time.perf_counter() - t0
                launches = _read_counters(counters)
            runs.append({
                "run": ("restore cached" if "TEST.CACHE_FEATURES=true" in argv
                        else "restore" if restore else "train"),
                "launches": launches, "val_launches": val_launches,
                "decoded_frames": decoded, "seconds": seconds,
                "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "host_stall_pct": [float(x) for x in re.findall(
                    r"host-stall (\d+)%", out)]})
            return out

        result = tc.convergence(args, run_cli=run_cli)
        decoder = ("native/frame_decoder.cc"
                   if native_decode.get_library() is not None else "PIL")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    bad = []
    jax_keys = _jax_tool_json_keys("train_convergence.py")
    if list(result) != jax_keys:
        bad.append(f"JSON keys {list(result)}; the JAX tool's {jax_keys}")
    if [r["run"] for r in runs] != ["train", "restore", "restore",
                                    "restore cached"]:
        bad.append(f"CLI runs {[r['run'] for r in runs]}")
    if not result["restore_acc"] == result["final_acc"] \
            == result["cached_eval_acc"]:
        bad.append("restores disagree: final {final_acc}, restore "
                   "{restore_acc}, cached {cached_eval_acc}".format(**result))
    losses = [v for _, v in result["train_loss_curve"]]
    if not losses or not all(math.isfinite(v) for v in losses) \
            or result["val_curve"]:
        bad.append(f"curves {result['train_loss_curve']}, "
                   f"{result['val_curve']}")
    episodes = {"train": args.episodes, "restore": args.final_eps,
                "restore cached": args.final_eps}
    frames_per_episode = {  # 5-way 5-shot, 4 train queries, 1 test query
        "train": 5 * (5 + 4) * args.seq_len, "restore": 5 * 6 * args.seq_len}
    for r in runs:
        # a restore is one evaluation; the train run validates nothing
        n = episodes[r["run"]]
        k1, k1_val = (n, []) if r["run"] == "train" else (0, [n])
        want = {"K1": CONVERGENCE_K1 * k1, "K2": 0}
        want_val = [{"K1": CONVERGENCE_K1 * v, "K2": 0} for v in k1_val]
        if r["launches"] != want or r["val_launches"] != want_val:
            bad.append(f"{r['run']}: launches {r['launches']} and "
                       f"{r['val_launches']} in its evaluations; expected "
                       f"{want} and {want_val}")
        route = "batch" if decoder != "PIL" else "per_frame"
        other = "per_frame" if route == "batch" else "batch"
        least = frames_per_episode.get(r["run"], 1) * (
            episodes[r["run"]] if r["run"] != "restore cached" else 1)
        if r["decoded_frames"][route] < least or r["decoded_frames"][other]:
            bad.append(f"{r['run']}: decoded {r['decoded_frames']} from "
                       f"disk through {decoder}; expected at least {least} "
                       f"{route}")
    out = {"decoder": decoder, "dataset_seconds": dataset_seconds,
           "runs": runs, "result": result, "jax_tool_keys_match":
               list(result) == jax_keys,
           "seconds": time.perf_counter() - t_phase, "card": CARD}
    log(json.dumps({"convergence": out}))
    if bad:
        raise AssertionError("phase convergence: " + "; ".join(bad))
    return out


def main() -> int:
    seconds = {}

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[phase] = time.perf_counter() - t0

    device = timed("device", phase_device)
    timed("build", phase_build)
    k1 = timed("K1", phase_k1)
    k2 = timed("K2", phase_k2)
    timed("quant", phase_quant)
    evals = {name: timed(name, phase_main_path, name)
             for name in CACHED_PATHS}
    evals.update({name: timed(name, phase_uncached_path, name)
                  for name in UNCACHED_PATHS})
    timed("uncached=cached", phase_uncached_equals_cached)
    extras = timed("extras", phase_extras)
    trains = {name: timed(name, phase_train_path, name)
              for name in TRAIN_PATHS}
    remats = {name: timed(name, phase_remat_path, name)
              for name in REMAT_PATHS}
    with tempfile.TemporaryDirectory() as tmp:
        # phase convergence's dataset is written while the ranks of phases
        # ddp and tp, processes of their own, leave this one idle
        root = os.path.join(tmp, "convergence")
        dataset = _in_a_thread(write_convergence_dataset, root)
        ddp = timed("ddp", phase_ddp, tmp)
        tp = timed("tp", phase_tp, tmp)
        convergence = timed("convergence", phase_convergence, root, dataset)
    log(json.dumps({"phase_seconds": seconds}))
    for k, entry in (("K1", k1), ("K2", k2)):
        entry["launches_by_path"] = {
            **{name: r["launches"][k] for name, r in evals.items()},
            **{f"{name} ({stage})": r["launches"][f"{k}_{stage}"]
               for name, r in trains.items()
               for stage in ("train", "val", "only_test")
               if f"{k}_{stage}" in r["launches"]},
            **{f"{name} (train)": r["launches"][k]
               for name, r in remats.items()},
            **{f"convergence clipspm RN50 (run {i + 1}: {r['run']})":
               r["launches"][k] + sum(v[k] for v in r["val_launches"])
               for i, r in enumerate(convergence["runs"])},
            **{f"cpm2c-extras ({stage})":
               extras["cpm2c-extras"]["launches"][stage][k]
               for stage in ("eval", "train")},
            **{f"ddp {name} (ranks, first step of {DDP_STEPS[0]})":
               sum(r["launches_step_1"].get(k, [0]))
               for name, r in ddp["train"].items()},
            **{f"ddp clipspm {stage} (N=1; rank 0 of 2)":
               ddp["eval"]["k1_launches_n1_and_rank0"][stage]
               for stage in ("uncached", "cached") if k == "K1"},
            **({f"tp {TP_TRAIN_PATH} (each of 4 ranks, a step of "
                f"{TP_STEP_EPISODES})": tp["train"]["k1_launches_each_rank"],
                "tp clipspm RN50 uncached (one process; each of 2 ranks)":
                tp["eval"]["k1_launches"]} if k == "K1" else {})}
    k1["launches"] = evals["clipspm"]["launches"]["K1"]
    k2["launches"] = evals["ta2n"]["launches"]["K2"]
    log(json.dumps({"kernels": [k1, k2]}))
    log(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
