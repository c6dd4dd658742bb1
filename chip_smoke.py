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
   each launch replaces; K1 also at cpm2c's motion stream (L=7);
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
   - clipfsar, cpm2c (HMDB layout, RN50, 5-way 1-shot, bf16; 1 and 2 K1
     launches per episode, cpm2c's second at L=7) and sten (UCF layout; no
     kernel): feature-cached evaluation, each head's fp32 logits on the
     card held against the CPU's;
   - clipspm-uncached and clipspm-vit-uncached: the clipspm and clipspm-vit
     paths with ``TEST.CACHE_FEATURES=false``, the uncached evaluator at
     ``TEST.EVAL_BATCH`` 32 episodes a step over the test EpisodeLoader (3
     K1 launches per episode); then the same 8 episodes through the uncached
     and the cached evaluator at fp32, whose losses and accuracies must
     agree;
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
   each train path also profiles one optimizer step; the clipspm and ta2n
   ones hold one fp32 train step on the card and on the CPU against an fp64
   step on the CPU, clipfsar's and cpm2c's hold the head's fp32 gradients
   on the card against the CPU's.

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
# (one frame fewer: L=7) in evaluation and in training
OTAM_FUSED = ((5, 5, 8, 1024, True, 0.5), (5, 5, 8, 1024, False, 0.5),
              (1, 5, 8, 1024, True, 0.5), (1, 5, 8, 1024, False, 0.5),
              (5, 5, 8, 1021, True, 0.5), (5, 5, 8, 1024, True, 0.1),
              (20, 5, 8, 1024, True, 0.5), (5, 5, 8, 512, True, 0.5),
              (1, 5, 8, 512, True, 0.5), (20, 5, 8, 512, True, 0.5),
              (5, 5, 7, 1024, True, 0.5), (20, 5, 7, 1024, True, 0.5))
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


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
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


def _times(fn, iters: int = 200) -> tuple:
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

    def shapes(qs, L, D):
        return {f"Q={q} S=5 L={L} D={D} bidirectional lambda=0.5": {
            "library_ms": None, **fused[(q, 5, L, D, True, 0.5)]}
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
# - clipfsar: configs/clipfsar/hmdb.yaml (RN50, 5-way 1-shot 1-query, bf16),
#   the clipspm path's split; one bidirectional OTAM per episode (1 fused K1
#   launch);
# - cpm2c: configs/cpm2c/hmdb.yaml (RN50, 5-way 1-shot, MOTION_COFF 0,
#   NORMAL_COFF 1, LMD [0.5, 1, 0]), the same split; two OTAMs per episode,
#   the appearance stream at L=8 and the motion stream at L=7 (2 fused K1
#   launches; the motion one is computed at weight 0, as in the JAX head);
# - sten: configs/sten/ucf.yaml (RN50, 5-way 1-shot) over the UCF-layout
#   split; no DP, so no kernel.
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
}
# episodes of each cached eval path (cut from 300 to make room for the
# uncached and head paths within the script's time)
MAIN_EPISODES = 200
SPLIT_FRAMES, SPLIT_PX = 10, 256
SEQ_LEN = 8
# the head on the card (fp32, no TF32) against the head on the CPU (fp32):
# sums in another order, so 1e-4 relative and absolute on the logits
HEAD_TOL = 1e-4
# the ViT tower on the card (fp32, no TF32; its attention the fused SDPA
# kernel) against the CPU's over 4 frames: max abs diff <= this times the
# largest feature magnitude
TOWER_TOL, TOWER_FRAMES = 1e-4, 4
# the device kernels of each, as the profiler names them (both modes)
KERNEL_NAMES = {"K1": ("otam_dp_kernel", "otam_fused_kernel"),
                "K2": ("softdtw_dp_kernel", "softdtw_fused_kernel")}
# the profiler range around each kernel's backward replay (train profile)
REPLAYS = {"K1": "K1 backward: plain replay",
           "K2": "K2 backward: plain replay"}


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


def _device_events(prof) -> list:
    """The device's kernels and copies: the profiler's GPU copies of user
    ranges (``gpu_user_annotation``, spans that cover idle time) left out."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and e.name not in REPLAYS.values()
            and not getattr(e, "is_user_annotation", False)]


def _summarize(prof, wall_us: float, n: int, top: int = 6) -> tuple:
    """The device side of a profile over ``n`` episodes: wall and device
    busy ms an episode (busy is the sum of the device events' durations; one
    stream, so they do not overlap), idle share, device ops an episode, each
    kernel's ms and share, and the top device ops. Returns the summary and
    the busy microseconds."""
    dev = _device_events(prof)
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


def check_tower_against_cpu(rec: _Recorder) -> dict:
    """The visual tower on the card (fp32 weights, no autocast, no TF32 in
    cuBLAS or cuDNN) against a CPU copy on the same seeded frames."""
    import copy

    tower = rec.learner.model.backbone
    cpu = copy.deepcopy(tower).cpu().float().eval()
    R = rec.learner.model.arch.image_resolution
    x = torch.rand(TOWER_FRAMES, R, R, 3,
                   generator=torch.Generator().manual_seed(7))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            got = tower(x.to(rec.learner.device)).cpu()
            want = cpu(x)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    if not err <= TOWER_TOL * scale:
        raise AssertionError(f"the tower on the card vs the CPU: max abs "
                             f"diff {err:.3e}, largest feature {scale:.3e}")
    return {"frames": TOWER_FRAMES, "max_abs_diff": err,
            "max_abs_feature": scale, "tol_of_max": TOWER_TOL}


def profile_head(rec: _Recorder, argv, episodes: int = 20) -> dict:
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


def phase_main_path(name: str, device: str = "cuda", extra_opts=(),
                    episodes: int = MAIN_EPISODES) -> dict:
    import gc

    from clipspm_tpu_torch.cli.run import main as cli_main

    spec = PATHS[name]
    log(f"main path {name}: frames come from a seeded uint8 source right "
        "after the decode stage, in place of the JPEG decode; the disk decode "
        "(native/frame_decoder.cc, which needs libjpeg, or PIL) is held "
        "against the JAX package by the CPU tests")
    on_gpu = torch.device(device).type == "cuda"
    counters = _counters()
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
            # the cuBLAS workspaces that phase 3's timed matmuls left on
            # their streams (32 MB each) are not the path's memory
            if hasattr(torch._C, "_cuda_clearCublasWorkspaces"):
                torch._C._cuda_clearCublasWorkspaces()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        with rec.installed():
            _zero_counters(counters)
            t0 = time.perf_counter()
            res = cli_main(argv)
            wall = time.perf_counter() - t0
            launches = _read_counters(counters)
        peak = torch.cuda.max_memory_allocated() if on_gpu else 0
        head_err = check_head_against_cpu(rec, argv, spec["metrics"])
        tower_err = (check_tower_against_cpu(rec)
                     if spec.get("tower_check") else None)
        head_profile = profile_head(rec, argv) if on_gpu else None
        if on_gpu and name == "ta2n":
            head_profile["k2_data_dependence"] = k2_on_path_inputs(rec, argv)

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
    tail = ((model.arch.embed_dim,) if hasattr(model, "arch")
            else (7, 7, model.dim))
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
# run one after another. UNCACHED_EPISODES is two full steps. Each path runs
# its eval path's config and split with TEST.CACHE_FEATURES=false.
UNCACHED_PATHS = {"clipspm-uncached": "clipspm",
                  "clipspm-vit-uncached": "clipspm-vit"}
UNCACHED_EPISODES = 64
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

    from clipspm_tpu_torch.data import pipeline
    from clipspm_tpu_torch.train.setup import build_catalog_and_sampler

    catalog, sampler = build_catalog_and_sampler(
        cfg, "test", False, int(cfg.TEST.QUERY_PER_CLASS))
    decode = pipeline.decode_path_lists
    pipeline.decode_path_lists = seeded_frames
    try:
        eps = [pipeline.decode_plan(sampler.sample(), catalog)
               for _ in range(episodes)]
    finally:
        pipeline.decode_path_lists = decode
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
    with tempfile.TemporaryDirectory() as root:
        write_split(root, spec["frame_dir"], spec["split_dir"],
                    spec["classes"], spec["videos"], SPLIT_FRAMES, SPLIT_PX)
        argv = ["--cfg", spec["cfg"], "--splits-root", root,
                "--allow-random-weights", "--device", "cuda",
                "TEST.ONLY_TEST=true", "TEST.CACHE_FEATURES=false",
                f"TEST.TEST_EPISODES={UNCACHED_EPISODES}",
                f"DATA.DATA_DIR={root}",
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
    log(json.dumps({"main_path": out}))
    log(json.dumps({"uncached_profile": {"path": name, **step_profile}}))
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
    with tempfile.TemporaryDirectory() as root:
        write_split(root, spec["frame_dir"], spec["split_dir"],
                    spec["classes"], spec["videos"], SPLIT_FRAMES, SPLIT_PX)
        cfg = load_config(spec["cfg"], splits_root=root, opts=[
            *spec["opts"], "USE_AMP=false", "TEST.ONLY_TEST=true",
            f"DATA.DATA_DIR={root}",
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
#   K1 launches an episode (L=8 and L=7).
# Each runs 40 episodes (steps of TASKS_PER_BATCH and the rest), validation
# and a periodic checkpoint at episode 32.
# ``check``: the one fp32 train step held against fp64 (below): its episodes
# and shape (one 5-way 1-shot 1-query episode, 80 frames: the CPU's fp64
# step sets the script's length), the per-tensor factor, and the tensors
# whose gradient is zero in exact arithmetic. None: the head's gradients on
# the card against the CPU's instead (``check_head_grads_against_cpu``; the
# clipfsar and cpm2c heads hold no BatchNorm).
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
}
TRAIN_EPISODES, VAL_FREQ, SAVE_FREQ, VAL_EPISODES, PRINT_FREQ = \
    40, 32, 32, 100, 16
# the profiled optimizer step's episodes (per-episode figures)
PROFILE_EPISODES = 2
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
# The head's parameter gradients (clipfsar, cpm2c) over the same features:
# fp32 on the card (TF32 off, K1's replay), fp32 on the CPU (the plain
# versions) and the fp64 witness on the CPU. Each tensor's card error
# against the witness may be twice the CPU's own, or HEAD_GRAD_TOL where
# that is smaller: most tensors agree to 1e-6, but context2's last bias
# sums its upstream gradient over every token, and cancels (the card and
# the CPU fp32 1.55e-4 apart on cpm2c's, measured on an H100 80GB HBM3 at
# 700 W). A wrong gradient path is off by O(1).
HEAD_GRAD_TOL = 1e-4


class _TrainRecorder(_Recorder):
    """Also times each optimizer step with CUDA events, and counts the
    kernels' launches of each validation apart from training's."""

    def __init__(self):
        super().__init__()
        self.steps = []          # (n episodes, start event, end event)
        self.val_launches = []   # {kernel: launches} of each validation

    @contextlib.contextmanager
    def installed(self):
        from clipspm_tpu_torch.train import feature_cache, learner

        step = learner.Learner._step
        evaluators = {cls: cls.evaluate for cls in (
            feature_cache.FeatureCachedEvaluator, learner.Learner)}
        counters = _counters()

        def timed_step(lrn, batch, n_valid):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = step(lrn, batch, n_valid)
            ev[1].record()
            self.steps.append((n_valid, *ev))
            return out

        def counted(evaluate):
            def counted_evaluate(ev, n, *args, **kwargs):
                # the validation's launches apart (cached or uncached): set
                # to 0 just before it, read just after, and training's
                # counts put back
                train_counts = _read_counters(counters)
                _zero_counters(counters)
                try:
                    return evaluate(ev, n, *args, **kwargs)
                finally:
                    self.val_launches.append(_read_counters(counters))
                    for k, mod in counters.items():
                        mod.launches = train_counts[k]
            return counted_evaluate

        learner.Learner._step = timed_step
        for cls, evaluate in evaluators.items():
            cls.evaluate = counted(evaluate)
        try:
            with super().installed():
                yield self
        finally:
            learner.Learner._step = step
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
    the plain version's replay (a profiler range around each backward
    call). For a remat-chunked tower, also one unprofiled step of the same
    episodes under each remat policy the port honours."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from clipspm_tpu_torch.data import pipeline
    from clipspm_tpu_torch.ops import otam_cuda, softdtw_cuda
    from clipspm_tpu_torch.train.setup import build_catalog_and_sampler

    tpb = PROFILE_EPISODES
    catalog, sampler = build_catalog_and_sampler(
        cfg, "train", True, int(cfg.TRAIN.QUERY_PER_CLASS))
    decode = pipeline.decode_path_lists
    pipeline.decode_path_lists = seeded_frames
    try:
        eps = [pipeline.decode_plan(sampler.sample(), catalog)
               for _ in range(tpb)]
    finally:
        pipeline.decode_path_lists = decode
    batch = learner._ready(*learner._to_device(eps))
    functions = {"K1": otam_cuda._OtamDistance,
                 "K2": softdtw_cuda._SoftDTWCosPadded}
    backwards = {k: f.backward for k, f in functions.items()}

    def ranged(name, backward):
        def run(ctx, grad_out):
            with record_function(name):
                return backward(ctx, grad_out)
        return staticmethod(run)

    for k, f in functions.items():
        f.backward = ranged(REPLAYS[k], backwards[k])
    try:
        learner._step(batch, 2)            # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            learner._step(batch, tpb)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        for k, f in functions.items():
            f.backward = staticmethod(backwards[k])
    out, busy_us = _summarize(prof, wall_us, tpb, top=8)
    model = learner.model
    if getattr(model, "train_encode_chunk", 0):
        policy, seconds = model.train_remat_policy, {}
        for p in ("attn_out", "full", "dots"):
            model.train_remat_policy = p
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            learner._step(batch, tpb)
            torch.cuda.synchronize()
            seconds[p] = (time.perf_counter() - t0) / tpb
        model.train_remat_policy = policy
        out["remat_policy_step_seconds_per_episode"] = seconds
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
    """One train step of one episode at full width and 224 (5-way 1-shot
    1-query, T=8) from identical weights: fp32 on the card, fp32 on the CPU
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

    n_eps, shot, queries = 1, 1, 1
    cfg = load_config(cfg_path, opts=[
        *opts, "USE_AMP=false", f"TRAIN.SHOT={shot}",
        f"TRAIN.QUERY_PER_CLASS={queries}", "TRAIN.TASKS_PER_BATCH=2"])
    way, T = int(cfg.TRAIN.WAY), int(cfg.DATA.SEQ_LEN)
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


def check_head_grads_against_cpu(learner, cfg) -> dict:
    """The trained head's parameter gradients on the card (fp32, TF32 off)
    and on a CPU copy (fp32) against the CPU copy's in fp64, over one train
    episode's features (the tower in eval mode on the card), train mode
    with dropout's modules in eval mode, the dispatch's train loss; a tensor
    whose gradient is 0 in fp64 (a stream weighted 0) must be 0 on the card
    too."""
    import copy

    import numpy as np

    from clipspm_tpu_torch.data import pipeline
    from clipspm_tpu_torch.data.transforms import episode_device_transform
    from clipspm_tpu_torch.train.losses import loss_and_acc
    from clipspm_tpu_torch.train.setup import build_catalog_and_sampler

    catalog, sampler = build_catalog_and_sampler(
        cfg, "train", True, int(cfg.TRAIN.QUERY_PER_CLASS))
    decode = pipeline.decode_path_lists
    pipeline.decode_path_lists = seeded_frames
    try:
        ep = pipeline.decode_plan(sampler.sample(), catalog)
    finally:
        pipeline.decode_path_lists = decode
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
        with torch.no_grad():
            gpu.eval()
            feats = [gpu.encode(episode_device_transform(
                torch.from_numpy(x).to(learner.device), train=False,
                img_size=t.img_size, resize_to=t.resize_to,
                normalize=t.normalize)).float()
                for x in (ep.support_images, ep.target_images)]
        labels = [torch.from_numpy(np.asarray(x)) for x in (
            ep.support_labels, ep.real_support_labels,
            ep.real_target_labels, ep.target_labels)]
        cpu = torch.device("cpu")
        for side, model, dev, dt in (
                ("card", gpu, learner.device, torch.float32),
                ("cpu", cpu_model, cpu, torch.float32),
                ("fp64", copy.deepcopy(cpu_model).double(), cpu,
                 torch.float64)):
            model.train()
            for m in model.modules():
                if isinstance(m, torch.nn.Dropout):
                    m.eval()
            model.zero_grad(set_to_none=True)
            su, qu = [f.to(dev, dt) for f in feats]
            sl, rs, rt, tl = [x.to(dev) for x in labels]
            out = model.match_features(su, qu, sl, rs, rt,
                                       learner.text_train.to(dev, dt),
                                       learner.text_test.to(dev, dt))
            loss, _ = loss_and_acc(learner.model_name, out, tl, rs, rt,
                                   learner.tasks_per_batch, cfg=cfg,
                                   train=True)
            loss.backward()
            losses[side] = loss.item()
            grads[side] = {k: p.grad.detach().cpu().double()
                           for k, p in model.named_parameters()
                           if p.grad is not None
                           and not k.startswith("backbone.")}
    finally:
        gpu.compute_dtype = dtype
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    card, cpu, ref = grads["card"], grads["cpu"], grads["fp64"]
    rows, bad, zero = [], [], 0
    if not set(card) == set(cpu) == set(ref) or not ref:
        bad.append(f"gradient tensors differ: {sorted(set(card) ^ set(ref))}")
    for k in sorted(set(card) & set(cpu) & set(ref)):
        if not ref[k].any():
            zero += 1
            if card[k].any() or cpu[k].any():
                bad.append(f"{k}: zero in fp64, not in fp32")
            continue
        err, cpu_err = rel(card[k], ref[k]), rel(cpu[k], ref[k])
        rows.append((err, cpu_err, rel(card[k], cpu[k]), k))
        if not err <= max(2.0 * cpu_err, HEAD_GRAD_TOL):
            bad.append(f"{k} {err:.3e} (CPU fp32 {cpu_err:.3e})")
    rows.sort(reverse=True)
    out = {"frames": int(cfg.TRAIN.WAY) * int(cfg.DATA.SEQ_LEN) * (
               int(cfg.TRAIN.SHOT) + int(cfg.TRAIN.QUERY_PER_CLASS)),
           "grad_tensors": len(rows), "zero_grad_tensors": zero,
           "grad_rel_l2_vs_fp64_worst": [[k, e, ce, cc]
                                         for e, ce, cc, k in rows[:6]],
           "grad_rel_l2_card_vs_cpu_max": max(
               (cc for _, _, cc, _ in rows), default=0.0),
           "loss": losses, "factor": 2.0, "floor": HEAD_GRAD_TOL}
    log(json.dumps({"head_grads_vs_cpu": out}))
    if bad:
        raise AssertionError("head gradients on the card vs the CPU: "
                             + "; ".join(bad[:8]))
    return out


def phase_train_path(name: str) -> dict:
    from clipspm_tpu_torch.cli.run import main as cli_main
    from clipspm_tpu_torch.utils.config import load_config

    run = TRAIN_PATHS[name]
    spec = PATHS[run["eval_path"]]
    counters = _counters()
    log(f"train path {name}: frames come from the same seeded uint8 "
        "source after the decode stage as the eval paths")
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_split(root, spec["frame_dir"], spec["split_dir"],
                    spec["classes"], spec["videos"], SPLIT_FRAMES, SPLIT_PX)
        write_split(root, spec["frame_dir"], spec["split_dir"],
                    run["train_classes"], run["train_videos"], SPLIT_FRAMES,
                    SPLIT_PX, mode="train")
        log(f"train path {name}: wrote "
            f"{run['train_classes'] * run['train_videos']} train and "
            f"{spec['classes'] * spec['videos']} test videos in "
            f"{time.perf_counter() - t0:.1f} s")
        ckpt = os.path.join(root, "ckpt")
        flags = ["--cfg", spec["cfg"], "--splits-root", root]
        opts = [*spec["opts"], *run.get("opts", ()), f"DATA.DATA_DIR={root}",
                f"CHECKPOINT.CHECKPOINT_DIR={ckpt}"]
        train_opts = [*opts, "TEST.ONLY_TEST=false",
                      f"TRAIN.TRAIN_EPISODES={TRAIN_EPISODES}",
                      f"TRAIN.VAL_FREQ={VAL_FREQ}",
                      f"TRAIN.PRINT_FREQ={PRINT_FREQ}",
                      f"TEST.TEST_EPISODES={VAL_EPISODES}",
                      f"CHECKPOINT.SAVE_FREQ={SAVE_FREQ}"]
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
        cfg = load_config(spec["cfg"], opts=train_opts, splits_root=root)
        tpb = learner.tasks_per_batch

        recs = _read_jsonl(os.path.join(ckpt, "metrics.jsonl"))
        losses = [r["value"] for r in recs
                  if r["tag"] == "loss/Train_loss[it]"]
        val_acc = [r["value"] for r in recs if r["tag"] == "acc/Test_acc"]
        with open(os.path.join(ckpt, "log.txt")) as f:
            stalls = [float(x) for x in
                      re.findall(r"host-stall (\d+)%", f.read())]
        steps = [(n, a.elapsed_time(b) / 1e3) for n, a, b in rec.steps]
        want_steps = [tpb] * (TRAIN_EPISODES // tpb)
        if TRAIN_EPISODES % tpb:
            want_steps.append(TRAIN_EPISODES % tpb)
        if [n for n, _ in steps] != want_steps \
                or len(losses) != len(want_steps) \
                or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"train path {name}: steps {steps}, losses "
                                 f"{losses}")
        if res["episodes"] != TRAIN_EPISODES:
            raise AssertionError(f"train path {name} ran {res['episodes']} "
                                 "episodes")
        per = run["launches"]
        want = {"train": {k: n * TRAIN_EPISODES for k, n in per.items()},
                "val": [{k: n * VAL_EPISODES for k, n in per.items()}]}
        if train_launches != want["train"] or val_launches != want["val"]:
            raise AssertionError(f"{name}: launches {train_launches} in "
                                 f"training and {val_launches} in "
                                 f"validation; expected {want}")
        for tag in ("best", f"iter_{SAVE_FREQ}"):
            if not os.path.isfile(os.path.join(ckpt, f"checkpoint_{tag}",
                                               "checkpoint.pt")):
                raise AssertionError(f"{name}: no checkpoint_{tag}")

        t0 = time.perf_counter()
        profile = profile_train_step(learner, cfg)
        stage_seconds["profile"] = time.perf_counter() - t0
        log(json.dumps({"train_profile": {"path": name, **profile}}))
        if run["check"] is None:
            t0 = time.perf_counter()
            check = check_head_grads_against_cpu(learner, cfg)
            stage_seconds["check"] = time.perf_counter() - t0
        del learner, rec

        # ONLY_TEST from checkpoint_best: the restored state is the saved
        # one bit for bit
        best = os.path.join(ckpt, "checkpoint_best")
        saved = torch.load(os.path.join(best, "checkpoint.pt"),
                           map_location="cpu", weights_only=True)
        test_rec = _Recorder()
        with test_rec.installed():
            _zero_counters(counters)
            t0 = time.perf_counter()
            test_res = cli_main([*flags, *opts, "TEST.ONLY_TEST=true",
                                 f"TEST.TEST_EPISODES={VAL_EPISODES}",
                                 f"TEST.TEST_MODEL_PATH={best}"])
            test_wall = time.perf_counter() - t0
            test_launches = _read_counters(counters)
        stage_seconds["only_test"] = test_wall
        restored = test_rec.learner.model.state_dict()
        if set(restored) != set(saved["model"]) or not all(
                torch.equal(restored[k].cpu(), v)
                for k, v in saved["model"].items()):
            raise AssertionError(f"{name}: ONLY_TEST's restored state_dict "
                                 "differs from checkpoint_best's")
        if test_launches != want["val"][0]:
            raise AssertionError(f"{name}: launches {test_launches} in the "
                                 f"ONLY_TEST run; expected {want['val'][0]}")
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
               ("only_test", test_launches)) for k, n in counts.items()},
           "val_accuracy_that_saved_best": val_acc[0],
           "best_meta": saved["meta"],
           "only_test_accuracy": test_res["accuracy"],
           "only_test_seconds": test_wall,
           "checkpoint_round_trip": "bit-equal",
           "stage_seconds": stage_seconds,
           ("train_step_vs_cpu" if run["check"] is not None
            else "head_grads_vs_cpu"): check}
    log(json.dumps({"train_path": out}))
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
    evals = {name: timed(name, phase_main_path, name) for name in PATHS}
    evals.update({name: timed(name, phase_uncached_path, name)
                  for name in UNCACHED_PATHS})
    timed("uncached=cached", phase_uncached_equals_cached)
    trains = {name: timed(name, phase_train_path, name)
              for name in TRAIN_PATHS}
    log(json.dumps({"phase_seconds": seconds}))
    for k, entry in (("K1", k1), ("K2", k2)):
        entry["launches_by_path"] = {
            **{name: r["launches"][k] for name, r in evals.items()},
            **{f"{name} ({stage})": r["launches"][f"{k}_{stage}"]
               for name, r in trains.items()
               for stage in ("train", "val", "only_test")}}
    k1["launches"] = evals["clipspm"]["launches"]["K1"]
    k2["launches"] = evals["ta2n"]["launches"]["K2"]
    log(json.dumps({"kernels": [k1, k2]}))
    log(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
