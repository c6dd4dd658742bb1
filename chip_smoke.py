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
   each launch replaces;
4. the main paths at full width, each through the port's CLI on random
   weights over a synthetic split, with every kernel launch counter set to
   0 just before the path and read just after:
   - clipspm: CLIP-SPM RN50 (224 crop, T=8, 5-way 5-shot, bf16)
     feature-cached evaluation over an HMDB-layout split (K1's fused
     mode, 3 launches per episode);
   - ta2n: TA2N on a torchvision ResNet-50 (224 crop, T=8, 5-way 1-shot,
     bf16) with ``MODEL.METRIC=otam``, feature-cached evaluation over a
     UCF-layout split (K2's fused mode, 1 launch per episode);
   - clipspm-train: 56 episodes of CLIP-SPM RN50 training (5-way 5-shot
     4-query, 16 episodes an Adam step, bf16) over an HMDB-layout train
     split, one cached validation, checkpoints, then an ONLY_TEST run from
     ``checkpoint_best`` (K1's fused mode, 3 launches per episode; K2
     none); one profiled optimizer step; and one fp32 train step on the
     card and on the CPU, each held against an fp64 step on the CPU.

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
# K1's fused mode: (Q, S, D, bidirectional, lambda); the first is the clipspm
# head's class and task distances in evaluation (RN50 width 1024, T=8, 5
# queries), then its task tokens (Q=1), single direction, a width that is not
# a multiple of 4 (4-byte copies), the otam head's lambda, and the class and
# task distances in training (4 queries a class: Q=20)
OTAM_FUSED = ((5, 5, 1024, True, 0.5), (5, 5, 1024, False, 0.5),
              (1, 5, 1024, True, 0.5), (1, 5, 1024, False, 0.5),
              (5, 5, 1021, True, 0.5), (5, 5, 1024, True, 0.1),
              (20, 5, 1024, True, 0.5))
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
# K2's fused mode: B pairs of [8, 2048] ResNet-50 sequences (the head's 25)
SDTW_FUSED_B = (25, 1600)
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
    for Q, S, D, bidir, lbda in OTAM_FUSED:
        sup = torch.randn(S, OTAM_T, D, generator=gen).to(dev)
        qry = torch.randn(Q, OTAM_T, D, generator=gen).to(dev)
        what = (f"K1 fused mode Q={Q} S={S} D={D} bidirectional={bidir} "
                f"lambda={lbda}")
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
            out = otam_cuda.otam_dp_cuda(t.reshape(-1, OTAM_T, OTAM_T)
                                         .contiguous(), lbda)
            if bidir:
                out = out + otam_cuda.otam_dp_cuda(
                    t.transpose(-2, -1).reshape(-1, OTAM_T, OTAM_T)
                    .contiguous(), lbda)
            return out.reshape(Q, S)

        k_ms, k_dev = _times(lambda: otam_cuda.otam_distance_cuda(
            sup, qry, lbda, bidir, 0.01))
        c_ms, c_dev = _times(chain)
        p_ms, p_dev = _times(lambda: otam_distance_plain(sup, qry, lbda,
                                                         bidir), iters=20)
        bound_ms, bound_by = _otam_fused_bound_ms(Q, S, OTAM_T, D, bidir)
        fused[(Q, S, D, bidir, lbda)] = dict(
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
    main = fused[(5, 5, 1024, True, 0.5)]
    train = {f"Q={q} S=5 L=8 D=1024 bidirectional lambda=0.5": {
        "library_ms": None, **fused[(q, 5, 1024, True, 0.5)]}
        for q in (20, 1)}
    return {"name": "otam_dp (K1)", "status": "ported", "route": "cuda",
            "source": "clipspm_tpu_torch/csrc/otam_dp.cu",
            "replaces": "clipspm_tpu/ops/otam_pallas.py:54",
            "max_abs_err": worst, "max_abs_grad_err": worst_grad,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "fused": {"shape": "Q=5 S=5 L=8 D=1024 bidirectional lambda=0.5",
                      **main},
            "train_shapes": train,
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
#   depend on METRIC, so the card-vs-CPU head check runs both metrics.
PATHS = {
    "clipspm": dict(cfg="configs/clipspm/hmdb.yaml", opts=(),
                    frame_dir="hmdb_256x256q5_l8", split_dir="hmdb_ARN",
                    classes=10, videos=12, launches={"K1": 3, "K2": 0},
                    metrics=(None,)),
    "ta2n": dict(cfg="configs/ta2n/ucf.yaml", opts=("MODEL.METRIC=otam",),
                 frame_dir="ucf_256x256q5_l8", split_dir="ucf_ARN",
                 classes=21, videos=6, launches={"K1": 0, "K2": 1},
                 metrics=("otam", "cos")),
}
MAIN_EPISODES = 300
SPLIT_FRAMES, SPLIT_PX = 10, 256
SEQ_LEN = 8
# the head on the card (fp32, no TF32) against the head on the CPU (fp32):
# sums in another order, so 1e-4 relative and absolute on the logits
HEAD_TOL = 1e-4
# the device kernels of each, as the profiler names them (both modes)
KERNEL_NAMES = {"K1": ("otam_dp_kernel", "otam_fused_kernel"),
                "K2": ("softdtw_dp_kernel", "softdtw_fused_kernel")}
# the profiler range around each of K1's backward replays (train profile)
REPLAY = "K1 backward: plain replay"


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
            and e.name != REPLAY
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


# The third main path, training: configs/clipspm/hmdb.yaml as shipped (RN50
# CLIP tower, 224 crop, T=8, 5-way 5-shot 4-query, TASKS_PER_BATCH=16, bf16,
# Adam at LR 1e-5) through the port's CLI on random weights, over a synthetic
# HMDB-layout split: 31 train classes x 9 videos (HMDB51's train split has 31
# classes; 9 = shot + queries) and the eval paths' 10 test classes x 12.
# Cut to 56 episodes (three full optimizer steps and one of 8 real episodes),
# one cached validation of 100 episodes at episode 32, one periodic
# checkpoint at 48; then an ONLY_TEST run from checkpoint_best. Each train
# episode makes three fused K1 launches; its backward replays the plain
# version and launches nothing of K1.
TRAIN_RUN = dict(episodes=56, val_freq=32, val_episodes=100, save_freq=48,
                 print_freq=16, train_classes=31, train_videos=9)
# The train step on the card against the CPU: 2 episodes of 5-way 1-shot
# 1-query (80 frames each) at full RN50 width, TF32 off, cuDNN's
# deterministic algorithms, dropout off, center crops, from one set of
# weights, three times: fp32 on the card, fp32 on the CPU, and fp64 on the
# CPU, the witness both fp32 runs are held against. The summed gradient is
# ill-conditioned: every convolution feeds a BatchNorm, so BatchNorm's own
# gradients and the convolutions' before it are small residues of large
# cancelling sums, and fp32 rounding alone moves them by percents. The CPU's
# fp32 error against fp64 measures that for each tensor; the card's, summed
# by other algorithms in other orders, may be no larger (TRAIN_CHECK_FACTOR
# times it), or TRAIN_CHECK_FLOOR where the CPU's is smaller; all gradients
# together the same. Measured on an H100 80GB HBM3 at 700 W: all gradients
# 1.9% from fp64 on the card and 4.9% on the CPU; no tensor's card error
# above 0.47 of the CPU's (the worst, early BatchNorm parameters, 2.5%
# against 6.0%). A wrong gradient path or weight layout is off by O(1). The
# attention pool's key bias has a zero gradient in exact arithmetic and is
# held to 1e-5 of the largest gradient norm. BatchNorm running stats and
# the loss: 1e-4 relative to the witness.
TRAIN_CHECK_FACTOR = 1.0
TRAIN_CHECK_FLOOR = 1e-4
TRAIN_CHECK_TOL = 1e-4
ZERO_GRAD = ("backbone.attnpool.k_proj.bias",)


class _TrainRecorder(_Recorder):
    """Also times each optimizer step with CUDA events, and counts the
    kernels' launches of each validation apart from training's."""

    def __init__(self):
        super().__init__()
        self.steps = []          # (n episodes, start event, end event)
        self.val_launches = []   # {kernel: launches} of each validation

    @contextlib.contextmanager
    def installed(self):
        from clipspm_tpu_torch.data import pipeline
        from clipspm_tpu_torch.train import feature_cache, learner

        step = learner.Learner._step
        evaluate = feature_cache.FeatureCachedEvaluator.evaluate
        decode = pipeline.decode_path_lists
        counters = _counters()

        def timed_step(lrn, batch, n_valid):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = step(lrn, batch, n_valid)
            ev[1].record()
            self.steps.append((n_valid, *ev))
            return out

        def counted_evaluate(ev, n):
            # the validation's launches apart: set to 0 just before it, read
            # just after, and training's counts put back
            train_counts = _read_counters(counters)
            _zero_counters(counters)
            try:
                return evaluate(ev, n)
            finally:
                self.val_launches.append(_read_counters(counters))
                for k, mod in counters.items():
                    mod.launches = train_counts[k]

        learner.Learner._step = timed_step
        feature_cache.FeatureCachedEvaluator.evaluate = counted_evaluate
        pipeline.decode_path_lists = seeded_frames
        try:
            with super().installed():
                yield self
        finally:
            learner.Learner._step = step
            feature_cache.FeatureCachedEvaluator.evaluate = evaluate
            pipeline.decode_path_lists = decode


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
    model (16 fresh episodes of the train stream, bf16, as trained): the
    shared summary (per episode), and K1's backward's plain replay (a
    profiler range around each backward call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from clipspm_tpu_torch.data import pipeline
    from clipspm_tpu_torch.ops import otam_cuda
    from clipspm_tpu_torch.train.setup import build_catalog_and_sampler

    tpb = learner.tasks_per_batch
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
    backward = otam_cuda._OtamDistance.backward

    def ranged(ctx, grad_out):
        with record_function(REPLAY):
            return backward(ctx, grad_out)

    otam_cuda._OtamDistance.backward = staticmethod(ranged)
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
        otam_cuda._OtamDistance.backward = backward
    out, busy_us = _summarize(prof, wall_us, tpb, top=8)
    replays = [e for e in prof.events() if e.name == REPLAY
               and e.device_type == DeviceType.CPU]
    replay_us = sum(e.device_time_total for e in replays)
    out.update({
        "k1_backward_replays_per_episode": len(replays) / tpb,
        "k1_backward_replay_device_ms_per_episode": replay_us / tpb / 1e3,
        "k1_backward_replay_wall_ms_per_episode":
            sum(e.cpu_time_total for e in replays) / tpb / 1e3,
        "k1_backward_replay_device_ops_per_episode":
            sum(_kernels_under(e) for e in replays) / tpb,
        "k1_backward_replay_share_of_device_busy": replay_us / busy_us})
    return out


def check_train_step_against_cpu(cfg_path: str) -> dict:
    """One accumulated train step of 2 episodes at full RN50 width and 224
    (5-way 1-shot 1-query, T=8) from identical weights: fp32 on the card,
    fp32 on the CPU and the fp64 witness on the CPU (TF32 off, dropout's
    modules in eval and BatchNorm in train mode, center crops). Summed
    gradients, BatchNorm running stats and the loss are held to the
    tolerances above."""
    import copy

    import numpy as np

    from clipspm_tpu_torch.data import transforms
    from clipspm_tpu_torch.data.episode import Episode
    from clipspm_tpu_torch.models.fsar import build_model
    from clipspm_tpu_torch.train import learner as learner_mod
    from clipspm_tpu_torch.utils.config import load_config
    from clipspm_tpu_torch.weights import random_init_

    cfg = load_config(cfg_path, opts=[
        "USE_AMP=false", "TRAIN.SHOT=1", "TRAIN.QUERY_PER_CLASS=1",
        "TRAIN.TASKS_PER_BATCH=2"])
    way, T = int(cfg.TRAIN.WAY), int(cfg.DATA.SEQ_LEN)
    base = random_init_(build_model(cfg), torch.Generator().manual_seed(4))
    text = torch.randn(len(cfg.TRAIN.CLASS_NAME), base.arch.embed_dim,
                       generator=torch.Generator().manual_seed(5))
    rng = np.random.default_rng(6)
    eps = []
    for _ in range(2):
        classes = rng.choice(len(cfg.TRAIN.CLASS_NAME), way,
                             replace=False).astype(np.int32)
        lab = rng.permutation(way).astype(np.int32)
        eps.append(Episode(
            support_images=rng.integers(0, 256, (way, T, SPLIT_PX, SPLIT_PX,
                                                 3), dtype=np.uint8),
            support_labels=lab,
            target_images=rng.integers(0, 256, (way, T, SPLIT_PX, SPLIT_PX,
                                                3), dtype=np.uint8),
            target_labels=np.arange(way, dtype=np.int32),
            real_support_labels=classes[lab],
            real_target_labels=classes, batch_class_list=classes))

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
        return max(TRAIN_CHECK_FACTOR * cpu_err, TRAIN_CHECK_FLOOR)

    g, c, r = card["grads"], cpu["grads"], ref["grads"]
    largest = max(float(v.norm()) for v in r.values())
    rows, bad = [], []
    for k in r:
        if not r[k].any():          # unused by the forward (the head's scale)
            if g[k].any() or c[k].any():
                bad.append(f"{k}: no gradient in fp64, some in fp32")
            continue
        if k in ZERO_GRAD:
            err = max(float((x[k] - r[k]).norm()) for x in (g, c)) / largest
            if err > 1e-5:
                bad.append(f"{k} (zero in exact arithmetic) {err:.3e}")
            continue
        err, cpu_err = rel(g[k], r[k]), rel(c[k], r[k])
        rows.append((err / max(cpu_err, TRAIN_CHECK_FLOOR), err, cpu_err, k))
        if err > limit(cpu_err):
            bad.append(f"{k} {err:.3e} (CPU fp32 {cpu_err:.3e})")
    names = [k for k in r if k not in ZERO_GRAD and r[k].any()]
    flat = lambda d: torch.cat([d[k].flatten() for k in names])  # noqa
    total, cpu_total = rel(flat(g), flat(r)), rel(flat(c), flat(r))
    stats = {x: max(rel(d["stats"][k], v) for k, v in ref["stats"].items())
             for x, d in (("card", card), ("cpu", cpu))}
    loss = {x: abs(d["loss"] - ref["loss"]) / abs(ref["loss"])
            for x, d in (("card", card), ("cpu", cpu))}
    rows.sort(reverse=True)
    by_err = sorted(rows, key=lambda row: -row[1])
    out = {"episodes": 2, "frames_per_episode": 2 * way * T,
           "grad_tensors": len(rows),
           "grad_rel_l2_vs_fp64_all": {"card": total, "cpu": cpu_total},
           "grad_rel_l2_vs_fp64_median": {
               "card": sorted(e for _, e, _, _ in rows)[len(rows) // 2],
               "cpu": sorted(e for _, _, e, _ in rows)[len(rows) // 2]},
           "grad_worst_card_to_cpu": [[k, q, e, ce]
                                      for q, e, ce, k in rows[:6]],
           "grad_worst_card": [[k, e, ce] for _, e, ce, k in by_err[:6]],
           "grad_factor": TRAIN_CHECK_FACTOR,
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


def phase_train_path() -> dict:
    from clipspm_tpu_torch.cli.run import main as cli_main
    from clipspm_tpu_torch.utils.config import load_config

    spec, run = PATHS["clipspm"], TRAIN_RUN
    counters = _counters()
    log("train path clipspm-train: frames come from the same seeded uint8 "
        "source after the decode stage as the eval paths")
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_split(root, spec["frame_dir"], spec["split_dir"],
                    spec["classes"], spec["videos"], SPLIT_FRAMES, SPLIT_PX)
        write_split(root, spec["frame_dir"], spec["split_dir"],
                    run["train_classes"], run["train_videos"], SPLIT_FRAMES,
                    SPLIT_PX, mode="train")
        log(f"train path: wrote {run['train_classes'] * run['train_videos']}"
            f" train and {spec['classes'] * spec['videos']} test videos in "
            f"{time.perf_counter() - t0:.1f} s")
        ckpt = os.path.join(root, "ckpt")
        flags = ["--cfg", spec["cfg"], "--splits-root", root]
        opts = [f"DATA.DATA_DIR={root}", f"CHECKPOINT.CHECKPOINT_DIR={ckpt}"]
        train_opts = [*opts, f"TRAIN.TRAIN_EPISODES={run['episodes']}",
                      f"TRAIN.VAL_FREQ={run['val_freq']}",
                      f"TRAIN.PRINT_FREQ={run['print_freq']}",
                      f"TEST.TEST_EPISODES={run['val_episodes']}",
                      f"CHECKPOINT.SAVE_FREQ={run['save_freq']}"]
        rec = _TrainRecorder()
        _fresh_peak()
        with rec.installed():
            _zero_counters(counters)
            t0 = time.perf_counter()
            res = cli_main([*flags, "--allow-random-weights", *train_opts])
            wall = time.perf_counter() - t0
            train_launches = _read_counters(counters)
        peak = torch.cuda.max_memory_allocated()
        learner, val_launches = rec.learner, rec.val_launches
        build_seconds = learner.build_seconds
        cfg = load_config(spec["cfg"], opts=train_opts, splits_root=root)

        recs = _read_jsonl(os.path.join(ckpt, "metrics.jsonl"))
        losses = [r["value"] for r in recs
                  if r["tag"] == "loss/Train_loss[it]"]
        val_acc = [r["value"] for r in recs if r["tag"] == "acc/Test_acc"]
        with open(os.path.join(ckpt, "log.txt")) as f:
            stalls = [float(x) for x in
                      re.findall(r"host-stall (\d+)%", f.read())]
        steps = [(n, a.elapsed_time(b) / 1e3) for n, a, b in rec.steps]
        want_steps = [16, 16, 16, 8]
        if [n for n, _ in steps] != want_steps or len(losses) != 4 \
                or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"train path: steps {steps}, losses "
                                 f"{losses}")
        if res["episodes"] != run["episodes"]:
            raise AssertionError(f"train path ran {res['episodes']} episodes")
        # K1: 3 fused launches an episode (its backward launches none);
        # K2: none, the clipspm head runs no soft-DTW
        want = {"train": {"K1": 3 * run["episodes"], "K2": 0},
                "val": [{"K1": 3 * run["val_episodes"], "K2": 0}]}
        if train_launches != want["train"] or val_launches != want["val"]:
            raise AssertionError(f"launches {train_launches} in training and "
                                 f"{val_launches} in validation; expected "
                                 f"{want}")
        for tag in ("best", f"iter_{run['save_freq']}"):
            if not os.path.isfile(os.path.join(ckpt, f"checkpoint_{tag}",
                                               "checkpoint.pt")):
                raise AssertionError(f"no checkpoint_{tag}")

        profile = profile_train_step(learner, cfg)
        log(json.dumps({"train_profile": profile}))
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
                                 f"TEST.TEST_EPISODES={run['val_episodes']}",
                                 f"TEST.TEST_MODEL_PATH={best}"])
            test_wall = time.perf_counter() - t0
            test_launches = _read_counters(counters)
        restored = test_rec.learner.model.state_dict()
        if set(restored) != set(saved["model"]) or not all(
                torch.equal(restored[k].cpu(), v)
                for k, v in saved["model"].items()):
            raise AssertionError("ONLY_TEST's restored state_dict differs "
                                 "from checkpoint_best's")
        if test_launches != want["val"][0]:
            raise AssertionError(f"launches {test_launches} in the ONLY_TEST "
                                 f"run; expected {want['val'][0]}")
        del test_rec
    check = check_train_step_against_cpu(spec["cfg"])
    rate_steps = steps[1:]
    out = {"path": "clipspm-train", "episodes": res["episodes"],
           "step_losses": losses, "step_episodes": [n for n, _ in steps],
           "step_device_seconds": [s for _, s in steps],
           "train_episodes_per_s_steps_2_4":
               sum(n for n, _ in rate_steps) / sum(s for _, s in rate_steps),
           "seconds_per_optimizer_step_2_3": [s for _, s in steps[1:3]],
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
           "train_step_vs_cpu": check}
    log(json.dumps({"train_path": out}))
    return out


def main() -> int:
    device = phase_device()
    phase_build()
    k1 = phase_k1()
    k2 = phase_k2()
    clipspm = phase_main_path("clipspm")
    ta2n = phase_main_path("ta2n")
    train = phase_train_path()
    k1["launches"] = clipspm["launches"]["K1"]
    k1["launches_by_path"] = {"clipspm": clipspm["launches"]["K1"],
                              "ta2n": ta2n["launches"]["K1"],
                              "clipspm-train": train["launches"]["K1_train"]}
    k2["launches"] = ta2n["launches"]["K2"]
    k2["launches_by_path"] = {"clipspm": clipspm["launches"]["K2"],
                              "ta2n": ta2n["launches"]["K2"],
                              "clipspm-train": train["launches"]["K2_train"]}
    log(json.dumps({"kernels": [k1, k2]}))
    log(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
