"""Where kernel K1's device time goes: the shipped source against two
variants derived from it by text substitution.

- ``shipped``: ``csrc/otam_dp.cu`` as it is;
- ``prefetch``: each row's table values are loaded into registers before
  the dependent walk over the row (tests whether global-load latency inside
  the walk costs time);
- ``reciprocal``: ``prefetch`` plus the soft-min's ``(x - m) / lbda``
  computed as ``(x - m) * (1 / lbda)`` (tests the cost of the IEEE
  divisions on the serial chain).

Each variant is built with the same ``nvcc`` flags, checked against the
plain wavefront, and timed per launch as CUDA-graph replays between CUDA
events (no gap from the host's launches). Run on a machine with an NVIDIA
GPU:

    python3 -m clipspm_tpu_torch.tools.k1_variants
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

from ..ops import build
from ..ops.otam import otam_cum_dist as plain

_WALK_LOAD = "const float d = (m <= Ms) ? drow[m - 1] : 0.0f;"
_ROW_START = """    const float* drow = table + static_cast<size_t>(l) * Ms;
    float upleft = 0.0f;"""
_PREFETCH = """    const float* drow = table + static_cast<size_t>(l) * Ms;
    float drow_reg[kMaxM];
#pragma unroll
    for (int m = 1; m < kMaxM; ++m)
      drow_reg[m] = (m <= Ms) ? drow[m - 1] : 0.0f;
    float upleft = 0.0f;"""


def variant_sources() -> dict:
    with open(os.path.join(build.CSRC_DIR, "otam_dp.cu")) as f:
        shipped = f.read()
    for needle in (_WALK_LOAD, _ROW_START, "const float m = fminf(a, b);",
                   "const float m = fminf(fminf(a, b), c);"):
        if needle not in shipped:
            raise RuntimeError(f"csrc/otam_dp.cu changed: {needle!r} not found")
    prefetch = shipped.replace(_ROW_START, _PREFETCH).replace(
        _WALK_LOAD, "const float d = drow_reg[m];")
    reciprocal = prefetch
    for x in "abc":
        reciprocal = reciprocal.replace(f"({x} - m) / lbda", f"({x} - m) * il")
    for head in ("const float m = fminf(a, b);",
                 "const float m = fminf(fminf(a, b), c);"):
        reciprocal = reciprocal.replace(
            head, head + "\n  const float il = 1.0f / lbda;")
    return {"shipped": shipped, "prefetch": prefetch,
            "reciprocal": reciprocal}


def _load(name: str, source: str) -> ctypes.CDLL:
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    src = os.path.join(build.BUILD_DIR, f"k1_{name}.cu")
    lib = os.path.join(build.BUILD_DIR, f"libk1_{name}.so")
    with open(src, "w") as f:
        f.write(source)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
                   check=True)
    dll = ctypes.CDLL(lib)
    dll.otam_dp_launch.restype = ctypes.c_int
    dll.otam_dp_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    return dll


def graph_ms(fn, iters: int = 200) -> float:
    """Per-call device time of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed between CUDA events, so no gap from the host's
    launches remains."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("k1_variants needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    libs = {n: _load(n, s) for n, s in variant_sources().items()}
    gen = torch.Generator().manual_seed(0)
    for B in (25, 5, 1600):
        tables = (torch.rand(B, 8, 8, generator=gen) * 2.0).cuda()
        for lbda in (0.5, 0.1):
            want = plain(tables, lbda)
            row = {"B": B, "lambda": lbda}
            for name, lib in libs.items():
                out = torch.empty(B, device="cuda")

                def launch(lib=lib, out=out):
                    rc = lib.otam_dp_launch(
                        tables.data_ptr(), out.data_ptr(), B, 8, 8, lbda,
                        torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"launch failed: cudaError {rc}")

                launch()
                torch.cuda.synchronize()
                row[f"{name}_max_abs_err"] = (out - want).abs().max().item()
                row[f"{name}_device_ms"] = graph_ms(launch)
            print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
