"""Timing of work on the card from CUDA events, for ``chip_smoke.py``.

- ``eager_ms``: per-call time of ``fn`` launched eagerly after warm-up; the
  host's launch rate is included where it is slower than the device;
- ``graph_ms``: per-call device time of ``fn``, its calls captured in one
  CUDA graph and replayed, so no gap from the host's launches remains.
"""

from __future__ import annotations

import torch

# One warm-up stream for every graph_ms call: cuBLAS keeps a workspace for
# each stream it has run on, so a new stream per call would hold 32 MB more
# device memory after each timed function that multiplies matrices.
_warmup_stream = None


def eager_ms(fn, iters: int = 200) -> float:
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


def graph_ms(fn, iters: int = 200) -> float:
    global _warmup_stream
    if _warmup_stream is None:
        _warmup_stream = torch.cuda.Stream()
    side = _warmup_stream
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
