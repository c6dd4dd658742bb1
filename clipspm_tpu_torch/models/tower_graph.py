"""CUDA-graph replay of the vision towers in evaluation.

Every tower that ``models/visual.py:encode_chunked`` calls
(``ModifiedResNet``, ``VisionTransformer``, ``TorchResNet``) derives from
:class:`GraphedTower`: its ``forward`` comes here, and ``tower_forward`` is
its eager body. A call runs the eager body, counted under the first reason
that holds, unless none does:

- ``grad``: grad mode is on (training, a remat chunk's recompute);
- ``train``: a module of the tower is in train mode;
- ``tp``: a module has a tensor-parallel context (``parallel/tensor.py``:
  its all-reduces run inside the forward);
- ``hook``: a module inside the tower has a forward hook, or a global one
  or a Python dispatch or function mode is on (a replay runs no Python);
- ``cpu``: the input is not on a CUDA device;
- ``first``: the call's key is new (the eager run warms cuBLAS, cuDNN and
  the allocator);
- ``full``: the tower holds ``MAX_GRAPHS`` graphs and the key is none of
  them.

A key is the input's shape, strides, dtype and device, the autocast state,
inference mode and the two TF32 switches. A key's second call captures a
graph of the eager body on a side stream and replays it; every later call
copies the input into the graph's static input, replays it on the current
stream and returns a clone of its static output (the chunked encode
concatenates several calls, and the next replay overwrites the static
output), all inside the operator ``clipspm_tower_graph::replay``, to which a
profiler links the graph's kernels.

The graph reads the tower's parameters and buffers where they lie, so
in-place updates (Adam, BatchNorm's running statistics, ``load_state_dict``'s
copies) reach the next replay. A tower whose tensors moved (``.to()``, a load
that assigns new ones) or whose switches changed drops its graphs and starts
again. Each tower class names in ``graph_switches`` the attributes of its
modules that their forwards read as they run (``int8_eval``,
``fast_softmax``, the norms' ``fp32``, ...).

Capture runs with ``capture_error_mode="thread_local"`` (the evaluator's
staging thread allocates pinned memory and issues copies while the main
thread captures) and under autocast without its weight-cast cache, as
``torch.cuda.make_graphed_callables`` requires: a cast cached during capture
would be a graph-pool tensor that later eager code reads. Each replay so
casts the weights again, where an eager episode casts them once. The int8
GEMMs a graph holds are added to ``ops/quant.py``'s ``launches`` at each
replay, so that count stays the GEMMs run on the card.

:func:`counts` gives the process's calls by mode (``replay``, ``capture``,
``eager``) and the eager ones by reason; :func:`last_mode` the mode of this
thread's last call (the ``model.tower`` span's ``graph`` attribute).
"""

from __future__ import annotations

import itertools
import threading
import weakref
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils._python_dispatch import _get_current_dispatch_mode

from ..ops import quant

# graphs a tower keeps (one per input signature: the eval chunk, the
# feature cache's last batch, ...); calls with other keys run eager
MAX_GRAPHS = 4
REASONS = ("grad", "train", "tp", "hook", "cpu", "first", "full")

_LOCK = threading.Lock()
_CAPTURE_LOCK = threading.Lock()
_COUNTS = {"replay": 0, "capture": 0, "eager": 0}
_EAGER = dict.fromkeys(REASONS, 0)
_LAST = threading.local()


def counts() -> Dict[str, object]:
    """The process's tower calls by mode, and the eager ones by reason."""
    with _LOCK:
        return {**_COUNTS, "eager_reasons": dict(_EAGER)}


def last_mode() -> str:
    """``"replay"``, ``"capture"`` or ``"eager"``: this thread's last tower
    call."""
    return getattr(_LAST, "mode", "eager")


def _count(mode: str, reason: Optional[str] = None) -> None:
    _LAST.mode = mode
    with _LOCK:
        _COUNTS[mode] += 1
        if reason is not None:
            _EAGER[reason] += 1


def tower_key(tower: nn.Module) -> Tuple[Optional[str], Optional[tuple]]:
    """``(reason, None)`` if a module of ``tower`` rules a graph out
    (``train``, ``tp``, ``hook``), else ``(None, key)``: the address of
    every parameter and buffer and the ``graph_switches`` of every
    module."""
    key = []
    data_ptr = torch.Tensor.data_ptr
    switches = type(tower).graph_switches
    stack = [tower]
    while stack:
        module = stack.pop()
        d = module.__dict__
        if d["training"]:
            return "train", None
        if d.get("tp") is not None:
            return "tp", None
        if module is not tower and (d["_forward_hooks"]
                                    or d["_forward_pre_hooks"]):
            return "hook", None
        key.append(tuple(map(d.get, switches)))
        for t in d["_parameters"].values():
            if t is not None:
                key.append(data_ptr(t))
        for t in d["_buffers"].values():
            if t is not None:
                key.append(data_ptr(t))
        stack.extend(m for m in d["_modules"].values() if m is not None)
    return None, tuple(key)


def _python_hooks() -> bool:
    """A global forward hook, or a Python dispatch or function mode."""
    module = nn.modules.module
    return bool(module._global_forward_hooks
                or module._global_forward_pre_hooks
                or _get_current_dispatch_mode() is not None
                or torch._C._is_torch_function_mode_enabled())


def _settings(device_type: str) -> tuple:
    """What the port sets that chooses a call's kernels and precision,
    besides its input: autocast (``clipspm_tpu_torch/__init__.py``), TF32
    (``chip_smoke.py``'s fp32 tower check) and inference mode."""
    return (torch.is_autocast_enabled(device_type),
            torch.get_autocast_dtype(device_type),
            torch.is_inference_mode_enabled(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


class _Graph:
    """One captured call: the graph, its static input and output, and the
    int8 GEMMs it holds."""

    def __init__(self, tower: "GraphedTower", x: torch.Tensor):
        dt = x.device.type
        self.static_in = torch.empty_strided(
            x.shape, x.stride(), dtype=x.dtype, device=x.device)
        self.static_in.copy_(x)
        self.graph = torch.cuda.CUDAGraph()
        autocast = torch.autocast(dt, dtype=torch.get_autocast_dtype(dt),
                                  enabled=torch.is_autocast_enabled(dt),
                                  cache_enabled=False)
        with _CAPTURE_LOCK, torch.cuda.device(x.device):
            before = quant.launches
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"), \
                    autocast:
                self.static_out = tower.tower_forward(self.static_in)
            # capture ran no GEMM: each replay counts what it runs
            self.int8_gemms = quant.launches - before
            quant.launches = before

        self.id = next(_IDS)
        _LIVE[self.id] = self

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.ops.clipspm_tower_graph.replay(x, self.id)
        quant.launches += self.int8_gemms
        return out

    def run(self, x: torch.Tensor) -> torch.Tensor:
        self.static_in.copy_(x)
        self.graph.replay()
        return self.static_out.clone()


# A replay is issued from an operator of its own. CUPTI gives a graph's
# kernels the correlation of its cudaGraphLaunch, and the profiler links that
# to the innermost operator running on the thread (a ``record_function``
# range does not count): so a trace credits the kernels to a host op inside
# the tower's module call, as it does the eager body's.
_LIB = torch.library.Library("clipspm_tower_graph", "DEF")
_LIB.define("replay(Tensor x, int graph) -> Tensor")
_LIVE: "weakref.WeakValueDictionary[int, _Graph]" = \
    weakref.WeakValueDictionary()
_IDS = itertools.count()


def _replay(x: torch.Tensor, graph: int) -> torch.Tensor:
    return _LIVE[graph].run(x)


_LIB.impl("replay", _replay, "CUDA")


class _Graphs:
    """One tower's graphs by call key, the keys seen once, and the tower key
    they were captured under. A copy or a pickle of the tower starts with
    none."""

    def __init__(self):
        self.tower = None
        self.graphs: Dict[tuple, _Graph] = {}
        self.seen = set()

    def __deepcopy__(self, memo):
        return _Graphs()

    def __reduce__(self):
        return _Graphs, ()


def dispatch(tower: "GraphedTower", x: torch.Tensor) -> torch.Tensor:
    """``tower``'s output for ``x``: a graph's replay where the call allows
    one, else the eager body (see the module's docstring)."""
    if torch.is_grad_enabled():
        reason, key = "grad", None
    else:
        reason, key = tower_key(tower)
    if reason is None:
        if _python_hooks():
            reason = "hook"
        elif x.device.type != "cuda":
            reason = "cpu"
    if reason is not None:
        _count("eager", reason)
        return tower.tower_forward(x)
    state = tower.__dict__.get("_tower_graphs")
    if state is None:
        state = tower._tower_graphs = _Graphs()
    if state.tower != key:
        state.tower, state.graphs, state.seen = key, {}, set()
    call = (tuple(x.shape), x.stride(), x.dtype, x.device,
            _settings(x.device.type))
    graph = state.graphs.get(call)
    mode = "replay"
    if graph is None:
        if len(state.graphs) >= MAX_GRAPHS:
            reason = "full"
        elif call not in state.seen:
            state.seen.add(call)
            reason = "first"
        if reason is not None:
            _count("eager", reason)
            return tower.tower_forward(x)
        graph = state.graphs[call] = _Graph(tower, x)
        mode = "capture"
    out = graph(x)
    _count(mode)
    return out


class GraphedTower(nn.Module):
    """A vision tower whose calls in evaluation on the card replay a CUDA
    graph (see the module's docstring); ``tower_forward`` is its eager
    body. ``graph_switches``: the attributes of the tower's modules that
    their forwards read as they run, which the tower key holds."""

    graph_switches: Tuple[str, ...] = ()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dispatch(self, x)

    def tower_forward(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError
