"""One run of one cell: set-up, the window, the per-layer readers, the
comparison with the reference, the result line.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``
(at the checkout's root), ``configs/<config>.json``, ``traffic/<mix>.json``,
the program entry that the mix names (``entries/<entry>.py``),
``limits/<workload>.json``, and ``metrics/<metric>.py`` for each per-layer
metric of the cell.

An entry module has ``RATE`` (the end-to-end rate it reports), ``SPLIT``
(the class names its text table holds), ``FAULTS`` (those of ``faults.py``
that it can have), and ``layout(cfg)`` (the traffic keys the configuration
fixes), ``setup``, ``window``, ``segment`` (a traced one), ``rate``,
``diagnostics``, ``check`` (the numbers compared, after the program is
freed) and ``control`` (the reference in a lower precision in the
program's place).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the top-level modules that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "clipspm_tpu")


class UnknownName(LookupError):
    """A workload, configuration, traffic mix or metric not found by its
    name."""


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    path = os.path.join(HERE, kind, f"{name}.json")
    if not os.path.isfile(path):
        raise UnknownName(f"no {kind} file for {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    t = _json("traffic", name)
    entry(t.get("entry"))
    return t


def entry(name):
    """The program entry ``entries/<name>.py``."""
    if not isinstance(name, str) or not os.path.isfile(
            os.path.join(HERE, "entries", f"{name}.py")):
        raise UnknownName(f"no program entry {name!r} (entries/<entry>.py)")
    return importlib.import_module(f"portbench.entries.{name}")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        raise UnknownName(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(workload: str, bench: Optional[dict] = None) -> Cell:
    """The cell called ``workload`` with its files and metrics, or
    ``UnknownName``."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise UnknownName(f"unknown workload {workload!r}; the benchmark has "
                          f"{sorted(cells)}")
    w = cells[workload]
    cfgs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in cfgs:
        raise UnknownName(f"unknown configuration {w['config']!r}")
    conf = _json_path(cfgs[w["config"]]["file"])
    t = traffic(w["traffic"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    for m in layer:
        metric_reader(m["name"])
    return Cell(workload, int(w["chips"]), conf, t, e2e, layer)


def _json_path(rel: str) -> dict:
    path = os.path.join(ROOT, rel)
    if not os.path.isfile(path):
        raise UnknownName(f"no configuration file {rel!r}")
    with open(path) as f:
        return json.load(f)


def check_layout(cell: Cell) -> None:
    """The traffic's episodes fit the configuration's model and trainer."""
    t = cell.traffic
    want = entry(t["entry"]).layout(cell.config["port_config"])
    bad = {k: (t[k], v) for k, v in want.items() if int(t[k]) != v}
    if bad:
        raise ValueError(f"{cell.name}: traffic and configuration disagree "
                         f"(traffic, configuration): {bad}")


def transform_spec(cfg: dict) -> dict:
    """The decode-to-model transform the configuration states (the port's
    ``TransformSpec.from_config`` rule)."""
    img = int(cfg["DATA"]["IMG_SIZE"])
    resize = 256 if img == 224 else 96 if img == 84 else max(96, -(-img * 8
                                                                 // 7))
    return {"img_size": img, "resize_to": resize,
            "flip": cfg["DATA"]["DATASET"] not in ("ssv2", "ssv2_cmn")}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``clipspm_tpu_torch`` is not ``clipspm_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What the per-layer readers read: the untraced window as the entry
    returned it (``episodes``, ``wall_s``, ...) and the allocator's peak
    over it; a trace of the card alone (``card``) and one of the host and
    the card (``host``), each over a segment of ``trace_steps`` steps, with
    the episodes of each."""
    config: dict
    traffic: dict
    window: dict
    peak_bytes: Optional[int]
    card: object
    card_episodes: int
    host: object
    host_episodes: int


@dataclasses.dataclass
class Inputs:
    """What the reference is handed: the configuration, the traffic, the
    pool, the seed, and the weights, text table and transform worked out
    again from them."""
    config: dict
    traffic: dict
    pool: list
    seed: int
    P: dict
    table: object
    transform: dict


def reference_inputs(cell: Cell, pool: list, seed: int, device) -> Inputs:
    """The reference's inputs, in float32 with TF32 off."""
    import torch

    from . import inputs
    from .reference import run as ref

    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    conf = cell.config
    names = inputs.class_names(conf, entry(cell.traffic["entry"]).SPLIT)
    P = inputs.make_weights(conf, seed, device)
    table = ref.text_table(P, conf["published"], names, device)
    return Inputs(conf, cell.traffic, pool, seed, P, table,
                  transform_spec(conf["port_config"]))


def _free(device) -> None:
    gc.collect()
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             limits: Optional[dict] = None, plant=None) -> dict:
    """One run of ``cell``; returns the result line's object. ``plant``
    (faults only) is called with the built learner before set-up, to break
    the timed path. With ``trace`` the untraced window is followed by a
    segment traced on the card alone and one traced on the host too."""
    import torch

    from . import compare, inputs, program
    from .trace import traced

    t_start = time.perf_counter() if t_start is None else t_start
    check_layout(cell)
    conf, t = cell.config, cell.traffic
    ent = entry(t["entry"])
    on_cuda = torch.device(device).type == "cuda"
    names = inputs.class_names(conf, ent.SPLIT)
    pool = inputs.make_episodes(t, len(names), seed, device)
    learner = program.build(conf, seed, device)
    if plant is not None:
        plant(learner)
    state = ent.setup(learner, pool, t)
    setup_peak = 0
    if on_cuda:
        torch.cuda.synchronize()
        setup_peak = int(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    window = ent.window(learner, pool, t, seconds, state)
    window_peak = int(torch.cuda.max_memory_allocated()) if on_cuda else None
    metrics: Dict[str, dict] = {}
    if trace:
        card, host = {}, {}
        with traced(learner.model, card, host=False):
            card_seg = ent.segment(learner, pool, t, state)
        with traced(learner.model, host, host=True):
            host_seg = ent.segment(learner, pool, t, state)
        run = Run(conf, t, window, window_peak, card["trace"],
                  card_seg["episodes"], host["trace"], host_seg["episodes"])
        for m in cell.per_layer:
            value = metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, ent.RATE: ent.rate(window)}
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
    peak = max(setup_peak, int(torch.cuda.max_memory_allocated())
               if on_cuda else 0)

    # the program's state goes before the reference runs
    del learner
    _free(device)
    numbers, failed = ent.check(reference_inputs(cell, pool, seed, device),
                                window, state)
    limit = limits if limits is not None else compare.limits(cell.name)
    out = {"correct": bool(compare.judge(numbers, limit, failed)),
           "attempted": int(window["episodes"]), "failed": int(failed),
           "metrics": metrics, "device": _device(cell, peak, on_cuda)}
    if trace:
        out["device"]["busy_s"] = card["trace"].busy_s()
        out["device"]["window_s"] = card["trace"].window_s
        out["breakdown"] = {
            "device_ops": card["trace"].breakdown()["device_ops"],
            "idle_gaps": host["trace"].breakdown()["idle_gaps"]}
        out["trace_reduce_s"] = card["reduce_s"] + host["reduce_s"]
    out["window"] = ent.diagnostics(window)
    out["checks"] = compare.checks_block(numbers, limit)
    return out


def _device(cell: Cell, peak: int, on_cuda: bool) -> dict:
    import torch
    if not on_cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips, "memory_peak_bytes": peak}
