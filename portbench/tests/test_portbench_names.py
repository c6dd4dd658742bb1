"""The harness finds every configuration, traffic mix, limit file and
per-layer reader of ``BENCHMARK.json`` by name, refuses unknown ones, and
the file keeps to the benchmark's contract."""

import json
import os
import re
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench import compare, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark()


def test_every_cell_is_found(bench):
    for w in bench["workloads"]:
        cell = harness.find_cell(w["name"], bench)
        harness.check_layout(cell)
        assert compare.limits(w["name"])
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_unknown_names_are_refused(bench):
    with pytest.raises(harness.UnknownName):
        harness.find_cell("no-such-cell", bench)
    with pytest.raises(harness.UnknownName):
        harness.traffic("no-such-mix")
    with pytest.raises(harness.UnknownName):
        harness.metric_reader("no_such.metric")
    with pytest.raises(harness.UnknownName):
        harness.entry("no_such_entry")
    broken = json.loads(json.dumps(bench))
    broken["workloads"][0]["config"] = "no-such-config"
    with pytest.raises(harness.UnknownName):
        harness.find_cell(broken["workloads"][0]["name"], broken)


def test_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    cells = [w["name"] for w in bench["workloads"]]
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(cells)) == len(cells) and len(set(metrics)) == len(metrics)
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/") and not c["reduced"]
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        for w in m["workloads"]:
            assert _applies(e2e[m["moves"]], w)
        assert os.path.isfile(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(
        1, len(cells) // 4)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def _applies(metric, w):
    return "workloads" not in metric or w in metric["workloads"]


def test_without_a_card_there_is_no_result():
    """On a host with no CUDA device the command exits non-zero and prints
    no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "rn50-eval",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
