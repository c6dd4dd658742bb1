"""``metrics/tower_graph_share.eval.py`` on hand-built host traces: tower
ranges with and without a ``cudaGraphLaunch`` inside them, on their thread
or another one."""

import pytest

from portbench import harness
from portbench.trace import TOWER, Trace

MS = 1_000_000


def _cpu(name, start_ms, end_ms, thread=1, op=0):
    return (name, start_ms * MS, end_ms * MS, thread, op, [])


def _run(cpu):
    host = Trace(device=[], cpu=cpu, window=(0, 100 * MS))
    return harness.Run({}, {}, {}, None, None, 0, host, 1)


READ = harness.metric_reader("tower_graph_share.eval")


def test_every_tower_range_that_launched_a_graph_counts():
    # four tower calls on thread 1: the first eager (kernel launches
    # only), the next three replays; a launch on thread 2 inside the first
    # range and one between ranges count for none
    cpu = [_cpu(TOWER, 0, 10), _cpu("cudaLaunchKernel", 2, 3),
           _cpu("cudaGraphLaunch", 5, 6, thread=2),
           _cpu(TOWER, 20, 30), _cpu("cudaGraphLaunch", 21, 29),
           _cpu("cudaGraphLaunch", 35, 36),
           _cpu(TOWER, 40, 50), _cpu("cudaGraphLaunch", 40, 41),
           _cpu(TOWER, 60, 70), _cpu("cuGraphLaunch", 70, 71)]
    assert READ(_run(cpu)) == pytest.approx(75.0)


def test_an_eager_tower_reads_zero_and_no_tower_reads_nothing():
    eager = [_cpu(TOWER, 0, 10), _cpu("cudaLaunchKernel", 2, 3),
             _cpu(TOWER, 20, 30), _cpu("aten::linear", 21, 29)]
    assert READ(_run(eager)) == 0.0
    assert READ(_run([_cpu("cudaGraphLaunch", 2, 3)])) is None
