"""Share of the benchmark's ``portbench.tower`` ranges (every forward of
the model's vision tower) in the host trace that launched a CUDA graph: a
runtime event whose name holds ``GraphLaunch`` started inside the range, on
its thread. In %; 0 where the tower runs eager. Layer: transform +
encode."""

import bisect

from portbench.trace import TOWER


def read(run):
    towers = run.host.spans(TOWER)
    if not towers:
        return None
    launches = {}
    for name, start, _, thread, _, _ in run.host.cpu:
        if "GraphLaunch" in name:
            launches.setdefault(thread, []).append(start)
    for starts in launches.values():
        starts.sort()
    replayed = 0
    for start, end, thread in towers:
        starts = launches.get(thread, [])
        i = bisect.bisect_left(starts, start)
        replayed += i < len(starts) and starts[i] <= end
    return 100.0 * replayed / len(towers)
