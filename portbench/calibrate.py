"""Readings that the limits of ``limits/<workload>.json`` are set from, on
the card, at the cell's own sizes (not run by the benchmark's runs):

    python3 portbench/calibrate.py --workload rn50-eval \\
        --seeds 11,12,... --control-seeds 11,12,13 [--faults all] \
        [--seconds 5]

For each of ``--seeds``: one run of the cell (``harness.run_cell``, its
window ``--seconds`` long, the benchmark's ``run_seconds`` unless given),
its numbers against the reference (the lower readings). For each of
``--control-seeds``: the control's numbers (the upper readings), the
reference computed in float8 put in the program's place; with
``--faults`` (names, or ``all``) also a run with each of those faults of
``faults.py`` that the cell's entry can have planted in it. One JSON line
a reading.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from portbench import faults, harness, inputs
    from portbench.reference.precision import fp8

    cell = harness.find_cell(args.workload)
    ent = harness.entry(cell.traffic["entry"])
    device = args.device
    seconds = (args.seconds if args.seconds is not None
               else harness.benchmark()["run_seconds"])

    def emit(kind, seed, numbers, t0, **extra):
        print(json.dumps({"workload": cell.name, "reading": kind,
                          "seed": seed, "numbers": numbers,
                          "seconds": time.perf_counter() - t0, **extra}),
              flush=True)
        harness._free(device)

    def run(kind, seed, plant=None):
        t0 = time.perf_counter()
        out = harness.run_cell(cell, seed, seconds, False, device,
                               plant=plant)
        emit(kind, seed, {k: c["value"] for k, c in out["checks"].items()},
             t0, correct=out["correct"], failed=out["failed"])

    for seed in (int(s) for s in args.seeds.split(",") if s):
        run("program", seed)
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        t0 = time.perf_counter()
        pool = inputs.make_episodes(
            cell.traffic, len(inputs.class_names(cell.config, ent.SPLIT)),
            seed, device)
        emit("control_fp8_reference", seed, ent.control(
            harness.reference_inputs(cell, pool, seed, device), fp8), t0)
        # an unchanged state reads 1 by the change's measure: no run
        for fault in ent.FAULTS:
            if fault != "unchanged_state" and (
                    args.faults == "all" or fault in args.faults.split(",")):
                run(f"fault_{fault}", seed, faults.FAULTS[fault])
    return 0


if __name__ == "__main__":
    sys.exit(main())
