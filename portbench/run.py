"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the cell's CUDA devices.
The last line of standard output is the result (JSON); the numbers that
decided ``correct`` end standard error, each beside its limit. Exits
non-zero, with no result, without enough CUDA devices, on an unknown name,
or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache in the checkout, at fixed paths
CACHE = os.path.join(ROOT, ".portbench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    cell = harness.find_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 3
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded {found} (JAX or the JAX package)",
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
