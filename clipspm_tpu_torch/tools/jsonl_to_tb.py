"""Convert a metrics.jsonl (clipspm_tpu_torch.utils.metrics.MetricsWriter
output) into TensorBoard event files.

Usage:
    python -m clipspm_tpu_torch.tools.jsonl_to_tb [--device cpu] \\
        <metrics.jsonl> <tb_out_dir>

The conversion runs on the host; like every entry point of the port it
refuses a host without a GPU unless given ``--device cpu``. Exits 2 with
this text when the two paths are not given.
"""

import argparse
import sys


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    known, paths = ap.parse_known_args(argv)
    if len(paths) != 2:
        print(__doc__)
        return 2
    from clipspm_tpu_torch import resolve_device
    from clipspm_tpu_torch.utils.metrics import jsonl_to_tensorboard

    resolve_device(known.device)
    n = jsonl_to_tensorboard(paths[0], paths[1])
    print(f"wrote {n} scalars to {paths[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
