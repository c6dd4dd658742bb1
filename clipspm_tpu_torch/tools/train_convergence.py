"""Convergence run of the port: a full-size tower and head trained from
random initialisation through the port's CLI, on class-separable JPEGs
read from disk.

Port of ``scripts/train_convergence.py``, with the same arguments,
defaults, dataset and one-line JSON. Its steps, each a CLI run:

1. ``make_convergence_dataset``: ``scripts/make_synthetic_dataset.py``
   (read in place) writes 256x256 JPEGs, 12 frames a video, ``--classes``
   train classes of ``--videos`` videos and as many test classes whose hues
   are disjoint from them, so the final accuracy measures transfer to
   unseen classes;
2. ``train``: training with a validation every ``--val-freq`` episodes,
   which saves ``checkpoint_best``;
3. ``restore``, three times: the test protocol over ``--final-eps`` seeded
   episodes from ``checkpoint_best`` uncached (the final accuracy), uncached
   again (a restore reproduces it) and through the feature cache
   (``TEST.CACHE_FEATURES=true``: the cached evaluator on the trained
   checkpoint, and its wall). The uncached runs say
   ``TEST.CACHE_FEATURES=false``: the JAX tool leaves them to the config,
   and ``configs/clipspm/*.yaml`` turn the cache on, so there all three of
   its restores take the cached evaluator.

Run on the GPU (``--device cuda``, the default; without a GPU it raises):

    python -m clipspm_tpu_torch.tools.train_convergence --arch RN50 \\
        --episodes 640 --lr 1e-4 [--root DIR] [--keep]

``--smoke`` shrinks the sizes only (test-tiny tower, 32x32 frames, 16
episodes), never the device: on a host without a GPU add ``--device cpu``.
Each step runs the CLI in a fresh process; ``run_cli`` may be swapped for
``run_cli_in_process`` to read the run's state (kernel counters, decode)
from the calling process. Prints one JSON line with the JAX tool's keys:
``arch``, ``episodes``, ``lr``, ``chance_pct``, ``train_loss_curve``,
``val_curve``, ``final_acc``, ``final_ci``, ``final_eval_episodes``,
``restore_acc``, ``cached_eval_acc`` and the walls of the training, the
final evaluation and the cached one. ``--keep`` keeps the checkpoint
directory (``<root>/ckpt_<arch>``, with the CLI's ``log.txt`` and
``metrics.jsonl``).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATASET_SCRIPT = os.path.join(REPO, "scripts", "make_synthetic_dataset.py")
FRAME_DIRS = {"hmdb": "hmdb_256x256q5_l8", "ucf": "ucf_256x256q5_l8",
              "kinetics": "k100_256x256q5_l8"}

TRAIN_LOSS = re.compile(r"Task \[(\d+)/\d+\], Train Loss: ([\d.]+)")
VAL_ACC = re.compile(r"Val @ (\d+): acc ([\d.]+)")
TEST_ACC = re.compile(r"\w+: ([\d.]+) \+/- ([\d.]+)")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", default=None,
                    help="family config to train (default "
                         "configs/clipspm/<dataset>.yaml); any head's "
                         "config works, e.g. configs/molo/ucf.yaml")
    ap.add_argument("--dataset", default="hmdb",
                    choices=["hmdb", "ucf", "kinetics"],
                    help="synthetic-dataset layout; must match the "
                         "config's DATA.DATASET")
    ap.add_argument("--arch", default="ViT-B/16")
    ap.add_argument("--episodes", type=int, default=400)
    ap.add_argument("--lr", type=float, default=3e-4,
                    help="LR for training from random initialisation (the "
                         "shipped 1e-5 is a finetuning LR)")
    ap.add_argument("--tasks-per-batch", type=int, default=16)
    ap.add_argument("--val-freq", type=int, default=96)
    ap.add_argument("--val-eps", type=int, default=48)
    ap.add_argument("--final-eps", type=int, default=200)
    ap.add_argument("--root",
                    default=os.path.join(tempfile.gettempdir(), "conv_ds"))
    ap.add_argument("--classes", type=int, default=8,
                    help="train classes in the generated dataset (the test "
                         "classes take disjoint hues)")
    ap.add_argument("--lr-sch", type=int, default=0,
                    help="episode milestone of the MultiStep 0.1x LR decay "
                         "(0: no decay)")
    ap.add_argument("--videos", type=int, default=10,
                    help="videos per class in the generated dataset")
    ap.add_argument("--keep", action="store_true",
                    help="keep the checkpoint directory")
    ap.add_argument("--smoke", action="store_true",
                    help="plumbing check: test-tiny tower, 32x32 frames, a "
                         "handful of episodes (the device is --device's)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every CLI run (default cuda)")
    args = ap.parse_args(argv)
    args.img_size, args.seq_len = 224, 8
    if args.smoke:
        args.arch, args.img_size, args.seq_len = "test-tiny", 32, 4
        args.root = args.root + "_smoke"
        args.episodes = min(args.episodes, 16)
        args.tasks_per_batch, args.val_freq = 4, 8
        args.val_eps, args.final_eps = 4, 8
    return args


def dataset_kwargs(args) -> dict:
    """``make_dataset``'s arguments: 256x256 JPEGs, 12 frames a video (48
    and 6 under ``--smoke``)."""
    return dict(classes=args.classes, videos=args.videos,
                frames=6 if args.smoke else 12,
                size=48 if args.smoke else 256,
                img_size=args.img_size, seq_len=args.seq_len,
                dataset=args.dataset)


def load_make_dataset() -> Callable:
    """``make_dataset`` of ``scripts/make_synthetic_dataset.py``, loaded
    from its file (it imports numpy and PIL only)."""
    spec = importlib.util.spec_from_file_location("make_synthetic_dataset",
                                                  DATASET_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_dataset


def make_convergence_dataset(args) -> None:
    """Write the dataset under ``args.root`` unless its frames are there."""
    if not os.path.exists(os.path.join(args.root, FRAME_DIRS[args.dataset])):
        load_make_dataset()(args.root, **dataset_kwargs(args))


def checkpoint_dir(args) -> str:
    return os.path.join(args.root, f"ckpt_{args.arch.replace('/', '_')}")


def cli_args(args) -> List[str]:
    """The arguments every CLI run of the tool shares."""
    common = [
        "--cfg", args.cfg or os.path.join(
            REPO, f"configs/clipspm/{args.dataset}.yaml"),
        "--splits-root", args.root,
        "--allow-random-weights",   # no CLIP release weights are read
        "--device", args.device,
        f"MODEL.BACKBONE={args.arch}",
        f"DATA.DATA_DIR={args.root}",
        f"DATA.SEQ_LEN={args.seq_len}",
        f"DATA.IMG_SIZE={args.img_size}",
        f"CHECKPOINT.CHECKPOINT_DIR={checkpoint_dir(args)}",
        f"SOLVER.LR={args.lr}",
    ]
    if args.lr_sch:
        common.append(f"SOLVER.LR_SCH={args.lr_sch}")
    return common


def run_cli_subprocess(argv: List[str]) -> str:
    """The port's CLI in a fresh process; returns its standard output (the
    tail of it and of its errors is copied to standard error)."""
    p = subprocess.run([sys.executable, "-m", "clipspm_tpu_torch.cli.run"]
                       + argv, cwd=REPO, capture_output=True, text=True)
    sys.stderr.write(p.stdout[-4000:] + p.stderr[-2000:])
    if p.returncode != 0:
        raise RuntimeError(f"CLI exited {p.returncode}")
    return p.stdout


def run_cli_in_process(argv: List[str]) -> str:
    """The port's CLI in this process; returns what it printed (whose tail
    is copied to standard error)."""
    from clipspm_tpu_torch.cli.run import main as cli_main

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            cli_main(argv)
    finally:
        sys.stderr.write(buf.getvalue()[-4000:])
    return buf.getvalue()


def train(args, run_cli: Callable) -> dict:
    """Train with validations from a fresh checkpoint directory; returns
    the loss and validation curves and the wall seconds."""
    ckpt = checkpoint_dir(args)
    if os.path.isdir(ckpt):
        shutil.rmtree(ckpt)   # left by an earlier run of the tool
    t0 = time.perf_counter()
    out = run_cli(cli_args(args) + [
        f"TRAIN.TRAIN_EPISODES={args.episodes}",
        f"TRAIN.TASKS_PER_BATCH={args.tasks_per_batch}",
        f"TRAIN.VAL_FREQ={args.val_freq}",
        f"TRAIN.PRINT_FREQ={max(16, args.tasks_per_batch)}",
        f"TEST.TEST_EPISODES={args.val_eps}",
        "CHECKPOINT.SAVE_FREQ=0",
    ])
    wall = time.perf_counter() - t0
    return {"train_loss_curve": [(int(ep), float(loss)) for ep, loss in
                                 TRAIN_LOSS.findall(out)],
            "val_curve": [(int(ep), float(acc)) for ep, acc in
                          VAL_ACC.findall(out)],
            "train_wall_s": wall}


def restore(args, run_cli: Callable, cached: bool = False) -> tuple:
    """The test protocol over ``args.final_eps`` episodes from
    ``checkpoint_best``, uncached or through the feature cache; returns
    (accuracy, CI, wall seconds)."""
    t0 = time.perf_counter()
    out = run_cli(cli_args(args) + [
        "TEST.ONLY_TEST=true", f"TEST.CACHE_FEATURES={str(cached).lower()}",
        f"TEST.TEST_EPISODES={args.final_eps}"])
    wall = time.perf_counter() - t0
    m = TEST_ACC.search(out)
    if m is None:
        raise RuntimeError("the ONLY_TEST run printed no accuracy line")
    return float(m.group(1)), float(m.group(2)), wall


def convergence(args, run_cli: Optional[Callable] = None) -> dict:
    """Every step in turn, each CLI run through ``run_cli`` (default
    ``run_cli_subprocess``); returns the JSON line's object."""
    run_cli = run_cli or run_cli_subprocess
    make_convergence_dataset(args)
    trained = train(args, run_cli)
    final_acc, final_ci, final_wall = restore(args, run_cli)
    restore_acc, _, _ = restore(args, run_cli)
    cached_acc, _, cached_wall = restore(args, run_cli, cached=True)
    if not args.keep:
        shutil.rmtree(checkpoint_dir(args), ignore_errors=True)
    return {
        "arch": args.arch, "episodes": args.episodes, "lr": args.lr,
        "chance_pct": 20.0,
        "train_loss_curve": trained["train_loss_curve"],
        "val_curve": trained["val_curve"],
        "final_acc": final_acc, "final_ci": final_ci,
        "final_eval_episodes": args.final_eps,
        "restore_acc": restore_acc,
        "cached_eval_acc": cached_acc,
        "train_wall_s": round(trained["train_wall_s"], 1),
        "final_eval_wall_s": round(final_wall, 1),
        "cached_eval_wall_s": round(cached_wall, 1),
    }


def main(argv=None) -> dict:
    from clipspm_tpu_torch import resolve_device

    args = parse_args(argv)
    resolve_device(args.device)   # no GPU and no --device cpu: raise now
    result = convergence(args)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
