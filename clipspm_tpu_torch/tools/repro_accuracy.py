"""Reproduce one cell of the reference's accuracy tables with the port.

Port of ``scripts/repro_accuracy.py``: given the OpenAI CLIP weights and a
dataset's frame dumps, it runs the published test protocol (10,000
episodes, 5-way, 1 query a class, 8 frames, 224x224 center crop, CI =
196*std/sqrt(n)) for one (backbone, dataset, shot) cell through the port's
CLI, on the GPU (``--device cuda``, the default; without a GPU it raises):

    python -m clipspm_tpu_torch.tools.repro_accuracy --dataset hmdb \\
        --backbone ViT-B/16 --shot 1 [--episodes 10000] [--data-root R]

What it needs (``check_assets`` lists what is missing, and the tool then
prints NOT READY with that list and exits 1):

1. CLIP weights: ``$CLIP_WEIGHTS_DIR`` (or ``~/.cache/clip``) holding the
   OpenAI release files ``RN50.pt`` and ``ViT-B-16.pt``, checked against
   their SHA-256 digests when loaded (``train/setup.py``);
2. the dataset root (``--data-root`` or ``$CLIPSPM_DATA_ROOT``): frame
   directories ``<root>/<ds>_256x256q5_l8/{train,test}/<class>/<vid>/*.jpg``
   and the split lists under ``<root>/splits/``;
3. the BPE vocabulary, read in place from ``clipspm_tpu/assets/``;
4. a trained head in ``CHECKPOINT.CHECKPOINT_DIR`` (``--checkpoint-dir``);
   without one the protocol measures the untrained head.

``--smoke`` replaces 1, 2 and 4 with the synthetic on-disk dataset
(``scripts/make_synthetic_dataset.py``, read in place) and random weights,
and runs the protocol's path end to end on ``--device``'s device (sizes
only change: add ``--device cpu`` on a host without a GPU).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the config of each dataset; every cell of the tables is one of these with
# a TRAIN.SHOT override
DATASET_CFG = {
    "hmdb": "configs/clipspm/hmdb.yaml",
    "ucf": "configs/clipspm/ucf.yaml",
    "kinetics": "configs/clipspm/k100.yaml",
    "ssv2": "configs/clipspm/ssv2_otam.yaml",       # SSv2-Full
    "ssv2_cmn": "configs/clipspm/ssv2_cmn.yaml",    # SSv2-Small
}

PUBLISHED = {  # (backbone, dataset, shot) -> % accuracy, the reference's
    ("RN50", "hmdb", 1): 77.4, ("RN50", "hmdb", 3): 82.6,
    ("RN50", "hmdb", 5): 84.5,
    ("RN50", "ucf", 1): 93.8, ("RN50", "ucf", 3): 97.2,
    ("RN50", "ucf", 5): 97.7,
    ("RN50", "kinetics", 1): 90.9, ("RN50", "kinetics", 3): 92.9,
    ("RN50", "kinetics", 5): 93.5,
    ("RN50", "ssv2", 1): 62.3, ("RN50", "ssv2", 3): 67.0,
    ("RN50", "ssv2", 5): 69.4,
    ("RN50", "ssv2_cmn", 1): 50.8, ("RN50", "ssv2_cmn", 3): 54.9,
    ("RN50", "ssv2_cmn", 5): 58.5,
    ("ViT-B/16", "hmdb", 1): 78.2, ("ViT-B/16", "hmdb", 3): 86.3,
    ("ViT-B/16", "hmdb", 5): 88.6,
    ("ViT-B/16", "ucf", 1): 96.2, ("ViT-B/16", "ucf", 3): 98.2,
    ("ViT-B/16", "ucf", 5): 98.7,
    ("ViT-B/16", "kinetics", 1): 92.8, ("ViT-B/16", "kinetics", 3): 94.1,
    ("ViT-B/16", "kinetics", 5): 94.3,
    ("ViT-B/16", "ssv2", 1): 66.7, ("ViT-B/16", "ssv2", 3): 74.8,
    ("ViT-B/16", "ssv2", 5): 77.3,
    ("ViT-B/16", "ssv2_cmn", 1): 57.8, ("ViT-B/16", "ssv2_cmn", 3): 62.4,
    ("ViT-B/16", "ssv2_cmn", 5): 66.2,
}


def check_assets(backbone: str, data_root: str, dataset: str) -> list:
    """What the run would miss: one line a missing asset."""
    from clipspm_tpu_torch.models.backbones.tokenizer import get_tokenizer
    from clipspm_tpu_torch.train.setup import find_clip_checkpoint
    from clipspm_tpu_torch.utils.config import DATASET_PATHS

    problems = []
    if find_clip_checkpoint(backbone) is None:
        problems.append(
            f"missing CLIP weights for {backbone} — set CLIP_WEIGHTS_DIR")
    if not get_tokenizer().using_openai_vocab:
        problems.append("BPE vocab asset missing (unexpected: it is bundled)")
    # the directories the run resolves (utils/config.py DATASET_PATHS), so
    # the check cannot pass while the run fails
    split_rel, frame_rel = DATASET_PATHS[dataset]
    frame_dir = os.path.join(data_root, frame_rel)
    if not os.path.isdir(frame_dir):
        problems.append(f"missing frame dir {frame_dir}")
    test_list = os.path.join(data_root, split_rel, "testlist03.txt")
    if not os.path.isfile(test_list):
        problems.append(f"missing split list {test_list}")
    return problems


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", choices=sorted(DATASET_CFG), default="hmdb")
    p.add_argument("--backbone", choices=["RN50", "ViT-B/16"],
                   default="ViT-B/16")
    p.add_argument("--shot", type=int, choices=[1, 3, 5], default=1)
    p.add_argument("--episodes", type=int, default=10000)
    p.add_argument("--data-root",
                   default=os.environ.get("CLIPSPM_DATA_ROOT", "/data"))
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--eval-batch", type=int, default=16,
                   help="episodes a step of the uncached evaluator "
                        "(TEST.EVAL_BATCH)")
    p.add_argument("--smoke", action="store_true",
                   help="run the whole path on the synthetic dataset with "
                        "random weights (no real assets needed)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (default cuda)")
    args = p.parse_args(argv)

    from clipspm_tpu_torch import resolve_device
    from clipspm_tpu_torch.cli.run import main as run_main

    resolve_device(args.device)   # no GPU and no --device cpu: raise now
    if args.smoke:
        root = os.path.join(tempfile.gettempdir(), "repro_smoke_ds")
        if not os.path.isdir(root):
            subprocess.run([sys.executable,
                            os.path.join(REPO, "scripts",
                                         "make_synthetic_dataset.py"),
                            "--root", root], check=True)
        run_main(["--cfg", os.path.join(root, "tiny.yaml"),
                  "--splits-root", root, "--allow-random-weights",
                  "--device", args.device,
                  "TEST.ONLY_TEST=true", "TEST.TEST_EPISODES=10"])
        print("smoke repro path OK — supply real assets to reproduce "
              "published cells")
        return 0

    published = PUBLISHED.get((args.backbone, args.dataset, args.shot))
    problems = check_assets(args.backbone, args.data_root, args.dataset)
    if problems:
        print("NOT READY — missing assets:")
        for q in problems:
            print(f"  - {q}")
        print("\nSee the prerequisites checklist in this script's docstring.")
        return 1

    opts = [
        "--cfg", os.path.join(REPO, DATASET_CFG[args.dataset]),
        "--splits-root", args.data_root,
        "--device", args.device,
        f"MODEL.BACKBONE={args.backbone}",
        f"TRAIN.SHOT={args.shot}",
        "TEST.ONLY_TEST=true",
        f"TEST.TEST_EPISODES={args.episodes}",
        f"TEST.EVAL_BATCH={args.eval_batch}",
        f"DATA.DATA_DIR={args.data_root}",
    ]
    if args.checkpoint_dir:
        opts.append(f"CHECKPOINT.CHECKPOINT_DIR={args.checkpoint_dir}")
    print(f"reproducing cell: {args.backbone} / {args.dataset} / "
          f"{args.shot}-shot (published: {published})")
    run_main(opts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
