"""bf16 against int8 evaluation on one checkpoint: the check a user runs
before turning on ``MODEL.INT8_EVAL``.

Port of ``scripts/int8_ab.py``. ``MODEL.INT8_EVAL`` runs the ViT tower's
block projections through an int8 product in evaluation, which does not
reproduce the float model's outputs. Given a config and its
``checkpoint_best``, this tool evaluates the same seeded episodes with one
``Learner`` as configured (bf16 under ``USE_AMP``) and one built from the
same state with ``MODEL.INT8_EVAL=true``, and prints the accuracy delta,
the per-query argmax agreement and the logit differences over the first 16
episodes. Runs on the GPU (``--device cuda``, the default; without a GPU
it raises):

    python -m clipspm_tpu_torch.tools.int8_ab \\
        --cfg configs/clipspm/hmdb.yaml [--episodes 200] [--eval-batch 16] \\
        [--splits-root R] [overrides...]
    python -m clipspm_tpu_torch.tools.int8_ab --smoke [--device cpu]

``--smoke`` takes the synthetic on-disk dataset
(``scripts/make_synthetic_dataset.py``, read in place), the test-tiny
tower and random weights: a check of the path, whose deltas decide
nothing; it changes sizes only, never the device.

Prints one JSON line: ``acc_bf16``, ``ci_bf16``, ``acc_int8``,
``ci_int8``, ``acc_delta``, ``argmax_agreement_pct``,
``mean_abs_logit_delta``, ``max_abs_logit_delta``, ``episodes``,
``restored_checkpoint``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# episodes whose logits are compared one by one
LOGIT_EPISODES = 16


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", default=os.path.join(
        REPO, "configs/clipspm/hmdb.yaml"))
    ap.add_argument("--splits-root", default=None)
    ap.add_argument("--episodes", type=int, default=200)
    ap.add_argument("--eval-batch", type=int, default=16)
    ap.add_argument("--allow-random-weights", action="store_true",
                    help="permit a random-init tower (e.g. a checkpoint "
                         "trained from scratch without the CLIP release "
                         "weights)")
    ap.add_argument("--smoke", action="store_true",
                    help="synthetic on-disk dataset and random weights "
                         "(a check of the path; its deltas decide "
                         "nothing)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of both learners (default cuda)")
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    return ap.parse_args(argv)


def smoke_setup() -> tuple:
    """Writes (once) the smoke dataset; returns its splits root and the
    overrides that point the config at it."""
    from clipspm_tpu_torch.tools.train_convergence import load_make_dataset

    root = os.path.join(tempfile.gettempdir(), "int8_ab_smoke")
    if not os.path.exists(os.path.join(root, "hmdb_256x256q5_l8")):
        load_make_dataset()(root, classes=8, videos=8, frames=6, size=48,
                            img_size=32, seq_len=4)
    return root, [f"DATA.DATA_DIR={root}", "DATA.SEQ_LEN=4",
                  "DATA.IMG_SIZE=32", "MODEL.BACKBONE=test-tiny",
                  "TRAIN.WAY=3", "TRAIN.SHOT=2",
                  f"CHECKPOINT.CHECKPOINT_DIR={root}/ckpt"]


def episode_logits(learner, ep, way: int):
    """``[queries, way]`` fp32 logits of one host episode, in eval mode."""
    import numpy as np
    import torch

    batch = learner._ready(*learner._to_device([ep]))
    learner.model.eval()
    with torch.no_grad():
        out = learner.episode_outputs(batch[0], train=False)
    return np.asarray(out["logits"].float().cpu()).reshape(-1, way)


def main(argv=None) -> dict:
    args = parse_args(argv)
    import numpy as np

    from clipspm_tpu_torch import resolve_device
    from clipspm_tpu_torch.models.fsar import build_model
    from clipspm_tpu_torch.train.checkpoint import CheckpointManager
    from clipspm_tpu_torch.train.learner import Learner
    from clipspm_tpu_torch.train.setup import build_learner
    from clipspm_tpu_torch.utils.config import load_config

    device = resolve_device(args.device)
    opts = list(args.opts)
    splits_root = args.splits_root
    if args.smoke:
        splits_root, smoke_opts = smoke_setup()
        opts += smoke_opts
        args.episodes = min(args.episodes, 12)
        args.eval_batch = 4

    cfg = load_config(args.cfg, opts=opts, splits_root=splits_root)
    # the float learner: data, weights, the checkpoint, the text tables
    learner = build_learner(
        cfg, log_fn=lambda m: print(m, file=sys.stderr), device=device,
        allow_random_weights=args.smoke or args.allow_random_weights)
    try:
        manager = CheckpointManager(str(cfg.CHECKPOINT.CHECKPOINT_DIR))
        restored = manager.exists("best")
        if restored:
            manager.restore("best", learner)
        elif not args.smoke:
            print("WARNING: no checkpoint_best found — A/B runs on the "
                  "UNTRAINED head (the tower's weights still matter where "
                  "CLIP weights were found)", file=sys.stderr)

        # the int8 twin: the same model class with the flag on, the same
        # state (the int8 projections keep the float weights)
        cfg_q = load_config(args.cfg, opts=opts + ["MODEL.INT8_EVAL=true"],
                            splits_root=splits_root)
        q_model = build_model(cfg_q)
        q_model.load_state_dict(learner.model.state_dict())
        q_learner = Learner(cfg_q, q_model, learner.text_train,
                            learner.text_test, device,
                            log_fn=learner.log)

        # the same episodes through both
        it = iter(learner.test_source)
        eps = [next(it) for _ in range(args.episodes)]
    finally:
        learner.close()
    rf = learner.evaluate(args.episodes, source=iter(eps),
                          batch_size=args.eval_batch)
    rq = q_learner.evaluate(args.episodes, source=iter(eps),
                            batch_size=args.eval_batch)

    way = int(cfg.TRAIN.WAY)
    agree, deltas = [], []
    for ep in eps[:min(LOGIT_EPISODES, args.episodes)]:
        lf = episode_logits(learner, ep, way)
        lq = episode_logits(q_learner, ep, way)
        agree.append(float((lf.argmax(-1) == lq.argmax(-1)).mean()))
        deltas.append(np.abs(lf - lq).ravel())
    deltas = np.concatenate(deltas)

    result = {
        "acc_bf16": round(rf["accuracy"], 2),
        "ci_bf16": round(rf["confidence"], 2),
        "acc_int8": round(rq["accuracy"], 2),
        "ci_int8": round(rq["confidence"], 2),
        "acc_delta": round(rq["accuracy"] - rf["accuracy"], 2),
        "argmax_agreement_pct": round(100.0 * float(np.mean(agree)), 2),
        "mean_abs_logit_delta": round(float(deltas.mean()), 5),
        "max_abs_logit_delta": round(float(deltas.max()), 5),
        "episodes": args.episodes,
        "restored_checkpoint": restored,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
