"""Config-driven entry point of the port.

Usage:
    python -m clipspm_tpu_torch.cli.run --cfg configs/clipspm/hmdb.yaml \
        TEST.ONLY_TEST=true [--device cuda|cpu] [KEY.PATH=value ...]

Same flags, overrides and log lines as ``clipspm_tpu/cli/run.py``, plus
``--device`` (default ``cuda``; with no GPU visible the run raises rather
than carrying on on the CPU). This slice carries the ``TEST.ONLY_TEST`` +
``TEST.CACHE_FEATURES`` route; training, the uncached evaluator and
checkpoint restore raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="clipspm_tpu_torch runner")
    p.add_argument("--cfg", dest="cfg_file", required=True,
                   help="path to the model/dataset YAML")
    p.add_argument("--base", dest="base_file", default=None,
                   help="path to base.yaml (defaults to configs/base.yaml)")
    p.add_argument("--splits-root", default=None,
                   help="directory containing the splits/ tree")
    p.add_argument("--allow-random-weights", action="store_true",
                   help="permit CLIP-head runs without pretrained weights / "
                        "the OpenAI BPE vocab (results are meaningless for "
                        "accuracy comparison)")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda)")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="KEY.PATH=value overrides")
    return p.parse_args(argv)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to clipspm_tpu_torch yet (ROADMAP.md, open "
        f"item '{item}'); run it with clipspm_tpu")


def main(argv=None) -> dict:
    """Runs the cached test protocol; returns its result dict."""
    args = parse_args(argv)
    from clipspm_tpu_torch import resolve_device
    from clipspm_tpu_torch.utils.config import load_config

    cfg = load_config(args.cfg_file, base_path=args.base_file,
                      opts=args.opts, splits_root=args.splits_root)
    if not cfg.TEST.ONLY_TEST:
        raise _not_ported("training", "training")
    test_model_path = str(cfg.TEST.get("TEST_MODEL_PATH", "") or "")
    if test_model_path:
        if not os.path.exists(test_model_path):
            raise FileNotFoundError(
                f"TEST.TEST_MODEL_PATH={test_model_path!r} does not exist — "
                "can't test")
        raise _not_ported("TEST.TEST_MODEL_PATH", "checkpoints")
    ckpt_dir = str(cfg.CHECKPOINT.CHECKPOINT_DIR)
    if cfg.CHECKPOINT.get("RESUME_FROM_CHECKPOINT", False) or \
            os.path.exists(os.path.join(ckpt_dir, "checkpoint_best")):
        raise _not_ported("checkpoint restore", "checkpoints")
    if not cfg.TEST.get("CACHE_FEATURES", False):
        raise _not_ported("the uncached evaluator", "uncached evaluator")
    device = resolve_device(args.device)

    from clipspm_tpu_torch.train.feature_cache import evaluate_cached
    from clipspm_tpu_torch.train.setup import (build_catalog_and_sampler,
                                               build_learner)

    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "log.txt"), "a") as logfile:
        def log(msg: str):
            print(msg)
            logfile.write(f"{time.strftime('%m/%d/%Y %H:%M:%S')} {msg}\n")
            logfile.flush()

        log(f"Options: {cfg.dump()}")
        learner = build_learner(cfg, log_fn=log, device=device,
                                allow_random_weights=args.allow_random_weights)
        log("Conduct Testing:")
        # loud, not silent: an accuracy line from an untrained head looks
        # like a real result otherwise
        log(f"WARNING: no 'best' checkpoint under {ckpt_dir} — evaluating "
            "the FRESH (untrained) model")
        catalog, sampler = build_catalog_and_sampler(
            cfg, "test", False, int(cfg.TEST.QUERY_PER_CLASS))
        res = evaluate_cached(cfg, learner, catalog=catalog, sampler=sampler,
                              log_fn=log)
        log(f"{cfg.DATA.DATASET}: {res['accuracy']:.2f} "
            f"+/- {res['confidence']:.2f} (loss {res['loss']:.4f})")
    return res


if __name__ == "__main__":
    main()
