"""Config-driven entry point of the port.

Usage:
    python -m clipspm_tpu_torch.cli.run --cfg configs/clipspm/hmdb.yaml \
        [--device cuda|cpu] [KEY.PATH=value ...]

Same flags, overrides, log lines and checkpoint directory as
``clipspm_tpu/cli/run.py``, plus ``--device`` (default ``cuda``; with no GPU
visible the run raises rather than carrying on on the CPU). With
``TEST.ONLY_TEST=false`` it trains (``Conduct Training:``), validating
through the feature cache every ``TRAIN.VAL_FREQ`` episodes and saving
``checkpoint_best`` and ``checkpoint_iter_N``; with ``TEST.ONLY_TEST=true``
it restores ``TEST.TEST_MODEL_PATH`` or ``checkpoint_best`` (when present)
and runs the ``TEST.CACHE_FEATURES`` test protocol. What the port does not
carry yet (training a head other than clipspm, the uncached evaluator,
several GPUs) raises ``NotImplementedError`` naming its ROADMAP item before
anything is built.
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


def _refuse_what_is_not_carried(cfg) -> None:
    from clipspm_tpu_torch.train.setup import check_num_chips

    check_num_chips(cfg)
    cached = bool(cfg.TEST.get("CACHE_FEATURES", False))
    if cfg.TEST.ONLY_TEST:
        if not cached:
            raise _not_ported("the uncached evaluator", "uncached evaluator")
        return
    if cfg.MODEL.NAME != "clipspm":
        raise _not_ported(f"training {cfg.MODEL.NAME!r}",
                          f"{cfg.MODEL.NAME} training")
    val_freq = int(cfg.TRAIN.VAL_FREQ or 0)
    if not cached and val_freq and val_freq < int(cfg.TRAIN.TRAIN_EPISODES):
        raise _not_ported("validation through the uncached evaluator",
                          "uncached evaluator")


def main(argv=None) -> dict:
    """Trains, or runs the cached test protocol; returns the result dict
    (``Learner.run``'s, or the evaluator's)."""
    args = parse_args(argv)
    from clipspm_tpu_torch import resolve_device
    from clipspm_tpu_torch.train.checkpoint import payload_file
    from clipspm_tpu_torch.utils.config import load_config

    cfg = load_config(args.cfg_file, base_path=args.base_file,
                      opts=args.opts, splits_root=args.splits_root)
    _refuse_what_is_not_carried(cfg)
    test_model_path = str(cfg.TEST.get("TEST_MODEL_PATH", "") or "")
    if cfg.TEST.ONLY_TEST and test_model_path:
        # a set but unloadable path never falls through to 'best' or to the
        # untrained model
        if not os.path.exists(test_model_path):
            raise FileNotFoundError(
                f"TEST.TEST_MODEL_PATH={test_model_path!r} does not exist — "
                "can't test")
        payload_file(os.path.abspath(test_model_path))
    device = resolve_device(args.device)

    from clipspm_tpu_torch.train.checkpoint import CheckpointManager
    from clipspm_tpu_torch.train.feature_cache import (FeatureCachedEvaluator,
                                                       evaluate_cached)
    from clipspm_tpu_torch.train.setup import (build_catalog_and_sampler,
                                               build_learner)
    from clipspm_tpu_torch.utils.metrics import MetricsWriter

    ckpt_dir = str(cfg.CHECKPOINT.CHECKPOINT_DIR)
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "log.txt"), "a") as logfile:
        def log(msg: str):
            print(msg)
            logfile.write(f"{time.strftime('%m/%d/%Y %H:%M:%S')} {msg}\n")
            logfile.flush()

        log(f"Options: {cfg.dump()}")
        learner = build_learner(cfg, log_fn=log, device=device,
                                allow_random_weights=args.allow_random_weights)
        manager = CheckpointManager(ckpt_dir)
        restored = False
        if cfg.CHECKPOINT.get("RESUME_FROM_CHECKPOINT", False) \
                and manager.exists("best"):
            payload = manager.restore("best", learner)
            log(f"Resumed from episode {payload['meta']['iteration']}")
            restored = True
        # JSONL, and TensorBoard event files when tensorboard imports
        metrics = MetricsWriter(os.path.join(ckpt_dir, "metrics.jsonl"),
                                tb_dir=os.path.join(ckpt_dir, "tb"))
        try:
            catalog, sampler = build_catalog_and_sampler(
                cfg, "test", False, int(cfg.TEST.QUERY_PER_CLASS))
            if cfg.TEST.ONLY_TEST:
                log("Conduct Testing:")
                if test_model_path:
                    payload = manager.restore_path(test_model_path, learner)
                    log(f"Loaded checkpoint from {test_model_path} ==> "
                        f"iter: [{payload['meta']['iteration']}]")
                elif manager.exists("best"):
                    manager.restore("best", learner)
                    log(f"Loaded checkpoint_best from {ckpt_dir}")
                elif not restored:
                    # loud: an accuracy line from an untrained head looks
                    # like a real result otherwise
                    log(f"WARNING: no 'best' checkpoint under {ckpt_dir} — "
                        "evaluating the FRESH (untrained) model")
                res = evaluate_cached(cfg, learner, catalog=catalog,
                                      sampler=sampler, log_fn=log)
                log(f"{cfg.DATA.DATASET}: {res['accuracy']:.2f} "
                    f"+/- {res['confidence']:.2f} (loss {res['loss']:.4f})")
                metrics.scalars({
                    f"TEST/{cfg.DATA.DATASET}_acc": res["accuracy"],
                    f"TEST/{cfg.DATA.DATASET}_ci": res["confidence"]}, 0)
            else:
                log("Conduct Training:")
                # one evaluator for every validation: its seeded sampler
                # stream continues across vals, and each val re-encodes the
                # table at the current weights
                val = None
                if cfg.TEST.get("CACHE_FEATURES", False):
                    val = FeatureCachedEvaluator(
                        learner, catalog, sampler,
                        encode_videos_per_step=int(
                            cfg.TEST.get("CACHE_ENCODE_VIDEOS", 30) or 30),
                        eval_batch=int(cfg.TEST.get("CACHE_EVAL_BATCH", 64)
                                       or 64),
                        num_decode_workers=int(cfg.DATA.NUM_WORKERS),
                        log_fn=log)
                try:
                    res = learner.run(
                        checkpoint_fn=lambda ep, acc: manager.save(
                            learner, "best", best_acc=acc),
                        periodic_checkpoint_fn=lambda ep: manager.save(
                            learner, f"iter_{ep}"),
                        metrics=metrics,
                        val_fn=val.evaluate if val is not None else None)
                finally:
                    if val is not None:
                        val.close()
        finally:
            learner.close()
            metrics.close()
    return res


if __name__ == "__main__":
    main()
