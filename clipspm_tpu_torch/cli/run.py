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
validating every ``TRAIN.VAL_FREQ`` episodes (through the feature cache
with ``TEST.CACHE_FEATURES``, else uncached at ``TEST.EVAL_BATCH`` episodes
a step) and saving ``checkpoint_best`` and ``checkpoint_iter_N``; with
``TEST.ONLY_TEST=true`` it restores ``TEST.TEST_MODEL_PATH`` or
``checkpoint_best`` (when present) and runs the test protocol, through the
feature cache with ``TEST.CACHE_FEATURES``, else uncached. A model the cache
cannot serve falls back to the uncached evaluator with a warning line. It
trains and tests the ported heads: clipspm, clipfsar, sten and cpm2c (RN50
and ViT towers) and ta2n. What the port does not carry yet (the other heads,
several GPUs, the remat policies ``attn`` and ``mlp``) raises
``NotImplementedError`` naming its ROADMAP item before anything is built.
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


def _refuse_what_is_not_carried(cfg) -> None:
    from clipspm_tpu_torch.models.fsar import check_model_config
    from clipspm_tpu_torch.train.learner import accum_dtype
    from clipspm_tpu_torch.train.setup import check_num_chips

    check_num_chips(cfg)
    check_model_config(cfg)
    accum_dtype(cfg)


def _cached_evaluator(cfg, learner, catalog, sampler, log, what: str):
    """The feature-cached evaluator, or None after a warning line when the
    model or the protocol cannot use it (its ``ValueError``)."""
    from clipspm_tpu_torch.train.feature_cache import cached_evaluator

    try:
        return cached_evaluator(cfg, learner, catalog, sampler, log_fn=log)
    except ValueError as e:
        log(f"WARNING: TEST.CACHE_FEATURES ignored{what} — {e}")
        return None


def main(argv=None) -> dict:
    """Trains, or runs the test protocol; returns the result dict
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
        eval_batch = max(1, int(cfg.TEST.get("EVAL_BATCH", 1) or 1))
        cached = bool(cfg.TEST.get("CACHE_FEATURES", False))
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
                ev = (_cached_evaluator(cfg, learner, catalog, sampler, log,
                                        "") if cached else None)
                if ev is not None:
                    # the test loader's prefetch goes unused
                    learner.test_source.close()
                    try:
                        res = ev.evaluate(int(cfg.TEST.TEST_EPISODES))
                    finally:
                        ev.close()
                else:
                    res = learner.evaluate(int(cfg.TEST.TEST_EPISODES),
                                           batch_size=eval_batch)
                log(f"{cfg.DATA.DATASET}: {res['accuracy']:.2f} "
                    f"+/- {res['confidence']:.2f} (loss {res['loss']:.4f})")
                metrics.scalars({
                    f"TEST/{cfg.DATA.DATASET}_acc": res["accuracy"],
                    f"TEST/{cfg.DATA.DATASET}_ci": res["confidence"]}, 0)
            else:
                log("Conduct Training:")
                # one evaluator for every validation: its seeded sampler
                # stream continues across vals, and each val re-encodes the
                # table at the current weights; without one, validation
                # runs uncached over the test loader
                val = (_cached_evaluator(cfg, learner, catalog, sampler, log,
                                         " for training validations")
                       if cached else None)
                if val is not None:
                    # the test loader's workers would idle for the whole run
                    learner.test_source.close()
                try:
                    res = learner.run(
                        checkpoint_fn=lambda ep, acc: manager.save(
                            learner, "best", best_acc=acc),
                        periodic_checkpoint_fn=lambda ep: manager.save(
                            learner, f"iter_{ep}"),
                        metrics=metrics, eval_batch_size=eval_batch,
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
