"""Config-driven entry point of the port.

Usage:
    python -m clipspm_tpu_torch.cli.run --cfg configs/clipspm/hmdb.yaml \
        [--device cuda|cpu] [KEY.PATH=value ...]

Same flags, overrides, log lines and checkpoint directory as
``clipspm_tpu/cli/run.py``, plus ``--device`` (default ``cuda``; with no GPU
visible the run raises rather than carrying on on the CPU).

- ``TEST.ONLY_TEST=false`` trains (``Conduct Training:``), validating every
  ``TRAIN.VAL_FREQ`` episodes and saving ``checkpoint_best`` and
  ``checkpoint_iter_N``.
- ``TEST.ONLY_TEST=true`` restores ``TEST.TEST_MODEL_PATH``, or
  ``checkpoint_best`` when present, and runs the test protocol.

Both evaluate through the feature cache with ``TEST.CACHE_FEATURES``, else
uncached at ``TEST.EVAL_BATCH`` episodes a step; a model the cache cannot
serve (soap and molo, which need each episode's pixels) falls back to the
uncached evaluator with a warning line. It builds all ten heads of
``configs/``: clipspm, clipfsar, sten and cpm2c (RN50 and ViT towers), and
ta2n, otam, trx, strm, soap and molo (torchvision ResNet trunk), with the
CLIP towers' switches ``MODEL.FAST_SOFTMAX``, ``MODEL.BF16_NORMS`` and
``MODEL.INT8_EVAL`` and every ``MODEL.TRAIN_REMAT_POLICY`` of the JAX
package.

``DEVICE.NUM_CHIPS=N`` and ``DEVICE.TP=T`` run a grid of N x T ranks,
global rank ``g`` on ``cuda:g`` (or on the CPU with ``--device cpu``) at
``(dp, tp) = (g // T, g % T)``: the CLI checks the config, then starts them
(``torch.multiprocessing`` on a free local port), or joins the group of a
``torchrun`` that started N x T ranks; each dp index trains and evaluates
its share of the episodes (``parallel/mesh.py``), its T ranks through the
tower sharded over them (``parallel/tensor.py``), rank 0 alone prints and
writes, and a rank that raises ends the run with its error. What the JAX
package refuses raises its ``ValueError`` before anything is built.
"""

from __future__ import annotations

import argparse
import contextlib
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


def _refuse_what_is_not_carried(cfg, device=None) -> None:
    from clipspm_tpu_torch.models.fsar import check_model_config
    from clipspm_tpu_torch.train.learner import accum_dtype
    from clipspm_tpu_torch.train.setup import check_num_chips

    check_num_chips(cfg, device)
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
    (``Learner.run``'s, or the evaluator's; rank 0's over ranks)."""
    args = parse_args(argv)
    from clipspm_tpu_torch import resolve_device
    from clipspm_tpu_torch.parallel import mesh as pmesh
    from clipspm_tpu_torch.train.checkpoint import payload_file
    from clipspm_tpu_torch.train.setup import num_chips, num_tp

    cfg = _load(args)
    device = resolve_device(args.device)
    _refuse_what_is_not_carried(cfg, device)
    test_model_path = str(cfg.TEST.get("TEST_MODEL_PATH", "") or "")
    if cfg.TEST.ONLY_TEST and test_model_path:
        # a set but unloadable path never falls through to 'best' or to the
        # untrained model
        if not os.path.exists(test_model_path):
            raise FileNotFoundError(
                f"TEST.TEST_MODEL_PATH={test_model_path!r} does not exist — "
                "can't test")
        payload_file(os.path.abspath(test_model_path))
    tp = num_tp(cfg)
    world = num_chips(cfg) * tp
    if world == 1:
        return _run(args, cfg, device)
    if pmesh.torchrun_env():
        mesh = pmesh.join_torchrun(device, world, tp)
        try:
            return _run(args, cfg, mesh.device, mesh)
        finally:
            pmesh.close()
    # the ranks parse the same arguments (a config does not pickle)
    return pmesh.spawn(_rank, world, device, args=(argv,), tp=tp)


def _load(args):
    from clipspm_tpu_torch.utils.config import load_config

    return load_config(args.cfg_file, base_path=args.base_file,
                       opts=args.opts, splits_root=args.splits_root)


def _rank(mesh, argv) -> dict:
    args = parse_args(argv)
    return _run(args, _load(args), mesh.device, mesh)


def _run(args, cfg, device, mesh=None) -> dict:
    """One process's run: the whole of it, or rank ``mesh.rank``'s share
    (only rank 0 prints, writes ``log.txt`` and ``metrics.jsonl`` and
    saves checkpoints)."""
    from clipspm_tpu_torch.train.checkpoint import CheckpointManager
    from clipspm_tpu_torch.train.setup import (build_catalog_and_sampler,
                                               build_learner)
    from clipspm_tpu_torch.utils.metrics import MetricsWriter

    main_rank = mesh is None or mesh.is_main
    test_model_path = str(cfg.TEST.get("TEST_MODEL_PATH", "") or "")
    ckpt_dir = str(cfg.CHECKPOINT.CHECKPOINT_DIR)
    os.makedirs(ckpt_dir, exist_ok=True)
    with contextlib.ExitStack() as stack:
        if main_rank:
            logfile = stack.enter_context(
                open(os.path.join(ckpt_dir, "log.txt"), "a"))

            def log(msg: str):
                print(msg)
                logfile.write(f"{time.strftime('%m/%d/%Y %H:%M:%S')} "
                              f"{msg}\n")
                logfile.flush()
        else:
            def log(msg: str):
                pass

        log(f"Options: {cfg.dump()}")
        learner = build_learner(cfg, log_fn=log, device=device, mesh=mesh,
                                allow_random_weights=args.allow_random_weights)
        manager = CheckpointManager(ckpt_dir, mesh)
        restored = False
        if cfg.CHECKPOINT.get("RESUME_FROM_CHECKPOINT", False) \
                and manager.exists("best"):
            payload = manager.restore("best", learner)
            log(f"Resumed from episode {payload['meta']['iteration']}")
            restored = True
        # JSONL, and TensorBoard event files when tensorboard imports
        metrics = (MetricsWriter(os.path.join(ckpt_dir, "metrics.jsonl"),
                                 tb_dir=os.path.join(ckpt_dir, "tb"))
                   if main_rank else None)
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
                if metrics is not None:
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
            if metrics is not None:
                metrics.close()
    return res




if __name__ == "__main__":
    main()
