"""The trainer and the uncached evaluator: a built model, its optimizer,
the episodic train loop and the test protocol.

Port of ``clipspm_tpu/train/learner.py`` (``TrainState``,
``_train_step_impl``, ``train_episodes``, ``evaluate``, ``run``). One
optimizer step takes ``TASKS_PER_BATCH`` episodes: each real episode runs its
forward and backward with the same weights and the gradients sum in
``.grad`` (the JAX package sums them in a ``lax.scan``); then one optimizer
step. A padding episode (past ``n_valid``) runs no forward at all, which is
what the JAX step's zero weight does to its gradient, BatchNorm statistics,
metrics and episode count.

``parallel_episodes=M`` (the JAX argument; ``DEVICE.NUM_CHIPS`` dp indices
run ``M = N``) splits a step into microsteps of M episodes, as the JAX
step's ``[E//M, M]`` reshape does: the M episodes of a microstep run from
the same incoming BatchNorm statistics, which then become the mean of their
M updated ones (an all-padding microstep is not run, so it keeps them). In
one process the M episodes run one after another (the plain version of the
multi-rank step); over an ``EpisodeMesh`` dp index ``d`` runs episode
``j*M + d`` of microstep ``j``, the statistics' mean is one all-reduce a
microstep and the gradients' sum one all-reduce a step, over the dp group.
With ``SOLVER.ACCUM_DTYPE: bfloat16`` each microstep's gradient (the fp32
sum of its M episodes' gradients; over ranks one fp32 all-reduce a
microstep) is rounded to bf16 and added into a bf16 sum, cast to fp32 for
the step: the JAX rule at every ``NUM_CHIPS``.

At ``DEVICE.TP`` above 1 the model's tower is sharded over the tp ranks of
a dp index (``parallel/tensor.py``), which run the same episodes; the
optimizer holds the shards, and :meth:`state_dict` and
:meth:`load_state_dict` the canonical unsharded layout, so a checkpoint is
the ``TP=1`` payload key for key. The gradients are summed over the dp
group alone: the backward's all-reduce over the tp group (Megatron's *f*)
hands every tp rank the same bits, so the replicated parameters' gradients
are the same sum on every tp rank. On the CPU they come out bit-identical;
on a GPU a backward kernel that adds with atomics rounds them apart (to
5.2e-6 relative in ViT-B/16's head on an H100), so at the end of each step
the replicated gradients and the BatchNorm buffers take tp rank 0's (one
broadcast over the tp group) and the replicas stay bit-identical.

Frames are transformed on the device, drawn from the learner's
``torch.Generator``; dropout draws from the device's default generator.
Both are seeded before each training episode from ``MODEL.SEED`` and the
episode's global index alone, so an episode draws the same crops, flips and
dropout masks at every ``NUM_CHIPS``, and a restored episode count restores
the streams. ``evaluate`` runs ``batch_size`` episodes a step from the test
stream, one after another as the JAX package's ``lax.map`` does (over
ranks, each its share, gathered in stream order); ``run`` validates through
it unless it is given a ``val_fn`` (the feature cache).
"""

from __future__ import annotations

import concurrent.futures as _cf
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..data.episode import Episode, stack_episodes, to_device
from ..data.transforms import TransformSpec, episode_device_transform
from ..parallel.mesh import EpisodeMesh, episode_mean_, flat_buffers
from ..parallel.tensor import (full_optimizer_state, full_shape,
                               full_state_dict, load_full_state_dict,
                               shard_model_, shard_optimizer_state)
from ..utils.metrics import recording, span, timed
from .losses import loss_and_acc
from .optim import make_optimizer


def accum_dtype(cfg) -> Optional[torch.dtype]:
    """``SOLVER.ACCUM_DTYPE``: None for fp32 (the default), ``bfloat16``
    for a bf16 sum of the episodes' gradients; any other value raises."""
    accum = str(cfg.get("SOLVER", {}).get("ACCUM_DTYPE", "float32")
                or "float32")
    if accum not in ("float32", "bfloat16"):
        raise ValueError(f"SOLVER.ACCUM_DTYPE must be float32 or "
                         f"bfloat16, got {accum!r}")
    return torch.bfloat16 if accum == "bfloat16" else None


def episode_seed(seed: int, episode: int) -> int:
    """The generator seed of training episode ``episode`` (its global
    index) under ``MODEL.SEED``."""
    return int(np.random.SeedSequence([seed, episode]).generate_state(1)[0])


def batch_stats(model: nn.Module) -> List[torch.Tensor]:
    """The BatchNorm buffers a train-mode forward updates (the JAX
    ``batch_stats`` collection, plus torch's batch counters)."""
    return [b for m in model.modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm)
            and m.track_running_stats
            for b in (m.running_mean, m.running_var, m.num_batches_tracked)]


class Learner:
    """Config-driven trainer and evaluator over episode streams, and the
    feature cache's view of the model (``train/feature_cache.py``)."""

    def __init__(self, cfg, model: nn.Module, text_train: torch.Tensor,
                 text_test: torch.Tensor, device: torch.device,
                 transform: Optional[TransformSpec] = None,
                 build_seconds: Optional[Dict[str, float]] = None,
                 train_source=None, test_source=None,
                 log_fn: Callable[[str], None] = print,
                 mesh: Optional[EpisodeMesh] = None,
                 parallel_episodes: Optional[int] = None):
        if parallel_episodes is None:
            parallel_episodes = mesh.dp_world if mesh is not None else 1
        if parallel_episodes < 1 or (mesh is not None
                                     and parallel_episodes != mesh.dp_world):
            raise ValueError(
                f"parallel_episodes={parallel_episodes}: one episode a dp "
                f"index per microstep needs "
                f"{mesh.dp_world if mesh else '>= 1'}")
        self.mesh = mesh
        self.parallel_episodes = int(parallel_episodes)
        self.cfg = cfg
        self.accum_dtype = accum_dtype(cfg)
        self.model_name = cfg.MODEL.NAME
        self.tasks_per_batch = int(cfg.TRAIN.TASKS_PER_BATCH)
        self.device = device
        self.model = model.to(device).eval()
        self.text_train = text_train.to(device)
        self.text_test = text_test.to(device)
        self.transform = transform or TransformSpec.from_config(cfg)
        # wall seconds of each build stage (model init, text tables, ...)
        self.build_seconds = dict(build_seconds or {})
        self.train_source = train_source
        self.test_source = test_source
        self.log = log_fn
        if mesh is not None:
            # every rank starts from dp index 0's replica, as DDP does
            mesh.broadcast_([*self.model.state_dict().values(),
                             self.text_train, self.text_test])
        # the tp layout (empty at TP=1), before the optimizer is made over
        # the shards
        self.shards = (shard_model_(self.model, mesh)
                       if mesh is not None and mesh.tp > 1 else {})
        self.optimizer, self.scheduler = make_optimizer(
            cfg, self.model.parameters())
        self.episode = 0                       # episodes consumed
        self.seed = int(cfg.MODEL.SEED)
        self.gen = torch.Generator(device=device)
        self._copy_stream = (torch.cuda.Stream(device=device)
                             if device.type == "cuda" else None)

    # -- state ---------------------------------------------------------------

    def _seed_episode(self, episode: int) -> None:
        """Seed the transform generator and the device's dropout one for
        training episode ``episode`` (its global index)."""
        seed = episode_seed(self.seed, episode)
        self.gen.manual_seed(seed)
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                torch.cuda.manual_seed(seed)
        else:
            torch.manual_seed(seed)

    def _param_names(self) -> List[str]:
        """The parameter names in the optimizer's order."""
        return [n for n, _ in self.model.named_parameters()]

    def state_dict(self) -> dict:
        """The canonical (``TP=1``) state: over tp ranks every rank of a
        dp index must call it (it gathers the shards)."""
        model = full_state_dict(self.model, self.shards, self.mesh)
        optim = full_optimizer_state(self.optimizer.state_dict(),
                                     self._param_names(), self.shards,
                                     self.mesh)
        return {"model": model, "optimizer": optim,
                "scheduler": self.scheduler.state_dict(),
                "episode": self.episode,
                "text_train": self.text_train, "text_test": self.text_test}

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict` (canonical, at any ``TP``; each tp
        rank takes its shards). A model tree that differs in keys or
        shapes raises before anything changes (``nn.Module.load_state_dict``
        would copy the matching tensors first). No generator state is
        restored, nor saved: the episode count seeds every later draw
        (generator states in a checkpoint of an earlier version, of any
        device, are ignored)."""
        tp = self.mesh.tp if self.mesh is not None else 1
        mine = {k: full_shape(v, self.shards.get(k), tp)
                for k, v in self.model.state_dict().items()}
        theirs = state["model"]
        bad = sorted(set(mine) ^ set(theirs)) + sorted(
            k for k in set(mine) & set(theirs)
            if mine[k] != tuple(theirs[k].shape))
        if bad:
            raise RuntimeError(f"model state differs in {len(bad)} keys or "
                               f"shapes, e.g. {bad[:3]}")
        load_full_state_dict(self.model, theirs, self.shards, self.mesh)
        self.optimizer.load_state_dict(shard_optimizer_state(
            state["optimizer"], self._param_names(), self.shards, self.mesh))
        self.scheduler.load_state_dict(state["scheduler"])
        self.episode = int(state["episode"])
        self.text_train = state["text_train"].to(self.device)
        self.text_test = state["text_test"].to(self.device)

    # -- steps ---------------------------------------------------------------

    def _to_device(self, episodes: Sequence[Episode]):
        """Stack host episodes and move them to the device: on a GPU through
        pinned memory on the learner's copy stream (the caller may be the
        staging thread); returns ``(batch, event)``, the event marking the
        copies' end (None on the CPU)."""
        host = stack_episodes(episodes)
        if self._copy_stream is None:
            return to_device(host, self.device), None
        with torch.cuda.stream(self._copy_stream):
            batch = to_device(host, self.device)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return batch, done

    def _ready(self, batch: Episode, done) -> Episode:
        """Order the compute stream after ``batch``'s copies; the tensors
        are marked as used there, so their memory outlives its reads."""
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            batch.map(lambda x: x.record_stream(stream))
        return batch

    def episode_outputs(self, ep: Episode, train: bool = True) -> dict:
        """The model's outputs over one device episode, its frames through
        the episode transform (random crops and flips in training)."""
        t = self.transform
        with span("learner.transform"):
            frames = [episode_device_transform(
                images, train=train, img_size=t.img_size,
                resize_to=t.resize_to, flip=t.flip, normalize=t.normalize,
                gen=self.gen)
                for images in (ep.support_images, ep.target_images)]
        return self.model(frames[0], frames[1], ep.support_labels,
                          ep.real_support_labels, ep.real_target_labels,
                          self.text_train, self.text_test)

    def _episode_loss(self, ep: Episode, train: bool = True):
        out = self.episode_outputs(ep, train)
        return loss_and_acc(self.model_name, out, ep.target_labels,
                            ep.real_support_labels, ep.real_target_labels,
                            self.tasks_per_batch, cfg=self.cfg, train=train)

    def _positions(self, n: int) -> range:
        """This process's episodes of a step of ``n``: all of them, or its
        dp index's shard."""
        return self.mesh.shard(n) if self.mesh is not None else range(n)

    def _local(self, episodes: Sequence[Optional[Episode]]) -> list:
        """This process's episodes of a step, in order. Over ranks the other
        ranks' places may hold None (a sharded ``EpisodeLoader`` yields
        so)."""
        mine = [episodes[p] for p in self._positions(len(episodes))]
        if any(ep is None for ep in mine):
            raise ValueError("a step's episode of this rank is missing: its "
                             "source did not shard the step as "
                             "dp_rank, dp_rank + dp_world, ...")
        return mine

    def _step(self, batch: Optional[Episode], n_valid: int
              ) -> Dict[str, torch.Tensor]:
        """One optimizer step over the first ``n_valid`` episodes of the
        step, of which ``batch`` holds this process's (the device batch of
        :meth:`_positions`); returns the metrics of all of them as device
        scalars (unfetched)."""
        if not self.model.training:
            self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        params = list(self.model.parameters())
        M = self.parallel_episodes
        stats = batch_stats(self.model) if M > 1 else []
        positions = list(self._positions(n_valid))
        acc_grads = None
        loss_sum = torch.zeros((), device=self.device)
        acc_sum = torch.zeros((), device=self.device)
        for j in range(-(-n_valid // M)):
            start = [b.clone() for b in stats]
            sums = None
            for k, p in enumerate(positions):
                if p // M != j:
                    continue
                # each of the microstep's episodes from its incoming stats
                for b, s0 in zip(stats, start):
                    b.copy_(s0)
                self._seed_episode(self.episode + p)
                with span("learner.forward"):
                    loss, acc = self._episode_loss(batch[k])
                # outside the model's autocast blocks: each op's backward
                # runs in the dtype its forward ran in (K1's replay in fp32)
                with span("learner.backward"):
                    loss.backward()
                loss_sum += loss.detach()
                acc_sum += acc
                if stats:
                    flat = flat_buffers(stats)
                    sums = flat if sums is None else sums + flat
            if stats:
                episode_mean_(stats, sums, min(M, n_valid - j * M),
                              self.mesh)
            if self.accum_dtype is not None:
                # the microstep's gradient: its M episodes' summed in fp32
                # (over the dp group, one all-reduce), then rounded into
                # the bf16 sum
                grads = [torch.zeros_like(p) if p.grad is None else p.grad
                         for p in params]
                if self.mesh is not None:
                    self.mesh.all_reduce_sum(grads)
                grads = [g.to(self.accum_dtype) for g in grads]
                acc_grads = grads if acc_grads is None else [
                    a + g for a, g in zip(acc_grads, grads)]
                self.optimizer.zero_grad(set_to_none=True)
        if acc_grads is not None:
            for p, g in zip(params, acc_grads):
                p.grad = g.to(p.dtype)
        for p in params:
            if p.grad is None:
                # the JAX chain decays every parameter, used or not
                p.grad = torch.zeros_like(p)
        metrics = torch.stack([loss_sum, acc_sum.to(loss_sum.dtype)])
        if self.mesh is not None:
            # the JAX step's sum over all E episodes (the bf16 sum has it)
            self.mesh.all_reduce_sum(
                [metrics] if acc_grads is not None
                else [p.grad for p in params] + [metrics])
        if self.mesh is not None and self.mesh.tp > 1:
            # the replicas take tp rank 0's rounding (see the module's
            # docstring)
            self.mesh.tp_broadcast_(
                [p.grad for n, p in zip(self._param_names(), params)
                 if self.shards[n] is None] + batch_stats(self.model))
        with span("learner.optimizer"):
            self.optimizer.step()
            self.scheduler.step()
        self.episode += n_valid
        denom = max(n_valid, 1)
        return {"loss": metrics[0] / denom, "acc": metrics[1] / denom}

    def train_episodes(self, episodes: Sequence[Optional[Episode]],
                       n_valid: Optional[int] = None) -> Dict[str, float]:
        """Consume a list of host episodes as one optimizer step. Only the
        first ``n_valid`` are real; the rest are padding, neither moved to
        the device nor run. Over ranks the list is the whole step, where
        each rank needs only its own episodes (``rank, rank + world, ...``;
        the others may be None). Returns loss and acc averaged over the
        real ones."""
        n = len(episodes) if n_valid is None else int(n_valid)
        with span("learner.step", call=True, episodes=n):
            local = self._local(episodes[:n])
            batch = None
            if local:
                with span("learner.stage") as sp:
                    batch = self._ready(*self._to_device(local))
                    sp.set(bytes=batch.nbytes)
            metrics = self._step(batch, n)
            with span("learner.fetch"):
                return {k: float(v) for k, v in metrics.items()}

    @torch.no_grad()
    def _eval_batch(self, batch: Episode, n: int) -> torch.Tensor:
        """``[n, 2]`` (loss, accuracy) of the first ``n`` episodes of a
        device batch, one episode after another (unfetched)."""
        rows = []
        for e in range(n):
            with span("learner.forward"):
                rows.append(torch.stack([x.float() for x in
                                         self._episode_loss(batch[e],
                                                            train=False)]))
        return torch.stack(rows)

    def evaluate(self, n_episodes: int, source=None,
                 batch_size: int = 1) -> Dict[str, float]:
        """The test protocol over ``n_episodes`` of ``source`` (the test
        stream by default, which continues across calls): the model in eval
        mode, the deterministic eval transform, ``batch_size`` episodes a
        step. A staging thread stacks and copies batch i+1 while the device
        runs batch i; the results of batch i are fetched after batch i+1
        has been issued. A trailing partial batch runs only its real
        episodes (the JAX package pads it with duplicates and trims their
        results). Over ranks ``batch_size`` is rounded up to a multiple of
        the dp ranks, as the JAX package rounds it to its ``dp`` width;
        each rank runs the episodes its source gave it (the others' places
        hold None) and every rank gathers all (loss, accuracy) pairs in
        stream order over the dp group. Returns mean accuracy (%), its
        ``196*std/sqrt(n)`` CI, mean loss, the per-episode ``loss_acc``
        ``[n, 2]``, and the wall and host-stall seconds (the loop's waits
        on the staging thread, its ``eval.wait`` spans)."""
        with span("learner.evaluate", call=True, episodes=n_episodes):
            return self._evaluate(n_episodes, source, batch_size)

    def _evaluate(self, n_episodes: int, source, batch_size: int
                  ) -> Dict[str, float]:
        it = iter(source or self.test_source)
        batch_size = max(1, int(batch_size))
        world = self.mesh.dp_world if self.mesh is not None else 1
        batch_size += -batch_size % world
        self.model.eval()

        def stage(index, n):
            with span("eval.stage", batch=index) as sp:
                items = [next(it) for _ in range(n)]
                local = [i for i, ep in enumerate(items) if ep is not None]
                if world == 1 and len(local) < n:
                    raise ValueError("an episode of the test stream is None")
                if not local:
                    return (None, None), []
                staged = self._to_device([items[i] for i in local])
                sp.set(bytes=staged[0].nbytes)
                return staged, local

        rows: List[np.ndarray] = []        # (position, loss, acc) of mine
        stager = _cf.ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="clipspm-eval")
        pending = None

        def harvest(pending):
            m, positions = pending
            with span("eval.harvest"):
                m = m.cpu()
            rows.append(np.concatenate([
                np.asarray(positions, np.float64)[:, None],
                m.numpy().astype(np.float64)], axis=1))

        stall_s, t0 = 0.0, time.perf_counter()
        try:
            done, staged = 0, 0
            if n_episodes > 0:
                fut = stager.submit(stage, staged, min(batch_size,
                                                       n_episodes))
            while done < n_episodes:
                with timed("eval.wait") as wait:
                    (batch, ready), local = fut.result()
                stall_s += wait.seconds
                n = min(batch_size, n_episodes - done)
                if done + n < n_episodes:
                    staged += 1
                    fut = stager.submit(stage, staged, min(
                        batch_size, n_episodes - done - n))
                if local:
                    m = self._eval_batch(self._ready(batch, ready),
                                         len(local))
                    del batch
                    if pending is not None:
                        harvest(pending)
                    pending = (m, [done + i for i in local])
                done += n
            if pending is not None:
                harvest(pending)
        finally:
            stager.shutdown(wait=False, cancel_futures=True)
        mine = np.concatenate(rows) if rows else np.zeros((0, 3))
        loss_acc = self._gather_episodes(mine, n_episodes)
        seconds = time.perf_counter() - t0
        accs = loss_acc[:, 1]
        self.log(f"uncached eval: {n_episodes} episodes in batches of "
                 f"{batch_size} — {seconds:.1f}s "
                 f"({n_episodes / max(seconds, 1e-9):.2f} eps/s, host-stall "
                 f"{100.0 * stall_s / max(seconds, 1e-9):.0f}%)")
        return {
            "accuracy": float(accs.mean() * 100.0),
            "confidence": float(196.0 * accs.std() / np.sqrt(len(accs))),
            "loss": float(loss_acc[:, 0].mean()),
            "loss_acc": loss_acc,
            "seconds": seconds,
            "host_stall_seconds": stall_s,
        }

    def _gather_episodes(self, mine: np.ndarray, n: int) -> np.ndarray:
        """``[n, 2]`` float64 (loss, accuracy) of episodes ``0..n-1`` from
        this process's ``[k, 3]`` (position, loss, accuracy) rows, over
        ranks gathered from all of them."""
        if self.mesh is not None:
            k = -(-n // self.mesh.dp_world)
            if len(mine) > k:
                raise ValueError(f"{len(mine)} of {n} episodes on one rank")
            pad = np.full((k - len(mine), 3), -1.0)
            got = self.mesh.all_gather(torch.from_numpy(
                np.concatenate([mine, pad])).to(self.device)).cpu().numpy()
            mine = got[got[:, 0] >= 0]
        order = np.argsort(mine[:, 0], kind="stable")
        if not np.array_equal(mine[order, 0], np.arange(n)):
            raise RuntimeError(f"the ranks evaluated episodes "
                               f"{mine[order, 0].tolist()} of {n}")
        return mine[order, 1:]

    def close(self) -> None:
        for source in (self.train_source, self.test_source):
            if source is not None:
                source.close()

    # -- the train loop ------------------------------------------------------

    def run(self, train_episodes: Optional[int] = None,
            val_freq: Optional[int] = None,
            test_episodes: Optional[int] = None,
            print_freq: Optional[int] = None,
            checkpoint_fn: Optional[Callable[[int, float], None]] = None,
            periodic_checkpoint_fn: Optional[Callable[[int], None]] = None,
            metrics=None, eval_batch_size: int = 1,
            val_fn: Optional[Callable[[int], Dict[str, float]]] = None
            ) -> Dict[str, float]:
        """Train to ``TRAIN.TRAIN_EPISODES`` with windowed logs, validation
        every ``VAL_FREQ`` episodes through ``val_fn``, or, without one,
        :meth:`evaluate` at ``eval_batch_size`` (a new best calls
        ``checkpoint_fn``), and ``periodic_checkpoint_fn`` every
        ``SAVE_FREQ``.

        A staging thread stacks and copies batch i+1 while the device runs
        step i; the metrics of step i are fetched after step i+1 has been
        issued, except at print, val and checkpoint boundaries. The trailing
        partial batch holds the remaining real episodes; its padding (the
        JAX package pads with masked duplicates to keep its jit shape) is
        never staged or run. Over ranks every rank runs the loop and its
        share of each step and of each validation; the caller gives rank 0
        alone the log, ``metrics`` and the checkpoint writes (which every
        rank calls, ``train/checkpoint.py``), and only rank 0 profiles.
        """
        from ..utils.metrics import host_rss_gb, profile_trace

        cfg = self.cfg
        total = train_episodes or int(cfg.TRAIN.TRAIN_EPISODES)
        val_freq = val_freq or int(cfg.TRAIN.VAL_FREQ)
        test_eps = test_episodes or int(cfg.TEST.TEST_EPISODES)
        print_freq = print_freq or int(cfg.TRAIN.PRINT_FREQ)
        save_freq = int(cfg.get("CHECKPOINT", {}).get("SAVE_FREQ", 0) or 0)
        tpb = self.tasks_per_batch
        if val_fn is None:
            def val_fn(n):
                return self.evaluate(n, batch_size=eval_batch_size)

        it = iter(self.train_source)
        best_acc = 0.0
        window_loss: List[float] = []
        window_acc: List[float] = []
        episode = self.episode
        # a torch.profiler trace of one optimizer step with its spans, on
        # request
        profile_dir = os.environ.get("CLIPSPM_PROFILE_DIR")
        profiled = self.mesh is not None and not self.mesh.is_main
        self.model.train()

        def stage(n):
            local = self._local([next(it) for _ in range(n)])
            return (self._to_device(local) if local else (None, None)), n

        def harvest(pending):
            dm, ep = pending
            m = {k: float(v) for k, v in dm.items()}
            window_loss.append(m["loss"])
            window_acc.append(m["acc"])
            if metrics is not None:
                metrics.scalars({"loss/Train_loss[it]": m["loss"],
                                 "acc/Train_acc[it]": m["acc"]}, ep)

        stager = _cf.ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="clipspm-stage")
        pending = None
        # seconds the loop waits on staging, against the window's wall
        stall_s, window_t0 = 0.0, time.perf_counter()
        try:
            fut = stager.submit(stage, min(tpb, total - episode))
            while episode < total:
                with timed("learner.wait") as wait:
                    (batch, done), n = fut.result()
                stall_s += wait.seconds
                nxt = episode + n
                if nxt < total:
                    fut = stager.submit(stage, min(tpb, total - nxt))
                if batch is not None:
                    batch = self._ready(batch, done)
                if profile_dir and not profiled and episode > 0:
                    with recording(), profile_trace(profile_dir):
                        dm = {k: float(v)
                              for k, v in self._step(batch, n).items()}
                    profiled = True
                    self.log(f"profiler trace written to {profile_dir}")
                else:
                    dm = self._step(batch, n)
                del batch
                episode = nxt
                if pending is not None:
                    harvest(pending)
                pending = (dm, episode)

                at_print = episode % print_freq < tpb
                at_save = bool(save_freq and periodic_checkpoint_fn
                               and episode % save_freq < tpb
                               and episode < total)
                at_val = bool(val_freq and episode % val_freq < tpb
                              and episode < total)
                if at_print or at_save or at_val or episode >= total:
                    harvest(pending)
                    pending = None

                if at_print:
                    rss = host_rss_gb()
                    wall = time.perf_counter() - window_t0
                    stall_pct = 100.0 * stall_s / max(wall, 1e-9)
                    self.log(f"Task [{episode}/{total}], Train Loss: "
                             f"{np.mean(window_loss):.7f}, Train Accuracy: "
                             f"{np.mean(window_acc):.7f}, RSS: {rss:.1f}G, "
                             f"{wall / max(len(window_loss), 1) / tpb:.3f}"
                             f"s/ep (host-stall {stall_pct:.0f}%)")
                    if metrics is not None:
                        metrics.scalars(
                            {"loss/Train_loss[mean]":
                                 float(np.mean(window_loss)),
                             "acc/Train_acc[mean]":
                                 float(np.mean(window_acc)),
                             "sys/host_rss_gb": rss,
                             "sys/host_stall_pct": stall_pct},
                            episode // print_freq)
                    window_loss, window_acc = [], []
                    stall_s, window_t0 = 0.0, time.perf_counter()

                if at_save:
                    periodic_checkpoint_fn(episode)

                if at_val:
                    res = val_fn(test_eps)
                    self.model.train()     # the evaluator set eval mode
                    self.log(f"Val @ {episode}: acc {res['accuracy']:.2f} "
                             f"+/- {res['confidence']:.2f}")
                    if res["accuracy"] > best_acc:
                        best_acc = res["accuracy"]
                        if checkpoint_fn:
                            checkpoint_fn(episode, best_acc)
                    if metrics is not None:
                        metrics.scalars(
                            {"loss/Test_loss": res["loss"],
                             "acc/Test_acc": res["accuracy"],
                             "acc/Best_acc": best_acc}, episode // val_freq)
            if pending is not None:
                harvest(pending)
        finally:
            stager.shutdown(wait=False, cancel_futures=True)
        # with no validation, the final state is saved as best so that
        # ONLY_TEST has something to restore
        if best_acc == 0.0 and checkpoint_fn and episode > 0:
            self.log(f"no validation ran (VAL_FREQ={val_freq} vs "
                     f"{total} episodes) — saving final state as best")
            checkpoint_fn(episode, 0.0)
        return {"best_accuracy": best_acc, "episodes": episode}
