"""The trainer and the uncached evaluator: a built model, its optimizer,
the episodic train loop and the test protocol.

Port of ``clipspm_tpu/train/learner.py`` (``TrainState``,
``_train_step_impl``, ``train_episodes``, ``evaluate``, ``run``). One
optimizer step takes ``TASKS_PER_BATCH`` episodes: each real episode runs its
forward and backward with the same weights and the gradients sum in
``.grad`` (the JAX package sums them in a ``lax.scan``; with
``SOLVER.ACCUM_DTYPE: bfloat16`` the sum is kept in bf16 and cast to fp32
for the step, as there); then one optimizer step. A padding episode (past
``n_valid``) runs no forward at all, which is what the JAX step's zero
weight does to its gradient, BatchNorm statistics, metrics and episode
count. Frames are transformed on the device, drawn from the learner's own
seeded ``torch.Generator``; dropout draws from the device's default
generator, seeded from ``MODEL.SEED``. ``evaluate`` runs ``batch_size``
episodes a step from the test stream, one after another as the JAX
package's ``lax.map`` does; ``run`` validates through it unless it is
given a ``val_fn`` (the feature cache).
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


def _reseed(seed: int, episode: int) -> int:
    """A generator seed from ``MODEL.SEED`` and an episode count."""
    return int(np.random.SeedSequence([seed, episode]).generate_state(1)[0])


class Learner:
    """Config-driven trainer and evaluator over episode streams, and the
    feature cache's view of the model (``train/feature_cache.py``)."""

    def __init__(self, cfg, model: nn.Module, text_train: torch.Tensor,
                 text_test: torch.Tensor, device: torch.device,
                 transform: Optional[TransformSpec] = None,
                 build_seconds: Optional[Dict[str, float]] = None,
                 train_source=None, test_source=None,
                 log_fn: Callable[[str], None] = print):
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
        self.optimizer, self.scheduler = make_optimizer(
            cfg, self.model.parameters())
        self.episode = 0                       # episodes consumed
        self.gen = torch.Generator(device=device)
        self._seed(int(cfg.MODEL.SEED))
        self._copy_stream = (torch.cuda.Stream(device=device)
                             if device.type == "cuda" else None)

    # -- state ---------------------------------------------------------------

    def _seed(self, seed: int) -> None:
        """Seed the transform generator and the device's dropout one."""
        self.gen.manual_seed(seed)
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                torch.cuda.manual_seed(seed)
        else:
            torch.manual_seed(seed)

    def _dropout_rng(self) -> torch.Tensor:
        if self.device.type == "cuda":
            return torch.cuda.get_rng_state(self.device)
        return torch.get_rng_state()

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "episode": self.episode,
                "transform_rng": self.gen.get_state(),
                "dropout_rng": self._dropout_rng(),
                "text_train": self.text_train, "text_test": self.text_test}

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`. A model tree that differs in keys or
        shapes raises before anything changes (``nn.Module.load_state_dict``
        would copy the matching tensors first). Generator states saved on
        another kind of device (a CUDA state is 16 bytes, a CPU one 5056)
        are not restored: everything else is, and both generators are
        reseeded from ``MODEL.SEED`` and the restored episode count, with a
        log line saying so."""
        mine = self.model.state_dict()
        theirs = state["model"]
        bad = sorted(set(mine) ^ set(theirs)) + sorted(
            k for k in set(mine) & set(theirs)
            if mine[k].shape != theirs[k].shape)
        if bad:
            raise RuntimeError(f"model state differs in {len(bad)} keys or "
                               f"shapes, e.g. {bad[:3]}")
        same_device = all(
            state[key].numel() == ours.numel() for key, ours in (
                ("transform_rng", self.gen.get_state()),
                ("dropout_rng", self._dropout_rng())))
        self.model.load_state_dict(theirs)
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.episode = int(state["episode"])
        if same_device:
            self.gen.set_state(state["transform_rng"])
            if self.device.type == "cuda":
                torch.cuda.set_rng_state(state["dropout_rng"], self.device)
            else:
                torch.set_rng_state(state["dropout_rng"])
        else:
            seed = _reseed(int(self.cfg.MODEL.SEED), self.episode)
            self._seed(seed)
            self.log(f"checkpoint generator states are of another device "
                     f"type than {self.device.type}: transform and dropout "
                     f"generators reseeded ({seed}) from MODEL.SEED and "
                     f"episode {self.episode}")
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

    def _episode_loss(self, ep: Episode, train: bool = True):
        t = self.transform
        frames = [episode_device_transform(
            images, train=train, img_size=t.img_size, resize_to=t.resize_to,
            flip=t.flip, normalize=t.normalize, gen=self.gen)
            for images in (ep.support_images, ep.target_images)]
        out = self.model(frames[0], frames[1], ep.support_labels,
                         ep.real_support_labels, ep.real_target_labels,
                         self.text_train, self.text_test)
        return loss_and_acc(self.model_name, out, ep.target_labels,
                            ep.real_support_labels, ep.real_target_labels,
                            self.tasks_per_batch, cfg=self.cfg, train=train)

    def _step(self, batch: Episode, n_valid: int) -> Dict[str, torch.Tensor]:
        """One optimizer step over the first ``n_valid`` episodes of a
        device batch; returns the metrics as device scalars (unfetched)."""
        if not self.model.training:
            self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        params = list(self.model.parameters())
        acc_grads = None
        loss_sum = torch.zeros((), device=self.device)
        acc_sum = torch.zeros((), device=self.device)
        for e in range(n_valid):
            loss, acc = self._episode_loss(batch[e])
            # outside the model's autocast blocks: each op's backward runs
            # in the dtype its forward ran in (K1's replay in fp32)
            loss.backward()
            if self.accum_dtype is not None:
                # the episode's gradient, rounded, joins the bf16 sum
                grads = [None if p.grad is None
                         else p.grad.to(self.accum_dtype) for p in params]
                acc_grads = grads if acc_grads is None else [
                    a if g is None else g if a is None else a + g
                    for a, g in zip(acc_grads, grads)]
                self.optimizer.zero_grad(set_to_none=True)
            loss_sum += loss.detach()
            acc_sum += acc
        if acc_grads is not None:
            for p, g in zip(params, acc_grads):
                p.grad = None if g is None else g.to(p.dtype)
        for p in params:
            if p.grad is None:
                # the JAX chain decays every parameter, used or not
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.scheduler.step()
        self.episode += n_valid
        denom = max(n_valid, 1)
        return {"loss": loss_sum / denom, "acc": acc_sum / denom}

    def train_episodes(self, episodes: Sequence[Episode],
                       n_valid: Optional[int] = None) -> Dict[str, float]:
        """Consume a list of host episodes as one optimizer step. Only the
        first ``n_valid`` are real; the rest are padding, neither moved to
        the device nor run. Returns loss and acc averaged over the real
        ones."""
        n = len(episodes) if n_valid is None else int(n_valid)
        batch = self._ready(*self._to_device(episodes[:n])) if n else None
        return {k: float(v) for k, v in self._step(batch, n).items()}

    @torch.no_grad()
    def _eval_batch(self, batch: Episode, n: int) -> torch.Tensor:
        """``[n, 2]`` (loss, accuracy) of the first ``n`` episodes of a
        device batch, one episode after another (unfetched)."""
        return torch.stack([
            torch.stack([x.float() for x in self._episode_loss(
                batch[e], train=False)]) for e in range(n)])

    def evaluate(self, n_episodes: int, source=None,
                 batch_size: int = 1) -> Dict[str, float]:
        """The test protocol over ``n_episodes`` of ``source`` (the test
        stream by default, which continues across calls): the model in eval
        mode, the deterministic eval transform, ``batch_size`` episodes a
        step. A staging thread stacks and copies batch i+1 while the device
        runs batch i; the results of batch i are fetched after batch i+1
        has been issued. A trailing partial batch runs only its real
        episodes (the JAX package pads it with duplicates and trims their
        results). Returns mean accuracy (%), its ``196*std/sqrt(n)`` CI,
        mean loss, and the wall and host-stall seconds."""
        it = iter(source or self.test_source)
        batch_size = max(1, int(batch_size))
        self.model.eval()

        def stage(n):
            return self._to_device([next(it) for _ in range(n)]), n

        results: List[np.ndarray] = []
        stager = _cf.ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="clipspm-eval")
        pending = None
        stall_s, t0 = 0.0, time.perf_counter()
        try:
            done = 0
            if n_episodes > 0:
                fut = stager.submit(stage, min(batch_size, n_episodes))
            while done < n_episodes:
                t_w = time.perf_counter()
                (batch, ready), n = fut.result()
                stall_s += time.perf_counter() - t_w
                done += n
                if done < n_episodes:
                    fut = stager.submit(stage,
                                        min(batch_size, n_episodes - done))
                m = self._eval_batch(self._ready(batch, ready), n)
                del batch
                if pending is not None:
                    results.append(pending.cpu().numpy())
                pending = m
            if pending is not None:
                results.append(pending.cpu().numpy())
        finally:
            stager.shutdown(wait=False, cancel_futures=True)
        seconds = time.perf_counter() - t0
        # float64 statistics of the fp32 values, as the JAX evaluator's
        loss_acc = (np.concatenate(results) if results
                    else np.zeros((0, 2))).astype(np.float64)
        accs = loss_acc[:, 1]
        self.log(f"uncached eval: {n_episodes} episodes in batches of "
                 f"{batch_size} — {seconds:.1f}s "
                 f"({n_episodes / max(seconds, 1e-9):.2f} eps/s, host-stall "
                 f"{100.0 * stall_s / max(seconds, 1e-9):.0f}%)")
        return {
            "accuracy": float(accs.mean() * 100.0),
            "confidence": float(196.0 * accs.std() / np.sqrt(len(accs))),
            "loss": float(loss_acc[:, 0].mean()),
            "seconds": seconds,
            "host_stall_seconds": stall_s,
        }

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
        never staged or run.
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
        # a torch.profiler trace of one optimizer step, on request
        profile_dir = os.environ.get("CLIPSPM_PROFILE_DIR")
        profiled = False
        self.model.train()

        def stage(n):
            return self._to_device([next(it) for _ in range(n)]), n

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
                t_w = time.perf_counter()
                (batch, done), n = fut.result()
                stall_s += time.perf_counter() - t_w
                nxt = episode + n
                if nxt < total:
                    fut = stager.submit(stage, min(tpb, total - nxt))
                batch = self._ready(batch, done)
                if profile_dir and not profiled and episode > 0:
                    with profile_trace(profile_dir):
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
