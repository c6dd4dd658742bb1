"""The rank grid: the process group, the episode shard and the collectives
of the episode-parallel train step and evaluators.

Port of ``clipspm_tpu/parallel/mesh.py``'s ``(dp, tp)`` mesh. The JAX
package shards the episode axis over ``dp`` and the tower's projections
over ``tp`` and XLA inserts the collectives; here ``DEVICE.NUM_CHIPS x
DEVICE.TP`` ranks each run in a process of their own, one device each, and
the trainer, the evaluators and the tower call the collectives explicitly.
Rank ``g`` sits at ``(dp, tp) = (g // TP, g % TP)``, as device ``dp*TP +
tp`` of the JAX mesh, so a tp group is consecutive ranks. The ranks of one
dp index run the same episodes; the tp collectives are
``parallel/tensor.py``'s. Over the dp group:

- the episode shard: dp index ``d`` of ``N`` takes episodes ``d, d+N, ...``
  of a stream or a step, the JAX ``[E//M, M]`` reshape of a step
  (``clipspm_tpu/train/learner.py:254``) with ``M = N``;
- :meth:`EpisodeMesh.all_reduce_sum`: the gradients' *sum* over the dp
  indices (the JAX step sums over all E episodes; ``DistributedDataParallel``
  would average them), flattened into buckets;
- :func:`episode_mean_`: BatchNorm buffers set to the mean of the
  microstep's updated ones (``learner.py:268-281``);
- :meth:`EpisodeMesh.all_gather`: per-episode results in global episode
  order.

A process group is initialised from ``(rank, world, device)`` with a
timeout, so that a rank that stops answering ends the others' collectives
with an error instead of hanging them. The backend is NCCL on ``cuda`` and
gloo on ``cpu``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# seconds a collective may wait for the other ranks
TIMEOUT_S = 1800
# gradients are all-reduced in flat buckets of about this many bytes
BUCKET_BYTES = 25 * 2 ** 20
# the environment torchrun gives each of its ranks
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class EpisodeMesh:
    """This process's place on the ``dp x tp`` grid of an initialised
    group: global ``rank`` of ``world``, ``tp`` ranks to a dp index, and
    the process groups of its dp column and its tp row (None at ``tp=1``:
    the dp group is then the whole group)."""
    rank: int
    world: int
    device: torch.device
    tp: int = 1
    dp_group: Any = None
    tp_group: Any = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def dp_world(self) -> int:
        return self.world // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    def shard(self, n: int) -> range:
        """This dp index's episodes of ``n``: ``dp_rank, dp_rank +
        dp_world, ...``."""
        return range(self.dp_rank, n, self.dp_world)

    def _buckets(self, tensors: Sequence[torch.Tensor],
                 collective: Callable[[torch.Tensor], None]) -> None:
        """Run ``collective`` in place over ``tensors`` flattened into
        buckets of one dtype and about ``BUCKET_BYTES``, then copy back."""
        bucket: List[torch.Tensor] = []
        size = 0

        def flush():
            flat = torch.cat([t.reshape(-1) for t in bucket])
            collective(flat)
            for t, part in zip(bucket, flat.split([t.numel()
                                                   for t in bucket])):
                t.copy_(part.view_as(t))

        for t in tensors:
            if bucket and (t.dtype != bucket[0].dtype
                           or size >= BUCKET_BYTES):
                flush()
                bucket, size = [], 0
            bucket.append(t)
            size += t.numel() * t.element_size()
        if bucket:
            flush()

    def all_reduce_sum(self, tensors: Sequence[torch.Tensor]) -> None:
        """Each tensor becomes its sum over the dp group, in place."""
        self._buckets(tensors, lambda flat: dist.all_reduce(
            flat, group=self.dp_group))

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Each tensor becomes dp index 0's, in place (within this tp
        rank's dp group)."""
        self._buckets(tensors, lambda flat: dist.broadcast(
            flat, src=self.tp_rank, group=self.dp_group))

    def tp_broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Each tensor becomes tp rank 0's of this dp index, in place."""
        self._buckets(tensors, lambda flat: dist.broadcast(
            flat, src=self.dp_rank * self.tp, group=self.tp_group))

    def all_gather(self, rows: torch.Tensor) -> torch.Tensor:
        """``[k, ...]`` rows of every dp index (the same shape on each) as
        ``[dp_world * k, ...]`` in global order: row ``j`` of dp index
        ``d`` is global row ``j * dp_world + d``, the inverse of
        :meth:`shard`. Moved as bytes, so any dtype goes over either
        backend."""
        rows = rows.contiguous()
        flat = rows.reshape(-1).view(torch.uint8)
        parts = [torch.empty_like(flat) for _ in range(self.dp_world)]
        dist.all_gather(parts, flat, group=self.dp_group)
        parts = [p.view(rows.dtype).view(rows.shape) for p in parts]
        return torch.stack(parts, dim=1).reshape(
            (self.dp_world * rows.shape[0],) + rows.shape[1:])

    def barrier(self) -> None:
        """Wait for every rank of the grid (an all-reduce on this rank's
        device, which either backend runs there): a checkpoint that rank 0
        writes is whole for every rank after it."""
        dist.all_reduce(torch.zeros(1, device=self.device))

    def loader_group(self):
        """A new gloo group over every rank, for one ``EpisodeLoader``'s
        producer thread alone (None for a world of one). Every rank must
        call it in the same order."""
        if self.world == 1:
            return None
        return dist.new_group(backend="gloo",
                              timeout=datetime.timedelta(seconds=TIMEOUT_S))


def episode_mean_(buffers: Sequence[torch.Tensor],
                  sums: Optional[torch.Tensor], count: int,
                  mesh: Optional[EpisodeMesh] = None) -> None:
    """Set ``buffers`` (a microstep's BatchNorm buffers) to the mean of the
    ``count`` real episodes' updated ones. ``sums`` is the flat sum
    (:func:`flat_buffers`) of this process's real episodes' updated buffers
    (None when it ran none), summed over the ranks first when ``mesh`` is
    given. The JAX step's ``tensordot(ws, s_new) / max(sum(ws), 1)``; the
    caller runs no all-padding microstep, so ``count >= 1``."""
    dtype = _flat_dtype(buffers)
    if sums is None:
        sums = torch.zeros(sum(b.numel() for b in buffers), dtype=dtype,
                           device=buffers[0].device)
    if mesh is not None:
        mesh.all_reduce_sum([sums])
    mean = sums / count
    for b, part in zip(buffers, mean.split([b.numel() for b in buffers])):
        part = part.view_as(b)
        b.copy_(part if b.is_floating_point() else part.round())


def _flat_dtype(buffers: Sequence[torch.Tensor]) -> torch.dtype:
    dtype = torch.float32
    for b in buffers:
        if b.is_floating_point():
            dtype = torch.promote_types(dtype, b.dtype)
    return dtype


def flat_buffers(buffers: Sequence[torch.Tensor]) -> torch.Tensor:
    """``buffers`` as one flat tensor of their widest float dtype (integer
    counters as floats: exact below 2**24)."""
    dtype = _flat_dtype(buffers)
    return torch.cat([b.reshape(-1).to(dtype) for b in buffers])


def init(rank: int, world: int, device: torch.device, *,
         init_method: str, backend: Optional[str] = None,
         timeout_s: float = TIMEOUT_S, tp: int = 1) -> EpisodeMesh:
    """Join the process group as ``rank`` of ``world`` on ``device`` (NCCL
    on ``cuda``, gloo on ``cpu``; ``backend`` overrides, for ranks sharing
    one card over gloo) and, at ``tp`` above 1, make the grid's dp and tp
    groups (every rank makes every group, in one order)."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world % tp:
        raise ValueError(f"{world} ranks do not make a grid of tp={tp}")
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=timeout)
    if tp == 1:
        return EpisodeMesh(rank, world, device)
    dp_groups = [dist.new_group(list(range(t, world, tp)), timeout=timeout)
                 for t in range(tp)]
    tp_groups = [dist.new_group(list(range(d * tp, (d + 1) * tp)),
                                timeout=timeout)
                 for d in range(world // tp)]
    return EpisodeMesh(rank, world, device, tp, dp_groups[rank % tp],
                       tp_groups[rank // tp])


def close() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_device(device: torch.device, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:rank``, or the CPU when asked."""
    device = torch.device(device)
    return torch.device("cuda", rank) if device.type == "cuda" else device


def torchrun_env() -> bool:
    """True inside a rank that ``torchrun`` started."""
    return all(k in os.environ for k in TORCHRUN_ENV)


def join_torchrun(device: torch.device, world: int, tp: int = 1
                  ) -> EpisodeMesh:
    """Join the group ``torchrun`` set up; its world must be ``world``
    (``DEVICE.NUM_CHIPS x DEVICE.TP``)."""
    have = int(os.environ["WORLD_SIZE"])
    if have != world:
        raise ValueError(f"DEVICE.NUM_CHIPS x DEVICE.TP = {world} but "
                         f"torchrun started {have} ranks")
    rank = int(os.environ["RANK"])
    return init(rank, world, rank_device(device, int(os.environ[
        "LOCAL_RANK"])), init_method="env://", tp=tp)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, devices: Sequence[torch.device],
               init_method: str, backend: Optional[str], timeout_s: float,
               tp: int, out: str, args: tuple) -> None:
    world = len(devices)
    if devices[rank].type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    mesh = init(rank, world, devices[rank], init_method=init_method,
                backend=backend, timeout_s=timeout_s, tp=tp)
    try:
        result = fn(mesh, *args)
        if mesh.is_main:
            torch.save(result, out)
    finally:
        close()


def spawn(fn: Callable, world: int, device: torch.device, args: tuple = (),
          *, devices: Optional[Sequence[torch.device]] = None,
          backend: Optional[str] = None,
          timeout_s: float = TIMEOUT_S, tp: int = 1):
    """Run ``fn(mesh, *args)`` in ``world`` new processes over a group on a
    free local port, rank ``r`` on :func:`rank_device` (or on
    ``devices[r]``), on a grid of ``world // tp`` dp indices by ``tp``;
    returns rank 0's result. A rank that raises ends the
    others and raises here (``torch.multiprocessing``'s
    ``ProcessRaisedException``). ``fn`` must be importable by name."""
    import torch.multiprocessing as mp

    if devices is None:
        devices = [rank_device(device, r) for r in range(world)]
    devices = [torch.device(d) for d in devices]
    init_method = f"tcp://localhost:{_free_port()}"
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pt")
        mp.spawn(_rank_main, nprocs=world, join=True,
                 args=(fn, devices, init_method, backend, timeout_s, tp,
                       out, args))
        # written by rank 0 of this call
        return torch.load(out, weights_only=False)
