"""Megatron tensor parallelism over the ``tp`` ranks of a dp index.

Port of ``clipspm_tpu/parallel/tensor.py`` (``megatron_specs``,
``shard_params``, ``shard_train_state``). The JAX package places the
parameters with ``PartitionSpec``s and GSPMD inserts the collectives; here
each tp rank holds its shard of the sharded parameters and the tower's
layers call the collectives of a :class:`TPContext` explicitly:

- column-parallel ``c_fc`` and ``in_proj``: the weight's output rows and the
  bias are sharded; the input goes through ``copy_to`` (Megatron's *f*: the
  identity forward, the gradient's all-reduce backward);
- row-parallel ``c_proj`` and ``out_proj``: the weight's input columns are
  sharded, the bias replicated; the local product goes through
  ``reduce_from`` (Megatron's *g*: an all-reduce forward, the identity
  backward) and the bias is added once, after the sum. The partial products
  are summed in fp32 and cast after the bias (the port's choice);
- everything else (norms, embeddings, the RN50 conv tower, BatchNorm, the
  heads) is replicated; a dimension that tp does not divide stays
  replicated (``megatron_specs``).

Which parameters shard is decided, as in the JAX package, from the last two
names of the parameter's JAX path (``weights.jax_paths``), not from torch's
names, so that a head's ``out_proj`` cannot shard by accident. The
attention shards by heads: rank r's ``in_proj`` rows are the q, k and v rows
of its ``n_head / tp`` heads (a fixed row permutation of the JAX package's
contiguous shard, which keeps the attention local), and ``out_proj``'s
columns the same heads'. Where tp does not divide the heads, ``in_proj``
and ``out_proj`` of that block stay replicated (a placement that differs
from the JAX package's; the results do not).

The collectives are ``all_reduce`` and ``broadcast`` alone, which gloo (tp
ranks sharing one card) and NCCL both run on CUDA tensors. Checkpoints and
:func:`full_state_dict` hold the canonical unsharded layout, so a state
saved at any ``tp`` loads at any other.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..models.backbones.clip import (AttentionPool2d, ResidualAttentionBlock,
                                     _Attention)
from ..weights import jax_paths
from .mesh import EpisodeMesh


def _fp32_copy(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` in fp32 (or its own dtype, if wider), to
    be all-reduced in place."""
    out = x.to(torch.promote_types(x.dtype, torch.float32)).contiguous()
    return out.clone() if out.data_ptr() == x.data_ptr() else out


class _CopyToTP(torch.autograd.Function):
    """Megatron's *f*: the identity; its backward sums the gradient over
    the tp group (in fp32)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        total = _fp32_copy(grad)
        dist.all_reduce(total, group=ctx.group)
        return total.to(grad.dtype), None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's *g*: the sum over the tp group of the ranks' partial
    products, in fp32 (or wider; the output too); its backward is the
    identity."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        total = _fp32_copy(x)
        dist.all_reduce(total, group=group)
        return total

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


@dataclasses.dataclass(frozen=True)
class TPContext:
    """The collectives of one tp row, as the tower's sharded layers call
    them: ``rank`` of ``world`` tp ranks over ``group``."""
    rank: int
    world: int
    group: object

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToTP.apply(x, self.group)

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromTP.apply(x, self.group)

    def max_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` becomes its elementwise maximum over the tp ranks."""
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` becomes its sum over the tp ranks (exact for integers)."""
        dist.all_reduce(t, group=self.group)
        return t


@dataclasses.dataclass(frozen=True)
class Shard:
    """A sharded parameter: ``dim`` cut into ``parts`` equal blocks (3 for
    the fused q, k, v of ``in_proj``, else 1), each block into ``tp``
    pieces; rank r holds piece r of every block."""
    dim: int
    parts: int = 1

    def index(self, size: int, rank: int, tp: int) -> torch.Tensor:
        """The indices along ``dim`` of rank ``rank``'s shard of a full
        tensor ``size`` long there."""
        block = size // self.parts
        piece = block // tp
        return torch.cat([torch.arange(p * block + rank * piece,
                                       p * block + (rank + 1) * piece)
                          for p in range(self.parts)])


# the JAX package's _spec_for (clipspm_tpu/parallel/tensor.py:42-54): the
# sharded dimension of a Dense kernel [in, out] or bias [out] by the last
# two names of its path
_COLUMN = ("c_fc", "in_proj")
_ROW = ("c_proj", "out_proj")


def _jax_dim(path: Tuple[str, ...], ndim: int) -> Optional[int]:
    if len(path) < 2 or ndim == 0:
        return None
    mod, name = path[-2], path[-1]
    if mod in _COLUMN:
        if name == "kernel":
            return 1
        if name == "bias":
            return 0
    if mod in _ROW and name == "kernel":
        return 0
    return None


def layout(model: nn.Module, n_tp: int) -> Dict[str, Optional[Shard]]:
    """Each parameter name of ``model`` (full, unsharded) -> its
    :class:`Shard` at ``n_tp`` ranks, or None (replicated)."""
    params = dict(model.named_parameters())
    paths = jax_paths(model)
    out: Dict[str, Optional[Shard]] = {}
    for name, p in params.items():
        jdim = _jax_dim(paths[name], p.dim())
        # a Dense kernel [in, out] is the port's weight [out, in]
        dim = None if jdim is None else p.dim() - 1 - jdim
        parts = 3 if name.endswith(("in_proj_weight", "in_proj_bias")) \
            else 1
        if dim is not None and p.shape[dim] % (parts * n_tp):
            dim = None
        out[name] = None if dim is None else Shard(dim, parts)
    # the attention shards by heads, or not at all
    for mod_name, mod in model.named_modules():
        if isinstance(mod, _Attention) and mod.n_head % n_tp:
            for leaf in ("in_proj_weight", "in_proj_bias",
                         "out_proj.weight"):
                out[f"{mod_name}.{leaf}" if mod_name else leaf] = None
    return out


def megatron_specs(model: nn.Module, n_tp: int) -> Dict[str, Optional[int]]:
    """Each parameter name of ``model`` -> its sharded dimension in the
    port's ``[out, in]`` layout at ``n_tp`` ranks, or None (replicated)."""
    return {k: (None if s is None else s.dim)
            for k, s in layout(model, n_tp).items()}


def _is_sharded(shards: Dict[str, Optional[Shard]], prefix: str,
                leaf: str) -> bool:
    return shards.get(f"{prefix}.{leaf}" if prefix else leaf) is not None


@torch.no_grad()
def shard_model_(model: nn.Module, mesh: EpisodeMesh
                 ) -> Dict[str, Optional[Shard]]:
    """Keep this rank's shard of each sharded parameter of ``model`` (full
    and the same on every tp rank) and give the sharded layers the mesh's
    :class:`TPContext`; returns the layout. The counterpart of the JAX
    ``shard_params``; call it before the optimizer is made."""
    shards = layout(model, mesh.tp)
    for name, p in model.named_parameters():
        if shards[name] is not None:
            p.data = _local(p.data, shards[name], mesh)
    ctx = TPContext(mesh.tp_rank, mesh.tp, mesh.tp_group)
    for prefix, mod in model.named_modules():
        if isinstance(mod, _Attention):
            mod.tp = ctx if _is_sharded(shards, prefix,
                                        "in_proj_weight") else None
        elif isinstance(mod, ResidualAttentionBlock):
            mod.tp = ctx if _is_sharded(shards, prefix,
                                        "mlp.c_fc.weight") else None
        elif isinstance(mod, AttentionPool2d):
            mod.tp = ctx if _is_sharded(shards, prefix,
                                        "c_proj.weight") else None
    return shards


def _gather(pairs: Sequence[Tuple[torch.Tensor, Shard]],
            mesh: Optional[EpisodeMesh]) -> List[torch.Tensor]:
    """The full tensors of the local shards ``pairs`` (each with its
    shard): one broadcast from each tp rank per dtype, bit for bit."""
    out: List[Optional[torch.Tensor]] = [None] * len(pairs)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, (t, _) in enumerate(pairs):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([pairs[i][0].reshape(-1) for i in idx])
        for i in idx:
            t, shard = pairs[i]
            out[i] = t.new_empty(full_shape(t, shard, mesh.tp))
        for r in range(mesh.tp):
            buf = flat if r == mesh.tp_rank else torch.empty_like(flat)
            dist.broadcast(buf, src=mesh.dp_rank * mesh.tp + r,
                           group=mesh.tp_group)
            for i, piece in zip(idx, buf.split([pairs[i][0].numel()
                                                for i in idx])):
                t, shard = pairs[i]
                out[i].index_copy_(shard.dim, shard.index(
                    out[i].shape[shard.dim], r, mesh.tp).to(t.device),
                    piece.view_as(t))
    return out


def _local(t: torch.Tensor, shard: Shard, mesh: EpisodeMesh
           ) -> torch.Tensor:
    return t.index_select(shard.dim, shard.index(
        t.shape[shard.dim], mesh.tp_rank, mesh.tp).to(t.device))


def full_shape(t: torch.Tensor, shard: Optional[Shard], tp: int
               ) -> Tuple[int, ...]:
    """The unsharded shape of a local tensor."""
    shape = list(t.shape)
    if shard is not None:
        shape[shard.dim] *= tp
    return tuple(shape)


def full_state_dict(model: nn.Module, shards: Dict[str, Optional[Shard]],
                    mesh: Optional[EpisodeMesh]) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every sharded parameter gathered over the
    tp ranks into its canonical layout (every tp rank calls it). An empty
    layout (``TP=1``; ``mesh`` may be None) gathers nothing."""
    state = model.state_dict()
    keys = [k for k in state if shards.get(k) is not None]
    full = _gather([(state[k], shards[k]) for k in keys], mesh)
    state.update(zip(keys, full))
    return state


def load_full_state_dict(model: nn.Module, state: Dict[str, torch.Tensor],
                         shards: Dict[str, Optional[Shard]],
                         mesh: Optional[EpisodeMesh]) -> None:
    """Load a canonical (unsharded) ``state`` into the sharded ``model``:
    each rank takes its shard."""
    model.load_state_dict({k: (_local(v, shards[k], mesh)
                               if shards.get(k) is not None else v)
                           for k, v in state.items()})


def _copy(state: dict) -> dict:
    """An optimizer ``state_dict`` whose per-parameter entries may be
    replaced without touching ``state``'s."""
    return {"state": {i: dict(e) for i, e in state["state"].items()},
            "param_groups": state["param_groups"]}


def _moments(state: dict, names: Sequence[str],
             shards: Dict[str, Optional[Shard]]
             ) -> Iterable[Tuple[dict, str, Shard]]:
    """The parameter-shaped entries of an optimizer ``state_dict``'s state
    (Adam's moments, SGD's momentum; not the step counts): ``(entry, key,
    shard)`` for each of a sharded parameter (``names``: the parameter
    names in the optimizer's order)."""
    for i, entry in state["state"].items():
        shard = shards.get(names[i])
        if shard is None:
            continue
        for key, v in entry.items():
            if torch.is_tensor(v) and v.dim() > shard.dim:
                yield entry, key, shard


def full_optimizer_state(state: dict, names: Sequence[str],
                         shards: Dict[str, Optional[Shard]],
                         mesh: Optional[EpisodeMesh]) -> dict:
    """An optimizer ``state_dict`` with the sharded parameters' moments
    gathered into their canonical layout, as the JAX ``shard_train_state``
    shards them (every tp rank calls it)."""
    state = _copy(state)
    found = list(_moments(state, names, shards))
    full = _gather([(e[k], s) for e, k, s in found], mesh)
    for (entry, key, _), t in zip(found, full):
        entry[key] = t
    return state


def shard_optimizer_state(state: dict, names: Sequence[str],
                          shards: Dict[str, Optional[Shard]],
                          mesh: Optional[EpisodeMesh]) -> dict:
    """A canonical optimizer ``state_dict`` cut to this rank's shards: the
    counterpart of the JAX ``shard_train_state``'s moments."""
    state = _copy(state)
    for entry, key, shard in list(_moments(state, names, shards)):
        entry[key] = _local(entry[key], shard, mesh)
    return state
