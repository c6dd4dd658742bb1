"""The tensors a remat policy names, each the output of an operator of its
own.

The JAX package names three tensors of a transformer block with
``checkpoint_name`` (``clipspm_tpu/models/backbones/clip.py:
ResidualAttentionBlock``): the attention probabilities (``attn_probs``),
the attention output (``attn_out``) and the MLP's gelu output
(``mlp_gelu``). A ``save_only_these_names`` policy keeps them across the
recompute, and the tag costs nothing. A selective-checkpoint policy in
PyTorch decides per operator, so here each tagged tensor is made by a
custom operator with its own backward: the policy (``models/visual.py``)
keeps that operator's output as it is, without a copy.

- ``attn_probs(scores, fast, dtype)``: the softmax of fp32 scores over the
  last axis, cast to ``dtype``; with ``fast`` the JAX package's
  ``FAST_SOFTMAX`` form, ``exp(s - max)`` cast to ``dtype`` and then
  divided by its sum in ``dtype``. Its backward keeps the scores and
  differentiates the same form again from them, so the softmax's
  derivative is taken from its fp32 probabilities, as in the JAX package,
  whose remat keeps only the cast ones and recomputes the softmax in the
  backward. Under a policy the scores are the recompute's, held only
  while the chunk's backward runs.
- ``attn_out(probs, v)``: ``probs @ v``.
- ``mlp_gelu(x)``: ``x * sigmoid(1.702 x)``, CLIP's QuickGELU; its backward
  needs ``x``, so ``x`` (the ``c_fc`` output) is recomputed under a policy
  that keeps only the gelu output, as in the JAX package.

A block runs these operators where :func:`active` names their tag: inside
the contexts of a policy that keeps them (``models/visual.py``), and
``attn_probs`` and ``attn_out`` wherever the attention is spelled out
(``MODEL.FAST_SOFTMAX``).
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch import Tensor

_state = threading.local()


def active() -> frozenset:
    """The tags whose operators the blocks run now (empty outside a
    policy's contexts)."""
    return getattr(_state, "tags", frozenset())


@contextlib.contextmanager
def tagging(names):
    """Run the operators of ``names`` inside the context; the forward and
    the recompute of one checkpoint both enter it, in whatever thread runs
    them, so both run the same operators."""
    before = active()
    _state.tags = frozenset(names)
    try:
        yield
    finally:
        _state.tags = before


def _probs(scores: Tensor, fast: bool, dtype: torch.dtype) -> Tensor:
    if fast:
        m = scores.detach().amax(-1, keepdim=True)
        e = torch.exp(scores - m).to(dtype)
        return e / e.sum(-1, keepdim=True)
    return torch.softmax(scores, -1).to(dtype)


@torch.library.custom_op("clipspm::attn_probs", mutates_args=())
def attn_probs(scores: Tensor, fast: bool, dtype: torch.dtype) -> Tensor:
    return _probs(scores, fast, dtype)


@attn_probs.register_fake
def _(scores, fast, dtype):
    return scores.new_empty(scores.shape, dtype=dtype)


def _probs_setup(ctx, inputs, output):
    scores, ctx.fast, ctx.dtype = inputs
    ctx.save_for_backward(scores)


def _probs_backward(ctx, grad):
    scores, = ctx.saved_tensors
    with torch.enable_grad(), torch.autocast(scores.device.type,
                                             enabled=False):
        scores = scores.detach().requires_grad_()
        probs = _probs(scores, ctx.fast, ctx.dtype)
        return torch.autograd.grad(probs, scores, grad)[0], None, None


attn_probs.register_autograd(_probs_backward, setup_context=_probs_setup)


@torch.library.custom_op("clipspm::attn_out", mutates_args=())
def attn_out(probs: Tensor, v: Tensor) -> Tensor:
    return torch.matmul(probs, v)


@attn_out.register_fake
def _(probs, v):
    return probs.new_empty(probs.shape[:-1] + v.shape[-1:])


def _out_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _out_backward(ctx, grad):
    probs, v = ctx.saved_tensors
    return (torch.matmul(grad, v.transpose(-1, -2)),
            torch.matmul(probs.transpose(-1, -2), grad))


attn_out.register_autograd(_out_backward, setup_context=_out_setup)


@torch.library.custom_op("clipspm::mlp_gelu", mutates_args=())
def mlp_gelu(x: Tensor) -> Tensor:
    return x * torch.sigmoid(1.702 * x)


@mlp_gelu.register_fake
def _(x):
    return torch.empty_like(x)


def _gelu_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[0])


def _gelu_backward(ctx, grad):
    x, = ctx.saved_tensors
    s = torch.sigmoid(1.702 * x)
    return grad * (s + 1.702 * x * s * (1 - s))


mlp_gelu.register_autograd(_gelu_backward, setup_context=_gelu_setup)

# each tag's operators; SDPA makes ``attn_out`` where the attention is one
# call (any of its backends' aten operators)
OPS = {"attn_probs": (torch.ops.clipspm.attn_probs.default,),
       "attn_out": (torch.ops.clipspm.attn_out.default,),
       "mlp_gelu": (torch.ops.clipspm.mlp_gelu.default,)}


def makes(op, names) -> bool:
    """Whether ``op`` makes the tensor of one of the tags ``names``."""
    return any(op in OPS[n] for n in names) or (
        "attn_out" in names and "scaled_dot_product" in str(op))
