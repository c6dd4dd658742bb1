"""The CLIP tower's switches and the remat policies ``attn`` and ``mlp``
against the JAX package (``test-tiny``: the ViT tower at width 64, 32 px,
2-way, T=4; ``test-tiny-rn`` for the BatchNorm dtype rule).

- ``MODEL.FAST_SOFTMAX``, ``MODEL.BF16_NORMS`` and ``MODEL.INT8_EVAL``, each
  alone and all together, JAX vs port from the same weights (carried by
  ``weights.py``): at fp32 the tower's features and the head's logits
  within 1e-5; at bf16 within 4 bf16 ulps of the largest. Where int8 runs,
  the same argmax, and every value within one int8 step (1/127) of the
  largest: the two packages' fp32 activations differ by rounding, and one
  that sits on a rounding boundary of its row's scale takes the next code
  on one side (measured on these inputs: at most 3 of 32 frames off by more
  than 1e-5, by 2.3e-3 to 3.7e-3 of the largest feature). So each int8
  projection the port runs is also held against the JAX ``int8_matmul`` on
  the very input it got, within 1e-6 (the codes, sums and outputs of the
  product itself are held exactly by ``tests/test_torch_quant.py``).
- ``BF16_NORMS`` at fp32 is bit-equal to off, ViT and ResNet; its BatchNorm
  in train mode keeps flax's biased running variance at bf16.
- The int8 train forward is bit-equal to the float one; in evaluation no
  float product runs in the blocks; the parameters and their OpenAI names
  do not change.
- Under ``attn`` and ``mlp`` (and ``FAST_SOFTMAX`` in training) the
  remat-chunked encode's loss and gradients equal ``full``'s and the JAX
  package's: at fp32 within rtol 5e-4, atol 5e-5; at bf16 within four
  bf16 ulps (2**-6) of the whole gradient. The policies are honoured:
  ``attn`` runs neither tagged operator again (no softmax operator, no
  ``probs @ v``), ``mlp`` no gelu and no attention, and the tagged tensors
  are their operators' outputs, with no copy. Under ``attn`` the softmax's
  derivative is recomputed from the scores, and under ``mlp`` ``c_fc`` is
  recomputed, in both packages: neither policy keeps what those
  derivatives need (the fp32 probabilities, the gelu's input).
- ``INT8_EVAL`` on a ResNet tower raises the JAX ``ValueError``.
- The slice: feature-cached evaluation with all three switches equals the
  JAX evaluator's; the CLI trains under ``attn`` and ``mlp`` with the
  switches, validating through int8.
"""

import contextlib
import dataclasses
import functools
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from make_synthetic_dataset import make_dataset  # noqa: E402

from clipspm_tpu.models.backbones.clip import CLIP_ARCHS as J_ARCHS  # noqa: E402
from clipspm_tpu.models.fsar import CLIPSPMModel as JModel  # noqa: E402
from clipspm_tpu.models.fsar import build_model as jax_build_model  # noqa: E402
from clipspm_tpu.models.visual import make_clip_visual as make_jax_visual  # noqa: E402
from clipspm_tpu.train.feature_cache import evaluate_cached as jax_evaluate  # noqa: E402
from clipspm_tpu.train.setup import build_learner as jax_build  # noqa: E402
from clipspm_tpu.utils.config import ConfigNode as JConfig  # noqa: E402
from clipspm_tpu.utils.config import SPM_DEFAULT_PARAMS  # noqa: E402
from clipspm_tpu.utils.config import load_config as jax_load  # noqa: E402
from clipspm_tpu_torch import weights  # noqa: E402
from clipspm_tpu_torch.cli.run import main as port_cli  # noqa: E402
from clipspm_tpu_torch.models.backbones import clip as tclip  # noqa: E402
from clipspm_tpu_torch.models.fsar import CLIPSPMModel, build_model  # noqa: E402
from clipspm_tpu_torch.ops import quant  # noqa: E402
from clipspm_tpu_torch.train.feature_cache import evaluate_cached  # noqa: E402
from clipspm_tpu_torch.train.setup import build_learner  # noqa: E402
from clipspm_tpu_torch.utils.config import ConfigNode  # noqa: E402
from clipspm_tpu_torch.utils.config import load_config  # noqa: E402

torch.set_num_threads(2)

WAY, SHOT, QUERIES, T, IMG, CLASSES = 2, 2, 2, 4, 32, 6
D = J_ARCHS["test-tiny"].embed_dim
SPM = dict(SPM_DEFAULT_PARAMS["hmdb"])
SWITCHES = {"fast_softmax": dict(fast_softmax=True),
            "bf16_norms": dict(bf16_norms=True),
            "int8_eval": dict(int8_eval=True),
            "all": dict(fast_softmax=True, bf16_norms=True, int8_eval=True)}
INT8_STEP = 1.0 / 127


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _inputs(seed=0, dim=D):
    rng = np.random.default_rng(seed)
    S, Q = WAY * SHOT, WAY * QUERIES
    sl = rng.permutation(np.repeat(np.arange(WAY), SHOT)).astype(np.int32)
    tl = rng.permutation(np.repeat(np.arange(WAY), QUERIES)).astype(np.int32)
    classes = rng.choice(CLASSES, WAY, replace=False).astype(np.int32)
    text = rng.normal(size=(2, CLASSES, dim)).astype(np.float32)
    return (rng.uniform(size=(S, T, IMG, IMG, 3)).astype(np.float32),
            rng.uniform(size=(Q, T, IMG, IMG, 3)).astype(np.float32),
            sl, classes[sl], classes[tl], text[0], text[1])


def _carried(switches, bf16=False, name="test-tiny", **model_kw):
    """The JAX model, its variables and the port's model holding them
    (``model_kw``: the chunking and remat keywords both models take)."""
    jm = JModel(arch=dataclasses.replace(J_ARCHS[name], **switches),
                way=WAY, shot=SHOT, spm=SPM,
                dtype=jnp.bfloat16 if bf16 else jnp.float32, **model_kw)
    tm = CLIPSPMModel(arch=dataclasses.replace(tclip.CLIP_ARCHS[name],
                                               **switches),
                      way=WAY, shot=SHOT, spm=SPM,
                      compute_dtype=torch.bfloat16 if bf16 else None,
                      **model_kw)
    variables = jm.init(jax.random.PRNGKey(1), *[
        jnp.asarray(a) for a in _inputs(dim=J_ARCHS[name].embed_dim)])
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tm.load_state_dict(weights.model_state_dict(variables), strict=True)
    return jm, variables, tm


def _check(got, want, switches, bf16, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    largest = float(np.abs(want).max())
    if bf16:
        tol = 4 * _bf16_ulp(largest)
    elif switches.get("int8_eval"):
        tol = INT8_STEP * largest
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=what)
        return
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max abs diff {err:.3e} > {tol:.3e}"


@contextlib.contextmanager
def _int8_projections():
    """Record each int8 projection of the port's blocks: its input,
    weight, bias and output."""
    int8_linear, seen = tclip.int8_linear, []

    def recording(x, weight, bias=None):
        y = int8_linear(x, weight, bias)
        seen.append(tuple(t.detach() for t in (x, weight, bias, y)))
        return y

    tclip.int8_linear = recording
    try:
        yield seen
    finally:
        tclip.int8_linear = int8_linear


def _check_projections_against_jax(projections):
    """Each int8 projection the port ran against the JAX ``int8_matmul``
    on the very input it got (``[K, M]`` kernel): within 1e-6 relative and
    of the largest output, as ``tests/test_torch_quant.py`` holds the two
    functions. The features' tolerance is left with the flips that the two
    packages' float steps cause upstream of a projection."""
    from clipspm_tpu.ops.quant import int8_matmul

    # four a block, over two tower calls (the encode and the forward's)
    assert len(projections) == 2 * 4 * J_ARCHS["test-tiny"].vision_layers
    jitted = jax.jit(int8_matmul)
    for x, w, b, y in projections:
        want = np.asarray(jitted(jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32),
            jnp.asarray(w.t().numpy()), jnp.asarray(b.numpy())
        ).astype(jnp.float32))
        np.testing.assert_allclose(y.float().numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(SWITCHES))
def test_switches_match_jax(case, bf16):
    switches = SWITCHES[case]
    jm, variables, tm = _carried(switches, bf16)
    x = _inputs(seed=3)
    frames = np.concatenate(x[:2])
    want_f = jm.apply(variables, jnp.asarray(frames), method=jm.encode)
    want = jm.apply(variables, *[jnp.asarray(a) for a in x])
    tm.eval()
    with torch.no_grad(), _int8_projections() as projections:
        got_f = tm.encode(torch.from_numpy(frames))
        got = tm(*[torch.from_numpy(a) for a in x])
    if switches.get("int8_eval"):
        _check_projections_against_jax(projections)
    else:
        assert not projections
    assert got_f.shape == want_f.shape == (2 * WAY * SHOT, T, D)
    assert got_f.dtype == (torch.bfloat16 if bf16 else torch.float32)
    _check(got_f.float(), want_f.astype(jnp.float32), switches, bf16,
           "features")
    _check(got["logits"], want["logits"], switches, bf16, "logits")
    assert (got["logits"].argmax(-1).tolist()
            == np.asarray(want["logits"]).argmax(-1).tolist())


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-rn"])
def test_bf16_norms_at_fp32_is_bit_equal_to_off(name):
    arch = tclip.CLIP_ARCHS[name]
    off = weights.random_init_(CLIPSPMModel(arch=arch, way=WAY, shot=SHOT,
                                            spm=SPM),
                               torch.Generator().manual_seed(0))
    on = CLIPSPMModel(arch=dataclasses.replace(arch, bf16_norms=True),
                      way=WAY, shot=SHOT, spm=SPM)
    on.load_state_dict(off.state_dict())
    x = [torch.from_numpy(a) for a in _inputs(seed=4, dim=arch.embed_dim)]
    for train in (False, True):
        outs = []
        for m in (off, on):
            m.train(train)
            for mod in m.modules():
                if isinstance(mod, torch.nn.Dropout):
                    mod.p = 0.0
            with torch.no_grad():
                outs.append((m.encode(x[0]), m(*x)["logits"]))
        assert torch.equal(outs[0][0], outs[1][0])
        assert torch.equal(outs[0][1], outs[1][1])
    for k, v in off.state_dict().items():      # the same running stats
        assert torch.equal(v, on.state_dict()[k]), k


def test_bf16_norms_resnet_tower_matches_flax_at_bf16():
    """test-tiny-rn: the BatchNorms in bf16 (eval), the tower's features
    within 4 bf16 ulps of the largest; in train mode the running variance
    is flax's biased one (fp32 statistics of the same bf16 input)."""
    jarch = dataclasses.replace(J_ARCHS["test-tiny-rn"], bf16_norms=True)
    jm = make_jax_visual(jarch, dtype=jnp.bfloat16)
    frames = jnp.asarray(np.concatenate(_inputs(seed=5)[:2]).reshape(
        -1, IMG, IMG, 3))
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(1), frames))
    want = jax.jit(jm.apply)(variables, frames)
    tm = tclip.make_clip_visual(dataclasses.replace(
        tclip.CLIP_ARCHS["test-tiny-rn"], bf16_norms=True))
    tm.load_state_dict(weights.visual_state_dict(
        variables["params"], variables["batch_stats"]), strict=False)
    tm.eval()
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = tm(torch.from_numpy(np.asarray(frames)))
    assert got.dtype == torch.bfloat16
    _check(got.float(), want.astype(jnp.float32), {}, True, "features")
    bn = tm.bn1
    assert not bn.fp32 and bn.running_var.dtype == torch.float32
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(4, 6, 6, bn.num_features))).to(torch.bfloat16)
    bn.train()
    y = bn(x.permute(0, 3, 1, 2))
    assert y.dtype == torch.bfloat16
    xf = x.float().numpy()
    var0 = variables["batch_stats"]["bn1"]["var"]
    want_var = 0.9 * var0 + 0.1 * xf.var(axis=(0, 1, 2))
    np.testing.assert_allclose(bn.running_var.numpy(), want_var, rtol=1e-5)


def test_int8_train_forward_is_bit_equal_and_eval_runs_no_float_product():
    """(JAX: tests/test_int8_eval.py.) Training never quantises; in
    evaluation the blocks' four projections run through the int8 product,
    and the only float matmul left is the tower's output projection."""
    arch = tclip.CLIP_ARCHS["test-tiny"]
    f = weights.random_init_(CLIPSPMModel(arch=arch, way=WAY, shot=SHOT,
                                          spm=SPM),
                             torch.Generator().manual_seed(1))
    q = CLIPSPMModel(arch=dataclasses.replace(arch, int8_eval=True),
                     way=WAY, shot=SHOT, spm=SPM)
    q.load_state_dict(f.state_dict())
    assert [k for k in q.state_dict()] == [k for k in f.state_dict()]
    x = [torch.from_numpy(a) for a in _inputs(seed=7)]
    outs = []
    for m in (f, q):
        m.train()
        for mod in m.modules():
            if isinstance(mod, torch.nn.Dropout):
                mod.p = 0.0
        with torch.no_grad():
            outs.append(m(*x))
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k

    class Mms(TorchDispatchMode):
        """fp32 matmuls (the plain int8 product's are float64)."""
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in (torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default) \
                    and out.dtype == torch.float32:
                self.n += 1
            return out

    plain, calls = quant.int8_mm_plain, []

    def counted(a, b):
        calls.append(a.shape)
        return plain(a, b)

    quant.int8_mm_plain = counted
    try:
        for m, int8_calls, mms in ((f, 0, 4 * arch.vision_layers + 1),
                                   (q, 4 * arch.vision_layers, 1)):
            m.backbone.eval()
            calls.clear()
            with Mms() as count, torch.no_grad():
                m.backbone(x[0][:, 0])
            assert (len(calls), count.n) == (int8_calls, mms)
    finally:
        quant.int8_mm_plain = plain


def test_int8_eval_on_a_resnet_tower_raises():
    d = {"MODEL": {"NAME": "clipspm", "BACKBONE": "RN50",
                   "INT8_EVAL": True},
         "TRAIN": {"WAY": 2, "SHOT": 1}, "DATA": {"SEQ_LEN": 4}}
    jcfg, tcfg = JConfig(d), ConfigNode(d)
    jcfg.params = tcfg.params = SPM
    for build in (jax_build_model, build_model):
        with pytest.raises(ValueError, match="INT8_EVAL"):
            build(jcfg if build is jax_build_model else tcfg)


# -- the remat policies -------------------------------------------------------

class _Ops(TorchDispatchMode):
    """The operators that run, by name."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        shape = tuple(out.shape) if isinstance(out, torch.Tensor) else ()
        self.names.append((str(func), shape))
        return out

    def count(self, pred) -> int:
        return sum(1 for name, shape in self.names if pred(name, shape))


# (policy, fast softmax): the two new policies, and the fast softmax's
# backward under the default policy
POLICY_CASES = [("attn", False), ("mlp", False), ("attn_out", True)]
CHUNK, FRAMES = 4, 12


@functools.lru_cache(maxsize=None)
def _tower_grads(policy, fast=False, bf16=False):
    """The remat-chunked train encode's loss (a random weighting of the
    features, fp32) and gradients: the port under ``policy`` and under
    ``full``, and the JAX package under ``policy``, from the same weights
    (bf16 compute with ``bf16``); and the operators the port's forward and
    backward ran."""
    kw = dict(encode_chunk=CHUNK, train_encode_chunk=CHUNK)
    jm, variables, tm = _carried(SWITCHES["fast_softmax"] if fast else {},
                                 bf16, train_remat_policy=policy, **kw)
    rng = np.random.default_rng(8)
    frames = rng.uniform(size=(FRAMES // T, T, IMG, IMG, 3)).astype(
        np.float32)
    W = rng.normal(size=(FRAMES // T, T, D)).astype(np.float32)

    def jloss(params):
        out = jm.apply({**variables, "params": params}, jnp.asarray(frames),
                       train=True, method=jm.encode)
        return jnp.sum(out.astype(jnp.float32) * W)

    jl, jg = jax.value_and_grad(jloss)(variables["params"])
    jg = weights.model_state_dict({"params": jax.tree_util.tree_map(
        lambda g: np.asarray(g, np.float32), jg)})
    out = {"jax": (float(jl), jg)}
    for p in (policy, "full"):
        tm.zero_grad()
        tm.train_remat_policy = p
        tm.train()
        with _Ops() as fwd:
            feats = tm.encode(torch.from_numpy(frames))
            loss = ((feats.float() if bf16 else feats)
                    * torch.from_numpy(W)).sum()
        with _Ops() as bwd:
            loss.backward()
        out[p] = (loss.item(), {k: v.grad.clone() for k, v in
                                tm.named_parameters() if v.grad is not None},
                  fwd, bwd)
    return out


@pytest.mark.parametrize("policy,fast", POLICY_CASES,
                         ids=[f"{p}{'-fast' if f else ''}"
                              for p, f in POLICY_CASES])
def test_remat_policy_loss_and_grads_match_full_and_jax(policy, fast):
    out = _tower_grads(policy, fast)
    loss, grads = out[policy][:2]
    assert grads and all(k.startswith("backbone.") for k in grads)
    for other in ("full", "jax"):
        np.testing.assert_allclose(loss, out[other][0], rtol=2e-5,
                                   atol=2e-5, err_msg=other)
        for k, g in grads.items():
            torch.testing.assert_close(g, out[other][1][k], rtol=5e-4,
                                       atol=5e-5, msg=f"{other}: {k}")


def _rel_diff(got, want) -> float:
    """``|got - want| / |want|`` over all the gradients of ``got``
    (Frobenius norms)."""
    num = sum(float(((g - torch.as_tensor(np.asarray(want[k]))) ** 2).sum())
              for k, g in got.items())
    den = sum(float((torch.as_tensor(np.asarray(want[k])) ** 2).sum())
              for k in got)
    return (num / den) ** 0.5


# bf16: four bf16 ulps at unit scale, of the whole gradient (measured on
# these inputs: 2e-3 to 6.5e-3 from full's, 7.5e-3 to 9.1e-3 from the JAX
# package's, which is 7.7e-3 to 9.3e-3 from full's)
BF16_GRAD_TOL = 4 * 2.0 ** -8


@pytest.mark.parametrize("policy,fast", POLICY_CASES,
                         ids=[f"{p}{'-fast' if f else ''}"
                              for p, f in POLICY_CASES])
def test_remat_policy_bf16_grads_match_full_and_jax(policy, fast):
    """At bf16 the gradients under ``policy`` are ``full``'s and the JAX
    package's within BF16_GRAD_TOL: the softmax's derivative is taken from
    its fp32 probabilities, recomputed from the kept scores, as the JAX
    package's remat recomputes them (``test_jax_attn_policy_recomputes_the_
    softmax``)."""
    out = _tower_grads(policy, fast, bf16=True)
    loss, grads = out[policy][:2]
    assert grads and all(g.dtype == torch.float32 for g in grads.values())
    for other in ("full", "jax"):
        np.testing.assert_allclose(loss, out[other][0], rtol=BF16_GRAD_TOL,
                                   err_msg=other)
        err = _rel_diff(grads, out[other][1])
        assert err <= BF16_GRAD_TOL, f"{other}: {err:.3e}"


@pytest.mark.parametrize("policy", ["attn", "mlp", "attn_out"])
def test_remat_policy_is_honoured_without_a_copy(policy):
    """What the backward recomputes (the forward operators that run again
    inside it), per chunk and block: ``attn`` none of its tags' operators
    (no softmax operator, no ``probs @ v``; the softmax's backward takes
    its derivative from the scores), ``mlp`` no gelu and no attention,
    ``attn_out`` no attention; ``c_fc`` under every one of them (``full``
    recomputes everything). The forward makes no copy of a tagged
    tensor."""
    out = _tower_grads(policy)
    fwd, bwd = out[policy][2:]
    blocks = -(-FRAMES // CHUNK) * J_ARCHS["test-tiny"].vision_layers
    width = 4 * J_ARCHS["test-tiny"].vision_width
    ops = {"probs": lambda n, s: n == "clipspm.attn_probs.default",
           "probs @ v": lambda n, s: n == "clipspm.attn_out.default",
           "sdpa": lambda n, s: "scaled_dot_product" in n
           and "backward" not in n,
           "gelu": lambda n, s: n == "clipspm.mlp_gelu.default",
           "c_fc": lambda n, s: n == "aten.addmm.default"
           and s[-1] == width}
    ran = {k: fwd.count(p) for k, p in ops.items()}
    again = {k: bwd.count(p) for k, p in ops.items()}
    full = {k: out["full"][3].count(p) for k, p in ops.items()}
    spelled = policy == "attn"
    assert ran == {"probs": blocks * spelled, "probs @ v": blocks * spelled,
                   "sdpa": blocks * (not spelled),
                   "gelu": blocks * (policy == "mlp"), "c_fc": blocks}
    assert again == {"probs": 0, "probs @ v": 0, "sdpa": 0, "gelu": 0,
                     "c_fc": blocks}
    assert full["sdpa"] == full["c_fc"] == blocks
    copies = fwd.count(lambda n, s: any(c in n for c in (
        "clone", "copy_", "_to_copy")))
    assert copies == 0


@pytest.mark.parametrize("fast", [False, True], ids=["softmax", "fast"])
def test_jax_attn_policy_recomputes_the_softmax(fast):
    """The JAX package under ``attn`` keeps the cast probabilities, not the
    fp32 ones its softmax's derivative needs, so its backward recomputes
    the exponentials from the scores: one more ``exp`` in the gradient than
    without remat. The port's ``attn_probs`` backward does the same from
    the scores it keeps."""
    from clipspm_tpu.models.backbones.clip import ResidualAttentionBlock

    width = J_ARCHS["test-tiny"].vision_width
    block = ResidualAttentionBlock(width, 1, fast_softmax=fast)
    x = jnp.ones((2, 17, width))
    v = block.init(jax.random.PRNGKey(0), x)
    policy = jax.checkpoint_policies.save_only_these_names("attn_probs",
                                                           "attn_out")

    def exps(f):
        text = str(jax.make_jaxpr(jax.grad(f))(v, x))
        return sum(1 for line in text.splitlines()
                   if re.search(r"= exp\b", line))

    plain = exps(lambda p, x: block.apply(p, x).sum())
    remat = exps(jax.checkpoint(lambda p, x: block.apply(p, x).sum(),
                                policy=policy))
    assert (plain, remat) == (1, 2)


def test_jax_mlp_policy_recomputes_c_fc_too():
    """The JAX package under ``mlp`` keeps only ``attn_out`` and
    ``mlp_gelu`` of a block, so its backward recomputes ``c_fc`` (whose
    output the gelu's derivative needs) as the port's does: one more
    ``[.., 4 * width]`` product in the gradient than without remat (the
    other one is ``c_proj``'s input gradient)."""
    from clipspm_tpu.models.backbones.clip import ResidualAttentionBlock

    width = J_ARCHS["test-tiny"].vision_width
    block = ResidualAttentionBlock(width, 1)
    x = jnp.ones((2, 17, width))
    v = block.init(jax.random.PRNGKey(0), x)
    policy = jax.checkpoint_policies.save_only_these_names("attn_out",
                                                           "mlp_gelu")

    def wide_products(f):
        text = str(jax.make_jaxpr(jax.grad(f))(v, x))
        return sum(1 for line in text.splitlines() if "dot_general" in line
                   and f"f32[2,17,{4 * width}] =" in line)

    plain = wide_products(lambda p, x: block.apply(p, x).sum())
    remat = wide_products(jax.checkpoint(
        lambda p, x: block.apply(p, x).sum(), policy=policy))
    assert (plain, remat) == (2, 3)


# -- the slice: cached evaluation and the CLI ---------------------------------

EPISODES = 12
SWITCH_OPTS = ["MODEL.FAST_SOFTMAX=true", "MODEL.BF16_NORMS=true",
               "MODEL.INT8_EVAL=true"]
EVAL_OPTS = ["MODEL.BACKBONE=test-tiny", "TRAIN.SHOT=2", "TEST.ONLY_TEST=true",
             "TEST.CACHE_FEATURES=true", f"TEST.TEST_EPISODES={EPISODES}",
             "TEST.QUERY_PER_CLASS=2", "TEST.CACHE_EVAL_BATCH=5",
             "TEST.CACHE_ENCODE_VIDEOS=8", "DATA.NUM_WORKERS=2",
             "DATA.IMG_NORM=true", "MODEL.ENCODE_CHUNK=5", *SWITCH_OPTS]


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    pytest.importorskip("PIL.Image")
    root = str(tmp_path_factory.mktemp("vit_switches"))
    cfg_path = make_dataset(root, classes=4, videos=5, frames=6, size=96,
                            img_size=32, seq_len=4)
    return root, cfg_path


def test_switched_cached_eval_matches_jax(split):
    root, cfg_path = split
    jcfg = jax_load(cfg_path, opts=EVAL_OPTS, splits_root=root)
    jl = jax_build(jcfg, log_fn=lambda *_: None, allow_random_weights=True)
    jl.test_source.close()
    want = jax_evaluate(jcfg, jl, log_fn=lambda *_: None)
    st = jl.state
    cfg = load_config(cfg_path, opts=EVAL_OPTS, splits_root=root)
    learner = build_learner(cfg, log_fn=lambda *_: None, device="cpu",
                            allow_random_weights=True)
    arch = learner.model.arch
    assert (arch.fast_softmax, arch.bf16_norms, arch.int8_eval) == (
        True, True, True)
    learner.model.load_state_dict(weights.model_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, st.params)}),
        strict=True)
    learner.text_train = torch.from_numpy(np.array(st.text_train))
    learner.text_test = torch.from_numpy(np.array(st.text_test))
    got = evaluate_cached(cfg, learner, log_fn=lambda *_: None)
    assert got["unique_videos"] == want["unique_videos"]
    assert got["accuracy"] == want["accuracy"]
    assert got["confidence"] == want["confidence"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-3)


@pytest.mark.parametrize("policy", ["attn", "mlp"])
def test_cli_trains_under_the_policy_with_switches(split, tmp_path, policy):
    """The CLI trains test-tiny in remat chunks under ``policy`` with the
    three switches and validates through the cache, the int8 product
    running in validation only."""
    root, cfg_path = split
    ckpt = str(tmp_path / "ckpt")
    plain, calls = quant.int8_mm_plain, []

    def counted(a, b):
        calls.append(a.shape)
        return plain(a, b)

    quant.int8_mm_plain = counted
    try:
        res = port_cli(["--cfg", cfg_path, "--splits-root", root, "--device",
                        "cpu", "--allow-random-weights",
                        "MODEL.BACKBONE=test-tiny", "TEST.CACHE_FEATURES=true",
                        "TEST.TEST_EPISODES=4", "DATA.NUM_WORKERS=2",
                        f"CHECKPOINT.CHECKPOINT_DIR={ckpt}",
                        "MODEL.TRAIN_ENCODE_CHUNK=5",
                        f"MODEL.TRAIN_REMAT_POLICY={policy}",
                        "TRAIN.TRAIN_EPISODES=8", "TRAIN.VAL_FREQ=4",
                        "TRAIN.PRINT_FREQ=4", *SWITCH_OPTS])
    finally:
        quant.int8_mm_plain = plain
    assert res["episodes"] == 8
    with open(os.path.join(ckpt, "log.txt")) as f:
        log = f.read()
    tasks = re.findall(r"Task \[(\d+)/8\], Train Loss: (\S+),", log)
    assert [int(t) for t, _ in tasks] == [4, 8]
    assert all(np.isfinite(float(v)) for _, v in tasks)
    assert "Val @ 4: acc" in log
    # validation's table encode: 4 projections x 2 blocks per tower call
    assert calls and len(calls) % 8 == 0
