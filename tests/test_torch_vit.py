"""The port's ViT visual tower against the JAX package.

The same weights (carried across by ``clipspm_tpu_torch.weights``) and the
same numpy inputs go through the flax ``VisionTransformer`` and the port's,
in fp32, at ``test-tiny`` and at a ViT-B/16 cut to 2 layers (the real 14x14+1
token grid, width 768, 12 heads); the OpenAI-key round trip and the
architecture inferred from a state dict; the chunked-encode defaults of
``build_model``, case by case against the JAX package's; and the
remat-chunked train encode against the unchunked one, for each remat policy
the port honours.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from clipspm_tpu.models.backbones import clip as jclip
from clipspm_tpu.models.backbones.torch_import import (
    convert_clip_state_dict, infer_arch_from_state_dict as jax_infer)
from clipspm_tpu.models.fsar import build_model as jax_build_model
from clipspm_tpu.utils.config import ConfigNode as JConfig
from clipspm_tpu.utils.config import SPM_DEFAULT_PARAMS
from clipspm_tpu_torch import weights
from clipspm_tpu_torch.models.backbones import clip as tclip
from clipspm_tpu_torch.models.fsar import CLIPSPMModel, build_model
from clipspm_tpu_torch.train.setup import infer_arch_from_state_dict
from clipspm_tpu_torch.utils.config import ConfigNode

torch.set_num_threads(2)

# ViT-B/16 cut to 2 layers: the real token grid and head count
VIT_B16_CUT = (512, 224, 2, 768, 16)
ARCHS = {"test-tiny": tuple(getattr(jclip.CLIP_ARCHS["test-tiny"], f)
                            for f in ("embed_dim", "image_resolution",
                                      "vision_layers", "vision_width",
                                      "vision_patch_size")),
         "vit-b16-cut": VIT_B16_CUT}


def _port_arch(jarch) -> tclip.CLIPArch:
    return tclip.CLIPArch(*[getattr(jarch, f.name)
                            for f in dataclasses.fields(tclip.CLIPArch)])


def _rel(got, want) -> float:
    got = torch.as_tensor(np.array(got), dtype=torch.float64)
    want = torch.as_tensor(np.array(want), dtype=torch.float64)
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_vit_tower_forward_and_grads_match_flax(name):
    """Eval output to 1e-4 (relative and absolute); the gradient of a
    random weighting of the output for every visual parameter and the
    frames to 1e-4 relative a tensor. fp32, sums in another order (XLA vs
    oneDNN); the port's attention is ``scaled_dot_product_attention``."""
    small = dict(context_length=16, vocab_size=600, transformer_width=32,
                 transformer_heads=2, transformer_layers=1)
    jarch = jclip.CLIPArch(*ARCHS[name], **small)
    jm = jclip.build_clip(jarch)
    v = jax.tree_util.tree_map(
        np.asarray, jclip.init_clip_params(jm, jax.random.PRNGKey(0)))
    tm = tclip.CLIPModel(_port_arch(jarch))
    tm.load_state_dict(weights.clip_state_dict(v), strict=True)
    assert isinstance(tm.visual, tclip.VisionTransformer)
    R = jarch.image_resolution
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (2, R, R, 3)).astype(np.float32)
    W = rng.normal(size=(2, jarch.embed_dim)).astype(np.float32)

    def f(params, x):
        out = jm.apply({"params": params}, x, method=jm.encode_image)
        return jnp.sum(out * W), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(img))
    tm.eval()
    x = torch.from_numpy(img).requires_grad_(True)
    got = tm.encode_image(x)
    (got * torch.from_numpy(W)).sum().backward()
    assert got.shape == want.shape == (2, jarch.embed_dim)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    assert _rel(x.grad, gx) <= 1e-4
    gsd = weights.clip_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, gp)})
    n = 0
    for k, p in tm.named_parameters():
        if k.startswith("visual."):
            assert _rel(p.grad, gsd[k]) <= 1e-4, k
            n += 1
    assert n == 8 + 12 * jarch.vision_layers


def test_vit_weights_round_trip_is_bit_exact():
    """port state dict -> JAX convert_clip_state_dict -> weights.py -> the
    same tensors, OpenAI's ViT keys throughout."""
    model = tclip.CLIPModel(tclip.CLIP_ARCHS["test-tiny"])
    weights.random_init_(model, torch.Generator().manual_seed(3))
    sd = model.state_dict()
    for key in ("visual.conv1.weight", "visual.class_embedding",
                "visual.positional_embedding", "visual.proj",
                "visual.ln_pre.weight", "visual.ln_post.bias",
                "visual.transformer.resblocks.1.attn.in_proj_weight"):
        assert key in sd, key
    arch, jvars = convert_clip_state_dict(sd)
    assert arch.is_vit and arch.vision_patch_size == 8
    back = weights.clip_state_dict(jvars)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


@pytest.mark.parametrize("name", ["ViT-B/16", "ViT-B/32", "ViT-L/14",
                                  "ViT-L/14@336px", "test-tiny", "RN50"])
def test_infer_arch_from_state_dict_matches_torch_import(name):
    """Shapes only (the model on the meta device): the port's inference
    against the JAX importer's, field by field; a released architecture
    comes back as itself (the test archs' text heads are not width // 64)."""
    with torch.device("meta"):
        sd = tclip.CLIPModel(tclip.CLIP_ARCHS[name]).state_dict()
    got, want = infer_arch_from_state_dict(sd), jax_infer(sd)
    for f in dataclasses.fields(tclip.CLIPArch):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    if not name.startswith("test-"):
        assert got == tclip.CLIP_ARCHS[name]


def test_random_init_gives_vit_embeddings_the_jax_scale():
    """``class_embedding``, ``positional_embedding`` and ``proj`` at
    ``width**-0.5 N(0, 1)`` (std within 3% over ViT-B/16's 151,296
    positional entries), as the JAX package initialises them."""
    vit = tclip.VisionTransformer(224, 16, 768, 1, 12, 512)
    weights.random_init_(vit, torch.Generator().manual_seed(0))
    for p in (vit.class_embedding, vit.positional_embedding, vit.proj):
        assert float(p.std()) == pytest.approx(768 ** -0.5, rel=0.03)
        assert abs(float(p.mean())) < 0.01
    jv = jclip.VisionTransformer(32, 8, 768, 1, 12, 512).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    for k in ("class_embedding", "proj"):
        assert float(jnp.std(jv[k])) == pytest.approx(768 ** -0.5, rel=0.1)


# -- build_model's chunk defaults ---------------------------------------------

def _cfgs(backbone, name="clipspm", **model_extra):
    d = {"MODEL": dict({"NAME": name, "BACKBONE": backbone}, **model_extra),
         "TRAIN": {"WAY": 2, "SHOT": 1},
         "DATA": {"SEQ_LEN": 4, "NUM_CLASS": 8}}
    jcfg, tcfg = JConfig(d), ConfigNode(d)
    jcfg.params = tcfg.params = dict(SPM_DEFAULT_PARAMS["hmdb"])
    return jcfg, tcfg


CHUNK_CASES = {
    "vit-b16 defaults": dict(backbone="ViT-B/16"),
    "rn50 defaults": dict(backbone="RN50"),
    "test-tiny defaults": dict(backbone="test-tiny"),
    "remat full": dict(backbone="ViT-B/16", TRAIN_REMAT_POLICY="full"),
    "remat dots": dict(backbone="ViT-B/16", TRAIN_REMAT_POLICY="dots"),
    "both off": dict(backbone="ViT-B/16", ENCODE_CHUNK=0,
                     TRAIN_ENCODE_CHUNK=False),
    "train true": dict(backbone="ViT-B/16", TRAIN_ENCODE_CHUNK=True),
    "train 24": dict(backbone="ViT-B/16", TRAIN_ENCODE_CHUNK=24),
    "rn50 eval true": dict(backbone="RN50", ENCODE_CHUNK=True),
    "train true, eval off": dict(backbone="ViT-B/16", ENCODE_CHUNK=0,
                                 TRAIN_ENCODE_CHUNK=True),
    "test-tiny train 4": dict(backbone="test-tiny", ENCODE_CHUNK=3,
                              TRAIN_ENCODE_CHUNK=4),
}


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunk_defaults_match_jax(case):
    jcfg, tcfg = _cfgs(**CHUNK_CASES[case])
    want, got = jax_build_model(jcfg), build_model(tcfg)
    assert (got.encode_chunk, got.train_encode_chunk,
            got.train_remat_policy) == (want.encode_chunk,
                                        want.train_encode_chunk,
                                        want.train_remat_policy)


@pytest.mark.parametrize("backbone,name", [("RN50", "clipspm"),
                                           ("test-tiny-rn", "clipspm"),
                                           ("resnet50", "ta2n")])
def test_train_chunk_rejected_for_batchnorm_backbones(backbone, name):
    for cfg, build in zip(_cfgs(backbone, name, TRAIN_ENCODE_CHUNK=True),
                          (jax_build_model, build_model)):
        with pytest.raises(ValueError, match="BatchNorm"):
            build(cfg)


def test_full_width_vit_b16_model():
    _, tcfg = _cfgs("ViT-B/16")
    with torch.device("meta"):
        m = build_model(tcfg)
    assert isinstance(m.backbone, tclip.VisionTransformer)
    assert m.backbone.positional_embedding.shape == (197, 768)
    assert len(m.backbone.transformer.resblocks) == 12
    assert m.backbone.transformer.resblocks[0].attn.n_head == 12
    assert m.backbone.proj.shape == (768, 512)
    assert m.head.dim == 512             # the head runs at the embed width
    assert (m.encode_chunk, m.train_encode_chunk, m.train_remat_policy) \
        == (30, 40, "attn_out")


# -- the remat-chunked train encode -------------------------------------------

class _CountRecompute(TorchDispatchMode):
    """Counts the attention forward ops that run (inside ``backward()``
    these are recomputes)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if "scaled_dot_product" in name and "backward" not in name:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("train_chunk,policy", [
    (True, "full"), (4, "full"), (4, "attn_out"), (5, "attn_out"),
    (4, "dots"), (4, "attn"), (4, "mlp")])
def test_train_chunked_forward_and_grads_match_unchunked(train_chunk, policy):
    """``tests/test_train_encode_chunk.py`` for the port: test-tiny, 16
    frames in chunks of 3 (``True`` reuses the eval width), 4 or 5 (with 4
    frames of padding); the loss to 2e-5 and every gradient to rtol 5e-4 /
    atol 5e-5. The policy is honoured: ``attn_out`` and ``mlp`` recompute no
    attention in the backward (``attn`` spells it out and keeps its
    probabilities and output), ``full`` and ``dots`` recompute every
    block's."""
    arch = tclip.CLIP_ARCHS["test-tiny"]
    kw = dict(arch=arch, way=2, shot=1, spm=SPM_DEFAULT_PARAMS["hmdb"])
    m0 = weights.random_init_(CLIPSPMModel(**kw),
                              torch.Generator().manual_seed(0))
    m1 = CLIPSPMModel(**kw, encode_chunk=3, train_encode_chunk=train_chunk,
                      train_remat_policy=policy)
    m1.load_state_dict(m0.state_dict())
    S, Q, T, img, D = 2, 2, 4, 32, arch.embed_dim
    rng = np.random.default_rng(0)
    args = (torch.from_numpy(rng.uniform(size=(S, T, img, img, 3))).float(),
            torch.from_numpy(rng.uniform(size=(Q, T, img, img, 3))).float(),
            torch.arange(S) % 2, torch.zeros(S, dtype=torch.long),
            torch.zeros(Q, dtype=torch.long),
            torch.from_numpy(rng.normal(size=(8, D))).float(),
            torch.from_numpy(rng.normal(size=(8, D))).float())
    losses, grads, recomputed = [], [], []
    for m in (m0, m1):
        m.train()
        for mod in m.modules():
            if isinstance(mod, torch.nn.Dropout):
                mod.p = 0.0
        out = m(*args)
        loss = out["logits"].sum() + out["dists"]
        with _CountRecompute() as count:
            loss.backward()
        losses.append(float(loss))
        grads.append({k: p.grad for k, p in m.named_parameters()
                      if p.grad is not None})
        recomputed.append(count.n)
    np.testing.assert_allclose(losses[1], losses[0], rtol=2e-5, atol=2e-5)
    assert set(grads[0]) == set(grads[1])
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, rtol=5e-4, atol=5e-5,
                                   msg=k)
    width = 3 if train_chunk is True else train_chunk
    chunks = -(-16 // width)
    assert recomputed[0] == 0
    assert recomputed[1] == (0 if policy in ("attn_out", "attn", "mlp")
                             else chunks * arch.vision_layers)


def test_unknown_remat_policy_raises():
    """A policy the JAX package does not know raises its ``ValueError``
    (every one it knows is honoured: ``attn`` and ``mlp`` in
    ``tests/test_torch_vit_switches.py``)."""
    _, tcfg = _cfgs("test-tiny", TRAIN_ENCODE_CHUNK=4,
                    TRAIN_REMAT_POLICY="everything")
    with pytest.raises(ValueError, match="unknown"):
        build_model(tcfg)
