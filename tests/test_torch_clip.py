"""Port CLIP towers, tokenizer and weight bridge against the JAX package.

The same weights (carried across by ``clipspm_tpu_torch.weights``) and the
same numpy inputs go through the flax ``CLIPModel`` and the port, in fp32.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from clipspm_tpu.models.backbones import clip as jclip
from clipspm_tpu.models.backbones import tokenizer as jtok
from clipspm_tpu.models.backbones.torch_import import convert_clip_state_dict
from clipspm_tpu_torch import weights
from clipspm_tpu_torch.models.backbones import clip as tclip
from clipspm_tpu_torch.models.backbones import tokenizer as ttok

torch.set_num_threads(2)

ARCH = "test-tiny-rn"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _randomize_stats(tree, rng):
    """Non-trivial BatchNorm running stats, so eval-mode BN is exercised."""
    if isinstance(tree, dict):
        return {k: _randomize_stats(v, rng) if k not in ("mean", "var") else
                (rng.normal(0, 0.1, np.shape(v)) if k == "mean"
                 else rng.uniform(0.5, 1.5, np.shape(v))).astype(np.float32)
                for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def both_models():
    rng = np.random.default_rng(0)
    jmodel = jclip.build_clip(ARCH)
    variables = jax.tree_util.tree_map(
        np.asarray, jclip.init_clip_params(jmodel, jax.random.PRNGKey(0)))
    variables = {"params": variables["params"],
                 "batch_stats": _randomize_stats(variables["batch_stats"],
                                                 rng)}
    tmodel = tclip.CLIPModel(tclip.CLIP_ARCHS[ARCH])
    tmodel.load_state_dict(weights.clip_state_dict(variables), strict=True)
    tmodel.eval()
    return jmodel, variables, tmodel


def test_resnet_encode_matches_flax(both_models):
    jmodel, variables, tmodel = both_models
    img = np.random.default_rng(1).uniform(0, 1, (3, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(img),
                                   method=jmodel.encode_image))
    with torch.no_grad():
        got = tmodel.encode_image(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (3, 64)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_encode_text_matches_flax(both_models):
    jmodel, variables, tmodel = both_models
    rng = np.random.default_rng(2)
    toks = np.zeros((4, 16), np.int32)
    for i, n in enumerate((3, 7, 16, 1)):
        toks[i, :n] = rng.integers(1, 598, n)
        toks[i, n - 1] = 599      # EOT: the highest id of the row
    want = np.asarray(jmodel.apply(variables, jnp.asarray(toks),
                                   method=jmodel.encode_text))
    with torch.no_grad():
        got = tmodel.encode_text(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_class_text_tables_match_flax(both_models):
    from clipspm_tpu.models.text_features import \
        encode_class_text_tables as jtables
    from clipspm_tpu_torch.models.text_features import \
        encode_class_text_tables as ttables

    jmodel, variables, tmodel = both_models
    lists = [["brush hair", "cartwheel", "catch"], ["climb", "dive"]]
    want = jtables(jmodel, variables, lists, batch_size=16)
    got = ttables(tmodel, lists, batch_size=16)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_tokenizer_ids_equal_on_every_class_name():
    with open(os.path.join(REPO, "configs", "class_names.yaml")) as f:
        table = yaml.safe_load(f)
    names = sorted({n for split in table.values() for names in split.values()
                    for n in names})
    assert len(names) > 100
    jt, tt = jtok.SimpleTokenizer(), ttok.SimpleTokenizer()
    assert jt.using_openai_vocab and tt.using_openai_vocab
    np.testing.assert_array_equal(
        ttok.tokenize(names, tokenizer=tt, truncate=True),
        jtok.tokenize(names, tokenizer=jt, truncate=True))


def test_weights_round_trip_is_bit_exact():
    """port state dict -> JAX convert_clip_state_dict -> weights.py -> the
    same tensors."""
    model = tclip.CLIPModel(tclip.CLIP_ARCHS[ARCH])
    weights.random_init_(model, torch.Generator().manual_seed(3))
    sd = model.state_dict()
    # non-trivial running stats survive the trip too
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = torch.rand(sd[k].shape) + 0.5
    _, jvars = convert_clip_state_dict(sd)
    back = weights.clip_state_dict(jvars)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype, k
        assert torch.equal(back[k], v), k


def test_openai_state_dict_file_loads_into_openai_keys(tmp_path, monkeypatch):
    """A local ``RN50.pt`` (a state dict in OpenAI's key layout) is found,
    refused when it is not the official release, and loaded bit-exact when
    the integrity check is waived."""
    from clipspm_tpu_torch.train.setup import build_clip_variables

    model = tclip.CLIPModel(tclip.CLIP_ARCHS[ARCH])
    weights.random_init_(model, torch.Generator().manual_seed(4))
    torch.save(model.state_dict(), tmp_path / "RN50.pt")
    monkeypatch.setenv("CLIP_WEIGHTS_DIR", str(tmp_path))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="integrity"):
        build_clip_variables("RN50", gen)
    monkeypatch.setenv("CLIPSPM_SKIP_WEIGHT_VERIFY", "1")
    loaded, pretrained = build_clip_variables("RN50", gen)
    assert pretrained
    arch, want = loaded.arch, tclip.CLIP_ARCHS[ARCH]
    assert (arch.embed_dim, arch.vision_layers, arch.vision_width,
            arch.context_length, arch.vocab_size, arch.transformer_layers) \
        == (want.embed_dim, want.vision_layers, want.vision_width,
            want.context_length, want.vocab_size, want.transformer_layers)
    got = loaded.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(got[k], v), k
