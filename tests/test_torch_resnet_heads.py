"""The port's five ResNet heads (otam, trx, strm, soap, molo) against the JAX
package, module by module and whole, plus their loss branches.

Sizes: ``test-tiny-resnet`` (ResNet-18 at width 8, feature width 64) at
64-px crops, so the trunk's maps are 2x2; T=4; 2-way, 1 or 2 shots; fp32,
evaluation unless a test says otherwise. Weights are drawn at random over
the trees flax's init makes (every norm, every bias and the parameters that
start at a constant, strm's ``gamma``, soap's ``lmd`` and molo's scales,
included, so that each path matters) and carried by
``weights.head_state_dict`` / ``model_state_dict``. otam's JAX OTAM runs its scan path, as the JAX tests run it on the
CPU. Tolerance: fp32 on both sides, sums in another order (XLA vs oneDNN):
1e-4 relative and absolute unless a test states otherwise.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipspm_tpu.models import blocks as jblocks
from clipspm_tpu.models.heads import molo as jmolo
from clipspm_tpu.models.heads import otam as jotam
from clipspm_tpu.models.heads import soap as jsoap
from clipspm_tpu.models.heads import strm as jstrm
from clipspm_tpu.models.heads import trx as jtrx
from clipspm_tpu.train.losses import loss_and_acc as jax_loss_and_acc
from clipspm_tpu.utils.config import ConfigNode as JConfig
from clipspm_tpu_torch import weights
from clipspm_tpu_torch.models import blocks as tblocks
from clipspm_tpu_torch.models.heads import molo as tmolo
from clipspm_tpu_torch.models.heads import otam as totam
from clipspm_tpu_torch.models.heads import soap as tsoap
from clipspm_tpu_torch.models.heads import strm as tstrm
from clipspm_tpu_torch.models.heads import trx as ttrx
from clipspm_tpu_torch.train.losses import loss_and_acc
from clipspm_tpu_torch.utils.config import ConfigNode

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
WAY, T, PX, D = 2, 4, 64, 64


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _draw(tree, rng, stats=False):
    """Values for a tree of shapes: kernels ``N(0, 1/fan_in)`` (flax's
    lecun-normal scale), norm scales and the parameters that start at a
    constant (strm's ``gamma``, soap's ``lmd``, molo's scales) uniform,
    biases ``N(0, 0.1)``, BatchNorm statistics around (0, 1), anything else
    (otam's token bank, molo's class tokens) ``N(0, 1/D)``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _draw(v, rng, stats)
            continue
        shape = tuple(v.shape)
        if stats:
            x = (rng.uniform(0.5, 2.0, shape) if k == "var"
                 else rng.normal(0, 0.2, shape))
        elif k == "kernel":
            x = rng.normal(0, np.prod(shape[:-1]) ** -0.5, shape)
        elif k == "scale" and len(shape) == 1:
            x = rng.uniform(0.5, 1.5, shape)
        elif k in ("gamma", "lmd", "scale", "scale_motion"):
            x = rng.uniform(0.3, 0.8, shape)
        elif k == "bias":
            x = rng.normal(0, 0.1, shape)
        else:
            x = rng.normal(0, shape[-1] ** -0.5, shape)
        out[k] = np.asarray(x, np.float32)
    return out


def _variables(module, *args, seed=0, **kwargs):
    """The module's variables, drawn with numpy over the tree of shapes
    that flax's init would make (``jax.eval_shape``: an eager flax init of
    a whole model takes tens of seconds on the CPU)."""
    shapes = jax.eval_shape(
        lambda *a: module.init(jax.random.PRNGKey(0), *a, **kwargs),
        *[jnp.asarray(a) for a in args])
    rng = np.random.default_rng(seed + 100)
    out = {"params": _draw(shapes.get("params", {}), rng)}
    if "batch_stats" in shapes:
        out["batch_stats"] = _draw(shapes["batch_stats"], rng, stats=True)
    return out


def _apply(module, variables, *args, **kwargs):
    """``module.apply`` under ``jax.jit`` (one XLA compile: an eager apply
    compiles every op on its own, several times slower here)."""
    return jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(
        variables, *[jnp.asarray(a) for a in args])


def _port(module, variables):
    module.load_state_dict(weights.head_state_dict(
        variables["params"], stats=variables.get("batch_stats")),
        strict=True)
    return module.eval()


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **tol)


def _feats(rng, *shape):
    """Features with a per-row offset: rows of i.i.d. noise alone are
    nearly orthogonal, so cosine tables would be near-constant."""
    base = rng.normal(size=shape[:1] + (1,) * (len(shape) - 2)
                      + shape[-1:])
    return (base + 0.5 * rng.normal(size=shape)).astype(np.float32)


def _labels(shot, rng):
    return rng.permutation(np.repeat(np.arange(WAY), shot)).astype(np.int32)


# -- blocks: molo's transformer and positional encoder -------------------------

def _self_attention(rng):
    return (jblocks.SelfAttention(dim=16, heads=2, dim_head=8),
            tblocks.SelfAttention(16, heads=2, dim_head=8),
            (_feats(rng, 3, 5, 16),))


def _transformer_v2(rng):
    return (jblocks.TransformerV2(dim=16, heads=2, dim_head_k=8, mlp_dim=32,
                                  depth=2),
            tblocks.TransformerV2(16, heads=2, dim_head_k=8, mlp_dim=32,
                                  depth=2),
            (_feats(rng, 3, 5, 16),))


def _positional_encoder(rng):
    # a no-parameter module: an empty tree carries nothing
    return (jblocks.PositionalEncoder(dim=16, scale_a=7.0, scale_b=0.5),
            tblocks.PositionalEncoder(16, scale_a=7.0, scale_b=0.5),
            (_feats(rng, 3, 9, 16),))


@pytest.mark.parametrize("case", [_self_attention, _transformer_v2,
                                  _positional_encoder],
                         ids=["self_attention", "transformer_v2",
                              "positional_encoder"])
def test_molo_blocks_match_jax(case):
    jmod, tmod, args = case(np.random.default_rng(0))
    variables = _variables(jmod, *args)
    if variables["params"]:
        tmod = _port(tmod, variables)
    tmod.eval()
    with torch.no_grad():
        _close(tmod(*_t(*args)), _apply(jmod, variables, *args), TOL)


def test_sinusoidal_positions_are_the_channel_index_table():
    np.testing.assert_array_equal(tblocks.sinusoidal_positions(20, 33),
                                  jblocks.sinusoidal_positions(20, 33))
    table = tblocks.sinusoidal_positions(5, 8)
    # channel 2's frequency uses i = 2 (the channel), not the pair index 1
    np.testing.assert_allclose(table[3, 2], np.sin(3 / 10000 ** (4 / 8)),
                               rtol=1e-6)
    assert not np.allclose(table[:, :8], ttrx.trx_positional_table(5, 8) * 10)


# -- otam: MoTokens -------------------------------------------------------------

def test_motokens_matches_jax():
    """The bank of 49 tokens takes the query's 4 tokens (a 2x2 map) after
    the first frame; the class probabilities over the cosine table (1 shot
    here, 2 in the whole otam model below)."""
    shot = 1
    rng = np.random.default_rng(2)
    qu = _feats(rng, 3, T, 4, D)
    su = _feats(rng, WAY * shot, T, 4, D)
    labels = _labels(shot, rng)
    jmod = jotam.MoTokens(dim=D, tokens=49, way=WAY)
    variables = _variables(jmod, qu, su, labels)
    tmod = _port(totam.MoTokens(D, tokens=49, way=WAY), variables)
    assert tuple(tmod.mo.shape) == (1, 49, D)
    with torch.no_grad():
        got = tmod(*_t(qu, su, labels))
    assert got.shape == (1, 3, WAY)
    _close(got, _apply(jmod, variables, qu, su, labels))


def test_cosine_similarity_rows_matches_jax():
    rng = np.random.default_rng(4)
    x, y = _feats(rng, 5, 7), _feats(rng, 3, 7)
    y[1] = 0.0                              # a norm under the clamp
    _close(totam.cosine_similarity_rows(*_t(x, y)),
           jotam.cosine_similarity_rows(jnp.asarray(x), jnp.asarray(y)),
           dict(rtol=1e-6, atol=1e-6))


# -- trx: the cross-transformer ------------------------------------------------

@pytest.mark.parametrize("shot,set_size", [(1, 2), (2, 3)])
def test_temporal_cross_transformer_matches_jax(shot, set_size):
    """Tuples in ``itertools.combinations`` order, class-grouped by a
    shuffled label order, the fp32 key LayerNorm, scores and softmax."""
    rng = np.random.default_rng(5 + shot)
    sup = _feats(rng, WAY * shot, T, D)
    qry = _feats(rng, 3, T, D)
    labels = _labels(shot, rng)
    kw = dict(way=WAY, shot=shot, seq_len=T, in_dim=D, out_dim=24,
              set_size=set_size)
    jmod = jtrx.TemporalCrossTransformer(**kw)
    variables = _variables(jmod, sup, labels, qry)
    tmod = _port(ttrx.TemporalCrossTransformer(**kw), variables)
    assert tmod.tuples.index.tolist() == [
        i for c in __import__("itertools").combinations(range(T), set_size)
        for i in c]
    with torch.no_grad():
        _close(tmod(*_t(sup, labels, qry)),
               _apply(jmod, variables, sup, labels, qry))
    np.testing.assert_array_equal(ttrx.trx_positional_table(12, D),
                                  jtrx.trx_positional_table(12, D))


# -- strm -----------------------------------------------------------------------

@pytest.mark.parametrize("hw,out", [(7, 4), (2, 4), (5, 2)],
                         ids=["7x7_to_4x4", "2x2_to_4x4", "5x5_to_2x2"])
def test_adaptive_max_pool_matches_jax(hw, out):
    """7x7 -> 4x4 is the 224-px case (cells overlap), 2x2 -> 4x4 the tests'
    (each cell repeats)."""
    x = np.random.default_rng(6).normal(size=(3, 2, hw, hw, 5)).astype(
        np.float32)
    got = tstrm.adaptive_max_pool_2d(torch.from_numpy(x), out, out)
    want = jstrm.adaptive_max_pool_2d(jnp.asarray(x), out, out)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _self_attn_bot(rng):
    x = _feats(rng, 5, 16, D)
    return (jstrm.SelfAttnBot(dim=D, seq_len=16), tstrm.SelfAttnBot(D, 16),
            (x,))


def _mlp_mix(rng):
    x = _feats(rng, 3, T, D)
    return (jstrm.MLPMixEnrich(dim=D, seq_len=T), tstrm.MLPMixEnrich(D, T),
            (x,))


def _tuple_distance(rng):
    sup, qry = _feats(rng, 4, T, D), _feats(rng, 3, T, D)
    kw = dict(way=WAY, shot=2, seq_len=T, in_dim=D, set_size=2)
    return (jstrm.TupleDistanceLoss(**kw), tstrm.TupleDistanceLoss(**kw),
            (sup, _labels(2, rng), qry))


@pytest.mark.parametrize("case", [_self_attn_bot, _mlp_mix, _tuple_distance],
                         ids=["self_attn_bot", "mlp_mix_enrich",
                              "tuple_distance"])
def test_strm_blocks_match_jax(case):
    jmod, tmod, args = case(np.random.default_rng(7))
    variables = _variables(jmod, *args)
    tmod = _port(tmod, variables)
    with torch.no_grad():
        _close(tmod(*_t(*args)), _apply(jmod, variables, *args))


# -- soap -----------------------------------------------------------------------

def _hmem(rng):
    return jsoap.HMEM(horizon=2), tsoap.HMEM(2), rng.uniform(
        size=(2, T, 8, 8, 3)).astype(np.float32)


def _prior(rng):
    return (jsoap.SOAPPrior(seq_len=T, horizons=(1, 2, 3), cr=4),
            tsoap.SOAPPrior(T, (1, 2, 3), cr=4),
            rng.uniform(size=(2, T, 8, 8, 3)).astype(np.float32))


@pytest.mark.parametrize("case", [_hmem, _prior], ids=["hmem", "prior"])
def test_soap_priors_match_jax(case):
    """HMEM's windows in reversed order; the three priors on pixels, with
    ``hm_lin`` mixing the horizons' 3 + 4 + 3 = 10 frames back to T."""
    jmod, tmod, clips = case(np.random.default_rng(8))
    variables = _variables(jmod, clips)
    tmod = _port(tmod, variables)
    with torch.no_grad():
        got = tmod(torch.from_numpy(clips))
    want = _apply(jmod, variables, clips)
    if isinstance(tmod, tsoap.HMEM):
        assert got.shape == (2, 2 * (T - 2), 8, 8, 3)
    _close(got, want)


def test_soap_t_loss_matches_jax():
    x = _feats(np.random.default_rng(9), 5, D)
    x[3] = x[1]                             # a zero distance, clamped
    got = tsoap.soap_t_loss(torch.from_numpy(x), torch.tensor(0.013))
    want = jsoap.soap_t_loss(jnp.asarray(x), jnp.asarray(0.013, jnp.float32))
    _close(got, want, dict(rtol=1e-5, atol=1e-7))
    assert 0.0 < float(got) < 1.0


# -- molo: the decoder ------------------------------------------------------------

@pytest.mark.parametrize("scale", [2, 4])
def test_upsample_bilinear_align_corners_matches_jax(scale):
    x = np.random.default_rng(10).normal(size=(3, 3, 5, 4)).astype(
        np.float32)
    _close(tmolo.upsample_bilinear_align_corners(torch.from_numpy(x), scale),
           jmolo.upsample_bilinear_align_corners(jnp.asarray(x), scale),
           dict(rtol=1e-5, atol=1e-6))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_up2_matches_jax(train):
    """In training, BatchNorm normalises by the batch statistics and folds
    flax's biased variance into the running one (momentum 0.9 there)."""
    x = np.random.default_rng(11).normal(1.0, 2.0, size=(3, 2, 2, 8)).astype(
        np.float32)
    jmod = jmolo.Up2(out_channels=6, scale=2)
    variables = _variables(jmod, x)
    tmod = _port(tmolo.Up2(8, 6, scale=2), variables).train(train)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    if not train:
        _close(got, _apply(jmod, variables, x))
        return
    want, new = _apply(jmod, variables, x, train=True,
                       mutable=["batch_stats"])
    _close(got, want)
    stats = new["batch_stats"]["bn"]
    _close(tmod.bn.running_mean, stats["mean"])
    _close(tmod.bn.running_var, stats["var"])
    assert not np.allclose(stats["var"],
                           variables["batch_stats"]["bn"]["var"])


# -- whole models -----------------------------------------------------------------

HEADS = {
    "otam": (lambda shot: jotam.OTAMModel(way=WAY, shot=shot, arch="resnet18",
                                          backbone_width=8),
             lambda shot: totam.OTAMModel(WAY, shot, arch="resnet18",
                                          backbone_width=8)),
    "trx": (lambda shot: jtrx.TRXModel(way=WAY, shot=shot, seq_len=T,
                                       temp_set=(2, 3), out_dim=24,
                                       arch="resnet18", backbone_width=8),
            lambda shot: ttrx.TRXModel(WAY, shot, seq_len=T, temp_set=(2, 3),
                                       out_dim=24, arch="resnet18",
                                       backbone_width=8)),
    "strm": (lambda shot: jstrm.STRMModel(way=WAY, shot=shot, seq_len=T,
                                          out_dim=24, arch="resnet18",
                                          backbone_width=8),
             lambda shot: tstrm.STRMModel(WAY, shot, seq_len=T, out_dim=24,
                                          arch="resnet18", backbone_width=8)),
    "soap": (lambda shot: jsoap.SOAPModel(way=WAY, shot=shot, seq_len=T,
                                          temp_set=(2, 3), out_dim=24,
                                          horizons=(1, 2, 3), cr=4,
                                          arch="resnet18", backbone_width=8),
             lambda shot: tsoap.SOAPModel(WAY, shot, seq_len=T,
                                          temp_set=(2, 3), out_dim=24,
                                          horizons=(1, 2, 3), cr=4,
                                          arch="resnet18", backbone_width=8)),
    "molo": (lambda shot: jmolo.MoLoModel(way=WAY, shot=shot, seq_len=T,
                                          arch="resnet18", backbone_width=8,
                                          num_class=10),
             lambda shot: tmolo.MoLoModel(WAY, shot, seq_len=T,
                                          arch="resnet18", backbone_width=8,
                                          num_class=10)),
}


def _episode(shot, seed):
    rng = np.random.default_rng(seed)

    def frames(n):
        # normalised frames, a colour per video plus noise: frames of
        # uniform noise in [0, 1) make the random trunk's videos nearly
        # collinear, and the logits' spread (2e-4) would sit under TOL
        base = rng.normal(size=(n, 1, 1, 1, 3))
        return (base + 0.3 * rng.normal(size=(n, T, PX, PX, 3))
                ).astype(np.float32)

    return frames(WAY * shot), frames(3), _labels(shot, rng)


@pytest.fixture(scope="module")
def carried():
    """``carried(name, shot)``: the JAX model, its drawn variables, the port
    model holding them, and an episode (built once a pair)."""
    built = {}

    def get(name, shot):
        if (name, shot) not in built:
            jnew, tnew = HEADS[name]
            ep = _episode(shot, seed=20 + shot)
            jmodel = jnew(shot)
            variables = _variables(jmodel, *ep)
            tmodel = tnew(shot)
            tmodel.load_state_dict(weights.model_state_dict(variables),
                                   strict=True)
            built[(name, shot)] = (jmodel, variables, tmodel.eval(), ep)
        return built[(name, shot)]

    return get


OUTPUT_KEYS = {
    "otam": {"logits", "mo_logits"}, "trx": {"logits"},
    "strm": {"logits", "logits_post_pat"}, "soap": {"logits", "t_loss"},
    "molo": {"logits", "logits_s2q", "logits_q2s", "logits_s2q_motion",
             "logits_q2s_motion", "loss_recons", "class_logits"},
}


# each head at one shot count (the multi-shot class grouping is also held
# module by module above); molo at 1 shot, its train forward's too
SHOTS = {"otam": 2, "trx": 2, "strm": 1, "soap": 2, "molo": 1}


@pytest.mark.parametrize("name", sorted(HEADS))
def test_model_outputs_match_jax(carried, name):
    """Every output of the evaluation forward; where the head is cacheable,
    ``encode`` against the JAX ``encode`` and encode + ``match_features``
    equal to the forward."""
    jmodel, variables, tmodel, ep = carried(name, SHOTS[name])
    want = _apply(jmodel, variables, *ep, train=False)
    sup, tgt, labels = _t(*ep)
    with torch.no_grad():
        got = tmodel(sup, tgt, labels)
    assert set(got) == set(want) == OUTPUT_KEYS[name]
    for key in want:
        _close(got[key], want[key])
    assert np.ptp(np.asarray(want["logits"])) > 1e-3
    cacheable = hasattr(jmodel, "feature_cacheable")
    assert hasattr(tmodel, "feature_cacheable") == cacheable
    if not cacheable:
        return
    with torch.no_grad():
        su, qu = tmodel.encode(sup), tmodel.encode(tgt)
        cached = tmodel.match_features(su, qu, labels)
    _close(su, _apply(jmodel, variables, ep[0], train=False,
                      method="encode"))
    for key in want:
        _close(cached[key], got[key].numpy(), dict(rtol=1e-5, atol=1e-5))


def test_molo_train_forward_matches_jax(carried):
    """molo in training (dropout off on both sides): the decoder runs, its
    BatchNorms and the trunk's take batch statistics, ``loss_recons`` is
    the reconstruction's mean square, and the running statistics move as
    flax's do."""
    jmodel, variables, tmodel, ep = carried("molo", 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        want, new = _apply(jmodel, variables, *ep, train=True,
                           mutable=["batch_stats"])
    model = HEADS["molo"][1](1)
    model.load_state_dict(weights.model_state_dict(variables), strict=True)
    model.train()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    with torch.no_grad():
        got = model(*_t(*ep))
    for key in want:
        _close(got[key], want[key])
    assert float(got["loss_recons"]) > 0
    sd = model.state_dict()
    after = weights.model_state_dict({"params": variables["params"],
                                      "batch_stats": _np_tree(
                                          new["batch_stats"])})
    running = [k for k in after if "running_" in k]
    assert any(k.startswith("up3.bn") for k in running)
    for k in running:
        _close(sd[k], after[k].numpy())


@pytest.mark.parametrize("name", sorted(HEADS))
def test_model_gradients_match_jax(carried, name):
    """The gradient of the dispatch's training loss (every term; molo's
    reconstruction is 0 outside training) with respect to every parameter,
    the models in evaluation mode: BatchNorm on its running statistics,
    which keeps the gradient well-conditioned (the train step's batch
    statistics make it a residue of cancelling sums:
    ``test_torch_slice_resnet_heads.py``). Per tensor to 1e-4 relative,
    or 1e-6 of the largest gradient where the gradient is a residue itself
    (a key bias under a softmax, zero in exact arithmetic)."""
    jmodel, variables, tmodel, ep = carried(name, SHOTS[name])
    tgt = np.asarray([0, 1, 1], np.int32)
    S = ep[0].shape[0]
    rs, rt = np.arange(S, dtype=np.int32) % WAY + 3, tgt + 3
    cfg = {"MODEL": {"USE_CLASSIFICATION_VALUE": 0.6,
                     "USE_CONTRASTIVE_COFF": 0.05, "RECONS_COFF": 0.05}}

    def jloss(params):
        out = jmodel.apply({**variables, "params": params},
                           *[jnp.asarray(a) for a in ep], train=False)
        return jax_loss_and_acc(name, out, jnp.asarray(tgt), jnp.asarray(rs),
                                jnp.asarray(rt), 2, cfg=JConfig(cfg),
                                train=True)[0]

    want = weights.model_state_dict({
        "params": _np_tree(jax.jit(jax.grad(jloss))(
            jax_tree(variables["params"]))),
        "batch_stats": variables["batch_stats"]})
    tmodel.zero_grad(set_to_none=True)
    out = tmodel(*_t(*ep))
    loss, _ = loss_and_acc(name, out, *_t(tgt, rs, rt), 2,
                           cfg=ConfigNode(cfg), train=True)
    loss.backward()
    got = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
           for k, p in tmodel.named_parameters()}
    largest = max(float(want[k].norm()) for k in got)
    for k, g in got.items():
        ref = want[k]
        err = float((g - ref).norm())
        assert err <= max(1e-4 * float(ref.norm()), 1e-6 * largest), k
    tmodel.zero_grad(set_to_none=True)


def jax_tree(tree):
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


# -- loss branches ------------------------------------------------------------------

def _outputs(name, rng, n_class_rows):
    def logits():
        return rng.normal(size=(1, 4, WAY)).astype(np.float32)

    out = {"logits": logits()}
    if name == "strm":
        out["logits_post_pat"] = logits()
    elif name == "soap":
        out["t_loss"] = np.float32(0.37)
    else:
        for key in ("logits_s2q", "logits_q2s", "logits_s2q_motion",
                    "logits_q2s_motion"):
            out[key] = logits()
        out["loss_recons"] = np.float32(0.81)
        out["class_logits"] = rng.normal(size=(1, n_class_rows, 10)).astype(
            np.float32)
    return out


@pytest.mark.parametrize("name,train,local", [
    ("strm", True, False), ("strm", False, False), ("soap", True, False),
    ("soap", False, False), ("molo", True, False), ("molo", False, False),
    ("molo", True, True)],
    ids=["strm-train", "strm-eval", "soap-train", "soap-eval", "molo-train",
         "molo-eval", "molo-train-local"])
def test_loss_branches_match_jax(name, train, local):
    """The same outputs through both dispatches at TASKS_PER_BATCH 4. molo:
    the main cross-entropy over TPB twice in training, ``loss_recons`` only
    there, and with ``USE_LOCAL`` the video labels repeated per token (T+1
    = 5 tokens a video)."""
    rng = np.random.default_rng(12)
    S = 4
    n_rows = (S + 4) * (T + 1 if local else 1)
    out = _outputs(name, rng, n_rows)
    tgt = np.asarray([0, 1, 1, 0], np.int32)
    rs = np.asarray([3, 7, 3, 7], np.int32)
    rt = np.asarray([3, 7, 7, 3], np.int32)
    cfg = {"MODEL": {"USE_CLASSIFICATION_VALUE": 0.6,
                     "USE_CONTRASTIVE_COFF": 0.05, "RECONS_COFF": 0.05,
                     "USE_LOCAL": local}}
    want = jax_loss_and_acc(name, {k: jnp.asarray(v) for k, v in out.items()},
                            jnp.asarray(tgt), jnp.asarray(rs),
                            jnp.asarray(rt), 4, cfg=JConfig(cfg), train=train)
    got = loss_and_acc(name, {k: torch.as_tensor(v) for k, v in out.items()},
                       *_t(tgt, rs, rt), 4, cfg=ConfigNode(cfg), train=train)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    assert float(got[1]) == float(want[1])
    if name == "molo":
        # the training terms are far outside that tolerance
        ev = loss_and_acc(name, {k: torch.as_tensor(v) for k, v in
                                 out.items()}, *_t(tgt, rs, rt), 4,
                          cfg=ConfigNode(cfg), train=False)
        assert train == (abs(float(ev[0]) - float(got[0])) > 1e-2)


# -- random initialisation -------------------------------------------------------

def test_random_init_starts_the_new_parameters_where_jax_does():
    """The new parameters as JAX initialises them (soap's and molo's
    ``setup`` parameters alone, strm's gate through a small
    ``SelfAttnBot``, otam's bank through its initializer) against
    ``weights.random_init_``."""
    def jax_init(module, *args, method=None):
        return _np_tree(module.init(jax.random.PRNGKey(0),
                                    *[jnp.asarray(a) for a in args],
                                    method=method))["params"]

    soap = jax_init(HEADS["soap"][0](1), method=lambda m: m.lmd)
    molo = jax_init(HEADS["molo"][0](1),
                    method=lambda m: (m.scale, m.scale_motion, m.class_token))
    bot = jax_init(jstrm.SelfAttnBot(dim=8, seq_len=4), np.zeros((1, 4, 8)))
    # MoTokens' bank: the initializer its ``self.param`` names
    mo = np.asarray(fnn.initializers.xavier_normal()(
        jax.random.PRNGKey(0), (1, 49, D)))
    models = {name: weights.random_init_(
        HEADS[name][1](1), torch.Generator().manual_seed(0))
        for name in ("otam", "strm", "soap", "molo")}
    assert float(models["strm"].attn_pat.gamma.detach()) == 0.0 \
        == float(bot["gamma"][0])
    assert float(models["soap"].lmd.detach()) == 0.5 == float(soap["lmd"])
    for key in ("scale", "scale_motion"):
        assert float(getattr(models["molo"], key).detach()) == 1.0 \
            == float(molo[key])
    std = (2.0 / (49 + D)) ** 0.5                      # xavier over (49, D)
    assert models["otam"].mo.mo.std().item() == pytest.approx(std, rel=0.1)
    assert mo.std() == pytest.approx(std, rel=0.15)
    tok = models["molo"].class_token
    assert tok.std().item() == pytest.approx(1.0, rel=0.3)
    assert molo["class_token"].std() == pytest.approx(1.0, rel=0.3)
    w = models["molo"].motion_conv.weight
    assert w.std().item() == pytest.approx(w[0].numel() ** -0.5, rel=0.1)
    assert not models["molo"].motion_conv.bias.any()
