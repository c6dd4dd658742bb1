"""The port's training modules against the JAX package: BatchNorm in train
mode, the CLIP tower's train forward and gradients, the train transform,
the optimizers and LR schedule, the clipspm head's gradients in train mode
(dropout off), the loss dispatch's train flag and the ``EpisodeLoader``."""

import os
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from make_synthetic_dataset import make_dataset  # noqa: E402

from clipspm_tpu.data import pipeline as jpipe  # noqa: E402
from clipspm_tpu.data import sampler as jsampler  # noqa: E402
from clipspm_tpu.data import splits as jsplits  # noqa: E402
from clipspm_tpu.data import transforms as jtf  # noqa: E402
from clipspm_tpu.models.backbones import clip as jclip  # noqa: E402
from clipspm_tpu.models.heads.clipspm import CLIPSPM as JCLIPSPM  # noqa: E402
from clipspm_tpu.train import losses as jlosses  # noqa: E402
from clipspm_tpu.train.optim import make_optimizer as j_make_optimizer  # noqa: E402
from clipspm_tpu.utils.config import ConfigNode as JConfig  # noqa: E402
from clipspm_tpu.utils.config import SPM_DEFAULT_PARAMS  # noqa: E402
from clipspm_tpu_torch import weights  # noqa: E402
from clipspm_tpu_torch.data import pipeline as tpipe  # noqa: E402
from clipspm_tpu_torch.data import sampler as tsampler  # noqa: E402
from clipspm_tpu_torch.data import splits as tsplits  # noqa: E402
from clipspm_tpu_torch.data import transforms as ttf  # noqa: E402
from clipspm_tpu_torch.models.backbones import clip as tclip  # noqa: E402
from clipspm_tpu_torch.models.heads.clipspm import CLIPSPM as TCLIPSPM  # noqa: E402
from clipspm_tpu_torch.train import losses as tlosses  # noqa: E402
from clipspm_tpu_torch.train.optim import make_optimizer, multistep_lr  # noqa: E402
from clipspm_tpu_torch.utils.config import ConfigNode  # noqa: E402

torch.set_num_threads(2)


def _rel(got, want) -> float:
    got, want = torch.as_tensor(np.asarray(got)), torch.as_tensor(
        np.asarray(want))
    return float((got - want).norm() / want.norm())


# -- BatchNorm in train mode (the repair) -----------------------------------

@pytest.mark.parametrize("shape", [(2, 5, 2, 2), (3, 4, 1, 1)])
def test_batchnorm_train_step_matches_flax_batch_stats(shape):
    """n = N*H*W is small (8, 3), so torch's unbiased running variance,
    n/(n-1) times flax's, would be 14% or 50% off; the port's is flax's."""
    N, C, H, W = shape
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, (N, H, W, C)).astype(np.float32)
    mean0 = rng.normal(size=C).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, C).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(size=C).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    y_j, upd = bn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(x), mutable=["batch_stats"])

    mod = tclip.FP32BatchNorm2d(C).train()
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
        mod.running_mean.copy_(torch.from_numpy(mean0))
        mod.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    y_t = mod(xt).permute(0, 2, 3, 1)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               rtol=1e-5, atol=1e-5)
    stats = upd["batch_stats"]
    np.testing.assert_allclose(mod.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(mod.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-6,
                               atol=1e-6)
    # torch's own BatchNorm2d keeps the unbiased variance: this test sees it
    plain = torch.nn.BatchNorm2d(C).train()
    plain.running_var.copy_(torch.from_numpy(var0))
    plain(xt)
    assert not np.allclose(plain.running_var.numpy(),
                           np.asarray(stats["var"]), rtol=1e-3)


def test_resnet_tower_train_forward_stats_and_grads_match_flax():
    """ModifiedResNet + AttentionPool2d in train mode (test-tiny-rn, 24
    frames): output, every updated running stat, and the gradient of a
    random weighting of the output. fp32, sums in other orders: output and
    stats to 1e-4, each gradient tensor to 1e-3 relative, except the
    attention pool's key bias, whose gradient is zero in exact arithmetic
    (a constant added to every key's logit) and so only rounding."""
    jm = jclip.build_clip("test-tiny-rn")
    v = jax.tree_util.tree_map(np.asarray,
                               jclip.init_clip_params(jm, jax.random.PRNGKey(0)))
    tm = tclip.CLIPModel(tclip.CLIP_ARCHS["test-tiny-rn"])
    tm.load_state_dict(weights.clip_state_dict(v), strict=True)
    tm.train()
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (24, 32, 32, 3)).astype(np.float32)
    R = rng.normal(size=(24, 64)).astype(np.float32)

    def f(params):
        out, upd = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]},
                            jnp.asarray(img), train=True,
                            method=jm.encode_image, mutable=["batch_stats"])
        return jnp.sum(out * R), (out, upd)

    (_, (out, upd)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        v["params"])
    o = tm.encode_image(torch.from_numpy(img))
    (o * torch.from_numpy(R)).sum().backward()
    assert _rel(o.detach(), out) <= 1e-4
    after = weights.clip_state_dict(
        {"params": v["params"],
         "batch_stats": jax.tree_util.tree_map(np.asarray,
                                               upd["batch_stats"])})
    sd = tm.state_dict()
    running = [k for k in sd if "running_" in k]
    assert len(running) == 2 * 19        # stem 3, blocks 4 x 3, downsample 4
    for k in running:
        assert _rel(sd[k], after[k]) <= 1e-4, k
    gsd = weights.clip_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, grads),
         "batch_stats": v["batch_stats"]})
    for k, p in tm.named_parameters():
        if not k.startswith("visual."):
            continue
        if k == "visual.attnpool.k_proj.bias":
            assert float(p.grad.norm()) <= 1e-5
            continue
        assert _rel(p.grad, gsd[k]) <= 1e-3, k


# -- the train transform ------------------------------------------------------

@pytest.mark.parametrize("flip", [True, False])
def test_train_crop_and_flip_match_jax_with_replayed_offsets(flip):
    """The JAX offsets, replayed from the same key as its transform splits
    it, passed to the port's flip and crop: equal frames."""
    rng = np.random.default_rng(2)
    x = rng.integers(0, 256, (6, 3, 40, 44, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(7)
    want = jtf.episode_device_transform(jnp.asarray(x), key, train=True,
                                        img_size=32, resize_to=40, flip=flip)
    k1, k2 = jax.random.split(key)
    flips = np.asarray(jax.random.bernoulli(k1, 0.5, (6,)))
    kt, kl = jax.random.split(k2)
    tops = np.asarray(jax.random.randint(kt, (6,), 0, 40 - 32 + 1))
    lefts = np.asarray(jax.random.randint(kl, (6,), 0, 44 - 32 + 1))
    assert flips.any() and not flips.all()
    got = torch.from_numpy(x)
    if flip:
        got = ttf.horizontal_flip(got, torch.from_numpy(flips))
    got = ttf.random_crop(got, 32, torch.from_numpy(tops).long(),
                          torch.from_numpy(lefts).long())
    np.testing.assert_array_equal(ttf.to_float(got).numpy(),
                                  np.asarray(want))
    # the pieces against JAX's own
    np.testing.assert_array_equal(
        ttf.horizontal_flip(torch.from_numpy(x),
                            torch.from_numpy(flips)).numpy(),
        np.asarray(jtf.horizontal_flip(jnp.asarray(x), k1)))


def test_train_transform_draws_from_its_generator():
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (5, 2, 40, 40, 3), dtype=np.uint8))

    def run(seed, flip=True):
        gen = torch.Generator().manual_seed(seed)
        return ttf.episode_device_transform(x, train=True, img_size=32,
                                            resize_to=40, flip=flip, gen=gen)

    a, b, c = run(0), run(0), run(1)
    assert a.shape == (5, 2, 32, 32, 3) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    # flip=False draws the same stream and only skips the mirror
    flips, tops, lefts = ttf.draw_train_offsets(
        5, 40, 40, 32, torch.Generator().manual_seed(0))
    assert torch.equal(run(0, flip=False),
                       ttf.to_float(ttf.random_crop(x, 32, tops, lefts)))
    assert torch.equal(a, ttf.to_float(ttf.random_crop(
        ttf.horizontal_flip(x, flips), 32, tops, lefts)))


# -- optimizers and schedule ----------------------------------------------------

@pytest.mark.parametrize("method,lr,wd", [("adam", 1e-3, 5e-5),
                                          ("sgd", 1e-2, 1e-3)])
def test_make_optimizer_matches_optax_chain_across_milestone(method, lr, wd):
    """5 steps at TASKS_PER_BATCH=4 with LR_SCH=8 episodes: the rate drops
    10x from the third step (2 * 4 >= 8) in both packages."""
    d = {"SOLVER": {"LR": lr, "WEIGHT_DECAY": wd, "LR_SCH": 8,
                    "OPTIM_METHOD": method, "MOMENTUM": 0.9},
         "TRAIN": {"TASKS_PER_BATCH": 4}}
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(4, 3)).astype(np.float32)
    grads = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(5)]

    wt = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt, sched = make_optimizer(ConfigNode(d), [wt])
    lrs = []
    for g in grads:
        lrs.append(opt.param_groups[0]["lr"])
        wt.grad = torch.from_numpy(g.copy())
        opt.step()
        sched.step()
    assert lrs == pytest.approx([lr, lr, lr / 10, lr / 10, lr / 10])

    tx = j_make_optimizer(JConfig(d))
    wj = jnp.asarray(w0)
    state = tx.init(wj)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, wj)
        wj = optax.apply_updates(wj, updates)
    np.testing.assert_allclose(wt.detach().numpy(), np.asarray(wj),
                               rtol=1e-5, atol=1e-6)


def test_multistep_lr_counts_episodes():
    sched = multistep_lr(1.0, [1000], gamma=0.1, episodes_per_step=16)
    assert sched(62) == 1.0 and sched(63) == pytest.approx(0.1)


# -- the clipspm head in train mode ------------------------------------------------

D, WAY, SHOT, QUERIES, T = 64, 2, 2, 2, 4


def test_head_gradients_in_train_mode_match_jax():
    """Train mode with dropout off on both sides (flax's Dropout patched to
    the identity, the port's rates 0): the gradient of a random weighting
    of the logits plus the aux distance, for every head parameter and both
    feature inputs, to 1e-4 relative (fp32)."""
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    labels = rng.permutation(np.repeat(np.arange(WAY), SHOT)).astype(np.int32)
    ep = (f32(WAY * SHOT, T, D), f32(WAY * QUERIES, T, D), labels,
          f32(WAY * SHOT, 1, D), f32(WAY * QUERIES, 1, D))
    R = f32(1, WAY * QUERIES, WAY)
    spm = SPM_DEFAULT_PARAMS["hmdb"]
    jh = JCLIPSPM(dim=D, way=WAY, shot=SHOT, spm=spm)
    ja = [jnp.asarray(a) for a in ep]
    variables = jh.init(jax.random.PRNGKey(1), *ja)

    def loss(params, su, qu):
        out = jh.apply({"params": params}, su, qu, *ja[2:], train=True,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(out["logits"] * R) + 0.5 * out["dists"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        gp, gsu, gqu = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
            variables["params"], ja[0], ja[1])

    th = TCLIPSPM(dim=D, way=WAY, shot=SHOT, spm=spm)
    th.load_state_dict(weights.head_state_dict(
        jax.tree_util.tree_map(np.asarray, variables["params"])), strict=True)
    th.train()
    drops = [m for m in th.modules() if isinstance(m, torch.nn.Dropout)]
    # token_tr's FeedForward, and each TransformerV1's attention and FFN
    assert sorted(m.p for m in drops) == [0.05, 0.05, 0.05, 0.2, 0.2]
    for m in drops:
        m.p = 0.0
    su = torch.from_numpy(ep[0]).requires_grad_(True)
    qu = torch.from_numpy(ep[1]).requires_grad_(True)
    out = th(su, qu, *[torch.from_numpy(a) for a in ep[2:]])
    ((out["logits"] * torch.from_numpy(R)).sum()
     + 0.5 * out["dists"]).backward()
    assert _rel(su.grad, gsu) <= 1e-4 and _rel(qu.grad, gqu) <= 1e-4
    gsd = weights.head_state_dict(jax.tree_util.tree_map(np.asarray, gp))
    for k, p in th.named_parameters():
        if k == "scale":       # unused by the forward: no gradient
            assert p.grad is None and not gsd[k].any()
            continue
        assert _rel(p.grad, gsd[k]) <= 1e-4, k


@pytest.mark.parametrize("name", ["clipspm", "ta2n"])
def test_loss_dispatch_train_flag_matches_jax(name):
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(1, 6, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 6).astype(np.int32)
    dists = np.float32(2.5)
    zeros = np.zeros(6, np.int32)
    jl, ja = jlosses.loss_and_acc(
        name, {"logits": jnp.asarray(logits), "dists": jnp.asarray(dists)},
        jnp.asarray(labels), jnp.asarray(zeros), jnp.asarray(zeros), 16,
        train=True)
    tl, ta = tlosses.loss_and_acc(
        name, {"logits": torch.from_numpy(logits),
               "dists": torch.tensor(dists)}, torch.from_numpy(labels),
        torch.from_numpy(zeros), torch.from_numpy(zeros), 16, train=True)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    assert ta.item() == float(ja)


def _fp64_step_narrowing(cfg_path: str, name: str, opts, size: int,
                         tol: float) -> None:
    """The model of ``cfg_path`` in fp64 (the witness ``chip_smoke.py``
    holds the card's fp32 train step against): no op of its train forward,
    the loss or the backward takes an fp64 tensor and returns an fp32 one,
    and its gradients agree with the fp32 model's to ``tol`` relative over
    all parameters (dropout off)."""
    import copy

    from torch.utils import _pytree as pytree
    from torch.utils._python_dispatch import TorchDispatchMode

    from clipspm_tpu_torch.models.fsar import build_model
    from clipspm_tpu_torch.utils.config import load_config
    from clipspm_tpu_torch.weights import random_init_

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, cfg_path), opts=[
        "USE_AMP=false", f"DATA.IMG_SIZE={size}", "DATA.SEQ_LEN=4",
        "TRAIN.WAY=2", "TRAIN.SHOT=1", "TRAIN.QUERY_PER_CLASS=1", *opts])
    base = random_init_(build_model(cfg), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    frames = [rng.uniform(0, 1, (2, 4, size, size, 3)) for _ in range(2)]
    labels = [torch.tensor([1, 0]), torch.tensor([3, 7]),
              torch.tensor([7, 3])]
    width = base.arch.embed_dim if name == "clipspm" else 1
    text = rng.normal(size=(len(cfg.TRAIN.CLASS_NAME), width))

    class Narrowing(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            dtypes = lambda t: {x.dtype for x in pytree.tree_leaves(t)  # noqa
                                if isinstance(x, torch.Tensor)}
            if torch.float64 in dtypes((args, kwargs)) \
                    and torch.float32 in dtypes(out):
                self.ops.add(str(func))
            return out

    grads = {}
    for dtype in (torch.float32, torch.float64):
        model = copy.deepcopy(base).to(dtype)
        model.train()
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.eval()
        model.zero_grad(set_to_none=True)
        tt = torch.tensor(text, dtype=dtype)
        with Narrowing() as mode:
            out = model(*[torch.tensor(f, dtype=dtype) for f in frames],
                        torch.tensor([0, 1]), *labels[1:], tt, tt)
            loss, _ = tlosses.loss_and_acc(name, out, labels[0], *labels[1:],
                                           1)
            loss.backward()
        if dtype == torch.float64:
            assert loss.dtype == torch.float64
            assert not mode.ops, sorted(mode.ops)
        grads[dtype] = torch.cat([p.grad.flatten().double()
                                  for _, p in sorted(model.named_parameters())
                                  if p.grad is not None])
    assert _rel(grads[torch.float32], grads[torch.float64]) <= tol


def test_fp64_train_step_never_narrows_to_fp32():
    """The clipspm model (test-tiny-rn; fp32 rounding is about 1e-5 here):
    gradients to 1e-4."""
    _fp64_step_narrowing("configs/clipspm/hmdb.yaml", "clipspm",
                         ["MODEL.BACKBONE=test-tiny-rn"], 32, 1e-4)


@pytest.mark.parametrize("opts", [
    ["MODEL.BACKBONE=test-tiny"],
    ["MODEL.BACKBONE=test-tiny", "MODEL.ENCODE_CHUNK=3",
     "MODEL.TRAIN_ENCODE_CHUNK=true"]], ids=["vit", "vit-remat"])
def test_fp64_vit_train_step_never_narrows_to_fp32(opts):
    """The clipspm model on the ViT tower, unchunked and remat-chunked
    (3 frames a chunk, ``attn_out``): gradients to 1e-4."""
    _fp64_step_narrowing("configs/clipspm/hmdb.yaml", "clipspm", opts, 32,
                         1e-4)


@pytest.mark.parametrize("metric", ["cos", "otam"])
def test_fp64_ta2n_train_step_never_narrows_to_fp32(metric):
    """The ta2n model (test-tiny-resnet at 64 px, both metrics; the soft-DTW
    plain version in fp64 on the CPU): gradients to 1e-3 (every trunk
    convolution feeds a BatchNorm, so fp32 rounding moves the summed
    gradient more than the clipspm tower's)."""
    _fp64_step_narrowing("configs/ta2n/ucf.yaml", "ta2n",
                         ["MODEL.BACKBONE=test-tiny-resnet",
                          f"MODEL.METRIC={metric}"], 64, 1e-3)


# -- the episode loader ---------------------------------------------------------

@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loader"))
    make_dataset(root, classes=4, videos=4, frames=6, size=40, img_size=32,
                 seq_len=4)
    return os.path.join(root, "splits", "hmdb_ARN"), os.path.join(
        root, "hmdb_256x256q5_l8")


@pytest.mark.parametrize("native", [True, False])
def test_episode_loader_yields_the_jax_loaders_episodes(split, native):
    ann, data = split
    kw = dict(way=2, shot=1, queries=2, seq_len=4, train=True, seed=5)
    tl = tpipe.EpisodeLoader(
        tsampler.EpisodeSampler(tsplits.load_split(ann, data, "train",
                                                   "hmdb", 4), **kw),
        num_workers=2, prefetch=2, use_native=native)
    jl = jpipe.EpisodeLoader(
        jsampler.EpisodeSampler(jsplits.load_split(ann, data, "train",
                                                   "hmdb", 4), **kw),
        num_workers=2, prefetch=2, use_native=native)
    try:
        for a, b in zip([e for _, e in zip(range(5), tl)],
                        [e for _, e in zip(range(5), jl)]):
            for field in ("support_images", "support_labels",
                          "target_images", "target_labels",
                          "real_support_labels", "real_target_labels",
                          "batch_class_list"):
                np.testing.assert_array_equal(getattr(a, field),
                                              getattr(b, field),
                                              err_msg=field)
            assert a.support_images.shape == (2, 4, 40, 40, 3)
    finally:
        tl.close()
        jl.close()
    # a closed loader ends iteration once what it queued is drained
    assert len(list(tl)) <= 3      # the queue's 2 and one put in flight


def test_episode_loader_surfaces_a_terminal_producer_error(split):
    ann, data = split

    class Broken(tsampler.EpisodeSampler):
        def sample(self):
            raise OSError("frames missing")

    loader = tpipe.EpisodeLoader(
        Broken(tsplits.load_split(ann, data, "train", "hmdb", 4), way=2,
               shot=1, queries=2, seq_len=4, train=True, seed=0),
        num_workers=1, prefetch=1)
    try:
        for _ in range(2):    # the first iterator, then any later one
            with pytest.raises(RuntimeError, match="failed 100 times") as e:
                next(iter(loader))
            assert isinstance(e.value.__cause__, OSError)
    finally:
        loader.close()
