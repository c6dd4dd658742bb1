"""Port config, split catalog, sampler, decode and eval transform against the
JAX package."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipspm_tpu.data import pipeline as jpipe
from clipspm_tpu.data import sampler as jsampler
from clipspm_tpu.data import splits as jsplits
from clipspm_tpu.data import transforms as jtf
from clipspm_tpu.train.learner import TransformSpec as JTransformSpec
from clipspm_tpu.utils import config as jconfig
from clipspm_tpu_torch.data import pipeline as tpipe
from clipspm_tpu_torch.data import sampler as tsampler
from clipspm_tpu_torch.data import splits as tsplits
from clipspm_tpu_torch.data import transforms as ttf
from clipspm_tpu_torch.utils import config as tconfig

PIL = pytest.importorskip("PIL.Image")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_CONFIGS = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "configs", "*", "*.yaml")))


@pytest.mark.parametrize("rel", MODEL_CONFIGS)
def test_load_config_matches_jax(rel, tmp_path):
    path = os.path.join(REPO, rel)
    opts = ["TEST.ONLY_TEST=true", "SOLVER.LR=5e-5", "TRAIN.WAY=3"]
    want = jconfig.load_config(path, opts=opts, splits_root=str(tmp_path))
    got = tconfig.load_config(path, opts=opts, splits_root=str(tmp_path))
    assert got.to_dict() == want.to_dict()
    ts, js = ttf.TransformSpec.from_config(got), JTransformSpec.from_config(want)
    assert (ts.img_size, ts.resize_to, ts.flip, ts.normalize) == \
        (js.img_size, js.resize_to, js.flip, js.normalize)


@pytest.fixture(scope="module")
def frame_split(tmp_path_factory):
    """A split of 96x96 JPEG videos of varied lengths (96 is the resize
    target of a 32-px crop, so the eval resize is an identity)."""
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    lines = []
    for c in range(5):
        for v in range(4):
            d = root / "test" / f"class{c}" / f"v{v}"
            d.mkdir(parents=True)
            for f in range(5 + (c + v) % 4):
                arr = rng.integers(0, 255, size=(96, 96, 3)).astype(np.uint8)
                PIL.fromarray(arr).save(str(d / f"{f:05d}.jpg"))
            lines.append(f"class{c}/v{v}")
    (root / "testlist03.txt").write_text("\n".join(lines) + "\n")
    return str(root)


def _catalogs(root, seq_len=4):
    return (tsplits.load_split(root, root, "test", "hmdb", seq_len),
            jsplits.load_split(root, root, "test", "hmdb", seq_len))


@pytest.mark.parametrize("train", [False, True])
def test_sampler_plans_equal_over_50_episodes(frame_split, train):
    tcat, jcat = _catalogs(frame_split)
    assert [r.frame_paths for r in tcat.records] == \
        [r.frame_paths for r in jcat.records]
    kw = dict(way=3, shot=2, queries=1, seq_len=4, train=train, seed=7)
    ts, js = tsampler.EpisodeSampler(tcat, **kw), \
        jsampler.EpisodeSampler(jcat, **kw)
    for _ in range(50):
        a, b = ts.sample(), js.sample()
        for field in ("support_video_idx", "support_frame_idx",
                      "support_labels", "real_support_labels",
                      "target_video_idx", "target_frame_idx",
                      "target_labels", "real_target_labels",
                      "batch_class_list"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field), err_msg=field)


@pytest.mark.parametrize("native", [True, False])
def test_decode_and_eval_transform_byte_equal(frame_split, native):
    tcat, jcat = _catalogs(frame_split)
    paths = [rec.frame_paths[:4] for rec in tcat.records[:6]]
    size = tpipe.probe_frame_size(tcat) if native else None
    assert tpipe.probe_frame_size(tcat) == jpipe.probe_frame_size(jcat) \
        == (96, 96)
    got = tpipe.decode_path_lists(paths, frame_size=size)
    want = jpipe.decode_path_lists(paths, frame_size=size)
    assert got.dtype == np.uint8 and got.shape == (6, 4, 96, 96, 3)
    np.testing.assert_array_equal(got, want)
    for normalize in (False, True):
        x = ttf.episode_device_transform(torch.from_numpy(got), train=False,
                                         img_size=32, resize_to=96,
                                         normalize=normalize)
        y = jtf.episode_device_transform(jnp.asarray(want), None,
                                         train=False, img_size=32,
                                         resize_to=96, normalize=normalize)
        assert x.shape == (6, 4, 32, 32, 3)
        if normalize:
            # off the shipped path (DATA.IMG_NORM is false in every config);
            # XLA fuses the normalize arithmetic, 1 ulp apart
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_resize_short_side_close_to_jax():
    """Off the main path (frames not at the resize target): antialiased
    bilinear, equal to JAX's resize up to interpolation rounding."""
    x = np.random.default_rng(1).integers(0, 255, (2, 3, 40, 60, 3)).astype(
        np.uint8)
    for size in (80, 24):
        got = ttf.resize_short_side(torch.from_numpy(x), size).numpy()
        want = np.asarray(jtf.resize_short_side(jnp.asarray(x), size))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1.0)
