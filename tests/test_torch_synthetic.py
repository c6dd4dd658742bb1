"""The port's ``SyntheticEpisodeSource`` against the JAX package's: from one
seed, the same episodes bit for bit (every leaf, its dtype and shape), in
the same order, over several episodes and three seeds."""

import dataclasses

import numpy as np
import pytest

from clipspm_tpu.data.synthetic import SyntheticEpisodeSource as JSource
from clipspm_tpu_torch.data.episode import Episode
from clipspm_tpu_torch.data.synthetic import SyntheticEpisodeSource


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_episodes_equal_the_jax_sources_bit_for_bit(seed):
    kw = dict(way=3, shot=2, queries=2, seq_len=4, img_size=16,
              num_classes=7, seed=seed)
    port, jax_src = SyntheticEpisodeSource(**kw), JSource(**kw)
    for got, want in zip([port.sample() for _ in range(3)],
                         [next(iter(jax_src)) for _ in range(3)]):
        assert isinstance(got, Episode)
        for f in dataclasses.fields(Episode):
            a, b = getattr(got, f.name), np.asarray(getattr(want, f.name))
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert np.array_equal(a, b), f.name
        assert got.support_images.shape == (6, 4, 16, 16, 3)
        assert sorted(got.support_labels.tolist()) == [0, 0, 1, 1, 2, 2]
        assert set(got.real_support_labels) == set(got.batch_class_list)
    port.close()
