"""Port OTAM DP (plain wavefront, and kernel K1 on a GPU) against the JAX
package's scan wavefront and its Pallas kernel (interpret mode on the CPU).

The JAX package is imported inside the fixture that needs it, so the GPU
cases also run on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_otam.py
"""

import types

import numpy as np
import pytest
import torch

from clipspm_tpu_torch.ops import otam as totam
from clipspm_tpu_torch.ops import otam_cuda

torch.set_num_threads(2)

SHAPES = [(4, 5, 8, 8), (3, 8, 8), (130, 8, 8)]
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's OTAM: scan wavefront and Pallas kernel."""
    import jax
    import jax.numpy as jnp

    from clipspm_tpu.ops import otam
    from clipspm_tpu.ops.otam_pallas import otam_cum_dist_pallas

    return types.SimpleNamespace(jax=jax, jnp=jnp, otam=otam,
                                 pallas=otam_cum_dist_pallas)


def _tables(shape, seed=0, lo=0.0, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, size=shape).astype(
        np.float32)


@pytest.mark.parametrize("lbda", [0.5, 0.1])
@pytest.mark.parametrize("shape", SHAPES)
def test_cum_dist_matches_jax_scan_and_pallas(ref, lbda, shape):
    d = _tables(shape)
    got = totam.otam_cum_dist(torch.from_numpy(d), lbda).numpy()
    assert got.shape == shape[:-2]
    np.testing.assert_allclose(
        got, np.asarray(ref.otam.otam_cum_dist(ref.jnp.asarray(d), lbda)),
        **TOL)
    np.testing.assert_allclose(
        got, np.asarray(ref.pallas(ref.jnp.asarray(d), lbda,
                                   interpret=True)), **TOL)


@pytest.mark.parametrize("lbda", [0.5, 0.1])
def test_unrolled_matches_wavefront(lbda):
    d = torch.from_numpy(_tables((7, 6, 5), seed=1))
    np.testing.assert_allclose(totam.otam_cum_dist_unrolled(d, lbda).numpy(),
                               totam.otam_cum_dist(d, lbda).numpy(), **TOL)


@pytest.mark.parametrize("lbda", [0.5, 0.1])
def test_gradients_match_jax(ref, lbda):
    d = _tables((6, 8, 8), seed=2, lo=0.1, hi=1.9)
    w = np.random.default_rng(3).uniform(size=6).astype(np.float32)
    t = torch.from_numpy(d).requires_grad_(True)
    (otam_cuda.otam_cum_dist(t, lbda) * torch.from_numpy(w)).sum().backward()
    want = ref.jax.grad(
        lambda x: ref.jnp.sum(ref.otam.otam_cum_dist(x, lbda) * w))(
        ref.jnp.asarray(d))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_otam_distance_matches_jax(ref, bidirectional):
    rng = np.random.default_rng(4)
    sup = rng.normal(size=(5, 8, 16)).astype(np.float32)
    qry = rng.normal(size=(3, 8, 16)).astype(np.float32)
    got = totam.otam_distance(torch.from_numpy(sup), torch.from_numpy(qry),
                              bidirectional=bidirectional).numpy()
    want = np.asarray(ref.otam.otam_distance(
        ref.jnp.asarray(sup), ref.jnp.asarray(qry),
        bidirectional=bidirectional))
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_frame_distance_cos_matches_jax(ref):
    rng = np.random.default_rng(5)
    q = rng.normal(size=(3, 8, 16)).astype(np.float32)
    s = rng.normal(size=(4, 8, 16)).astype(np.float32)
    np.testing.assert_allclose(
        totam.frame_distance_cos(torch.from_numpy(q),
                                 torch.from_numpy(s)).numpy(),
        np.asarray(ref.otam.frame_distance_cos(ref.jnp.asarray(q),
                                               ref.jnp.asarray(s))),
        rtol=1e-6, atol=1e-6)


def test_cpu_tensor_never_launches_the_kernel():
    before = otam_cuda.launches
    otam_cuda.otam_cum_dist(torch.from_numpy(_tables((3, 8, 8))), 0.5)
    assert otam_cuda.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel K1 is CUDA C++ with no CPU "
                    "or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lbda", [0.5, 0.1])
@pytest.mark.parametrize("B", [25, 5, 1600])
def test_kernel_matches_plain_on_gpu(cuda_device, lbda, B):
    d = torch.from_numpy(_tables((B, 8, 8), seed=B)).to(cuda_device)
    before = otam_cuda.launches
    got = otam_cuda.otam_cum_dist(d, lbda)
    assert otam_cuda.launches == before + 1
    want = totam.otam_cum_dist(d, lbda)
    torch.testing.assert_close(got, want, **TOL)
    t1 = d.clone().requires_grad_(True)
    t2 = d.clone().requires_grad_(True)
    otam_cuda.otam_cum_dist(t1, lbda).sum().backward()
    totam.otam_cum_dist(t2, lbda).sum().backward()
    torch.testing.assert_close(t1.grad, t2.grad, rtol=2e-4, atol=2e-4)
