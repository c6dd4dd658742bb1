"""Port soft-DTW (plain wavefront, and kernel K2 on a GPU) against the JAX
package's scan wavefront and its Pallas kernel (interpret mode on the CPU).

Both sides use the clamped soft-min (clamp at 80, sentinel 1e30), so the
forward is held within 2e-5 in fp32 and gradients within 2e-4. The JAX
package is imported inside the fixture that needs it, so the GPU cases also
run on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_softdtw.py
"""

import importlib
import types

import numpy as np
import pytest
import torch

from clipspm_tpu_torch.ops import softdtw as tsdtw
from clipspm_tpu_torch.ops import softdtw_cuda

torch.set_num_threads(2)

# TA2N's padded tables [way*Q, T+2, T], a non-square odd shape, and a batch
# beyond one 128-lane tile of the Pallas kernel
SHAPES = [(25, 10, 8), (4, 5, 7), (130, 10, 8)]
TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's soft-DTW: scan wavefront and Pallas kernel."""
    import jax
    import jax.numpy as jnp

    from clipspm_tpu.ops.softdtw_pallas import softdtw_from_dists_pallas

    # the module, not the function of the same name that clipspm_tpu.ops
    # re-exports
    softdtw = importlib.import_module("clipspm_tpu.ops.softdtw")
    return types.SimpleNamespace(jax=jax, jnp=jnp, sdtw=softdtw,
                                 pallas=softdtw_from_dists_pallas)


def _tables(shape, seed=0, lo=0.0, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, size=shape).astype(
        np.float32)


@pytest.mark.parametrize("bandwidth", [0.0, 2.0])
@pytest.mark.parametrize("gamma", [0.1, 1.0])
@pytest.mark.parametrize("shape", SHAPES)
def test_from_dists_matches_jax_scan_and_pallas(ref, shape, gamma,
                                                bandwidth):
    d = _tables(shape)
    got = tsdtw.softdtw_from_dists(torch.from_numpy(d), gamma,
                                   bandwidth).numpy()
    assert got.shape == shape[:-2]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, np.asarray(ref.sdtw.softdtw_from_dists(ref.jnp.asarray(d),
                                                    gamma, bandwidth)),
        **TOL)
    np.testing.assert_allclose(
        got, np.asarray(ref.pallas(ref.jnp.asarray(d), gamma, bandwidth,
                                   interpret=True)), **TOL)


def test_batch_dims_are_kept():
    d = torch.from_numpy(_tables((2, 3, 6, 5), seed=7))
    got = tsdtw.softdtw_from_dists(d, 0.5)
    assert got.shape == (2, 3)
    torch.testing.assert_close(
        got, tsdtw.softdtw_from_dists(d.reshape(6, 6, 5), 0.5).reshape(2, 3))


@pytest.mark.parametrize("gamma,bandwidth", [(0.1, 0.0), (1.0, 2.0)])
def test_gradients_match_jax(ref, gamma, bandwidth):
    d = _tables((6, 10, 8), seed=2, lo=0.1, hi=1.9)
    w = np.random.default_rng(3).uniform(size=6).astype(np.float32)
    t = torch.from_numpy(d).requires_grad_(True)
    (softdtw_cuda.softdtw_from_dists(t, gamma, bandwidth)
     * torch.from_numpy(w)).sum().backward()
    want = ref.jax.grad(lambda x: ref.jnp.sum(
        ref.sdtw.softdtw_from_dists(x, gamma, bandwidth) * w))(
        ref.jnp.asarray(d))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize("dist", ["cos", "l2sq"])
@pytest.mark.parametrize("normalize", [False, True])
def test_softdtw_matches_jax(ref, normalize, dist):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 8, 16)).astype(np.float32)
    y = rng.normal(size=(6, 7, 16)).astype(np.float32)
    gamma = 0.1 if dist == "cos" else 1.0
    got = tsdtw.softdtw(torch.from_numpy(x), torch.from_numpy(y), gamma,
                        normalize=normalize, dist=dist).numpy()
    want = np.asarray(ref.sdtw.softdtw(ref.jnp.asarray(x), ref.jnp.asarray(y),
                                       gamma, normalize=normalize, dist=dist))
    assert got.shape == want.shape == ((6,) if normalize else (6, 1))
    np.testing.assert_allclose(got, want, **TOL)


def test_softdtw_gradients_match_jax(ref):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(5, 8, 16)).astype(np.float32)
    y = rng.normal(size=(5, 8, 16)).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    tsdtw.softdtw(tx, ty, gamma=0.1).sum().backward()
    gx, gy = ref.jax.grad(lambda a, b: ref.jnp.sum(
        ref.sdtw.softdtw(a, b, gamma=0.1)), argnums=(0, 1))(
        ref.jnp.asarray(x), ref.jnp.asarray(y))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **GRAD_TOL)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(gy), **GRAD_TOL)


@pytest.mark.parametrize("fn", ["pairwise_cos_dist", "pairwise_l2sq"])
def test_pairwise_distances_match_jax(ref, fn):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 8, 16)).astype(np.float32)
    y = rng.normal(size=(3, 6, 16)).astype(np.float32)
    x[0, 2] = 0.0   # a zero frame: the eps clamp of the cosine norms
    np.testing.assert_allclose(
        getattr(tsdtw, fn)(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(getattr(ref.sdtw, fn)(ref.jnp.asarray(x),
                                         ref.jnp.asarray(y))),
        rtol=1e-5, atol=1e-5)


def test_pruned_cells_stay_at_the_sentinel():
    # a band narrower than |N - M| leaves the corner unreachable: R[N, M]
    # must be the sentinel exactly, not a sentinel plus a distance
    d = torch.from_numpy(_tables((3, 10, 4), seed=6))
    assert (tsdtw.softdtw_from_dists(d, 0.1, bandwidth=2.0) == 1e30).all()


def test_cpu_tensor_never_launches_the_kernel():
    before = softdtw_cuda.launches
    softdtw_cuda.softdtw_from_dists(torch.from_numpy(_tables((3, 10, 8))),
                                    0.1)
    tsdtw.softdtw(torch.randn(2, 8, 4), torch.randn(2, 8, 4), gamma=0.1)
    assert softdtw_cuda.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        softdtw_cuda.softdtw_dp_cuda(torch.zeros(2, 10, 8), 0.1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel K2 is CUDA C++ with no CPU "
                    "or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bandwidth", [0.0, 2.0])
@pytest.mark.parametrize("gamma", [0.1, 1.0])
@pytest.mark.parametrize("B", [25, 5, 1600])
def test_kernel_matches_plain_on_gpu(cuda_device, B, gamma, bandwidth):
    d = torch.from_numpy(_tables((B, 10, 8), seed=B)).to(cuda_device)
    before = softdtw_cuda.launches
    got = softdtw_cuda.softdtw_from_dists(d, gamma, bandwidth)
    assert softdtw_cuda.launches == before + 1
    want = tsdtw.softdtw_from_dists(d, gamma, bandwidth)
    torch.testing.assert_close(got, want, **TOL)
    t1 = d.clone().requires_grad_(True)
    t2 = d.clone().requires_grad_(True)
    softdtw_cuda.softdtw_from_dists(t1, gamma, bandwidth).sum().backward()
    tsdtw.softdtw_from_dists(t2, gamma, bandwidth).sum().backward()
    torch.testing.assert_close(t1.grad, t2.grad, **GRAD_TOL)


@pytest.mark.cuda
def test_kernel_keeps_the_sentinel_on_gpu(cuda_device):
    d = torch.from_numpy(_tables((3, 10, 4), seed=6)).to(cuda_device)
    assert (softdtw_cuda.softdtw_dp_cuda(d, 0.1, 2.0) == 1e30).all()
