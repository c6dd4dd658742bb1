"""Port OTAM DP (plain wavefront, and kernel K1 on a GPU) against the JAX
package's scan wavefront and its Pallas kernel (interpret mode on the CPU).
K1 has two modes: table mode (``otam_dp_cuda``, behind ``otam_cum_dist``)
and fused mode (``otam_distance_cuda``: cosine table and both DP directions
in one launch, behind ``otam_distance``); their plain versions are the
wavefront and ``otam_distance_plain``.

The JAX package is imported inside the fixture that needs it, so the GPU
cases also run on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_otam.py
"""

import types

import numpy as np
import pytest
import torch

from clipspm_tpu_torch.ops import otam as totam
from clipspm_tpu_torch.ops import otam_cuda, softdtw_cuda

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
@pytest.mark.parametrize("lbda", [0.5, 0.1])
def test_otam_distance_matches_jax(ref, lbda, bidirectional):
    # the plain composition is K1's fused mode's plain version; on a CPU
    # tensor otam_distance is that composition
    rng = np.random.default_rng(4)
    sup = rng.normal(size=(5, 8, 16)).astype(np.float32)
    qry = rng.normal(size=(3, 8, 16)).astype(np.float32)
    got = totam.otam_distance_plain(torch.from_numpy(sup),
                                    torch.from_numpy(qry), lbda,
                                    bidirectional).numpy()
    want = np.asarray(ref.otam.otam_distance(
        ref.jnp.asarray(sup), ref.jnp.asarray(qry), lbda=lbda,
        bidirectional=bidirectional))
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        totam.otam_distance(torch.from_numpy(sup), torch.from_numpy(qry),
                            lbda, bidirectional).numpy(), got)


def test_otam_distance_gradients_match_jax(ref):
    rng = np.random.default_rng(9)
    sup = rng.normal(size=(4, 8, 16)).astype(np.float32)
    qry = rng.normal(size=(2, 8, 16)).astype(np.float32)
    ts = torch.from_numpy(sup).requires_grad_(True)
    tq = torch.from_numpy(qry).requires_grad_(True)
    otam_cuda.otam_distance(ts, tq, 0.5).sum().backward()
    gs, gq = ref.jax.grad(lambda s, q: ref.jnp.sum(
        ref.otam.otam_distance(s, q, lbda=0.5)), argnums=(0, 1))(
        ref.jnp.asarray(sup), ref.jnp.asarray(qry))
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(gs), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(gq), rtol=2e-4,
                               atol=2e-4)


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
    before = (otam_cuda.launches, softdtw_cuda.launches)
    otam_cuda.otam_cum_dist(torch.from_numpy(_tables((3, 8, 8))), 0.5)
    totam.otam_distance(torch.randn(4, 8, 16), torch.randn(2, 8, 16))
    totam.otam_distance(torch.randn(4, 8, 16), torch.randn(2, 8, 16), 0.1,
                        bidirectional=False)
    assert (otam_cuda.launches, softdtw_cuda.launches) == before


class FakeCudaTensor:
    """What an entry reads of a tensor before it would build or launch
    (device, dtype, shape, contiguity), on a CUDA device, so the refusals
    are tested without a GPU."""

    def __init__(self, shape, dtype=torch.float32, contiguous=True):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device("cuda", 0)
        self._contiguous = contiguous

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return self._contiguous


def _refusing_library():
    raise AssertionError("the entry built the kernel before refusing")


@pytest.mark.parametrize("support,query,error,match", [
    (torch.zeros(5, 8, 16), torch.zeros(5, 8, 16), ValueError, "CUDA"),
    (FakeCudaTensor((5, 8, 16), torch.bfloat16), FakeCudaTensor((5, 8, 16)),
     TypeError, "float32"),
    (FakeCudaTensor((5, 8, 16)), FakeCudaTensor((5, 8, 16), torch.float16),
     TypeError, "float32"),
    (FakeCudaTensor((5, 33, 16)), FakeCudaTensor((5, 8, 16)), ValueError,
     "frames"),
    (FakeCudaTensor((5, 8, 16)), FakeCudaTensor((5, 33, 16)), ValueError,
     "frames"),
    (FakeCudaTensor((5, 8, 16), contiguous=False),
     FakeCudaTensor((5, 8, 16)), ValueError, "contiguous"),
    (FakeCudaTensor((5, 8, 16)), FakeCudaTensor((5, 8, 12)), ValueError,
     "width"),
], ids=["cpu", "bf16", "fp16", "wide-support", "wide-query",
        "non-contiguous", "widths"])
def test_fused_entry_refuses_without_building(monkeypatch, support, query,
                                              error, match):
    monkeypatch.setattr(otam_cuda, "_library", _refusing_library)
    with pytest.raises(error, match=match):
        otam_cuda.otam_distance_cuda(support, query, 0.5, True, 0.01)


@pytest.mark.parametrize("tables,error,match", [
    (torch.zeros(2, 8, 8), ValueError, "CUDA"),
    (FakeCudaTensor((2, 8, 8), torch.bfloat16), TypeError, "float32"),
    (FakeCudaTensor((2, 8, 33)), ValueError, "Ms"),
], ids=["cpu", "bf16", "wide"])
def test_table_entry_refuses_without_building(monkeypatch, tables, error,
                                              match):
    monkeypatch.setattr(otam_cuda, "_library", _refusing_library)
    with pytest.raises(error, match=match):
        otam_cuda.otam_dp_cuda(tables, 0.5)


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


@pytest.mark.cuda
@pytest.mark.parametrize("lbda", [0.5, 0.1])
@pytest.mark.parametrize("L,Ms", [(8, 32), (32, 32), (3, 17), (1, 5),
                                  (6, 1)])
def test_table_mode_wide_and_odd_shapes_on_gpu(cuda_device, L, Ms, lbda):
    d = torch.from_numpy(_tables((37, L, Ms), seed=L * 100 + Ms)).to(
        cuda_device)
    torch.testing.assert_close(otam_cuda.otam_dp_cuda(d, lbda),
                               totam.otam_cum_dist(d, lbda), **TOL)


# fp32 fused mode: the dot products are summed in another order than
# cuBLAS's, a few ulps of each table entry, carried through the DP
FUSED_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("Q,S,Lq,Ls,D,bidirectional,lbda", [
    (5, 5, 8, 8, 1024, True, 0.5),
    (5, 5, 8, 8, 1024, False, 0.5),
    (1, 5, 8, 8, 1024, True, 0.5),
    (5, 5, 8, 8, 1021, True, 0.1),
    (3, 4, 8, 5, 64, True, 0.5),
    (2, 3, 20, 32, 100, True, 0.5),
    (2, 3, 32, 1, 7, False, 0.1),
    # the ViT-B/16 tower's width: class and task distances in evaluation,
    # task tokens, and the class and task distances in training
    (5, 5, 8, 8, 512, True, 0.5),
    (1, 5, 8, 8, 512, True, 0.5),
    (20, 5, 8, 8, 512, True, 0.5),
])
def test_fused_mode_matches_plain_on_gpu(cuda_device, Q, S, Lq, Ls, D,
                                         bidirectional, lbda):
    gen = torch.Generator().manual_seed(Q * 1000 + D)
    sup = torch.randn(S, Ls, D, generator=gen).to(cuda_device)
    qry = torch.randn(Q, Lq, D, generator=gen).to(cuda_device)
    before = otam_cuda.launches
    got = otam_cuda.otam_distance(sup, qry, lbda, bidirectional)
    assert otam_cuda.launches == before + 1
    want = totam.otam_distance_plain(sup, qry, lbda, bidirectional)
    assert got.shape == (Q, S)
    torch.testing.assert_close(got, want, **FUSED_TOL)
    s1, q1 = sup.clone().requires_grad_(True), qry.clone().requires_grad_(True)
    s2, q2 = sup.clone().requires_grad_(True), qry.clone().requires_grad_(True)
    otam_cuda.otam_distance(s1, q1, lbda, bidirectional).sum().backward()
    totam.otam_distance_plain(s2, q2, lbda, bidirectional).sum().backward()
    torch.testing.assert_close(s1.grad, s2.grad, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(q1.grad, q2.grad, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_fused_mode_takes_the_heads_strided_inputs_on_gpu(cuda_device):
    # the clipspm head's task query: _qu[1:] of a transposed tensor
    gen = torch.Generator().manual_seed(11)
    base = torch.randn(8, 6, 1024, generator=gen).to(cuda_device)
    qry = base.transpose(0, 1)[1:]
    sup = torch.randn(5, 8, 1024, generator=gen).to(cuda_device)
    assert not qry.is_contiguous()
    torch.testing.assert_close(totam.otam_distance(sup, qry),
                               totam.otam_distance_plain(sup, qry),
                               **FUSED_TOL)
