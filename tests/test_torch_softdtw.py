"""Port soft-DTW (plain wavefront, and kernel K2 on a GPU) against the JAX
package's scan wavefront and its Pallas kernel (interpret mode on the CPU).

Both sides use the clamped soft-min (clamp at 80, sentinel 1e30), so the
forward is held within 2e-5 in fp32 and gradients within 2e-4. K2 has two
modes: table mode (``softdtw_dp_cuda``, behind ``softdtw_from_dists``) and
fused mode (``softdtw_cos_padded_cuda``: cosine table, query-axis padding
and both directions in one launch, behind ``softdtw``); their plain
versions are the wavefront and ``softdtw_cos_padded_plain``. The JAX
package is imported inside the fixture that needs it, so the GPU cases also
run on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_softdtw.py
"""

import importlib
import types

import numpy as np
import pytest
import torch

from clipspm_tpu_torch.ops import otam_cuda, softdtw_cuda
from clipspm_tpu_torch.ops import softdtw as tsdtw

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


@pytest.mark.parametrize("bandwidth", [0.0, 2.0])
@pytest.mark.parametrize("gamma", [0.1, 1.0])
@pytest.mark.parametrize("M", [8, 5])
def test_cos_padded_plain_matches_jax(ref, M, gamma, bandwidth):
    # the plain composition is K2's fused mode's plain version; on a CPU
    # tensor softdtw(normalize=False, dist="cos") is that composition
    rng = np.random.default_rng(10 + M)
    x = rng.normal(size=(6, 8, 16)).astype(np.float32)
    y = rng.normal(size=(6, M, 16)).astype(np.float32)
    got = tsdtw.softdtw_cos_padded_plain(torch.from_numpy(x),
                                         torch.from_numpy(y), gamma,
                                         bandwidth).numpy()
    want = np.asarray(ref.sdtw.softdtw(ref.jnp.asarray(x), ref.jnp.asarray(y),
                                       gamma, normalize=False,
                                       bandwidth=bandwidth, dist="cos"))
    assert got.shape == (6,) and want.shape == (6, 1)
    np.testing.assert_allclose(got, want[:, 0], **TOL)
    np.testing.assert_array_equal(
        tsdtw.softdtw(torch.from_numpy(x), torch.from_numpy(y), gamma,
                      bandwidth=bandwidth).numpy(), got[:, None])


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
    before = (otam_cuda.launches, softdtw_cuda.launches)
    softdtw_cuda.softdtw_from_dists(torch.from_numpy(_tables((3, 10, 8))),
                                    0.1)
    tsdtw.softdtw(torch.randn(2, 8, 4), torch.randn(2, 8, 4), gamma=0.1)
    tsdtw.softdtw(torch.randn(2, 8, 4), torch.randn(2, 6, 4), gamma=1.0,
                  bandwidth=2.0)
    tsdtw.softdtw(torch.randn(2, 8, 4), torch.randn(2, 8, 4), normalize=True)
    assert (otam_cuda.launches, softdtw_cuda.launches) == before


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        softdtw_cuda.softdtw_dp_cuda(torch.zeros(2, 10, 8), 0.1)


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


@pytest.mark.parametrize("x,y,error,match", [
    (torch.zeros(25, 8, 64), torch.zeros(25, 8, 64), ValueError, "CUDA"),
    (FakeCudaTensor((25, 8, 64), torch.bfloat16), FakeCudaTensor((25, 8, 64)),
     TypeError, "float32"),
    (FakeCudaTensor((25, 8, 64)), FakeCudaTensor((25, 8, 64), torch.float16),
     TypeError, "float32"),
    (FakeCudaTensor((25, 33, 64)), FakeCudaTensor((25, 8, 64)), ValueError,
     "steps"),
    (FakeCudaTensor((25, 8, 64)), FakeCudaTensor((25, 33, 64)), ValueError,
     "steps"),
    (FakeCudaTensor((25, 8, 64)), FakeCudaTensor((25, 8, 64),
                                                 contiguous=False),
     ValueError, "contiguous"),
    (FakeCudaTensor((25, 8, 64)), FakeCudaTensor((24, 8, 64)), ValueError,
     "batch"),
], ids=["cpu", "bf16", "fp16", "wide-x", "wide-y", "non-contiguous",
        "batches"])
def test_fused_entry_refuses_without_building(monkeypatch, x, y, error,
                                              match):
    monkeypatch.setattr(softdtw_cuda, "_library", _refusing_library)
    with pytest.raises(error, match=match):
        softdtw_cuda.softdtw_cos_padded_cuda(x, y, 0.1)


@pytest.mark.parametrize("tables,error,match", [
    (FakeCudaTensor((2, 10, 8), torch.bfloat16), TypeError, "float32"),
    (FakeCudaTensor((2, 10, 33)), ValueError, "M <="),
], ids=["bf16", "wide"])
def test_table_entry_refuses_without_building(monkeypatch, tables, error,
                                              match):
    monkeypatch.setattr(softdtw_cuda, "_library", _refusing_library)
    with pytest.raises(error, match=match):
        softdtw_cuda.softdtw_dp_cuda(tables, 0.1)


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


@pytest.mark.cuda
@pytest.mark.parametrize("gamma,bandwidth", [(0.1, 0.0), (1.0, 2.0)])
@pytest.mark.parametrize("N,M", [(10, 32), (40, 17), (1, 1), (5, 16)])
def test_table_mode_wide_and_odd_shapes_on_gpu(cuda_device, N, M, gamma,
                                               bandwidth):
    d = torch.from_numpy(_tables((37, N, M), seed=N * 100 + M)).to(
        cuda_device)
    torch.testing.assert_close(
        softdtw_cuda.softdtw_dp_cuda(d, gamma, bandwidth),
        tsdtw.softdtw_from_dists(d, gamma, bandwidth), **TOL)


# fp32 fused mode: the dot products are summed in another order than
# cuBLAS's, and the reverse table is the forward one read transposed where
# the plain version takes a second matmul: a few ulps of each table entry,
# carried through the DP
FUSED_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("gamma,bandwidth", [(0.1, 0.0), (1.0, 0.0),
                                             (0.1, 2.0), (1.0, 2.0)])
@pytest.mark.parametrize("B,N,M,D", [(25, 8, 8, 2048), (3, 10, 6, 61),
                                     (2, 20, 32, 100), (4, 1, 3, 8),
                                     (100, 8, 8, 2048)])   # ta2n training
def test_fused_mode_matches_plain_on_gpu(cuda_device, B, N, M, D, gamma,
                                         bandwidth):
    gen = torch.Generator().manual_seed(B * 1000 + D)
    x = torch.randn(B, N, D, generator=gen).to(cuda_device)
    y = torch.randn(B, M, D, generator=gen).to(cuda_device)
    before = softdtw_cuda.launches
    got = tsdtw.softdtw(x, y, gamma, bandwidth=bandwidth)
    assert softdtw_cuda.launches == before + 1
    assert got.shape == (B, 1)
    want = tsdtw.softdtw_cos_padded_plain(x, y, gamma, bandwidth)
    torch.testing.assert_close(got[:, 0], want, **FUSED_TOL)
    x1, y1 = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    x2, y2 = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    softdtw_cuda.softdtw_cos_padded(x1, y1, gamma, bandwidth).sum().backward()
    tsdtw.softdtw_cos_padded_plain(x2, y2, gamma,
                                   bandwidth).sum().backward()
    torch.testing.assert_close(x1.grad, x2.grad, **GRAD_TOL)
    torch.testing.assert_close(y1.grad, y2.grad, **GRAD_TOL)


@pytest.mark.cuda
def test_fused_mode_takes_the_heads_strided_inputs_on_gpu(cuda_device):
    # the TA2N head's aligned query: pairs[..., D:] of the ACM pair tensor
    gen = torch.Generator().manual_seed(12)
    pairs = torch.randn(5, 1, 8, 2 * 2048, generator=gen).to(cuda_device)
    qu_al, su_al = pairs[..., 2048:], pairs[..., :2048]
    x, y = qu_al.reshape(5, 8, 2048), su_al.reshape(5, 8, 2048)
    assert not x.is_contiguous()
    torch.testing.assert_close(tsdtw.softdtw(x, y, gamma=0.1)[:, 0],
                               tsdtw.softdtw_cos_padded_plain(x, y, 0.1),
                               **FUSED_TOL)


@pytest.mark.cuda
def test_other_forms_use_the_table_mode_on_gpu(cuda_device):
    gen = torch.Generator().manual_seed(13)
    x = torch.randn(4, 8, 16, generator=gen).to(cuda_device)
    y = torch.randn(4, 7, 16, generator=gen).to(cuda_device)
    for kw, launches in ((dict(normalize=True), 3), (dict(dist="l2sq"), 2)):
        before = softdtw_cuda.launches
        got = tsdtw.softdtw(x, y, 1.0, **kw)
        assert softdtw_cuda.launches == before + launches
        want = tsdtw.softdtw(x.cpu(), y.cpu(), 1.0, **kw)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_fused_backward_under_bf16_autocast_is_fp32_on_gpu(cuda_device):
    """ta2n's training shape (B = 5 ways x 20 queries = 100): forward and
    ``backward()`` both called inside a bf16 autocast block. The replay's
    cosine matmuls stay fp32, so the gradients are fp32 and equal the fp32
    plain gradients (in bf16 they would be ~1e-2 off)."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(100, 8, 2048, generator=gen).to(cuda_device)
    y = torch.randn(100, 8, 2048, generator=gen).to(cuda_device)
    x1, y1 = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = softdtw_cuda.softdtw_cos_padded(x1, y1, 0.1)
        assert out.dtype == torch.float32
        out.sum().backward()
    x2, y2 = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    tsdtw.softdtw_cos_padded_plain(x2, y2, 0.1).sum().backward()
    assert x1.grad.dtype == y1.grad.dtype == torch.float32
    torch.testing.assert_close(x1.grad, x2.grad, **GRAD_TOL)
    torch.testing.assert_close(y1.grad, y2.grad, **GRAD_TOL)


@pytest.mark.parametrize("fn", ["cos_padded", "table"])
def test_autograd_functions_run_with_autocast_off(monkeypatch, fn):
    """K2's ``autograd.Function``s under CUDA autocast (its state set by
    hand: this machine has no GPU; the kernel entries stand in as the plain
    versions on CPU tensors): the forward and the backward's replay both
    run with autocast off (``custom_fwd(cast_inputs=float32)``,
    ``custom_bwd``), whatever state ``backward()`` is called in."""
    seen = []

    def watching(plain):
        def run(*args):
            seen.append(torch.is_autocast_enabled("cuda"))
            return plain(*args)
        return run

    gen = torch.Generator().manual_seed(3)
    if fn == "cos_padded":
        args = [torch.randn(4, 8, 16, generator=gen),
                torch.randn(4, 8, 16, generator=gen)]
        plain = tsdtw.softdtw_cos_padded_plain
        monkeypatch.setattr(softdtw_cuda, "softdtw_cos_padded_cuda",
                            watching(plain))
        monkeypatch.setattr(softdtw_cuda, "softdtw_cos_padded_plain",
                            watching(plain))
        apply = softdtw_cuda._SoftDTWCosPadded.apply
    else:
        args = [torch.rand(4, 10, 8, generator=gen) * 2.0]
        plain = tsdtw.softdtw_from_dists
        monkeypatch.setattr(softdtw_cuda, "softdtw_dp_cuda", watching(plain))
        monkeypatch.setattr(softdtw_cuda, "plain_from_dists", watching(plain))
        apply = softdtw_cuda._SoftDTW.apply
    leaves = [a.requires_grad_(True) for a in args]
    state = torch.is_autocast_enabled("cuda")
    torch.set_autocast_enabled("cuda", True)
    try:
        out = apply(*leaves, 0.1, 0.0)
        out.sum().backward()
    finally:
        torch.set_autocast_enabled("cuda", state)
    assert seen == [False, False]
    assert all(a.grad.dtype == torch.float32 for a in leaves)
