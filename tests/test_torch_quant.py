"""The port's dynamic int8 matmul (``ops/quant.py``) against the JAX
package's (``clipspm_tpu/ops/quant.py``).

The same numpy inputs go through both, the JAX function compiled as the
JAX package runs it (``jit``: XLA turns the division of the row maxima by
127 into a multiplication by its reciprocal, where eager JAX divides): the
int8 codes of the activations and of the weights must be identical, the
int32 sums exact, the outputs within 1e-6 relative (and of the largest);
against the float product, the JAX test's own bound (median error below
0.02 of the output's std, largest below 0.2). On the
CPU the product of the codes is the plain float64 one; on the card it is
``torch._int_mm``, held bit for bit against the plain version by the
``cuda`` cases (and by ``chip_smoke.py``'s ``quant`` phase at ViT-B/16's
shapes). The JAX package is imported by the cases that need it, so the
``cuda`` cases run on a machine without JAX.
"""

import numpy as np
import pytest
import torch

from clipspm_tpu_torch.ops import quant

# (rows, K, M, input dtype): the JAX test's shape; a ViT block's
# projections at test-tiny (rows = 2 frames x 17 tokens); a bf16 input;
# ViT-B/16's c_proj at 2 frames, 1.2M codes (where one scale a ulp off
# would flip some)
SHAPES = [(64, 96, 32, "float32"), (34, 64, 192, "float32"),
          (34, 256, 64, "float32"), (40, 64, 256, "bfloat16"),
          (394, 3072, 768, "float32")]


def _inputs(R, K, M, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(R, K)).astype(np.float32)
    x[3] = 0.0                          # a zero row: the 1e-8 scale floor
    w = rng.normal(size=(K, M)).astype(np.float32)   # JAX's [K, M] kernel
    b = rng.normal(size=(M,)).astype(np.float32)
    return x, w, b


def _jax_codes(jnp, a, axis):
    s = jnp.maximum(jnp.max(jnp.abs(a), axis=axis, keepdims=True) / 127.0,
                    1e-8)
    return jnp.round(a / s).astype(jnp.int8)


@pytest.mark.parametrize("R,K,M,dtype", SHAPES)
def test_codes_sums_and_outputs_match_jax(R, K, M, dtype):
    import jax
    import jax.numpy as jnp

    from clipspm_tpu.ops.quant import int8_matmul as jax_int8_matmul

    x, w, b = _inputs(R, K, M, seed=R + K + M)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).to(tdt)
    xq, sx = quant.quantize_rows(tx.float())
    wq, sw = quant.quantize_rows(torch.from_numpy(w.T.copy()))
    codes = jax.jit(lambda a, axis: _jax_codes(jnp, a, axis),
                    static_argnums=1)
    jxq = np.asarray(codes(jx.astype(jnp.float32), -1))
    jwq = np.asarray(codes(jnp.asarray(w), 0))
    np.testing.assert_array_equal(xq.numpy(), jxq)
    np.testing.assert_array_equal(wq.numpy(), jwq.T)
    assert int(xq[3].abs().max()) == 0
    acc = quant.int8_mm(xq, wq)
    jacc = np.asarray(jax.lax.dot_general(
        jnp.asarray(jxq), jnp.asarray(jwq), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), jacc)
    np.testing.assert_array_equal(
        acc.numpy(), jxq.astype(np.int64) @ jwq.astype(np.int64))
    got = quant.int8_linear(tx, torch.from_numpy(w.T.copy()),
                            torch.from_numpy(b))
    want = jax.jit(jax_int8_matmul)(jx, jnp.asarray(w), jnp.asarray(b))
    assert got.dtype == tdt and got.shape == (R, M)
    # compiled XLA may fuse the rescale and the bias into one FMA: where
    # the bias cancels the product, a ulp of the product is what remains,
    # so the bound is relative to the largest output too
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_close_to_the_float_product():
    """The JAX package's own bound (tests/test_int8_eval.py)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(64, 96)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(96, 32)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(32,)).astype(np.float32))
    ref = (x @ w + b).numpy()
    err = np.abs(quant.int8_linear(x, w.t(), b).numpy() - ref)
    scale = float(np.abs(ref).std())
    assert float(np.median(err)) < 0.02 * scale
    assert float(err.max()) < 0.2 * scale


def test_batched_input_and_autocast_keep_the_int8_path():
    """``[B, L, K]`` inputs flatten to rows; under bf16 autocast the codes
    come from the fp32 view of ``x`` and the output takes ``x``'s dtype."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 17, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(48, 64)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(48,)).astype(np.float32))
    flat = quant.int8_linear(x.reshape(34, 64), w, b).reshape(2, 17, 48)
    torch.testing.assert_close(quant.int8_linear(x, w, b), flat, rtol=0,
                               atol=0)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = quant.int8_linear(x, w, b)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, flat, rtol=0, atol=0)


def test_cpu_product_is_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.integers(-127, 128, (40, 3072), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (24, 3072), dtype=np.int8))
    before = quant.launches
    got = quant.int8_mm(a, b)
    assert quant.launches == before
    want = a.numpy().astype(np.int64) @ b.numpy().astype(np.int64).T
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the int8 GEMM (torch._int_mm) "
                    "has no CPU route in the port")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("R,K,M", [(5910, 768, 2304), (5910, 768, 768),
                                   (5910, 768, 3072), (5910, 3072, 768),
                                   (40, 64, 256)])
def test_int8_gemm_equals_the_plain_version_on_gpu(cuda_device, R, K, M):
    gen = torch.Generator().manual_seed(R + K + M)
    a = torch.randint(-127, 128, (R, K), generator=gen, dtype=torch.int8)
    b = torch.randint(-127, 128, (M, K), generator=gen, dtype=torch.int8)
    before = quant.launches
    got = quant.int8_mm(a.to(cuda_device), b.to(cuda_device))
    assert quant.launches == before + 1
    assert torch.equal(got.cpu(), quant.int8_mm_plain(a, b))


@pytest.mark.cuda
def test_refused_int8_gemm_shape_raises_on_gpu(cuda_device):
    a = torch.ones(16, 64, dtype=torch.int8, device=cuda_device)
    b = torch.ones(32, 64, dtype=torch.int8, device=cuda_device)
    with pytest.raises(RuntimeError):
        quant.int8_mm(a, b)
