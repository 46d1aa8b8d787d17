"""The pieces the rest of the zoo is built from, port vs the JAX package
and the torch goldens (CPU): the bicubic and nearest resizes, the gated
fusion's alpha maps, ``metapool_spatial``, ReLayNet's max pool with its
argmax mask and the unpooling, and the CRPE head split."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcct_tpu.models.ftc import pinned_alpha_nchw as jax_pinned_alpha
from tcct_tpu.models.mpvit import _fit_crpe_window as jax_fit_crpe_window
from tcct_tpu.models.relaynet import max_pool_with_mask as jax_max_pool_with_mask
from tcct_tpu.models.relaynet import max_unpool as jax_max_unpool
from tcct_tpu.ops.pool import metapool_spatial as jax_metapool_spatial
from tcct_tpu.ops.resize import resize_bicubic as jax_resize_bicubic
from tcct_tpu.ops.resize import resize_nearest as jax_resize_nearest
from tcct_tpu_torch.models.ftc import gate_alpha, pinned_alpha_nchw, pinned_gate
from tcct_tpu_torch.models.mpvit import _fit_crpe_window
from tcct_tpu_torch.models.relaynet import max_pool_with_mask, max_unpool
from tcct_tpu_torch.ops.pool import metapool_spatial
from tcct_tpu_torch.ops.resize import resize_bicubic, resize_nearest


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def test_bicubic_matches_golden(golden):
    """torch's own ``F.interpolate(mode='bicubic')`` is the golden
    (tests/test_ops.py's bound)."""
    g = golden("ops")
    out = resize_bicubic(_nchw(g["x"]), (21, 27), align_corners=False)
    np.testing.assert_allclose(_nhwc(out), g["cub"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("size", [(21, 27), (3, 4), (11, 3), (7, 9), (1, 5)])
def test_bicubic_matches_jax(size, align_corners):
    x = np.random.default_rng(0).standard_normal((2, 7, 9, 3)).astype(np.float32)
    want = np.asarray(jax_resize_bicubic(jnp.asarray(x), size, align_corners=align_corners))
    got = _nhwc(resize_bicubic(_nchw(x), size, align_corners))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    bf = resize_bicubic(_nchw(x).bfloat16(), size, align_corners)
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("size", [(13, 17), (3, 4), (7, 9), (20, 2)])
def test_nearest_matches_jax_and_torch(size):
    """Bitwise JAX's and torch's ``'nearest'`` on the [H, W, ...] numpy
    arrays of the datasets' prep."""
    x = np.random.default_rng(1).standard_normal((7, 9, 3)).astype(np.float32)
    got = resize_nearest(x, size)
    want = np.asarray(jax_resize_nearest(jnp.asarray(x), size, (0, 1)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _nchw(got[None]).numpy(),
        torch.nn.functional.interpolate(_nchw(x[None]), size=size, mode="nearest").numpy())


def test_pinned_alpha_and_gate_alpha_match_jax():
    """The pinned pattern is JAX's array; a pinned level's map (bicubic,
    clamp) is JAX's gate map at an odd level size, transposed to NCHW; a
    drawn map lies in [0, 1] with the level's shape, channels_last."""
    np.testing.assert_array_equal(pinned_alpha_nchw(2, 5, 3, 4), jax_pinned_alpha(2, 5, 3, 4))
    shape = (2, 5, 100, 70)
    with pinned_gate():
        got = gate_alpha(shape, None, "cpu")
    a = jnp.asarray(jax_pinned_alpha(2, 5, 3, 3)).transpose(0, 2, 3, 1)
    want = jnp.clip(jax_resize_bicubic(a, (100, 70), align_corners=False), 0.0, 1.0)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0, atol=1e-6)
    drawn = gate_alpha((2, 8, 64, 96), torch.Generator().manual_seed(0), "cpu")
    assert drawn.dtype == torch.float32 and drawn.shape == (2, 8, 64, 96)
    assert float(drawn.min()) >= 0.0 and float(drawn.max()) <= 1.0
    assert drawn.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", [(5, 7), (1, 6), (8, 8)])
def test_metapool_spatial_matches_jax(size, dtype):
    """f32: within 1e-6 with the gradient; bf16: the same bf16 values."""
    H, W = size
    x = np.random.default_rng(2).standard_normal((2, H * W, 6)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xt = torch.from_numpy(x).to(dtype)
    want = np.asarray(jax_metapool_spatial(jnp.asarray(xt.float().numpy()).astype(jdt), size)
                      .astype(jnp.float32))
    got = metapool_spatial(xt, size)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=1e-6 if dtype == torch.float32 else 0)
    if dtype == torch.float32:
        g = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
        jg = jax.grad(lambda v: jnp.sum(jax_metapool_spatial(v, size) * g))(jnp.asarray(x))
        xr = torch.from_numpy(x).requires_grad_(True)
        (metapool_spatial(xr, size) * torch.from_numpy(g)).sum().backward()
        np.testing.assert_allclose(xr.grad.numpy(), np.asarray(jg), rtol=0, atol=1e-6)


def test_max_pool_with_mask_and_unpool_match_jax_with_ties():
    """Pooled values, the first-wins argmax mask and the unpooled map equal
    JAX's on an input full of ties (small integers), f32 and bf16; the
    gradients through pool and unpool (ties share the pooled gradient)
    agree; the mask is f32 whatever x's type."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 3, (2, 8, 12, 4)).astype(np.float32)
    x[0, :2, :2, 0] = 1.0  # a whole window tied
    jp, jm = jax_max_pool_with_mask(jnp.asarray(x))
    for dt in (torch.float32, torch.bfloat16):
        p, m = max_pool_with_mask(_nchw(x).to(dt))
        assert p.dtype == dt and m.dtype == torch.float32
        np.testing.assert_array_equal(_nhwc(p.float()), np.asarray(jp))
        np.testing.assert_array_equal(_nhwc(m), np.asarray(jm))
        assert float(m.reshape(2, 4, 4, 2, 6, 2).sum((3, 5)).max()) == 1.0
    v = rng.standard_normal((2, 4, 6, 4)).astype(np.float32)
    np.testing.assert_array_equal(_nhwc(max_unpool(_nchw(v), _nchw(np.asarray(jm)))),
                                  np.asarray(jax_max_unpool(jnp.asarray(v), jm)))
    g = rng.standard_normal(x.shape).astype(np.float32)

    def jfun(a):
        pooled, mask = jax_max_pool_with_mask(a)
        return jnp.sum(jax_max_unpool(pooled * 2.0, mask) * g) + jnp.sum(pooled ** 2)

    want = np.asarray(jax.grad(jfun)(jnp.asarray(x)))
    xr = _nchw(x).requires_grad_(True)
    pooled, mask = max_pool_with_mask(xr)
    ((max_unpool(pooled * 2.0, mask) * _nchw(g)).sum() + (pooled ** 2).sum()).backward()
    np.testing.assert_allclose(_nhwc(xr.grad), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("heads", [1, 2, 3, 4, 5, 8, 12])
def test_crpe_head_split_matches_jax(heads):
    window = ((3, 2), (5, 3), (7, 3))
    assert _fit_crpe_window(window, heads) == jax_fit_crpe_window(window, heads)
    assert sum(h for _, h in _fit_crpe_window(window, heads)) == heads
