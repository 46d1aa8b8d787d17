"""The port's fixed-order formulations of the two train-step sums that used
float atomics on the card, against the JAX package (CPU).

- ``losses/polar.py::points_selection_bins``: the 33-segment sum, now one
  f32 product of the one-hot bin matrix and the features, against
  ``tcct_tpu.losses.points_selection_bins`` (``segment_sum``) at the bounds
  of ``tests/test_torch_losses.py`` (rtol 1e-5, atol 1e-6; gradients 1e-5 of
  their max), with an empty class, fewer class pixels than bins, heavy bf16
  ties and a pixel count that is no multiple of the bins.
- ``ops/resize.py::resize_bilinear``: forward ``F.interpolate`` bit for bit;
  backward the adjoint ``A_h^T dY A_w``, against the VJP of
  ``tcct_tpu.ops.resize.resize_bilinear`` and against ``F.interpolate``'s
  autograd, within 1e-5 of each one's max (f32 summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tcct_tpu.losses import points_selection_bins as jax_points_selection_bins
from tcct_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from tcct_tpu_torch.losses import points_selection_bins
from tcct_tpu_torch.ops.resize import interpolation_matrix, resize_bilinear


def _bins_case(P, L, frac, levels, seed):
    """Seeded features, probabilities with ``levels`` distinct values (bf16
    ties when few) and a class mask covering about ``frac`` of the pixels."""
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(P, L)).astype(np.float32)
    prob = (np.round(rng.uniform(size=P) * levels) / levels).astype(np.float32)
    true = (rng.uniform(size=P) < frac).astype(np.float32)
    return feat, prob, true


# (P, L, class share, distinct probabilities): an empty class, fewer class
# pixels than bins, heavy ties, P no multiple of 32, a class of every pixel
BINS_CASES = [(3000, 8, 0.0, 8), (1000, 8, 0.02, 100), (4096, 16, 0.6, 4), (3001, 8, 0.5, 1000),
              (777, 5, 1.0, 3), (20, 4, 0.5, 8)]


@pytest.mark.parametrize("P,L,frac,levels", BINS_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bins_fixed_order_matches_jax(P, L, frac, levels, dtype):
    """The bins against JAX's segment_sum on the same pixels (bf16
    probabilities: the stable sort keeps tied pixels in JAX's order), and
    the gradient into the features against jax.grad."""
    feat, prob, true = _bins_case(P, L, frac, levels, 20 + P)
    fj = jnp.asarray(feat, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    pj, tj = jnp.asarray(prob, jnp.bfloat16), jnp.asarray(true)
    want = np.asarray(jax_points_selection_bins(fj, pj, tj))
    ft = torch.from_numpy(feat).to(dtype).requires_grad_()
    pt = torch.from_numpy(prob).to(torch.bfloat16)
    got = points_selection_bins(ft, pt, torch.from_numpy(true))
    assert got.dtype == torch.float32 and got.shape == (32, L)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    if frac == 0.0:
        assert not bool(got.detach().any())
    g = np.random.default_rng(P).normal(size=(32, L)).astype(np.float32)
    (gf,) = torch.autograd.grad(got, ft, torch.from_numpy(g))
    _, vjp = jax.vjp(lambda f: jax_points_selection_bins(f, pj, tj), fj)
    gj = np.asarray(vjp(jnp.asarray(g))[0], np.float32)
    s = float(np.abs(gj).max()) + 1e-12
    np.testing.assert_allclose(gf.float().numpy() / s, gj / s, atol=1e-5)


def test_bins_gradient_is_a_gather_by_bin():
    """Each pixel's feature gradient is its bin's gradient over the bin
    size, 0 for the pixels outside the bins: one read per row."""
    feat, prob, true = _bins_case(640, 4, 0.7, 16, 3)
    ft = torch.from_numpy(feat).requires_grad_()
    got = points_selection_bins(ft, torch.from_numpy(prob), torch.from_numpy(true))
    g = torch.randn(32, 4)
    (gf,) = torch.autograd.grad(got, ft, g)
    n = int((true > 0.5).sum())
    nper = max(n // 32, 1)
    key = np.where(true > 0.5, prob, -np.inf)
    order = np.argsort(-key, kind="stable")
    want = np.zeros_like(feat)
    for rank, row in enumerate(order[:nper * 32]):
        if true[row] > 0.5:
            want[row] = g[rank // nper].numpy() / nper
    np.testing.assert_allclose(gf.numpy(), want, rtol=1e-6, atol=1e-7)


# (N, C, H, W) -> (Ho, Wo): up, down, odd sizes, one axis unchanged, 1x1
RESIZE_CASES = [((2, 3, 5, 7), (10, 14)), ((2, 4, 9, 5), (4, 3)), ((1, 2, 7, 7), (13, 20)),
                ((2, 3, 6, 8), (6, 17)), ((1, 5, 16, 16), (256, 256)), ((2, 3, 1, 1), (3, 4)),
                ((1, 2, 11, 3), (5, 3))]


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("shape,size", RESIZE_CASES)
def test_bilinear_adjoint_matches_jax_and_torch(shape, size, align_corners, channels_last):
    """Forward bitwise F.interpolate; backward within 1e-5 of each
    reference's max of the VJP of the JAX package's resize (NHWC) and of
    F.interpolate's autograd; the gradient keeps the input's layout."""
    rng = np.random.default_rng(sum(shape) + sum(size))
    x = rng.normal(size=shape).astype(np.float32)
    xt = torch.from_numpy(x)
    if channels_last:
        xt = xt.contiguous(memory_format=torch.channels_last)
    xt.requires_grad_()
    y = resize_bilinear(xt, size, align_corners)
    want_y = F.interpolate(xt.detach(), size=size, mode="bilinear", align_corners=align_corners)
    assert torch.equal(y.detach(), want_y)
    g = rng.normal(size=y.shape).astype(np.float32)
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    if channels_last and shape[1] > 1 and shape[2] * shape[3] > 1:
        assert gx.is_contiguous(memory_format=torch.channels_last)
    x2 = torch.from_numpy(x).requires_grad_()
    (gt,) = torch.autograd.grad(
        F.interpolate(x2, size=size, mode="bilinear", align_corners=align_corners), x2,
        torch.from_numpy(g))
    _, vjp = jax.vjp(lambda a: jax_resize_bilinear(a, size, align_corners),
                     jnp.asarray(np.moveaxis(x, 1, -1)))
    gj = np.moveaxis(np.asarray(vjp(jnp.asarray(np.moveaxis(g, 1, -1)))[0]), -1, 1)
    for want in (gt.numpy(), gj):
        np.testing.assert_allclose(gx.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bilinear_adjoint_rounds_once_to_the_gradient_dtype(dtype):
    """In bf16 the adjoint is the f32 adjoint of the bf16 gradient, rounded
    once to bf16; the matrices are f32 with two nonzeros a row summing to 1."""
    gy = torch.randn(2, 3, 12, 16).to(dtype)
    x = torch.zeros(2, 3, 6, 8, dtype=dtype, requires_grad=True)
    (gx,) = torch.autograd.grad(resize_bilinear(x, (12, 16), True), x, gy)
    assert gx.dtype == dtype
    Ah = interpolation_matrix(6, 12, True, torch.device("cpu"))
    Aw = interpolation_matrix(8, 16, True, torch.device("cpu"))
    assert Ah.dtype == torch.float32 and bool(((Ah != 0).sum(1) <= 2).all())
    torch.testing.assert_close(Ah.sum(1), torch.ones(12))
    # the adjoint's own order, A_h^T (gy A_w): the other association can
    # round an f32 value on the other side of a bf16 tie
    want = (Ah.T @ (gy.float() @ Aw)).to(dtype)
    torch.testing.assert_close(gx.float(), want.float(), rtol=1e-6, atol=1e-6)
