"""The port's depthwise 3x3 backward with its flags -- the residual and the
bias gradient formed in the same call, no ``dx`` when autograd does not
want it -- and at the narrow channel counts, against the JAX package's
gradients (CPU).

On the CPU the wrapper takes the plain backward, so these tests hold what
the kernel is held against on the card (``tests/test_torch_kernels.py``).
The references are ``jax.vjp`` of the JAX package's ``ConvPosEnc``, of its
Pallas depthwise kernel in interpret mode where that kernel takes the
shape, and else of the grouped ``lax`` convolution it replaces.  ``dx`` is
held at 1e-5; ``dw`` and ``db`` are sums over the pixels, held at 1e-5 of
sum|x*g| per tap and of sum|g| (the order of the f32 sums)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcct_tpu_torch.ops.kernels.dwconv as dwmod
from tcct_tpu.models.mpvit import ConvPosEnc as JaxConvPosEnc
from tcct_tpu.ops.pallas.dwconv import dwconv3x3 as jax_dwconv3x3
from tcct_tpu.ops.pallas.dwconv import dwconv3x3_eligible
from tcct_tpu_torch.infer.importer import flatten_variables, from_jax_variables
from tcct_tpu_torch.models.mpvit import ConvPosEnc
from tcct_tpu_torch.ops.kernels.dwconv import (
    dwconv3x3,
    dwconv3x3_backward,
    dwconv3x3_backward_reference,
)


def _case(shape, stride, seed):
    rng = np.random.default_rng(seed)
    B, H, W, C = shape
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = rng.normal(size=shape).astype(np.float32)
    k = rng.normal(size=(3, 3, 1, C)).astype(np.float32)
    g = rng.normal(size=(B, Ho, Wo, C)).astype(np.float32)
    return x, k, g


def _jax_conv(stride, C):
    """The JAX package's depthwise 3x3 as a function of (x, k): its Pallas
    kernel in interpret mode where it takes the shape, else the grouped
    convolution that the kernel replaces."""
    def pallas(a, b):
        return jax_dwconv3x3(a, b, interpret=True, stride=stride)

    def lax(a, b):
        return jax.lax.conv_general_dilated(a, b, (stride, stride), ((1, 1), (1, 1)),
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                            feature_group_count=C,
                                            precision=jax.lax.Precision.HIGHEST)

    return pallas, lax


def _jax_vjp(x, k, g, stride):
    pallas, lax = _jax_conv(stride, x.shape[-1])
    fn = pallas if dwconv3x3_eligible(x.shape, jnp.float32, stride) else lax
    _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(k))
    return tuple(np.asarray(t) for t in vjp(jnp.asarray(g)))


def _sum_bound(x, g, stride):
    """1e-5 of sum|x*g| per tap, and of sum|g| per channel."""
    tap = dwconv3x3_backward_reference(torch.from_numpy(np.abs(x)), torch.zeros(3, 3, x.shape[-1]),
                                       torch.from_numpy(np.abs(g)), stride)[1].numpy()
    return 1e-5 * tap + 1e-7, 1e-5 * np.abs(g).sum((0, 1, 2)) + 1e-7


def _assert_within(got, want, lim):
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert (err <= lim).all(), float((err - lim).max())


@pytest.mark.parametrize("dim,size", [(16, (6, 10)), (40, (5, 7)), (8, (1, 9)), (3, (7, 5))])
def test_conv_pos_enc_backward_matches_jax(dim, size):
    """ConvPosEnc's gradients (tokens, taps, bias) through the port's module
    and through the plain backward with bias and residual on, against
    jax.vjp of the JAX module, weights carried over by from_jax_variables,
    f32."""
    rng = np.random.default_rng(40)
    H, W = size
    x = rng.normal(size=(2, H * W, dim)).astype(np.float32)
    gy = rng.normal(size=(2, H * W, dim)).astype(np.float32)
    jm = JaxConvPosEnc(dim=dim)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), size)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)), variables["params"])
    _, vjp = jax.vjp(lambda p, t: jm.apply({"params": p}, t, size), params, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(gy))
    want_dk = np.asarray(gp["proj"]["kernel"])[:, :, 0]  # [3, 3, C]
    want_db = np.asarray(gp["proj"]["bias"])

    tm = ConvPosEnc(dim)
    tm.load_state_dict(from_jax_variables(flatten_variables({"params": params})), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    got_x, got_w, got_b = torch.autograd.grad(tm(xt, size), (xt, tm.proj.weight, tm.proj.bias),
                                              torch.from_numpy(gy))

    img, gimg = x.reshape(2, H, W, dim), gy.reshape(2, H, W, dim)
    lim_w, lim_b = _sum_bound(img, gimg, 1)
    taps = tm.proj.weight.detach()[:, 0].permute(1, 2, 0)
    dx, dw, db = dwconv3x3_backward_reference(torch.from_numpy(img), taps, torch.from_numpy(gimg),
                                              1, bias=True, residual=True)
    for ddx, ddw, ddb in ((got_x.numpy().reshape(2, H, W, dim),
                           got_w.detach()[:, 0].permute(1, 2, 0).numpy(), got_b.numpy()),
                          (dx.numpy(), dw.numpy(), db.numpy())):
        np.testing.assert_allclose(ddx, np.asarray(gx).reshape(2, H, W, dim), rtol=1e-5,
                                   atol=1e-5)
        _assert_within(ddw, want_dk, lim_w)
        _assert_within(ddb, want_db, lim_b)


@pytest.mark.parametrize("shape", [(2, 8, 12, 8), (1, 9, 7, 5), (2, 6, 10, 4)])
def test_bias_gradient_at_stride_2_matches_jax(shape):
    """The bias without the residual, at stride 2: jax.vjp of the depthwise
    conv plus a bias against the plain backward with ``bias=True`` and
    against autograd through the port's ``dwconv3x3(x, w, 2, bias)``."""
    x, k, g = _case(shape, 2, 41)
    b = np.random.default_rng(42).normal(size=shape[-1]).astype(np.float32)
    pallas, lax = _jax_conv(2, shape[-1])
    conv = pallas if dwconv3x3_eligible(shape, jnp.float32, 2) else lax
    _, vjp = jax.vjp(lambda a, kk, bb: conv(a, kk) + bb, jnp.asarray(x), jnp.asarray(k),
                     jnp.asarray(b))
    want_dx, want_dk, want_db = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    lim_w, lim_b = _sum_bound(x, g, 2)

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(k[:, :, 0])).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    auto = torch.autograd.grad(dwconv3x3(xt, wt, 2, bt), (xt, wt, bt), torch.from_numpy(g))
    plain = dwconv3x3_backward_reference(torch.from_numpy(x), wt.detach(), torch.from_numpy(g), 2,
                                         bias=True)
    for dx, dw, db in (auto, plain):
        np.testing.assert_allclose(dx.detach().numpy(), want_dx, rtol=1e-5, atol=1e-5)
        _assert_within(dw.detach().numpy(), want_dk[:, :, 0], lim_w)
        _assert_within(db.detach().numpy(), want_db, lim_b)


# (x needs a gradient, the conv has a bias that needs one, residual, stride)
@pytest.mark.parametrize("need_x,with_bias,residual,stride",
                         [(True, True, True, 1), (False, True, True, 1), (False, False, False, 1),
                          (True, False, False, 2), (False, True, False, 2),
                          (True, True, False, 1)])
def test_backward_forms_only_the_gradients_asked_for(monkeypatch, need_x, with_bias, residual,
                                                     stride):
    """Autograd's backward makes one dwconv3x3_backward call that asks for
    dx only when x needs a gradient and for db only when the bias does; the
    wrapper then returns None in their place, and the gradients it does
    form equal the plain backward's."""
    x, k, g = _case((2, 7, 9, 6), stride, 43)
    calls = []
    real = dwmod.dwconv3x3_backward

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append((kw, out))
        return out

    monkeypatch.setattr(dwmod, "dwconv3x3_backward", spy)
    xt = torch.from_numpy(x).requires_grad_(need_x)
    wt = torch.from_numpy(np.ascontiguousarray(k[:, :, 0])).requires_grad_()
    bt = torch.ones(6).requires_grad_() if with_bias else None
    y = dwconv3x3(xt, wt, stride, bt, residual)
    y.backward(torch.from_numpy(g))
    (kw, (dx, dw, db)), = calls
    assert kw == {"bias": with_bias, "residual": residual, "need_dx": need_x}
    assert (dx is None) == (not need_x) and (db is None) == (not with_bias)
    assert (xt.grad is None) == (not need_x)
    want = dwconv3x3_backward_reference(torch.from_numpy(x), wt.detach(), torch.from_numpy(g),
                                        stride, bias=True, residual=residual)
    assert torch.equal(wt.grad, want[1])
    if need_x:
        assert torch.equal(xt.grad, want[0])
    if with_bias:
        assert torch.equal(bt.grad, want[2])
    none = dwconv3x3_backward(torch.from_numpy(x), wt.detach(), torch.from_numpy(g), stride,
                              need_dx=False)
    assert none[0] is None and none[2] is None and torch.equal(none[1], want[1])


def test_backward_refuses_the_residual_at_stride_2():
    x, k, g = _case((1, 6, 6, 4), 2, 44)
    with pytest.raises(ValueError, match="stride 1"):
        dwconv3x3_backward(torch.from_numpy(x), torch.from_numpy(k[:, :, 0].copy()),
                           torch.from_numpy(g), 2, residual=True)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("C", [2, 3, 5, 7])
def test_narrow_channels_match_jax(C, stride):
    """The narrow channel counts (a thread of the kernel holds parts of
    several pixels) at odd H and W: dx, dw and db of the wrapper (CPU: the
    plain backward) against jax.vjp; ``tests/test_torch_ops.py`` covers
    C = 1 and 4."""
    x, k, g = _case((2, 9, 7, C), stride, 45 + C)
    want_dx, want_dk = _jax_vjp(x, k, g, stride)
    dx, dw, db = dwconv3x3_backward(torch.from_numpy(x), torch.from_numpy(k[:, :, 0].copy()),
                                    torch.from_numpy(g), stride, bias=True)
    lim_w, lim_b = _sum_bound(x, g, stride)
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=1e-5, atol=1e-5)
    _assert_within(dw.numpy(), want_dk[:, :, 0], lim_w)
    _assert_within(db.numpy(), g.sum((0, 1, 2)), lim_b)
