"""PyTorch port ops vs the JAX package and the torch goldens (CPU, f32).

The port's kernel wrappers take their plain PyTorch version for a CPU
tensor, so these tests hold the plain versions (the kernels' references),
forward and backward, against the JAX package's Pallas kernels run in
interpret mode, or against the JAX function they replace."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcct_tpu.models.layers import BatchNorm as JaxBatchNorm
from tcct_tpu.models.layers import leaky_relu as jax_leaky_relu
from tcct_tpu.ops.packed_conv import pack_nhwc, unpack_nhwc
from tcct_tpu.ops.pallas import metapool_tokens_pallas
from tcct_tpu.ops.pallas.bnstats import bn_act_train_packed_pallas
from tcct_tpu.ops.pallas.dwconv import dwconv3x3 as jax_dwconv3x3
from tcct_tpu.ops.pool import avg_pool_2d as jax_avg_pool_2d
from tcct_tpu.ops.pool import max_pool_2d as jax_max_pool_2d
from tcct_tpu_torch.models.layers import BatchNorm2d, Conv2d, DropPath, conv2d, gelu, train_pass
from tcct_tpu_torch.ops import (
    avg_pool_2d,
    max_pool_2d,
    metapool_tokens_backward_reference,
    metapool_tokens_reference,
    resize_bilinear,
)
from tcct_tpu_torch.ops.kernels import build
from tcct_tpu_torch.ops.kernels.bnstats import (
    bn_act_train,
    bn_normalize_reference,
    bn_stats_reference,
)
from tcct_tpu_torch.ops.kernels.dwconv import (
    dwconv3x3,
    dwconv3x3_backward,
    dwconv3x3_backward_reference,
    dwconv3x3_reference,
)
from tcct_tpu_torch.ops.kernels.metapool import metapool_tokens, metapool_tokens_backward


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.numpy(), 1, -1)


@pytest.mark.parametrize("shape", [(2, 50, 24), (1, 1024, 64), (3, 256, 96)])
def test_metapool_plain_matches_pallas(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(metapool_tokens_pallas(jnp.asarray(x), interpret=True))
    got = metapool_tokens_reference(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 50, 24), (1, 1, 5), (2, 7, 1)])
def test_metapool_plain_matches_torch_avgpool(shape):
    """Against torch's own AvgPool2d on the 3-D token tensor, the
    reference's call; also at one token or one channel, where the valid
    count is 1 along that axis."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=shape).astype(np.float32))
    want = torch.nn.AvgPool2d(3, 1, 1, count_include_pad=False)(x) - x
    np.testing.assert_allclose(metapool_tokens_reference(x).numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_metapool_plain_matches_golden(golden):
    g = golden("ops")
    got = metapool_tokens_reference(torch.from_numpy(g["tok"])).numpy()
    np.testing.assert_allclose(got, g["meta"], rtol=1e-5, atol=1e-5)


def test_metapool_wrapper_cpu_is_plain_and_uncounted():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 40, 32)).astype(np.float32))
    before = metapool_tokens.launches
    np.testing.assert_array_equal(metapool_tokens(x).numpy(), metapool_tokens_reference(x).numpy())
    assert metapool_tokens.launches == before


def test_metapool_plain_bf16_is_f32_inside():
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 30, 16)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    got = metapool_tokens_reference(xb)
    assert got.dtype == torch.bfloat16
    want = metapool_tokens_reference(xb.float()).to(torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())


@pytest.mark.parametrize(
    "shape,stride",
    [((2, 12, 24, 8), 1), ((1, 9, 130, 16), 1), ((2, 12, 24, 8), 2), ((1, 16, 40, 32), 2)],
)
def test_dwconv_plain_matches_pallas(shape, stride):
    rng = np.random.default_rng(3)
    x = rng.normal(size=shape).astype(np.float32)
    k = rng.normal(size=(3, 3, 1, shape[-1])).astype(np.float32)
    want = np.asarray(jax_dwconv3x3(jnp.asarray(x), jnp.asarray(k), interpret=True, stride=stride))
    got = dwconv3x3_reference(torch.from_numpy(x), torch.from_numpy(k[:, :, 0]), stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_conv_module_routes_to_dwconv(stride, monkeypatch):
    """Conv2d sends a depthwise 3x3 (stride 1/2, pad 1) to the depthwise
    wrapper and matches nn.Conv2d's own conv, bias included."""
    import tcct_tpu_torch.models.layers as layers

    seen = []
    real = layers.dwconv3x3
    monkeypatch.setattr(layers, "dwconv3x3",
                        lambda x, w, s, *rest: seen.append(s) or real(x, w, s, *rest))
    torch.manual_seed(0)
    m = conv2d(16, 16, 3, stride, 1, groups=16)
    x = torch.randn(2, 16, 10, 14).contiguous(memory_format=torch.channels_last)
    got = m(x)
    want = torch.nn.functional.conv2d(x, m.weight, m.bias, stride, 1, groups=16)
    assert seen == [stride]
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "args",
    [dict(cin=16, cout=16, k=3, s=1, p=1, g=1), dict(cin=16, cout=16, k=5, s=1, p=2, g=16),
     dict(cin=16, cout=16, k=3, s=1, p=0, g=16), dict(cin=8, cout=16, k=3, s=1, p=1, g=8)],
)
def test_other_convs_do_not_route(args):
    m = conv2d(args["cin"], args["cout"], args["k"], args["s"], args["p"], groups=args["g"])
    assert not m._depthwise3x3(torch.zeros(1, args["cin"], 8, 8))


def test_wrappers_raise_on_other_devices():
    """No silent fallback: only a CPU tensor takes the plain version."""
    with pytest.raises(ValueError):
        metapool_tokens(torch.empty(1, 4, 4, device="meta"))
    with pytest.raises(ValueError):
        dwconv3x3(torch.empty(1, 4, 4, 8, device="meta"), torch.empty(3, 3, 8, device="meta"))
    with pytest.raises(ValueError):
        dwconv3x3(torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 8), stride=3)


def test_kernel_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_stale", lambda name: True)
    with pytest.raises(build.KernelError):
        build.load("metapool")


def test_kernel_sources_present():
    assert build.sources() == ["bnstats", "crosscnn_fused", "dwconv3x3", "metapool"]


def test_launch_error_code_raises():
    with pytest.raises(build.KernelError):
        build.check(9, "probe")
    build.check(0, "probe")


def test_bilinear_align_corners_true(golden):
    g = golden("ops")
    out = resize_bilinear(_nchw(g["x"]), (14, 18), align_corners=True)
    np.testing.assert_allclose(_nhwc(out), g["up_t"], rtol=1e-5, atol=1e-5)


def test_bilinear_align_corners_false(golden):
    g = golden("ops")
    out = resize_bilinear(_nchw(g["x"]), (13, 20), align_corners=False)
    np.testing.assert_allclose(_nhwc(out), g["up_f"], rtol=1e-5, atol=1e-5)


def test_bilinear_downsample(golden):
    g = golden("ops")
    out = resize_bilinear(_nchw(g["x"]), (4, 5), align_corners=False)
    np.testing.assert_allclose(_nhwc(out), g["dn_f"], rtol=1e-5, atol=1e-5)


def test_pools_match_jax():
    x = np.random.default_rng(4).normal(size=(2, 9, 12, 5)).astype(np.float32)
    np.testing.assert_allclose(
        _nhwc(avg_pool_2d(_nchw(x))), np.asarray(jax_avg_pool_2d(jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        _nhwc(max_pool_2d(_nchw(x), 2)), np.asarray(jax_max_pool_2d(jnp.asarray(x), 2)))


def test_batchnorm_eval_expression_order():
    rng = np.random.default_rng(5)
    bn = BatchNorm2d(6).eval()
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.from_numpy(rng.normal(size=6).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, 6).astype(np.float32)))
    x = rng.normal(size=(2, 6, 4, 5)).astype(np.float32)
    inv = (1.0 / np.sqrt(bn.running_var.numpy() + 1e-5)) * bn.weight.detach().numpy()
    want = ((x - bn.running_mean.numpy()[:, None, None]) * inv[:, None, None]
            + bn.bias.detach().numpy()[:, None, None])
    np.testing.assert_allclose(bn(torch.from_numpy(x)).detach().numpy(), want, rtol=1e-6, atol=1e-6)
    # eval with leaky=True is LeakyReLU(0.01) then the same expression
    xl = np.where(x > 0, x, 0.01 * x)
    want_l = ((xl - bn.running_mean.numpy()[:, None, None]) * inv[:, None, None]
              + bn.bias.detach().numpy()[:, None, None])
    got_l = bn(torch.from_numpy(x), leaky=True).detach().numpy()
    np.testing.assert_allclose(got_l, want_l, rtol=1e-6, atol=1e-6)
    # train mode normalises with the batch statistics instead
    mean, var = bn_stats_reference(torch.from_numpy(x))
    want_t = bn_normalize_reference(torch.from_numpy(x), mean, var, bn.weight, bn.bias)
    np.testing.assert_array_equal(bn.train()(torch.from_numpy(x)).detach().numpy(),
                                  want_t.detach().numpy())


def test_gelu_is_exact_in_f32_and_tanh_in_bf16():
    x = torch.linspace(-4, 4, 101)
    np.testing.assert_allclose(
        gelu(x).numpy(), np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()), approximate=False)),
        rtol=1e-6, atol=1e-6)
    xb = x.to(torch.bfloat16)
    assert torch.equal(gelu(xb), torch.nn.functional.gelu(xb, approximate="tanh"))
    assert isinstance(conv2d(4, 4), Conv2d)


# ---------------------------------------------------------------------------
# backward kernels' plain versions (K1b, K2b) and the train BN (K3)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 50, 24), (1, 64, 2), (3, 2, 96)])
def test_metapool_backward_matches_pallas_vjp(shape):
    """K1b: autograd through metapool_tokens (CPU: the plain backward)
    against jax.vjp of the Pallas kernel (interpret mode), N and C >= 2;
    f32, atol/rtol 1e-5 (summation order)."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    _, vjp = jax.vjp(lambda t: metapool_tokens_pallas(t, interpret=True), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_()
    got = torch.autograd.grad(metapool_tokens(xt), xt, torch.from_numpy(g))[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    before = metapool_tokens_backward.launches
    direct = metapool_tokens_backward(torch.from_numpy(g))
    assert metapool_tokens_backward.launches == before
    np.testing.assert_array_equal(direct.numpy(), got.numpy())


def test_metapool_backward_is_adjoint_of_torch_avgpool():
    """The plain backward equals autograd of torch's own AvgPool2d on the
    3-D token tensor, also at one token or one channel."""
    for shape in [(2, 30, 16), (1, 1, 5), (2, 7, 1)]:
        x = torch.from_numpy(np.random.default_rng(11).normal(size=shape).astype(np.float32))
        g = torch.from_numpy(np.random.default_rng(12).normal(size=shape).astype(np.float32))
        x.requires_grad_()
        y = torch.nn.AvgPool2d(3, 1, 1, count_include_pad=False)(x) - x
        want = torch.autograd.grad(y, x, g)[0]
        got = metapool_tokens_backward_reference(g)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def _dw_case(shape, stride, seed):
    rng = np.random.default_rng(seed)
    B, H, W, C = shape
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = rng.normal(size=shape).astype(np.float32)
    k = rng.normal(size=(3, 3, 1, C)).astype(np.float32)
    g = rng.normal(size=(B, Ho, Wo, C)).astype(np.float32)
    return x, k, g


def _port_dw_grads(x, k, g, stride):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(k[:, :, 0])).requires_grad_()
    y = dwconv3x3(xt, wt, stride)
    return torch.autograd.grad(y, (xt, wt), torch.from_numpy(g))


def _assert_dw_close(got, want, x, g, stride):
    """dw is a sum over B*Ho*Wo products: hold it to 1e-5 of sum|x*g| per
    tap (summation order), not of |dw|."""
    mag = dwconv3x3_backward_reference(torch.from_numpy(np.abs(x)), torch.zeros(3, 3, x.shape[-1]),
                                       torch.from_numpy(np.abs(g)), stride)[1].numpy()
    err = np.abs(got - want)
    assert (err <= 1e-5 * mag + 1e-7).all(), (err.max(), mag.max())


@pytest.mark.parametrize(
    "shape,stride",
    [((2, 12, 24, 8), 1), ((1, 9, 13, 4), 1), ((2, 8, 10, 1), 1),
     ((2, 12, 24, 8), 2), ((1, 8, 12, 4), 2), ((2, 6, 8, 1), 2)],
)
def test_dwconv_backward_matches_pallas_vjp(shape, stride):
    """K2b: dx and dw of the port (CPU: the plain backward) against
    jax.vjp of the Pallas depthwise kernel in interpret mode, both strides,
    odd W at stride 1 and narrow C (4 and 1, the RegNet loss heads); dx
    f32 atol/rtol 1e-5."""
    x, k, g = _dw_case(shape, stride, 13)
    _, vjp = jax.vjp(lambda a, b: jax_dwconv3x3(a, b, interpret=True, stride=stride),
                     jnp.asarray(x), jnp.asarray(k))
    dx_w, dk_w = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    dx, dw = _port_dw_grads(x, k, g, stride)
    np.testing.assert_allclose(dx.numpy(), dx_w, rtol=1e-5, atol=1e-5)
    _assert_dw_close(dw.numpy(), dk_w[:, :, 0], x, g, stride)


@pytest.mark.parametrize("shape", [(1, 9, 7, 4), (2, 7, 10, 3), (1, 5, 5, 1), (1, 10, 9, 2)])
def test_dwconv_backward_stride2_odd_sizes_match_jax_conv(shape):
    """K2b at stride 2 with odd H or W (the Pallas kernel takes even sizes
    only): against jax.vjp of the grouped lax conv it replaces."""
    x, k, g = _dw_case(shape, 2, 14)
    C = shape[-1]

    def conv(a, b):
        return jax.lax.conv_general_dilated(a, b, (2, 2), ((1, 1), (1, 1)),
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                            feature_group_count=C,
                                            precision=jax.lax.Precision.HIGHEST)

    y, vjp = jax.vjp(conv, jnp.asarray(x), jnp.asarray(k))
    assert y.shape[1:3] == g.shape[1:3]
    dx_w, dk_w = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    dx, dw = _port_dw_grads(x, k, g, 2)
    np.testing.assert_allclose(dx.numpy(), dx_w, rtol=1e-5, atol=1e-5)
    _assert_dw_close(dw.numpy(), dk_w[:, :, 0], x, g, 2)


@pytest.mark.parametrize("stride", [1, 2])
def test_dwconv_backward_plain_is_autograd_of_plain_forward(stride):
    """The plain backward equals torch autograd of the plain forward
    (a grouped conv2d), bf16 included: f32 inside, cast once."""
    x, k, g = _dw_case((2, 11, 9, 6), stride, 15)
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
        xt = torch.from_numpy(x).to(dt).requires_grad_()
        wt = torch.from_numpy(np.ascontiguousarray(k[:, :, 0])).to(dt).requires_grad_()
        gt = torch.from_numpy(g).to(dt)
        xf, wf = xt.detach().float().requires_grad_(), wt.detach().float().requires_grad_()
        want = torch.autograd.grad(dwconv3x3_reference(xf, wf, stride), (xf, wf), gt.float())
        dx, dw, db = dwconv3x3_backward(xt.detach(), wt.detach(), gt, stride)
        assert dx.dtype == dw.dtype == dt and db is None
        for a, b in zip((dx, dw), want):
            torch.testing.assert_close(a.float(), b.to(dt).float(), rtol=tol, atol=tol * 10)


def _jax_bn_train(x, scale, bias, mean0, var0, leaky, g):
    """The JAX package's train BatchNorm (after LeakyReLU when leaky) on
    NHWC x: y, the new running stats and the vjp of the cotangent g."""
    bn = JaxBatchNorm()

    def f(x, scale, bias):
        t = jax_leaky_relu(x) if leaky else x
        y, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                           "batch_stats": {"mean": mean0, "var": var0}},
                          t, use_running_average=False, mutable=["batch_stats"])
        return y, upd["batch_stats"]

    y, vjp, stats = jax.vjp(f, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), has_aux=True)
    return y, stats, vjp(jnp.asarray(g))


def _bn_case(shape, seed):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = (rng.normal(size=C) * 0.1).astype(np.float32)
    mean0 = rng.normal(size=C).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, C).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return x, scale, bias, mean0, var0, g


def _port_bn(x, scale, bias, mean0, var0, g, leaky):
    bn = BatchNorm2d(x.shape[-1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(np.moveaxis(x, -1, 1)).contiguous(memory_format=torch.channels_last)
    xt.requires_grad_()
    y = bn(xt, leaky=leaky)
    gx, gw, gb = torch.autograd.grad(y, (xt, bn.weight, bn.bias), torch.from_numpy(np.moveaxis(g, -1, 1)))
    return (np.moveaxis(y.detach().numpy(), 1, -1), bn, np.moveaxis(gx.numpy(), 1, -1),
            gw.numpy(), gb.numpy())


def _close_scaled(a, b, atol=2e-5):
    s = float(np.abs(b).max()) + 1e-9
    np.testing.assert_allclose(np.asarray(a) / s, np.asarray(b) / s, atol=atol)


@pytest.mark.parametrize("leaky", [False, True])
@pytest.mark.parametrize("shape", [(2, 6, 10, 8), (3, 5, 7, 1)])
def test_bn_train_matches_jax_batchnorm(shape, leaky):
    """K3 (CPU: the plain stats/normalize and analytic backward) against
    the JAX package's train BatchNorm after leaky_relu: y (f32 atol/rtol
    1e-5), the EMA running statistics (biased var; atol 1e-6), and the
    gradients in x, weight and bias (2e-5 of each one's max)."""
    x, scale, bias, mean0, var0, g = _bn_case(shape, 16)
    yj, stats, (gxj, gsj, gbj) = _jax_bn_train(x, scale, bias, mean0, var0, leaky, g)
    y, bn, gx, gw, gb = _port_bn(x, scale, bias, mean0, var0, g, leaky)
    np.testing.assert_allclose(y, np.asarray(yj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), atol=1e-6)
    _close_scaled(gx, gxj)
    _close_scaled(gw, gsj)
    _close_scaled(gb, gbj)


@pytest.mark.parametrize("leaky", [False, True])
def test_bn_train_matches_pallas_bnstats(leaky):
    """K3 against the TPU kernel it replaces, bn_act_train_packed_pallas on
    pack_nhwc(x) (align (0,0), interpret mode; C a multiple of 32): y after
    unpacking, batch mean and biased var, and the gradients."""
    x, scale, bias, _, _, g = _bn_case((2, 8, 10, 32), 17)

    def f(x, s, b):
        y, m, v = bn_act_train_packed_pallas(pack_nhwc(jnp.asarray(x)), s, b, align=(0, 0),
                                             leaky=leaky, interpret=True)
        return unpack_nhwc(y), (m, v)

    yj, vjp, (mj, vj) = jax.vjp(f, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                has_aux=True)
    gxj, gsj, gbj = vjp(jnp.asarray(g))
    xt = torch.from_numpy(np.moveaxis(x, -1, 1)).requires_grad_()
    w, b = torch.from_numpy(scale).requires_grad_(), torch.from_numpy(bias).requires_grad_()
    y, mean, var = bn_act_train(xt, w, b, 1e-5, leaky)
    np.testing.assert_allclose(np.moveaxis(y.detach().numpy(), 1, -1), np.asarray(yj),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(vj), rtol=1e-5, atol=1e-6)
    gx, gw, gb = torch.autograd.grad(y, (xt, w, b), torch.from_numpy(np.moveaxis(g, -1, 1)))
    _close_scaled(np.moveaxis(gx.numpy(), 1, -1), gxj)
    _close_scaled(gw.numpy(), gsj)
    _close_scaled(gb.numpy(), gbj)


def test_bn_train_bf16_stats_are_f32_of_the_input_values():
    """In bf16 the statistics are f32 reductions of the bf16 values of
    act(x) and y is the normalize in bf16; the CPU wrapper counts no
    launch."""
    x, scale, bias, _, _, _ = _bn_case((2, 4, 6, 8), 18)
    xb = torch.from_numpy(np.moveaxis(x, -1, 1)).to(torch.bfloat16)
    w, b = torch.from_numpy(scale).to(torch.bfloat16), torch.from_numpy(bias).to(torch.bfloat16)
    before = bn_act_train.launches
    y, mean, var = bn_act_train(xb, w, b, 1e-5, True)
    assert bn_act_train.launches == before
    assert y.dtype == torch.bfloat16 and mean.dtype == var.dtype == torch.float32
    t = torch.nn.functional.leaky_relu(xb, 0.01).double()
    np.testing.assert_allclose(mean.numpy(), t.mean((0, 2, 3)).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), t.var((0, 2, 3), unbiased=False).numpy(),
                               rtol=1e-4, atol=1e-5)
    want = bn_normalize_reference(xb, mean, var, w, b, 1e-5, True)
    assert torch.equal(y, want)


def test_batchnorm_train_ema_and_train_pass():
    """Train-mode BN moves its buffers by 0.9 * running + 0.1 * batch
    (biased var) outside a train pass; inside one the buffers stay and the
    collector holds the new statistics, chained when the BN runs twice."""
    torch.manual_seed(0)
    bn = BatchNorm2d(3).train()
    x1, x2 = torch.randn(2, 3, 4, 5), torch.randn(2, 3, 4, 5)
    m1, v1 = bn_stats_reference(x1)
    m2, v2 = bn_stats_reference(x2)
    with train_pass(bn) as stats:
        bn(x1)
        bn(x2)
    assert torch.equal(bn.running_mean, torch.zeros(3)) and torch.equal(bn.running_var, torch.ones(3))
    mean, var = stats[bn]
    torch.testing.assert_close(mean, 0.9 * (0.9 * 0.0 + 0.1 * m1) + 0.1 * m2)
    torch.testing.assert_close(var, 0.9 * (0.9 * 1.0 + 0.1 * v1) + 0.1 * v2)
    bn(x1)
    torch.testing.assert_close(bn.running_mean, 0.1 * m1)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * v1)


def test_droppath_train_mode():
    """Per-sample Bernoulli(keep) masks from the train pass's generator,
    kept samples scaled by 1/keep; identity in eval mode; no generator in
    train mode raises."""
    dp = DropPath(0.5)
    x = torch.ones(64, 3, 4)
    assert dp.eval()(x) is x
    dp.train()
    with pytest.raises(ValueError):
        dp(x)
    with train_pass(dp, torch.Generator().manual_seed(0)):
        a = dp(x)
    with train_pass(dp, torch.Generator().manual_seed(0)):
        b = dp(x)
    assert torch.equal(a, b)
    per_sample = a.reshape(64, -1)
    assert set(per_sample.unique().tolist()) <= {0.0, 2.0}
    assert (per_sample == per_sample[:, :1]).all()
    assert 10 < int((per_sample[:, 0] == 2.0).sum()) < 54
    assert DropPath(0.0).train()(x) is x
