"""The port's depthwise 3x3 forward at the edges of its kernels' tiling, its
bias-and-residual epilogue, and ConvPosEnc, against the JAX package (CPU).

On the CPU the wrapper takes its plain versions, so these tests hold what
the kernels are held against on the card (``tests/test_torch_kernels.py``):
the plain forward against the Pallas kernel in interpret mode (or, where
that kernel does not take the shape, against the grouped convolution it
replaces), and ``dwconv3x3(x, w, 1, bias, residual=True)`` against the three
steps it stands for."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcct_tpu.infer.importer import export_torch_state
from tcct_tpu.models.mpvit import ConvPosEnc as JaxConvPosEnc
from tcct_tpu.ops.pallas.dwconv import dwconv3x3 as jax_dwconv3x3
from tcct_tpu.ops.pallas.dwconv import dwconv3x3_eligible
from tcct_tpu_torch.infer.importer import flatten_variables, from_jax_variables
from tcct_tpu_torch.models.mpvit import ConvPosEnc
from tcct_tpu_torch.ops.kernels.dwconv import (
    dwconv3x3,
    dwconv3x3_forward,
    dwconv3x3_reference,
)


def _jax_dwconv(x, k, stride):
    """The JAX package's depthwise 3x3: its Pallas kernel in interpret mode
    where it takes the shape (stride 2 needs even H and W), else the grouped
    convolution that the kernel replaces."""
    if dwconv3x3_eligible(x.shape, jnp.float32, stride):
        return np.asarray(jax_dwconv3x3(jnp.asarray(x), jnp.asarray(k), interpret=True,
                                        stride=stride))
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (stride, stride), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=x.shape[-1],
        precision=jax.lax.Precision.HIGHEST))


# H = 1, W = 1, odd sizes at stride 2, widths around a block's columns, the
# channel counts of the 16-byte, 8-byte and one-element words
@pytest.mark.parametrize(
    "shape,stride",
    [((2, 1, 9, 40), 1), ((2, 9, 1, 40), 1), ((1, 1, 1, 4), 1), ((2, 33, 17, 1), 1),
     ((2, 13, 21, 4), 1), ((1, 9, 31, 40), 1), ((1, 10, 33, 216), 1), ((1, 4, 6, 216), 1),
     ((2, 1, 9, 40), 2), ((2, 9, 1, 40), 2), ((2, 7, 5, 4), 2), ((1, 33, 17, 1), 2),
     ((1, 9, 31, 40), 2), ((1, 11, 13, 216), 2), ((2, 8, 12, 40), 2), ((1, 6, 4, 216), 2)],
)
def test_dwconv_plain_matches_jax_at_the_edges(shape, stride):
    rng = np.random.default_rng(30)
    x = rng.normal(size=shape).astype(np.float32)
    k = rng.normal(size=(3, 3, 1, shape[-1])).astype(np.float32)
    want = _jax_dwconv(x, k, stride)
    got = dwconv3x3_reference(torch.from_numpy(x), torch.from_numpy(k[:, :, 0]), stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.normal(size=(3, 3, shape[-1])) / 3).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.normal(size=(shape[-1],)).astype(np.float32)).to(dtype)
    return x, w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 9, 13, 40), (1, 1, 7, 4), (2, 5, 1, 216), (3, 6, 6, 1)])
def test_dwconv_epilogue_is_the_three_steps(shape, dtype):
    """conv + bias + x through one call equals the plain conv followed by the
    two adds, bit for bit; each part alone too."""
    x, w, b = _inputs(shape, dtype, 31)
    base = dwconv3x3_reference(x, w, 1)
    assert torch.equal(dwconv3x3(x, w, 1, b, residual=True), base + b + x)
    assert torch.equal(dwconv3x3(x, w, 1, b), base + b)
    assert torch.equal(dwconv3x3(x, w, 1, None, residual=True), base + x)
    assert torch.equal(dwconv3x3(x, w, 2, b), dwconv3x3_reference(x, w, 2) + b)
    assert torch.equal(dwconv3x3_forward(x, w, 1, b, True), base + b + x)
    assert dwconv3x3(x, w, 1, b, residual=True).dtype == dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride,residual", [(1, True), (1, False), (2, False)])
def test_dwconv_epilogue_gradients_are_autograd_s(stride, residual, dtype):
    """Gradients in x, w and bias of the one call equal autograd's through
    the three steps (same plain backward, then the adds' own gradients)."""
    x, w, b = _inputs((2, 7, 10, 12), dtype, 32)
    g = _inputs((2, (7 - 1) // stride + 1, (10 - 1) // stride + 1, 12), dtype, 33)[0]

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        return torch.autograd.grad(fn(*leaves), leaves, g)

    def three(xx, ww, bb):
        y = dwconv3x3(xx, ww, stride) + bb
        return y + xx if residual else y

    got = grads(lambda xx, ww, bb: dwconv3x3(xx, ww, stride, bb, residual))
    want = grads(three)
    for a, c, name in zip(got, want, "xwb"):
        assert a.dtype == dtype and a.shape == c.shape
        assert torch.equal(a, c), name


def test_dwconv_epilogue_refuses():
    x, w, b = _inputs((1, 4, 6, 8), torch.float32, 34)
    with pytest.raises(ValueError, match="stride 1"):
        dwconv3x3(x, w, 2, b, residual=True)
    with pytest.raises(ValueError, match="stride 1"):
        dwconv3x3_forward(x, w, 2, rows=4)
    with pytest.raises(ValueError, match="bias"):
        dwconv3x3(x, w, 1, b[:4])
    with pytest.raises(ValueError, match="bias"):
        dwconv3x3(x, w, 1, b.to(torch.bfloat16))
    with pytest.raises(ValueError, match="stride must be"):
        dwconv3x3(x, w, 3)


@pytest.mark.parametrize("dim,size", [(16, (6, 10)), (40, (5, 7)), (8, (1, 9))])
def test_conv_pos_enc_matches_jax(dim, size):
    """The port's ConvPosEnc (one call: conv + bias + tokens) against the
    JAX module, weights carried over by from_jax_variables (the same as
    export_torch_state into the port's skeleton), f32, 1e-5."""
    rng = np.random.default_rng(35)
    H, W = size
    x = rng.normal(size=(2, H * W, dim)).astype(np.float32)
    jm = JaxConvPosEnc(dim=dim)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), size)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)), variables["params"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), size))
    tm = ConvPosEnc(dim)
    state = from_jax_variables(flatten_variables({"params": params}))
    skeleton = {k: v.numpy() for k, v in tm.state_dict().items()}
    exported, _ = export_torch_state({"params": params}, skeleton)
    assert sorted(state) == sorted(exported)
    for k, v in exported.items():
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(v))
    tm.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), size).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
