"""The fused CrossCNNBlock of the PyTorch port on the CPU (f32): its plain
version against the TPU kernel it replaces (``attic/crosscnn_fused.py``,
Pallas in interpret mode), against the JAX module and against the port's
own module path; the fused pyramid; sizes the Pallas kernel refuses; what
the wrapper refuses.  The CUDA kernel itself is held against the plain
version on the card (``tests/test_torch_kernels.py``, ``chip_smoke.py``)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcct_tpu.models.crosscnn import CrossCNNBlock as JaxCrossCNNBlock
from tcct_tpu.models.crosscnn import CrossResNet as JaxCrossResNet
from tcct_tpu_torch.infer.importer import flatten_variables, from_jax_variables
from tcct_tpu_torch.models.crosscnn import (
    CrossCNNBlock,
    CrossResNet,
    cross_resnet_fused,
    seeded_cross_block,
)
from tcct_tpu_torch.ops.kernels.crosscnn_fused import (
    fused_cross_block,
    fused_cross_block_reference,
    pack_cross_block,
)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "attic"))
import crosscnn_fused as attic  # noqa: E402  (the retired TPU kernel)


def _randomized(variables, rng):
    """Random positive BN statistics (as attic/test_fused_crosscnn.py), and
    the conv biases and BN affines moved off their init (0 and 1), so that
    every operand of the kernel matters."""
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(rng.normal(size=a.shape).astype(np.float32)) ** 2 + 0.5,
        variables["batch_stats"])

    def move(path, a):
        if path[-1].key == "kernel":
            return np.asarray(a)
        return np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(move, variables["params"])
    return {"params": params, "batch_stats": stats}


def _load(module, variables):
    state = from_jax_variables(flatten_variables(variables))
    res = module.load_state_dict(state, strict=False)
    assert res.unexpected_keys == []
    assert all("num_batches_tracked" in k for k in res.missing_keys)
    return module.eval()


def _nhwc(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("shape,cout,ksize,tile", [
    ((2, 64, 64, 32), 32, 13, 32), ((2, 64, 64, 32), 32, 9, 32), ((2, 64, 64, 32), 32, 5, 16),
    ((1, 32, 32, 32), 64, 11, 32)])
def test_plain_version_matches_pallas_kernel_and_modules(shape, cout, ksize, tile):
    """fused_cross_block_reference == the Pallas kernel (interpret mode) ==
    the JAX module == the port's module, rtol = atol = 1e-4, on the same
    weights and statistics."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    blk = JaxCrossCNNBlock(cout, ksize=ksize)
    v = _randomized(blk.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False), rng)
    pallas = np.asarray(attic.fused_cross_block(jnp.asarray(x), v["params"], v["batch_stats"],
                                                tile=tile, interpret=True))
    module = np.asarray(blk.apply(v, jnp.asarray(x), train=False))
    port = _load(CrossCNNBlock(shape[-1], cout, ksize), v)
    with torch.inference_mode():
        got = fused_cross_block_reference(_nhwc(x), port).numpy()
        via_wrapper = fused_cross_block(_nhwc(x), port).numpy()  # a CPU tensor: the plain version
        port_module = port(_nhwc(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == shape[:3] + (cout,)
    assert np.abs(pallas).max() > 1.0
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, module, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, port_module, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(via_wrapper, got)
    assert fused_cross_block.launches == 0


def test_fused_pyramid_matches_attic():
    """cross_resnet_fused against the attic's (Pallas, interpret) and the
    JAX module on [1,64,128,3]: 2e-3, the attic test's bound (summation
    order compounds through the five blocks)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 64, 128, 3)).astype(np.float32)
    net = JaxCrossResNet(tiny=True)
    v = _randomized(net.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False), rng)
    want = attic.cross_resnet_fused(jnp.asarray(x), v["params"], v["batch_stats"], interpret=True)
    refs = net.apply(v, jnp.asarray(x), train=False)
    port = _load(CrossResNet(tiny=True), v)
    with torch.inference_mode():
        gots = cross_resnet_fused(_nhwc(x), port)
    assert len(gots) == 5
    for i, (g, w, r) in enumerate(zip(gots, want, refs)):
        assert tuple(g.shape) == w.shape == (1, 64 >> i, 128 >> i, 32)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("shape,cout,k,plain", [
    ((8, 16, 36, 32), 32, 5, False),    # duke's last level: no multiple of a Pallas tile
    ((8, 4, 8, 32), 32, 5, False),      # the bottom of a 64x128 input: smaller than a tile
    ((2, 19, 32, 128), 256, 5, False),  # goals' last level, the widest channel change
    ((2, 7, 9, 32), 64, 13, False),     # an image inside the halo
    ((2, 16, 36, 32), 32, 9, True),     # a plain block: k = 3 whatever ksize says
])
def test_plain_version_at_sizes_pallas_refuses(shape, cout, k, plain):
    """Sizes the Pallas kernel cannot take (it wants H and W multiples of
    its tile): the plain version against the port's module path, f32, within
    1e-4 of the output's scale."""
    blk = seeded_cross_block(shape[-1], cout, k, 3, plain)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=shape).astype(np.float32))
    with torch.inference_mode():
        got = fused_cross_block(x, blk)
        want = blk(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == shape[:3] + (cout,) and got.is_contiguous()
    assert pack_cross_block(blk, torch.float32).k == (3 if plain else k)
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4 * max(1.0, scale))


def test_bf16_rounds_where_the_tpu_kernel_does():
    """In bf16 the plain version rounds only before each following conv and
    at the output: it equals the same chain written out here, and stays
    within bf16 distance of the f32 result."""
    import torch.nn.functional as F

    blk = seeded_cross_block(32, 64, 7, 4)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 12, 20, 32)).astype(np.float32))
    with torch.inference_mode():
        f32 = fused_cross_block(x, blk)
        b16 = blk.to(torch.bfloat16)
        got = fused_cross_block(x.bfloat16(), b16)
        r = lambda t: t.bfloat16().float()  # noqa: E731
        conv = lambda c, t, pad: F.conv2d(r(t), c.weight.float(), c.bias.float(), padding=pad)  # noqa: E731

        def affine(t, bn):
            s = bn.weight.float() / torch.sqrt(bn.running_var.float() + 1e-5)
            sh = bn.bias.float() - bn.running_mean.float() * s
            return F.leaky_relu(t, 0.01) * s[None, :, None, None] + sh[None, :, None, None]

        xc = x.bfloat16().permute(0, 3, 1, 2)
        a = affine(conv(b16.block12[1], conv(b16.block12[0], xc, 1), 1), b16.block12[3])
        b = conv(b16.block34[1], conv(b16.block34[0], xc, (0, 3)), (3, 0))
        b = affine(conv(b16.block34[2], b, 1), b16.block34[4])
        y = affine(conv(b16.block5[0], F.gelu(a + b), 1), b16.block5[2])
        want = y.bfloat16().permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    rel = (got.float() - f32).abs() / (f32.abs() + float(f32.abs().mean()))
    assert float(rel.max()) < 0.1


def test_pack_is_cached_on_the_module_and_follows_its_weights():
    blk = seeded_cross_block(32, 32, 5, 5)
    p1 = pack_cross_block(blk, torch.float32)
    assert pack_cross_block(blk, torch.float32) is p1
    assert p1.w.numel() == (9 + 9 + 5 + 5 + 9 + 9) * 32 * 32 and tuple(p1.vec.shape) == (12, 32)
    w, b = p1.conv(2)  # block34.0, back in the module's layout
    assert torch.equal(w, blk.block34[0].weight) and torch.equal(b, blk.block34[0].bias)
    assert pack_cross_block(blk, torch.bfloat16) is not p1  # another dtype: another pack
    with torch.no_grad():
        blk.block5[2].running_var.mul_(2.0)  # written in place: repacked
    p2 = pack_cross_block(blk, torch.float32)
    assert p2 is not p1 and not torch.equal(p2.vec[10], p1.vec[10])
    blk.load_state_dict(seeded_cross_block(32, 32, 5, 6).state_dict())
    assert not torch.equal(pack_cross_block(blk, torch.float32).w, p2.w)


def test_fused_block_refuses():
    blk = seeded_cross_block(32, 32, 5, 7)
    x = torch.zeros(1, 8, 8, 32)
    with pytest.raises(ValueError, match="no backward"):  # grad mode, parameters need gradients
        fused_cross_block(x, blk)
    with torch.no_grad():
        with pytest.raises(ValueError, match="train mode"):
            fused_cross_block(x, blk.train())
        net = CrossResNet(tiny=True).train()
        with pytest.raises(ValueError, match="train mode"):
            cross_resnet_fused(torch.zeros(1, 16, 16, 3), net)
        net.eval().msca = True
        with pytest.raises(ValueError, match="MSCA"):
            cross_resnet_fused(torch.zeros(1, 16, 16, 3), net)
    with pytest.raises(ValueError, match="no backward"):
        with torch.enable_grad():
            for p in blk.parameters():
                p.requires_grad_(False)
            fused_cross_block(x.requires_grad_(), blk.eval())
