"""The eval MHCA block's MetaPool site (``norm1``, the MetaPool mixer, the
residual add, ``norm2``) as the port runs it when serving,
``ops/kernels/metapool.py::metapool_block``, against the JAX package on
the CPU (f32, numpy-seeded inputs; the Pallas mixer in interpret mode),
and the block's dispatch between the site and the four separate ops."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcct_tpu.models.mpvit import MHCAEncoder as JaxMHCAEncoder
from tcct_tpu.ops.pallas import metapool_tokens_pallas
from tcct_tpu_torch.infer.importer import flatten_variables, from_jax_variables
from tcct_tpu_torch.models import mpvit
from tcct_tpu_torch.models.mpvit import MHCAEncoder
from tcct_tpu_torch.ops.kernels.metapool import (
    metapool_block,
    metapool_block_reference,
    metapool_tokens,
)
from tcct_tpu_torch.ops.pool import metapool_tokens_reference

EPS = 1e-6


def _site_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    w1, w2 = (rng.uniform(0.5, 1.5, C).astype(np.float32) for _ in range(2))
    b1, b2 = (rng.normal(size=C).astype(np.float32) * 0.1 for _ in range(2))
    return x, w1, b1, w2, b2


def _jax_site(x, w1, b1, w2, b2):
    ln = fnn.LayerNorm(epsilon=EPS)
    n = ln.apply({"params": {"scale": w1, "bias": b1}}, x)
    y = x + metapool_tokens_pallas(n, interpret=True)
    return y, ln.apply({"params": {"scale": w2, "bias": b2}}, y)


# N, C >= 2: the Pallas count map's own limit
@pytest.mark.parametrize("shape", [(2, 2, 5), (2, 50, 5), (1, 3, 24), (2, 33, 24), (2, 2, 160),
                                   (1, 41, 160), (2, 3, 216), (1, 17, 216), (2, 9, 2)])
def test_site_plain_matches_jax(shape):
    """The plain site (CPU) against flax LayerNorm(1e-6) -> the Pallas
    MetaPool kernel -> add -> LayerNorm, f32: y within 1e-5 + 1e-5 |y|;
    n2 within 1e-5 plus that bound carried through LayerNorm2, |w2| rstd
    (1e-5 + 1e-5 max|y|) per token (a near-constant token, as C = 2 gives,
    magnifies y's last bits by its rstd)."""
    args = _site_inputs(shape, sum(shape))
    want_y, want_n2 = _jax_site(*(jnp.asarray(a) for a in args))
    before = metapool_block.launches
    y, n2 = metapool_block(*(torch.from_numpy(a) for a in args), eps=EPS)
    assert metapool_block.launches == before  # the CPU takes the plain version: no launch
    want_y = np.asarray(want_y, np.float64)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-5, atol=1e-5)
    rstd = 1.0 / np.sqrt(want_y.var(-1, keepdims=True) + EPS)
    carried = np.abs(args[3]) * rstd * (1e-5 + 1e-5 * np.abs(want_y).max(-1, keepdims=True))
    err = np.abs(n2.numpy() - np.asarray(want_n2, np.float64))
    assert (err <= 1e-5 + carried).all(), float((err - carried).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_site_flags_on_the_cpu(dtype):
    """No LayerNorm and no residual is the bare mixer; the residual alone is
    ``metapool_tokens(x) + x``; both bit for bit, n2 None without LN2."""
    x = torch.from_numpy(_site_inputs((2, 30, 24), 3)[0]).to(dtype)
    a, n2 = metapool_block(x, residual=False)
    assert n2 is None
    assert torch.equal(a, metapool_tokens(x))
    y, _ = metapool_block(x)
    assert torch.equal(y, metapool_tokens(x) + x)
    with pytest.raises(ValueError, match="w1, b1, w2 and b2 together"):
        metapool_block(x, torch.ones(24, dtype=dtype), torch.zeros(24, dtype=dtype))


def _encoder_pair(dim, num_layers, seed):
    """A JAX MHCAEncoder (mixer 'metapool_pallas') with seeded LayerNorm
    affines, and the port's encoder loaded from the same variables."""
    heads, mlp_ratio, window = 4, 2, ((3, 2), (5, 3), (7, 3))
    jenc = JaxMHCAEncoder(dim, num_layers, heads, mlp_ratio, (0.0,) * num_layers,
                          "metapool_pallas", window)
    x0 = jnp.zeros((1, 6, dim), jnp.float32)
    variables = jenc.init({"params": jax.random.PRNGKey(seed)}, x0, (2, 3))
    flat = flatten_variables(variables)
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if "/norm" in k:
            flat[k] = (rng.uniform(0.5, 1.5, v.shape) if k.endswith("scale")
                       else rng.normal(size=v.shape) * 0.1).astype(np.float32)
        elif k.endswith("bias"):
            flat[k] = (rng.normal(size=v.shape) * 0.1).astype(np.float32)
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    enc = MHCAEncoder(dim, num_layers, heads, mlp_ratio, window, [0.0] * num_layers)
    missing, unexpected = enc.load_state_dict(from_jax_variables(flat), strict=False)
    # left unset: the CRPE convs the mixer never runs, and the blocks' own
    # names of the shared CPE (one module with the encoder's, which is set)
    assert not unexpected
    assert all("crpe." in k or k.startswith("MHCA_layers.") and ".cpe." in k for k in missing)
    return jenc, tree, enc.eval()


@pytest.mark.parametrize("dim,num_layers,hw", [(24, 1, (5, 7)), (64, 2, (6, 9)),
                                               (160, 1, (3, 4))])
def test_eval_block_matches_jax(dim, num_layers, hw):
    """The port's eval MHCA blocks under torch.inference_mode() (the site)
    against the JAX blocks with the same weights, f32 within 1e-5."""
    jenc, tree, enc = _encoder_pair(dim, num_layers, dim + num_layers)
    rng = np.random.default_rng(dim)
    x = (rng.normal(size=(2, hw[0] * hw[1], dim)) * 2.0 + 0.5).astype(np.float32)
    want = np.asarray(jenc.apply(tree, jnp.asarray(x), hw))  # [B, H, W, C]
    with torch.inference_mode():
        got = enc(torch.from_numpy(x), hw)  # NCHW view
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_block_on_the_cpu_is_the_four_ops_bitwise(dtype):
    """On the CPU the site's plain version is the four ops: the eval block
    gives the same bits with and without a gradient wanted."""
    _, _, enc = _encoder_pair(24, 2, 7)
    enc = enc.to(dtype)
    x = torch.from_numpy(_site_inputs((2, 20, 24), 8)[0]).to(dtype)
    with torch.inference_mode():
        site = enc(x, (4, 5))
    with torch.enable_grad():
        four = enc(x, (4, 5))
    assert torch.equal(site, four.detach())


@pytest.fixture
def spies(monkeypatch):
    calls = {"block": 0, "tokens": 0}

    def block(*a, **k):
        calls["block"] += 1
        return metapool_block(*a, **k)

    def tokens(*a, **k):
        calls["tokens"] += 1
        return metapool_tokens(*a, **k)

    monkeypatch.setattr(mpvit, "metapool_block", block)
    monkeypatch.setattr(mpvit, "metapool_tokens", tokens)
    return calls


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad"])
def test_eval_without_grad_takes_the_site(spies, mode):
    _, _, enc = _encoder_pair(24, 2, 9)
    x = torch.from_numpy(_site_inputs((2, 12, 24), 10)[0])
    with getattr(torch, mode)():
        enc(x, (3, 4))
    assert spies == {"block": 2, "tokens": 0}


@pytest.mark.parametrize("train", [True, False])
def test_train_or_grad_takes_the_four_ops(spies, train):
    """Train mode, or eval with a gradient wanted: norm1, the mixer (with
    its backward), the add and norm2 as separate ops, and gradients reach
    the input and both LayerNorms; the result equals the site's."""
    _, _, enc = _encoder_pair(24, 1, 11)
    enc.train(train)
    x = torch.from_numpy(_site_inputs((2, 12, 24), 12)[0]).requires_grad_()
    out = enc(x, (3, 4))
    assert spies == {"block": 0, "tokens": 1}
    out.square().sum().backward()
    blk = enc.MHCA_layers[0]
    for t in (x.grad, blk.norm1.weight.grad, blk.norm1.bias.grad, blk.norm2.weight.grad):
        assert t is not None and bool(torch.isfinite(t).all()) and float(t.abs().sum()) > 0
    with torch.no_grad():
        site = enc.eval()(x, (3, 4))
    assert spies["block"] == 1
    assert torch.equal(site, out.detach())  # drop_path 0: train and eval agree


def test_train_mode_without_grad_keeps_the_four_ops(spies):
    _, _, enc = _encoder_pair(24, 1, 13)
    with torch.no_grad():
        enc.train()(torch.from_numpy(_site_inputs((1, 12, 24), 14)[0]), (3, 4))
    assert spies == {"block": 0, "tokens": 1}


def test_site_reference_is_the_separate_passes():
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _site_inputs((2, 16, 24), 15))
    y, n2 = metapool_block_reference(x, w1, b1, w2, b2, EPS)
    n = torch.nn.functional.layer_norm(x, (24,), w1, b1, EPS)
    want = x + metapool_tokens_reference(n)
    assert torch.equal(y, want)
    assert torch.equal(n2, torch.nn.functional.layer_norm(want, (24,), w2, b2, EPS))
