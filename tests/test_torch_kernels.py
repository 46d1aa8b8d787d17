"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA card and the CUDA toolkit: without
them each one skips (``chip_smoke.py`` repeats these checks on the card
at the serving and train shapes).  Run on a GPU machine with
``python -m pytest --noconftest tests/test_torch_kernels.py -q``."""

import os

import pytest
import torch
import torch.nn.functional as F

from tcct_tpu_torch.models.crosscnn import seeded_cross_block
from tcct_tpu_torch.ops.kernels import build
from tcct_tpu_torch.ops.kernels.bnstats import (
    bn_act_backward_dx,
    bn_act_backward_sums,
    bn_act_normalize,
    bn_act_sums,
    bn_act_train,
    bn_act_train_backward,
    bn_act_train_backward_reference,
    bn_act_train_backward_tolerance,
    bn_act_train_split,
    bn_backward_sums_reference,
    bn_normalize_reference,
    bn_stats_reference,
    bn_sums_reference,
    bn_weight_grads,
    stats_from_sums,
)
from tcct_tpu_torch.ops.kernels.crosscnn_fused import (
    _fn,
    fused_cross_block,
    fused_cross_block_reference,
    fused_plan,
    pack_cross_block,
)
from tcct_tpu_torch.ops.kernels.dwconv import (
    dwconv3x3,
    dwconv3x3_backward,
    dwconv3x3_backward_reference,
    dwconv3x3_forward,
    dwconv3x3_reference,
)
from tcct_tpu_torch.ops.kernels.metapool import (
    metapool_block,
    metapool_block_reference,
    metapool_tokens,
    metapool_tokens_backward,
)
from tcct_tpu_torch.ops.pool import metapool_tokens_backward_reference, metapool_tokens_reference

pytestmark = pytest.mark.gpu

# |kernel - plain| <= atol + rtol * |plain|: f32 differs by summation
# order only; bf16 by at most a couple of output roundings
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 2.0 ** -7)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 50, 24), (1, 1, 5), (3, 1000, 160), (2, 36864, 64)])
def test_metapool_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    n = metapool_tokens.launches
    got = metapool_tokens(x)
    torch.cuda.synchronize()
    assert metapool_tokens.launches == n + 1
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, metapool_tokens_reference(x), dtype)


# The forward's edges.  Stride 2 and small stride-1 inputs take the direct
# kernel; a stride-1 call that names `rows` takes the ring kernel, whose
# block covers 128 or 256 threads' worth of columns (at C = 64: 16 or 32 in
# bf16, 8 or 16 in f32) and walks a strip of `rows` output rows.  Widths one
# less and one more than a block's columns, heights one more than a strip,
# H = 1, W = 1, C that takes the 16-byte, the 8-byte and the one-element
# word, C above one block's channel words (2056 in bf16).
DW_SHAPES = [(2, 12, 24, 8), (1, 9, 130, 40), (2, 33, 17, 160), (8, 64, 144, 96),
             (1, 9, 15, 64), (1, 9, 17, 64), (2, 4, 31, 64), (2, 4, 33, 64), (1, 1, 1, 8),
             (2, 1, 7, 16), (2, 7, 1, 16), (2, 13, 21, 4), (2, 13, 21, 12), (3, 20, 19, 1),
             (1, 35, 33, 216), (1, 34, 31, 264), (1, 3, 2, 2056)]


def _dw_inputs(cuda, shape, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = (torch.randn((3, 3, shape[-1]), generator=g, device=cuda) / 3).to(dtype)
    bias = torch.randn((shape[-1],), generator=g, device=cuda).to(dtype)
    return x, w, bias


# (stride, rows): the launch's own choice at both strides, the ring kernel
# at three strip heights
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride,rows", [(1, 0), (2, 0), (1, 1), (1, 3), (1, 8)])
@pytest.mark.parametrize("shape", DW_SHAPES)
def test_dwconv_kernel_matches_plain(cuda, shape, stride, rows, dtype):
    x, w, _ = _dw_inputs(cuda, shape, dtype, 1)
    n, n2 = dwconv3x3.launches, dwconv3x3.launches_s2
    got = dwconv3x3(x, w, stride) if rows == 0 else dwconv3x3_forward(x, w, stride, rows=rows)
    torch.cuda.synchronize()
    assert dwconv3x3.launches == n + 1 and dwconv3x3.launches_s2 == n2 + (stride == 2)
    want = dwconv3x3_reference(x, w, stride)
    assert got.shape == want.shape
    _close(got, want, dtype)
    if rows > 0:  # the ring kernel keeps the direct kernel's order of sums: same bits
        assert torch.equal(got, dwconv3x3_forward(x, w, stride, rows=-1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride,rows", [(1, 0), (2, 0), (1, 5)])
def test_dwconv_kernel_takes_an_8_byte_aligned_view(cuda, stride, rows, dtype):
    """A view that starts 8 bytes into its storage: the launch falls to the
    8-byte word and gives what it gives for an aligned copy."""
    off = 8 // torch.empty((), dtype=dtype).element_size()
    g = torch.Generator(device=cuda).manual_seed(2)
    flat = torch.randn(2 * 9 * 11 * 16 + off, generator=g, device=cuda).to(dtype)
    x = flat[off:].view(2, 9, 11, 16)
    assert x.data_ptr() % 16 == 8
    w = (torch.randn((3, 3, 16), generator=g, device=cuda) / 3).to(dtype)
    got = dwconv3x3_forward(x, w, stride, rows=rows)
    torch.cuda.synchronize()
    assert torch.equal(got, dwconv3x3_forward(x.clone(), w, stride, rows=rows))
    _close(got, dwconv3x3_reference(x, w, stride), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [0, 3, 8])
@pytest.mark.parametrize("shape", DW_SHAPES)
def test_dwconv_epilogue_equals_the_three_passes(cuda, shape, rows, dtype):
    """conv + bias + x in one launch is bitwise the kernel's conv followed
    by the two PyTorch adds; the bias alone at both strides."""
    x, w, bias = _dw_inputs(cuda, shape, dtype, 3)
    n = dwconv3x3.launches
    for stride, b, res in ((1, bias, True), (1, None, True), (1, bias, False), (2, bias, False)):
        r = rows if stride == 1 else 0
        got = dwconv3x3_forward(x, w, stride, b, res, rows=r)
        want = dwconv3x3_forward(x, w, stride, rows=r)
        if b is not None:
            want = want + b
        if res:
            want = want + x
        torch.cuda.synchronize()
        assert torch.equal(got, want), (stride, b is not None, res)
    assert dwconv3x3.launches == n + 8
    _close(dwconv3x3(x, w, 1, bias, True), dwconv3x3_reference(x, w, 1) + bias + x, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 50, 24), (1, 1, 5), (3, 1000, 160), (8, 1024, 128)])
def test_metapool_backward_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(2)
    gy = torch.randn(shape, generator=g, device=cuda).to(dtype)
    n = metapool_tokens_backward.launches
    got = metapool_tokens_backward(gy)
    torch.cuda.synchronize()
    assert metapool_tokens_backward.launches == n + 1
    assert got.dtype == dtype and got.shape == gy.shape
    _close(got, metapool_tokens_backward_reference(gy), dtype)


# K1/K1b and the MetaPool site: the serving stages of stc_tt (duke) and
# stc_st, then odd ones: C that takes the 16-byte, the 8-byte and the
# one-element word, C above a block's 256 words in f32 (480 / 4 = 120 is
# not), one and two tokens, one channel
MP_SHAPES = [(8, 9216, 96), (8, 2304, 216), (8, 576, 288), (2, 37, 5), (3, 50, 24),
             (2, 41, 216), (2, 19, 288), (2, 33, 480), (3, 1, 24), (2, 2, 160), (4, 1, 5),
             (2, 2, 2), (2, 70, 1), (1, 5, 1100)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MP_SHAPES)
def test_metapool_kernels_at_model_and_odd_shapes(cuda, shape, dtype):
    """K1 and K1b against their plain versions."""
    g = torch.Generator(device=cuda).manual_seed(20)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    y, dx = metapool_tokens(x), metapool_tokens_backward(x)
    torch.cuda.synchronize()
    _close(y, metapool_tokens_reference(x), dtype)
    _close(dx, metapool_tokens_backward_reference(x), dtype)


def _site_inputs(cuda, shape, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    C = shape[-1]
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    w1, w2 = ((torch.rand(C, generator=g, device=cuda) + 0.5).to(dtype) for _ in range(2))
    b1, b2 = ((torch.randn(C, generator=g, device=cuda) * 0.1).to(dtype) for _ in range(2))
    return x, w1, b1, w2, b2


def _site_f64(x, w1, b1, w2, b2, eps=1e-6):
    """The site's chain in f64, no rounding."""
    x = x.double()
    C = x.shape[-1]
    n = F.layer_norm(x, (C,), w1.double(), b1.double(), eps)
    y = x + F.avg_pool2d(n[:, None], 3, 1, 1, count_include_pad=False)[:, 0] - n
    return y, F.layer_norm(y, (C,), w2.double(), b2.double(), eps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MP_SHAPES)
def test_metapool_block_flags(cuda, shape, dtype):
    """The site's flags: none is metapool_tokens, the residual alone is
    metapool_tokens(x) + x, both bit for bit; one launch each."""
    x = _site_inputs(cuda, shape, dtype, 21)[0]
    n = metapool_block.launches
    a, none = metapool_block(x, residual=False)
    y, _ = metapool_block(x)
    torch.cuda.synchronize()
    assert none is None and metapool_block.launches == n + 2
    assert torch.equal(a, metapool_tokens(x))
    assert torch.equal(y, metapool_tokens(x) + x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MP_SHAPES + [(8, 36864, 64)])
def test_metapool_block_matches_plain(cuda, shape, dtype):
    """The whole site (LayerNorm1, mixer, residual, LayerNorm2) against the
    four separate passes on the card.  f32: within 1e-5 |ref| + 1e-5 rms
    (the LayerNorm sums run in another order).  bf16: no further from the
    chain in f64 than 1.5x the plain bf16 passes, in the maximum and the
    mean error (a LayerNorm output that rounds the other way moves a value
    by one bf16 step)."""
    args = _site_inputs(cuda, shape, dtype, 22)
    with torch.inference_mode():
        got = metapool_block(*args)
        want = metapool_block_reference(*args)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        for a, c in zip(got, want):
            rms = float(c.double().square().mean().sqrt())
            assert bool(((a - c).abs() <= 1e-5 * c.abs() + 1e-5 * rms).all())
        return
    truth = _site_f64(*args)
    for a, c, t in zip(got, want, truth):
        e_k, e_p = (a.double() - t).abs(), (c.double() - t).abs()
        assert float(e_k.max()) <= 1.5 * float(e_p.max())
        assert float(e_k.mean()) <= 1.5 * float(e_p.mean())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [24, 5, 216])
def test_metapool_kernels_take_an_offset_view(cuda, C, dtype):
    """Inputs one element into their storage (no 16-byte words): K1, K1b
    and the site give the aligned copies' bits."""
    x, w1, b1, w2, b2 = _site_inputs(cuda, (2, 29, C), dtype, 23)
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
    flat[1:] = x.reshape(-1)
    xs = flat[1:].view(x.shape)
    assert xs.data_ptr() % 16 != 0
    assert torch.equal(metapool_tokens(xs), metapool_tokens(x))
    assert torch.equal(metapool_tokens_backward(xs), metapool_tokens_backward(x))
    with torch.inference_mode():
        for a, c in zip(metapool_block(xs, w1, b1, w2, b2), metapool_block(x, w1, b1, w2, b2)):
            assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_metapool_block_captures_and_replays(cuda, dtype):
    """One site at a serving shape captured in a CUDA graph and replayed on
    new inputs copied into the captured ones: the eager bits."""
    shape = (8, 2304, 128)
    args = _site_inputs(cuda, shape, dtype, 24)
    with torch.inference_mode():
        metapool_block(*args)
        torch.cuda.synchronize()
        static = [a.clone() for a in args]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = metapool_block(*static)
        new = _site_inputs(cuda, shape, dtype, 25)
        for dst, src in zip(static, new):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        for a, c in zip(outs, metapool_block(*new)):
            assert torch.equal(a, c)


def test_metapool_block_refuses(cuda):
    x, w1, b1, w2, b2 = _site_inputs(cuda, (2, 8, 24), torch.float32, 26)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="float32/bfloat16"):
            metapool_block(x.half(), w1.half(), b1.half(), w2.half(), b2.half())
        with pytest.raises(ValueError, match="LayerNorm weights"):
            metapool_block(x, w1.bfloat16(), b1, w2, b2)
        with pytest.raises(ValueError, match="LayerNorm weights"):
            metapool_block(x, w1[:20], b1[:20], w2, b2)
        with pytest.raises(ValueError, match="LayerNorm weights"):
            metapool_block(x, w1.cpu(), b1, w2, b2)
        with pytest.raises(ValueError, match="device"):
            metapool_block(x.to("meta"))
    with pytest.raises(ValueError, match="no backward"):
        metapool_block(x, w1.requires_grad_(), b1, w2, b2)


# --- the site on a width shard (tcct::metapool_block_shard) -----------------------------

# (B, H, W, C) token grids split 2 and 4 ways: duke's four site shapes at 4
# rows a rank, then odd ones (C taking the 16-byte, 8-byte and one-element
# words, one row, one column a rank, a row wider than a tile)
SHARD_GRIDS = [(4, 128, 288, 64), (4, 64, 144, 96), (4, 32, 72, 128), (4, 16, 36, 160),
               (2, 5, 16, 24), (1, 1, 8, 5), (2, 3, 4, 2), (1, 2, 1200, 8), (3, 7, 12, 216)]


def _shard_site(x, M, m, affine, fn=None):
    """Rank m's site on its columns of the whole [B, H, W, C] grid ``x``."""
    from tcct_tpu_torch.parallel.spatial import cut_halos

    from tcct_tpu_torch.ops.kernels.metapool import metapool_block_shard

    B, H, _, C = x.shape
    xs, lh, rh = cut_halos(x, m, (x.shape[2] // M,) * M, 1, 1, wrap=True)
    return (fn or metapool_block_shard)(xs.reshape(B, -1, C), lh[:, :, 0], rh[:, :, 0], m == 0,
                                        m == M - 1, *affine)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("grid", SHARD_GRIDS)
def test_metapool_block_shard_matches_plain_and_reassembles(cuda, grid, M, dtype):
    """The shard entry point against its plain version on the same CUDA
    tensors (f32 within 1e-5 |ref| + 1e-5 rms, bf16 no further from the f64
    chain than 1.5x the plain passes, as the site's test), one launch a
    rank; the ranks' outputs reassembled are the one-launch site's on the
    whole grid bit for bit."""
    from tcct_tpu_torch.ops.kernels.metapool import (
        metapool_block_shard,
        metapool_block_shard_reference,
    )

    B, H, W, C = grid
    if W % M:
        pytest.skip("the grid's width does not split")
    x, w1, b1, w2, b2 = _site_inputs(cuda, (B, H * W, C), dtype, 27)
    x = x.reshape(B, H, W, C)
    affine = (w1, b1, w2, b2)
    with torch.inference_mode():
        n = metapool_block_shard.launches
        parts = [_shard_site(x, M, m, affine) for m in range(M)]
        assert metapool_block_shard.launches == n + M
        for m, got in enumerate(parts):
            want = _shard_site(x, M, m, affine, fn=metapool_block_shard_reference)
            if dtype == torch.float32:
                for a, c in zip(got, want):
                    rms = float(c.double().square().mean().sqrt())
                    assert bool(((a - c).abs() <= 1e-5 * c.abs() + 1e-5 * rms).all())
        whole = metapool_block(x.reshape(B, -1, C), *affine)
        for i in (0, 1):
            got = torch.cat([p[i].reshape(B, H, -1, C) for p in parts], 2).reshape(B, -1, C)
            assert torch.equal(got, whole[i])
    if dtype == torch.bfloat16:
        truth = _site_f64(x.reshape(B, -1, C), *affine)
        want = metapool_block_reference(x.reshape(B, -1, C), *affine)
        for i in (0, 1):
            e_k, e_p = (whole[i].double() - truth[i]).abs(), (want[i].double() - truth[i]).abs()
            assert float(e_k.max()) <= 1.5 * float(e_p.max())


def test_metapool_block_shard_refuses(cuda):
    from tcct_tpu_torch.ops.kernels.metapool import metapool_block_shard

    x, w1, b1, w2, b2 = _site_inputs(cuda, (2, 12, 24), torch.float32, 28)
    h = x[:, :3]
    with torch.inference_mode():
        with pytest.raises(ValueError, match="do not fit"):
            metapool_block_shard(x, x[:, :5], x[:, :5], True, True, w1, b1, w2, b2)
        with pytest.raises(ValueError, match="halos must be"):
            metapool_block_shard(x, h.bfloat16(), h, True, True, w1, b1, w2, b2)
        with pytest.raises(ValueError, match="LayerNorm weights"):
            metapool_block_shard(x, h, h, True, True, w1.bfloat16(), b1, w2, b2)
    with pytest.raises(ValueError, match="no backward"):
        metapool_block_shard(x.requires_grad_(), h, h, True, True, w1, b1, w2, b2)


def _dw_bwd_close(x, w, gy, stride, dtype, **flags):
    """dx as the forward's tolerance; dw within 1e-5 of sum|x*g| per tap
    (f32 summation order) plus, in bf16, one rounding of dw (2^-7 |dw|),
    against the plain version run in f32 and cast; db likewise within 1e-5
    of sum|g|.  Returns the kernel's (dx, dw, db)."""
    dx, dw, db = dwconv3x3_backward(x, w, gy, stride, **flags)
    torch.cuda.synchronize()
    rdx, _, _ = dwconv3x3_backward_reference(x, w, gy, stride, **flags)
    assert dw.dtype == w.dtype
    if rdx is None:
        assert dx is None
    else:
        assert dx.dtype == x.dtype
        _close(dx, rdx, dtype)
    mag = dwconv3x3_backward_reference(x.float().abs(), w.float(), gy.float().abs(), stride)[1]
    ref32 = dwconv3x3_backward_reference(x.float(), w.float(), gy.float(), stride)[1]
    one = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    err = (dw.float() - ref32).abs()
    lim = 1e-5 * mag + 1e-6 + one * ref32.abs()
    assert bool((err <= lim).all()), float((err - lim).max())
    if flags.get("bias"):
        gsum = gy.float().sum((0, 1, 2))
        lim = 1e-5 * gy.float().abs().sum((0, 1, 2)) + 1e-6 + one * gsum.abs()
        assert db.dtype == gy.dtype and bool(((db.float() - gsum).abs() <= lim).all())
    else:
        assert db is None
    return dx, dw, db


def _dw_bwd_inputs(cuda, shape, stride, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = (torch.randn((3, 3, shape[-1]), generator=g, device=cuda) / 3).to(dtype)
    Ho, Wo = (shape[1] - 1) // stride + 1, (shape[2] - 1) // stride + 1
    gy = torch.randn((shape[0], Ho, Wo, shape[3]), generator=g, device=cuda).to(dtype)
    return x, w, gy


# K2b: C a multiple of 4 (four channels a thread; 16-byte copies where the
# rows allow), the narrow channels 1-8 (parts of several pixels a thread),
# rows around a tile (1,024 elements: 256 pixels at C = 4, 128 at C = 8),
# H = 1, W = 1, odd sizes at stride 2, and a train shape
DWB_SHAPES = [(2, 12, 24, 8), (1, 9, 13, 40), (2, 33, 17, 160), (8, 64, 64, 96), (2, 31, 29, 4),
              (3, 20, 19, 1), (2, 9, 11, 2), (2, 7, 13, 3), (1, 11, 9, 5), (2, 9, 7, 6),
              (1, 13, 11, 7), (2, 10, 12, 8), (1, 5, 257, 4), (1, 4, 129, 8), (1, 6, 255, 4),
              (2, 1, 33, 16), (2, 17, 1, 12), (1, 1, 1, 4), (1, 9, 31, 12), (2, 1, 1, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape", DWB_SHAPES)
def test_dwconv_backward_kernel_matches_plain(cuda, shape, stride, dtype):
    """One launch a call; dx, dw against the plain version; then each flag:
    bias (db), residual (stride 1: bitwise dx + g), no dx; dw the same bits
    in every call and run."""
    x, w, gy = _dw_bwd_inputs(cuda, shape, stride, dtype, 3)
    n, n2 = dwconv3x3_backward.launches, dwconv3x3_backward.launches_s2
    dx, dw, _ = _dw_bwd_close(x, w, gy, stride, dtype)
    assert dwconv3x3_backward.launches == n + 1
    assert dwconv3x3_backward.launches_s2 == n2 + (stride == 2)
    res = stride == 1
    dx1, dw1, db1 = _dw_bwd_close(x, w, gy, stride, dtype, bias=True, residual=res)
    assert torch.equal(dx1, dx + gy if res else dx) and torch.equal(dw1, dw)
    no_dx, dw2, db2 = _dw_bwd_close(x, w, gy, stride, dtype, bias=True, need_dx=False)
    assert no_dx is None and torch.equal(dw2, dw) and torch.equal(db2, db1)
    _, dw3, _ = dwconv3x3_backward(x, w, gy, stride)
    assert torch.equal(dw3, dw)  # fixed-order reduction: bitwise repeatable
    assert dwconv3x3_backward.launches == n + 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("C", [4, 8, 3])
def test_dwconv_backward_takes_an_offset_view(cuda, C, stride, dtype):
    """x and g starting one element into their storage (no 16-byte copies):
    dx bitwise the aligned copies', dw and db within the bounds."""
    x, w, gy = _dw_bwd_inputs(cuda, (2, 9, 13, C), stride, dtype, 4)
    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=dtype, device=cuda)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)
    xs, gs = shifted(x), shifted(gy)
    assert xs.data_ptr() % 16 != 0 and gs.data_ptr() % 16 != 0
    dx, _, _ = _dw_bwd_close(xs, w, gs, stride, dtype, bias=True)
    assert torch.equal(dx, dwconv3x3_backward(x, w, gy, stride)[0])


@pytest.mark.parametrize("stride,shape", [(1, (8, 64, 64, 96)), (1, (8, 256, 256, 1)),
                                          (2, (8, 64, 64, 128))])
def test_dwconv_backward_captures_and_replays(cuda, stride, shape):
    """One K2b call (bias, and the residual at stride 1) at a train shape,
    captured in a CUDA graph and replayed on new inputs copied into the
    captured ones, gives the eager results bit for bit: the launch
    allocates nothing and its workspace stays put."""
    dtype = torch.bfloat16
    flags = dict(bias=True, residual=stride == 1)
    x, w, gy = _dw_bwd_inputs(cuda, shape, stride, dtype, 5)
    dwconv3x3_backward(x, w, gy, stride, **flags)  # builds and sizes the workspace
    torch.cuda.synchronize()
    sx, sw, sg = x.clone(), w.clone(), gy.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = dwconv3x3_backward(sx, sw, sg, stride, **flags)
    x2, w2, g2 = _dw_bwd_inputs(cuda, shape, stride, dtype, 6)
    for dst, src in zip((sx, sw, sg), (x2, w2, g2)):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    want = dwconv3x3_backward(x2, w2, g2, stride, **flags)
    for a, c in zip(outs, want):
        assert torch.equal(a, c)


def _bn_inputs(cuda, shape, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    C = shape[1]
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    w = (torch.rand(C, generator=g, device=cuda) + 0.5).to(dtype)
    b = (torch.randn(C, generator=g, device=cuda) * 0.1).to(dtype)
    return x, w, b


# The train step's BatchNorm shapes (every one of the 18 of a bf16 stc_tt
# step, batch 8 at 256x256), then odd ones: one channel, C not a multiple
# of a 16-byte word, C above 256, rows fewer than a block's lanes.
BN_SHAPES = [(8, 1, 256, 256), (8, 32, 16, 16), (8, 32, 32, 32), (8, 32, 64, 64),
             (8, 32, 128, 128), (8, 32, 256, 256), (8, 64, 128, 128), (8, 96, 64, 64),
             (8, 96, 128, 128), (8, 128, 32, 32), (8, 128, 64, 64), (8, 160, 16, 16),
             (8, 160, 32, 32),
             (2, 32, 12, 10), (4, 96, 33, 17), (2, 1, 64, 64), (3, 4, 7, 5), (2, 300, 5, 6)]


@pytest.mark.parametrize("leaky", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_bn_train_kernel_matches_plain(cuda, shape, dtype, leaky):
    """K3: batch mean and var within 1e-5 of E[|t|] and E[t^2] (f32 sums
    in another order); y equal to the plain normalize given those
    statistics, to the forward's tolerance; repeated runs bitwise equal."""
    x, w, b = _bn_inputs(cuda, shape, dtype, 4)
    n = bn_act_train.launches
    y, mean, var = bn_act_train(x, w, b, 1e-5, leaky)
    torch.cuda.synchronize()
    assert bn_act_train.launches == n + 1
    assert y.dtype == dtype and mean.dtype == var.dtype == torch.float32
    rm, rv = bn_stats_reference(x, leaky)
    t = torch.nn.functional.leaky_relu(x, 0.01) if leaky else x
    tf = t.float()
    assert bool(((mean - rm).abs() <= 1e-5 * tf.abs().mean((0, 2, 3)) + 1e-7).all())
    assert bool(((var - rv).abs() <= 1e-5 * (tf * tf).mean((0, 2, 3)) + 1e-7).all())
    _close(y, bn_normalize_reference(x, mean, var, w, b, 1e-5, leaky), dtype)
    y2, mean2, var2 = bn_act_train(x, w, b, 1e-5, leaky)
    assert torch.equal(y, y2) and torch.equal(mean, mean2) and torch.equal(var, var2)


def _bn_bwd_close(x, w, mean, var, gy, leaky, got):
    """K3b against the plain adjoint on the same inputs, within
    bn_act_train_backward_tolerance: one rounding to x's dtype of the plain
    dx plus what 1e-5 of the two f32 sums moves it by; dweight and dbias
    within 1e-5 of r * sum|gy * t| (+ |mean| sum|gy|) and of sum|gy|."""
    want = bn_act_train_backward_reference(x, w, mean, var, gy, 1e-5, leaky)
    lims = bn_act_train_backward_tolerance(x, w, mean, var, gy, 1e-5, leaky)
    assert got[0].dtype == x.dtype and got[0].shape == x.shape
    assert got[1].dtype == got[2].dtype == w.dtype
    assert bool(torch.isfinite(got[0].float()).all())
    for a, c, lim in zip(got, want, lims):
        err = (a.double() - c.double()).abs()
        assert bool((err <= lim).all()), (float(err.max()), float((err - lim).max()))


@pytest.mark.parametrize("leaky", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_bn_train_backward_kernel_matches_plain(cuda, shape, dtype, leaky):
    """K3b against the plain adjoint at the forward kernel's statistics
    (bounds in _bn_bwd_close); one launch a call; repeated runs bitwise
    equal."""
    x, w, b = _bn_inputs(cuda, shape, dtype, 5)
    _, mean, var = bn_act_train(x, w, b, 1e-5, leaky)
    g = torch.Generator(device=cuda).manual_seed(7)
    gy = torch.randn(x.shape, generator=g, device=cuda).to(dtype)
    gy = gy.contiguous(memory_format=torch.channels_last)
    n = bn_act_train_backward.launches
    got = bn_act_train_backward(x, w, mean, var, gy, 1e-5, leaky)
    torch.cuda.synchronize()
    assert bn_act_train_backward.launches == n + 1
    _bn_bwd_close(x, w, mean, var, gy, leaky, got)
    again = bn_act_train_backward(x, w, mean, var, gy, 1e-5, leaky)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_train_backward_on_card_matches_plain(cuda, dtype):
    """Autograd through bn_act_train on the card runs K3b (one launch), and
    its gradients are the plain adjoint's at the bounds of _bn_bwd_close,
    also for a gradient that comes in NCHW-contiguous."""
    x, w, b = _bn_inputs(cuda, (4, 32, 16, 16), dtype, 5)
    xr = x.detach().requires_grad_()
    wr, br = w.detach().requires_grad_(), b.detach().requires_grad_()
    y, mean, var = bn_act_train(xr, wr, br, 1e-5, True)
    gy = torch.randn(y.shape, device=cuda).to(dtype)  # contiguous, not channels_last
    n = bn_act_train_backward.launches
    got = torch.autograd.grad(y, (xr, wr, br), gy)
    assert bn_act_train_backward.launches == n + 1
    _bn_bwd_close(x, w, mean, var, gy, True, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_train_kernels_are_one_launch_each(cuda, dtype):
    """A K3 call and a K3b call each put one kernel on the device and
    nothing else (train shape, channels_last gradient)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, w, b = _bn_inputs(cuda, (8, 64, 128, 128), dtype, 8)
    gy = torch.randn_like(x).contiguous(memory_format=torch.channels_last)
    _, mean, var = bn_act_train(x, w, b, 1e-5, False)
    bn_act_train_backward(x, w, mean, var, gy, 1e-5, False)
    torch.cuda.synchronize()
    for call, kernel in ((lambda: bn_act_train(x, w, b, 1e-5, False), "bn_act_fwd_kernel"),
                         (lambda: bn_act_train_backward(x, w, mean, var, gy, 1e-5, False),
                          "bn_act_bwd_kernel")):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)]
        assert len(names) == 1 and kernel in names[0], names


@pytest.mark.parametrize("leaky", [False, True])
def test_bn_train_kernels_capture_and_replay(cuda, leaky):
    """One K3 call and one K3b call at a train shape, captured in a CUDA
    graph and replayed on new inputs copied into the captured ones, give
    the eager results bit for bit."""
    shape, dtype = (8, 32, 128, 128), torch.bfloat16
    x, w, b = _bn_inputs(cuda, shape, dtype, 9)
    gy = torch.randn(shape, device=cuda).to(dtype).contiguous(memory_format=torch.channels_last)

    def both(x, w, b, gy):
        y, mean, var = bn_act_train(x, w, b, 1e-5, leaky)
        return (y, mean, var) + bn_act_train_backward(x, w, mean, var, gy, 1e-5, leaky)

    both(x, w, b, gy)  # builds and warms up outside the capture
    torch.cuda.synchronize()
    sx, sw, sb, sg = (t.clone() for t in (x, w, b, gy))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = both(sx, sw, sb, sg)
    x2, w2, b2 = _bn_inputs(cuda, shape, dtype, 10)
    gy2 = (torch.randn(shape, device=cuda) * 0.5).to(dtype)
    for dst, src in zip((sx, sw, sb, sg), (x2, w2, b2, gy2)):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    want = both(x2, w2, b2, gy2.contiguous(memory_format=torch.channels_last))
    for a, c in zip(outs, want):
        assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_fn_through_kernels(cuda, dtype):
    """The wrappers are autograd Functions on the card: their outputs carry
    a grad_fn, and the gradients match torch autograd through the plain
    versions, run in f32 (metapool: shifted adds; depthwise: F.conv2d)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((2, 256, 64), generator=g, device=cuda).to(dtype).requires_grad_()
    y = metapool_tokens(x)
    assert y.grad_fn is not None
    gy = torch.randn_like(y)
    (gx,) = torch.autograd.grad(y, x, gy)
    xf = x.detach().float().requires_grad_()
    (gx_ref,) = torch.autograd.grad(metapool_tokens_reference(xf), xf, gy.float())
    _close(gx, gx_ref.to(dtype), dtype)

    for stride in (1, 2):
        x = torch.randn((2, 17, 24, 32), generator=g, device=cuda).to(dtype).requires_grad_()
        w = (torch.randn((3, 3, 32), generator=g, device=cuda) / 3).to(dtype).requires_grad_()
        y = dwconv3x3(x, w, stride)
        assert y.grad_fn is not None
        gy = torch.randn_like(y)
        gx, gw = torch.autograd.grad(y, (x, w), gy)
        xf, wf = x.detach().float().requires_grad_(), w.detach().float().requires_grad_()
        gx_ref, gw_ref = torch.autograd.grad(dwconv3x3_reference(xf, wf, stride), (xf, wf),
                                             gy.float())
        _close(gx, gx_ref.to(dtype), dtype)
        mag = dwconv3x3_backward_reference(xf.detach().abs(), wf.detach(), gy.float().abs(),
                                           stride)[1]
        lim = 1e-5 * mag + 1e-6 + (2.0 ** -7 * gw_ref.abs() if dtype == torch.bfloat16 else 0)
        assert bool(((gw.float() - gw_ref).abs() <= lim).all())

    # with the bias and the residual: dx gains g, the bias gets g summed over the pixels
    b = torch.randn((32,), generator=g, device=cuda).to(dtype).requires_grad_()
    x = x.detach().requires_grad_()
    y = dwconv3x3(x, w, 1, b, True)
    assert y.grad_fn is not None
    gy = torch.randn_like(y)
    gx, gw, gb = torch.autograd.grad(y, (x, w, b), gy)
    dx, dw, _ = dwconv3x3_backward(x.detach(), w.detach(), gy, 1)
    assert torch.equal(gx, dx + gy) and torch.equal(gw, dw)
    # the bias gradient is the kernel's fixed-order f32 sum of g, cast once
    assert torch.equal(gb, dwconv3x3_backward(x.detach(), w.detach(), gy, 1, bias=True)[2])
    gsum = gy.float().sum((0, 1, 2))
    lim = 1e-5 * gy.float().abs().sum((0, 1, 2)) + 1e-6 + (
        2.0 ** -7 * gsum.abs() if dtype == torch.bfloat16 else 0)
    assert bool(((gb.float() - gsum).abs() <= lim).all())


def _cross_block(cuda, cin, cout, k, dtype, seed, plain=False):
    """The seeded block (random conv biases, random positive BN affines and
    statistics, eval mode) on the card."""
    return seeded_cross_block(cin, cout, k, seed, plain).to(device=cuda, dtype=dtype)


def _k4_close(got, want, dtype):
    """Both versions round the same chain at the same places and differ in
    the order of their f32 sums; the bounds scale with the plain output's
    rms (5 to 12 with these seeded blocks, elements up to 290).
    f32: 1e-4 rms abs + 1e-4 rel (1e-4 + 1e-4 rel at unit scale), the
    summation-order error of six chained convs.
    bf16: where the two f32 sums of an intermediate straddle a bf16 rounding
    boundary the intermediate differs by one bf16 ulp, and up to three more
    convs and a BatchNorm scale carry that to a few outputs.  So every
    element is held to 2^-7 |want| + 2^-3 rms, all but 2 + 2^-19 of them
    (about two in a million) to 2^-6 |want| + 2^-5 rms, and the mean error
    to 2^-11 rms."""
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all())
    err = (g - w).abs()
    rms = w.pow(2).mean().sqrt().clamp_min(1.0)
    if dtype == torch.float32:
        lim = 1e-4 * rms + 1e-4 * w.abs()
    else:
        lim = 2.0 ** -7 * w.abs() + 2.0 ** -3 * rms
        n_out = int((err > 2.0 ** -6 * w.abs() + 2.0 ** -5 * rms).sum())
        assert n_out <= 2 + err.numel() * 2.0 ** -19, (n_out, err.numel())
        assert float(err.mean()) <= 2.0 ** -11 * float(rms), (float(err.mean()), float(rms))
    bad = err > lim
    assert not bool(bad.any()), (int(bad.sum()), float(err.max()), float((err - lim).max()))


# (B, H, W, Cin, Cout, k, plain): stc_tt's five duke levels, gtc_tb's
# channel-changing levels, a plain block, an input smaller than a tile
K4_SHAPES = [
    (8, 256, 576, 32, 32, 13, False), (8, 128, 288, 32, 32, 11, False),
    (8, 64, 144, 32, 32, 9, False), (8, 32, 72, 32, 32, 7, False),
    (8, 16, 36, 32, 32, 5, False),
    (8, 128, 288, 32, 64, 11, False), (8, 64, 144, 64, 96, 9, False),
    (8, 32, 72, 96, 128, 7, False), (8, 16, 36, 128, 256, 5, False),
    (8, 64, 144, 32, 32, 9, True), (8, 4, 8, 32, 32, 5, False),
    (3, 20, 44, 128, 256, 5, False),  # the weights stream through the ring; no tile divides H, W
]


# f32 runs on the CUDA cores, bf16 on the tensor cores
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K4_SHAPES)
def test_fused_cross_block_kernel_matches_plain(cuda, shape, dtype):
    B, H, W, cin, cout, k, plain = shape
    blk = _cross_block(cuda, cin, cout, k, dtype, 7, plain)
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn((B, H, W, cin), generator=g, device=cuda).to(dtype)
    n = fused_cross_block.launches
    with torch.inference_mode():
        got = fused_cross_block(x, blk)
        torch.cuda.synchronize()
        assert fused_cross_block.launches == n + 1
        want = fused_cross_block_reference(x, blk)
    assert got.shape == (B, H, W, cout) and got.dtype == dtype
    plan = fused_plan(B, H, W, cin, cout, 3 if plain else k, dtype)
    assert plan.th >= 1 and plan.smem <= 232448
    assert plan.tw in ((12, 28, 44, 60) if dtype == torch.bfloat16 else (1, 2, 4, 8, 16))
    _k4_close(got, want, dtype)


# (th, tw, ring steps a slot; 0: resident weights) in place of the launch's own plan, bf16
K4_PLANS = [(8, 28, 0), (24, 12, 0), (16, 12, 0), (4, 12, 0), (4, 28, 1), (8, 12, 3),
            (4, 12, 8), (2, 12, 16)]


@pytest.mark.parametrize("plan", K4_PLANS)
@pytest.mark.parametrize("shape", [(2, 37, 61, 32, 32, 13), (3, 20, 44, 32, 64, 7),
                                   (2, 9, 30, 64, 96, 5)])
def test_fused_cross_block_plans_bitwise(cuda, shape, plan):
    """Every plan (tile, resident or streamed weights at any chunk, and so
    256 or 512 threads a block) gives the launch's own output bit for bit:
    each accumulator takes its MMAs in the same order."""
    B, H, W, cin, cout, k = shape
    th, tw, ring = plan
    blk = _cross_block(cuda, cin, cout, k, torch.bfloat16, 14)
    g = torch.Generator(device=cuda).manual_seed(15)
    x = torch.randn((B, H, W, cin), generator=g, device=cuda).to(torch.bfloat16)
    pk = pack_cross_block(blk, torch.bfloat16)
    with torch.inference_mode():
        want = fused_cross_block(x, blk)
        got = torch.empty_like(want)
        err = _fn("tcct_crosscnn_fused_fwd_at")(
            x.data_ptr(), pk.wf.data_ptr(), pk.vec.data_ptr(), got.data_ptr(), B, H, W, cin, cout,
            k, th, tw, ring, torch.cuda.current_stream().cuda_stream)
        if err == 1:  # cudaErrorInvalidValue: these weights do not fit beside the tile
            assert cout > 32 and ring == 0
            return
        build.check(err, f"K4 at plan {plan}")
        torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_fused_cross_block_against_its_own_source(cuda):
    """``chip_smoke.py --against`` with this tree's own sources: the other
    library binds and launches, and agrees bit for bit at every fused-block
    shape."""
    import chip_smoke

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    verdicts = chip_smoke.compare_against(root, "", ["fused_cross_block"], timed=False)
    assert verdicts == [True] * len(chip_smoke.K4_SHAPES)


@pytest.mark.parametrize("k", [3, 5, 7, 9, 11, 13])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_cross_block_kernel_odd_sizes(cuda, dtype, k):
    """A seeded sweep of odd H and W and batch sizes, which no tile divides:
    the edge guards and the per-stage zero masks, at every tile the launch
    shrinks to for a small grid."""
    gen = torch.Generator().manual_seed(9 + k)
    for i in range(6):
        H = int(torch.randint(1, 65, (1,), generator=gen))
        W = int(torch.randint(1, 81, (1,), generator=gen))
        B = (1, 2, 5, 24, 16, 3)[i]  # small grids shrink the tile, large ones keep it
        cin, cout = ((32, 32), (32, 64), (64, 32))[i % 3]
        blk = _cross_block(cuda, cin, cout, k, dtype, 10 + i)
        g = torch.Generator(device=cuda).manual_seed(11 + i)
        x = torch.randn((B, H, W, cin), generator=g, device=cuda).to(dtype)
        with torch.inference_mode():
            got = fused_cross_block(x, blk)
            torch.cuda.synchronize()
            _k4_close(got, fused_cross_block_reference(x, blk), dtype)


def test_fused_cross_block_refuses(cuda):
    blk = _cross_block(cuda, 32, 32, 5, torch.float32, 12)
    x = torch.zeros(1, 8, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="no backward"):
        fused_cross_block(x, blk)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="channels"):
            fused_cross_block(torch.zeros(1, 8, 8, 16, device=cuda), blk)
        with pytest.raises(ValueError, match="float32/bfloat16"):
            fused_cross_block(x.half(), blk)
        with pytest.raises(ValueError, match="train mode"):
            fused_cross_block(x, blk.train())
        # no model has a bf16 block the tensor cores do not take
        narrow = _cross_block(cuda, 8, 24, 5, torch.bfloat16, 13)
        with pytest.raises(ValueError, match="multiple of 16"):
            fused_cross_block(torch.zeros(2, 9, 11, 8, device=cuda).bfloat16(), narrow)
        with pytest.raises(build.KernelError):
            fused_plan(2, 9, 11, 8, 24, 5, torch.bfloat16)
        f32 = fused_cross_block(torch.ones(2, 9, 11, 8, device=cuda), narrow.float())
        assert f32.shape == (2, 9, 11, 24)  # f32 takes multiples of 8


def test_kernels_refuse_bad_inputs(cuda):
    with pytest.raises(ValueError):
        metapool_tokens(torch.zeros(2, 4, 4, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError):
        dwconv3x3(torch.zeros(1, 4, 4, 8, device=cuda), torch.zeros(3, 3, 4, device=cuda))
    with pytest.raises(ValueError, match="stride 1"):
        dwconv3x3(torch.zeros(1, 4, 4, 8, device=cuda), torch.zeros(3, 3, 8, device=cuda), 2,
                  residual=True)
    with pytest.raises(ValueError, match="stride 1"):
        dwconv3x3_forward(torch.zeros(1, 4, 4, 8, device=cuda),
                          torch.zeros(3, 3, 8, device=cuda), 2, rows=4)
    with pytest.raises(ValueError, match="bias"):
        dwconv3x3(torch.zeros(1, 4, 4, 8, device=cuda), torch.zeros(3, 3, 8, device=cuda),
                  bias=torch.zeros(4, device=cuda))
    with pytest.raises(ValueError):
        dwconv3x3_backward(torch.zeros(1, 4, 4, 8, device=cuda), torch.zeros(3, 3, 8, device=cuda),
                           torch.zeros(1, 3, 4, 8, device=cuda))
    with pytest.raises(ValueError, match="stride 1"):
        dwconv3x3_backward(torch.zeros(1, 4, 4, 8, device=cuda), torch.zeros(3, 3, 8, device=cuda),
                           torch.zeros(1, 2, 2, 8, device=cuda), 2, residual=True)
    with pytest.raises(ValueError):
        bn_act_train(torch.zeros(2, 4, 3, 3, device=cuda, dtype=torch.float16),
                     torch.ones(4, device=cuda), torch.zeros(4, device=cuda))
    x = torch.zeros(2, 4, 3, 3, device=cuda)
    with pytest.raises(ValueError, match="gy"):
        bn_act_train_backward(x, torch.ones(4, device=cuda), torch.zeros(4, device=cuda),
                              torch.ones(4, device=cuda), torch.zeros(2, 4, 3, 4, device=cuda))
    with pytest.raises(ValueError, match="channels"):  # more than one block of words
        bn_act_train(torch.zeros(1, 4099, 1, 1, device=cuda), torch.ones(4099, device=cuda),
                     torch.zeros(4099, device=cuda))


def test_build_all(cuda):
    build.build_all()
    for name in build.sources():
        assert build.load(name) is not None


def _layered(n, hw, n_class=5, seed=0):
    """uint8 scans and labels, one horizontal band per class."""
    g = torch.Generator().manual_seed(seed)
    imgs = torch.randint(0, 256, (n, *hw, 3), generator=g, dtype=torch.uint8)
    rows = torch.arange(hw[0])[:, None].expand(*hw)
    labs = (rows * n_class // hw[0]).to(torch.uint8).expand(n, *hw).contiguous()
    return imgs, labs


def test_augmentation_makes_no_host_sync(cuda):
    """The train chain's draws and application never wait for the card:
    ``set_sync_debug_mode('error')`` turns any synchronisation into an error."""
    from tcct_tpu_torch.data.augment import apply_train, draw_train

    imgs, labs = (t.to(cuda) for t in _layered(4, (96, 128)))
    labs[2] = 0  # an empty mask takes the fallback window
    gen = torch.Generator(device=cuda).manual_seed(0)
    apply_train(imgs, labs, draw_train(labs, gen, (64, 64)), (64, 64))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        img, lab = apply_train(imgs, labs, draw_train(labs, gen, (64, 64)), (64, 64))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert img.shape == (4, 64, 64, 3) and lab.shape == (4, 64, 64)
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0


def test_augmented_bf16_step_repeats_bitwise(cuda):
    """One augmented bf16 train step of full-width stc_tt (batch 2, 96x128
    scans cropped to 64x64) twice from one state and one generator: every
    state tensor and the generator's state equal bit for bit."""
    from tcct_tpu_torch.models import RegNet, get_model
    from tcct_tpu_torch.models.layers import init_weights
    from tcct_tpu_torch.train import TrainConfig, build_train_step, make_optimizer

    imgs, labs = _layered(2, (96, 128))
    cfg = TrainConfig(n_class=5, crop_hw=(64, 64), ds=True, udh=True, reg=True, augment=True,
                      dtype=torch.bfloat16)
    ends = []
    for _ in range(2):
        m = RegNet(get_model("stc_tt", 5, variant="train", drop_path_rate=0.1), out_channels=5)
        init_weights(m, torch.Generator().manual_seed(0))
        gen = torch.Generator(device=cuda).manual_seed(1)
        build_train_step(m, make_optimizer(1, lr=1e-4), cfg, cuda, gen)(imgs, labs)
        ends.append({**m.state_dict(), "generator": gen.get_state()})
    off = [k for k in ends[0] if not torch.equal(ends[0][k], ends[1][k])]
    assert not off, off[:8]


# The gated fusion's f32 maps reach the head and decoder BatchNorms with the
# step's bf16 weights (gtc_tt, batch 8 at 256x256: the head at 16x16, the
# decoder's four levels, lap_map's one channel).
BN_GATED_SHAPES = [(8, 32, 16, 16), (8, 32, 32, 32), (8, 32, 64, 64), (8, 32, 128, 128),
                   (8, 1, 256, 256), (2, 300, 5, 6)]


@pytest.mark.parametrize("shape", BN_GATED_SHAPES)
def test_bn_train_kernels_f32_input_bf16_params(cuda, shape):
    """K3 and K3b on an f32 input with bf16 weight and bias: y in f32, the
    statistics, and (dx, dweight, dbias) against the plain versions at the
    bounds of the same-type tests; dweight and dbias come back in bf16.  A
    weight of a type the kernel does not read (fp16) raises."""
    x, w, b = _bn_inputs(cuda, shape, torch.float32, 11)
    w, b = w.to(torch.bfloat16), b.to(torch.bfloat16)
    n = bn_act_train.launches
    y, mean, var = bn_act_train(x, w, b, 1e-5, False)
    torch.cuda.synchronize()
    assert bn_act_train.launches == n + 1 and y.dtype == torch.float32
    rm, rv = bn_stats_reference(x, False)
    assert bool(((mean - rm).abs() <= 1e-5 * x.abs().mean((0, 2, 3)) + 1e-7).all())
    assert bool(((var - rv).abs() <= 1e-5 * (x * x).mean((0, 2, 3)) + 1e-7).all())
    _close(y, bn_normalize_reference(x, mean, var, w, b, 1e-5, False), torch.float32)
    gy = torch.randn(x.shape, device=cuda).contiguous(memory_format=torch.channels_last)
    got = bn_act_train_backward(x, w, mean, var, gy, 1e-5, False)
    _bn_bwd_close(x, w, mean, var, gy, False, got)
    with pytest.raises(ValueError, match="float32/bfloat16 weight"):
        bn_act_train(x, w.half(), b, 1e-5, False)


# Task 2's f32 BatchNorms (batch 8 at 224x224): every shape of the res18
# step, then those res50 adds, up to 2048 channels (512 words a row: one row
# lane a block) and 25.7 MB maps.
BN_TASK2_SHAPES = [(8, 64, 112, 112), (8, 64, 56, 56), (8, 128, 28, 28), (8, 256, 14, 14),
                   (8, 512, 7, 7), (8, 256, 56, 56), (8, 128, 56, 56), (8, 512, 28, 28),
                   (8, 1024, 14, 14), (8, 2048, 7, 7)]


@pytest.mark.parametrize("shape", BN_TASK2_SHAPES)
def test_bn_train_kernels_at_task2_shapes(cuda, shape):
    """K3 and K3b in f32 at the task-2 ResNets' shapes, one launch each,
    against the plain versions at the bounds of the tests above, and
    bitwise repeatable."""
    x, w, b = _bn_inputs(cuda, shape, torch.float32, 13)
    n, nb = bn_act_train.launches, bn_act_train_backward.launches
    y, mean, var = bn_act_train(x, w, b, 1e-5, False)
    torch.cuda.synchronize()
    assert bn_act_train.launches == n + 1
    rm, rv = bn_stats_reference(x, False)
    assert bool(((mean - rm).abs() <= 1e-5 * x.abs().mean((0, 2, 3)) + 1e-7).all())
    assert bool(((var - rv).abs() <= 1e-5 * (x * x).mean((0, 2, 3)) + 1e-7).all())
    _close(y, bn_normalize_reference(x, mean, var, w, b, 1e-5, False), torch.float32)
    g = torch.Generator(device=cuda).manual_seed(17)
    gy = torch.randn(x.shape, generator=g, device=cuda).contiguous(
        memory_format=torch.channels_last)
    got = bn_act_train_backward(x, w, mean, var, gy, 1e-5, False)
    torch.cuda.synchronize()
    assert bn_act_train_backward.launches == nb + 1
    _bn_bwd_close(x, w, mean, var, gy, False, got)
    again = bn_act_train_backward(x, w, mean, var, gy, 1e-5, False)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert torch.equal(bn_act_train(x, w, b, 1e-5, False)[0], y)


# --- the tcct:: ops on the card ------------------------------------------------------


def _op_cases(dev, dtype):
    """(op, arguments) of every tcct:: op at a small shape on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(21)

    def rand(*shape, grad=False):
        return torch.randn(shape, generator=g, device=dev).to(dtype).requires_grad_(grad)

    ops = torch.ops.tcct
    w1 = rand(8) * 0.5 + 1
    cases = [(ops.metapool_tokens.default, (rand(2, 5, 8, grad=True),)),
             (ops.metapool_tokens_backward.default, (rand(2, 5, 8),)),
             (ops.metapool_block.default, (rand(2, 5, 8), w1, rand(8), w1, rand(8), 1e-6, True)),
             (ops.metapool_block.default, (rand(2, 5, 8), None, None, None, None, 1e-6, False)),
             (ops.metapool_block_shard.default, (rand(2, 6, 8), rand(2, 3, 8), rand(2, 3, 8),
                                                 True, False, w1, rand(8), w1, rand(8), 1e-6))]
    for s in (1, 2):
        x, w, b = rand(2, 5, 7, 8, grad=True), rand(3, 3, 8, grad=True), rand(8, grad=True)
        gy = rand(2, (5 - 1) // s + 1, (7 - 1) // s + 1, 8)
        cases += [(ops.dwconv3x3.default, (x, w, b, s, s == 1, 0)),
                  (ops.dwconv3x3_backward.default, (x.detach(), w.detach(), gy, s, True, s == 1,
                                                    True)),
                  (ops.dwconv3x3_backward.default, (x.detach(), w.detach(), gy, s, False, False,
                                                    False))]
    for leaky in (False, True):
        x = (rand(2, 8, 5, 6) * 2 + 0.5).contiguous(memory_format=torch.channels_last)
        w = (torch.rand(8, device=dev) + 0.5).requires_grad_()
        b = (torch.randn(8, device=dev) * 0.1).requires_grad_()
        mean, var = bn_stats_reference(x, leaky)
        gy = rand(2, 8, 5, 6).contiguous(memory_format=torch.channels_last)
        cases += [(ops.bn_act_train.default, (x.requires_grad_(), w, b, 1e-5, leaky)),
                  (ops.bn_act_train_backward.default, (x.detach(), w.detach(), mean, var, gy,
                                                       1e-5, leaky))]
        xd, wd, n = x.detach(), w.detach(), x.numel() // 8
        sums = bn_act_sums(xd, leaky)
        cases += [(ops.bn_act_sums.default, (xd, leaky)),
                  (ops.bn_act_normalize.default, (xd, sums, n, wd, b.detach(), 1e-5, leaky)),
                  (ops.bn_act_backward_sums.default, (xd, gy, leaky)),
                  (ops.bn_act_backward_dx.default, (xd, wd, mean, var, gy,
                                                    bn_act_backward_sums(xd, gy, leaky), n,
                                                    1e-5, leaky))]
    blk = seeded_cross_block(32, 32, 5, 22).to(dev, dtype).eval()
    pk = pack_cross_block(blk, dtype)
    cases.append((ops.fused_cross_block.default,
                  (rand(1, 6, 7, 32), pk.w, pk.vec, pk.wf, pk.cin, pk.cout, pk.k)))
    return cases


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_every_op_on_the_card(cuda, dtype):
    """``torch.library.opcheck`` of every tcct:: op on CUDA tensors: the
    fake implementation's shapes, types and strides (K3's channels_last y)
    against the kernels', the schema, the autograd registration and the
    AOT dispatch."""
    for op, args in _op_cases(cuda, dtype):
        res = torch.library.opcheck(op, args)
        assert set(res.values()) == {"SUCCESS"}, (op, res)


# --- the two-phase entry points of K3/K3b (data parallelism) ----------------------------

SPLIT_SHAPES = [(8, 32, 256, 256), (8, 64, 128, 128), (8, 160, 8, 8), (8, 1, 256, 256),
                (4, 5, 33, 17), (8, 2048, 7, 7)]


@pytest.mark.parametrize("leaky", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_bn_split_entry_points_are_the_one_launch_bitwise(cuda, shape, dtype, leaky):
    """At one rank: sums then normalize give K3's y, mean and var bit for
    bit; backward sums then dx give K3b's dx, and the weight gradients from
    the sums K3b's dweight and dbias; one launch each, counted."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.3).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    gy = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = (torch.rand(shape[1], generator=g, device=cuda) + 0.5).to(dtype)
    b = torch.randn(shape[1], generator=g, device=cuda).to(dtype)
    n = x.numel() // shape[1]
    y, mean, var = bn_act_train(x, w, b, 1e-5, leaky)
    dx, dw, db = bn_act_train_backward(x, w, mean, var, gy, 1e-5, leaky)
    counts = [f.launches for f in (bn_act_sums, bn_act_normalize, bn_act_backward_sums,
                                   bn_act_backward_dx)]
    sums = bn_act_sums(x, leaky)
    y2, mean2, var2 = bn_act_normalize(x, sums, n, w, b, 1e-5, leaky)
    gs = bn_act_backward_sums(x, gy, leaky)
    dx2 = bn_act_backward_dx(x, w, mean, var, gy, gs, n, 1e-5, leaky)
    torch.cuda.synchronize()
    assert [f.launches for f in (bn_act_sums, bn_act_normalize, bn_act_backward_sums,
                                 bn_act_backward_dx)] == [c + 1 for c in counts]
    for a, c in ((y, y2), (mean, mean2), (var, var2), (dx, dx2)):
        assert torch.equal(a, c)
    dw2, db2 = bn_weight_grads(gs, mean, var, 1e-5, w.dtype)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SPLIT_SHAPES[2:])
def test_bn_split_entry_points_match_plain(cuda, shape, dtype):
    """Against the plain versions on the same inputs: the sums within 1e-5
    of sum|t| (and of sum t^2, sum|gy|, sum|gy t|; f32 sums in another
    order); y within the kernels' TOL; dx within K3b's bound; and with a
    count larger than x's rows (another rank's rows in the sums) too."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = (torch.randn(shape, generator=g, device=cuda) + 0.5).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    gy = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = (torch.rand(shape[1], generator=g, device=cuda) + 0.5).to(dtype)
    b = torch.randn(shape[1], generator=g, device=cuda).to(dtype)
    t, gf = x.float(), gy.float()
    lim = 1e-5 * torch.stack([t.abs().sum((0, 2, 3)), (t * t).sum((0, 2, 3))]) + 1e-6
    assert ((bn_act_sums(x) - bn_sums_reference(x)).abs() <= lim).all()
    lim = 1e-5 * torch.stack([gf.abs().sum((0, 2, 3)), (gf * t).abs().sum((0, 2, 3))]) + 1e-6
    assert ((bn_act_backward_sums(x, gy) - bn_backward_sums_reference(x, gy)).abs() <= lim).all()
    n = 3 * x.numel() // shape[1]  # as if two more ranks held as many rows
    sums = bn_sums_reference(x) * 3
    y, mean, var = bn_act_normalize(x, sums, n, w, b)
    want_m, want_v = stats_from_sums(sums, n)
    atol, rtol = TOL[dtype]
    # the kernel divides by n; torch on the card multiplies by 1/n: an ulp or
    # two, and var = E[t^2] - mean^2 carries it as that many ulps of E[t^2]
    eps = 2.0 ** -23
    assert ((mean - want_m).abs() <= 4 * eps * want_m.abs()).all()
    assert ((var - want_v).abs() <= 8 * eps * (sums[1] / n)).all()
    torch.testing.assert_close(y, bn_normalize_reference(x, mean, var, w, b), atol=atol,
                               rtol=rtol)
    gs = bn_backward_sums_reference(x, gy) * 3
    from tcct_tpu_torch.ops.kernels.bnstats import _dx_from_sums

    dx = bn_act_backward_dx(x, w, mean, var, gy, gs, n)
    want = _dx_from_sums(x, w, mean, var, gy, gs, n, 1e-5, False)
    lim = bn_act_train_backward_tolerance(x, w, mean, var, gy)[0]
    assert ((dx.double() - want.double()).abs() <= lim).all()


def test_bn_split_autograd_on_card_is_the_one_launch(cuda):
    """``bn_act_train_split`` (what a data-parallel BatchNorm runs) without a
    reduction: outputs and gradients bitwise ``bn_act_train``'s, and
    captured in a CUDA graph its replay bitwise the eager call."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(4, 48, 32, 32, generator=g, device=cuda).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    w = (torch.rand(48, generator=g, device=cuda) + 0.5).requires_grad_()
    b = torch.randn(48, generator=g, device=cuda).requires_grad_()
    gy = torch.randn(4, 48, 32, 32, generator=g, device=cuda).to(torch.bfloat16)
    one = bn_act_train(x, w, b, 1e-5, True)
    two = bn_act_train_split(x, w, b, 1e-5, True)
    assert all(torch.equal(p, q) for p, q in zip(one, two))
    g1 = torch.autograd.grad(one[0], [x, w, b], gy)
    g2 = torch.autograd.grad(two[0], [x, w, b], gy)
    assert all(torch.equal(p, q) for p, q in zip(g1, g2))
    xs = x.detach()
    n = xs.numel() // 48

    def both():
        s = bn_act_sums(xs, True)
        return bn_act_normalize(xs, s, n, w.detach(), b.detach(), 1e-5, True)

    eager = both()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = both()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(eager, out))


def test_bn_split_entry_points_refuse(cuda):
    x = torch.randn(2, 4, 3, 3, device=cuda)
    w, b = torch.ones(4, device=cuda), torch.zeros(4, device=cuda)
    with pytest.raises(ValueError, match="want sums"):
        bn_act_normalize(x, torch.zeros(3, 4, device=cuda), 18, w, b)
    with pytest.raises(ValueError, match="fewer than"):
        bn_act_normalize(x, torch.zeros(2, 4, device=cuda), 5, w, b)
    with pytest.raises(ValueError, match="want gy like x"):
        bn_act_backward_sums(x, torch.zeros(2, 4, 3, 2, device=cuda))
