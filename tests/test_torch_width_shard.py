"""The halo math of the width-sharded predictor, in one process on the CPU
(``tcct_tpu_torch/parallel/spatial.py`` and the operations it feeds).

For M in {2, 4} a seeded whole tensor (numpy) is cut into M width shards,
each with the halos an exchange would give it, cut by slicing
(``spatial.cut_halos``, the same assembly as the exchange's); each sharded
operation runs on every shard and the results, concatenated by columns, are
held to the operation on the whole tensor, f32:

- the stride-1 convs (``F.conv2d``: CrossCNN's 1x13 and 3x3, MSCA's 1x21
  depthwise and 5x5 depthwise; the depthwise kernel's plain version: K2 s1
  and the ConvPosEnc epilogue), the stride-2 dense 3x3 (the MPViT stem)
  and K2 s2 (the patch embeds): within 1e-5 (another width may sum in
  another order; on this CPU they are bitwise);
- 2x2 max-pooling and the MetaPool site's plain shard version
  (``metapool_block_shard``): bit for bit;
- the decoder's 2x bilinear upsampling with ``align_corners=True``: within
  2^-20 of the largest |x| (ATen's CPU kernel blends with four product
  weights, the shard version in its CUDA kernel's order).

Teeth, each missing its tolerance by far: zero halos for a conv, a site
shard without the row wrap, a site shard fed ``norm1(0)`` for its missing
tokens, a resize in local coordinates.  The reassembled site is also held
against the JAX package's ``metapool_tokens_pallas`` in interpret mode, and
the mesh's rank layout and width blocks against JAX's 2x4 mesh.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tcct_tpu_torch.models.layers import conv2d, init_weights
from tcct_tpu_torch.ops.kernels.dwconv import dwconv3x3_reference
from tcct_tpu_torch.ops.kernels.metapool import (
    metapool_block_reference,
    metapool_block_shard,
    metapool_block_shard_reference,
)
from tcct_tpu_torch.models.crosscnn import (
    cross_block_halo,
    fused_cross_block_shard,
    seeded_cross_block,
)
from tcct_tpu_torch.ops.kernels.crosscnn_fused import fused_cross_block
from tcct_tpu_torch.ops.pool import max_pool_2d, metapool_spatial, metapool_spatial_shard
from tcct_tpu_torch.ops.resize import upsample2x_aligned_shard
from tcct_tpu_torch.parallel.mesh import DataMesh, shard_batch
from tcct_tpu_torch.parallel.spatial import WidthShard, assemble_halos, cut_halos, width_blocks

RANKS = (2, 4)


def image(B, C, H, W, seed=0) -> torch.Tensor:
    """Seeded NCHW f32 in channels_last memory."""
    a = np.random.default_rng(seed).standard_normal((B, C, H, W)).astype(np.float32)
    return torch.from_numpy(a).contiguous(memory_format=torch.channels_last)


def seeded_conv(cin, cout, k, stride, pad, groups, seed=1):
    c = conv2d(cin, cout, k, stride, pad, groups=groups)
    init_weights(c, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        c.bias.copy_(torch.from_numpy(
            np.random.default_rng(seed).standard_normal(cout).astype(np.float32)))
    return c


def even(W, M):
    """M equal blocks of W columns."""
    return (W // M,) * M


def sharded_conv(conv, x, M, residual=False, zero_halos=False, blocks=None):
    """The conv's shards, each from its halos, concatenated by columns;
    ``blocks``: the ranks' input columns of which ``x`` is a level (default:
    M equal blocks of ``x``'s)."""
    blocks = blocks or even(x.shape[3], M)
    outs = []
    for m in range(M):
        conv.width_shard = WidthShard(m, blocks)
        left, right = conv.halo_columns(x)
        widths = conv.width_shard.widths(blocks[m] * x.shape[3] // sum(blocks))
        xs, lh, rh = cut_halos(x.permute(0, 2, 3, 1), m, widths, left, right)
        if zero_halos:
            lh, rh = torch.zeros_like(lh), torch.zeros_like(rh)
        outs.append(conv.conv_with_halos(xs.permute(0, 3, 1, 2), lh, rh, residual))
    conv.width_shard = None
    return torch.cat(outs, 3)


# (name, cin, cout, kernel, stride, padding, groups): the convs a shard runs
CONVS = [
    ("crosscnn 1x13", 8, 8, (1, 13), 1, (0, 6), 1),
    ("crosscnn 13x1", 8, 8, (13, 1), 1, (6, 0), 1),
    ("dense 3x3", 8, 16, 3, 1, 1, 1),
    ("mpvit stem 3x3 s2", 3, 8, 3, 2, 1, 1),
    ("K2 s1", 8, 8, 3, 1, 1, 8),
    ("K2 s2", 8, 8, 3, 2, 1, 8),
    ("msca 1x21 depthwise", 8, 8, (1, 21), 1, (0, 10), 8),
    ("msca 5x5 depthwise", 8, 8, 5, 1, 2, 8),
]


@pytest.mark.parametrize("M", RANKS)
@pytest.mark.parametrize("case", CONVS, ids=[c[0] for c in CONVS])
@torch.no_grad()
def test_conv_shards_reassemble(case, M):
    _, cin, cout, k, s, p, g = case
    conv = seeded_conv(cin, cout, k, s, p, g)
    x = image(2, cin, 6, 48)
    got, want = sharded_conv(conv, x, M), conv(x)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    if conv.kernel_size[1] > 1:  # teeth: zero halos miss at every shard boundary
        bad = sharded_conv(conv, x, M, zero_halos=True)
        assert float((bad - want).abs().max()) > 1e-2


@pytest.mark.parametrize("width", [96, 12])
@pytest.mark.parametrize("case", CONVS, ids=[c[0] for c in CONVS])
@torch.no_grad()
def test_conv_shards_reassemble_at_uneven_blocks(case, width):
    """The same convs on the blocks of a 96-column input over 4 ranks (32,
    32, 16, 16), at the input and at its 1/8 level (4, 4, 2, 2 columns: the
    1x13's and 1x21's halos reach past two and three ranks)."""
    _, cin, cout, k, s, p, g = case
    conv = seeded_conv(cin, cout, k, s, p, g)
    x = image(2, cin, 6, width, seed=12)
    got = sharded_conv(conv, x, 4, blocks=width_blocks(96, 4))
    torch.testing.assert_close(got, conv(x), atol=1e-5, rtol=0)


@pytest.mark.parametrize("M", RANKS)
@torch.no_grad()
def test_convposenc_epilogue_shards_reassemble(M):
    """K2 s1 with the ConvPosEnc epilogue, ``conv(x) + bias + x`` in the
    depthwise kernel's plain version, on the widened shard: the whole
    tensor's ``plus_input``."""
    conv = seeded_conv(8, 8, 3, 1, 1, 8)
    x = image(2, 8, 5, 32, seed=3)
    torch.testing.assert_close(sharded_conv(conv, x, M, residual=True), conv.plus_input(x),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("M", RANKS)
def test_k2_s2_keeps_the_global_output_grid(M):
    """The depthwise kernel's stride-2 plain version on a shard fed two left
    halo columns: the whole image's output columns, bit for bit; fed one
    (an odd grid), it misses."""
    x = image(1, 8, 6, 32, seed=4)
    w = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 3, 8)).astype(np.float32))
    xn = x.permute(0, 2, 3, 1)
    want = dwconv3x3_reference(xn, w, 2)
    outs, odd = [], []
    for m in range(M):
        xs, lh, _ = cut_halos(xn, m, even(32, M), 2, 0)
        outs.append(dwconv3x3_reference(torch.cat([lh, xs], 2), w, 2)[:, :, 1:])
        odd.append(dwconv3x3_reference(torch.cat([lh[:, :, 1:], xs], 2), w, 2)[:, :, :-1])
    assert torch.equal(torch.cat(outs, 2), want)
    assert float((torch.cat(odd, 2) - want).abs().max()) > 1e-2


def test_msca_strip_halo_reaches_past_a_rank():
    """``msca``'s 1x21 strip conv needs 10 columns from each side: on 9
    columns a rank (duke's deepest CNN level over 4 ranks) each halo is cut
    from two ranks, and the shards reassemble the whole conv."""
    conv = seeded_conv(8, 8, (1, 21), 1, (0, 10), 8)
    x = image(1, 8, 4, 36, seed=11)
    with torch.no_grad():
        torch.testing.assert_close(sharded_conv(conv, x, 4), conv(x), atol=1e-5, rtol=0)


def test_stride2_refuses_an_odd_offset():
    conv = seeded_conv(3, 8, 3, 2, 1, 1)
    conv.width_shard = WidthShard(1, (7, 7))
    x = image(1, 3, 4, 7)
    with pytest.raises(ValueError, match="odd offset"):
        conv.conv_with_halos(x, x.permute(0, 2, 3, 1)[:, :, :1], x.permute(0, 2, 3, 1)[:, :, :0])


@pytest.mark.parametrize("M", RANKS)
def test_max_pool_is_local_at_even_offsets(M):
    x = image(2, 4, 8, 32, seed=6)
    got = torch.cat([max_pool_2d(p, 2) for p in torch.chunk(x, M, 3)], 3)
    assert torch.equal(got, max_pool_2d(x, 2))


def _resize_shards(x, M, local=False):
    outs = []
    for m in range(M):
        xs, lh, rh = cut_halos(x.permute(0, 2, 3, 1), m, even(x.shape[3], M), 1, 1)
        xs = xs.permute(0, 3, 1, 2)
        if local:
            outs.append(F.interpolate(xs, scale_factor=2, mode="bilinear", align_corners=True))
        else:
            outs.append(upsample2x_aligned_shard(xs, lh, rh, m * xs.shape[3], x.shape[3]))
    return torch.cat(outs, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", RANKS)
def test_aligned_upsampling_shards_reassemble(M, dtype):
    """MPUpBlock's 2x bilinear upsampling (align_corners=True) from global
    coordinates: within 2^-20 of max|x| of F.interpolate on the whole image
    in f32, and in bf16 within one bf16 step (the same f32 value rounded)
    on at most a few elements; in local coordinates every shard boundary
    moves."""
    x = image(2, 5, 8, 72, seed=7).to(dtype)
    want = F.interpolate(x, size=(16, 144), mode="bilinear", align_corners=True)
    got = _resize_shards(x, M)
    assert got.shape == want.shape and got.dtype == dtype
    d = (got.float() - want.float()).abs()
    scale = float(x.float().abs().max())
    if dtype == torch.float32:
        assert float(d.max()) <= 2.0 ** -20 * scale
    else:
        assert float(d.max()) <= 2.0 ** -7 * scale and int((d > 0).sum()) <= 4
    bad = _resize_shards(x, M, local=True)
    assert float((bad.float() - want.float()).abs().max()) > 0.1 * scale


# --- the MetaPool site on a shard -----------------------------------------------------


def site_inputs(B, H, W, C, seed=8):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((B, H, W, C)) * 2 + 0.5).astype(np.float32))
    w1, w2 = (torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)) for _ in range(2))
    b1, b2 = (torch.from_numpy(rng.normal(size=C).astype(np.float32) * 0.5) for _ in range(2))
    return x, (w1, b1, w2, b2)


def sharded_site(x, M, affine, wrap=True, norm_of_zero=False):
    """Every shard's site, reassembled to [B, H*W, C] tokens (y, n2)."""
    B, H, _, C = x.shape
    ys, ns = [], []
    for m in range(M):
        xs, lh, rh = cut_halos(x, m, even(x.shape[2], M), 1, 1, wrap=wrap)
        first, last = m == 0, m == M - 1
        if norm_of_zero:  # the missing tokens passed as zero rows, normalised as tokens
            first = last = False
        y, n2 = metapool_block_shard(xs.reshape(B, -1, C), lh[:, :, 0], rh[:, :, 0], first, last,
                                     *affine)
        ys.append(y.reshape(B, H, -1, C))
        ns.append(n2.reshape(B, H, -1, C))
    return tuple(torch.cat(t, 2).reshape(B, -1, C) for t in (ys, ns))


@pytest.mark.parametrize("M", RANKS)
@pytest.mark.parametrize("shape", [(2, 5, 16, 24), (1, 3, 8, 5), (2, 1, 8, 1)])
def test_site_shards_reassemble_bitwise(shape, M):
    """The shard site's plain version (LayerNorm1 of tokens and halos, the
    wrapped window, the whole grid's counts, residual, LayerNorm2): the
    whole grid's ``metapool_block_reference`` bit for bit, y and n2."""
    x, affine = site_inputs(*shape)
    B, H, W, C = shape
    got = sharded_site(x, M, affine)
    want = metapool_block_reference(x.reshape(B, -1, C), *affine)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("M", RANKS)
def test_site_teeth(M):
    """Without the row wrap (each row's ends as the sequence's ends), or with
    norm1(0) (the bias) for the missing tokens, the site misses by far."""
    x, affine = site_inputs(2, 5, 16, 24)
    want = metapool_block_reference(x.reshape(2, -1, 24), *affine)
    for kw in ({"wrap": False}, {"norm_of_zero": True}):
        got = sharded_site(x, M, affine, **kw)
        assert float((got[0] - want[0]).abs().max()) > 1e-2, kw


@pytest.mark.parametrize("M", RANKS)
def test_site_shards_match_jax_pallas_metapool(M):
    """The reassembled site's y against ``x + metapool(norm1(x))`` with the
    JAX package's Pallas MetaPool in interpret mode on the whole grid's
    normalised tokens."""
    from tcct_tpu.ops.pallas import metapool_tokens_pallas

    x, affine = site_inputs(2, 6, 16, 32, seed=9)
    tokens = x.reshape(2, -1, 32)
    got = sharded_site(x, M, affine)[0]
    n1 = F.layer_norm(tokens, (32,), affine[0], affine[1], 1e-6)
    want = tokens.numpy() + np.asarray(metapool_tokens_pallas(n1.numpy(), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_site_shard_refuses_bad_halos_and_opchecks():
    x, affine = site_inputs(2, 3, 8, 16)
    t = x.reshape(2, -1, 16)
    with pytest.raises(ValueError, match="do not fit"):
        metapool_block_shard(t, torch.zeros(2, 5, 16), torch.zeros(2, 5, 16), True, True, *affine)
    with pytest.raises(ValueError, match="LayerNorm weights must be"):
        metapool_block_shard(t, x[:, :, 0], x[:, :, 0], True, True, affine[0][:8], *affine[1:])
    op = torch.ops.tcct.metapool_block_shard.default
    for args in ((t, x[:, :, 0], x[:, :, -1], True, False, *affine, 1e-6),
                 (t, x[:, :, 0], x[:, :, -1], False, True, *affine, 1e-5)):
        res = torch.library.opcheck(op, args)
        assert set(res.values()) == {"SUCCESS"}, res
    # the op's CPU implementation is the plain version
    args = (t, x[:, :, 0], x[:, :, -1], True, True, *affine)
    for a, b in zip(metapool_block_shard(*args), metapool_block_shard_reference(*args)):
        assert torch.equal(a, b)


# --- the exchange's assembly and the mesh --------------------------------------------


def test_halos_wrap_rows_and_refuse_to_reach_past_a_neighbour():
    """The wrapped halos are the whole grid's flat-order neighbours of each
    row's ends and refuse to reach past the neighbour's one column; an
    unwrapped halo wider than a rank's columns takes the ranks beyond it."""
    B, H, W, C, M = 1, 3, 8, 2, 4
    x = torch.arange(B * H * W * C, dtype=torch.float32).reshape(B, H, W, C)
    flat = x.reshape(B, H * W, C)
    w = W // M
    for m in range(M):
        _, lh, rh = cut_halos(x, m, even(W, M), 1, 1, wrap=True)
        for h in range(H):
            i0, i1 = h * W + m * w, h * W + m * w + w - 1  # the row's ends, flat
            want_l = flat[:, i0 - 1] if i0 > 0 else torch.zeros(B, C)
            want_r = flat[:, i1 + 1] if i1 + 1 < H * W else torch.zeros(B, C)
            assert torch.equal(lh[:, h, 0], want_l) and torch.equal(rh[:, h, 0], want_r)
    # a halo wider than a rank's 2 columns reaches the rank beyond; a wrapped one refuses
    xp = torch.nn.functional.pad(x, (0, 0, 3, 3))  # 3 zero columns beyond each edge
    for m in range(M):
        _, lh, rh = cut_halos(x, m, even(W, M), 3, 3)
        assert torch.equal(lh, xp[:, :, m * w:m * w + 3])
        assert torch.equal(rh, xp[:, :, m * w + w + 3:m * w + w + 6])
    with pytest.raises(ValueError, match="one column a side"):
        cut_halos(x, 0, even(W, M), 3, 3, wrap=True)
    edges = [torch.zeros(1, 2, 2, 1)] * 2
    lh, rh = assemble_halos(edges, 0, (1, 1), 1, 1)
    assert lh.shape == rh.shape == (1, 2, 1, 1)


def test_mesh_layout_is_jax_data_major_and_shards_the_width():
    """Rank d*M + m of a (2, 4) mesh holds the rows and the width block that
    the JAX package's ``shard_batch`` puts on device (d, m) of its
    ``make_mesh(8, ('data', 'model'), shape=(2, 4))`` (8 virtual CPU
    devices)."""
    from tcct_tpu.parallel import make_mesh as jax_make_mesh
    from tcct_tpu.parallel import shard_batch as jax_shard_batch

    jmesh = jax_make_mesh(8, ("data", "model"), shape=(2, 4))
    arr = jax_shard_batch(jmesh, np.zeros((4, 2, 64, 3), np.uint8))
    by_device = {s.device: s.index for s in arr.addressable_shards}
    x = torch.arange(4 * 2 * 64 * 3).reshape(4, 2, 64, 3)
    for r, dev in enumerate(jmesh.devices.flat):
        mesh = DataMesh(("data", "model"), {"data": 2, "model": 4}, 8, r, None,
                        torch.device("cpu"), "gloo", 4)
        idx = by_device[dev]
        assert (mesh.data_rank, mesh.model_rank) == (r // 4, r % 4)
        assert torch.equal(shard_batch(mesh, x), x[idx[0], :, idx[2]])
        assert torch.equal(shard_batch(mesh, x[:, 0, 0]), x[idx[0], 0, 0])  # 2-D: rows only


# --- the uneven layout and halos across ranks ------------------------------------------


def test_width_blocks_split_whole_units():
    """Whole 16-column units, the first ranks one more; JAX's divisibility
    rule, a width not of whole units and a rank with no columns raise."""
    assert width_blocks(96, 4) == (32, 32, 16, 16)
    assert width_blocks(672, 4) == (176, 176, 160, 160)
    assert width_blocks(576, 8) == (80,) * 4 + (64,) * 4
    assert width_blocks(256, 4) == (64,) * 4
    with pytest.raises(ValueError, match="divisible by the size of its mesh axis"):
        width_blocks(512, 3)
    with pytest.raises(ValueError, match="a rank would hold no columns"):
        width_blocks(48, 4)
    with pytest.raises(ValueError, match="not a multiple of 16"):
        width_blocks(100, 4)


@pytest.mark.parametrize("W,M", [(96, 4), (672, 4), (576, 8), (576, 4), (144, 6)])
def test_uneven_layout_offsets_at_every_level(W, M):
    """At every level 1/s of the input (s = 1 .. 16) each rank's offset and
    the global width are the whole image's: the blocks tile the level, and
    before each 2x2 pool or stride-2 conv (s <= 8) every offset and width is
    even; a 2x2 pool of the blocks is the whole level's pool."""
    blocks = width_blocks(W, M)
    for s in (1, 2, 4, 8, 16):
        ends = 0
        for r in range(M):
            shard = WidthShard(r, blocks)
            w = blocks[r] // s
            assert shard.level(w) == (ends, W // s)
            assert shard.widths(w) == tuple(b // s for b in blocks)
            if s <= 8:
                shard.require_even(w, "a 2x2 max-pool")
            ends += w
        assert ends == W // s
    with pytest.raises(ValueError, match="no level of the blocks"):
        WidthShard(0, blocks).level(blocks[0] // 3)
    x = image(1, 2, 4, W // 8, seed=13)
    parts = torch.split(x, [b // 8 for b in blocks], 3)
    got = torch.cat([max_pool_2d(t, 2) for t in parts], 3)
    assert torch.equal(got, max_pool_2d(x, 2))


@pytest.mark.parametrize("clip", [False, True])
def test_halos_reach_two_and_three_ranks(clip):
    """Blocks of 2, 1, 1, 2 columns and 4-column halos: each halo is the
    whole tensor's columns beside the block, from as many ranks as it
    reaches, zeros past the edges (or, clipped, only the columns there)."""
    widths = (2, 1, 1, 2)
    x = torch.arange(1 * 2 * 6 * 3, dtype=torch.float32).reshape(1, 2, 6, 3)
    xp = torch.nn.functional.pad(x, (0, 0, 4, 4))
    start = 0
    for m, w in enumerate(widths):
        xs, lh, rh = cut_halos(x, m, widths, 4, 4, clip=clip)
        assert torch.equal(xs, x[:, :, start:start + w])
        lo, hi = start + 4 - 4, start + w + 4  # in xp's columns
        want_l, want_r = xp[:, :, lo:start + 4], xp[:, :, start + w + 4:hi + 4]
        if clip:
            want_l, want_r = want_l[:, :, 4 - min(4, start):], want_r[:, :, :min(4, 6 - start - w)]
        assert torch.equal(lh, want_l) and torch.equal(rh, want_r), m
        start += w


@pytest.mark.parametrize("widths", [(32, 32, 16, 16), (4, 4, 2, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_metapool2d_shards_reassemble_bitwise(dtype, widths):
    """The spatial MetaPool on a shard (one halo column a side, zeros at the
    edges, the whole grid's counts at the shard's columns): the whole grid's
    ``metapool_spatial`` bit for bit, f32 and bf16, at even and uneven
    blocks (a 96-column grid's, and its 1/8 level's); teeth: the shard's own
    counts (2 at its ends) miss."""
    B, Hh, C, W = 2, 5, 6, sum(widths)
    x = torch.from_numpy(np.random.default_rng(14).standard_normal((B, Hh, W, C))
                         .astype(np.float32)).to(dtype)
    want = metapool_spatial(x.reshape(B, -1, C), (Hh, W))
    outs, bad, off = [], [], 0
    for m, w in enumerate(widths):
        xs, lh, rh = cut_halos(x, m, widths, 1, 1)
        t = xs.reshape(B, -1, C)
        outs.append(metapool_spatial_shard(t, (Hh, w), lh, rh, off, W).reshape(B, Hh, w, C))
        bad.append(metapool_spatial_shard(t, (Hh, w), lh, rh, 0, w).reshape(B, Hh, w, C))
        off += w
    assert torch.equal(torch.cat(outs, 2).reshape(B, -1, C), want)
    assert float((torch.cat(bad, 2).reshape(B, -1, C) - want).float().abs().max()) > 1e-2


@pytest.mark.parametrize("widths", [(16, 16, 8, 8), (4, 4, 2, 2)])
@torch.no_grad()
def test_k4_on_haloed_shards_matches_the_whole_map(widths):
    """K4's plain version (the CPU op) on each block widened by ``k // 2 + 2``
    halo columns a side, none past the image's edges (``clip``), cropped:
    the whole map's columns (within 1e-5: another width may sum in another
    order).  At (4, 4, 2, 2) the 4-column halos reach past two ranks and the
    third rank's right halo stops at the edge.  Teeth: zero halo columns at
    the edges, as an input, carry bias, BN shift and GELU values into the
    edge columns and miss by far."""
    k = 5
    h = cross_block_halo(k)
    blk = seeded_cross_block(8, 16, k, seed=15)
    x = image(2, 8, 6, sum(widths), seed=16).permute(0, 2, 3, 1).contiguous()
    want = fused_cross_block(x, blk)
    for clip in (True, False):
        outs = []
        for m in range(4):
            xs, lh, rh = cut_halos(x, m, widths, h, h, clip=clip)
            outs.append(fused_cross_block_shard(xs, blk, lh, rh))
        got = torch.cat(outs, 2)
        assert got.shape == want.shape
        if clip:
            torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        else:
            err = (got - want).abs().amax(dim=(0, 1, 3))
            assert float(err[0]) > 1e-2 and float(err[-1]) > 1e-2
            assert float(err[h:-h].max()) <= 1e-5  # only the edge columns' fields
