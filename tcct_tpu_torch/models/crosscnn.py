"""Cross-convolution CNN branch (reference task1/nets/tcct.py:803-885;
JAX counterpart ``tcct_tpu/models/crosscnn.py``).

Each block runs two parallel paths — {3x3, 3x3} and {1xk -> kx1 -> 3x3} —
fused by GELU, then a 3x3 head; kernel sizes shrink per level
(13, 11, 9, 7, 5) with 2x2 max-pooling between levels.  The reference's
order inside each Sequential is LeakyReLU *then* BatchNorm, kept here;
the Sequential indices (with gaps where the activation has no
parameters) match its state-dict names.  The LeakyReLU runs inside the
BatchNorm (``leaky=True``), so in train mode the two are one fused
kernel (``ops/kernels/bnstats.py``).

These are dense convs (no depthwise 3x3), so they run ``F.conv2d``.  The
JAX package's space-to-depth packing of this branch
(``tcct_tpu/ops/packed_conv.py``) exists for the TPU's lane width and is
an exact rewrite of this plain form; it is not reproduced.

:func:`cross_resnet_fused` (eval mode only) is the same pyramid with every
block as one launch of the fused block kernel
(``ops/kernels/crosscnn_fused.py``); the FTC models take its maps through
``cnn_feats=``, on a width shard too (:func:`fused_cross_block_shard`).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from tcct_tpu_torch.models.layers import BatchNorm2d, conv2d, gelu, init_weights
from tcct_tpu_torch.models.msca import MSCA
from tcct_tpu_torch.ops.kernels.crosscnn_fused import fold_bn, fused_cross_block
from tcct_tpu_torch.ops.pool import max_pool_2d


def _lrelu():
    return nn.LeakyReLU(0.01)


def _convs_act_bn(seq: nn.Sequential, x):
    """Run a ``Sequential(conv..., LeakyReLU, BatchNorm2d)``: the convs,
    then the LeakyReLU and the BN as one ``leaky=True`` BN call."""
    *convs, _act, bn = seq
    for conv in convs:
        x = conv(x)
    return bn(x, leaky=True)


class CrossCNNBlock(nn.Module):
    """Parallel {3x3,3x3} + {1xk,kx1,3x3} paths (reference tcct.py:803-828).
    ``plain=True`` forces k = 3 (the PlainCNNBlock ablation, tcct.py:830-855)."""

    def __init__(self, cin, cout, ksize=9, plain: bool = False):
        super().__init__()
        k = 3 if plain else ksize
        self.block12 = nn.Sequential(
            conv2d(cin, cout, 3, 1, 1), conv2d(cout, cout, 3, 1, 1), _lrelu(), BatchNorm2d(cout)
        )
        self.block34 = nn.Sequential(
            conv2d(cin, cout, (1, k), 1, (0, k // 2)),
            conv2d(cout, cout, (k, 1), 1, (k // 2, 0)),
            conv2d(cout, cout, 3, 1, 1),
            _lrelu(),
            BatchNorm2d(cout),
        )
        self.block5 = nn.Sequential(conv2d(cout, cout, 3, 1, 1), _lrelu(), BatchNorm2d(cout))

    def forward(self, x):
        a = _convs_act_bn(self.block12, x)
        b = _convs_act_bn(self.block34, x)
        return _convs_act_bn(self.block5, gelu(a + b))


class CrossResNet(nn.Module):
    """5-level cross-conv pyramid (reference tcct.py:857-885).  ``tiny``
    gives channels (32,)*5, else (32, 64, 96, 128, 256); ``plain`` gives
    every block k = 3; ``msca`` adds an MSCA attention ``att.i`` after
    block i (the ``msca`` model).  Returns the 5 pre-pool feature maps
    (NCHW).  Under a width shard the 2x2 max-pools are local: the rank's
    offset is even at every pooled level."""

    width_shard = None  # set by parallel.spatial.width_shard()

    def __init__(self, tiny: bool = True, in_ch: int = 3, plain: bool = False,
                 msca: bool = False):
        super().__init__()
        self.layer_dims = (32, 32, 32, 32, 32) if tiny else (32, 64, 96, 128, 256)
        self.msca = msca
        dims = self.layer_dims
        self.cnn = nn.Sequential(conv2d(in_ch, dims[0], 3, 1, 1), BatchNorm2d(dims[0]))
        cins = (dims[0],) + dims[:-1]
        self.path_estan = nn.ModuleList(
            CrossCNNBlock(cins[i], dims[i], k, plain=plain)
            for i, k in enumerate((13, 11, 9, 7, 5))
        )
        if msca:  # the MSCA attention after every block
            self.att = nn.ModuleList(MSCA(d) for d in dims)

    def forward(self, x):
        x = self.cnn(x)
        xs = []
        for i, block in enumerate(self.path_estan):
            x = block(x)
            if self.msca:
                x = self.att[i](x)
            xs.append(x)
            if i < len(self.path_estan) - 1:
                if self.width_shard is not None:  # local at even offsets
                    self.width_shard.require_even(x.shape[3], "a 2x2 max-pool")
                x = max_pool_2d(x, 2)
        return xs


def cross_block_halo(k: int) -> int:
    """Columns a ``CrossCNNBlock`` of kernel size ``k`` reads beyond each
    side of an output column (its receptive radius in width): block34's
    1xk, kx1 and 3x3 read ``k // 2 + 1``, block12's two 3x3s 2, and block5's
    3x3 adds 1 to the larger (``attic/crosscnn_fused.py::_halo``)."""
    return k // 2 + 2


def fused_cross_block_shard(x: torch.Tensor, block, lh: torch.Tensor,
                            rh: torch.Tensor) -> torch.Tensor:
    """:func:`fused_cross_block` at a width shard's columns: NHWC ``x``
    [B, H, w, Cin] widened by the halo columns ``lh`` and ``rh`` (up to
    :func:`cross_block_halo` each, none on a side that is the image's
    edge), one launch on [B, H, hl + w + hr, Cin], the output cropped to the
    shard's ``w`` columns.  An interior side's cropped columns are those
    whose receptive field the widened input cuts; at the image's edge the
    kernel's own zero padding of each conv's input is the whole image's."""
    hl, w = lh.shape[2], x.shape[2]
    y = fused_cross_block(torch.cat([lh, x, rh], dim=2), block)
    return y[:, :, hl:hl + w].contiguous()


def cross_resnet_fused(x: torch.Tensor, base_cnn: CrossResNet) -> List[torch.Tensor]:
    """The eval ``CrossResNet`` forward with every block through
    :func:`fused_cross_block` (JAX counterpart
    ``attic/crosscnn_fused.py::cross_resnet_fused``): NHWC image ``x``
    [B,H,W,3] -> the five pre-pool NHWC feature maps.  The stem conv stays
    ``F.conv2d``, its BatchNorm folded to an f32 ``(scale, shift)``; 2x2
    max-pooling runs between the blocks.

    Under a width shard (``base_cnn.width_shard``) ``x`` is the rank's
    block of the columns: the stem conv exchanges its one-column halos,
    each block one exchange of :func:`cross_block_halo` columns a side,
    clipped at the image's edges (:func:`fused_cross_block_shard`), and the
    pools are local."""
    if base_cnn.training:
        raise ValueError("cross_resnet_fused: inference only; the CNN branch is in train mode")
    if getattr(base_cnn, "msca", False):
        raise ValueError("cross_resnet_fused: the MSCA option is not part of the fused block")
    shard = base_cnn.width_shard
    stem, bn = base_cnn.cnn
    y = stem(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    s, t = fold_bn(bn)
    y = (y.float() * s + t).to(x.dtype).contiguous()
    xs = []
    last = len(base_cnn.path_estan) - 1
    for i, block in enumerate(base_cnn.path_estan):
        if shard is None:
            y = fused_cross_block(y, block)
        else:
            h = cross_block_halo(block.block34[0].kernel_size[1])
            y = fused_cross_block_shard(y, block, *shard.halos(y, h, h, clip=True))
        xs.append(y)
        if i < last:
            if shard is not None:  # local at even offsets
                shard.require_even(y.shape[2], "a 2x2 max-pool")
            y = max_pool_2d(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).contiguous()
    return xs


def seeded_cross_block(cin, cout, k, seed, plain=False) -> CrossCNNBlock:
    """An eval-mode ``CrossCNNBlock`` in which every operand of the fused
    kernel matters: seeded He-normal weights, random conv biases, and random
    positive BatchNorm affines and statistics (normal^2 + 0.5, as
    attic/test_fused_crosscnn.py draws its statistics).  What the kernel is
    held against its plain version on."""
    blk = CrossCNNBlock(cin, cout, k, plain=plain)
    g = torch.Generator().manual_seed(seed)
    init_weights(blk, g)
    with torch.no_grad():
        for m in blk.modules():
            if isinstance(m, nn.Conv2d):
                m.bias.copy_(torch.randn(cout, generator=g) * 0.1)
            elif isinstance(m, nn.BatchNorm2d):
                for t in (m.weight, m.bias, m.running_mean, m.running_var):
                    t.copy_(torch.randn(cout, generator=g) ** 2 + 0.5)
    return blk.eval()
