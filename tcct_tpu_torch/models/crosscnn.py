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
"""

from __future__ import annotations

import torch.nn as nn

from tcct_tpu_torch.models.layers import BatchNorm2d, conv2d, gelu
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
    """Parallel {3x3,3x3} + {1xk,kx1,3x3} paths (reference tcct.py:803-828)."""

    def __init__(self, cin, cout, ksize=9):
        super().__init__()
        k = ksize
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
    gives channels (32,)*5.  Returns the 5 pre-pool feature maps."""

    def __init__(self, tiny: bool = True, in_ch: int = 3):
        super().__init__()
        self.layer_dims = (32, 32, 32, 32, 32) if tiny else (32, 64, 96, 128, 256)
        dims = self.layer_dims
        self.cnn = nn.Sequential(conv2d(in_ch, dims[0], 3, 1, 1), BatchNorm2d(dims[0]))
        cins = (dims[0],) + dims[:-1]
        self.path_estan = nn.ModuleList(
            CrossCNNBlock(cins[i], dims[i], k) for i, k in enumerate((13, 11, 9, 7, 5))
        )

    def forward(self, x):
        x = self.cnn(x)
        xs = []
        for i, block in enumerate(self.path_estan):
            x = block(x)
            xs.append(x)
            if i < len(self.path_estan) - 1:
                x = max_pool_2d(x, 2)
        return xs
