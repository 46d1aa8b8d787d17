"""ReLayNet, the OCT-layer U-Net baseline (reference
task1/onnx/tcct_heg.py:29-151; JAX counterpart
``tcct_tpu/models/relaynet.py``).

7x3 conv + BatchNorm + PReLU blocks, 2x2 max pooling that keeps the
argmax position of each window as a one-hot mask, and max unpooling that
puts each value back at its position, with channel-concatenated skips;
the reference's ``eran``/``dran`` 1x1 heads form the polarization feats
(``norm_add``) for the feature-polarization loss.

As in the JAX package the pooling mask is f32 whatever the compute dtype,
so the unpooled maps, and the decoder after them, are f32 in a bf16 step
(the decoder's convs promote their bf16 weights, ``layers.promoted``) and
the logits are f32.  Input sides must be multiples of 8.

Under a width shard (``parallel/spatial.py::width_shard``) the 7x3 convs
take a one-column halo a side (``layers.Conv2d``), the pooling with masks
and the unpooling are local at the even offsets of every level, and so are
the skip concatenations, BN and PReLU; the logits come back, not the feats.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from tcct_tpu_torch.models.ftc import norm_add
from tcct_tpu_torch.models.layers import BatchNorm2d, conv2d
from tcct_tpu_torch.ops.resize import resize_bilinear


def max_pool_with_mask(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """2x2/2 max pool of NCHW ``x``: ``(pooled, mask)``, the mask f32 of
    x's shape, 1 at the first (row-major) maximum of each window, else 0.
    Ties share the pooled value's gradient equally, as the JAX package's
    ``jnp.max`` does."""
    B, C, H, W = x.shape
    win = x.reshape(B, C, H // 2, 2, W // 2, 2)
    pooled = torch.amax(win, dim=(3, 5))
    eq = (win == pooled[:, :, :, None, :, None]).permute(0, 1, 2, 4, 3, 5)
    flat = eq.reshape(B, C, H // 2, W // 2, 4)
    first = (torch.cumsum(flat.to(torch.int32), dim=-1) == 1) & flat
    mask = first.reshape(B, C, H // 2, W // 2, 2, 2).permute(0, 1, 2, 4, 3, 5)
    return pooled, mask.reshape(B, C, H, W).to(torch.float32)


def max_unpool(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Each pooled value of NCHW ``x`` put back at its window's mask
    position (zero elsewhere), in the promoted dtype of x and the mask.  The
    2x repeat is a broadcast, so its gradient is a sum over the window (no
    scatter, no float atomics)."""
    B, C, h, w = x.shape
    up = x[:, :, :, None, :, None].expand(B, C, h, 2, w, 2).reshape(B, C, 2 * h, 2 * w)
    return up * mask


class BasicBlock(nn.Module):
    """7x3 conv + BN + PReLU with one parameter (reference tcct_heg.py:29-59)."""

    def __init__(self, cin: int, filters: int = 64):
        super().__init__()
        self.conv = conv2d(cin, filters, (7, 3), 1, (3, 1))
        self.batchnorm = BatchNorm2d(filters)
        self.prelu = nn.PReLU(1, init=0.25)

    def forward(self, x):
        x = self.batchnorm(self.conv(x))
        return torch.where(x >= 0, x, self.prelu.weight * x)


class ReLayNet(nn.Module):
    """3-level encoder/decoder with unpooling skips (reference
    tcct_heg.py:94-148).  ``forward(x)``: NHWC image -> ``[logits]`` (one
    NHWC map); ``forward(x, with_feats=True)`` -> ``([logits], [feat])``."""

    feats_prefixes = ("eran", "dran")  # modules that only form the feats
    width_shard = None  # set by parallel.spatial.width_shard()

    def __init__(self, out_channels: int = 8, filters: int = 64, in_ch: int = 3):
        super().__init__()
        f = filters
        self.encode1 = BasicBlock(in_ch, f)
        self.encode2 = BasicBlock(f, f)
        self.encode3 = BasicBlock(f, f)
        self.bottleneck = BasicBlock(f, f)
        self.decode1 = BasicBlock(2 * f, f)
        self.decode2 = BasicBlock(2 * f, f)
        self.decode3 = BasicBlock(2 * f, f)
        self.classifier_conv = conv2d(f, out_channels, 1, 1, 0)
        for name in ("eran1", "eran2", "eran3", "dran1", "dran2", "dran3"):
            setattr(self, name, conv2d(f, 32, 1, 1, 0))

    def _pool(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.width_shard is not None:  # local at even offsets
            self.width_shard.require_even(x.shape[3], "a 2x2 max-pool")
        return max_pool_with_mask(x)

    def forward(self, x: torch.Tensor, with_feats: bool = False):
        if with_feats and self.width_shard is not None:
            raise NotImplementedError("ReLayNet: a width shard serves the logits only, not the "
                                      "polarization feats")
        x = x.permute(0, 3, 1, 2)
        out1 = self.encode1(x)
        e1, m1 = self._pool(out1)
        out2 = self.encode2(e1)
        e2, m2 = self._pool(out2)
        out3 = self.encode3(e2)
        e3, m3 = self._pool(out3)
        bn = self.bottleneck(e3)
        d3 = self.decode1(torch.cat([out3, max_unpool(bn, m3)], 1))
        d2 = self.decode2(torch.cat([out2, max_unpool(d3, m2)], 1))
        d1 = self.decode3(torch.cat([out1, max_unpool(d2, m1)], 1))
        outs = [self.classifier_conv(d1).permute(0, 2, 3, 1)]
        if not with_feats:
            return outs
        e1u = resize_bilinear(e1, x.shape[2:], align_corners=False)
        feat = norm_add([self.eran1(e1u), self.eran2(e2), self.eran3(e3),
                         self.dran1(d1), self.dran2(d2), self.dran3(d3)])
        return outs, [feat.permute(0, 2, 3, 1)]
