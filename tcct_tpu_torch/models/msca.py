"""MSCA, SegNeXt's multi-scale convolutional attention (JAX counterpart
``tcct_tpu/models/msca.py``; the reference carries it as dead code,
task1/onnx/tcct_goals.py:803-834).

A 5x5 depthwise context conv, three separable strip-conv pairs (1x7/7x1,
1x11/11x1, 1x21/21x1, depthwise) added to it, a 1x1 mixing conv, and the
result gating the input multiplicatively.  ``CrossResNet(msca=True)`` puts
one after every CrossCNN block (the ``msca`` model).  None of these convs
is a 3x3 depthwise: they run cuDNN.  The attribute names are the
reference's (``conv0_1`` ...), which the JAX package's names keep too.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from tcct_tpu_torch.models.layers import conv2d


class MSCA(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv0 = conv2d(dim, dim, 5, 1, 2, groups=dim)
        for i, k in enumerate((7, 11, 21)):
            setattr(self, f"conv{i}_1", conv2d(dim, dim, (1, k), 1, (0, k // 2), groups=dim))
            setattr(self, f"conv{i}_2", conv2d(dim, dim, (k, 1), 1, (k // 2, 0), groups=dim))
        self.conv3 = conv2d(dim, dim, 1, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = self.conv0(x)
        a0 = self.conv0_2(self.conv0_1(attn))
        a1 = self.conv1_2(self.conv1_1(attn))
        a2 = self.conv2_2(self.conv2_1(attn))
        return self.conv3(attn + a0 + a1 + a2) * x
