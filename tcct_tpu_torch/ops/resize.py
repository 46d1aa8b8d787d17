"""Bilinear resizing on NCHW tensors (torch ``interpolate`` semantics).

The serving path uses two flavours (reference task1/nets/tcct.py:890, 941):

- ``align_corners=True``  — decoder 2x upsampling (``MPUpBlock``);
- ``align_corners=False`` — aux-head upsampling to the input size.

The forward is ``F.interpolate``.  The backward is the adjoint of the
separable interpolation, ``dX = A_h^T · dY · A_w`` with the per-axis
interpolation matrices ``A_h [Ho, Hi]`` and ``A_w [Wo, Wi]``: two matrix
products in f32, in a fixed order, where ``F.interpolate``'s CUDA backward
adds with float atomics and does not repeat bit for bit.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable


def _linear_coeffs(in_size: int, out_size: int, align_corners: bool):
    """Source indices and weights of 1-D linear interpolation, as torch's
    ``area_pixel_compute_source_index`` forms them: endpoint-aligned, or
    half-pixel centres clamped at 0 (the JAX package's
    ``tcct_tpu/ops/resize.py::_linear_coeffs``)."""
    if out_size == in_size:
        idx = np.arange(in_size)
        return idx, idx, np.zeros(in_size, np.float32)
    i = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = np.zeros(1) if out_size == 1 else i * (in_size - 1) / (out_size - 1)
    else:
        src = np.maximum((i + 0.5) * in_size / out_size - 0.5, 0.0)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    return i0, i1, (src - i0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _matrix_np(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    i0, i1, w = _linear_coeffs(in_size, out_size, align_corners)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, i0), 1.0 - w)
    np.add.at(m, (rows, i1), w)
    return m


@functools.lru_cache(maxsize=None)
def interpolation_matrix(in_size: int, out_size: int, align_corners: bool,
                         device: torch.device) -> torch.Tensor:
    """The f32 ``[out, in]`` matrix of 1-D linear interpolation (two
    nonzeros a row), cached per size, ``align_corners`` and device."""
    return torch.from_numpy(_matrix_np(in_size, out_size, align_corners)).to(device)


def resize_bilinear_backward(gy: torch.Tensor, in_hw: Tuple[int, int], align_corners: bool,
                             channels_last: bool = False) -> torch.Tensor:
    """The adjoint of :func:`resize_bilinear` at an NCHW gradient ``gy``:
    ``A_h^T · gy · A_w`` in f32, rounded once to ``gy``'s dtype, in
    channels_last memory if asked.  An axis whose size does not change is
    the identity and is skipped."""
    (Hi, Wi), (Ho, Wo) = in_hw, gy.shape[2:]
    g = gy.float()
    if channels_last:  # contract on the [B, H, W, C] view
        g = g.permute(0, 2, 3, 1)
        if Wo != Wi:  # [Wi, Wo] @ [B, Ho, Wo, C]
            g = torch.matmul(interpolation_matrix(Wi, Wo, align_corners, g.device).T, g)
        if Ho != Hi:  # [Hi, Ho] @ [B, Ho, Wi * C]
            A = interpolation_matrix(Hi, Ho, align_corners, g.device)
            g = torch.matmul(A.T, g.reshape(g.shape[0], Ho, -1)).view(
                g.shape[0], Hi, Wi, g.shape[3])
        g = g.permute(0, 3, 1, 2)
    else:
        if Wo != Wi:  # [B, C, Ho, Wo] @ [Wo, Wi]
            g = torch.matmul(g, interpolation_matrix(Wi, Wo, align_corners, g.device))
        if Ho != Hi:  # [Hi, Ho] @ [B, C, Ho, Wi]
            g = torch.matmul(interpolation_matrix(Hi, Ho, align_corners, g.device).T, g)
    return g.to(gy.dtype)


class _ResizeBilinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size, align_corners):
        ctx.in_hw, ctx.align_corners = tuple(x.shape[2:]), align_corners
        ctx.channels_last = (not x.is_contiguous()
                             and x.is_contiguous(memory_format=torch.channels_last))
        return F.interpolate(x, size=size, mode="bilinear", align_corners=align_corners)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        return (resize_bilinear_backward(gy, ctx.in_hw, ctx.align_corners, ctx.channels_last),
                None, None)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``size=(H, W)``."""
    return _ResizeBilinear.apply(x, tuple(int(s) for s in size), bool(align_corners))
