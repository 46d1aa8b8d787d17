"""Resizing on NCHW tensors (torch ``interpolate`` semantics; JAX
counterpart ``tcct_tpu/ops/resize.py``).

The models use three flavours (reference task1/nets/tcct.py:890, 941, 926):

- bilinear ``align_corners=True``  — decoder 2x upsampling (``MPUpBlock``;
  on a width shard :func:`upsample2x_aligned_shard`);
- bilinear ``align_corners=False`` — aux-head upsampling to the input size;
- bicubic ``align_corners=False`` — the gated fusion's random alpha map
  (:func:`resize_bicubic`, forward only: the map carries no gradient).

:func:`resize_nearest` is the nearest-neighbour sampling of the datasets'
geometry prep (``data/eyeset.py``).

The forward is ``F.interpolate``.  The backward is the adjoint of the
separable interpolation, ``dX = A_h^T · dY · A_w`` with the per-axis
interpolation matrices ``A_h [Ho, Hi]`` and ``A_w [Wo, Wi]``: two matrix
products in f32, in a fixed order, where ``F.interpolate``'s CUDA backward
adds with float atomics and does not repeat bit for bit.

The bicubic resize is the same separable form in the forward,
``A_h · x · A_w^T`` with the cubic-convolution matrices (Keys, a = -0.75,
taps clamped to the edge), in f32.
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


@functools.lru_cache(maxsize=None)
def _aligned_taps(in_size: int, out_size: int, start: int, count: int, device: torch.device):
    """ATen's ``upsample_bilinear2d`` source taps of outputs ``start`` ..
    ``start + count - 1`` with ``align_corners=True``, in its float32
    arithmetic: ``scale = (in - 1) / (out - 1)``, ``src = scale * dst``,
    ``i0 = floor(src)``, ``i1 = i0 + 1`` inside the axis, ``l1 = src - i0``,
    ``l0 = 1 - l1``.  Tensors ``(i0, i1, l0, l1)`` on ``device``, cached."""
    f32 = np.float32
    scale = f32(in_size - 1) / f32(out_size - 1) if out_size > 1 else f32(0)
    src = scale * np.arange(start, start + count).astype(f32)
    i0 = np.minimum(src.astype(np.int64), in_size - 1)
    l1 = src - i0.astype(f32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (i0, i0 + (i0 < in_size - 1), f32(1) - l1, l1))


def upsample2x_aligned_shard(x: torch.Tensor, lh: torch.Tensor, rh: torch.Tensor,
                             offset: int, width: int) -> torch.Tensor:
    """``resize_bilinear(whole, (2H, 2W), align_corners=True)`` at a width
    shard's output columns ``2 offset .. 2 (offset + w) - 1``: NCHW ``x``
    [B, C, H, w] holds the whole input's columns ``offset ..`` of ``width``,
    ``lh`` and ``rh`` (NHWC [B, H, 1, C]) the column on each side.

    The source coordinate ``dst (W - 1) / (2W - 1)`` is global and not
    shift-invariant, so a local resize of the shard would move every shard
    boundary.  The taps and weights are ATen's in float32
    (:func:`_aligned_taps`), blended as its CUDA kernel writes it,
    ``l0h (l0w a + l1w b) + l1h (l0w c + l1w d)`` in f32, rounded once to
    x's dtype; the card's kernel may contract a product into an add (an
    FMA), so the two agree to about an f32 rounding, not bit for bit."""
    B, C, H, w = x.shape
    xe = torch.cat([lh, x.permute(0, 2, 3, 1), rh], dim=2).float()  # [B, H, w + 2, C]
    hi0, hi1, h0, h1 = _aligned_taps(H, 2 * H, 0, 2 * H, x.device)
    wi0, wi1, w0, w1 = _aligned_taps(width, 2 * width, 2 * offset, 2 * w, x.device)
    c0, c1 = wi0 - (offset - 1), wi1 - (offset - 1)  # xe's column 0 is global offset - 1
    r0, r1 = xe[:, hi0], xe[:, hi1]  # [B, 2H, w + 2, C]
    w0, w1 = w0[:, None], w1[:, None]
    a = w0 * r0[:, :, c0] + w1 * r0[:, :, c1]
    b = w0 * r1[:, :, c0] + w1 * r1[:, :, c1]
    y = h0[:, None, None] * a + h1[:, None, None] * b
    return y.to(x.dtype).permute(0, 3, 1, 2)


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys' cubic convolution kernel, torch's a = -0.75."""
    t = np.abs(t)
    return np.where(t <= 1, (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1,
                    np.where(t < 2, a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a, 0.0))


def _cubic_coeffs(in_size: int, out_size: int, align_corners: bool):
    """The four source indices (clamped to the edge) and weights of each
    output of 1-D cubic interpolation (the JAX package's
    ``tcct_tpu/ops/resize.py::_cubic_coeffs``)."""
    i = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = i * (in_size - 1) / max(out_size - 1, 1)
    else:
        src = (i + 0.5) * in_size / out_size - 0.5
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    idxs = [np.clip(i0 + k, 0, in_size - 1) for k in range(-1, 3)]
    ws = [_cubic_kernel(t - k).astype(np.float32) for k in range(-1, 3)]
    return idxs, ws


@functools.lru_cache(maxsize=None)
def _cubic_matrix_np(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    for idx, w in zip(*_cubic_coeffs(in_size, out_size, align_corners)):
        np.add.at(m, (rows, idx), w)
    return m


@functools.lru_cache(maxsize=None)
def cubic_matrix(in_size: int, out_size: int, align_corners: bool,
                 device: torch.device) -> torch.Tensor:
    """The f32 ``[out, in]`` matrix of 1-D cubic interpolation, cached per
    size, ``align_corners`` and device."""
    return torch.from_numpy(_cubic_matrix_np(in_size, out_size, align_corners)).to(device)


def resize_bicubic(x: torch.Tensor, size: Tuple[int, int],
                   align_corners: bool = False) -> torch.Tensor:
    """Bicubic resize of an NCHW tensor to ``size=(H, W)``: the height axis,
    then the width axis, each an f32 product with :func:`cubic_matrix`,
    rounded once to x's dtype.  Forward only (no gradient reaches x)."""
    (Hi, Wi), (Ho, Wo) = x.shape[2:], (int(size[0]), int(size[1]))
    y = x.detach().float()
    if Ho != Hi:  # [Ho, Hi] @ [B, C, Hi, Wi]
        y = torch.matmul(cubic_matrix(Hi, Ho, align_corners, y.device), y)
    if Wo != Wi:  # [B, C, Ho, Wi] @ [Wi, Wo]
        y = torch.matmul(y, cubic_matrix(Wi, Wo, align_corners, y.device).T)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _nearest_idx(in_size: int, out_size: int) -> np.ndarray:
    """torch's 'nearest' source index: ``floor(i * in / out)``."""
    i = np.arange(out_size, dtype=np.float64)
    return np.minimum((i * in_size / out_size).astype(np.int64), in_size - 1)


def resize_nearest(x: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize (torch ``'nearest'``, cv2 ``INTER_NEAREST``;
    reference task1/data/octnpy.py:72) of an [H, W, ...] numpy array."""
    for axis, n in enumerate(size):
        if x.shape[axis] != n:
            x = np.take(x, _nearest_idx(x.shape[axis], int(n)), axis=axis)
    return x
