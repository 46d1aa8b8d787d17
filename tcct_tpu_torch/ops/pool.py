"""Pooling primitives with torch-exact edge semantics.

The reference's token mixer ``MetaPool`` feeds a **[B, N, C] token
tensor** to ``nn.AvgPool2d(3, stride=1, padding=1,
count_include_pad=False)``.  Torch reads a 3-D input as (C, H, W), so the
3x3 window slides over the *(token, channel)* axes, not over 2-D space.
The shipped checkpoints were trained with exactly this op, and
:func:`metapool_tokens_reference` keeps it.  :func:`metapool_spatial` is
the PoolFormer mixer the reference meant (the ``metapool2d`` mixer): a 3x3
average over the tokens' (H, W) grid, per channel; not checkpoint
compatible.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _axis_counts(size: int, device) -> torch.Tensor:
    """Valid (non-pad) element count of a 3-wide, pad-1 window along one
    axis of length ``size``: 2 at the edges, 3 inside (1 if size == 1)."""
    i = torch.arange(size, device=device)
    lo = torch.clamp(i - 1, min=0)
    hi = torch.clamp(i + 2, max=size)
    return (hi - lo).to(torch.float32)


def avg_pool_2d(x: torch.Tensor, window: int = 3, stride: int = 1, padding: int = 1) -> torch.Tensor:
    """AvgPool over the last two axes of an NCHW tensor with torch's
    ``count_include_pad=False``: each output averages its valid inputs."""
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=False)


def max_pool_2d(x: torch.Tensor, window: int = 2, stride: Optional[int] = None,
                padding: int = 0) -> torch.Tensor:
    """MaxPool of an NCHW tensor with torch's floor-mode semantics: the
    reference's ``nn.MaxPool2d(kernel_size=2)`` by default; ``stride``
    (default ``window``) and ``padding`` (``-inf`` on each side: the task-2
    ResNet stem's 3x3/2 pad 1, JAX's ``max_pool_2d`` of an ``-inf``-padded
    input)."""
    return F.max_pool2d(x, window, stride or window, padding)


def _window_sum3x3(v: torch.Tensor) -> torch.Tensor:
    """3x3 zero-padded window sum over the last two axes, by shifted adds."""
    p = F.pad(v, (1, 1, 1, 1))  # zeros outside
    rows = p[:, :-2] + p[:, 1:-1] + p[:, 2:]
    return rows[..., :-2] + rows[..., 1:-1] + rows[..., 2:]


def _token_counts(N: int, C: int, device) -> torch.Tensor:
    return _axis_counts(N, device)[:, None] * _axis_counts(C, device)[None, :]


def metapool_tokens_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain MetaPool on a [B, N, C] token tensor:
    ``AvgPool2d(3, 1, pad=1, count_include_pad=False)(x) - x`` with the
    window over (N, C).

    The arithmetic is f32 inside and the result is cast to the input
    dtype once, as the kernel it stands beside does
    (``ops/kernels/metapool.py``): a 3x3 zero-padded window sum by shifted
    adds, divided by the valid count, minus ``x``."""
    _, N, C = x.shape
    xf = x.float()
    return (_window_sum3x3(xf) / _token_counts(N, C, x.device) - xf).to(x.dtype)


def metapool_tokens_backward_reference(g: torch.Tensor) -> torch.Tensor:
    """Plain adjoint of :func:`metapool_tokens_reference` for the output
    gradient ``g`` [B, N, C]: ``window_sum(g / count) - g``, f32 inside,
    cast to g's dtype once (the window is symmetric, so the adjoint of
    the window sum is the window sum)."""
    _, N, C = g.shape
    gf = g.float()
    return (_window_sum3x3(gf / _token_counts(N, C, g.device)) - gf).to(g.dtype)


def metapool_spatial(x: torch.Tensor, size) -> torch.Tensor:
    """PoolFormer MetaPool on [B, N, C] tokens of an (H, W) grid (JAX
    ``tcct_tpu/ops/pool.py::metapool_spatial``): a 3x3 average over H and W
    per channel with ``count_include_pad=False``, minus ``x``.  The window
    sum is f32 and is multiplied by the reciprocal of the valid count, then
    rounded to x's dtype once before the subtraction, as the JAX package's
    ``avg_pool_2d`` does."""
    B, N, C = x.shape
    H, W = size
    img = x.reshape(B, H, W, C).permute(0, 3, 1, 2).reshape(B * C, H, W).float()
    inv = 1.0 / (_axis_counts(H, x.device)[:, None] * _axis_counts(W, x.device)[None, :])
    pooled = (_window_sum3x3(img) * inv).to(x.dtype)
    return pooled.reshape(B, C, N).transpose(1, 2) - x
