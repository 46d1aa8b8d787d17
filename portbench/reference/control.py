"""The lower-precision control: the reference computed in fp8, the step
below the bf16 that the configurations state, as fp8 training does it.
Every convolution's and linear layer's input and weight are rounded to
e4m3 (:func:`fp8`) and the gradient arriving at its output to e5m2
(:func:`fp8_grad`), each with one scale a tensor, its largest magnitude
mapped to the format's largest value; the products accumulate in f32.  The
forward rounding passes the gradient straight through."""

from __future__ import annotations

import torch


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    scale = torch.clamp(t.abs().amax(), min=1e-30) / torch.finfo(dtype).max
    return (t / scale).to(dtype).to(t.dtype) * scale


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 in the forward, the gradient passed as it is."""
    d = t.detach()
    return t + (_round(d, torch.float8_e4m3fn) - d)


class _GradFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def fp8_grad(t: torch.Tensor) -> torch.Tensor:
    """The identity in the forward; the gradient rounded to e5m2."""
    return _GradFp8.apply(t)
