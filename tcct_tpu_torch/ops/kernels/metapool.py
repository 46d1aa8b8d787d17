"""MetaPool token mixer: hand-written CUDA kernels (``csrc/metapool.cu``),
forward and backward, and their plain PyTorch versions.

Replaces the TPU kernels ``tcct_tpu/ops/pallas/metapool.py::_kernel`` and
``::_bwd_kernel`` (both through ``pallas_call`` at metapool.py:64; the
backward is that file's custom VJP).  Both kernels are memory-bound (one
read and one write per element); see the source's header note for their
design.  Unlike the TPU kernel they have no size budget: every stage of
every geometry runs through them.

:func:`metapool_tokens` is a ``torch.autograd.Function``: its forward
launches the forward kernel and its backward the backward kernel.  On a
CPU tensor the same function runs the plain forward and the plain
backward.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from tcct_tpu_torch.ops.kernels import build
from tcct_tpu_torch.ops.pool import metapool_tokens_backward_reference, metapool_tokens_reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fn(name: str):
    """The C entry point ``name`` of the library, typed (built and loaded
    on first use)."""
    fn = getattr(build.load("metapool"), name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(entry: str, x: torch.Tensor, what: str) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 3 or x.dtype not in _DTYPES:
        raise ValueError(f"{what}: want [B,N,C] float32/bfloat16, got {tuple(x.shape)} {x.dtype}")
    B, N, C = x.shape
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    err = _fn(entry)(x.data_ptr(), y.data_ptr(), B, N, C, _DTYPES[x.dtype],
                     torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"{what} {tuple(x.shape)} {x.dtype}")
    return y


def _forward(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return metapool_tokens_reference(x)
    y = _launch("tcct_metapool_fwd", x, "metapool_tokens")
    metapool_tokens.launches += 1
    return y


def metapool_tokens_backward(g: torch.Tensor) -> torch.Tensor:
    """Gradient of :func:`metapool_tokens` for the output gradient ``g``
    [B, N, C]: ``window_sum(g / count) - g``, f32 inside, in g's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    backward kernel, or the call raises."""
    if g.device.type == "cpu":
        return metapool_tokens_backward_reference(g)
    dx = _launch("tcct_metapool_bwd", g, "metapool_tokens_backward")
    metapool_tokens_backward.launches += 1
    return dx


class _MetaPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _forward(x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return metapool_tokens_backward(g)


def metapool_tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, N, C] -> [B, N, C]: ``AvgPool2d(3,1,1,count_include_pad=False)
    - x`` over the (token, channel) axes, f32 inside, cast to x's dtype.
    Differentiable: the backward is :func:`metapool_tokens_backward`.

    A CPU tensor takes the plain versions; a CUDA tensor launches the
    kernels, or the call raises."""
    return _MetaPool.apply(x)


# launches of the forward / backward kernel
metapool_tokens.launches = 0
metapool_tokens_backward.launches = 0
