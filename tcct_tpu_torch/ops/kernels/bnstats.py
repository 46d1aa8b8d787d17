"""Train-mode BatchNorm with an optional LeakyReLU(0.01) in front:
hand-written CUDA kernel (``csrc/bnstats.cu``) and its plain PyTorch
versions (statistics, normalize, backward).

Replaces the TPU kernels ``tcct_tpu/ops/pallas/bnstats.py::_stats_kernel``
(``pallas_call`` at bnstats.py:129) and ``::_norm_kernel`` (bnstats.py:149),
via ``bn_act_train_packed_pallas``, on the port's own layout: NCHW tensors
in channels_last memory, channels the fast axis.  The TPU kernel's packed
layout, phantom masks and phase-fold matmul are TPU layout artifacts and
have no counterpart here.

The arithmetic is the JAX package's default train BatchNorm
(``tcct_tpu/models/layers.py::BatchNorm``), not the TPU kernel's folded
``t*inv + shift``: with ``t = act(x)`` in the input dtype,
``mean = E[t]`` and ``var = E[t^2] - mean^2`` (biased, not clamped) as f32
reductions, ``inv = rsqrt(var + eps) * weight`` in f32, and
``y = (t - mean) * inv + bias`` in the input dtype.

:func:`bn_act_train` is a ``torch.autograd.Function``.  Its forward
launches the kernel (a statistics sweep and a normalize sweep) on a CUDA
tensor and runs the plain versions on a CPU tensor; its backward is the
plain analytic adjoint on both, as the JAX package's own backward
(``bnstats.py::_bwd``) is plain jnp.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from tcct_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DIMS = (0, 2, 3)  # every axis of NCHW but channels


def _act(x: torch.Tensor, leaky: bool) -> torch.Tensor:
    return F.leaky_relu(x, 0.01) if leaky else x


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def bn_stats_reference(x: torch.Tensor, leaky: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain statistics sweep of NCHW ``x``: per-channel f32 ``(mean, var)``
    of ``act(x)``, ``var = E[t^2] - mean^2`` (biased, not clamped)."""
    tf = _act(x, leaky).float()
    mean = tf.mean(_DIMS)
    return mean, (tf * tf).mean(_DIMS) - mean * mean


def bn_normalize_reference(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                           weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
                           leaky: bool = False) -> torch.Tensor:
    """Plain normalize sweep: ``(act(x) - mean) * inv + bias`` in x's dtype
    with ``inv = rsqrt(var + eps) * weight`` in f32 (the reciprocal of an
    IEEE square root, as the kernel forms it)."""
    dt = x.dtype
    inv = torch.reciprocal(torch.sqrt(var + eps)) * weight.float()
    t = _act(x, leaky)
    return ((t - _per_channel(mean.to(dt))) * _per_channel(inv.to(dt))
            + _per_channel(bias.to(dt)))


def bn_act_train_backward_reference(x, weight, mean, var, gy, eps: float = 1e-5,
                                    leaky: bool = False):
    """Plain analytic adjoint of ``y = BN_train(act(x))`` (the JAX
    package's ``bnstats.py::_bwd`` without the packing), f32 inside:
    ``(dx in x's dtype, dweight, dbias in weight's dtype)``."""
    n = x.numel() // x.shape[1]
    tf = _act(x, leaky).float()
    gyf = gy.float()
    r = torch.reciprocal(torch.sqrt(var + eps))
    w = weight.float()
    inv = w * r
    gsum = gyf.sum(_DIMS)
    ginv = (gyf * tf).sum(_DIMS) - mean * gsum
    gvar = ginv * (-0.5) * w * r ** 3
    gmean = -inv * gsum - 2.0 * mean * gvar
    dt = gyf * _per_channel(inv) + _per_channel(gmean / n) + _per_channel(gvar / n) * 2.0 * tf
    if leaky:
        dt = dt * torch.where(x >= 0, 1.0, 0.01)
    return dt.to(x.dtype), (ginv * r).to(weight.dtype), gsum.to(weight.dtype)


@functools.cache
def _fn(name: str):
    """A C entry point of the library, typed (built and loaded on first use)."""
    fn = getattr(build.load("bnstats"), name)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "tcct_bn_act_train_parts":
        fn.argtypes = [ll]
    else:  # tcct_bn_act_train
        fn.argtypes = [p] * 8 + [ll, i, ctypes.c_float, i, i, p]
    fn.restype = i
    return fn


def _kernel(x, weight, bias, eps, leaky):
    if x.device.type != "cuda":
        raise ValueError(f"bn_act_train: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"bn_act_train: want NCHW float32/bfloat16, got {tuple(x.shape)} {x.dtype}")
    C = x.shape[1]
    for name, p in (("weight", weight), ("bias", bias)):
        if tuple(p.shape) != (C,) or p.device != x.device:
            raise ValueError(f"bn_act_train: want {name} [{C}] on {x.device}, got "
                             f"{tuple(p.shape)} on {p.device}")
    xc = x.contiguous(memory_format=torch.channels_last)
    y = torch.empty_like(xc, memory_format=torch.channels_last)
    stats = torch.empty((3, C), dtype=torch.float32, device=x.device)  # mean, var, inv
    M = x.numel() // C
    if M == 0:
        raise ValueError(f"bn_act_train: empty batch {tuple(x.shape)}")
    part = torch.empty((_fn("tcct_bn_act_train_parts")(M), 2, C), dtype=torch.float32,
                       device=x.device)
    w32 = weight.float().contiguous()
    b32 = bias.float().contiguous()
    err = _fn("tcct_bn_act_train")(
        xc.data_ptr(), y.data_ptr(), w32.data_ptr(), b32.data_ptr(), stats[0].data_ptr(),
        stats[1].data_ptr(), stats[2].data_ptr(), part.data_ptr(), M, C, float(eps), int(leaky),
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"bn_act_train {tuple(x.shape)} {x.dtype} leaky={leaky}")
    bn_act_train.launches += 1
    return y, stats[0], stats[1]


class _BNActTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, leaky):
        if x.device.type == "cpu":
            mean, var = bn_stats_reference(x, leaky)
            y = bn_normalize_reference(x, mean, var, weight, bias, eps, leaky)
        else:
            y, mean, var = _kernel(x, weight, bias, eps, leaky)
        ctx.save_for_backward(x, weight, mean, var)
        ctx.eps, ctx.leaky, ctx.bias_dtype = eps, leaky, bias.dtype
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, var = ctx.saved_tensors
        dx, dw, db = bn_act_train_backward_reference(x, weight, mean, var, gy, ctx.eps, ctx.leaky)
        return dx, dw, db.to(ctx.bias_dtype), None, None


def bn_act_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
                 leaky: bool = False):
    """Train-mode BatchNorm of NCHW ``x`` after an optional LeakyReLU(0.01):
    ``(y in x's dtype, batch mean [C] f32, biased batch var [C] f32)``.
    Differentiable in x, weight and bias (through y; the statistics are
    outputs only).

    A CPU tensor takes the plain versions; a CUDA tensor launches the
    kernel, or the call raises."""
    return _BNActTrain.apply(x, weight, bias, float(eps), bool(leaky))


bn_act_train.launches = 0
