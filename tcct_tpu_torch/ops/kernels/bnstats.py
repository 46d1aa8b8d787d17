"""Train-mode BatchNorm with an optional LeakyReLU(0.01) in front:
hand-written CUDA kernels (``csrc/bnstats.cu``), forward (K3) and backward
(K3b), and their plain PyTorch versions (statistics, normalize, backward).

Replaces the TPU kernels ``tcct_tpu/ops/pallas/bnstats.py::_stats_kernel``
(``pallas_call`` at bnstats.py:129) and ``::_norm_kernel`` (bnstats.py:149),
via ``bn_act_train_packed_pallas``, and its backward (``::_bwd``, plain
jnp), on the port's own layout: NCHW tensors in channels_last memory,
channels the fast axis.  The TPU kernel's packed layout, phantom masks and
phase-fold matmul are TPU layout artifacts and have no counterpart here.

The arithmetic is the JAX package's default train BatchNorm
(``tcct_tpu/models/layers.py::BatchNorm``), not the TPU kernel's folded
``t*inv + shift``: with ``t = act(x)`` in the input dtype,
``mean = E[t]`` and ``var = E[t^2] - mean^2`` (biased, not clamped) as f32
reductions, ``inv = rsqrt(var + eps) * weight`` in f32, and
``y = (t - mean) * inv + bias`` in the input dtype.

:func:`bn_act_train` calls the op ``tcct::bn_act_train``, whose autograd
formula (``_BNActTrainAutograd``) calls the op
``tcct::bn_act_train_backward``.  On a CUDA tensor the
forward launches K3 and the backward K3b: each one cooperative launch that
sums per channel in a fixed order, then normalizes (or forms dx) in the
same launch.  On a CPU tensor both run the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from tcct_tpu_torch.ops.kernels import build, library

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


def bn_act_train_backward_tolerance(x, weight, mean, var, gy, eps: float = 1e-5,
                                    leaky: bool = False):
    """Per-element bounds on ``|K3b - plain|`` for ``(dx, dweight, dbias)``,
    f64.  The two differ in the order of the f32 sums ``sum(gy)`` and
    ``sum(gy * t)`` only (the kernel rounds every other product and sum in
    the plain version's order), so dx may differ by one rounding to x's
    dtype plus what 1e-5 of ``sum|gy|`` and of ``sum|gy * t| + |mean|
    sum|gy|`` moves it by through gmean and gvar, plus 1e-6 of its terms;
    dweight and dbias by 1e-5 of ``r * (sum|gy * t| + |mean| sum|gy|)`` and
    of ``sum|gy|``, plus one rounding to weight's dtype."""
    def ulp_share(dtype):  # spacing of dtype's values near v, as a share of |v|
        return 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -23

    want = bn_act_train_backward_reference(x, weight, mean, var, gy, eps, leaky)
    n = x.numel() // x.shape[1]
    t, g = _act(x, leaky).double(), gy.double()
    m, w = mean.double(), weight.double()
    r = torch.reciprocal(torch.sqrt(var.double() + eps))
    s_g, s_gt = g.abs().sum(_DIMS), (g * t).abs().sum(_DIMS)
    d_ginv, d_gsum = 1e-5 * (s_gt + m.abs() * s_g), 1e-5 * s_g
    d_gvar = 0.5 * w.abs() * r ** 3 * d_ginv
    d_gmean = (w * r).abs() * d_gsum + 2 * m.abs() * d_gvar
    gvar = -0.5 * ((g * t).sum(_DIMS) - m * g.sum(_DIMS)) * w * r ** 3
    gmean = -w * r * g.sum(_DIMS) - 2 * m * gvar
    terms = ((g * _per_channel(w * r)).abs() + _per_channel(gmean / n).abs()
             + (_per_channel(2 * gvar / n) * t).abs())
    lim_dx = (_per_channel(d_gmean / n) + _per_channel(2 * d_gvar / n) * t.abs() + 1e-6 * terms
              + ulp_share(x.dtype) * want[0].double().abs() + 1e-30)
    lim_dw = r * d_ginv + ulp_share(weight.dtype) * want[1].double().abs() + 1e-30
    lim_db = d_gsum + ulp_share(weight.dtype) * want[2].double().abs() + 1e-30
    return lim_dx, lim_dw, lim_db


@functools.cache
def _fn(name: str):
    """A C entry point of the library, typed (built and loaded on first use)."""
    fn = getattr(build.load("bnstats"), name)
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn.argtypes, fn.restype = {
        "tcct_bn_act_workspace": ([ll, i, i, i], ll),
        "tcct_bn_act_train": ([p] * 6 + [ll, i, f, i, i, i, i, p], i),
        "tcct_bn_act_train_backward": ([p] * 9 + [ll, i, f, i, i, i, p], i),
    }[name]
    return fn


def _check(x, what, **params):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"{what}: want NCHW float32/bfloat16, got {tuple(x.shape)} {x.dtype}")
    C = x.shape[1]
    for name, t in params.items():
        if tuple(t.shape) != (C,) or t.device != x.device:
            raise ValueError(f"{what}: want {name} [{C}] on {x.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    M = x.numel() // C if C else 0
    if M == 0:
        raise ValueError(f"{what}: empty batch {tuple(x.shape)}")
    return M, C


def _param(t: torch.Tensor, what: str) -> torch.Tensor:
    """A per-channel parameter as the kernel reads it: f32 or bf16 whatever
    x's type (every combination launches: bf16 weights before f32 maps come
    after a trained gate), contiguous; any other type raises."""
    if t.dtype not in _DTYPES:
        raise ValueError(f"{what}: want a float32/bfloat16 weight and bias, got {t.dtype}")
    return t.contiguous()


def _workspace(x, M, C, backward: bool) -> torch.Tensor:
    n = _fn("tcct_bn_act_workspace")(M, C, _DTYPES[x.dtype], int(backward))
    if n < 0:
        raise ValueError(f"bn_act_train: channels {C} in {x.dtype} are more than one block "
                         "of words")
    return torch.empty(n, dtype=torch.float32, device=x.device)


def _forward_cuda(x, weight, bias, eps: float, leaky: bool):
    M, C = _check(x, "bn_act_train", weight=weight, bias=bias)
    xc = x.contiguous(memory_format=torch.channels_last)
    y = torch.empty_like(xc, memory_format=torch.channels_last)
    stats = torch.empty((3, C), dtype=torch.float32, device=x.device)  # mean, var, inv
    part = _workspace(x, M, C, False)
    w, b = _param(weight, "bn_act_train"), _param(bias, "bn_act_train")
    err = _fn("tcct_bn_act_train")(
        xc.data_ptr(), y.data_ptr(), w.data_ptr(), b.data_ptr(), stats.data_ptr(),
        part.data_ptr(), M, C, float(eps), int(leaky), _DTYPES[x.dtype], _DTYPES[w.dtype],
        _DTYPES[b.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"bn_act_train {tuple(x.shape)} {x.dtype} leaky={leaky}")
    bn_act_train.launches += 1
    return y, stats[:2]


def _forward_cpu(x, weight, bias, eps: float, leaky: bool):
    mean, var = bn_stats_reference(x, leaky)
    return bn_normalize_reference(x, mean, var, weight, bias, eps, leaky), torch.stack([mean, var])


def _like_y(x: torch.Tensor) -> torch.Tensor:
    """An output shaped like NCHW ``x`` in the layout each implementation
    gives: channels_last from the kernels, x's own from the plain versions."""
    if x.device.type == "cuda":
        return torch.empty_like(x, memory_format=torch.channels_last)
    return torch.empty_like(x)


# (y, stats [2, C] f32: mean, var); the kernel writes a third row, inv
_forward_op = library.define(
    "bn_act_train(Tensor x, Tensor weight, Tensor bias, float eps, bool leaky) "
    "-> (Tensor, Tensor)",
    cpu=_forward_cpu, cuda=_forward_cuda,
    fake=lambda x, weight, bias, eps, leaky: (
        _like_y(x), x.new_empty((2, x.shape[1]), dtype=torch.float32)))


def _backward_cuda(x, weight, mean, var, gy, eps: float, leaky: bool):
    M, C = _check(x, "bn_act_train_backward", weight=weight, mean=mean, var=var)
    if gy.shape != x.shape or gy.dtype != x.dtype or gy.device != x.device:
        raise ValueError(f"bn_act_train_backward: want gy like x {tuple(x.shape)} {x.dtype}, "
                         f"got {tuple(gy.shape)} {gy.dtype} on {gy.device}")
    xc = x.contiguous(memory_format=torch.channels_last)
    gc = gy.contiguous(memory_format=torch.channels_last)
    dx = torch.empty_like(xc, memory_format=torch.channels_last)
    w = _param(weight, "bn_act_train_backward")
    dwb = torch.empty((2, C), dtype=w.dtype, device=x.device)  # dweight, dbias
    coef = torch.empty((3, C), dtype=torch.float32, device=x.device)
    part = _workspace(x, M, C, True)
    m32, v32 = mean.float().contiguous(), var.float().contiguous()
    err = _fn("tcct_bn_act_train_backward")(
        xc.data_ptr(), gc.data_ptr(), dx.data_ptr(), w.data_ptr(), m32.data_ptr(),
        v32.data_ptr(), coef.data_ptr(), dwb.data_ptr(), part.data_ptr(), M, C, float(eps),
        int(leaky), _DTYPES[x.dtype], _DTYPES[w.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"bn_act_train_backward {tuple(x.shape)} {x.dtype} leaky={leaky}")
    bn_act_train_backward.launches += 1
    return dx, dwb


def _backward_cpu(x, weight, mean, var, gy, eps: float, leaky: bool):
    dx, dw, db = bn_act_train_backward_reference(x, weight, mean, var, gy, eps, leaky)
    return dx, torch.stack([dw, db])


# (dx, [2, C] in weight's dtype: dweight, dbias)
_backward_op = library.define(
    "bn_act_train_backward(Tensor x, Tensor weight, Tensor mean, Tensor var, Tensor gy, "
    "float eps, bool leaky) -> (Tensor, Tensor)",
    cpu=_backward_cpu, cuda=_backward_cuda,
    fake=lambda x, weight, mean, var, gy, eps, leaky: (
        _like_y(x), weight.new_empty((2, x.shape[1]))))


def bn_act_train_backward(x: torch.Tensor, weight: torch.Tensor, mean: torch.Tensor,
                          var: torch.Tensor, gy: torch.Tensor, eps: float = 1e-5,
                          leaky: bool = False):
    """The adjoint of :func:`bn_act_train` at ``gy``, given the forward's
    batch ``mean`` and ``var``: ``(dx in x's dtype, dweight, dbias in
    weight's dtype)`` (the op ``tcct::bn_act_train_backward``).  A CPU
    tensor takes :func:`bn_act_train_backward_reference`; a CUDA tensor
    launches K3b, or the call raises."""
    library.check_device(x, "bn_act_train_backward")
    dx, dwb = _backward_op(x, weight, mean, var, gy, float(eps), bool(leaky))
    return dx, dwb[0], dwb[1]


class _BNActTrainAutograd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, leaky):
        y, stats = library.below_autograd(_forward_op, x, weight, bias, eps, leaky)
        ctx.save_for_backward(x, weight, stats)
        ctx.eps, ctx.leaky, ctx.bias_dtype = eps, leaky, bias.dtype
        ctx.mark_non_differentiable(stats)
        return y, stats

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, _gstats):
        x, weight, stats = ctx.saved_tensors
        dx, dw, db = bn_act_train_backward(x, weight, stats[0], stats[1], gy, ctx.eps,
                                           ctx.leaky)
        return dx, dw, db.to(ctx.bias_dtype), None, None


library.autograd(_forward_op, _BNActTrainAutograd)


def bn_act_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
                 leaky: bool = False):
    """Train-mode BatchNorm of NCHW ``x`` after an optional LeakyReLU(0.01):
    ``(y in x's dtype, batch mean [C] f32, biased batch var [C] f32)`` (the
    op ``tcct::bn_act_train``; the statistics are two rows of its second
    output).  Differentiable in x, weight and bias (through y; the
    statistics are outputs only).

    A CPU tensor takes the plain versions; a CUDA tensor launches the
    kernel, or the call raises."""
    library.check_device(x, "bn_act_train")
    y, stats = _forward_op(x, weight, bias, float(eps), bool(leaky))
    return y, stats[0], stats[1]


def bn_act_train_flops(x_shape, backward: bool = False) -> int:
    """Operations of K3 (``backward=False``) or K3b on NCHW ``x_shape``:
    about 8 an element forward (the activation, two sums, the normalize),
    12 backward."""
    return (12 if backward else 8) * math.prod(x_shape)


bn_act_train.launches = 0
bn_act_train_backward.launches = 0
