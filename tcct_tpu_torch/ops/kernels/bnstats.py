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

A batch split over the ranks of a data-parallel step needs the statistics
of the whole batch, so each kernel also has a two-phase form, four ops of
their own (the TPU kernel's own structure, ``_stats_kernel`` then
``_norm_kernel``): :func:`bn_act_sums` (the per-channel f32 sums of t and
t*t), then, once the caller has added the sums across the ranks,
:func:`bn_act_normalize` over the batch's ``count`` rows; backward
:func:`bn_act_backward_sums` (the sums of gy and gy*t) and
:func:`bn_act_backward_dx`.  :func:`bn_act_train_split` is the autograd
function over them; the collective is the caller's ``reduce``.  At one
rank the split path gives bitwise the one launch's results.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Optional, Tuple

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


def bn_sums_reference(x: torch.Tensor, leaky: bool = False) -> torch.Tensor:
    """Plain sums sweep of NCHW ``x``: [2, C] f32, ``sum(t)`` and
    ``sum(t*t)`` of ``t = act(x)`` per channel."""
    tf = _act(x, leaky).float()
    return torch.stack([tf.sum(_DIMS), (tf * tf).sum(_DIMS)])


def stats_from_sums(sums: torch.Tensor, count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel f32 ``(mean, var)`` from [2, C] sums over ``count`` rows:
    ``mean = sum(t) / n``, ``var = sum(t*t) / n - mean^2`` (biased, not
    clamped), the kernels' arithmetic."""
    mean = sums[0] / count
    return mean, sums[1] / count - mean * mean


def bn_stats_reference(x: torch.Tensor, leaky: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain statistics sweep of NCHW ``x``: per-channel f32 ``(mean, var)``
    of ``act(x)``, ``var = E[t^2] - mean^2`` (biased, not clamped)."""
    return stats_from_sums(bn_sums_reference(x, leaky), x.numel() // x.shape[1])


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


def bn_backward_sums_reference(x: torch.Tensor, gy: torch.Tensor,
                               leaky: bool = False) -> torch.Tensor:
    """Plain sums of the backward: [2, C] f32, ``sum(gy)`` and
    ``sum(gy * t)`` per channel."""
    gyf = gy.float()
    return torch.stack([gyf.sum(_DIMS), (gyf * _act(x, leaky).float()).sum(_DIMS)])


def bn_weight_grads(sums: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, eps: float,
                    dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dweight, dbias)`` in ``dtype`` from the backward's [2, C] sums:
    ``(sum(gy*t) - mean * sum(gy)) / sqrt(var + eps)`` and ``sum(gy)``,
    each step rounded in f32 as K3b rounds it.  Summed over the rows the
    sums cover, so on one rank's sums they are that rank's share."""
    r = torch.reciprocal(torch.sqrt(var + eps))
    return ((sums[1] - mean * sums[0]) * r).to(dtype), sums[0].to(dtype, copy=True)


def _dx_from_sums(x, weight, mean, var, gy, sums, count: int, eps: float, leaky: bool):
    """dx (in x's dtype) of the analytic adjoint from the backward's sums
    over ``count`` rows, f32 inside."""
    tf = _act(x, leaky).float()
    gyf = gy.float()
    r = torch.reciprocal(torch.sqrt(var + eps))
    w = weight.float()
    inv = w * r
    gsum = sums[0]
    ginv = sums[1] - mean * gsum
    gvar = ginv * (-0.5) * w * r ** 3
    gmean = -inv * gsum - 2.0 * mean * gvar
    n = count
    dt = gyf * _per_channel(inv) + _per_channel(gmean / n) + _per_channel(gvar / n) * 2.0 * tf
    if leaky:
        dt = dt * torch.where(x >= 0, 1.0, 0.01)
    return dt.to(x.dtype)


def bn_act_train_backward_reference(x, weight, mean, var, gy, eps: float = 1e-5,
                                    leaky: bool = False):
    """Plain analytic adjoint of ``y = BN_train(act(x))`` (the JAX
    package's ``bnstats.py::_bwd`` without the packing), f32 inside:
    ``(dx in x's dtype, dweight, dbias in weight's dtype)``."""
    sums = bn_backward_sums_reference(x, gy, leaky)
    dx = _dx_from_sums(x, weight, mean, var, gy, sums, x.numel() // x.shape[1], eps, leaky)
    return (dx,) + bn_weight_grads(sums, mean, var, eps, weight.dtype)


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
        "tcct_bn_act_sums": ([p] * 4 + [ll, i, i, i, i, p], i),
        "tcct_bn_act_normalize": ([p] * 6 + [ll, ll, i, f, i, i, i, i, p], i),
        "tcct_bn_act_backward_dx": ([p] * 7 + [ll, ll, i, f, i, i, i, p], i),
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


# --- the two-phase entry points ------------------------------------------------------


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def _sums_cuda(x, gy, leaky: bool, backward: bool):
    M, C = _check(x, "bn_act_backward_sums" if backward else "bn_act_sums")
    xc = _rows(x)
    gc = _rows(gy) if backward else None
    if backward and (gy.shape != x.shape or gy.dtype != x.dtype or gy.device != x.device):
        raise ValueError(f"bn_act_backward_sums: want gy like x {tuple(x.shape)} {x.dtype}, "
                         f"got {tuple(gy.shape)} {gy.dtype} on {gy.device}")
    sums = torch.empty((2, C), dtype=torch.float32, device=x.device)
    part = _workspace(x, M, C, backward)
    err = _fn("tcct_bn_act_sums")(
        xc.data_ptr(), gc.data_ptr() if backward else None, sums.data_ptr(), part.data_ptr(),
        M, C, int(leaky), _DTYPES[x.dtype], int(backward),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"bn_act_sums {tuple(x.shape)} {x.dtype} leaky={leaky} "
                     f"backward={backward}")
    return sums


def _check_sums(x, sums, count: int, what: str) -> None:
    C = x.shape[1]
    if tuple(sums.shape) != (2, C) or sums.dtype != torch.float32 or sums.device != x.device:
        raise ValueError(f"{what}: want sums [2, {C}] float32 on {x.device}, got "
                         f"{tuple(sums.shape)} {sums.dtype} on {sums.device}")
    if count < x.numel() // max(C, 1):
        raise ValueError(f"{what}: count {count} is fewer than x's {x.numel() // C} rows")


def _sums_fwd_cuda(x, leaky: bool):
    out = _sums_cuda(x, None, leaky, False)
    bn_act_sums.launches += 1
    return out


_sums_op = library.define(
    "bn_act_sums(Tensor x, bool leaky) -> Tensor",
    cpu=lambda x, leaky: bn_sums_reference(x, leaky), cuda=_sums_fwd_cuda,
    fake=lambda x, leaky: x.new_empty((2, x.shape[1]), dtype=torch.float32))


def _normalize_cuda(x, sums, count: int, weight, bias, eps: float, leaky: bool):
    M, C = _check(x, "bn_act_normalize", weight=weight, bias=bias)
    _check_sums(x, sums, count, "bn_act_normalize")
    xc = _rows(x)
    y = torch.empty_like(xc, memory_format=torch.channels_last)
    stats = torch.empty((3, C), dtype=torch.float32, device=x.device)  # mean, var, inv
    w, b = _param(weight, "bn_act_normalize"), _param(bias, "bn_act_normalize")
    sc = sums.contiguous()
    err = _fn("tcct_bn_act_normalize")(
        xc.data_ptr(), y.data_ptr(), w.data_ptr(), b.data_ptr(), sc.data_ptr(),
        stats.data_ptr(), M, int(count), C, float(eps), int(leaky), _DTYPES[x.dtype],
        _DTYPES[w.dtype], _DTYPES[b.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"bn_act_normalize {tuple(x.shape)} {x.dtype} leaky={leaky}")
    bn_act_normalize.launches += 1
    return y, stats[:2]


def _normalize_cpu(x, sums, count: int, weight, bias, eps: float, leaky: bool):
    mean, var = stats_from_sums(sums, count)
    return bn_normalize_reference(x, mean, var, weight, bias, eps, leaky), torch.stack([mean, var])


# (y, stats [2, C] f32: mean, var of the count rows the sums cover)
_normalize_op = library.define(
    "bn_act_normalize(Tensor x, Tensor sums, int count, Tensor weight, Tensor bias, float eps, "
    "bool leaky) -> (Tensor, Tensor)",
    cpu=_normalize_cpu, cuda=_normalize_cuda,
    fake=lambda x, sums, count, weight, bias, eps, leaky: (
        _like_y(x), x.new_empty((2, x.shape[1]), dtype=torch.float32)))


def _backward_sums_cuda(x, gy, leaky: bool):
    out = _sums_cuda(x, gy, leaky, True)
    bn_act_backward_sums.launches += 1
    return out


_backward_sums_op = library.define(
    "bn_act_backward_sums(Tensor x, Tensor gy, bool leaky) -> Tensor",
    cpu=lambda x, gy, leaky: bn_backward_sums_reference(x, gy, leaky),
    cuda=_backward_sums_cuda,
    fake=lambda x, gy, leaky: x.new_empty((2, x.shape[1]), dtype=torch.float32))


def _backward_dx_cuda(x, weight, mean, var, gy, sums, count: int, eps: float, leaky: bool):
    M, C = _check(x, "bn_act_backward_dx", weight=weight, mean=mean, var=var)
    _check_sums(x, sums, count, "bn_act_backward_dx")
    if gy.shape != x.shape or gy.dtype != x.dtype or gy.device != x.device:
        raise ValueError(f"bn_act_backward_dx: want gy like x {tuple(x.shape)} {x.dtype}, "
                         f"got {tuple(gy.shape)} {gy.dtype} on {gy.device}")
    xc, gc = _rows(x), _rows(gy)
    dx = torch.empty_like(xc, memory_format=torch.channels_last)
    w = _param(weight, "bn_act_backward_dx")
    m32, v32, sc = mean.float().contiguous(), var.float().contiguous(), sums.contiguous()
    err = _fn("tcct_bn_act_backward_dx")(
        xc.data_ptr(), gc.data_ptr(), dx.data_ptr(), w.data_ptr(), m32.data_ptr(),
        v32.data_ptr(), sc.data_ptr(), M, int(count), C, float(eps), int(leaky),
        _DTYPES[x.dtype], _DTYPES[w.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"bn_act_backward_dx {tuple(x.shape)} {x.dtype} leaky={leaky}")
    bn_act_backward_dx.launches += 1
    return dx


_backward_dx_op = library.define(
    "bn_act_backward_dx(Tensor x, Tensor weight, Tensor mean, Tensor var, Tensor gy, "
    "Tensor sums, int count, float eps, bool leaky) -> Tensor",
    cpu=lambda x, weight, mean, var, gy, sums, count, eps, leaky: _dx_from_sums(
        x, weight, mean, var, gy, sums, count, eps, leaky),
    cuda=_backward_dx_cuda,
    fake=lambda x, weight, mean, var, gy, sums, count, eps, leaky: _like_y(x))

for _op, _what in ((_sums_op, "bn_act_sums"), (_normalize_op, "bn_act_normalize"),
                   (_backward_sums_op, "bn_act_backward_sums"),
                   (_backward_dx_op, "bn_act_backward_dx")):
    library.no_backward(_op, _what)


def bn_act_sums(x: torch.Tensor, leaky: bool = False) -> torch.Tensor:
    """The forward's sums pass (the op ``tcct::bn_act_sums``): [2, C] f32,
    ``sum(t)`` and ``sum(t*t)`` of ``t = act(x)`` per channel.  A CUDA
    tensor launches the first phases of K3 (bitwise its sums), a CPU
    tensor takes :func:`bn_sums_reference`."""
    library.check_device(x, "bn_act_sums")
    return _sums_op(x, bool(leaky))


def bn_act_normalize(x: torch.Tensor, sums: torch.Tensor, count: int, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5, leaky: bool = False):
    """The forward's finish pass (the op ``tcct::bn_act_normalize``): with
    ``sums`` the [2, C] sums of :func:`bn_act_sums` over ``count`` rows (the
    whole batch, added across the ranks), ``(y in x's dtype, mean [C] f32,
    var [C] f32)``, each as K3 forms it from its own sums."""
    library.check_device(x, "bn_act_normalize")
    y, stats = _normalize_op(x, sums, int(count), weight, bias, float(eps), bool(leaky))
    return y, stats[0], stats[1]


def bn_act_backward_sums(x: torch.Tensor, gy: torch.Tensor, leaky: bool = False) -> torch.Tensor:
    """The backward's sums pass (the op ``tcct::bn_act_backward_sums``):
    [2, C] f32, ``sum(gy)`` and ``sum(gy * act(x))`` per channel, bitwise
    K3b's on a CUDA tensor."""
    library.check_device(x, "bn_act_backward_sums")
    return _backward_sums_op(x, gy, bool(leaky))


def bn_act_backward_dx(x: torch.Tensor, weight: torch.Tensor, mean: torch.Tensor,
                       var: torch.Tensor, gy: torch.Tensor, sums: torch.Tensor, count: int,
                       eps: float = 1e-5, leaky: bool = False) -> torch.Tensor:
    """The backward's finish pass (the op ``tcct::bn_act_backward_dx``): dx
    in x's dtype from the forward's ``mean`` and ``var`` and the [2, C]
    backward sums over ``count`` rows (the whole batch)."""
    library.check_device(x, "bn_act_backward_dx")
    return _backward_dx_op(x, weight, mean, var, gy, sums, int(count), float(eps), bool(leaky))


class _BNActTrainSplit(torch.autograd.Function):
    """Train BN over a batch whose rows are split across ranks: the sums
    pass, ``reduce`` (the caller's all-reduce of the [2, C] sums, in place),
    the finish pass; backward the same, with dweight and dbias from this
    rank's own sums (partial gradients, added across the ranks with the
    rest of the gradient) and dx from the reduced ones."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, leaky, count, reduce):
        sums = bn_act_sums(x, leaky)
        if reduce is not None:
            reduce(sums)
        y, mean, var = bn_act_normalize(x, sums, count, weight, bias, eps, leaky)
        ctx.save_for_backward(x, weight, mean, var)
        ctx.conf = (eps, leaky, count, reduce, bias.dtype)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, var = ctx.saved_tensors
        eps, leaky, count, reduce, bias_dtype = ctx.conf
        sums = bn_act_backward_sums(x, gy, leaky)
        dw, db = bn_weight_grads(sums, mean, var, eps, weight.dtype)
        if reduce is not None:
            reduce(sums)
        dx = bn_act_backward_dx(x, weight, mean, var, gy, sums, count, eps, leaky)
        return dx, dw, db.to(bias_dtype), None, None, None, None


def bn_act_train_split(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       eps: float = 1e-5, leaky: bool = False, count: Optional[int] = None,
                       reduce: Optional[Callable[[torch.Tensor], None]] = None):
    """:func:`bn_act_train` through the two-phase entry points, for a batch
    of ``count`` rows (B*H*W; default x's own) of which ``x`` holds some:
    ``reduce(sums)`` adds a [2, C] f32 tensor across the ranks in place
    (None: this rank holds the whole batch).  Returns ``(y, mean, var)``
    of the whole batch; differentiable in x, weight and bias.  At one rank
    bitwise :func:`bn_act_train`'s results and gradients."""
    count = x.numel() // x.shape[1] if count is None else int(count)
    return _BNActTrainSplit.apply(x, weight, bias, float(eps), bool(leaky), count, reduce)


def bn_act_train_flops(x_shape, backward: bool = False) -> int:
    """Operations of K3 (``backward=False``) or K3b on NCHW ``x_shape``:
    about 8 an element forward (the activation, two sums, the normalize),
    12 backward."""
    return (12 if backward else 8) * math.prod(x_shape)


bn_act_train.launches = 0
bn_act_train_backward.launches = 0
bn_act_sums.launches = 0
bn_act_normalize.launches = 0
bn_act_backward_sums.launches = 0
bn_act_backward_dx.launches = 0
