"""Shared building blocks (NCHW tensors in the channels_last format).

Module attribute names follow the reference's torch state-dict paths
(``stem.0.conv.weight``, ``InvRes.norm.running_var``...), so the shipped
checkpoints load with ``load_state_dict`` and
``tcct_tpu.infer.importer.export_torch_state`` can fill this package's
own ``state_dict()``.

Numerics follow the JAX package (``tcct_tpu/models/layers.py``):
- BatchNorm (eps 1e-5) normalises as ``(x - mean) * inv + bias`` in the
  input dtype, with ``inv`` computed in f32; in train mode the batch
  statistics come from the train-BN kernel (``ops/kernels/bnstats.py``)
  and the running statistics follow flax's EMA (momentum 0.9, biased
  variance);
- GELU is the exact erf form in f32 and the tanh form in bf16;
- Hardswish, LeakyReLU(0.01), LayerNorm eps 1e-6;
- a conv whose input is wider than its compute weights (f32 maps after a
  trained gate, bf16 weights) promotes the weights to the input's dtype,
  as flax does (:func:`promoted`), and runs in full f32 (no TF32);
  BatchNorm runs in the input's dtype whatever its weights' type.

Train mode is ``module.train()``.  A train step runs its forward inside
:func:`train_pass`, which hands the model's DropPaths their generator and
collects the new BN running statistics instead of writing them into the
(compute-dtype) buffers the forward reads.  A data-parallel step's pass
also carries the mesh and this rank's rows of the global batch: the train
BatchNorms then take the statistics of the whole batch (the two-phase
kernels and an all-reduce of their sums), and every random draw is made at
the global batch's shape, of which the rank keeps its rows, so each rank's
generator advances as a one-process step's does.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from tcct_tpu_torch.ops.kernels.bnstats import bn_act_train, bn_act_train_split
from tcct_tpu_torch.ops.kernels.dwconv import dwconv3x3
from tcct_tpu_torch.parallel.distributed import Rows
from tcct_tpu_torch.parallel.spatial import pad_columns


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.01)


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)


def promoted(t: Optional[torch.Tensor], x: torch.Tensor) -> Optional[torch.Tensor]:
    """``t`` cast to x's dtype where x's is the wider (a bf16 weight before
    an f32 input), else ``t``: flax's ``promote_dtype``, which the JAX
    package's convs apply to their bf16 compute weights after the gated
    fusion has widened the maps to f32 (``models/ftc.py::gate_fusion``)."""
    if t is None or t.dtype == x.dtype or torch.promote_types(t.dtype, x.dtype) != x.dtype:
        return t
    return t.to(x.dtype)


@contextlib.contextmanager
def full_f32_cudnn(deterministic: bool = False):
    """cuDNN's convs in full f32 (TF32 off), and deterministic if asked,
    whatever the caller has set; the caller's settings come back after."""
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32 = False
    cudnn.deterministic = prev[1] or deterministic
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = prev


class _PromotedConv(torch.autograd.Function):
    """``F.conv2d`` of an input wider than the layer's compute weights (the
    weights already promoted).  Forward and backward run in full f32, TF32
    off whatever the caller set (PyTorch lets cuDNN use TF32 by default):
    the maps a trained gate widens are f32 in the JAX package, and the port
    holds them to its f32 results.  The backward runs cuDNN's deterministic
    algorithms: its default f32 weight-gradient algorithm adds with float
    atomics, so a gated step would not repeat, or resume, bit for bit.  The
    bf16 convs keep cuDNN's default choice, which repeats."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups)
        ctx.bias = b is not None
        with full_f32_cudnn():
            return F.conv2d(x, w, b, stride, padding, dilation, groups)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        wants = ctx.needs_input_grad
        mask = (wants[0], wants[1], ctx.bias and wants[2])
        with full_f32_cudnn(deterministic=True):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                gy, x, w, [w.shape[0]] if ctx.bias else None, stride, padding, dilation, False,
                [0, 0], groups, mask)
        return gx, gw, gb, None, None, None, None


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose depthwise 3x3 (stride 1 or 2, pad 1) runs the
    hand-written depthwise kernel (``ops/kernels/dwconv.py``); every other
    geometry runs ``F.conv2d``.  Same predicate as the JAX package's
    ``MaybePackedConv._dw_pallas_eligible``.

    Under a width shard (``parallel/spatial.py::width_shard``) a conv that
    reads neighbouring columns takes them from the ranks beside it
    (:meth:`halo_columns`) and computes the whole image's conv at the
    rank's columns (:meth:`conv_with_halos`)."""

    width_shard = None  # set by parallel.spatial.width_shard()

    def _depthwise3x3(self, x: torch.Tensor) -> bool:
        return (
            self.kernel_size == (3, 3)
            and self.stride in ((1, 1), (2, 2))
            and self.padding == (1, 1)
            and self.dilation == (1, 1)
            and self.groups == self.out_channels == self.in_channels
            and x.shape[1] == self.in_channels
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(x, residual=False)

    def plus_input(self, x: torch.Tensor) -> torch.Tensor:
        """``conv(x) + x`` (ConvPosEnc): the depthwise kernel adds the bias
        and the input in its own launch, rounded as the separate adds."""
        return self._conv(x, residual=True)

    def halo_columns(self, x: torch.Tensor) -> Tuple[int, int]:
        """Columns beyond a width shard's own that this conv reads, on the
        left and on the right: ``pw`` each side at stride 1 (a SAME conv of
        width ``2 pw + 1``); a 3x3 pad-1 conv at stride 2 reads global
        columns 2j-1 .. 2j+1, one on the left (the depthwise kernel, whose
        own pad assumes column 0 is the image's edge, takes two and drops
        its first output column)."""
        (kw, sw, pw, dw) = (self.kernel_size[1], self.stride[1], self.padding[1],
                            self.dilation[1])
        if sw == 1 and dw == 1 and kw == 2 * pw + 1:
            return pw, pw
        if sw == 2 and dw == 1 and kw == 3 and pw == 1:
            return (2 if self._depthwise3x3(x) else 1), 0
        raise NotImplementedError(f"width shard: no halo rule for a conv of kernel "
                                  f"{self.kernel_size}, stride {self.stride}, padding "
                                  f"{self.padding}, dilation {self.dilation}")

    def conv_with_halos(self, x: torch.Tensor, lh: torch.Tensor, rh: torch.Tensor,
                        residual: bool = False) -> torch.Tensor:
        """The conv of the whole image (``+ x`` with ``residual``) at a
        width shard's columns, from its block ``x`` (NCHW) and the NHWC halo
        columns :meth:`halo_columns` asks for.  The depthwise kernel runs
        on the widened input, its extra output columns cropped; ``F.conv2d``
        runs with no width padding."""
        stride = self.stride[1]
        if stride == 2:
            self.width_shard.require_even(x.shape[3], "a stride-2 conv")
        xe = pad_columns(x, lh, rh)
        if self._depthwise3x3(x):
            taps = self.weight[:, 0].permute(1, 2, 0).to(x.dtype)
            bias = None if self.bias is None else self.bias.to(x.dtype)
            y = dwconv3x3(xe.permute(0, 2, 3, 1), taps, stride, bias, residual)
            y = y[:, :, 1:-1] if stride == 1 else y[:, :, 1:]
            return y.contiguous().permute(0, 3, 1, 2)
        w = promoted(self.weight, x)
        args = (promoted(self.bias, x), self.stride, (self.padding[0], 0), self.dilation,
                self.groups)
        y = F.conv2d(xe, w, *args) if w is self.weight else _PromotedConv.apply(xe, w, *args)
        return y + x if residual else y

    def _conv(self, x: torch.Tensor, residual: bool) -> torch.Tensor:
        shard = self.width_shard
        if shard is not None and self.kernel_size[1] * self.stride[1] > 1:
            left, right = self.halo_columns(x)
            return self.conv_with_halos(x, *shard.halos(x.permute(0, 2, 3, 1), left, right),
                                        residual)
        if not self._depthwise3x3(x):
            w = promoted(self.weight, x)
            if w is self.weight:
                y = self._conv_forward(x, w, self.bias)
            else:
                y = _PromotedConv.apply(x, w, promoted(self.bias, x), self.stride, self.padding,
                                        self.dilation, self.groups)
            return y + x if residual else y
        taps = self.weight[:, 0].permute(1, 2, 0).to(x.dtype)  # [C,1,3,3] -> [3,3,C]
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return dwconv3x3(x.permute(0, 2, 3, 1), taps, self.stride[0], bias,
                         residual).permute(0, 3, 1, 2)


class _TrainPass:
    """What one train-mode forward shares with its BN and DropPath modules
    (and a gated FTC's fusion, and the RegNet's loss heads)."""

    def __init__(self, generator: Optional[torch.Generator], mesh=None,
                 rows: Optional[Rows] = None):
        self.generator = generator
        self.new_stats: Dict[nn.Module, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.mesh = mesh  # a parallel.DataMesh: the BNs take the two-phase kernels
        self.rows = rows  # this rank's rows of the global batch
        self.whole = rows is None  # the tensors in flight hold the whole batch

    def draw_rows(self, b: int) -> Rows:
        """The rows of a draw over the batch axis of a tensor of ``b`` rows:
        draw ``total`` rows, keep ``[start:stop)``."""
        if self.whole:
            return Rows(0, b, b)
        if self.rows.stop - self.rows.start != b:
            raise ValueError(f"train_pass: a tensor of {b} rows in a pass over rows "
                             f"[{self.rows.start}, {self.rows.stop}) of {self.rows.total}")
        return self.rows

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole batch of this rank's rows ``t`` (differentiable into
        them), or ``t`` itself where the pass already holds the whole batch."""
        return t if self.whole else self.mesh.gather_rows(t)

    @contextlib.contextmanager
    def whole_batch(self):
        """Inside the block the tensors in flight hold the whole batch on
        every rank (the loss heads after :meth:`gather`): BNs sum them
        without an all-reduce, draws cover them whole."""
        prev = self.whole
        self.whole = True
        try:
            yield
        finally:
            self.whole = prev


@contextlib.contextmanager
def train_pass(model: nn.Module, generator: Optional[torch.Generator] = None, mesh=None,
               rows: Optional[Rows] = None):
    """One train-mode forward of ``model``: its DropPaths (and a gated FTC's
    fusion, ``models/ftc.py``) draw from ``generator``, and each of its
    train-mode BatchNorms puts its new running statistics (f32 ``(mean,
    var)``) into the yielded dict, keyed by module, instead of updating its
    buffers.  A BN run twice in the pass updates from its first result, as
    flax's mutable ``batch_stats`` does.  The modules that take part are
    those whose class declares a ``train_pass`` attribute.

    With ``mesh`` (a ``parallel.DataMesh``) and ``rows`` (a
    ``parallel.Rows``) the input holds this rank's rows of the global
    batch: the BNs run the two-phase kernels, all-reduce their sums over
    the mesh and divide by the global count, and the draws are made for the
    whole batch, the rank keeping its rows."""
    if mesh is not None:
        mesh.require_data_only("train_pass")
    ctx = _TrainPass(generator, mesh, rows)
    mods = [m for m in model.modules() if hasattr(type(m), "train_pass")]
    for m in mods:
        m.train_pass = ctx
    try:
        yield ctx.new_stats
    finally:
        for m in mods:
            m.train_pass = None


def conv2d(cin: int, cout: int, kernel_size=3, stride=1, padding=None, groups=1,
           bias=True) -> Conv2d:
    """torch-style constructor with the reference's default padding k//2."""
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size, kernel_size)
    if padding is None:
        padding = (kernel_size[0] // 2, kernel_size[1] // 2)
    return Conv2d(cin, cout, kernel_size, stride, padding, groups=groups, bias=bias)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm in the JAX package's expression order:
    ``inv = rsqrt(var + eps) * weight`` in f32, then
    ``(x - mean) * inv + bias`` in the input dtype.

    ``leaky=True`` applies LeakyReLU(0.01) first (the CrossCNN blocks'
    LeakyReLU-then-BN).  Train mode normalises with the batch statistics
    through :func:`bn_act_train` (one fused kernel on the card) and moves
    the running statistics by flax's EMA:
    ``0.9 * running + 0.1 * batch``, with the biased batch variance."""

    MOMENTUM = 0.9  # flax's convention; torch's momentum 0.1
    train_pass: Optional[_TrainPass] = None  # set by train_pass()

    def forward(self, x: torch.Tensor, leaky: bool = False) -> torch.Tensor:
        if self.training:
            ctx = self.train_pass
            if ctx is None or ctx.mesh is None:
                y, mean, var = bn_act_train(x, self.weight, self.bias, self.eps, leaky)
            else:  # a data-parallel pass: the statistics of the whole batch
                rows = ctx.draw_rows(x.shape[0])
                count = x.numel() // x.shape[1] * rows.total // (rows.stop - rows.start)
                y, mean, var = bn_act_train_split(
                    x, self.weight, self.bias, self.eps, leaky, count,
                    None if ctx.whole else ctx.mesh.all_reduce_)
            self._update_running_stats(mean, var)
            return y
        if leaky:
            x = leaky_relu(x)
        dt = x.dtype
        inv = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        return ((x - self.running_mean.to(dt)[:, None, None]) * inv.to(dt)[:, None, None]
                + self.bias.to(dt)[:, None, None])

    @torch.no_grad()
    def _update_running_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.MOMENTUM
        if self.train_pass is not None:
            stats = self.train_pass.new_stats
            old = stats.get(self, (self.running_mean, self.running_var))
            stats[self] = (m * old[0].float() + (1 - m) * mean, m * old[1].float() + (1 - m) * var)
        else:
            self.running_mean.copy_(m * self.running_mean.float() + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var.float() + (1 - m) * var)


class ConvBN(nn.Module):
    """Conv(bias=False) + BN + optional act (reference tcct.py:55-97)."""

    def __init__(self, cin, cout, kernel_size=1, stride=1, pad=0, groups=1, act=None):
        super().__init__()
        self.conv = conv2d(cin, cout, kernel_size, stride, pad, groups=groups, bias=False)
        self.bn = BatchNorm2d(cout)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act is not None else x


class DWConvBN(nn.Module):
    """Depthwise + pointwise conv + BN + act (reference tcct.py:99-147)."""

    def __init__(self, cin, cout, kernel_size=1, stride=1, act=F.hardswish):
        super().__init__()
        self.dwconv = conv2d(cin, cout, kernel_size, stride, (kernel_size - 1) // 2,
                             groups=cout, bias=False)
        self.pwconv = conv2d(cout, cout, 1, 1, 0, bias=False)
        self.bn = BatchNorm2d(cout)
        self.act = act

    def forward(self, x):
        x = self.bn(self.pwconv(self.dwconv(x)))
        return self.act(x) if self.act is not None else x


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2 (reference tcct.py:29-53)."""

    def __init__(self, dim, hidden, out):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class DropPath(nn.Module):
    """Stochastic depth per sample (timm DropPath; JAX counterpart
    ``tcct_tpu/models/layers.py::DropPath``): in train mode each sample is
    kept with probability ``1 - rate`` and scaled by ``1 / (1 - rate)``,
    the mask drawn from :func:`train_pass`'s generator (for the global
    batch, of which a data-parallel rank keeps its rows).  The identity in
    eval mode or at rate 0."""

    train_pass: Optional[_TrainPass] = None  # set by train_pass()

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        gen = self.train_pass.generator if self.train_pass is not None else None
        if gen is None:
            raise ValueError("DropPath in train mode draws from train_pass(model, generator); "
                             "none is set")
        keep = 1.0 - self.rate
        rows = self.train_pass.draw_rows(x.shape[0])
        shape = (rows.total,) + (1,) * (x.dim() - 1)
        mask = (torch.rand(shape, generator=gen, device=x.device) < keep)[rows.start:rows.stop]
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class ResBlock(nn.Module):
    """Conv-BN-act / depthwise / Conv-BN residual (reference tcct.py:518-572)."""

    def __init__(self, features):
        super().__init__()
        self.conv1 = ConvBN(features, features, act=F.hardswish)
        self.dwconv = conv2d(features, features, 3, 1, 1, groups=features, bias=False)
        self.norm = BatchNorm2d(features)
        self.conv2 = ConvBN(features, features)

    def forward(self, x):
        y = self.conv1(x)
        y = F.hardswish(self.norm(self.dwconv(y)))
        return x + self.conv2(y)


def trunc_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], by redrawing what falls outside."""
    z = torch.randn(shape, generator=generator)
    while True:
        out = z.abs() > 2.0
        n = int(out.sum())
        if n == 0:
            return z
        z[out] = torch.randn(n, generator=generator)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init with the JAX package's initialisers: convs
    He-normal over fan_out (``normal(0, sqrt(2 / (cout*kh*kw)))``), dense
    layers truncated-normal(0.02), biases 0, norms weight 1 / bias 0,
    BN statistics mean 0 / var 1.  Draws come from ``generator`` in module
    order, so one seed gives one set of weights on any device."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            cout, _, kh, kw = m.weight.shape
            std = (2.0 / (cout * kh * kw)) ** 0.5
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            m.weight.copy_(trunc_normal(m.weight.shape, generator) * 0.02)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return module
