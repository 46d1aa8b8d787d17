"""Depthwise 3x3 convolution (stride 1 or 2, SAME): hand-written CUDA
kernels (``csrc/dwconv3x3.cu``), forward and fused backward, and their
plain PyTorch versions.

Replaces the TPU kernels ``tcct_tpu/ops/pallas/dwconv.py::_fwd_kernel``
(``pallas_call`` at dwconv.py:200), ``::_fwd_kernel_s2`` (dwconv.py:380),
``::_bwd_kernel`` (dwconv.py:220) and ``::_bwd_kernel_s2`` (dwconv.py:420).
The kernels are memory-bound; see the source's header note for their
design.

:func:`dwconv3x3` is a ``torch.autograd.Function``: its forward launches
the forward kernel (:func:`dwconv3x3_forward`) and its backward the fused
backward kernel, one launch that reads ``x`` and ``g`` once and gives
``dx`` (plus ``g`` at the ConvPosEnc site), the nine ``dw`` taps and the
bias gradient.  The forward can add a bias and the input itself
(``conv(x) + bias + x``, the ConvPosEnc site) in the same launch, rounded
as the three separate passes round.  On a CPU tensor the same function
runs the plain forward and the plain backward.  The forward op's ``out``
overload (``tcct::dwconv3x3.out``, the arguments then ``y``) launches the
same kernel into a given output.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from tcct_tpu_torch.ops.kernels import build, library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def dwconv3x3_reference(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Plain version: NHWC x [B,H,W,C], taps w [3,3,C] -> [B,Ho,Wo,C],
    a grouped ``conv2d`` in f32 on the NCHW view, cast to x's dtype."""
    C = x.shape[-1]
    xc = x.permute(0, 3, 1, 2).float()
    wc = w.permute(2, 0, 1).unsqueeze(1).float()  # [C, 1, 3, 3]
    y = F.conv2d(xc, wc, stride=stride, padding=1, groups=C)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _tap_views(v: torch.Tensor, a: int, t: int, stride: int, Ho: int, Wo: int) -> torch.Tensor:
    """Rows a, a+s, ..., columns t, t+s, ... of a tensor padded to cover
    input rows -1 .. s*(Ho-1)+1: the input pixels that tap (a, t) meets."""
    return v[:, a:a + stride * (Ho - 1) + 1:stride, t:t + stride * (Wo - 1) + 1:stride]


def dwconv3x3_backward_reference(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                                 stride: int = 1, *, bias: bool = False, residual: bool = False,
                                 need_dx: bool = True):
    """Plain backward of :func:`dwconv3x3` for the output gradient ``g``
    [B,Ho,Wo,C]: ``(dx [B,H,W,C] in x's dtype, dw [3,3,C] in w's dtype,
    db [C] in g's dtype)``.  Nine shifted multiply-adds in f32, as the
    kernel forms them: ``dx`` scatters ``g * w[a, t]`` onto the input pixels
    of tap (a, t), ``dw[a, t]`` sums ``x * g`` over those pixels.
    ``residual`` (the gradient of ``conv(x) + x``) adds ``g`` to ``dx`` in
    x's dtype; ``bias`` gives ``db``, ``g`` summed over the pixels in f32
    (else None); ``need_dx=False`` gives no ``dx`` (None)."""
    B, H, W, C = x.shape
    Ho, Wo = g.shape[1], g.shape[2]
    Hp, Wp = stride * (Ho - 1) + 3, stride * (Wo - 1) + 3
    xf, wf, gf = x.float(), w.float(), g.float()
    xp = F.pad(xf, (0, 0, 1, Wp - W - 1, 1, Hp - H - 1))
    dxp = xf.new_zeros((B, Hp, Wp, C))
    dw = xf.new_zeros((3, 3, C))
    for a in range(3):
        for t in range(3):
            if need_dx:
                _tap_views(dxp, a, t, stride, Ho, Wo).add_(gf * wf[a, t])
            dw[a, t] = (_tap_views(xp, a, t, stride, Ho, Wo) * gf).sum((0, 1, 2))
    dx = dxp[:, 1:H + 1, 1:W + 1].to(x.dtype) if need_dx else None
    if dx is not None and residual:
        dx = dx + g
    db = gf.sum((0, 1, 2)).to(g.dtype) if bias else None
    return dx, dw.to(w.dtype), db


@functools.cache
def _fn(name: str):
    """A C entry point of the library, typed (built and loaded on first use)."""
    lib = build.load("dwconv3x3")
    fn = getattr(lib, name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "tcct_dwconv3x3_fwd":
        fn.argtypes = [p, p, p, p] + [i] * 8 + [p]
        fn.restype = i
    elif name == "tcct_dwconv3x3_bwd_workspace":
        fn.argtypes = [p, p] + [i] * 6
        fn.restype = ctypes.c_longlong
    else:  # tcct_dwconv3x3_bwd
        fn.argtypes = [p] * 7 + [i] * 7 + [p]
        fn.restype = i
    return fn


def _check(x: torch.Tensor, w: torch.Tensor, stride: int, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"{what}: want NHWC float32/bfloat16, got {tuple(x.shape)} {x.dtype}")
    C = x.shape[-1]
    if tuple(w.shape) != (3, 3, C) or w.dtype != x.dtype or w.device != x.device:
        raise ValueError(f"{what}: want taps [3,3,{C}] {x.dtype} on {x.device}, got "
                         f"{tuple(w.shape)} {w.dtype} on {w.device}")


def _check_forward(x, w, stride, bias, residual, rows) -> None:
    if stride not in (1, 2):
        raise ValueError(f"dwconv3x3: stride must be 1 or 2, got {stride}")
    if stride != 1 and (residual or rows > 0):
        raise ValueError("dwconv3x3: residual=True and rows > 0 need stride 1")
    C = x.shape[-1]
    if bias is not None and (tuple(bias.shape) != (C,) or bias.dtype != x.dtype
                             or bias.device != x.device):
        raise ValueError(f"dwconv3x3: want bias [{C}] {x.dtype} on {x.device}, got "
                         f"{tuple(bias.shape)} {bias.dtype} on {bias.device}")


def _out_shape(x, stride: int):
    B, H, W, C = x.shape
    return B, (H - 1) // stride + 1, (W - 1) // stride + 1, C


def _forward_cpu(x, w, bias, stride: int, residual: bool, rows: int):
    _check_forward(x, w, stride, bias, residual, rows)
    y = dwconv3x3_reference(x, w, stride)
    if bias is not None:
        y = y + bias
    return (y + x if residual else y).contiguous()


def _forward_cuda(x, w, bias, stride: int, residual: bool, rows: int, y=None):
    """The forward's launch, into ``y`` where it is given (the ``out``
    overload)."""
    _check_forward(x, w, stride, bias, residual, rows)
    _check(x, w, stride, "dwconv3x3")
    B, H, W, C = x.shape
    x = x.contiguous()
    w = w.contiguous()
    if y is None:
        y = x.new_empty(_out_shape(x, stride))
    else:
        library.check_out("dwconv3x3", y, _out_shape(x, stride), x)
    if y.numel() == 0:
        return y
    bias_ptr = None if bias is None else bias.contiguous().data_ptr()
    err = _fn("tcct_dwconv3x3_fwd")(x.data_ptr(), w.data_ptr(), bias_ptr, y.data_ptr(), B, H, W,
                                    C, stride, _DTYPES[x.dtype], int(residual), rows,
                                    torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"dwconv3x3 {tuple(x.shape)} stride {stride} {x.dtype}")
    dwconv3x3.launches += 1
    dwconv3x3.launches_s2 += stride == 2
    return y


def _forward_fake(x, w, bias, stride: int, residual: bool, rows: int):
    return x.new_empty(_out_shape(x, stride))


_forward_op = library.define(
    "dwconv3x3(Tensor x, Tensor w, Tensor? bias, int stride, bool residual, int rows) -> Tensor",
    cpu=_forward_cpu, cuda=_forward_cuda, fake=_forward_fake)
library.define_out(_forward_op, "Tensor(a!) y", cuda=_forward_cuda, outputs=_forward_fake)


def dwconv3x3_forward(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                      bias: Optional[torch.Tensor] = None, residual: bool = False,
                      rows: int = 0) -> torch.Tensor:
    """``dwconv3x3_reference(x, w, stride) + bias + x`` (the last two
    optional): NHWC [B,H,W,C] -> [B,Ho,Wo,C], the op ``tcct::dwconv3x3``.
    The sum is rounded to x's dtype first, then the bias [C] and the input
    are added, each as an f32 add with a rounding of its own, so the result
    equals the three passes bit for bit.  ``residual`` needs stride 1.

    A CPU tensor takes the plain versions; a CUDA tensor launches the
    forward kernel once, or the call raises.  ``rows > 0`` (stride 1) names
    the ring kernel's strip height and ``rows < 0`` the direct kernel, for
    tests and measurements; 0 lets the launch pick kernel and strip."""
    library.check_device(x, "dwconv3x3")
    return _forward_op(x, w, bias, int(stride), bool(residual), int(rows))


# the backward's block partials: a buffer a device, replaced by a larger one
# when a call needs more.  The launch allocates nothing, so a CUDA graph can
# capture it; a replaced buffer is kept alive, since a captured graph may
# still write to it.
_workspaces = {}


def _workspace(x: torch.Tensor, g: torch.Tensor, stride: int) -> torch.Tensor:
    B, H, W, C = x.shape
    n = _fn("tcct_dwconv3x3_bwd_workspace")(x.data_ptr(), g.data_ptr(), B, H, W, C, stride,
                                            _DTYPES[x.dtype])
    if n < 0:
        build.check(int(-n), f"dwconv3x3_backward {tuple(x.shape)} stride {stride} {x.dtype}")
    bufs = _workspaces.setdefault(x.device, [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.empty(max(n, 1), dtype=torch.float32, device=x.device))
    return bufs[-1]


def _check_backward(stride: int, residual: bool) -> None:
    if stride not in (1, 2):
        raise ValueError(f"dwconv3x3_backward: stride must be 1 or 2, got {stride}")
    if residual and stride != 1:
        raise ValueError("dwconv3x3_backward: residual=True needs stride 1")


def _backward_cpu(x, w, g, stride: int, bias: bool, residual: bool, need_dx: bool):
    _check_backward(stride, residual)
    dx, dw, db = dwconv3x3_backward_reference(x, w, g, stride, bias=bias, residual=residual,
                                              need_dx=need_dx)
    return (x.new_empty(0) if dx is None else dx.contiguous(), dw.contiguous(),
            g.new_empty(0) if db is None else db)


def _backward_cuda(x, w, g, stride: int, bias: bool, residual: bool, need_dx: bool):
    _check_backward(stride, residual)
    _check(x, w, stride, "dwconv3x3_backward")
    B, H, W, C = x.shape
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    if tuple(g.shape) != (B, Ho, Wo, C) or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"dwconv3x3_backward: want g [{B},{Ho},{Wo},{C}] {x.dtype}, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    x, w, g = x.contiguous(), w.contiguous(), g.contiguous()
    dx = torch.empty_like(x) if need_dx else x.new_empty(0)
    dw = torch.empty_like(w)
    db = g.new_empty((C,) if bias else (0,))
    if x.numel() == 0:
        return dx, dw.zero_(), db.zero_()
    part = _workspace(x, g, stride)
    err = _fn("tcct_dwconv3x3_bwd")(
        x.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr() if need_dx else None,
        dw.data_ptr(), db.data_ptr() if bias else None, part.data_ptr(), B, H, W, C,
        stride, _DTYPES[x.dtype], int(residual), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"dwconv3x3_backward {tuple(x.shape)} stride {stride} {x.dtype}")
    dwconv3x3_backward.launches += 1
    dwconv3x3_backward.launches_s2 += stride == 2
    return dx, dw, db


def _backward_fake(x, w, g, stride: int, bias: bool, residual: bool, need_dx: bool):
    return (torch.empty_like(x, memory_format=torch.contiguous_format) if need_dx
            else x.new_empty(0), torch.empty_like(w, memory_format=torch.contiguous_format),
            g.new_empty((x.shape[-1],) if bias else (0,)))


# dx and db are empty tensors where they are not wanted: an op returns no None
_backward_op = library.define(
    "dwconv3x3_backward(Tensor x, Tensor w, Tensor g, int stride, bool bias, bool residual, "
    "bool need_dx) -> (Tensor, Tensor, Tensor)",
    cpu=_backward_cpu, cuda=_backward_cuda, fake=_backward_fake)


def dwconv3x3_backward(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, stride: int = 1, *,
                       bias: bool = False, residual: bool = False, need_dx: bool = True):
    """Gradients of :func:`dwconv3x3` for the output gradient ``g``
    [B,Ho,Wo,C]: ``(dx [B,H,W,C] in x's dtype, dw [3,3,C] in w's dtype,
    db [C] in g's dtype)``, ``dw`` and ``db`` summed in f32 in a fixed
    order and cast once (the op ``tcct::dwconv3x3_backward``).
    ``residual`` (stride 1) adds ``g`` to ``dx``, rounded as the plain add
    rounds; ``bias`` forms ``db``, the sum of ``g`` over the pixels (else
    None); ``need_dx=False`` forms no ``dx`` (None).

    A CPU tensor takes the plain version; a CUDA tensor launches the fused
    backward kernel once, or the call raises."""
    library.check_device(x, "dwconv3x3_backward")
    dx, dw, db = _backward_op(x, w, g, int(stride), bool(bias), bool(residual), bool(need_dx))
    return dx if need_dx else None, dw, db if bias else None


class _DWConv3x3Autograd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, stride, residual, rows):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.residual = stride, residual
        return library.below_autograd(_forward_op, x, w, bias, stride, residual, rows)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx, dw, db = dwconv3x3_backward(x, w, g, ctx.stride, bias=need_b,
                                        residual=ctx.residual, need_dx=need_x)
        return dx, dw if need_w else None, db, None, None, None


library.autograd(_forward_op, _DWConv3x3Autograd)


def dwconv3x3(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              bias: Optional[torch.Tensor] = None, residual: bool = False) -> torch.Tensor:
    """Depthwise 3x3 correlation, SAME zero padding, stride 1 or 2, f32
    accumulation: NHWC [B,H,W,C] x [3,3,C] -> [B,Ho,Wo,C], optionally
    ``+ bias`` [C] and ``+ x`` (``residual``, stride 1) in the same launch
    (see :func:`dwconv3x3_forward`).  Differentiable in x, w and bias: the
    backward is one :func:`dwconv3x3_backward` call, which also adds ``g``
    for the residual and sums ``g`` for the bias, and forms no ``dx`` when
    autograd does not ask for it.

    A CPU tensor takes the plain versions; a CUDA tensor launches the
    kernels, or the call raises."""
    return dwconv3x3_forward(x, w, stride, bias, residual)


def dwconv3x3_flops(x_shape, stride: int, backward: bool = False) -> int:
    """Operations of K2 (``backward=False``) or K2b on NHWC ``x_shape``:
    a multiply and an add a tap for each output element, 18; the backward
    as many again for ``dw`` beside ``dx``."""
    B, H, W, C = x_shape
    n_out = B * ((H - 1) // stride + 1) * ((W - 1) // stride + 1) * C
    return (36 if backward else 18) * n_out


# launches of the forward / backward kernel, all strides and stride 2 only
dwconv3x3.launches = 0
dwconv3x3.launches_s2 = 0
dwconv3x3_backward.launches = 0
dwconv3x3_backward.launches_s2 = 0
