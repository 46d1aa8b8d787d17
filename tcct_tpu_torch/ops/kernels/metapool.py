"""MetaPool token mixer: hand-written CUDA kernels (``csrc/metapool.cu``),
forward and backward, the serving block's MetaPool site in one launch, and
their plain PyTorch versions.

Replaces the TPU kernels ``tcct_tpu/ops/pallas/metapool.py::_kernel`` and
``::_bwd_kernel`` (both through ``pallas_call`` at metapool.py:64; the
backward is that file's custom VJP).  The kernels are memory-bound (one
read and one write per element); see the source's header note for their
design.  Unlike the TPU kernel they have no size budget: every stage of
every geometry runs through them.

:func:`metapool_tokens` calls the op ``tcct::metapool_tokens``, whose
CUDA implementation launches the forward kernel and whose autograd formula
(``_MetaPoolAutograd``) calls the op ``tcct::metapool_tokens_backward``
(the backward kernel).  On a CPU tensor the same ops run the plain forward
and the plain backward.
:func:`metapool_block` (``tcct::metapool_block``) is the eval block's
whole token pass around the mixer (``norm1``, the mixer, the residual add,
``norm2``) as one launch of the same forward kernel with flags; it has no
backward.  Its ``out`` overload (``tcct::metapool_block.out``, the
arguments then ``y`` and ``n2``) launches the same kernel into given
outputs.
:func:`metapool_block_shard` (``tcct::metapool_block_shard``) is the same
site on a width shard of the token grid, its row ends' neighbours taken
from two exchanged halo columns.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from tcct_tpu_torch.ops.kernels import build, library
from tcct_tpu_torch.ops.pool import (
    _axis_counts,
    metapool_tokens_backward_reference,
    metapool_tokens_reference,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# flags of tcct_metapool_block
_NORMS, _RESIDUAL = 1, 2


@functools.cache
def _fn(name: str):
    """The C entry point ``name`` of the library, typed (built and loaded
    on first use)."""
    fn = getattr(build.load("metapool"), name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "tcct_metapool_block":
        fn.argtypes = [p] * 7 + [i] * 5 + [ctypes.c_float, p]
    elif name == "tcct_metapool_block_shard":
        fn.argtypes = [p] * 9 + [i] * 6 + [ctypes.c_float, p]
    else:
        fn.argtypes = [p, p, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check_tokens(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 3 or x.dtype not in _DTYPES:
        raise ValueError(f"{what}: want [B,N,C] float32/bfloat16, got {tuple(x.shape)} {x.dtype}")


def _launch(entry: str, x: torch.Tensor, what: str) -> torch.Tensor:
    _check_tokens(x, what)
    B, N, C = x.shape
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    err = _fn(entry)(x.data_ptr(), y.data_ptr(), B, N, C, _DTYPES[x.dtype],
                     torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"{what} {tuple(x.shape)} {x.dtype}")
    return y


def _tokens_cuda(x: torch.Tensor) -> torch.Tensor:
    y = _launch("tcct_metapool_fwd", x, "metapool_tokens")
    metapool_tokens.launches += 1
    return y


def _tokens_backward_cuda(g: torch.Tensor) -> torch.Tensor:
    dx = _launch("tcct_metapool_bwd", g, "metapool_tokens_backward")
    metapool_tokens_backward.launches += 1
    return dx


def _like(x: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x, memory_format=torch.contiguous_format)


_tokens_op = library.define("metapool_tokens(Tensor x) -> Tensor",
                            cpu=lambda x: metapool_tokens_reference(x).contiguous(),
                            cuda=_tokens_cuda, fake=_like)
_tokens_backward_op = library.define(
    "metapool_tokens_backward(Tensor g) -> Tensor",
    cpu=lambda g: metapool_tokens_backward_reference(g).contiguous(),
    cuda=_tokens_backward_cuda, fake=_like)


def metapool_tokens_backward(g: torch.Tensor) -> torch.Tensor:
    """Gradient of :func:`metapool_tokens` for the output gradient ``g``
    [B, N, C]: ``window_sum(g / count) - g``, f32 inside, in g's dtype
    (the op ``tcct::metapool_tokens_backward``).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    backward kernel, or the call raises."""
    library.check_device(g, "metapool_tokens_backward")
    return _tokens_backward_op(g)


class _MetaPoolAutograd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return library.below_autograd(_tokens_op, x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return metapool_tokens_backward(g)


library.autograd(_tokens_op, _MetaPoolAutograd)


def metapool_tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, N, C] -> [B, N, C]: ``AvgPool2d(3,1,1,count_include_pad=False)
    - x`` over the (token, channel) axes, f32 inside, cast to x's dtype
    (the op ``tcct::metapool_tokens``).  Differentiable: the backward is
    :func:`metapool_tokens_backward`.

    A CPU tensor takes the plain versions; a CUDA tensor launches the
    kernels, or the call raises."""
    library.check_device(x, "metapool_tokens")
    return _tokens_op(x)


def metapool_flops(shape) -> int:
    """Operations of K1 or K1b on [B, N, C]: the 3x3 window's 8 adds, the
    division and the subtraction, about 11 an element."""
    return 11 * math.prod(shape)


def metapool_block_reference(x: torch.Tensor, w1: Optional[torch.Tensor] = None,
                             b1: Optional[torch.Tensor] = None,
                             w2: Optional[torch.Tensor] = None,
                             b2: Optional[torch.Tensor] = None, eps: float = 1e-6,
                             residual: bool = True
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of :func:`metapool_block`: the separate passes
    ``F.layer_norm -> metapool_tokens_reference -> add -> F.layer_norm``,
    each rounded to x's dtype, as the eval block runs them."""
    C = x.shape[-1]
    norms = _norms(w1, b1, w2, b2)
    n = F.layer_norm(x, (C,), w1, b1, eps) if norms else x
    y = metapool_tokens_reference(n)
    if residual:
        y = x + y
    return y, (F.layer_norm(y, (C,), w2, b2, eps) if norms else None)


def _norms(*affine) -> bool:
    """Whether the site's two LayerNorms are on: all four weights given."""
    given = [t is not None for t in affine]
    if any(given) and not all(given):
        raise ValueError("metapool_block: the two LayerNorms need w1, b1, w2 and b2 together")
    return all(given)


def _block_cuda(x, w1, b1, w2, b2, eps: float, residual: bool, y=None, n2=None):
    """The site's launch, into ``y`` and ``n2`` where they are given (the
    ``out`` overload)."""
    norms = _norms(w1, b1, w2, b2)
    what = "metapool_block"
    _check_tokens(x, what)
    B, N, C = x.shape
    affine = [w1, b1, w2, b2] if norms else []
    for t in affine:
        if t.shape != (C,) or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{what}: LayerNorm weights must be [{C}] {x.dtype} on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    x = x.contiguous()
    w1, b1, w2, b2 = (t.contiguous() if t is not None else None for t in (w1, b1, w2, b2))
    if y is None:
        y = torch.empty_like(x)
        n2 = torch.empty_like(x) if norms else x.new_empty(0)
    else:
        for t in (y, n2) if norms else (y,):
            library.check_out(what, t, x.shape, x)
    if x.numel() == 0:
        return y, n2
    flags = (_NORMS if norms else 0) | (_RESIDUAL if residual else 0)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    err = _fn("tcct_metapool_block")(
        x.data_ptr(), ptr(w1), ptr(b1), ptr(w2), ptr(b2), y.data_ptr(),
        n2.data_ptr() if norms else None, B, N, C, _DTYPES[x.dtype], flags, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"{what} {tuple(x.shape)} {x.dtype} flags {flags}")
    metapool_block.launches += 1
    return y, n2


def _block_cpu(x, w1, b1, w2, b2, eps: float, residual: bool):
    y, n2 = metapool_block_reference(x, w1, b1, w2, b2, eps, residual)
    return y.contiguous(), x.new_empty(0) if n2 is None else n2.contiguous()


def _block_fake(x, w1, b1, w2, b2, eps: float, residual: bool):
    return _like(x), _like(x) if _norms(w1, b1, w2, b2) else x.new_empty(0)


# n2 is an empty tensor without the LayerNorms: an op returns no None
_block_op = library.define(
    "metapool_block(Tensor x, Tensor? w1, Tensor? b1, Tensor? w2, Tensor? b2, float eps, "
    "bool residual) -> (Tensor, Tensor)", cpu=_block_cpu, cuda=_block_cuda, fake=_block_fake)
library.no_backward(_block_op, "metapool_block")
library.define_out(_block_op, "Tensor(a!) y, Tensor(b!) n2", cuda=_block_cuda,
                   outputs=_block_fake)


def metapool_block(x: torch.Tensor, w1: Optional[torch.Tensor] = None,
                   b1: Optional[torch.Tensor] = None, w2: Optional[torch.Tensor] = None,
                   b2: Optional[torch.Tensor] = None, eps: float = 1e-6, residual: bool = True
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The MetaPool site of the eval block on [B, N, C] tokens, in one
    launch of the forward kernel (the op ``tcct::metapool_block``):

        n  = LayerNorm1(x)        (w1, b1)
        a  = metapool(n)          rounded once, as metapool_tokens
        y  = x + a                (residual; else y = a)
        n2 = LayerNorm2(y)        (w2, b2)

    With no weights (all four None) both LayerNorms are skipped: n = x and
    n2 is None.

    Returns ``(y, n2)``.  Each LayerNorm takes its statistics per token in
    f32 and rounds its output to x's dtype, as ``nn.LayerNorm`` does; the
    weights are [C] in x's dtype.  With no LayerNorm and no residual the
    kernel is exactly :func:`metapool_tokens`'s; ``residual`` alone gives
    ``metapool_tokens(x) + x`` bit for bit.

    Inference only: raises if autograd would want a gradient.  A CPU tensor
    takes the plain version (:func:`metapool_block_reference`); a CUDA
    tensor launches the kernel, or the call raises."""
    norms = _norms(w1, b1, w2, b2)
    library.check_device(x, "metapool_block")
    y, n2 = _block_op(x, w1, b1, w2, b2, float(eps), bool(residual))
    return y, n2 if norms else None


def metapool_block_flops(shape) -> int:
    """Operations of the site on [B, N, C]: the two LayerNorms about 8 an
    element each, the window about 12, the residual add."""
    return 30 * math.prod(shape)


# --- the site on a width shard ---------------------------------------------------------

# flags of tcct_metapool_block_shard
_FIRST, _LAST = 1, 2


def _check_shard(x, left, right, affine) -> int:
    """The rows H of the token grid of a shard's [B, H*w, C] tokens, from
    its [B, H, C] halos; raises for halos or LayerNorm weights that do not
    fit the tokens."""
    what = "metapool_block_shard"
    if x.dim() != 3 or left.dim() != 3 or left.shape != right.shape:
        raise ValueError(f"{what}: want x [B, H*w, C] and halos [B, H, C], got "
                         f"{tuple(x.shape)}, {tuple(left.shape)}, {tuple(right.shape)}")
    B, N, C = x.shape
    H = left.shape[1]
    if left.shape[0] != B or left.shape[2] != C or H == 0 or N % H or N == 0:
        raise ValueError(f"{what}: halos {tuple(left.shape)} do not fit tokens {tuple(x.shape)}")
    for t in (left, right):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{what}: halos must be {x.dtype} on {x.device}, got "
                             f"{t.dtype} on {t.device}")
    for t in affine:
        if t.shape != (C,) or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{what}: LayerNorm weights must be [{C}] {x.dtype} on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    return H


def metapool_block_shard_reference(x: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
                                   has_first: bool, has_last: bool, w1: torch.Tensor,
                                   b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                                   eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`metapool_block_shard`: LayerNorm1 of the
    tokens and of the halos, each row's columns between its two halo tokens
    (a missing one zero after the norm), the window sums in
    :func:`metapool_tokens_reference`'s order (token axis, then channels),
    the whole grid's counts, the residual add and LayerNorm2, each rounded
    to x's dtype as :func:`metapool_block_reference` rounds it.  The shards'
    outputs reassemble to that function's on the whole grid bit for bit."""
    H = _check_shard(x, left, right, (w1, b1, w2, b2))
    B, N, C = x.shape
    w = N // H
    nl = F.layer_norm(left, (C,), w1, b1, eps).clone()
    nr = F.layer_norm(right, (C,), w1, b1, eps).clone()
    if has_first:
        nl[:, 0] = 0
    if has_last:
        nr[:, H - 1] = 0
    n = F.layer_norm(x, (C,), w1, b1, eps).reshape(B, H, w, C)
    ext = torch.cat([nl[:, :, None], n, nr[:, :, None]], dim=2).float()
    rows = ext[:, :, :-2] + ext[:, :, 1:-1] + ext[:, :, 2:]  # the token axis
    p = F.pad(rows, (1, 1))
    win = p[..., :-2] + p[..., 1:-1] + p[..., 2:]  # the channel axis
    cn = torch.full((H, w), 3.0, device=x.device)
    if has_first:
        cn[0, 0] -= 1
    if has_last:
        cn[H - 1, w - 1] -= 1
    count = cn[:, :, None] * _axis_counts(C, x.device)
    y = x + (win / count - n.float()).to(x.dtype).reshape(B, N, C)
    return y, F.layer_norm(y, (C,), w2, b2, eps)


def _block_shard_cuda(x, left, right, has_first: bool, has_last: bool, w1, b1, w2, b2,
                      eps: float):
    what = "metapool_block_shard"
    _check_tokens(x, what)
    H = _check_shard(x, left, right, (w1, b1, w2, b2))
    B, N, C = x.shape
    x, left, right, w1, b1, w2, b2 = (t.contiguous() for t in (x, left, right, w1, b1, w2, b2))
    y, n2 = torch.empty_like(x), torch.empty_like(x)
    flags = (_FIRST if has_first else 0) | (_LAST if has_last else 0)
    err = _fn("tcct_metapool_block_shard")(
        x.data_ptr(), left.data_ptr(), right.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), y.data_ptr(), n2.data_ptr(), B, H, N // H, C,
        _DTYPES[x.dtype], flags, float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"{what} {tuple(x.shape)} H {H} {x.dtype} flags {flags}")
    metapool_block_shard.launches += 1
    return y, n2


def _block_shard_cpu(x, left, right, has_first: bool, has_last: bool, w1, b1, w2, b2,
                     eps: float):
    y, n2 = metapool_block_shard_reference(x, left, right, has_first, has_last, w1, b1, w2, b2,
                                           eps)
    return y.contiguous(), n2.contiguous()


def _block_shard_fake(x, left, right, has_first: bool, has_last: bool, w1, b1, w2, b2,
                      eps: float):
    return _like(x), _like(x)


_block_shard_op = library.define(
    "metapool_block_shard(Tensor x, Tensor left, Tensor right, bool has_first, bool has_last, "
    "Tensor w1, Tensor b1, Tensor w2, Tensor b2, float eps) -> (Tensor, Tensor)",
    cpu=_block_shard_cpu, cuda=_block_shard_cuda, fake=_block_shard_fake)
library.no_backward(_block_shard_op, "metapool_block_shard")


def metapool_block_shard(x: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
                         has_first: bool, has_last: bool, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor, eps: float = 1e-6
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`metapool_block` with the norms and the residual (the serving
    site) on a width shard of an H-row token grid, in one launch (the op
    ``tcct::metapool_block_shard``).

    ``x`` [B, H*w, C] holds w consecutive columns of every row, row-major.
    The window runs over the whole grid's flat token order, so a row's first
    token neighbours the token before it in that order and its last token
    the one after: ``left`` and ``right`` [B, H, C] hold those tokens, raw
    (before LayerNorm1), one per row (``parallel/spatial.py``'s exchange
    with the row wrap).  ``has_first``: the shard holds the grid's first
    token, whose left neighbour does not exist (``left[:, 0]`` is not read);
    ``has_last`` likewise for ``right[:, H-1]``.  A missing neighbour is
    the window's zero padding after the norm, and the counts are the whole
    grid's.  Returns ``(y, n2)`` of the shard's tokens: the shards'
    results, concatenated by columns, are the whole grid's site bit for bit.

    Inference only.  A CPU tensor takes the plain version
    (:func:`metapool_block_shard_reference`); a CUDA tensor launches the
    kernel, or the call raises."""
    library.check_device(x, "metapool_block_shard")
    return _block_shard_op(x, left, right, bool(has_first), bool(has_last), w1, b1, w2, b2,
                           float(eps))


# launches of the forward / backward kernel, of the site and of its shard entry
metapool_tokens.launches = 0
metapool_tokens_backward.launches = 0
metapool_block.launches = 0
metapool_block_shard.launches = 0
