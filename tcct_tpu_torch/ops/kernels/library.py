"""The ``tcct::`` custom operators: one for each hand-written kernel.

Each op has a schema, a fake implementation (the outputs' shapes, types and
strides, symbolic batch sizes included, for ``torch.export`` and the
tracers), a CPU implementation (the kernel's plain version) and a CUDA
implementation (the ctypes launch and its launch count).  The dispatcher
picks the implementation by the inputs' device, so a CUDA tensor never
takes the plain version: it launches the kernel or the call raises.  A
kernel with a backward has it as an op of its own; the forward op's
autograd formula is a ``torch.autograd.Function`` registered on its
``Autograd`` key (:func:`autograd`), whose forward runs the op below
autograd and whose backward calls the backward op.  An op without a
backward refuses, at the op, any call that autograd would want a gradient
from (:func:`no_backward`).

The serving ops (the MetaPool site, the depthwise forward and the fused
CrossCNN block) also have an ``out`` overload (:func:`define_out`): the
same arguments, then the output tensors it writes, the same launch into
them.  A replayed serving tape (``infer/graphs.py``) calls it, so that the
kernel writes where the next captured graph reads.

The wrapper modules (``metapool.py``, ``dwconv.py``, ``bnstats.py``,
``crosscnn_fused.py``) define their ops through :func:`define` when they
are imported; their public functions are thin calls of ``torch.ops.tcct``.
The registration is the low-level ``torch.library.Library`` one, and the
autograd kernels are written out rather than made by
``torch.library.register_autograd``: every call of a kernel pays for the
dispatch, and both ``torch.library.custom_op`` (an aliasing check around
each implementation) and ``register_autograd`` (a generic wrapper that
re-reads the schema each call) add Python work per call on top of it.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

_LIB = torch.library.Library("tcct", "FRAGMENT")

# an op with an ``out`` overload -> (that overload, a function of the op's
# arguments that makes its outputs, empty): see :func:`define_out`
OUT: Dict[torch._ops.OpOverload, Tuple[torch._ops.OpOverload, Callable]] = {}


def _name(op: torch._ops.OpOverload) -> str:
    """``op``'s name as ``Library.impl`` takes it: ``name`` or ``name.overload``."""
    overload = op._schema.overload_name
    return f"{op._opname}.{overload}" if overload else op._opname


def define(schema: str, *, cpu: Callable, cuda: Callable,
           fake: Callable) -> torch._ops.OpOverload:
    """Define ``tcct::<schema>`` with its CPU, CUDA and fake
    implementations; returns the overload it names (``name.out(...)``:
    ``out``; else the default)."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"tcct::{name}", fake, lib=_LIB)
    op, _, overload = name.partition(".")
    return getattr(getattr(torch.ops.tcct, op), overload or "default")


def define_out(op: torch._ops.OpOverload, outs: str, *, cuda: Callable,
               outputs: Callable) -> torch._ops.OpOverload:
    """Define ``op``'s ``out`` overload: ``op``'s arguments, then ``outs``
    (the schema of the output tensors it writes, in ``op``'s order), and
    no return; returns it.  ``cuda`` is ``op``'s CUDA implementation,
    called with the outputs after the arguments: the same launch, into
    them.  On the CPU the overload writes ``op``'s plain result into them.
    ``outputs``, called with ``op``'s arguments, makes the outputs a call
    would return, empty (``op``'s fake implementation does: it allocates
    on the device of its arguments).  The profiler records either overload
    under ``op``'s name, with the arguments at the same positions."""
    n = len(op._schema.arguments)
    args = str(op._schema).split("(", 1)[1].rsplit(") ->", 1)[0]

    def cpu(*a):
        got = op(*a[:n])
        for o, t in zip(a[n:], got if isinstance(got, tuple) else (got,)):
            check_out(f"{op._opname}.out", o, t.shape, t)
            o.copy_(t)

    def launch(*a):
        cuda(*a)

    out = define(f"{op._opname}.out({args}, {outs}) -> ()", cpu=cpu, cuda=launch,
                 fake=lambda *a: None)
    no_backward(out, f"{op._opname}.out")
    OUT[op] = (out, outputs)
    return out


def check_out(what: str, out: torch.Tensor, shape: Sequence[int], like: torch.Tensor) -> None:
    """Raise unless ``out`` can take a kernel's output: contiguous,
    ``shape``, of ``like``'s type and on its device."""
    if (tuple(out.shape) != tuple(shape) or out.dtype != like.dtype
            or out.device != like.device or not out.is_contiguous()):
        raise ValueError(f"{what}: out must be a contiguous {tuple(shape)} {like.dtype} on "
                         f"{like.device}, got {tuple(out.shape)} {out.dtype} on {out.device}")


def check_device(x: torch.Tensor, what: str) -> None:
    """Raise for a tensor on neither the CPU nor a CUDA card (a meta tensor
    would otherwise run the fake implementation)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def below_autograd(op: torch._ops.OpOverload, *args):
    """``op(*args)`` past its autograd kernel, straight to the device's
    implementation (what an autograd formula's forward runs)."""
    with torch._C._AutoDispatchBelowAutograd():
        return op(*args)


def autograd(op: torch._ops.OpOverload, function: type) -> None:
    """Register ``function``, a ``torch.autograd.Function`` taking the op's
    arguments, as ``op``'s autograd formula: a call that autograd would
    want a gradient from goes through ``function.apply``, any other runs
    the op below autograd."""
    def kernel(*args):
        if torch.is_grad_enabled() and torch._C._any_requires_grad(*args):
            return function.apply(*args)
        return below_autograd(op, *args)

    _LIB.impl(_name(op), kernel, "Autograd")


def no_backward(op: torch._ops.OpOverload, what: str) -> None:
    """Make ``op`` raise when autograd would want a gradient from it (grad
    mode on and an input that requires one); otherwise it runs as usual."""
    def kernel(*args):
        if torch.is_grad_enabled() and torch._C._any_requires_grad(*args):
            raise ValueError(f"{what}: no backward; call it under torch.no_grad() or "
                             "torch.inference_mode()")
        return below_autograd(op, *args)

    _LIB.impl(_name(op), kernel, "Autograd")

