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

from typing import Callable

import torch

_LIB = torch.library.Library("tcct", "FRAGMENT")


def define(schema: str, *, cpu: Callable, cuda: Callable,
           fake: Callable) -> torch._ops.OpOverload:
    """Define ``tcct::<schema>`` with its CPU, CUDA and fake
    implementations; returns the op's default overload."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"tcct::{name}", fake, lib=_LIB)
    return getattr(torch.ops.tcct, name).default


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

    _LIB.impl(op._opname, kernel, "Autograd")


def no_backward(op: torch._ops.OpOverload, what: str) -> None:
    """Make ``op`` raise when autograd would want a gradient from it (grad
    mode on and an input that requires one); otherwise it runs as usual."""
    def kernel(*args):
        if torch.is_grad_enabled() and torch._C._any_requires_grad(*args):
            raise ValueError(f"{what}: no backward; call it under torch.no_grad() or "
                             "torch.inference_mode()")
        return below_autograd(op, *args)

    _LIB.impl(op._opname, kernel, "Autograd")

