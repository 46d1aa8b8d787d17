"""Tracing and profiling (JAX counterpart ``tcct_tpu/utils/profiling.py``;
the reference has wall-clock prints and a commented-out fvcore FLOP count).

- :func:`trace` - a ``torch.profiler`` capture (CPU, and CUDA where there is
  a card) written as a Chrome trace under a directory.
- :func:`measured_traffic` - the newest such trace parsed into device
  kernel time, by the op that launched each kernel.
- :func:`cost_analysis` - operations of a call by ``FlopCounterMode`` (with
  a formula for every ``tcct::`` op) and the bytes of every op it
  dispatches.
- :func:`debug_nans` - raise at the first op whose floating output holds a
  NaN (``jax_debug_nans``).

JAX's ``measured_traffic`` also gives HBM bytes from each op's measured
bandwidth; the torch profiler records no bandwidth, so this one has none.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

from tcct_tpu_torch.ops.kernels.bnstats import bn_act_train_flops
from tcct_tpu_torch.ops.kernels.crosscnn_fused import fused_cross_block_flops
from tcct_tpu_torch.ops.kernels.dwconv import dwconv3x3_flops
from tcct_tpu_torch.ops.kernels.metapool import metapool_block_flops, metapool_flops

_OPS = torch.ops.tcct

# operations of each tcct:: op, the formulas chip_smoke.py's bounds use; a
# formula gets each tensor argument as its shape
register_flop_formula(_OPS.metapool_tokens)(lambda x, out_shape=None: metapool_flops(x))
register_flop_formula(_OPS.metapool_tokens_backward)(lambda g, out_shape=None: metapool_flops(g))
register_flop_formula(_OPS.metapool_block)(
    lambda x, *args, out_shape=None: metapool_block_flops(x))
register_flop_formula(_OPS.metapool_block_shard)(
    lambda x, *args, out_shape=None: metapool_block_flops(x))
register_flop_formula(_OPS.dwconv3x3)(
    lambda x, w, bias, stride, *args, out_shape=None: dwconv3x3_flops(x, stride))
register_flop_formula(_OPS.dwconv3x3_backward)(
    lambda x, w, g, stride, *args, out_shape=None: dwconv3x3_flops(x, stride, backward=True))
register_flop_formula(_OPS.bn_act_train)(
    lambda x, *args, out_shape=None: bn_act_train_flops(x))
register_flop_formula(_OPS.bn_act_train_backward)(
    lambda x, *args, out_shape=None: bn_act_train_flops(x, backward=True))
register_flop_formula(_OPS.fused_cross_block)(
    lambda x, w, vec, wf, cin, cout, k, out_shape=None: fused_cross_block_flops(x, cin, cout, k))


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU activity, and CUDA where a card is present)
    and write its Chrome trace as ``<log_dir>/trace_<ns>.json``.  Yields
    the ``torch.profiler.profile``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def measured_traffic(trace_dir: str) -> Dict[str, object]:
    """The newest trace under ``trace_dir`` (written by :func:`trace`):
    ``self_time_s``, the device's kernel, copy and set time; ``categories``,
    that time by the op that launched it (the innermost CPU op around the
    launch: ``tcct::metapool_block``, ``aten::cudnn_convolution``, ...;
    "unattributed" where the trace links it to none); ``host_ops``, the
    host time of each CPU op by name (where a CPU-only trace shows its
    ``tcct::`` ops)."""
    paths = glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no trace (*.json) under {trace_dir}")
    with open(max(paths, key=os.path.getmtime)) as f:
        events = json.load(f)["traceEvents"]
    op_of: Dict[int, str] = {}
    host_ops: Dict[str, float] = {}
    for ev in events:
        if ev.get("cat") == "cpu_op" and ev.get("ph") == "X":
            host_ops[ev["name"]] = host_ops.get(ev["name"], 0.0) + ev.get("dur", 0) * 1e-6
            ext = ev.get("args", {}).get("External id")
            if ext is not None:
                op_of[ext] = ev["name"]
    total, cats = 0.0, {}
    for ev in events:
        if ev.get("cat") in _DEVICE_CATS and ev.get("ph") == "X":
            t = ev.get("dur", 0) * 1e-6
            total += t
            group = op_of.get(ev.get("args", {}).get("External id"), "unattributed")
            cats[group] = cats.get(group, 0.0) + t
    return {"self_time_s": total, "categories": cats, "host_ops": host_ops}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


_TRANSCENDENTAL = ("exp", "log", "tanh", "sigmoid", "erf", "sqrt", "rsqrt", "gelu", "sin",
                   "cos", "pow")


class _Traffic(TorchDispatchMode):
    """Bytes in and out of every op dispatched, and the elements of every
    transcendental op's output."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.transcendentals = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        if func.__name__.split(".")[0].lstrip("_") in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in torch.utils._pytree.tree_leaves(out)
                                        if isinstance(t, torch.Tensor))
        return out


def cost_analysis(fn, *args, **kwargs) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` once and count its work:
    ``flops`` by ``torch.utils.flop_counter.FlopCounterMode`` (the aten
    formulas and this package's for the ``tcct::`` ops), ``bytes_accessed``
    the inputs plus outputs of every op dispatched (which, like HLO's
    "bytes accessed", counts a fused chain's intermediates), and
    ``transcendentals`` the output elements of exp, log, tanh, erf, sqrt
    and the like."""
    flops = FlopCounterMode(display=False)
    traffic = _Traffic()
    with flops, traffic:
        fn(*args, **kwargs)
    return {"flops": float(flops.get_total_flops()), "bytes_accessed": float(traffic.bytes),
            "transcendentals": float(traffic.transcendentals)}


class _NaNCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and bool(t.isnan().any()):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Inside the block, raise ``FloatingPointError`` at the first op whose
    floating output holds a NaN, naming the op (``jax_debug_nans``).  Each
    check reads the output back to the host, so this is for debugging."""
    if not enable:
        yield
        return
    with _NaNCheck():
        yield
