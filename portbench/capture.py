"""``torch.profiler`` captures of whole batches or steps, reduced to what the
per-layer readers take.

A traced run measures its window as an untraced run does, then makes two
captures, after a throwaway one that takes the profiler's start-up.  The
light one records the device's activity alone (kernels, copies, sets; no
host ops, no shapes): the device's busy time a unit (the union of those
intervals) and the launches a unit are read from it.  The shaped one
records the host ops with their input shapes as well: each ``tcct::``
call's shapes and device time, and the host op whose launch ended each
idle stretch, are read from it.  Under either the host runs slower than
untraced (the profiler's tracing costs it time at every launch), so what
depends on the host's pace (the idle share, the utilization) takes the
untraced window's seconds and units, with the busy time a unit.

Each capture's Chrome trace is written to the process's temporary directory,
parsed and deleted.  A device event is attributed to the innermost host op
whose launch it came from (the trace's ``External id``).
"""

from __future__ import annotations

import collections
import json
import os
import sys
import tempfile
import time
from typing import Callable, List, Optional

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """One capture of ``units`` batches or steps over ``window_s`` seconds
    (``unit_s``: the host's seconds for each volume or step in it)."""

    def __init__(self, events: list, window_s: float, unit_s: List[float], units: int):
        self.window_s = window_s
        self.unit_s = unit_s
        self.units = units
        ops = {}
        for ev in events:
            if ev.get("ph") == "X" and ev.get("cat") == "cpu_op":
                ext = ev.get("args", {}).get("External id")
                if ext is not None:
                    ops[ext] = ev
        self.device = []  # (name, start us, duration us, category, host op event or None)
        for ev in events:
            if ev.get("ph") == "X" and ev.get("cat") in _DEVICE_CATS:
                op = ops.get(ev.get("args", {}).get("External id"))
                self.device.append((ev["name"], float(ev["ts"]), float(ev.get("dur", 0)),
                                    ev["cat"], op))
        self.device.sort(key=lambda d: d[1])
        self.kernels = [d for d in self.device if d[3] == "kernel"]
        self.busy_s = self._union() * 1e-6

    def _union(self) -> float:
        busy, end = 0.0, None
        for _, ts, dur, _, _ in self.device:
            if end is None or ts >= end:
                busy += dur
                end = ts + dur
            elif ts + dur > end:
                busy += ts + dur - end
                end = ts + dur
        return busy

    def tcct_calls(self) -> List[tuple]:
        """(op name, input dims, input types, concrete inputs, device s) of
        each ``tcct::`` call that launched on the device."""
        calls = collections.OrderedDict()
        for name, _, dur, _, op in self.kernels:
            if op is None or not op["name"].startswith("tcct::"):
                continue
            key = id(op)
            if key not in calls:
                a = op.get("args", {})
                calls[key] = [op["name"], a.get("Input Dims", []), a.get("Input type", []),
                              a.get("Concrete Inputs", []), 0.0]
            calls[key][4] += dur * 1e-6
        return [tuple(c) for c in calls.values()]


class Capture:
    """A traced run's two captures (:class:`Trace`): ``light`` and
    ``shaped``.  The driver sets ``paced_units`` and ``paced_s`` (the
    untraced window's batches or steps and seconds), ``flops_per_unit`` (the
    reference's operations a unit) and ``peak_flops`` (the card's dense
    rate); ``run.py`` sets the run's ``cell``, ``seed`` and ``device``."""

    def __init__(self, light: Trace, shaped: Trace):
        self.light, self.shaped = light, shaped
        self.cell: Optional[dict] = None
        self.seed: Optional[int] = None
        self.device: Optional[str] = None
        self.units = light.units
        self.window_s = light.window_s
        self.busy_s = light.busy_s
        self.paced_units = 0
        self.paced_s = 0.0
        self.flops_per_unit: Optional[float] = None
        self.peak_flops: Optional[float] = None

    # --- what the per-layer readers take ------------------------------------------

    def idle_pct(self) -> Optional[float]:
        """Share of the untraced window with nothing on the device: the
        light capture's busy time a unit, times the window's units, over
        the window's seconds."""
        if not self.light.device or self.paced_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.units * self.paced_units / self.paced_s)

    def busy_ms_per_unit(self) -> Optional[float]:
        return self.busy_s * 1e3 / self.units if self.light.device else None

    def launches_per_unit(self) -> Optional[float]:
        return len(self.light.kernels) / self.units if self.light.kernels else None

    def mfu_pct(self) -> Optional[float]:
        """The reference's operations of the untraced window's units over
        its seconds and the card's dense peak."""
        if (not self.light.kernels or not self.flops_per_unit or not self.peak_flops
                or self.paced_s <= 0):
            return None
        return 100.0 * self.flops_per_unit * self.paced_units / self.paced_s / self.peak_flops

    def tcct_roofline_pct(self) -> Optional[float]:
        """Sum of the shaped capture's ``tcct::`` calls' bounds over the sum
        of their device time (``reference/costs.py``)."""
        from portbench.reference.costs import FORMULAS, bound_s

        bound = spent = 0.0
        for op, dims, types, args, dev_s in self.shaped.tcct_calls():
            if op not in FORMULAS:
                continue
            bound += bound_s(op, dims, types, args)
            spent += dev_s
        return 100.0 * bound / spent if spent > 0 else None

    def breakdown(self) -> dict:
        """The device ops that took most time (light capture), and the
        longest idle stretches summed by the host op whose launch ended them
        (shaped capture, whose host runs slower than untraced)."""
        by_op = collections.Counter()
        for name, _, dur, _, _ in self.light.device:
            by_op[name[:120]] += dur * 1e-6
        gaps = collections.Counter()
        end = None
        for name, ts, dur, _, op in self.shaped.device:
            if end is not None and ts > end:
                gaps["before " + (op["name"] if op is not None else name)[:110]] += (ts - end) * 1e-6
            end = ts + dur if end is None else max(end, ts + dur)
        return {"device_ops": [[k, v] for k, v in by_op.most_common(10)],
                "idle_gaps": [[k, v] for k, v in gaps.most_common(10)]}


def capture(unit: Callable[[], None], n: int, per: int, sync: Callable[[], None]) -> Capture:
    """Profile ``unit`` (one volume or step, ``per`` batches or steps):
    once under a throwaway light profiler, so that the profiler's start-up
    stays out of the captures, then ``n`` times under the light capture and
    once under the shaped one."""
    _profiled(unit, 1, sync, shapes=False)
    light = Trace(*_profiled(unit, n, sync, shapes=False), n * per)
    shaped = Trace(*_profiled(unit, 1, sync, shapes=True), per)
    print("portbench: light capture, seconds a volume or step: "
          + " ".join(f"{t:.4f}" for t in light.unit_s), file=sys.stderr)
    return Capture(light, shaped)


def _profiled(unit: Callable[[], None], n: int, sync: Callable[[], None], shapes: bool):
    """The trace events, the wall seconds and each unit's seconds of ``n``
    runs of ``unit`` under the profiler: the device's activity alone, or
    with ``shapes`` the host ops and their input shapes too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    if shapes or not activities:
        activities.append(ProfilerActivity.CPU)
    unit_s = []
    with profile(activities=activities, record_shapes=shapes) as prof:
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            a = time.perf_counter()
            unit()
            unit_s.append(time.perf_counter() - a)
        sync()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return events, window, unit_s
