"""The program's spans in a traced serving run, read as per-layer metrics.

The program records spans of its serving path when its tracer is on
(``tcct_tpu_torch/utils/tracing.py``: ``serve.volume``, ``serve.batch``,
``serve.copy_in``, ``serve.dispatch``, ``serve.maps_back`` and, inside the
dispatch, ``model.cnn``, ``model.vit``, ``model.fusion``, ``model.decoder``).
A traced run of a serving cell makes two passes with the tracer on, after
the captures of ``capture.py``, which run with it off:

- the span pass, with no profiler, for :data:`SPAN_PASS_S` seconds (and at
  least ``capture_volumes`` volumes): the host's time in each span, free
  of the profiler's cost at every launch, as a share of the pass's time a
  volume, put at the untraced window's pace (``host_*`` metrics;
  :func:`at_the_windows_pace`);
- the spanned light capture of ``capture_volumes`` volumes, under
  ``ProfilerActivity.CUDA`` alone as the light capture is, after a
  throwaway one: the device's kernels, copies and sets beside the spans.
  The spans are in Unix nanoseconds, as the trace's host events are
  (``ts * 1000 + baseTimeNanoseconds``).  A device event belongs to the
  ``model.*`` span that holds its launch (the ``cuda_runtime`` or
  ``cuda_driver`` event of the same ``correlation``; where the trace has
  none, its start), else to no section (``*_device_ms_per_batch``).  The
  device's idle stretches are placed on the spans' clock by the launches
  that end them (:func:`on_host_clock`), and each, between the first
  volume's start and the last volume's end, is split by the innermost
  ``serve.*`` span open over it, or the client where none is
  (``edge_idle_ms_per_volume``: what lies outside ``serve.dispatch``).

A reader is handed the capture (``harness.per_layer``), on which the run has
set its ``cell``, ``seed`` and ``device``; the driver has freed its
predictor before the readers run.  So the first reader of these metrics
makes both passes in a fresh process (``python3 portbench/spans.py``, one
that has never run the profiler, whose hooks slow every later launch of a
process that has), given the cell, seed and device as arguments, which
builds the predictor anew with the ``build`` of the cell's own driver, and
leaves the passes on the capture (``capture.spans``) for the others.  Both
processes print the cell and seed the passes measured.  A capture with no
device activity or no cell, a cell whose driver serves no volumes
(``SERVES_VOLUMES``), or a program without the tracer leaves every reading
out.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

SECTIONS = ("cnn", "vit", "fusion", "decoder")
HOST = ("host_dispatch_ms_per_batch", "host_copy_in_ms_per_batch",
        "host_maps_back_ms_per_volume")
SPAN_PASS_S = 15.0  # the span pass's least seconds
# the least delay from a launch on the host to its kernel's start on an idle
# card, as an H100's traces read it (4-5 us where the trace's clocks agree)
LAUNCH_LAG_NS = 5_000
ANCHOR_NS = 1_000_000  # on_host_clock: the launches that give one anchor
MAX_DRIFT = 0.05  # on_host_clock: the most the conversion's offset moves a ns
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class DeviceEvent(NamedTuple):
    """A kernel, copy or set on the card, in Unix nanoseconds; ``launch_ns``
    is its launch on the host, None where the trace has no launch event."""

    name: str
    cat: str
    start_ns: int
    end_ns: int
    launch_ns: Optional[int]

    @property
    def key_ns(self) -> int:
        return self.launch_ns if self.launch_ns is not None else self.start_ns


class SpanPasses(NamedTuple):
    """What a cell's two passes recorded: the span pass's spans and seconds
    a volume, the spanned capture's spans and device events (all of the
    capture's), and the readings."""

    host: list
    volume_s: List[float]
    spanned: list
    device: List[DeviceEvent]
    readings: Dict[str, float]


def reading(capture, key: str) -> Optional[float]:
    """The reading ``key`` of the run's span passes, made at the first call
    for ``capture``; None where the capture holds no device activity or the
    passes cannot be made."""
    if capture is None or not capture.light.device:
        return None
    if not hasattr(capture, "spans"):
        capture.spans = passes_of_the_run(capture)
        if capture.spans is not None:
            capture.spans = at_the_windows_pace(capture.spans, capture)
    return None if capture.spans is None else capture.spans.readings.get(key)


def at_the_windows_pace(got: SpanPasses, capture) -> SpanPasses:
    """The passes with their host readings at the untraced window's pace:
    each span's share of the span pass's time a volume, times the window's
    time a volume (``capture.paced_s`` over ``paced_units`` batches).  The
    host's speed moves in phases longer than a pass, in another process
    and a minute after the window, and the window is what the run's rate
    reads, as ``capture.py``'s idle share and ``mfu`` take it.  Prints the
    pass against the window: the host spans' sum a volume (dispatch and
    copy-in of every batch, the maps back) over the pass's volume."""
    vols, batches = len(_named(got.host, "serve.volume")), len(_named(got.host, "serve.batch"))
    r = got.readings
    if not vols or not batches or capture.paced_units <= 0 or any(k not in r for k in HOST):
        return got
    per = batches / vols
    host_ms = ((r["host_dispatch_ms_per_batch"] + r["host_copy_in_ms_per_batch"]) * per
               + r["host_maps_back_ms_per_volume"])
    pass_ms = sum(got.volume_s) * 1e3 / len(got.volume_s)
    window_ms = capture.paced_s / capture.paced_units * per * 1e3
    print(f"portbench: span pass of {capture.cell['name']} seed {capture.seed}: {vols} "
          f"volumes, {pass_ms:.2f} ms a volume against the window's {window_ms:.2f}; dispatch, "
          f"copy-in and maps back {host_ms:.2f} ms a volume, {100 * host_ms / pass_ms:.1f} % of "
          f"the pass's volume; host readings at the pass's pace: "
          + json.dumps({k: round(r[k], 4) for k in HOST}), file=sys.stderr)
    return got._replace(readings=dict(r, **{k: r[k] * window_ms / pass_ms for k in HOST}))


def passes_of_the_run(capture) -> Optional[SpanPasses]:
    """The span passes of the cell, seed and device that the run set on
    ``capture`` (:func:`run_passes`); None where it set no cell, where the
    cell's driver serves no volumes, or where the program has no tracer."""
    cell = capture.cell
    if cell is None or importlib.util.find_spec("tcct_tpu_torch.utils.tracing") is None:
        return None
    from portbench import harness

    if not getattr(harness.driver(cell["traffic_file"]["driver"]), "SERVES_VOLUMES", False):
        return None
    try:
        return run_passes(cell["name"], capture.seed, capture.device)
    except (subprocess.SubprocessError, OSError) as e:
        print(f"portbench: the span passes of {cell['name']} seed {capture.seed} failed "
              f"({e}): their metrics are left out", file=sys.stderr)
        return None


def run_passes(workload: str, seed: int, device) -> SpanPasses:
    """:func:`passes` in a fresh process (this file as a script), one that
    has never run the profiler: after a ``torch.profiler`` session has
    ended, every launch of its process stays slower (CUPTI's hooks).  Its
    standard error is this process's."""
    from portbench import harness
    from tcct_tpu_torch.utils.tracing import Span

    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_spans_")
    os.close(fd)
    try:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--workload", workload,
                        "--seed", str(seed), "--device", str(device), "--out", path],
                       cwd=harness.ROOT, check=True, timeout=900)
        with open(path) as f:
            got = json.load(f)
    finally:
        os.unlink(path)
    return SpanPasses([Span(*s) for s in got["host"]], got["volume_s"],
                      [Span(*s) for s in got["spanned"]],
                      [DeviceEvent(*d) for d in got["device"]], got["readings"])


def passes(cell: dict, seed: int, device) -> SpanPasses:
    """Build the cell's predictor from ``seed`` with its driver's ``build``,
    warm it up and make the span pass (:data:`SPAN_PASS_S` seconds, at least
    ``capture_volumes`` volumes) and the spanned light capture of
    ``capture_volumes`` volumes and one more, whose spans are left out of the
    readings (a capture can lose its last ms of device records, and the first
    events of that volume end the last idle stretch of the ones before)."""
    import torch

    from portbench import harness
    from tcct_tpu_torch.utils import tracing

    pred, pool, _, _ = harness.driver(cell["traffic_file"]["driver"]).build(cell, seed, device)
    sync = torch.cuda.synchronize if pred.device.type == "cuda" else (lambda: None)
    n = cell["traffic_file"]["capture_volumes"]

    def volumes(k, seconds=0.0):
        out, t0 = [], time.perf_counter()
        while len(out) < k or time.perf_counter() - t0 < seconds:
            a = time.perf_counter()
            pred.predict_volume(pool[len(out) % len(pool)])
            out.append(time.perf_counter() - a)
        return out

    def spanned(k, seconds=0.0):
        tracing.enable()
        try:
            took = volumes(k, seconds)
        finally:
            got = tracing.drain()
            tracing.disable()
        return got, took

    volumes(2 + n)  # every shape (whole and padded batches), and the allocator's cache
    sync()
    gc.collect()
    gc.freeze()  # as drivers/volumes.py's window runs
    host, volume_s = spanned(n, SPAN_PASS_S)
    _profiled(lambda: volumes(1), sync)  # the profiler's start-up, tracer off
    events, every = _profiled(lambda: spanned(n + 1)[0], sync)
    last = max(_named(every, "serve.volume"), key=lambda v: v.start_ns).request_id
    spans = [v for v in every if v.request_id != last]
    device = device_events(events)
    out = host_readings(host)
    if device:
        out.update(device_readings(spans, device))
    print(f"portbench: span passes of {cell['name']} seed {seed}: {len(volume_s)} volumes in "
          f"{sum(volume_s):.3f} s, median {sorted(volume_s)[len(volume_s) // 2] * 1e3:.2f} ms",
          file=sys.stderr)
    if device:
        d = dict(diagnostics(spans, device), in_volume_share=in_volume_share(every, device))
        print("portbench: spans: " + json.dumps(d), file=sys.stderr)
    return SpanPasses(host, volume_s, spans, device, out)


def _profiled(unit, sync):
    """The Chrome trace's events of ``unit`` under the profiler (the card's
    activity alone; the host's where there is no card), their times in
    Unix nanoseconds, and what ``unit`` returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    act = ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU
    with profile(activities=[act]) as prof:
        sync()
        got = unit()
        sync()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_spans_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = [dict(ev, ts_ns=base + round(float(ev["ts"]) * 1000),
                   dur_ns=round(float(ev.get("dur", 0)) * 1000))
              for ev in trace["traceEvents"] if ev.get("ph") == "X" and "ts" in ev]
    return events, got


def device_events(events: Sequence[dict]) -> List[DeviceEvent]:
    """The kernels, copies and sets of a trace's events (with ``ts_ns``
    and ``dur_ns``), each with the time of its launch where a launch event
    of the same ``correlation`` is in the trace; sorted by start."""
    launches = {}
    for ev in events:
        if ev.get("cat") in _LAUNCH_CATS:
            c = ev.get("args", {}).get("correlation")
            if c is not None:
                launches[c] = ev["ts_ns"]
    out = [DeviceEvent(ev["name"], ev["cat"], ev["ts_ns"], ev["ts_ns"] + ev["dur_ns"],
                       launches.get(ev.get("args", {}).get("correlation")))
           for ev in events if ev.get("cat") in _DEVICE_CATS]
    return sorted(out, key=lambda d: d.start_ns)


def on_host_clock(device: Sequence[DeviceEvent]) -> Tuple[List[DeviceEvent], List[tuple]]:
    """The events on the spans' clock, sorted by start, and the card's idle
    stretches between them as (start, end), the first from minus and the
    last to plus infinity.

    A trace's device times are the card's clock converted to the host's,
    and on some captures that conversion drifts (by up to 2.5 % of the time
    since the capture began); the launches are the host's own.  No event
    starts sooner than :data:`LAUNCH_LAG_NS` after its launch, and one that
    ends an idle stretch of the card starts then: so in each
    :data:`ANCHOR_NS` of launches the least launch-to-start delay, less
    that lag, is the conversion's offset there (an anchor).  An anchor that
    lies above another by more than :data:`MAX_DRIFT` times the time
    between them came from events that waited in the queue, and is dropped;
    between the anchors left the offset is linear, beyond them constant.
    Each event moves by the offset at its launch (at its start, where it
    has none).  Where no event follows an idle stretch the events stay as
    the trace gives them.  (Placing each stretch alone by the launch that
    ends it fails on a drifting clock: the drift opens gaps inside a queue,
    and a queued event is not where its launch says.)"""
    ordered = sorted(device, key=lambda d: d.start_ns)
    lows: Dict[int, tuple] = {}
    end = None
    t0 = min((d.launch_ns for d in ordered if d.launch_ns is not None), default=0)
    for d in ordered:
        if d.launch_ns is not None and end is not None and d.start_ns > end:
            k = (d.launch_ns - t0) // ANCHOR_NS
            lag = d.start_ns - d.launch_ns - LAUNCH_LAG_NS
            if k not in lows or lag < lows[k][1]:
                lows[k] = (d.launch_ns, lag)
        end = d.end_ns if end is None else max(end, d.end_ns)
    pts = [lows[k] for k in sorted(lows)] or [(0, 0)]
    env = [lag for _, lag in pts]  # the least drift-bounded function through the anchors
    for i in range(1, len(pts)):
        env[i] = min(env[i], env[i - 1] + MAX_DRIFT * (pts[i][0] - pts[i - 1][0]))
    for i in range(len(pts) - 2, -1, -1):
        env[i] = min(env[i], env[i + 1] + MAX_DRIFT * (pts[i + 1][0] - pts[i][0]))
    at, lag = zip(*(p for p, e in zip(pts, env) if p[1] <= e))

    def offset(t: int) -> int:
        i = bisect.bisect_right(at, t)
        if i == 0 or i == len(at):
            return lag[min(i, len(at) - 1)]
        return round(lag[i - 1] + (t - at[i - 1]) / (at[i] - at[i - 1]) * (lag[i] - lag[i - 1]))

    events = sorted((d._replace(start_ns=d.start_ns - (o := offset(d.key_ns)),
                                end_ns=d.end_ns - o) for d in ordered),
                    key=lambda d: d.start_ns)
    idle, t = [], -math.inf
    for a, b in busy(events):
        idle.append((t, a))
        t = b
    return events, idle + [(t, math.inf)]


def in_volume_share(spans, device: Sequence[DeviceEvent]) -> float:
    """The share of the events whose launch (or start) lies inside a
    ``serve.volume`` span."""
    vols = sorted((v.start_ns, v.end_ns) for v in _named(spans, "serve.volume"))
    inside = 0
    for d in device:
        i = bisect.bisect_right(vols, (d.key_ns, math.inf)) - 1
        inside += i >= 0 and d.key_ns <= vols[i][1]
    return inside / max(len(device), 1)


def within_volumes(spans, device: Sequence[DeviceEvent]) -> List[DeviceEvent]:
    """The events launched (started, where no launch is known) between the
    first ``serve.volume`` span's start and the last one's end."""
    vols = _named(spans, "serve.volume")
    if not vols:
        return []
    lo, hi = min(s.start_ns for s in vols), max(s.end_ns for s in vols)
    return [d for d in device if lo <= d.key_ns <= hi]


def _named(spans, name: str) -> list:
    return [s for s in spans if s.name == name]


def _ms(spans) -> float:
    return sum(s.end_ns - s.start_ns for s in spans) * 1e-6


def host_readings(spans) -> Dict[str, float]:
    """The span pass's host milliseconds, at its own pace:
    ``serve.dispatch`` and ``serve.copy_in`` over its batches,
    ``serve.maps_back`` over its volumes."""
    batches, vols = len(_named(spans, "serve.batch")), len(_named(spans, "serve.volume"))
    if not batches or not vols:
        return {}
    return {"host_dispatch_ms_per_batch": _ms(_named(spans, "serve.dispatch")) / batches,
            "host_copy_in_ms_per_batch": _ms(_named(spans, "serve.copy_in")) / batches,
            "host_maps_back_ms_per_volume": _ms(_named(spans, "serve.maps_back")) / vols}


def _section_of(spans):
    """A function from a time to the model section whose ``model.*`` span
    holds it (``outside`` where none does) and that span."""
    model = sorted((s for s in spans if s.name.startswith("model.")), key=lambda s: s.start_ns)
    starts = [s.start_ns for s in model]

    def of(t: int):
        i = bisect.bisect_right(starts, t) - 1
        if i < 0 or t >= model[i].end_ns:
            return "outside", None
        name = model[i].name[len("model."):]
        return (name if name in SECTIONS else "outside"), model[i]

    return of


def sections_ns(spans, device: Sequence[DeviceEvent]) -> Dict[str, int]:
    """Device nanoseconds by the ``model.*`` span that holds each event's
    launch (its start where no launch is known); ``outside`` for the rest."""
    of = _section_of(spans)
    out = dict.fromkeys(SECTIONS + ("outside",), 0)
    for d in device:
        out[of(d.key_ns)[0]] += d.end_ns - d.start_ns
    return out


def busy(device: Sequence[DeviceEvent]) -> List[tuple]:
    """The union of the events' intervals, as sorted disjoint (start, end)."""
    out = []
    for d in sorted(device, key=lambda d: d.start_ns):
        if out and d.start_ns <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], d.end_ns))
        else:
            out.append((d.start_ns, d.end_ns))
    return out


def innermost(spans, lo: int, hi: int) -> List[tuple]:
    """[lo, hi) cut into (start, end, name) pieces by the innermost
    ``serve.*`` span open over each (None where none is)."""
    bounds = []
    for s in spans:
        if s.name.startswith("serve."):
            bounds += [(s.start_ns, 1, s.span_id, s.name), (s.end_ns, 0, s.span_id, s.name)]
    bounds.sort()
    out, stack, t = [], [], lo
    for at, opening, sid, name in bounds:
        at = min(max(at, lo), hi)
        if at > t:
            out.append((t, at, stack[-1][1] if stack else None))
            t = at
        if opening:
            stack.append((sid, name))
        else:
            stack = [e for e in stack if e[0] != sid]
    if hi > t:
        out.append((t, hi, stack[-1][1] if stack else None))
    return out


def idle_split_ns(spans, device: Sequence[DeviceEvent]) -> Dict[str, int]:
    """The device's idle nanoseconds between the first ``serve.volume``'s
    start and the last one's end, placed by :func:`on_host_clock` and split
    by the innermost ``serve.*`` span open over them (``client`` where none
    is).  ``device`` holds the capture's events, those after the last volume
    too: the first of them ends the last idle stretch."""
    vols = _named(spans, "serve.volume")
    if not vols:
        return {}
    lo, hi = min(s.start_ns for s in vols), max(s.end_ns for s in vols)
    out: Dict[str, int] = {}
    pieces = innermost(spans, lo, hi)
    for a, b in on_host_clock(device)[1]:
        a, b = max(a, lo), min(b, hi)
        for p0, p1, name in pieces:
            if p0 < b and p1 > a:
                name = name or "client"
                out[name] = out.get(name, 0) + int(min(b, p1) - max(a, p0))
    return out


def device_readings(spans, device: Sequence[DeviceEvent]) -> Dict[str, float]:
    """The spanned capture's readings from its events (``device``, all of
    them): each model section's device milliseconds over its batches, and
    the device's idle milliseconds outside ``serve.dispatch`` over its
    volumes."""
    batches, vols = len(_named(spans, "serve.batch")), len(_named(spans, "serve.volume"))
    if not batches or not vols:
        return {}
    sec = sections_ns(spans, within_volumes(spans, device))
    out = {f"{k}_device_ms_per_batch": sec[k] * 1e-6 / batches for k in SECTIONS}
    idle = idle_split_ns(spans, device)
    out["edge_idle_ms_per_volume"] = (sum(idle.values()) - idle.get("serve.dispatch", 0)) \
        * 1e-6 / vols
    return out


def events_per_batch(spans, device: Sequence[DeviceEvent]) -> Dict[str, list]:
    """For each section (and ``outside``), the fewest and the most device
    events a ``serve.batch`` span holds the launch of: equal where every
    batch launches the same sequence and the clocks agree."""
    batches = sorted(_named(spans, "serve.batch"), key=lambda s: s.start_ns)
    starts = [b.start_ns for b in batches]
    of = _section_of(spans)
    counts = [dict.fromkeys(SECTIONS + ("outside",), 0) for _ in batches]
    for d in device:
        i = bisect.bisect_right(starts, d.key_ns) - 1
        if i >= 0 and d.key_ns < batches[i].end_ns:
            counts[i][of(d.key_ns)[0]] += 1
    return {k: [min(c[k] for c in counts), max(c[k] for c in counts)] for k in counts[0]} \
        if counts else {}


def _lags_us(device: Sequence[DeviceEvent]) -> dict:
    lag = sorted((d.start_ns - d.launch_ns) * 1e-3 for d in device if d.launch_ns is not None)
    return {q: lag[int(f * (len(lag) - 1))] for q, f in (("min", 0), ("p1", 0.01), ("p50", 0.5),
                                                          ("max", 1))} if lag else {}


def diagnostics(spans, device: Sequence[DeviceEvent]) -> dict:
    """What says whether the clocks agree and the sections add up, of the
    capture's events (``device``) launched inside its volumes: how many
    there are and how many had a launch event; the launch-to-start delays
    (us) as the trace gives them and on the spans' clock
    (:func:`on_host_clock`); those of a ``model.*`` span that start before
    it on the spans' clock; each section's events a batch (fewest, most);
    each section's and all device time a batch; the busy time a batch; the
    idle split a volume; each volume's ms."""
    batches = max(len(_named(spans, "serve.batch")), 1)
    vols = _named(spans, "serve.volume")
    inside = within_volumes(spans, device)
    placed = within_volumes(spans, on_host_clock(device)[0])
    of = _section_of(spans)
    early = sum(1 for d in placed
                if (sp := of(d.key_ns)[1]) is not None and d.start_ns < sp.start_ns)
    sec = sections_ns(spans, inside)
    return {"events": len(inside),
            "with_launch": sum(d.launch_ns is not None for d in inside),
            "start_minus_launch_us": {"trace": _lags_us(inside), "placed": _lags_us(placed)},
            "model_events_starting_early": early,
            "events_per_batch": events_per_batch(spans, inside),
            "ms_per_batch": {k: v * 1e-6 / batches for k, v in sec.items()},
            "device_sum_ms_per_batch": sum(sec.values()) * 1e-6 / batches,
            "busy_ms_per_batch": sum(b - a for a, b in busy(inside)) * 1e-6 / batches,
            "idle_ms_per_volume": {k: v * 1e-6 / max(len(vols), 1)
                                   for k, v in idle_split_ns(spans, device).items()},
            "volume_ms": [(s.end_ns - s.start_ns) * 1e-6 for s in vols]}


def main(argv=None) -> int:
    """``python3 portbench/spans.py --workload <cell> --seed <n> --device
    <device> --out <file>``: the cell's span passes, written to ``<file>`` as
    JSON (the arguments :func:`run_passes` hands the process)."""
    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--device", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from portbench import harness

    harness.fix_caches()
    harness.few_threads()
    if args.device == "cuda":
        from tcct_tpu_torch.ops.kernels.build import build_all

        build_all()
    got = passes(harness.load_cell(args.workload), args.seed, args.device)
    with open(args.out, "w") as f:
        json.dump(got._asdict(), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
