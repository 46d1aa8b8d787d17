"""The span readers (``portbench/spans.py``) on a synthetic capture whose
spans and device intervals overlap by known amounts, and the span passes of
a tiny serving cell on the CPU: the three host readings, and no device one."""

from __future__ import annotations

import math
import os
import sys
import time
from types import SimpleNamespace

import pytest

from tcct_tpu_torch.utils.tracing import Span

SEED = 2 ** 33 + 12345
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

US = 1000  # the synthetic times are in microseconds, the spans' in ns


def _span(name, a, b, sid, parent, request=1, **attrs):
    return Span(name, a * US, b * US, sid, parent, request, attrs)


# Volume 1 [0, 100): one batch with the four model sections, then the maps.
# Volume 2 [120, 160): one batch of a model without sections.
SPANS = [
    _span("serve.volume", 0, 100, 1, None, scans=3),
    _span("serve.batch", 0, 60, 2, 1, rows=2),
    _span("serve.copy_in", 0, 10, 3, 2),
    _span("serve.dispatch", 10, 50, 4, 2),
    _span("model.cnn", 12, 20, 5, 4),
    _span("model.vit", 20, 30, 6, 4),
    _span("model.fusion", 30, 35, 7, 4),
    _span("model.decoder", 35, 48, 8, 4),
    _span("serve.maps_back", 60, 100, 9, 1),
    _span("serve.volume", 120, 160, 10, None, 2, scans=1),
    _span("serve.batch", 120, 140, 11, 10, 2, rows=1),
    _span("serve.copy_in", 120, 125, 12, 11, 2),
    _span("serve.dispatch", 125, 138, 13, 11, 2),
    _span("serve.maps_back", 140, 160, 14, 10, 2),
]


def _device():
    """Each event that starts on an idle card starts LAUNCH_LAG_NS (5 us)
    after its launch: the trace's clock agrees with the spans'."""
    from portbench.spans import DeviceEvent

    def ev(name, launch, a, b, cat="kernel"):
        return DeviceEvent(name, cat, a * US, b * US, None if launch is None else launch * US)

    return [ev("h2d", 3, 8, 12, "gpu_memcpy"),  # launched in copy_in: outside
            ev("cnn", 13, 18, 22),  # launched in model.cnn, runs into model.vit's time
            ev("vit", 21, 22, 30),  # queued behind cnn
            ev("fusion", None, 31, 33),  # no launch event: its start decides
            ev("decoder", 36, 41, 55),  # runs on after the dispatch ends
            ev("argmax", 49, 55, 58),  # in the dispatch, outside the sections
            ev("d2h", 61, 66, 70, "gpu_memcpy"),
            ev("other", 126, 131, 137),
            ev("d2h", 141, 146, 150, "gpu_memcpy")]


def test_host_readings():
    from portbench.spans import host_readings

    got = host_readings(SPANS)
    # dispatch 40 + 13 us, copy-in 10 + 5 over 2 batches; maps 40 + 20 over 2 volumes
    assert got == pytest.approx({"host_dispatch_ms_per_batch": 0.0265,
                                 "host_copy_in_ms_per_batch": 0.0075,
                                 "host_maps_back_ms_per_volume": 0.030})


def test_host_readings_at_the_windows_pace(capsys):
    """A pass of 0.1 ms a volume against a window of 0.2 ms a volume (one
    batch a volume): every host reading doubles; the device ones stay."""
    from portbench.spans import SpanPasses, at_the_windows_pace, host_readings

    got = SpanPasses(SPANS, [0.0001, 0.0001], [], [],
                     dict(host_readings(SPANS), cnn_device_ms_per_batch=4.0))
    capture = SimpleNamespace(paced_s=0.002, paced_units=10, seed=SEED,
                              cell={"name": "stc_tt.duke-volumes"})
    paced = at_the_windows_pace(got, capture).readings
    assert paced == pytest.approx({"host_dispatch_ms_per_batch": 0.053,
                                   "host_copy_in_ms_per_batch": 0.015,
                                   "host_maps_back_ms_per_volume": 0.060,
                                   "cnn_device_ms_per_batch": 4.0})
    assert f"stc_tt.duke-volumes seed {SEED}" in capsys.readouterr().err
    assert at_the_windows_pace(got, SimpleNamespace(paced_s=0.0, paced_units=0)) is got


def test_sections_by_launch_else_start():
    from portbench.spans import sections_ns

    got = sections_ns(SPANS, _device())
    assert got == {"cnn": 4 * US, "vit": 8 * US, "fusion": 2 * US, "decoder": 14 * US,
                   "outside": (4 + 3 + 4 + 6 + 4) * US}
    assert sum(got.values()) == sum(d.end_ns - d.start_ns for d in _device())


def test_events_outside_the_volumes_are_left_out():
    from portbench.spans import DeviceEvent, within_volumes

    tail = DeviceEvent("tail", "kernel", 175 * US, 180 * US, 170 * US)
    early = DeviceEvent("early", "kernel", 2 * US, 3 * US, -1 * US)
    assert within_volumes(SPANS, [early] + _device() + [tail]) == _device()
    assert within_volumes([], _device()) == []


def test_idle_split_by_the_innermost_serve_span():
    from portbench.spans import idle_split_ns

    # idle: [0,8) copy-in; [12,18) [30,31) [33,41) dispatch; [58,60) batch, [60,66) maps;
    # [70,100) maps; [100,120) client; [120,125) copy-in, [125,131) dispatch;
    # [137,138) dispatch, [138,140) batch, [140,146) maps; [150,160) maps
    assert idle_split_ns(SPANS, _device()) == {
        "serve.copy_in": 13 * US, "serve.dispatch": 22 * US, "serve.batch": 4 * US,
        "serve.maps_back": 52 * US, "client": 20 * US}


def test_device_readings():
    from portbench.spans import device_readings

    got = device_readings(SPANS, _device())
    assert got == pytest.approx({"cnn_device_ms_per_batch": 0.002,
                                 "vit_device_ms_per_batch": 0.004,
                                 "fusion_device_ms_per_batch": 0.001,
                                 "decoder_device_ms_per_batch": 0.007,
                                 "edge_idle_ms_per_volume": (111 - 22) / 2 / 1000})


def test_a_trace_off_the_spans_clock_reads_the_same():
    """A trace whose device times lie 3 ms early (its launches on the
    spans' clock) gives the same readings; an event launched after the last
    volume ends its last idle stretch and is read by no section."""
    from portbench.spans import DeviceEvent, device_readings

    launched = [d for d in _device() if d.launch_ns is not None]
    early = [d._replace(start_ns=d.start_ns - 3000 * US, end_ns=d.end_ns - 3000 * US)
             for d in launched]
    tail = DeviceEvent("tail", "kernel", 171 * US - 3000 * US, 175 * US - 3000 * US, 166 * US)
    assert device_readings(SPANS, early + [tail]) == pytest.approx(
        device_readings(SPANS, launched))


def test_diagnostics_see_the_clock():
    from portbench.spans import DeviceEvent, diagnostics, in_volume_share

    dev = _device()
    d = diagnostics(SPANS, dev)
    assert d["model_events_starting_early"] == 0 and d["events"] == 9
    assert d["with_launch"] == 8 and d["device_sum_ms_per_batch"] == pytest.approx(0.0245)
    assert d["start_minus_launch_us"]["placed"]["min"] == pytest.approx(1.0)
    assert in_volume_share(SPANS, dev) == 1.0
    # a trace 200 us off the spans' clock: no event inside a volume
    late = [DeviceEvent(e.name, e.cat, e.start_ns + 200 * US, e.end_ns + 200 * US,
                        None if e.launch_ns is None else e.launch_ns + 200 * US) for e in dev]
    assert in_volume_share(SPANS, late) == 0.0


def test_device_events_pair_launches_by_correlation():
    from portbench.spans import device_events

    events = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts_ns": 100,
               "dur_ns": 5, "args": {"correlation": 7}},
              {"ph": "X", "cat": "kernel", "name": "k2", "ts_ns": 300, "dur_ns": 20,
               "args": {"correlation": 9}},
              {"ph": "X", "cat": "kernel", "name": "k1", "ts_ns": 150, "dur_ns": 40,
               "args": {"correlation": 7}},
              {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts_ns": 90, "dur_ns": 30}]
    got = device_events(events)
    assert [(d.name, d.start_ns, d.end_ns, d.launch_ns) for d in got] == [
        ("k1", 150, 190, 100), ("k2", 300, 320, None)]


def test_readers_leave_out_what_they_cannot_read(tiny_root, monkeypatch):
    """No capture, a capture without device activity, a capture the run
    handed no cell, a cell whose driver serves no volumes, or a program
    without the tracer: every reader gives None, whatever the command line
    names."""
    import importlib.util

    from portbench import harness, spans

    names = ["host_dispatch_ms_per_batch", "host_copy_in_ms_per_batch",
             "host_maps_back_ms_per_volume", "edge_idle_ms_per_volume",
             "cnn_device_ms_per_batch", "vit_device_ms_per_batch",
             "fusion_device_ms_per_batch", "decoder_device_ms_per_batch"]
    readers = [harness.reader(n + ".serve") for n in names]
    empty = SimpleNamespace(light=SimpleNamespace(device=[]))
    assert [r(None) for r in readers] == [None] * 8
    assert [r(empty) for r in readers] == [None] * 8
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", "stc_tt.duke-volumes",
                                      "--seed", "1", "--trace", "1"])
    light = SimpleNamespace(device=[("k", 0.0, 1.0, "kernel", None)])
    busy = SimpleNamespace(light=light, cell=None, seed=None, device=None)
    assert [r(busy) for r in readers] == [None] * 8 and busy.spans is None
    train = SimpleNamespace(light=light, cell=harness.load_cell("stc_tt.goals-train"), seed=1,
                            device="cpu")
    assert spans.reading(train, names[0]) is None and train.spans is None
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name.endswith(".tracing") else real(name, *a))
    again = SimpleNamespace(light=light, cell=harness.load_cell("stc_tt.duke-volumes"), seed=1,
                            device="cpu")
    assert spans.reading(again, names[0]) is None and again.spans is None


def test_span_passes_of_a_tiny_cell(tiny_root, monkeypatch):
    """The passes in their own process on the CPU: the three host readings,
    no device reading (the capture has no device activity), one request a
    volume."""
    from portbench import harness, spans

    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([tiny_root, REPO]))
    cell = harness.load_cell("stc_tt.duke-volumes")
    t0 = time.perf_counter()
    got = spans.run_passes("stc_tt.duke-volumes", SEED, "cpu")
    assert time.perf_counter() - t0 < 300
    assert set(got.readings) == {"host_dispatch_ms_per_batch", "host_copy_in_ms_per_batch",
                                 "host_maps_back_ms_per_volume"}
    assert all(v > 0 for v in got.readings.values())
    assert got.device == []
    t = cell["traffic_file"]
    assert sum(got.volume_s) >= spans.SPAN_PASS_S
    for pass_spans, least in ((got.host, len(got.volume_s)), (got.spanned, t["capture_volumes"])):
        vols = [s for s in pass_spans if s.name == "serve.volume"]
        assert len(vols) == least >= t["capture_volumes"]
        batches = [s for s in pass_spans if s.name == "serve.batch"]
        assert sum(b.attrs["rows"] for b in batches) == len(vols) * t["scans"]
        assert {s.request_id for s in pass_spans} == {v.request_id for v in vols}


# A driver added as a file: drivers/volumes.py, writing the cell, seed and
# device of each build to built.txt in the benchmark's root.
NOTING_DRIVER = '''"""drivers/volumes.py, noting each build in built.txt."""

import os

from portbench import harness

_volumes = harness.driver("volumes")
SERVES_VOLUMES = True


def build(cell, seed, device):
    with open(os.path.join(harness.ROOT, "built.txt"), "a") as f:
        f.write(f"{cell['name']} {seed} {device}\\n")
    return _volumes.build(cell, seed, device)
'''


def test_span_passes_follow_the_handed_cell(tiny_root, monkeypatch):
    """A traced run's readers make the passes of the cell, seed and device
    the run set on the capture, built by that cell's own driver, in their
    own process; the command line of the process is not read."""
    import json

    from portbench import harness, spans

    b = os.path.join(tiny_root, "portbench")
    with open(os.path.join(b, "drivers", "noting.py"), "w") as f:
        f.write(NOTING_DRIVER)
    with open(os.path.join(b, "traffic", "duke-volumes.json")) as f:
        t = dict(json.load(f), driver="noting")
    with open(os.path.join(b, "traffic", "noted-volumes.json"), "w") as f:
        json.dump(t, f)
    with open(os.path.join(b, "limits", "stc_tt.duke-volumes.json")) as f:
        limits = f.read()
    with open(os.path.join(b, "limits", "stc_tt.noted-volumes.json"), "w") as f:
        f.write(limits)
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "stc_tt.noted-volumes", "config": "stc_tt",
                               "traffic": "noted-volumes", "chips": 1, "why": "a test cell"})
    with open(os.path.join(tiny_root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([tiny_root, REPO]))
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", "stc_st.duke-volumes",
                                      "--seed", "1", "--trace", "1"])
    capture = SimpleNamespace(light=SimpleNamespace(device=[("k", 0.0, 1.0, "kernel", None)]),
                              cell=harness.load_cell("stc_tt.noted-volumes"), seed=SEED,
                              device="cpu", paced_s=1.0, paced_units=3)
    assert harness.reader("host_dispatch_ms_per_batch.serve")(capture) > 0
    assert harness.reader("cnn_device_ms_per_batch.serve")(capture) is None  # no device events
    with open(os.path.join(tiny_root, "built.txt")) as f:
        assert f.read() == f"stc_tt.noted-volumes {SEED} cpu\n"


def test_a_drifting_device_clock_is_placed_by_the_launches():
    """A stream of launches every 20 us onto one in-order queue, each event
    starting 5 us after its launch or when the one before it ends (a backlog
    of 10 events of 60 us every 2 ms), one that waited 300 us on something
    unseen, and a device clock 2 ms behind the host's that drifts by 2 % of
    the time, which opens gaps of 0.4 us inside each backlog: on the host's
    clock every event starts within 1 us of when it truly did (within the
    drift over an anchor's span in the first and last), and every idle
    stretch of the truth is there within as much."""
    from portbench.spans import ANCHOR_NS, DeviceEvent, busy, on_host_clock

    true, end = [], 0
    for i in range(1000):
        launch = 1_000 * US + 20 * US * i
        dur = 60 * US if i % 100 < 10 else 10 * US
        start = max(launch + (300 if i == 520 else 5) * US, end)
        true.append(DeviceEvent(f"k{i}", "kernel", start, start + dur, launch))
        end = start + dur
    seen = [d._replace(start_ns=d.start_ns - 2000 * US + d.launch_ns // 50,
                       end_ns=d.end_ns - 2000 * US + d.launch_ns // 50) for d in true]
    placed, idle = on_host_clock(seen)
    got = {d.name: d for d in placed}
    lo, hi = true[0].launch_ns + ANCHOR_NS, true[-1].launch_ns - ANCHOR_NS
    for t in true:
        edge = not lo <= t.launch_ns <= hi
        assert abs(got[t.name].start_ns - t.start_ns) <= (0.02 * ANCHOR_NS if edge else 1 * US)
    want = [(a, b) for a, b in zip([-math.inf] + [b for _, b in busy(true)],
                                   [a for a, _ in busy(true)] + [math.inf])]
    inner = [(a, b) for a, b in idle if lo + 5 * US <= a and b <= hi - 5 * US]
    assert len(inner) == len([w for w in want if lo + 5 * US <= w[0] and w[1] <= hi - 5 * US])
    assert len(inner) > 400
    assert all(any(abs(a - wa) <= 1 * US and abs(b - wb) <= 1 * US for wa, wb in want)
               for a, b in inner)
    assert on_host_clock([DeviceEvent("k", "kernel", 5, 9, None)]) == (
        [DeviceEvent("k", "kernel", 5, 9, None)], [(-math.inf, 5), (9, math.inf)])
