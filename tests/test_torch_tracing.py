"""The port's serving spans (``tcct_tpu_torch/utils/tracing.py``) on the CPU:
off they cost no clock read and no record, on they nest by parent and
request, ``predict_volume`` records one request of the documented shape
without changing its maps, the drained times sit on ``torch.profiler``'s
Chrome-trace clock, and ``torch.export`` traces through them."""

import contextlib
import json
import math
import os
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from tcct_tpu_torch.data import DatasetGeometry
from tcct_tpu_torch.infer import VolumePredictor
from tcct_tpu_torch.infer.export import export_model, load_exported
from tcct_tpu_torch.models import RegNet, get_model
from tcct_tpu_torch.models.layers import init_weights
from tcct_tpu_torch.utils import tracing

NC = 5
GEO = DatasetGeometry("tiny", NC, 0, 32, "resize", (32, 32))
MODEL_SECTIONS = ["model.cnn", "model.vit", "model.fusion", "model.decoder"]


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


@pytest.fixture(scope="module")
def model():
    m = RegNet(get_model("stc_tt", NC), out_channels=NC)
    init_weights(m, torch.Generator().manual_seed(0))
    return m.eval()


def _volume(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def _children(spans, parent):
    return [s for s in sorted(spans, key=lambda s: s.start_ns) if s.parent_id == parent.span_id]


def test_off_records_nothing_and_returns_the_shared_noop():
    assert tracing.span("serve.batch", rows=3) is tracing.NO_SPAN
    with tracing.span("serve.volume"):
        with tracing.span("serve.batch", rows=2):
            pass
    assert tracing.drain() == []


class _Boom:
    def __getattr__(self, name):
        raise AssertionError(f"the clock was read while tracing is off ({name})")


def test_off_reads_no_clock_and_allocates_nothing(monkeypatch):
    """Off, a span reads no clock and leaves no allocation of the tracer's:
    10,000 spans leave tracemalloc no block from ``tracing.py``."""

    def boom():
        raise AssertionError("the clock was read while tracing is off")

    monkeypatch.setattr(tracing, "perf_counter_ns", boom)
    monkeypatch.setattr(tracing, "time", _Boom())
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for i in range(10_000):
            with tracing.span("serve.batch", rows=i & 7):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = [tracemalloc.Filter(True, tracing.__file__)]
    grown = [d for d in after.filter_traces(mine).compare_to(before.filter_traces(mine), "lineno")
             if d.count_diff > 0]
    assert grown == []
    assert tracing.drain() == []


def test_spans_nest_by_parent_and_share_the_request():
    tracing.enable()
    with tracing.span("serve.volume", scans=3):
        with tracing.span("serve.batch", rows=2):
            with tracing.span("serve.dispatch"):
                pass
        with tracing.span("serve.maps_back"):
            pass
    with tracing.span("serve.volume", scans=1):
        pass
    spans = {s.name + str(s.attrs.get("scans", "")): s for s in tracing.drain()}
    first, second = spans["serve.volume3"], spans["serve.volume1"]
    assert first.parent_id is None and second.parent_id is None
    assert first.request_id != second.request_id
    assert spans["serve.batch"].parent_id == first.span_id
    assert spans["serve.batch"].attrs == {"rows": 2}
    assert spans["serve.dispatch"].parent_id == spans["serve.batch"].span_id
    assert spans["serve.maps_back"].parent_id == first.span_id
    assert {s.request_id for n, s in spans.items() if n != "serve.volume1"} == {first.request_id}
    for s in spans.values():
        assert s.start_ns <= s.end_ns
    assert first.start_ns <= spans["serve.dispatch"].start_ns <= spans["serve.dispatch"].end_ns \
        <= first.end_ns


@pytest.mark.parametrize("on", [False, True])
def test_borders_hand_this_threads_spans_to_the_hook(on):
    """Inside ``borders(record)`` this thread's ``span(name, **attrs)`` is
    ``record(name, attrs)`` whether tracing is on or off, and records
    nothing; another thread's spans are as before; after it tracing is as
    it was."""
    if on:
        tracing.enable()
    seen, other = [], []

    def record(name, attrs):
        seen.append((name, attrs))
        return contextlib.nullcontext()

    with tracing.borders(record):
        with tracing.span("model.cnn", rows=1):
            with tracing.span("model.vit"):
                pass
        t = threading.Thread(target=lambda: other.append(tracing.span("serve.batch")))
        t.start()
        t.join()
    assert seen == [("model.cnn", {"rows": 1}), ("model.vit", {})]
    assert (other[0] is tracing.NO_SPAN) is not on
    assert tracing.drain() == []
    assert (tracing.span("serve.batch") is tracing.NO_SPAN) is not on
    with tracing.span("serve.batch"):
        pass
    assert [s.name for s in tracing.drain()] == (["serve.batch"] if on else [])


def test_drain_empties_and_gives_unix_nanoseconds():
    tracing.enable()
    before = time.time_ns()
    with tracing.span("serve.volume"):
        time.sleep(0.002)
    after = time.time_ns()
    (s,) = tracing.drain()
    assert tracing.drain() == []
    assert before - 1_000_000 <= s.start_ns < s.end_ns <= after + 1_000_000
    assert s.end_ns - s.start_ns >= 2_000_000


def test_disable_keeps_the_spans_until_drain():
    tracing.enable()
    with tracing.span("serve.volume"):
        pass
    tracing.disable()
    with tracing.span("serve.batch"):
        pass
    assert [s.name for s in tracing.drain()] == ["serve.volume"]


def test_a_full_buffer_counts_what_it_drops(monkeypatch):
    """The buffer keeps at most ``CAPACITY`` undrained spans, the first ones,
    and counts the rest; a drain makes room, and enabling again resets the
    count."""
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    tracing.enable()
    for i in range(5):
        with tracing.span("serve.batch", rows=i):
            pass
    assert tracing.dropped() == 2
    assert [s.attrs["rows"] for s in tracing.drain()] == [0, 1, 2]
    with tracing.span("serve.batch", rows=5):
        pass
    assert [s.attrs["rows"] for s in tracing.drain()] == [5] and tracing.dropped() == 2
    tracing.disable()
    tracing.enable()
    assert tracing.dropped() == 0


def test_threads_keep_their_own_stacks():
    """A span opened on another thread while one is open here is a root of
    its own request, not a child."""
    tracing.enable()
    with tracing.span("serve.volume"):
        worker = threading.Thread(target=_one_span, args=("serve.batch",))
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
    spans = {s.name: s for s in tracing.drain()}
    assert spans["serve.batch"].parent_id is None
    assert spans["serve.batch"].request_id != spans["serve.volume"].request_id


def _one_span(name):
    with tracing.span(name):
        pass


@pytest.mark.parametrize("n,bs", [(5, 2), (4, 4)])
def test_predict_volume_is_one_request(model, n, bs):
    """One ``serve.volume``, ceil(n / bs) ``serve.batch`` with one copy-in
    and one dispatch each (the four model sections inside the dispatch, in
    order) and one ``serve.maps_back``; the batches' rows sum to n."""
    pred = VolumePredictor(model, GEO, batch_size=bs, dtype=torch.float32, device="cpu")
    tracing.enable()
    pred.predict_volume(_volume(n))
    spans = tracing.drain()
    (vol,) = [s for s in spans if s.name == "serve.volume"]
    assert vol.parent_id is None and vol.attrs == {"scans": n}
    assert {s.request_id for s in spans} == {vol.request_id}
    top = _children(spans, vol)
    assert [s.name for s in top] == ["serve.batch"] * math.ceil(n / bs) + ["serve.maps_back"]
    assert sum(b.attrs["rows"] for b in top[:-1]) == n
    for b in top[:-1]:
        copy_in, dispatch = _children(spans, b)
        assert (copy_in.name, dispatch.name) == ("serve.copy_in", "serve.dispatch")
        sections = _children(spans, dispatch)
        assert [s.name for s in sections] == MODEL_SECTIONS
        assert dispatch.start_ns <= sections[0].start_ns and sections[-1].end_ns <= dispatch.end_ns
        assert dispatch.attrs == {"replayed": False}  # the CPU serves every batch eagerly
    assert len(spans) == 1 + math.ceil(n / bs) * (3 + len(MODEL_SECTIONS)) + 1


def test_maps_are_bitwise_the_same_traced(model):
    pred = VolumePredictor(model, GEO, batch_size=2, dtype=torch.float32, device="cpu")
    vol = _volume(5, seed=1)
    untraced = pred.predict_volume(vol)
    tracing.enable()
    traced = pred.predict_volume(vol)
    tracing.disable()
    assert len(tracing.drain()) > 0
    np.testing.assert_array_equal(traced, untraced)


def test_postprocess_and_fused_cnn_spans(model):
    """``native_hw`` adds ``serve.postprocess`` under the volume; on the
    fused CNN path ``model.cnn`` is the predictor's fused branch, still
    first inside the dispatch."""
    pred = VolumePredictor(model, GEO, batch_size=2, dtype=torch.float32, device="cpu",
                           cnn_impl="fused")
    tracing.enable()
    maps = pred.predict_volume(_volume(2), native_hw=(40, 48))
    spans = tracing.drain()
    assert maps.shape == (2, 40, 48)
    (vol,) = [s for s in spans if s.name == "serve.volume"]
    assert [s.name for s in _children(spans, vol)] == ["serve.batch", "serve.maps_back",
                                                       "serve.postprocess"]
    (dispatch,) = [s for s in spans if s.name == "serve.dispatch"]
    assert [s.name for s in _children(spans, dispatch)] == MODEL_SECTIONS


def _block(mixer, dim=64, heads=8):
    from tcct_tpu_torch.models.mpvit import ConvPosEnc, ConvRelPosEnc, MHCABlock

    crpe = ConvRelPosEnc(dim // heads, ((3, 2), (5, 3), (7, 3)))
    blk = MHCABlock(dim, 4, ConvPosEnc(dim), crpe, mixer=mixer, num_heads=heads)
    init_weights(blk, torch.Generator().manual_seed(1))
    return blk


@pytest.mark.parametrize("serving", [True, False])
@pytest.mark.parametrize("mixer", ["factor", "hydra", "metapool", "metapool2d"])
def test_attention_mixer_records_one_span(mixer, serving):
    """An attention mixer's call (the mixer and its CRPE) is one
    ``mixer.attention`` span with its tokens, channels and heads, served or
    trained; a MetaPool block records none; the output is the same
    untraced."""
    blk = _block(mixer)
    x = torch.randn(2, 4 * 6, 64, generator=torch.Generator().manual_seed(2))
    ctx = torch.inference_mode() if serving else contextlib.nullcontext()
    blk.train(not serving)
    with ctx:
        torch.manual_seed(3)
        want = blk(x, (4, 6))
        tracing.enable()
        torch.manual_seed(3)
        got = blk(x, (4, 6))
    spans = tracing.drain()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if mixer in ("factor", "hydra"):
        (s,) = spans
        assert s.name == "mixer.attention" and s.attrs == {"tokens": 24, "dim": 64, "heads": 8}
    else:
        assert spans == []


@pytest.mark.parametrize("mixer", ["factor", "hydra"])
def test_attention_mixer_on_a_width_shard_records_no_span(mixer):
    """On a width shard (here one rank, whose all-reduces return their
    input) the attention mixer records no span and serves as it does off
    the shard."""
    from types import SimpleNamespace

    blk = _block(mixer).eval()
    x = torch.randn(2, 4 * 6, 64, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        want = blk(x, (4, 6))
        blk.width_shard = blk.att.width_shard = SimpleNamespace(all_reduce_=lambda t, op="sum": t)
        tracing.enable()
        got = blk(x, (4, 6))
    assert tracing.drain() == []
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_factor_predictor_spans_every_block():
    """MPViT-Small with factorized attention: each dispatch's
    ``model.vit`` holds one ``mixer.attention`` span for each of its 38
    blocks, stage by stage (2, 9, 18, 9 blocks on the 16x16, 8x8, 4x4 and
    2x2 token grids of a 32x32 scan), and the maps are the untraced maps."""
    m = RegNet(get_model("stc_st", NC, variant="infer", mixer="factor"), out_channels=NC)
    init_weights(m, torch.Generator().manual_seed(0))
    pred = VolumePredictor(m.eval(), GEO, batch_size=2, dtype=torch.float32, device="cpu")
    vol = _volume(3, seed=2)
    untraced = pred.predict_volume(vol)
    tracing.enable()
    traced = pred.predict_volume(vol)
    spans = tracing.drain()
    np.testing.assert_array_equal(traced, untraced)
    by_id = {s.span_id: s for s in spans}
    dispatches = [s for s in spans if s.name == "serve.dispatch"]
    assert len(dispatches) == 2
    for d in dispatches:
        (vit,) = [s for s in _children(spans, d) if s.name == "model.vit"]
        att = [s for s in spans if s.name == "mixer.attention"
               and vit.start_ns <= s.start_ns <= s.end_ns <= vit.end_ns]
        assert all(by_id[s.parent_id] is vit for s in att)
        stages = [(s.attrs["tokens"], s.attrs["dim"], s.attrs["heads"]) for s in att]
        assert stages == [(256, 64, 8)] * 2 + [(64, 128, 8)] * 9 + [(16, 216, 8)] * 18 \
            + [(4, 288, 8)] * 9


def test_drained_start_is_on_the_profilers_clock(tmp_path):
    """A span and a ``record_function`` range opened at once: the span's
    drained start and end and the range's ``ts * 1000 +
    baseTimeNanoseconds`` agree within 1 ms, the span inside the range (a
    range opened first outside the probe takes the profiler's first-call
    cost)."""
    path = str(tmp_path / "trace.json")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm-up"):
            pass
        tracing.enable()
        with torch.profiler.record_function("probe"):
            with tracing.span("probe"):
                time.sleep(0.003)
        spans = tracing.drain()
        tracing.disable()
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    (ev,) = [e for e in trace["traceEvents"] if e.get("name") == "probe" and e.get("ph") == "X"]
    start = float(ev["ts"]) * 1000 + int(trace.get("baseTimeNanoseconds", 0))
    end = start + float(ev["dur"]) * 1000
    (s,) = spans
    assert 0 <= s.start_ns - start < 1e6, (s.start_ns - start) / 1e6
    assert 0 <= end - s.end_ns < 1e6, (end - s.end_ns) / 1e6


@pytest.mark.parametrize("on", [False, True])
def test_export_traces_through_spans(model, tmp_path, on):
    """``torch.export`` of the serving forward, with tracing off and on:
    the program runs and gives the eager logits; export records no span."""
    x = torch.from_numpy(_volume(2).astype(np.float32) / 255.0)
    if on:
        tracing.enable()
    path = export_model(model, x, os.path.join(str(tmp_path), "stc_tt.pt2"))
    assert tracing.drain() == []
    tracing.disable()
    with torch.inference_mode():
        want = model(x)[0]
    torch.testing.assert_close(load_exported(path)(x), want, rtol=0, atol=0)
