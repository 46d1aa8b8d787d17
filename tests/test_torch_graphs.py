"""The single-card predictor's per-bucket CUDA graphs (``infer/graphs.py``)
on the card: replayed maps bit for bit the eager forward's, the ``tcct::``
calls of a replay the eager ones, each replayed segment inside the
``model.*`` span its ops ran in, and the maps of back-to-back volumes kept
apart.  Each test serves two buckets, with a padded tail, in bf16 through
both CNN branches of ``stc_tt`` and ``stc_st``, and ``stc_st`` with factorized
attention.  Every test needs a CUDA card
and the CUDA toolkit: without them each one skips.  Run on a GPU machine
with ``python -m pytest --noconftest tests/test_torch_graphs.py -q``."""

import collections
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from tcct_tpu_torch.infer import load_predictor
from tcct_tpu_torch.ops.kernels.crosscnn_fused import fused_cross_block
from tcct_tpu_torch.ops.kernels.dwconv import dwconv3x3
from tcct_tpu_torch.ops.kernels.metapool import metapool_block
from tcct_tpu_torch.utils import tracing

pytestmark = pytest.mark.gpu

CASES = [("stc_tt", "plain"), ("stc_tt", "fused"), ("stc_st", "plain"), ("stc_st", "fused")]
SECTIONS = ("model.cnn", "model.vit", "model.fusion", "model.decoder")
# each case's tape: (segments, tcct:: calls), the same in both buckets; the
# attention mixer's spans add none to these models
TAPES = {("stc_tt", "plain"): (18, 16), ("stc_tt", "fused"): (22, 21),
         ("stc_st", "plain"): (59, 91), ("stc_st", "fused"): (63, 96)}
BUCKETS = [(64, 96), (96, 160)]  # (H, W)
BS, N = 4, 10  # a volume: two whole batches and a tail of 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _predictor(net, impl, mixer="metapool"):
    return load_predictor("duke", net=net, cnn_impl=impl, batch_size=BS, dtype=torch.bfloat16,
                          device="cuda", seed=0, mixer=mixer)


def _volume(hw, seed):
    return np.random.default_rng(seed).integers(0, 256, (N,) + hw + (3,), dtype=np.uint8)


def _batches(vol):
    padded = np.concatenate([vol, np.zeros((-len(vol) % BS,) + vol.shape[1:], vol.dtype)])
    return [torch.from_numpy(padded[i: i + BS]).cuda() for i in range(0, len(padded), BS)]


def _eager_maps(pred, vol):
    return torch.cat([pred._forward(x) for x in _batches(vol)])[:len(vol)].cpu().numpy()


def _tape(pred, hw):
    return pred._tapes[(BS,) + hw + (3,)]


@pytest.mark.parametrize("net,impl", CASES)
def test_replayed_maps_are_the_eager_maps(cuda, net, impl):
    """Two volumes in each of two buckets: the first batch of a bucket runs
    eagerly and captures its tape, every later one replays it; the maps
    are bit for bit the eager forward's."""
    pred = _predictor(net, impl)
    for hw in BUCKETS:
        for seed in (1, 2):
            vol = _volume(hw, seed)
            np.testing.assert_array_equal(pred.predict_scans(vol), _eager_maps(pred, vol))
    st = pred.stats
    assert st["captures"] == 2 and st["eager"] == 2 and st["replayed"] == 2 * 2 * 3 - 2
    for hw in BUCKETS:
        tape = _tape(pred, hw)
        assert st["tapes"][(BS,) + hw + (3,)] == {"segments": tape.segments,
                                                  "tcct_calls": tape.tcct_calls,
                                                  "spans": tape.spans}
        assert (tape.segments, tape.tcct_calls) == TAPES[net, impl]
        assert tape.spans == dict.fromkeys(SECTIONS, 1)
        assert {n for names in tape.segment_spans for n in names} == set(SECTIONS)


def test_factor_attention_replays_the_eager_maps(cuda, tmp_path):
    """MPViT-Small with its own mixer, factorized attention and the CRPE
    (``stc_st``, ``mixer='factor'``): replayed maps bit for bit the eager
    forward's in both buckets; each replay opens one ``mixer.attention``
    span a block, 38, with the block's tokens, channels and heads, around
    the graphs and ``tcct::`` calls of its mixer."""
    pred = _predictor("stc_st", "plain", mixer="factor")
    for hw in BUCKETS:
        for seed in (1, 2):
            vol = _volume(hw, seed)
            np.testing.assert_array_equal(pred.predict_scans(vol), _eager_maps(pred, vol))
    assert pred.stats["captures"] == 2 and pred.stats["replayed"] == 2 * 2 * 3 - 2
    for hw in BUCKETS:
        tape = _tape(pred, hw)
        assert tape.spans == dict(dict.fromkeys(SECTIONS, 1), **{"mixer.attention": 38})
        assert pred.stats["tapes"][(BS,) + hw + (3,)]["spans"] == tape.spans
        x = _batches(_volume(hw, 7))[0]
        tape.x.copy_(x)
        spans, _, graph_launches = _traced(tape.replay, tmp_path)
        att = [s for s in spans if s.name == "mixer.attention"]
        grid = [(-(-hw[0] // 2 ** k)) * (-(-hw[1] // 2 ** k)) for k in (1, 2, 3, 4)]
        assert [(s.attrs["tokens"], s.attrs["dim"], s.attrs["heads"]) for s in att] == \
            [(grid[0], 64, 8)] * 2 + [(grid[1], 128, 8)] * 9 + [(grid[2], 216, 8)] * 18 \
            + [(grid[3], 288, 8)] * 9
        inside = [any(a.start_ns <= t <= a.end_ns for a in att) for t in graph_launches]
        assert inside == ["mixer.attention" in names for names in tape.segment_spans]


def test_back_to_back_volumes_keep_their_maps(cuda):
    """The static output is overwritten by every replay: each batch's maps
    are copied out before the next, so two volumes served one after the
    other return their own maps."""
    pred = _predictor("stc_tt", "plain")
    a, b = _volume(BUCKETS[0], 3), _volume(BUCKETS[0], 4)
    pred.predict_scans(a)  # the capture
    got_a, got_b = pred.predict_scans(a), pred.predict_scans(b)
    assert pred.stats["replayed"] == 3 + 3 + 2
    assert (got_a != got_b).mean() > 0.01
    np.testing.assert_array_equal(got_a, _eager_maps(pred, a))
    np.testing.assert_array_equal(got_b, _eager_maps(pred, b))
    for i in range(0, N - BS, BS):  # no two batches of a volume alike either
        assert not np.array_equal(got_b[i: i + BS], got_b[i + BS: i + 2 * BS])


class _Calls(TorchDispatchMode):
    """Logs the ``tcct::`` ops dispatched, by name without the overload."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "tcct":
            self.names.append(func._opname)
        return func(*args, **(kwargs or {}))


def _counters():
    return {"metapool_block": metapool_block.launches, "dwconv3x3": dwconv3x3.launches,
            "dwconv3x3_s2": dwconv3x3.launches_s2,
            "fused_cross_block": fused_cross_block.launches}


def _counted(fn):
    """The ``tcct::`` op names ``fn`` dispatches, in order, and the launch
    counters' moves."""
    before = _counters()
    with _Calls() as calls:
        fn()
    torch.cuda.synchronize()
    return calls.names, {k: v - before[k] for k, v in _counters().items()}


@pytest.mark.parametrize("net,impl", CASES)
def test_replay_makes_the_eager_tcct_calls(cuda, net, impl):
    """A replayed batch makes the eager batch's ``tcct::`` calls: the same
    ops in the same order, the same launches of each kernel."""
    pred = _predictor(net, impl)
    for hw in BUCKETS:
        x = _batches(_volume(hw, 5))[0]
        pred.predict_scans(x.cpu().numpy())  # the capture
        tape = _tape(pred, hw)
        eager_names, eager_counts = _counted(lambda: pred._forward(x))
        tape.x.copy_(x)
        names, counts = _counted(tape.replay)
        assert names == eager_names and len(names) == tape.tcct_calls
        assert counts == eager_counts and sum(counts.values()) - counts["dwconv3x3_s2"] == \
            tape.tcct_calls
        assert counts["fused_cross_block"] == (5 if impl == "fused" else 0)
        assert torch.equal(tape.out, pred._forward(x))


def _traced(fn, tmp_path):
    """``fn`` under the profiler (the card's activity) with tracing on: the
    spans, each kernel's launch and each ``cudaGraphLaunch``, in Unix ns
    (a launch's middle: a replayed segment launches a few us after its
    span opens, as near as the two clocks agree)."""
    tracing.enable()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
    finally:
        spans = tracing.drain()
        tracing.disable()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    launches, graph_launches, kernels = {}, [], []
    for ev in trace["traceEvents"]:
        if ev.get("ph") != "X" or "ts" not in ev or ev.get("cat") not in (
                "cuda_runtime", "cuda_driver", "kernel"):
            continue
        ts = base + round((float(ev["ts"]) + float(ev.get("dur", 0)) / 2) * 1000)
        if ev["cat"] == "kernel":
            kernels.append(ev["args"].get("correlation"))
        else:
            launches[ev["args"].get("correlation")] = ts
            if ev["name"] == "cudaGraphLaunch":
                graph_launches.append(ts)
    return spans, [launches.get(c) for c in kernels], sorted(graph_launches)


def _section(spans, t):
    """The innermost ``model.*`` span open at ``t``, or None."""
    inside = [s for s in spans if s.name.startswith("model.") and s.start_ns <= t <= s.end_ns]
    return max(inside, key=lambda s: s.start_ns).name if inside else None


@pytest.mark.parametrize("net,impl", CASES)
def test_replayed_segments_lie_in_their_spans(cuda, net, impl, tmp_path):
    """With tracing on, each replayed segment's ``cudaGraphLaunch`` lies in
    the ``model.*`` span its ops ran in when captured, and each section of
    the model launches as many kernels replayed as eagerly."""
    pred = _predictor(net, impl)
    for hw in BUCKETS:
        x = _batches(_volume(hw, 6))[0]
        pred.predict_scans(x.cpu().numpy())
        tape = _tape(pred, hw)
        tape.x.copy_(x)
        spans, kernels, graph_launches = _traced(tape.replay, tmp_path)
        assert len(graph_launches) == tape.segments
        assert [_section(spans, t) for t in graph_launches] == \
            [names[-1] if names else None for names in tape.segment_spans]
        eager_spans, eager_kernels, none = _traced(lambda: pred._forward(x), tmp_path)
        assert none == [] and None not in kernels and None not in eager_kernels
        by = collections.Counter(_section(spans, t) for t in kernels)
        eager_by = collections.Counter(_section(eager_spans, t) for t in eager_kernels)
        assert by == eager_by and set(by) >= {"model.cnn", "model.vit", "model.decoder"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["site", "site_no_norms", "dwconv_s1", "dwconv_s2", "fused"])
def test_out_overload_launches_the_same_kernel(cuda, case, dtype):
    """On the card an ``out`` overload launches its op's kernel once, into
    the given outputs, bit for bit what the op returns."""
    from tests.test_torch_out_overloads import CASES, _outputs

    op, args = CASES[case](dtype)
    args = tuple(a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args)
    counters = {"metapool_block": metapool_block, "dwconv3x3": dwconv3x3,
                "fused_cross_block": fused_cross_block}
    counter = counters[op._qualified_op_name.split("::")[1]]
    want = op.default(*args)
    want = want if isinstance(want, tuple) else (want,)
    outs = _outputs(op, args)
    n = counter.launches
    op.out(*args, *outs)
    torch.cuda.synchronize()
    assert counter.launches == n + 1
    for o, w in zip(outs, want):
        assert o.device.type == "cuda" and torch.equal(o, w)
