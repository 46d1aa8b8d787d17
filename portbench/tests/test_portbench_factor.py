"""The ``stc_st_factor`` configuration on the CPU at tiny shapes: the port's
factorized attention against ``reference/factor.py``, the cell
``stc_st_factor.duke-volumes`` run end to end and caught when its answer is
altered, the two attention readers on hand-made span passes, and
``reference/attention_costs.py`` against a hand count."""

from __future__ import annotations

import json
import os

import pytest
import torch
from test_portbench_cells import _altered_answer, run_tiny

from tcct_tpu_torch.utils.tracing import Span

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "stc_st_factor.duke-volumes"


def _cfg(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def _models(nc, variant, seed=5, calib=None):
    """The reference and the program with factorized attention, on the
    reference's seeded weights, calibrated on the NCHW batch ``calib`` as
    the serving driver calibrates them where it is given."""
    from portbench import scans
    from portbench.reference import factor
    from tcct_tpu_torch.models import RegNet, get_model

    cfg = _cfg("stc_st_factor")
    ref = factor.RegNet(cfg, nc, variant)
    scans.fill_weights(ref, scans.generator(seed, 2, "cpu"))
    if calib is not None:
        factor.calibrate(ref, calib)
    prog = RegNet(get_model(cfg["net"], nc, variant=variant, drop_path_rate=cfg["drop_path_rate"],
                            mixer=cfg["mixer"]), out_channels=nc)
    prog.load_state_dict(ref.state_dict(), strict=True)
    return ref, prog


def _cut(ref, x, factor):
    """The reference's logits on ``x`` with every attention's output cut to
    nothing, the weights restored after."""
    keep = {k: v.clone() for k, v in ref.state_dict().items()}
    for blk in ref.modules():
        if isinstance(blk, factor.MHCABlock):
            blk.att.proj.weight.zero_()
            blk.att.proj.bias.zero_()
    cut = ref.base.run(x, factor.Ctx())[0]
    ref.load_state_dict(keep)
    return cut


@pytest.mark.parametrize("calibrated", [False, True])
def test_serving_logits_match(calibrated):
    """The port's stc_st with ``mixer='factor'`` against the reference's
    attention and CRPE in f32, at the other configurations' bound (1e-5 of
    the logits' range), on the seeded weights and on the weights the
    reference's ``calibrate`` scales; with every block's attention output
    cut to nothing, the reference moves by far more than that bound."""
    from portbench import scans
    from portbench.reference import factor

    imgs, _ = scans.banded(2, (64, 96), 9, scans.generator(1, 1, "cpu"), "cpu")
    x = imgs.float() / 255.0
    ref, prog = _models(9, "infer", calib=x.permute(0, 3, 1, 2) if calibrated else None)
    with torch.no_grad():
        want = ref.eval().base.run(x.permute(0, 3, 1, 2), factor.Ctx())[0]
        got = prog.eval()(x)[0].permute(0, 3, 1, 2)
        bound = 1e-5 * want.abs().max()
        assert (got - want).abs().max() <= bound, (got - want).abs().max()
        cut = _cut(ref, x.permute(0, 3, 1, 2), factor)
    assert (cut - want).abs().max() > 20 * bound


def test_calibrate_gives_the_attention_weight():
    """At the seeded scale, cutting every attention's output changes under
    1 % of the served classes; after ``calibrate`` (qkv at C ** -0.5, the
    CRPE at 1 / w, each mixer's output at the residual's root mean square)
    it changes over 10 %, more than the check's limit on
    ``map_mismatch_share`` lets pass."""
    from portbench import scans
    from portbench.reference import factor, model

    imgs, _ = scans.banded(4, (64, 96), 9, scans.generator(1, 1, "cpu"), "cpu")
    x = imgs.permute(0, 3, 1, 2).float() / 255.0
    with open(os.path.join(BENCH, "limits", CELL + ".json")) as f:
        limit = json.load(f)["numbers"]["map_mismatch_share"]["limit"]
    flips = {}
    for cal in (model.calibrate, factor.calibrate):
        ref = factor.RegNet(_cfg("stc_st_factor"), 9, "infer")
        scans.fill_weights(ref, scans.generator(5, 2, "cpu"))
        cal(ref, x[:2])
        with torch.no_grad():
            want = ref.eval().base.run(x, factor.Ctx())[0].argmax(1)
            flips[cal] = float((_cut(ref, x, factor).argmax(1) != want).float().mean())
    assert flips[model.calibrate] < 0.01 and flips[factor.calibrate] > max(0.1, limit)
    for m in ref.modules():
        if isinstance(m, factor.FactorAttention):
            assert float(m.qkv.weight.detach().std()) == pytest.approx(m.qkv.in_features ** -0.5)
        elif isinstance(m, model.ConvRelPosEnc):
            for conv in m.conv_list:
                assert float(conv.weight.detach().std()) == pytest.approx(1 / conv.kernel_size[0])


def test_reference_trains_the_crpe():
    """The CRPE is part of what a step moves here, unlike in ``model.py``."""
    from portbench.reference import factor, model

    ref = factor.RegNet(_cfg("stc_st_factor"), 5, "train")
    trained = factor.trained_parameters(ref)
    assert any(".crpe." in k for k in trained) and any(".att.qkv." in k for k in trained)
    assert not any(k.startswith(("base.fuse.", "base.base_vit.cls_head.")) for k in trained)
    assert not any(".crpe." in k for k in model.trained_parameters(ref))


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(tiny_root, trace):
    from portbench import harness

    assert harness.load_cell(CELL)["reference"].__name__ == "portbench.reference.factor"
    line = run_tiny(CELL, trace)
    assert list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    if trace:
        assert line["metrics"] == {}  # a CPU capture holds no device time: nothing is read
    else:
        assert {"serve_bscans_per_s", "setup_s"} <= set(line["metrics"])


def test_broken_timed_path_is_not_correct(tiny_root):
    line = run_tiny(CELL, fault=_altered_answer)
    assert line["correct"] is False, line["checks"]


US = 1000


def _span(name, a, b, sid, parent, **attrs):
    return Span(name, a * US, b * US, sid, parent, 1, attrs)


def _passes(per_batch=(2, 2)):
    """Two batches in one volume, each a dispatch with a ``model.vit``
    holding ``per_batch[i]`` attention spans of 10 us from 20 us on."""
    from portbench.spans import DeviceEvent, SpanPasses

    spanned, device, sid = [_span("serve.volume", 0, 400, 1, None, scans=4)], [], 2
    for i, n in enumerate(per_batch):
        t = 200 * i
        spanned += [_span("serve.batch", t, t + 190, sid, 1, rows=2),
                    _span("serve.dispatch", t + 10, t + 150, sid + 1, sid),
                    _span("model.vit", t + 15, t + 140, sid + 2, sid + 1)]
        for k in range(n):
            a = t + 20 + 30 * k
            spanned.append(_span("mixer.attention", a, a + 10, sid + 3 + k, sid + 2,
                                 tokens=64, dim=64, heads=8))
            # launched inside the span: 4 us on the device; its neighbour,
            # launched just after the span, is not the attention's
            device.append(DeviceEvent("att", "kernel", (a + 12) * US, (a + 16) * US,
                                      (a + 5) * US))
            device.append(DeviceEvent("mlp", "kernel", (a + 16) * US, (a + 30) * US,
                                      (a + 11) * US))
        sid += 3 + n
    device.append(DeviceEvent("late", "kernel", 500 * US, 600 * US, 450 * US))  # after the volume
    return SpanPasses([], [], spanned, device, {})


def _capture(passes, blocks):
    from types import SimpleNamespace

    cfg = {"mpvit": {"num_path": [blocks], "num_layers": [1], "embed_dims": [64],
                     "num_heads": [8]}}
    traffic = {"batch": 2, "hw": [16, 16], "dtype": "bfloat16"}
    return SimpleNamespace(light=SimpleNamespace(device=[object()]), spans=passes,
                           cell={"config_file": cfg, "traffic_file": traffic})


@pytest.mark.parametrize("per_batch,blocks,want", [((2, 2), 2, 0.008), ((2, 1), 2, None),
                                                   ((2, 2), 3, None)])
def test_attention_readers(per_batch, blocks, want):
    """An event launched inside a ``mixer.attention`` span is the
    attention's (2 a batch, 4 us each: 0.008 ms a batch); one launched
    after it, or after the last volume, is not; a batch holding other than
    the configuration's blocks gives None.  The roofline is the batch's
    bound over that time."""
    from portbench import harness
    from portbench.reference.attention_costs import batch_bound_s

    cap = _capture(_passes(per_batch), blocks)
    got = harness.reader("attention_device_ms_per_batch.serve")(cap)
    roof = harness.reader("attention_roofline_pct.serve")(cap)
    if want is None:
        assert got is None and roof is None
    else:
        assert got == pytest.approx(want)
        bound_ms = batch_bound_s(cap.cell["config_file"], cap.cell["traffic_file"]) * 1e3
        assert roof == pytest.approx(100 * bound_ms / want)


def test_attention_readers_without_passes():
    """A capture with no device activity, or whose passes could not be
    made (a program without the tracer), gives nothing to read."""
    from types import SimpleNamespace

    from portbench import harness

    for cap in (None, SimpleNamespace(light=SimpleNamespace(device=[]))):
        assert harness.reader("attention_device_ms_per_batch.serve")(cap) is None
        assert harness.reader("attention_roofline_pct.serve")(cap) is None
    cap = _capture(None, 2)
    assert harness.reader("attention_device_ms_per_batch.serve")(cap) is None


def test_attention_costs_by_hand():
    """stc_st's stage 2 at duke's bucket, batch 8, bf16: 18 blocks of 216
    channels, 8 heads of 27, on a 32 x 72 grid."""
    from portbench.reference import attention_costs as ac

    cfg, hw = _cfg("stc_st_factor"), (256, 576)
    assert list(ac.grids(hw, 4)) == [(128, 288), (64, 144), (32, 72), (16, 36)]
    assert list(ac.stage_blocks(cfg, hw))[2] == (18, 2304, 216, 8)
    assert ac.mixers(cfg) == 2 + 9 + 18 + 9 == 38
    B, N, C, d = 8, 2304, 216, 27
    per_token = 3 * C * C + C * C + C * d + C * d  # qkv, proj, k^T v, q kv: multiply-adds
    taps = 2 * 3 * 3 + 3 * 5 * 5 + 3 * 7 * 7  # heads x window area
    weights = (3 * C * C + 3 * C) + (C * C + C) + (d * taps + C)
    nbytes, mm, crpe = ac.block_costs(B, N, C, 8, 2)
    assert nbytes == (2 * B * N * C + weights) * 2
    assert mm == 2 * B * N * per_token
    assert crpe == 2 * B * N * d * taps
    bound = ac.block_bound_s(B, N, C, 8, "bfloat16")
    assert bound == max(nbytes / 3.35e12, mm / 989e12, crpe / 67e12)
    traffic = {"batch": B, "hw": list(hw), "dtype": "bfloat16"}
    total = sum(n * ac.block_bound_s(B, t, c, h, "bfloat16")
                for n, t, c, h in ac.stage_blocks(cfg, hw))
    assert ac.batch_bound_s(cfg, traffic) == pytest.approx(total)
