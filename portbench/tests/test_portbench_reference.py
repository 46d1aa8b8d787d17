"""The frozen reference against the program on the CPU at a small size, and
the frozen operation formulas against the program's ``*_flops`` functions.
A drift in either shows here."""

from __future__ import annotations

import json
import os

import pytest
import torch
import torch.nn.functional as F

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def _models(name, nc, variant, seed=5):
    from portbench import scans
    from portbench.reference import model as ref_model
    from tcct_tpu_torch.models import RegNet, get_model

    cfg = _cfg(name)
    ref = ref_model.RegNet(cfg, nc, variant)
    scans.fill_weights(ref, scans.generator(seed, 2, "cpu"))
    prog = RegNet(get_model(cfg["net"], nc, variant=variant, drop_path_rate=cfg["drop_path_rate"],
                            mixer=cfg["mixer"]), out_channels=nc)
    prog.load_state_dict(ref.state_dict(), strict=True)
    return ref, prog


@pytest.mark.parametrize("name", ["stc_tt", "stc_st"])
def test_serving_logits_match(name):
    from portbench import scans
    from portbench.reference import model as ref_model

    ref, prog = _models(name, 9, "infer")
    imgs, _ = scans.banded(2, (64, 96), 9, scans.generator(1, 1, "cpu"), "cpu")
    x = imgs.float() / 255.0
    with torch.no_grad():
        want = ref.eval().base.run(x.permute(0, 3, 1, 2), ref_model.Ctx())[0]
        got = prog.eval()(x)[0].permute(0, 3, 1, 2)
    # f32 on both sides, summed in other orders: 1e-5 of the logits' range
    assert (got - want).abs().max() <= 1e-5 * want.abs().max(), (got - want).abs().max()


def test_train_step_matches():
    """One f32 step of the program (``build_train_step``) and of the
    reference from one state, on one batch and one generator state: the
    losses, every first gradient and the new parameters and statistics."""
    from portbench import scans
    from portbench.reference import train as ref_train
    from tcct_tpu_torch.train import AdamW, TrainConfig, build_train_step
    from tcct_tpu_torch.train.state import trainable_parameters

    ref, prog = _models("stc_tt", 5, "train")
    imgs, labs = scans.banded(2, (64, 64), 5, scans.generator(1, 1, "cpu"), "cpu")
    opt = AdamW(1e-4, weight_decay=2e-4, clip_norm=12.0)
    cfg = TrainConfig(ds=True, udh=True, reg=True, augment=False, dtype=torch.float32,
                      n_class=5, crop_hw=(64, 64))
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    state0 = {k: v.clone() for k, v in ref.state_dict().items()}
    step = build_train_step(prog, opt, cfg, device="cpu", generator=gen)
    metrics, _ = step(imgs, labs)
    tr = ref_train.Trainer(ref.train())
    gen.set_state(state)
    out = tr.step(imgs.float() / 255.0, F.one_hot(labs.long(), 5).float(), gen)
    assert abs(float(metrics["total"]) - out["total"]) <= 1e-5 * abs(out["total"])
    assert tr.names == list(trainable_parameters(prog))
    norms = {k: float(g.norm()) for k, g in out["grads"].items()}
    med = sorted(norms.values())[len(norms) // 2]
    norm = float(metrics["grad_norm"])
    unclip = norm / 12.0 if norm >= 12.0 else 1.0  # the step hands AdamW unclipped gradients
    for k, m in zip(tr.names, opt.mu):
        g = m / 0.1 * unclip
        assert (g - out["grads"][k]).norm() <= 1e-3 * max(norms[k], med), k
    got, want = prog.state_dict(), ref.state_dict()
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            assert torch.allclose(got[k], v, atol=1e-6, rtol=1e-5), k
    # Adam's update of an element whose gradient is nought to rounding takes
    # the rounding's sign: the parameters are held leaf by leaf, by the norm
    # of their change, where the reference's gradient is not nought
    moving = [k for k in tr.names if norms[k] >= 1e-3 * med]
    change = {k: float((want[k] - state0[k]).norm()) for k in moving}
    cmed = sorted(change.values())[len(change) // 2]
    for k in moving:
        gap = abs(float((got[k] - state0[k]).norm()) - change[k])
        assert gap <= 0.05 * max(change[k], cmed), k


def test_formulas_match_the_program():
    """Each frozen formula gives the program's operation count at the
    shapes of today's cells."""
    from portbench.reference import costs
    from tcct_tpu_torch.ops.kernels.bnstats import bn_act_train_flops
    from tcct_tpu_torch.ops.kernels.crosscnn_fused import fused_cross_block_flops
    from tcct_tpu_torch.ops.kernels.dwconv import dwconv3x3_flops
    from tcct_tpu_torch.ops.kernels.metapool import metapool_block_flops, metapool_flops

    tokens = [(8, 128 * 288, 64), (8, 64 * 144, 96), (8, 32 * 72, 216), (8, 16 * 36, 288)]
    for x in tokens:
        assert costs.metapool_tokens([x], 2, [])[1] == metapool_flops(x)
        assert costs.metapool_block([x], 2, [])[1] == metapool_block_flops(x)
    for x in [(8, 128, 288, 64), (8, 64, 144, 96), (8, 32, 72, 160), (8, 128, 128, 64)]:
        for s in (1, 2):
            args = [None, None, None, s, False, 0, True]
            assert costs.dwconv3x3([x], 2, args)[1] == dwconv3x3_flops(x, s)
            assert costs.dwconv3x3_backward([x], 2, args)[1] == dwconv3x3_flops(x, s, True)
    for x in [(8, 32, 256, 576), (8, 32, 256, 256), (8, 1, 256, 256), (8, 160, 16, 16)]:
        assert costs.bn_act_train([x], 2, [])[1] == bn_act_train_flops(x)
        assert costs.bn_act_train_backward([x], 2, [])[1] == bn_act_train_flops(x, True)
    for x, k in [((8, 256, 576, 32), 13), ((8, 128, 288, 32), 11), ((8, 16, 36, 32), 5)]:
        args = [None, None, None, None, 32, 32, k]
        assert costs.fused_cross_block([x], 2, args)[1] == fused_cross_block_flops(x, 32, 32, k)


def test_flop_count_on_meta_matches_real_tensors():
    """The reference's operations counted on the meta device (as set-up
    counts them) equal the count on real tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference import model as ref_model

    cfg = _cfg("stc_tt")
    counts = []
    for dev in ("meta", "cpu"):
        with torch.device(dev):
            ref = ref_model.RegNet(cfg, 9, "infer").eval()
            x = torch.zeros((1, 3, 64, 96))
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            ref.base.run(x, ref_model.Ctx())
        counts.append(fc.get_total_flops())
    assert counts[0] == counts[1] > 0
