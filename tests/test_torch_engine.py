"""The port's training entry point (``tcct_tpu_torch/train``,
``tcct_tpu_torch/cli``) against the JAX package's on the CPU, at small
sizes: the Dice/IoU scores (1e-6), the metric log, the epoch index plans
(equal), the val pass at JAX's weights (f32 ``stc_tt`` at 64x64, 1e-4),
the one-sync val against the host loop, a debug fit of ``stc_tt`` with
augmentation, checkpoints, a bitwise resume, ``RegNet(con='mse')`` and
the CLI.  The 50-step trajectory on the golden parity case is in the slow
tier."""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcct_tpu.cli.main import build_parser as jax_build_parser
from tcct_tpu.data import EyeSet as JaxEyeSet
from tcct_tpu.losses import seg as jseg
from tcct_tpu.models import RegNet as JaxRegNet
from tcct_tpu.models import get_model as jax_get_model
from tcct_tpu.train import TrainConfig as JaxTrainConfig
from tcct_tpu.train.engine import Trainer as JaxTrainer
from tcct_tpu.train.state import create_train_state
from tcct_tpu.train.state import make_optimizer as jax_make_optimizer
from tcct_tpu.train.step import build_eval_epoch as jax_build_eval_epoch
from tcct_tpu.utils.logging import MetricLogger as JaxMetricLogger
from tcct_tpu_torch.cli.main import build_parser, main
from tcct_tpu_torch.data import EyeSet
from tcct_tpu_torch.infer import load_into
from tcct_tpu_torch.infer.importer import flatten_variables, from_jax_variables
from tcct_tpu_torch.losses import seg
from tcct_tpu_torch.models import RegNet, get_model
from tcct_tpu_torch.train import (
    TrainConfig,
    Trainer,
    build_eval_step,
    build_predict,
    build_train_step,
    make_optimizer,
    restore_checkpoint,
    save_checkpoint,
)
from tcct_tpu_torch.utils import MetricLogger

SYNTH = {"TCCT_SYNTH_N": "6", "TCCT_SYNTH_HW": "64x64"}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this module's CPU steps: the suite runs
    several workers at once, and torch's default of one thread a core each
    makes them wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_set():
    """Synthetic goals at 64x64: 6 train scans, 2 val scans, for both packages."""
    mp = pytest.MonkeyPatch()
    for k, v in SYNTH.items():
        mp.setenv(k, v)
    mp.delenv("TCCT_DATA_ROOT", raising=False)
    try:
        yield EyeSet.load("goals"), JaxEyeSet.load("goals")
    finally:
        mp.undo()


def _cfg(**kw):
    base = dict(n_class=5, crop_hw=(64, 64), ds=True, udh=True, reg=True, augment=True)
    base.update(kw)
    return TrainConfig(**base)


def _trainer(ds, root, net="stc_tt", **kw):
    torch.manual_seed(0)
    m = RegNet(get_model(net, 5, variant="train", drop_path_rate=0.1), out_channels=5)
    steps = kw.pop("steps", 2)
    tr = Trainer(m, ds, kw.pop("cfg", _cfg()), root=str(root), bs=2, device="cpu", debug=True,
                 **kw)
    tr.steps_per_epoch = steps
    return tr


# --- scores and logs --------------------------------------------------------------

def test_scores_match_jax():
    rng = np.random.default_rng(0)
    pr = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (3, 16, 16))]
    gt = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (3, 16, 16))]
    tp, tg = torch.from_numpy(pr), torch.from_numpy(gt)
    jp, jg = jnp.asarray(pr), jnp.asarray(gt)
    for got, want in [
        (seg.mdice_score(tp[..., 2], tg[..., 2]), jseg.mdice_score(jp[..., 2], jg[..., 2])),
        (seg.miou_score(tp[..., 1], tg[..., 1]), jseg.miou_score(jp[..., 1], jg[..., 1])),
        (seg.mdice_scorem(tp, tg, start_idx=1), jseg.mdice_scorem(jp, jg, start_idx=1)),
        (seg.miou_scorem(tp, tg, start_idx=1), jseg.miou_scorem(jp, jg, start_idx=1)),
        (seg.mdice_scores(tp, tg), jseg.mdice_scores(jp, jg)),
    ]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_metric_logger_lines_match_jax(tmp_path):
    kw = dict(epoch=3, total=torch.tensor(1.5), scores=[0.1, 0.2], n=np.int64(4), name="x")
    MetricLogger(str(tmp_path / "a.jsonl")).log(**kw)
    JaxMetricLogger(str(tmp_path / "b.jsonl")).log(**{**kw, "total": jnp.asarray(1.5)})
    a, b = (json.loads(open(tmp_path / f).read()) for f in ("a.jsonl", "b.jsonl"))
    assert a.pop("t") > 0 and b.pop("t") > 0
    assert a == b


# --- the engine ----------------------------------------------------------------------

@pytest.mark.parametrize("n,steps,bs", [(6, 2, 2), (8, 12, 8), (3, 40, 8)])
def test_epoch_indices_equal_jax(n, steps, bs):
    ds = types.SimpleNamespace(splits={"train": (np.zeros((n, 1)),)},
                               oversample=max(1, 735 // n))
    stub = types.SimpleNamespace(dataset=ds, steps_per_epoch=steps, bs=bs)
    for epoch in range(4):
        got = Trainer._epoch_indices(stub, epoch)
        np.testing.assert_array_equal(got, JaxTrainer._epoch_indices(stub, epoch))
        assert got.shape == (steps, bs)


def test_trainer_epoch_indices_equal_jax(small_set, tmp_path):
    ours, ref = small_set
    tr = _trainer(ours, tmp_path)
    stub = types.SimpleNamespace(dataset=ref, steps_per_epoch=tr.steps_per_epoch, bs=tr.bs)
    for epoch in range(4):
        np.testing.assert_array_equal(tr._epoch_indices(epoch),
                                      JaxTrainer._epoch_indices(stub, epoch))


@pytest.fixture(scope="module")
def jax_val(small_set):
    """JAX's eval_epoch of a seeded f32 stc_tt train state on the val split
    (stochastic_val=False), and that state's variables."""
    _, ref = small_set
    net = JaxRegNet(base=jax_get_model("stc_tt", 5, variant="train", drop_path_rate=0.0),
                    out_channels=5)
    cfg = JaxTrainConfig(n_class=5, crop_hw=(64, 64))
    state = create_train_state(net, jax_make_optimizer(steps_per_epoch=1, lr=1e-4),
                               jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)),
                               jnp.zeros((1, 64, 64, 5)))
    imgs, labs = (jnp.asarray(a) for a in ref.splits["val"])
    m = jax_build_eval_epoch(net, cfg, stochastic_val=False)(state, imgs, labs,
                                                             jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in m.items()}, flatten_variables(state.variables())


def test_val_at_jax_weights_matches_jax_eval_epoch(small_set, jax_val, tmp_path):
    ours, _ = small_set
    want, variables = jax_val
    m = RegNet(get_model("stc_tt", 5, variant="train", drop_path_rate=0.0), out_channels=5)
    tr = Trainer(m, ours, _cfg(dtype=torch.float32), root=str(tmp_path), bs=2, device="cpu",
                 stochastic_val=False)
    load_into(tr.model, from_jax_variables(variables))
    for compiled in (True, False):
        got = tr.val(epoch=0, compiled=compiled)
        assert abs(got["val_f1s"] - float(want["val_f1s"])) < 1e-4
        assert abs(got["val_iou"] - float(want["val_iou"])) < 1e-4
        # the logged scores are rounded to 4 decimals: 1e-4 + half of that
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1.5e-4)


@pytest.fixture(scope="module")
def fitted(small_set, tmp_path_factory):
    """One debug fit of stc_tt with augmentation (2 epochs of 2 steps, val each)."""
    ours, _ = small_set
    root = tmp_path_factory.mktemp("fit")
    tr = _trainer(ours, root)
    logs = tr.fit(epochs=2)
    return tr, logs, root


def test_debug_fit_logs_finite_losses_and_checkpoints(fitted):
    tr, logs, root = fitted
    assert np.isfinite(logs["val_f1s"]) and len(logs["scores"]) == 5
    lines = [json.loads(x) for x in open(os.path.join(root, "metrics.jsonl"))]
    assert [x["epoch"] for x in lines] == [0, 1]
    for x in lines:
        for k in ("total", "los", "udh", "reg", "los_epoch", "val_f1s", "val_iou", "val_s"):
            assert np.isfinite(x[k]), k
    assert all(os.path.isdir(os.path.join(root, n)) for n in ("last", "val_top"))
    assert tr.state.step == 4 and tr.state.epoch == 2
    assert tr.lr() == pytest.approx(1e-6 + (1e-4 - 1e-6) * 0.5)
    assert not tr.is_lr_lower_than(1e-5)


def test_one_sync_val_equals_host_loop(fitted):
    tr, _, _ = fitted
    fast, slow = tr.val(epoch=7), tr.val(epoch=7, compiled=False)
    assert abs(fast["val_f1s"] - slow["val_f1s"]) < 1e-6
    assert abs(fast["val_iou"] - slow["val_iou"]) < 1e-6
    np.testing.assert_allclose(fast["scores"], slow["scores"], atol=1e-4)
    again = tr.val(epoch=7)
    assert again == fast
    assert tr.model.training  # val leaves the model in train mode


def test_checkpoint_round_trip(fitted, tmp_path):
    tr, _, root = fitted
    state = tr.state
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    mu = [t.clone() for t in state.optimizer.mu]
    gen = state.generator.get_state()
    save_checkpoint(str(tmp_path), state, "probe")
    tr.train_epoch(epoch=5)
    assert state.step == 6 and state.epoch == 3
    assert restore_checkpoint(str(tmp_path), state, "nope") is None
    assert restore_checkpoint(str(tmp_path), state, "probe") is state
    assert state.step == 4 and state.epoch == 2
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(torch.equal(a, b) for a, b in zip(state.optimizer.mu, mu))
    assert torch.equal(state.generator.get_state(), gen)
    tr.remove_checkpoints(keep="val_top")
    assert not os.path.exists(os.path.join(root, "last"))
    assert os.path.isdir(os.path.join(root, "val_top"))
    assert tr.resume("val_top") and not tr.resume("last")


def _everything(tr):
    out = {f"model.{k}": v for k, v in tr.model.state_dict().items()}
    for name in ("mu", "nu"):
        out.update({f"{name}.{i}": t for i, t in enumerate(getattr(tr.state.optimizer, name))})
    out["generator"] = tr.state.generator.get_state()
    out["count"] = torch.tensor(tr.state.optimizer.count)
    return out


def test_bitwise_resume(small_set, tmp_path):
    """Epochs 0-1 without a break against epoch 0, a checkpoint, a new
    Trainer that resumes and runs epoch 1, bf16 with augmentation: every
    parameter, buffer, moment, the count and the generator's state equal
    bit for bit."""
    ours, _ = small_set
    cfg = _cfg(dtype=torch.bfloat16)
    a = _trainer(ours, tmp_path / "a", cfg=cfg, steps=1)
    a.fit(epochs=2)
    b = _trainer(ours, tmp_path / "b", cfg=cfg, steps=1)
    b.fit(epochs=1)
    b = _trainer(ours, tmp_path / "b", cfg=cfg, steps=1)
    assert b.resume("last") and b.state.epoch == 1
    b.fit(epochs=2)
    ea, eb = _everything(a), _everything(b)
    assert ea.keys() == eb.keys()
    off = [k for k in ea if not torch.equal(ea[k], eb[k])]
    assert not off, off[:8]


def test_bitwise_resume_gated(small_set, tmp_path):
    """test_bitwise_resume for gtc_tt: the gate's alpha maps draw from the
    step's generator between the augmentation and DropPath, at fixed
    shapes, so the resumed run equals the unbroken one bit for bit."""
    ours, _ = small_set
    cfg = _cfg(dtype=torch.bfloat16)
    a = _trainer(ours, tmp_path / "a", net="gtc_tt", cfg=cfg, steps=1)
    a.fit(epochs=2)
    b = _trainer(ours, tmp_path / "b", net="gtc_tt", cfg=cfg, steps=1)
    b.fit(epochs=1)
    b = _trainer(ours, tmp_path / "b", net="gtc_tt", cfg=cfg, steps=1)
    assert b.resume("last") and b.state.epoch == 1
    b.fit(epochs=2)
    ea, eb = _everything(a), _everything(b)
    assert ea.keys() == eb.keys()
    off = [k for k in ea if not torch.equal(ea[k], eb[k])]
    assert not off, off[:8]


def test_bf16_step_leaves_the_f32_masters_in_the_model():
    """After a bf16 train step every parameter of the model is the f32
    master object it was, the shared ConvPosEnc modules' too, so
    ``state_dict()``, checkpoints and the eval step read the trained
    weights (``functional_call`` with tied names left their bf16 compute
    copies in the model)."""
    m = RegNet(get_model("stc_tt", 5, variant="train", drop_path_rate=0.0), out_channels=5)
    step = build_train_step(m, make_optimizer(1, lr=1e-4), _cfg(augment=False,
                                                                dtype=torch.bfloat16), "cpu")
    before = dict(m.named_parameters(remove_duplicate=False))
    rng = np.random.default_rng(0)
    step(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
         rng.integers(0, 5, (2, 64, 64), dtype=np.uint8))
    after = dict(m.named_parameters(remove_duplicate=False))
    assert after.keys() == before.keys()
    moved = [k for k in before if not (after[k] is before[k] and after[k].dtype == torch.float32)]
    assert not moved, moved[:8]
    assert all(v.dtype == torch.float32 for v in m.state_dict().values() if v.is_floating_point())


def test_eval_step_and_predict(small_set):
    ours, _ = small_set
    torch.manual_seed(0)
    m = RegNet(get_model("stc_tt", 5, variant="train", drop_path_rate=0.0), out_channels=5)
    cfg = _cfg(augment=False)
    build_train_step(m, make_optimizer(1, lr=1e-4), cfg, "cpu")  # the train-mode model
    imgs, labs = (torch.from_numpy(a) for a in ours.splits["val"])
    m1 = build_eval_step(m, cfg, device="cpu")(imgs, labs, torch.tensor([True, False]))
    assert m.training and m1["scores"].shape == (5,) and 0 <= float(m1["val_f1s"]) <= 1
    oh = build_predict(m, 5)(imgs.float() / 255.0)
    assert oh.shape == (2, 64, 64, 5) and int(oh.sum()) == 2 * 64 * 64


def test_augment_needs_a_generator():
    m = RegNet(get_model("stc_tt", 5, variant="train"), out_channels=5)
    with pytest.raises(ValueError, match="generator"):
        build_train_step(m, make_optimizer(1), _cfg(), "cpu")


def test_regnet_con_mse_matches_jax():
    """--type_udh=mse: RegNet(con='mse') passes con to the polarization
    loss, on the JAX RegNet's prototypes."""
    import flax.linen as nn

    rng = np.random.default_rng(1)
    feats = [rng.normal(size=(2, 16, 16, 32)).astype(np.float32)]
    pred = rng.normal(size=(2, 16, 16, 5)).astype(np.float32)
    true = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (2, 16, 16))]
    for con in ("cos", "mse"):
        jnet = JaxRegNet(base=nn.Dense(1), out_channels=5, con=con)
        v = jnet.init(jax.random.PRNGKey(0), jnp.asarray(pred), jnp.asarray(true),
                      method=JaxRegNet.init_loss_heads)
        want = jnet.apply(v, [jnp.asarray(f) for f in feats], jnp.asarray(pred),
                          jnp.asarray(true), method=JaxRegNet.regular_udh)
        ours = RegNet(torch.nn.Identity(), out_channels=5, con=con)
        ours.fcp.buf_grad.copy_(torch.from_numpy(np.asarray(v["prototypes"]["fcp_buf_grad"])))
        got = ours.regular_udh([torch.from_numpy(f) for f in feats], torch.from_numpy(pred),
                               torch.from_numpy(true))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)


# --- the CLI ---------------------------------------------------------------------------

def test_cli_takes_every_jax_option_with_its_default():
    ours, ref = build_parser(), jax_build_parser()
    theirs = {a.dest: a for a in ref._actions if a.option_strings}
    mine = {a.dest: a for a in ours._actions if a.option_strings}
    assert set(theirs) <= set(mine) and set(mine) - set(theirs) == {"device"}
    for dest, a in theirs.items():
        assert mine[dest].option_strings == a.option_strings, dest
        assert mine[dest].default == a.default, dest
        assert mine[dest].choices == a.choices, dest
    assert ours.parse_args([]).device == "cuda"


@pytest.mark.parametrize("argv", [
    ["--bs=8", "--net=stc_tt", "--los=di", "--db=goals"],
    ["--db=hcms", "--lr=0.01", "--wd=5e-4", "--inc=x", "--gpu=0", "--los=dice", "--net=gtc_tt",
     "--pth=true", "--bs=2", "--epochs=100", "--root=exp", "--resume=false", "--reg=true",
     "--coff_reg=0.1", "--epl=true", "--coff_epl=0.1", "--udh=true", "--coff_udh=1",
     "--type_udh=cos", "--ds=true", "--coff_ds=1", "--pl=true", "--bug=true"],
    ["--variant=infer", "--mixer=hydra", "--crop=128", "--stochastic_val=false",
     "--import_pt=/x.pt", "--data_root=/d"],
])
def test_cli_parses_the_jax_cli_tests_commands(argv):
    assert vars(build_parser().parse_args(argv)) == {
        **vars(jax_build_parser().parse_args(argv)), "device": "cuda"}


def test_cli_runs_a_debug_epoch_on_the_cpu(small_set, tmp_path, monkeypatch):
    for k, v in SYNTH.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(Trainer, "__init__", _short_epochs(Trainer.__init__))
    main(["--db", "goals", "--bug", "true", "--bs", "2", "--ds", "true", "--udh", "true",
          "--reg", "true", "--type_udh", "mse", "--crop", "64", "--dtype", "f32",
          "--device", "cpu", "--root", str(tmp_path)])
    lines = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert len(lines) == 1 and np.isfinite(lines[0]["total"]) and "val_f1s" in lines[0]
    assert os.path.isdir(tmp_path / "last")


@pytest.mark.parametrize("argv", [["--net", "gtc_tt"], ["--net", "relay"],
                                  ["--mixer", "hydra"]])
def test_cli_trains_the_zoo(small_set, tmp_path, monkeypatch, argv):
    """One debug epoch (2 steps, bf16, augmentation, every auxiliary loss)
    of gated fusion, ReLayNet and a CRPE mixer from the CLI on the CPU."""
    for k, v in SYNTH.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(Trainer, "__init__", _short_epochs(Trainer.__init__))
    main(["--db", "goals", "--bug", "true", "--bs", "2", "--ds", "true", "--udh", "true",
          "--reg", "true", "--epl", "true", "--crop", "64", "--device", "cpu",
          "--root", str(tmp_path)] + argv)
    lines = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert len(lines) == 1 and all(np.isfinite(lines[0][k]) for k in
                                   ("total", "los", "udh", "reg", "epl", "val_f1s"))


def _short_epochs(init):
    def wrapped(self, *a, **k):
        init(self, *a, **k)
        self.steps_per_epoch = 2
    return wrapped


@pytest.mark.parametrize("argv,err,match", [
    (["--packed_cnn", "true"], ValueError, "lane width"),
])
def test_cli_refuses_what_is_not_ported(argv, err, match, monkeypatch):
    for k, v in SYNTH.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(err, match=match):
        main(["--db", "goals", "--device", "cpu"] + argv)


# --- the 50-step trajectory (slow tier) --------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("fixture", ["train_parity", "train_parity_gtc"])
def test_training_parity_50_steps(golden, fixture):
    """The f32 step from the golden sd0 weights, 50 steps on the golden
    batch (pinned noise; for gtc_tt the pinned alpha maps and the
    edge-pixel loss): the losses and the final parameter L2 at the bounds of
    tests/test_train_parity.py."""
    g = golden(fixture)
    gated = fixture.endswith("_gtc")
    sd0 = {k[len("sd0::"):]: g[k] for k in g.files if k.startswith("sd0::")}
    m = RegNet(get_model("gtc_tt" if gated else "stc_tt", 5, variant="train",
                         drop_path_rate=0.0), out_channels=5)
    m.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd0.items()}, strict=True)
    cfg = _cfg(augment=False, pinned_reg_noise=True, epl=gated, pinned_gate_noise=gated)
    step = build_train_step(m, make_optimizer(1, lr=1e-4, weight_decay=2e-4), cfg, "cpu")
    imgs, labs = np.ascontiguousarray(np.moveaxis(g["x_u8"], 1, -1)), g["labels"]
    losses = np.array([float(step(imgs, labs)[0]["total"]) for _ in range(50)])
    ref = np.asarray(g["losses"][:50])
    rel = np.abs(losses - ref) / np.abs(ref)
    assert rel[0] < 5e-4 and rel.max() < 5e-3, (rel[0], rel.max())
    final = {k: v.double().numpy() for k, v in m.state_dict().items()}
    l2 = np.sqrt(sum(float((v ** 2).sum()) for k, v in final.items()
                     if v.ndim > 0 and "running" not in k and "tracked" not in k))
    np.testing.assert_allclose(l2, float(g["param_l2"]), rtol=1e-5)
    moved2 = drift2 = 0.0
    for key in g.files:
        if key.startswith("sdN::"):
            k = key[len("sdN::"):]
            ref_final = g[key].astype(np.float64)
            moved2 += float(((ref_final - sd0[k].astype(np.float64)) ** 2).sum())
            drift2 += float(((final[k] - ref_final) ** 2).sum())
    assert np.sqrt(drift2 / moved2) < 0.5
