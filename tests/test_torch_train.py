"""The port's train step vs the JAX package's (CPU, f32, 64x64).

Both start from the golden ``train_parity.npz`` ``sd0`` weights of
``RegNet(stc_tt, variant='train', drop_path_rate=0)`` and its fixed batch:
the port loads ``sd0`` by name, JAX through ``import_torch_state``,
exactly as ``tests/test_train_parity.py`` builds its side (so the JAX
compile is the one that test makes).  The loss is the paper's: deep-
supervision Dice + feature polarization + boundary regression with pinned
noise.  Bounds: ``tests/test_train_parity.py``'s per-tensor gradient bound,
``max(2e-3 * |ref|, 2e-4 * global norm)``, over more than 280 tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tcct_tpu.infer.importer import export_torch_state, import_torch_state
from tcct_tpu.models import RegNet as JaxRegNet
from tcct_tpu.models import get_model as jax_get_model
from tcct_tpu.train import TrainConfig as JaxTrainConfig
from tcct_tpu.train import build_train_step as jax_build_train_step
from tcct_tpu.train.schedule import cyclic_lr as jax_cyclic_lr
from tcct_tpu.train.state import create_train_state
from tcct_tpu.train.state import make_optimizer as jax_make_optimizer
from tcct_tpu.train.step import build_loss_fn as jax_build_loss_fn
from tcct_tpu_torch.infer.importer import flatten_variables, from_jax_variables
from tcct_tpu_torch.models import RegNet, get_model
from tcct_tpu_torch.models.layers import init_weights
from tcct_tpu_torch.train import (
    AdamW,
    TrainConfig,
    build_loss_fn,
    build_train_step,
    cyclic_lr,
    make_optimizer,
    make_stepwise,
    trainable_parameters,
)
from tcct_tpu_torch.train.precision import cast_floating

LR = 1e-4


def _port_model(sd0, drop_path_rate=0.0):
    m = RegNet(get_model("stc_tt", 5, variant="train", drop_path_rate=drop_path_rate),
               out_channels=5)
    m.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd0.items()}, strict=True)
    return m.to(memory_format=torch.channels_last)


def _port_cfg(dtype=torch.float32, pinned=True):
    return TrainConfig(n_class=5, crop_hw=(64, 64), ds=True, coff_ds=0.5, udh=True,
                       coff_udh=1.0, reg=True, coff_reg=0.1, augment=False, dtype=dtype,
                       pinned_reg_noise=pinned)


@pytest.fixture(scope="module")
def slice_ref(golden):
    """The JAX side, as tests/test_train_parity.py builds it: step-0
    gradients and metrics of build_loss_fn, and the state after one
    build_train_step step."""
    g = golden("train_parity")
    sd0 = {k[len("sd0::"):]: g[k] for k in g.files if k.startswith("sd0::")}
    net = JaxRegNet(base=jax_get_model("stc_tt", 5, variant="train", drop_path_rate=0.0),
                    out_channels=5)
    cfg = JaxTrainConfig(n_class=5, crop_hw=(64, 64), ds=True, coff_ds=0.5, udh=True,
                         coff_udh=1.0, reg=True, coff_reg=0.1, epl=False, coff_epl=0.1,
                         augment=False, pinned_reg_noise=True, pinned_gate_noise=False)
    opt = jax_make_optimizer(steps_per_epoch=1, lr=LR, weight_decay=2e-4)
    state = create_train_state(net, opt, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                               jnp.zeros((1, 64, 64, 5)))
    variables, _ = import_torch_state(sd0, state.variables())
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"],
                          prototypes=variables["prototypes"])
    imgs = jnp.asarray(np.moveaxis(g["x_u8"], 1, -1))
    labs = jnp.asarray(g["labels"])
    img = imgs.astype(jnp.float32) / 255.0
    true_oh = jax.nn.one_hot(labs.astype(jnp.int32), 5, dtype=jnp.float32)
    k = jax.random.PRNGKey(0)
    grads, (new_bs, metrics) = jax.jit(jax.grad(jax_build_loss_fn(net, cfg), has_aux=True))(
        state.params, state.batch_stats, state.prototypes,
        img, true_oh, {"gate": k, "droppath": k}, None,
    )
    state1, _ = jax_build_train_step(net, opt, cfg)(state, imgs, labs)
    updates, _ = opt.update(grads, opt.init(state.params), state.params)
    sd1_optax = export_torch_state({"params": optax.apply_updates(state.params, updates)}, sd0)[0]
    grads, report = export_torch_state({"params": grads}, sd0)
    return {
        "g": g, "sd0": sd0, "grads": grads, "filled": set(report.filled),
        "bs0": export_torch_state({"batch_stats": new_bs}, sd0)[0],
        "metrics": {k: float(v) for k, v in metrics.items()},
        "sd1": export_torch_state(state1.variables(), sd0)[0], "sd1_optax": sd1_optax,
        "imgs": np.asarray(imgs), "labs": np.asarray(labs),
    }


@pytest.fixture(scope="module")
def port_step0(slice_ref):
    """The port's step-0 loss, gradients and BN statistics (f32, CPU)."""
    m = _port_model(slice_ref["sd0"]).train()
    params = trainable_parameters(m)
    img = torch.tensor(slice_ref["imgs"]).float() / 255.0
    true_oh = torch.nn.functional.one_hot(torch.from_numpy(slice_ref["labs"]).long(), 5).float()
    loss, (bs, metrics) = build_loss_fn(m, _port_cfg())(params, dict(m.named_buffers()), img, true_oh)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {k: (np.zeros(p.shape, np.float32) if gr is None else gr.numpy())
             for (k, p), gr in zip(params.items(), grads)}
    return grads, {k: v.numpy() for k, v in bs.items()}, {k: float(v.detach()) for k, v in metrics.items()}


def _grad_check(mine, ref_of, g):
    gnorm = np.sqrt(sum(float((g[k].astype(np.float64) ** 2).sum())
                        for k in g.files if k.startswith("grad0::")))
    checked = 0
    for key in g.files:
        if not key.startswith("grad0::"):
            continue
        tk = key[len("grad0::"):]
        ref = ref_of(tk)
        if ref is None or tk.endswith(("running_mean", "running_var")):
            continue
        ref = np.asarray(ref, np.float64)
        err = np.linalg.norm(mine[tk].astype(np.float64) - ref)
        assert err <= max(2e-3 * np.linalg.norm(ref), 2e-4 * gnorm), (tk, err, np.linalg.norm(ref))
        checked += 1
    assert checked > 280, checked


def test_step0_gradients_match_jax(slice_ref, port_step0):
    grads, _, _ = port_step0
    _grad_check(grads, slice_ref["grads"].get, slice_ref["g"])


def test_step0_gradients_match_golden(slice_ref, port_step0):
    """The same bound against the torch reference's own step-0 gradients."""
    grads, _, _ = port_step0
    g = slice_ref["g"]
    _grad_check(grads, lambda k: g["grad0::" + k], g)


def test_step0_losses_and_bn_stats_match_jax(slice_ref, port_step0):
    """Every loss term (rtol 1e-5) and the new f32 BN running statistics of
    all 52 BN modules (the EMA of the batch statistics; atol 1e-5 + rtol
    1e-4: batch statistics of f32 activations through 40 layers)."""
    _, bs, metrics = port_step0
    for k in ("los", "udh", "reg", "total"):
        np.testing.assert_allclose(metrics[k], slice_ref["metrics"][k], rtol=1e-5, err_msg=k)
    assert len(bs) == 2 * 52
    for k, v in bs.items():
        np.testing.assert_allclose(v, slice_ref["bs0"][k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_one_step_matches_jax_train_step(slice_ref):
    """One clip + AdamW step (constant lr 1e-4, wd 2e-4) through
    build_train_step against JAX's build_train_step.  Adam's first step is
    about ``-lr * sign(g)`` whatever |g|, and f32 noise (with the
    polarization loss's bin routing) flips the sign of many near-zero
    gradient elements, so the bounds are on the whole update: the loss
    (rtol 1e-5) and the new BN statistics as in the step-0 test; every
    parameter within 2.1 lr of JAX's; at most 2 % of the elements more than
    5 % of lr away (1.1 % measured); the update's L2 drift below
    tests/test_train_parity.py's bound, 0.5 (0.20 measured)."""
    m = _port_model(slice_ref["sd0"])
    step = build_train_step(m, make_optimizer(1, lr=LR, weight_decay=2e-4), _port_cfg(), "cpu")
    metrics, _ = step(slice_ref["imgs"], slice_ref["labs"])
    np.testing.assert_allclose(float(metrics["total"]), slice_ref["metrics"]["total"], rtol=1e-5)
    sd1, sd0, ref = m.state_dict(), slice_ref["sd0"], slice_ref["sd1"]
    for k, v in ref.items():
        if "running" in k:
            np.testing.assert_allclose(sd1[k].numpy(), np.asarray(v), rtol=1e-4, atol=1e-5, err_msg=k)
    moved2 = drift2 = 0.0
    n_el = n_off = 0
    for k in slice_ref["filled"]:
        mine, v = sd1[k].numpy().astype(np.float64), np.asarray(ref[k], np.float64)
        diff = np.abs(mine - v)
        assert diff.max() <= 2.1 * LR, k
        n_el += diff.size
        n_off += int((diff > 0.05 * LR).sum())
        moved2 += float(((v - sd0[k]) ** 2).sum())
        drift2 += float(((mine - v) ** 2).sum())
    assert n_off <= 0.02 * n_el, (n_off, n_el)
    assert np.sqrt(drift2 / moved2) < 0.5


def test_optimizer_on_jax_gradients_matches_optax(slice_ref):
    """The port's AdamW over its trainable set, fed JAX's step-0
    gradients, gives what JAX's optimizer gives on the same gradients
    (within 1e-3 of lr, every element): the same parameter set is clipped,
    decayed and stepped, zero-gradient ones (tau) by the decay alone."""
    m = _port_model(slice_ref["sd0"])
    params = trainable_parameters(m)
    grads = slice_ref["grads"]
    # JAX's parameter tree, less the per-block names of the shared CPE
    filled = slice_ref["filled"]
    assert set(params) <= filled
    assert all(".MHCA_layers." in k and ".cpe." in k for k in filled - set(params))
    make_optimizer(1, lr=LR, weight_decay=2e-4).update(
        [p.data for p in params.values()],
        [torch.from_numpy(np.array(grads[k], np.float32)) for k in params])
    want = slice_ref["sd1_optax"]
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]), rtol=0,
                                   atol=1e-3 * LR, err_msg=k)


def test_bf16_step_with_drop_path_and_noise():
    """The bf16 step with DropPath 0.1 and random boundary noise runs on
    the CPU path: finite losses, f32 masters and statistics that move,
    and the same generator seed gives the same step."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    y = rng.integers(0, 5, (2, 64, 64), dtype=np.uint8)
    runs = []
    for _ in range(2):
        torch.manual_seed(0)
        m = RegNet(get_model("stc_tt", 5, variant="train", drop_path_rate=0.1), out_channels=5)
        init_weights(m, torch.Generator().manual_seed(0))
        w0 = m.base.aux0.weight.detach().clone()
        step = build_train_step(m, make_optimizer(1, lr=LR), _port_cfg(torch.bfloat16, pinned=False),
                                "cpu", torch.Generator().manual_seed(1))
        metrics, bs = step(x, y)
        assert all(np.isfinite(float(v)) for v in metrics.values())
        assert all(v.dtype == torch.float32 for v in bs.values())
        assert m.base.aux0.weight.dtype == torch.float32
        assert not torch.equal(m.base.aux0.weight.detach(), w0)
        assert not torch.equal(m.base.head[1].running_var, torch.ones(32))
        runs.append(float(metrics["total"]))
    assert runs[0] == runs[1]


def test_optimizer_matches_optax():
    """Three steps of the port's AdamW against optax.chain(clip_by_global_norm(12),
    adamw) with the cyclic schedule, one step over the clip (rtol 1e-6)."""
    rng = np.random.default_rng(2)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * sc for s in shapes] for sc in (1, 20, 0.1)]
    tx = jax_make_optimizer(steps_per_epoch=1, weight_decay=2e-4)
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = make_optimizer(1, weight_decay=2e-4)
    for gs in grads:
        upd, st = tx.update([jnp.asarray(g) for g in gs], st, jp)
        jp = optax.apply_updates(jp, upd)
        norm = opt.update(tp, [torch.from_numpy(g) for g in gs])
        np.testing.assert_allclose(float(norm), np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                                            for g in gs)), rtol=1e-5)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)
    assert isinstance(opt, AdamW) and opt.count == 3


def test_cyclic_lr_matches_golden_and_jax(golden):
    g = golden("schedule")
    ours = np.array([cyclic_lr(e) for e in range(130)])
    np.testing.assert_allclose(ours, g["lrs"], rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(ours, [float(jax_cyclic_lr(e)) for e in range(130)], rtol=1e-6)
    assert make_stepwise(cyclic_lr, 10)(45) == cyclic_lr(4)


def test_cast_floating_and_trainable_set():
    t = {"a": torch.ones(2), "n": torch.ones(2, dtype=torch.int64)}
    out = cast_floating(t, torch.bfloat16)
    assert out["a"].dtype == torch.bfloat16 and out["n"] is t["n"]
    m = RegNet(get_model("stc_tt", 5, variant="train"), out_channels=5)
    names = set(trainable_parameters(m))
    assert "tau" in names and "lap_epl.0.weight" in names and "base.t321.weight" in names
    assert not any(("crpe" in k or "cls_head" in k or ".fuse." in k) for k in names)
    with pytest.raises(ValueError, match="generator"):  # augmentation draws from one
        build_train_step(m, make_optimizer(1), TrainConfig(augment=True), "cpu")


@pytest.mark.parametrize("name", ["stc_tt", "cnnu", "vitu"])
def test_trainable_set_is_the_jax_params_tree(name):
    """The trained set follows the model's flags: the port trains exactly
    the parameters of the JAX train state's ``params`` tree (shapes from
    ``jax.eval_shape``, no JAX compute).  ``cnnu`` has no ViT branch and no
    ``tran_*`` projections there, ``vitu`` no ``tran_cnn*``."""
    net = JaxRegNet(base=jax_get_model(name, 5, variant="train"), out_channels=5)
    state = jax.eval_shape(lambda: create_train_state(
        net, jax_make_optimizer(steps_per_epoch=1, lr=LR), jax.random.PRNGKey(0),
        jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 5))))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), state.params)
    want = set(from_jax_variables(flatten_variables({"params": zeros})))
    m = RegNet(get_model(name, 5, variant="train"), out_channels=5)
    shared = {k for k, _ in m.named_parameters(remove_duplicate=False)} - set(
        dict(m.named_parameters()))
    assert set(trainable_parameters(m)) == want - shared
