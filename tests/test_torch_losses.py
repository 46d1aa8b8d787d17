"""PyTorch port losses vs the JAX package and the torch goldens (CPU).

The same seeded logits, one-hot labels and features go through the JAX
loss and its port.  Tolerances: f32 reassociation (rtol 1e-5) for the
closed-form losses; the goldens' own bounds (``tests/test_losses.py``,
``tests/test_regnet_losses.py``) where a golden is the reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from tcct_tpu.infer.importer import import_torch_state
from tcct_tpu.losses import get_loss as jax_get_loss
from tcct_tpu.losses import points_selection_bins as jax_points_selection_bins
from tcct_tpu.losses.polar import feature_polarization_loss as jax_polarization
from tcct_tpu.losses.seg import deep_supervision_loss as jax_ds_loss
from tcct_tpu.models.regnet import RegNet as JaxRegNet
from tcct_tpu_torch.losses import (
    cosinesim_loss,
    deep_supervision_loss,
    feature_polarization_loss,
    get_loss,
    points_selection_bins,
)
from tcct_tpu_torch.models import RegNet


def _nhwc(x):
    return np.ascontiguousarray(np.moveaxis(x, 1, -1))


def _onehot(labels, nc=5):
    return np.eye(nc, dtype=np.float32)[labels]


@pytest.mark.parametrize("name,key", [("di", "loss_di"), ("mse", "loss_mse")])
def test_multiloss_matches_golden_and_jax(golden, name, key):
    g = golden("losses_seg")
    logits, oh = _nhwc(g["logits"]), _onehot(g["labels"])
    got = float(get_loss(name)(torch.from_numpy(logits), torch.from_numpy(oh)))
    want = float(jax_get_loss(name)(jnp.asarray(logits), jnp.asarray(oh)))
    np.testing.assert_allclose(got, g[key], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # integer labels are one-hot encoded on the fly
    got_int = float(get_loss(name)(torch.from_numpy(logits), torch.from_numpy(g["labels"])))
    np.testing.assert_allclose(got_int, got, rtol=1e-6)


@pytest.mark.parametrize("ds", [True, False])
def test_deep_supervision_matches_jax(ds):
    rng = np.random.default_rng(0)
    outs = [rng.normal(size=(2, 16, 12, 5)).astype(np.float32) * 3 for _ in range(4)]
    oh = _onehot(rng.integers(0, 5, (2, 16, 12)))
    got = deep_supervision_loss([torch.from_numpy(o) for o in outs], torch.from_numpy(oh),
                                get_loss("di"), ds=ds, coff_ds=0.5)
    want = jax_ds_loss([jnp.asarray(o) for o in outs], jnp.asarray(oh), jax_get_loss("di"),
                       ds=ds, coff_ds=0.5)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_points_selection_bins_golden(golden):
    g = golden("binpool")
    out = points_selection_bins(torch.from_numpy(g["feat"]), torch.from_numpy(g["prob"]),
                                torch.from_numpy(g["true"]))
    np.testing.assert_allclose(out.numpy(), g["bins_out"], rtol=1e-4, atol=1e-5)


def test_points_selection_bins_ties_are_stable():
    """bf16 probabilities tie often: the ranking must be the stable sort
    jnp.argsort gives, so the bins hold the same pixels."""
    rng = np.random.default_rng(1)
    P, L = 3000, 8
    feat = rng.normal(size=(P, L)).astype(np.float32)
    prob = np.round(rng.uniform(size=P) * 8) / 8  # 9 distinct values
    true = (rng.uniform(size=P) > 0.3).astype(np.float32)
    pb = torch.from_numpy(prob.astype(np.float32)).to(torch.bfloat16)
    got = points_selection_bins(torch.from_numpy(feat), pb, torch.from_numpy(true))
    want = jax_points_selection_bins(jnp.asarray(feat), jnp.asarray(prob, jnp.bfloat16),
                                     jnp.asarray(true))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_cosinesim_golden(golden):
    g = golden("binpool")
    got = cosinesim_loss(torch.from_numpy(g["cos_q"]), torch.from_numpy(g["cos_k"]))
    np.testing.assert_allclose(float(got), g["cos_loss"], rtol=1e-5)


class _DummyBase(nn.Module):
    @nn.compact
    def __call__(self, x, train=False):
        return [x], [x]


@pytest.fixture(scope="module")
def heads(golden):
    """The port's RegNet loss heads and the JAX RegNet's, both holding the
    golden regnet_losses weights."""
    g = golden("regnet_losses")
    pred, true = _nhwc(g["pred"]), _nhwc(g["true"])
    sd = {k[len("w::"):]: g[k] for k in g.files if k.startswith("w::")}
    port = RegNet(torch.nn.Identity(), out_channels=5)
    missing, unexpected = port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                                               strict=False)
    assert unexpected == [] and all(k.startswith(("base.", "fcp.")) for k in missing)
    jnet = JaxRegNet(base=_DummyBase(), out_channels=5)
    v = jnet.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(pred), jnp.asarray(true),
                  method=JaxRegNet.init_loss_heads)
    v, _ = import_torch_state(sd, v, strict_shapes=True)
    return g, pred, true, port, jnet, v


def test_boundary_loss_pinned_matches_golden_and_jax(heads):
    """Pinned noise (uniforms 0.5), eval-mode lap_map BN: the golden's
    bound (rtol 2e-4, atol 2e-5) and JAX's (rtol 1e-5)."""
    g, pred, true, port, jnet, v = heads
    port.eval()
    with torch.no_grad():
        got = float(port.regular_reg(torch.from_numpy(pred), torch.from_numpy(true)))
    want = float(jnet.apply(v, jnp.asarray(pred), jnp.asarray(true), rng=None, train=False,
                            method=JaxRegNet.regular_reg))
    np.testing.assert_allclose(got, g["los_reg"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_boundary_loss_train_mode_and_grads_match_jax(heads):
    """Train-mode lap_map BN (eps 1.0, batch statistics) with pinned noise:
    the loss (rtol 1e-5) and its gradients in every loss-head parameter
    (1e-3 of each tensor's max: JAX's own f32 gradient of lap_reg.0 lies
    1.4e-4 of its max from the float64 one) match JAX's.  The logits' own
    gradient is ~1e-7, below f32 cancellation noise of a loss ~1.5, so it
    is held only to 2e-3 of its max."""
    g, pred, true, port, jnet, v = heads
    port.train()
    p = torch.from_numpy(pred).requires_grad_()
    names = [k for k, _ in port.named_parameters() if k.startswith(("lap_reg", "lap_map"))]
    params = dict(port.named_parameters())
    loss = port.regular_reg(p, torch.from_numpy(true))
    grads = torch.autograd.grad(loss, [p] + [params[k] for k in names])
    port.eval()

    def f(params, pr):
        out, _ = jnet.apply({**v, "params": params}, pr, jnp.asarray(true), rng=None, train=True,
                            method=JaxRegNet.regular_reg, mutable=["batch_stats"])
        return out

    want, (gparams, gpred) = jax.value_and_grad(f, argnums=(0, 1))(v["params"], jnp.asarray(pred))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    s = float(np.abs(np.asarray(gpred)).max())
    np.testing.assert_allclose(grads[0].numpy() / s, np.asarray(gpred) / s, atol=2e-3)
    refs = {}
    for k in names:
        mod, idx, leaf = k.split(".")
        gj = np.asarray(gparams[f"{mod}_{idx}"]["kernel" if leaf == "weight" and params[k].dim() == 4
                                                 else "scale" if leaf == "weight" else "bias"])
        refs[k] = gj.transpose(3, 2, 0, 1) if gj.ndim == 4 else gj
    top = max(float(np.abs(r).max()) for r in refs.values())
    for k, gt in zip(names, grads[1:]):
        # floored at 1e-3 of the largest: lap_map.0's bias feeds a train BN,
        # so its true gradient is 0 and both sides hold noise
        s = max(float(np.abs(refs[k]).max()), 1e-3 * top)
        np.testing.assert_allclose(gt.numpy() / s, refs[k] / s, atol=1e-3, err_msg=k)


def test_boundary_loss_random_noise_is_seeded(heads):
    _, pred, true, port, _, _ = heads
    port.eval()
    p, t = torch.from_numpy(pred), torch.from_numpy(true)
    a = port.regular_reg(p, t, torch.Generator().manual_seed(3))
    b = port.regular_reg(p, t, torch.Generator().manual_seed(3))
    c = port.regular_reg(p, t, torch.Generator().manual_seed(4))
    pinned = port.regular_reg(p, t)
    assert torch.isfinite(a) and float(a) == float(b)
    assert float(a) != float(c) and float(a) != float(pinned)


def test_polarization_matches_golden_and_jax(heads):
    g, pred, true, port, _, _ = heads
    feat = _nhwc(g["feat"])
    protos = g["fcp_buf"]
    got = float(feature_polarization_loss([torch.from_numpy(feat)] * 4, torch.from_numpy(pred),
                                          torch.from_numpy(true), torch.from_numpy(protos)))
    want = float(jax_polarization([jnp.asarray(feat)] * 4, jnp.asarray(pred), jnp.asarray(true),
                                  jnp.asarray(protos)))
    np.testing.assert_allclose(got, g["los_udh"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_polarization_grads_match_jax(heads):
    """The polarization loss's gradient in the features (the logits only
    rank the pixels), port against JAX, also in the mse form."""
    g, pred, true, _, _, _ = heads
    feat = _nhwc(g["feat"])
    protos = g["fcp_buf"]
    for con in ("cos", "mse"):
        f = torch.from_numpy(feat).requires_grad_()
        loss = feature_polarization_loss([f], torch.from_numpy(pred), torch.from_numpy(true),
                                         torch.from_numpy(protos), con=con)
        (gf,) = torch.autograd.grad(loss, f)
        gj = jax.grad(lambda fe: jax_polarization([fe], jnp.asarray(pred), jnp.asarray(true),
                                                  jnp.asarray(protos), con=con))(jnp.asarray(feat))
        s = float(np.abs(np.asarray(gj)).max())
        np.testing.assert_allclose(gf.numpy() / s, np.asarray(gj) / s, atol=1e-5)


def test_edge_pixel_loss_matches_jax(heads):
    _, pred, true, port, jnet, v = heads
    got = float(port.regular_epl(torch.from_numpy(pred), torch.from_numpy(true)))
    want = float(jnet.apply(v, jnp.asarray(pred), jnp.asarray(true), method=JaxRegNet.regular_epl))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# --- the losses off the train step's path (get_mloss, the per-class bases) -----------

@pytest.mark.parametrize("name,key", [("di", "mdice"), ("d2", "mdice2"), ("ce", "ce")])
def test_get_mloss_matches_golden_and_jax(golden, name, key):
    """MDice, bi-MDice and cross-entropy on the golden logits and integer
    labels (``lossm.npz``, tests/test_losses.py's rtol 1e-5), on one-hot
    labels too, and JAX's value (rtol 1e-6)."""
    from tcct_tpu.losses.seg import get_mloss as jax_get_mloss
    from tcct_tpu_torch.losses import get_mloss

    g = golden("lossm")
    x, lab = np.moveaxis(g["x"], 1, -1), g["lab"]
    got = float(get_mloss(name)(torch.from_numpy(x), torch.from_numpy(lab)))
    np.testing.assert_allclose(got, g[key], rtol=1e-5)
    np.testing.assert_allclose(got, float(jax_get_mloss(name)(jnp.asarray(x), jnp.asarray(lab))),
                               rtol=1e-6)
    oh = torch.nn.functional.one_hot(torch.from_numpy(lab).long(), x.shape[-1]).float()
    np.testing.assert_allclose(float(get_mloss(name)(torch.from_numpy(x), oh)), got, rtol=1e-6)


def test_weighted_cross_entropy_matches_jax():
    from tcct_tpu.losses.seg import CrossEntropyLoss as JaxCE
    from tcct_tpu_torch.losses import CrossEntropyLoss

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 7, 4)).astype(np.float32)
    lab = rng.integers(0, 4, (2, 6, 7))
    w = (0.5, 1.0, 2.0, 3.0)
    got = float(CrossEntropyLoss(w)(torch.from_numpy(x), torch.from_numpy(lab)))
    np.testing.assert_allclose(got, float(JaxCE(w)(jnp.asarray(x), jnp.asarray(lab))), rtol=1e-6)


def test_soft_argmax_matches_golden(golden):
    from tcct_tpu_torch.losses import soft_argmax

    g = golden("lossm")
    got = soft_argmax(torch.from_numpy(np.moveaxis(g["x"], 1, -1))).numpy()
    np.testing.assert_allclose(got, np.moveaxis(g["soft_argmax"], 1, -1), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("base", ["dice_bi", "iou", "dice", "dice_per_class"])
def test_multiloss_bases_match_jax(base):
    """MultiLoss with the per-class DiceLoss(bi=True), IouLoss and DiceLoss
    bases and the one-pass Dice, against JAX's (rtol 1e-6), with their
    gradients (rtol 1e-5)."""
    from tcct_tpu.losses import seg as jseg
    from tcct_tpu_torch.losses import DiceLoss, IouLoss, MultiLoss

    ours, theirs = {
        "dice_bi": (MultiLoss(DiceLoss(bi=True)), jseg.MultiLoss(jseg.DiceLoss(bi=True))),
        "iou": (MultiLoss(IouLoss()), jseg.MultiLoss(jseg.IouLoss())),
        "dice": (MultiLoss("dice"), jseg.MultiLoss(jseg.DiceLoss())),
        "dice_per_class": (MultiLoss(DiceLoss()), jseg.MultiLoss(jseg.DiceLoss())),
    }[base]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 9, 5)).astype(np.float32)
    lab = rng.integers(0, 5, (2, 8, 9))
    jl, jg = jax.value_and_grad(lambda v: theirs(v, jnp.asarray(lab)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = ours(xt, torch.from_numpy(lab))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("nc", [5, 9])
def test_optimize_prototypes_matches_jax(nc):
    """The self-optimized prototypes (333 Adam steps with the plateau
    schedule) from JAX's own U[0, 1) rows: within 1e-3 of JAX's (1.1e-4
    measured: f32 reassociation through 333 steps); unit rows; the
    generator's draw has the same shape and gives unit rows too."""
    from tcct_tpu.losses.polar import optimize_prototypes as jax_optimize
    from tcct_tpu_torch.losses import optimize_prototypes, refine_prototypes

    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_optimize(key, nc, 32))
    vec0 = np.array(jax.random.uniform(key, (nc, 32), jnp.float32))
    got = refine_prototypes(torch.from_numpy(vec0)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-6)
    drawn = optimize_prototypes(nc, 32, torch.Generator().manual_seed(0), steps=20)
    assert drawn.shape == (nc, 32)
    np.testing.assert_allclose(drawn.norm(dim=-1).numpy(), 1.0, rtol=1e-6)


def test_boundary_loss_abs_has_the_jax_derivative_at_zero():
    """The Laplacian of the one-hot target is exactly 0 wherever a class is
    absent, at init (zero biases): there ``|x|`` must have JAX's derivative,
    1, not torch's 0.  A Laplacian ``s * x + b`` with ``b = 0`` makes that
    the gradient of ``b``; held against jax.grad (rtol 1e-5)."""
    from tcct_tpu.losses.boundary import boundary_regression_loss as jax_boundary
    from tcct_tpu_torch.losses import boundary_regression_loss

    rng = np.random.default_rng(7)
    pred = rng.standard_normal((2, 16, 12, 5)).astype(np.float32)
    true = np.eye(5, dtype=np.float32)[np.sort(rng.integers(0, 5, (2, 16, 12)), axis=1)]

    def jloss(b):
        return jax_boundary(jnp.asarray(pred), jnp.asarray(true), lambda x: 0.7 * x + b,
                            jax.nn.sigmoid, None)

    want = float(jax.grad(jloss)(jnp.float32(0.0)))
    b = torch.tensor(0.0, requires_grad=True)
    loss = boundary_regression_loss(torch.from_numpy(pred), torch.from_numpy(true),
                                    lambda x: 0.7 * x + b, torch.sigmoid, None)
    (got,) = torch.autograd.grad(loss, b)
    assert abs(want) > 1e-4
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
