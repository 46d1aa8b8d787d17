"""PyTorch port models vs the JAX package (CPU, f32), at stc_tt's full
widths on a small spatial size.

Weights cross the framework boundary through the parity bridge: the JAX
package's ``import_torch_state``/``export_torch_state`` on one side, the
port's ``state_dict()`` and ``from_jax_variables`` on the other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcct_tpu.infer.importer import export_torch_state, import_torch_state
from tcct_tpu.models import RegNet as JaxRegNet
from tcct_tpu.models import get_model as jax_get_model
from tcct_tpu_torch.infer.importer import flatten_variables, from_jax_variables, load_into
from tcct_tpu_torch.models import RegNet, get_model, list_models
from tcct_tpu_torch.models.layers import BatchNorm2d, init_weights

NC = 9
HW = (64, 128)


def port_model(seed=0):
    m = RegNet(get_model("stc_tt", NC, variant="infer"), out_channels=NC)
    return init_weights(m, torch.Generator().manual_seed(seed))


@torch.no_grad()
def calibrate_bn(model, x):
    """Set every BN's running statistics to the batch statistics of its
    input on ``x`` (in execution order, one forward pass), and its affine
    to seeded values: a trained-like state whose logits stay O(1), so an
    absolute tolerance means something."""
    rng = np.random.default_rng(1)

    def hook(mod, args):
        a = args[0].float()
        mod.running_mean.copy_(a.mean(dim=(0, 2, 3)))
        mod.running_var.copy_(a.var(dim=(0, 2, 3), unbiased=False) + 1e-3)
        c = a.shape[1]
        mod.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
        mod.bias.copy_(torch.from_numpy(rng.normal(size=c).astype(np.float32) * 0.1))

    hs = [m.register_forward_pre_hook(hook) for m in model.modules() if isinstance(m, BatchNorm2d)]
    try:
        model.eval()(x)
    finally:
        for h in hs:
            h.remove()
    return model


@pytest.fixture(scope="module")
def jax_net():
    net = JaxRegNet(base=jax_get_model("stc_tt", NC, variant="infer", mixer="metapool_pallas"),
                    out_channels=NC)
    x = jnp.zeros((1,) + HW + (3,), jnp.float32)
    v = jax.jit(lambda: net.init({"params": jax.random.PRNGKey(0)}, x, train=False))()
    return net, jax.device_get(v)


@pytest.mark.parametrize("variant", ["infer", "train"])
def test_state_dict_names_match_reference(golden, variant):
    """The port's state-dict keys and shapes are the reference torch
    model's (golden train-parity skeleton; the infer variant lacks the
    train variant's t321-t324 projections)."""
    g = golden("train_parity")
    ref = {k[len("sd0::"):]: g[k].shape for k in g.files if k.startswith("sd0::")}
    if variant == "infer":
        ref = {k: s for k, s in ref.items() if not k.startswith("base.t32")}
    m = RegNet(get_model("stc_tt", 5, variant=variant), out_channels=5)
    ours = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert ours == ref


def test_from_jax_variables_matches_export(jax_net):
    """from_jax_variables == export_torch_state(variables, port skeleton)
    on every key it fills; the keys the JAX model never creates are only
    the unused CRPE convs, cls_head, fuse and the RegNet loss heads."""
    _, v = jax_net
    m = port_model()
    skel = {k: t.numpy() for k, t in m.state_dict().items()}
    state, rep = export_torch_state(v, skel)
    ours = from_jax_variables(flatten_variables(v))
    assert set(ours) == set(rep.filled)
    for k, t in ours.items():
        np.testing.assert_array_equal(t.numpy(), state[k], err_msg=k)
    unused = ("crpe.", "cls_head.", "lap_", ".fuse.")
    assert [k for k in rep.missing if not any(u in k for u in unused)] == []
    missing, unexpected = load_into(m, ours)
    assert unexpected == []


def test_regnet_logits_match_jax(jax_net):
    """Full RegNet(stc_tt, infer) logits, all four heads, port vs JAX in f32."""
    net, v = jax_net
    x = np.random.default_rng(0).random((2,) + HW + (3,)).astype(np.float32)
    m = calibrate_bn(port_model(), torch.from_numpy(x))
    sd = {k: t.numpy() for k, t in m.state_dict().items()}
    jv, report = import_torch_state(sd, v)
    assert [k for k in report.untouched_target if "kernel" in k or "bn" in k] == []
    want, _ = jax.jit(lambda v, x: net.apply(v, x, train=False))(jv, jnp.asarray(x))
    with torch.inference_mode():
        got = m.to(memory_format=torch.channels_last)(torch.from_numpy(x))
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == (2,) + HW + (NC,)
        assert np.abs(w).max() > 0.5  # a real test of an absolute tolerance
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3, err_msg=f"head {i}")
        assert (g.argmax(-1) == w.argmax(-1)).mean() > 0.999


def test_registry():
    assert {"stc_tt", "tcct", "relay"} <= set(list_models())
    with pytest.raises(KeyError, match="stc_tt"):
        get_model("nope", 5)
    with pytest.raises(ValueError):
        get_model("stc_tt", 5, variant="t64")
    assert get_model("stc_tt", 5, variant="t32").variant == "t32"
    train = get_model("stc_tt", 5, variant="train", drop_path_rate=0.2)
    assert train.variant == "train" and hasattr(train, "t321")
    dp = train.base_vit.mhca_stages[3].mhca_blks[0].MHCA_layers[0].drop_path
    assert dp.rate == pytest.approx(0.2)  # the last block of the linear schedule
    assert train.base_vit.mhca_stages[0].mhca_blks[0].MHCA_layers[0].drop_path.rate == 0.0
    a = get_model("tcct", 5).state_dict()
    b = get_model("stc_tt", 5).state_dict()
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in b.items()}


def test_shared_cpe_is_one_module():
    """The encoder and its block share one ConvPosEnc, as in the reference:
    both state-dict keys load the same tensor."""
    m = get_model("stc_tt", 5)
    enc = m.base_vit.mhca_stages[0].mhca_blks[0]
    assert enc.MHCA_layers[0].cpe is enc.cpe
    sd = m.state_dict()
    k = "base_vit.mhca_stages.0.mhca_blks.0."
    assert sd[k + "cpe.proj.weight"].data_ptr() == sd[k + "MHCA_layers.0.cpe.proj.weight"].data_ptr()


def test_init_weights_is_seeded():
    a, b, c = port_model(0).state_dict(), port_model(0).state_dict(), port_model(1).state_dict()
    k = "base.base_vit.stem.0.conv.weight"
    assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    w = a[k]  # He-normal over fan_out: std sqrt(2 / (32 * 3 * 3))
    assert abs(float(w.std()) - (2 / (32 * 9)) ** 0.5) < 0.02


def test_from_jax_variables_matches_export_train_tree(golden):
    """The whole JAX train state (parameters with the t32x projections and
    the lap_* loss heads, BN statistics, the fcp prototypes) carried across:
    from_jax_variables == export_torch_state on the golden sd0 skeleton, on
    every key, and it fills the train variant with nothing left over but
    what the JAX model never creates."""
    from tcct_tpu.train.state import create_train_state, make_optimizer

    g = golden("train_parity")
    sd0 = {k[len("sd0::"):]: g[k] for k in g.files if k.startswith("sd0::")}
    net = JaxRegNet(base=jax_get_model("stc_tt", 5, variant="train", drop_path_rate=0.0),
                    out_channels=5)
    state = create_train_state(net, make_optimizer(1, lr=1e-4), jax.random.PRNGKey(3),
                               jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 5)))
    v = jax.device_get(state.variables())
    want, rep = export_torch_state(v, sd0)
    ours = from_jax_variables(flatten_variables(v))
    assert set(ours) == set(rep.filled)
    for k, t in ours.items():
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)
    for k in ("tau", "fcp.buf_grad", "lap_reg.0.weight", "lap_map.1.running_var",
              "lap_epl.0.weight", "base.t321.weight"):
        assert k in ours, k
    assert tuple(ours["lap_reg.1.weight"].shape) == (4, 1, 3, 3)
    m = RegNet(get_model("stc_tt", 5, variant="train"), out_channels=5)
    missing, unexpected = load_into(m, ours)
    assert unexpected == []
    assert all(any(u in k for u in ("crpe.", "cls_head.", ".fuse.", "num_batches_tracked",
                                    "fcp.vec_grad", "fcp.cos_dist")) for k in missing), missing
