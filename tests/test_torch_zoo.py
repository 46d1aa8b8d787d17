"""The FTC model family of the PyTorch port vs the JAX package (CPU, f32):
every registry name beyond stc_tt, both variants, at full width on a 64x96
input; the predictor's ``net=`` and ``cnn_impl=`` arguments; what the port
refuses.

Weights cross the framework boundary as in ``tests/test_torch_models.py``:
the port model is seeded and BN-calibrated, the JAX package's
``import_torch_state`` fills a flax tree (shapes from ``jax.eval_shape``)
from its ``state_dict()``, and ``from_jax_variables`` carries that tree
back."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcct_tpu.infer.importer import import_torch_state
from tcct_tpu.infer.predictor import VolumePredictor as JaxVolumePredictor
from tcct_tpu.models import RegNet as JaxRegNet
from tcct_tpu.models import get_model as jax_get_model
from tcct_tpu.models.layers import feats_gate
from tcct_tpu_torch.data import DatasetGeometry
from tcct_tpu_torch.infer import VolumePredictor, load_into, load_predictor
from tcct_tpu_torch.infer.importer import flatten_variables, from_jax_variables
from tcct_tpu_torch.models import RegNet, get_model, list_models
from tcct_tpu_torch.models.layers import init_weights
from tcct_tpu_torch.ops.kernels.crosscnn_fused import fused_cross_block
from tests.test_torch_models import calibrate_bn

NC = 9
HW = (64, 96)
NEW = ["stc_tb", "stc_st", "stc_sb", "gtc_tt", "gtc_tb", "cnnu", "pnnu", "vitu"]
GEO = DatasetGeometry("tinyz", NC, 0, 64, "resize", HW)
# state-dict entries no forward reads under any flag
NEVER_RUN = ("crpe.", "cls_head.", "lap_", "fcp.", "tau", "num_batches_tracked", ".fuse.")

_PAIRS = {}


def pair(name, variant):
    """(calibrated port model, JAX net, JAX variables with the port's
    weights, input), built once per (name, variant)."""
    key = (name, variant)
    if key not in _PAIRS:
        x = np.random.default_rng(0).random((2,) + HW + (3,)).astype(np.float32)
        m = RegNet(get_model(name, NC, variant=variant), out_channels=NC)
        init_weights(m, torch.Generator().manual_seed(0))
        calibrate_bn(m, torch.from_numpy(x))
        net = JaxRegNet(base=jax_get_model(name, NC, variant=variant, mixer="metapool_pallas"),
                        out_channels=NC)
        # feats_gate(False), as the JAX predictor sets it: the infer variant's
        # polarization feats average maps of unequal widths under the base CNN
        # (32 and 64 channels) and cannot be formed there
        with feats_gate(False):
            shapes = jax.eval_shape(lambda: net.init({"params": jax.random.PRNGKey(0)},
                                                     jnp.zeros((1,) + HW + (3,)), train=False))
        zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
        sd = {k: t.numpy() for k, t in m.state_dict().items()}
        jv, report = import_torch_state(sd, zeros)
        assert [k for k in report.untouched_target if "kernel" in k or "bn" in k] == []
        _PAIRS[key] = (m, net, jv, x)
    return _PAIRS[key]


@pytest.mark.parametrize("variant", ["infer", "train"])
@pytest.mark.parametrize("name", NEW)
def test_zoo_from_jax_variables(name, variant):
    """The JAX tree of each model maps onto the port's state-dict names and
    shapes with nothing left over, and fills every tensor the port's
    forward reads under the model's flags (``load_into`` raises otherwise).
    What the JAX model never creates is only what its flags switch off."""
    m, _, jv, _ = pair(name, variant)
    ours = from_jax_variables(flatten_variables(jv))
    sd = m.state_dict()
    assert set(ours) <= set(sd)
    for k, t in ours.items():
        assert tuple(t.shape) == tuple(sd[k].shape), k
        np.testing.assert_array_equal(t.numpy(), sd[k].numpy(), err_msg=k)
    fresh = RegNet(get_model(name, NC, variant=variant), out_channels=NC)
    missing, unexpected = load_into(fresh, ours)
    assert unexpected == []
    off = tuple("base." + p for p in fresh.base.unused_prefixes())
    left = [k for k in missing if not k.startswith(off) and not any(u in k for u in NEVER_RUN)]
    assert left == []
    # the flags switch off whole subtrees of the JAX variables
    have = lambda sub: any(sub in k for k in ours)  # noqa: E731
    assert have("base.base_cnn.path_estan.4.")
    assert have("base.base_vit.") == (name not in ("cnnu", "pnnu"))
    assert have("base.tran_vit0.") == (name not in ("cnnu", "pnnu"))
    assert have("base.tran_cnn0.") == (name not in ("cnnu", "pnnu", "vitu"))


@pytest.mark.parametrize("variant", ["infer", "train"])
@pytest.mark.parametrize("name", NEW)
def test_zoo_logits_match_jax(name, variant):
    """Eval-mode logits of all four heads, port vs JAX in f32: within 1e-3,
    argmax agreement above 99.9 %."""
    m, net, jv, x = pair(name, variant)
    with feats_gate(False):
        want, _ = jax.jit(lambda v, x: net.apply(v, x, train=False))(jv, jnp.asarray(x))
    with torch.inference_mode():
        got = m.eval().to(memory_format=torch.channels_last)(torch.from_numpy(x))
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == (2,) + HW + (NC,)
        assert np.abs(w).max() > 0.5  # a real test of an absolute tolerance
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3, err_msg=f"{name} head {i}")
        assert (g.argmax(-1) == w.argmax(-1)).mean() > 0.999


def test_jax_infer_feats_need_the_gate():
    """A fault of the JAX package, not of the port: its infer variant with
    the wide CNN branch averages feature maps of 32 and 64 channels for the
    polarization feats and raises, unless ``feats_gate(False)`` skips them
    (as its predictor does).  The port's infer variant never forms them."""
    net = JaxRegNet(base=jax_get_model("stc_tb", NC, variant="infer"), out_channels=NC)
    init = lambda: net.init({"params": jax.random.PRNGKey(0)},  # noqa: E731
                            jnp.zeros((1,) + HW + (3,)), train=False)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(init)
    with feats_gate(False):
        jax.eval_shape(init)
    with pytest.raises(ValueError, match="variant='train' only"):
        get_model("stc_tb", NC)(torch.zeros(1, 32, 32, 3), with_feats=True)


def test_registry_zoo():
    assert list_models() == sorted(NEW + ["stc_tt", "tcct"])
    tb = get_model("gtc_tb", 5)
    assert tb.flag_gate and tb.base_cnn.layer_dims == (32, 64, 96, 128, 256)
    assert tb.base_cnn.path_estan[1].block12[0].weight.shape == (64, 32, 3, 3)
    assert tb.aux1.weight.shape == (5, 64, 1, 1)  # infer: aux heads on the raw skip widths
    assert get_model("gtc_tb", 5, variant="train").aux1.weight.shape == (5, 32, 1, 1)
    sb = get_model("stc_sb", 5)
    assert [len(s.mhca_blks) for s in sb.base_vit.mhca_stages] == [2, 3, 3, 3]
    assert [len(s.mhca_blks[0].MHCA_layers) for s in sb.base_vit.mhca_stages] == [1, 3, 6, 3]
    assert sb.base_vit.mhca_stages[1].aggregate.conv.weight.shape == (216, 128 * 4, 1, 1)
    pn = get_model("pnnu", 5)
    assert not pn.flag_vit and pn.base_cnn.path_estan[0].block34[0].weight.shape == (32, 32, 1, 3)
    assert not get_model("vitu", 5).flag_cnn
    assert get_model("stc_st", 5, mixer="metapool_pallas", drop_path_rate=0.2).variant == "infer"


def test_load_into_needed_follows_the_flags():
    """A cnnu loads without the ViT branch and a vitu without the CNN
    projections; a model that runs a branch may not come without it."""
    sd = RegNet(get_model("stc_tt", 5), out_channels=5).state_dict()
    drop = lambda subs: {k: v for k, v in sd.items() if not any(s in k for s in subs)}  # noqa: E731
    no_vit = drop(("base_vit.", "tran_vit", "tran_cnn"))
    load_into(RegNet(get_model("cnnu", 5), out_channels=5), no_vit)
    for net in ("stc_tt", "gtc_tt", "vitu"):
        with pytest.raises(KeyError, match="base_vit|tran_vit"):
            load_into(RegNet(get_model(net, 5), out_channels=5), no_vit)
    no_tran_cnn = drop(("tran_cnn",))
    load_into(RegNet(get_model("vitu", 5), out_channels=5), no_tran_cnn)
    with pytest.raises(KeyError, match="tran_cnn"):
        load_into(RegNet(get_model("stc_tt", 5), out_channels=5), no_tran_cnn)
    with pytest.raises(KeyError, match="base_cnn"):
        load_into(RegNet(get_model("cnnu", 5), out_channels=5), drop(("base_cnn.cnn.0",)))
    with pytest.raises(KeyError, match="path_estan.3"):
        load_into(RegNet(get_model("vitu", 5), out_channels=5), drop(("path_estan.3.block5.0",)))
    # a bare FTC (no RegNet wrapper) is held to the same rule
    bare = {k[len("base."):]: v for k, v in no_vit.items() if k.startswith("base.")}
    load_into(get_model("cnnu", 5), bare)
    with pytest.raises(KeyError, match="base_vit"):
        load_into(get_model("stc_tt", 5), bare)


@pytest.mark.parametrize("name", ["stc_tt", "gtc_tb"])
def test_predictor_fused_matches_plain_and_jax(name):
    """``cnn_impl='fused'`` on the CPU (the kernel's plain version): the f32
    class maps equal the ``'plain'`` ones, and the JAX predictor's, on at
    least 99.9 % of pixels; the fused path goes through fused_cross_block
    five times a batch."""
    if name == "stc_tt":
        m = RegNet(get_model(name, NC), out_channels=NC)
        init_weights(m, torch.Generator().manual_seed(0))
        x = np.random.default_rng(0).random((2,) + HW + (3,)).astype(np.float32)
        calibrate_bn(m, torch.from_numpy(x))
        net = jv = None
    else:
        m, net, jv, _ = pair(name, "infer")
    vol = np.random.default_rng(4).integers(0, 255, (5,) + HW + (3,), dtype=np.uint8)
    plain = VolumePredictor(m, GEO, batch_size=4, dtype=torch.float32, device="cpu")
    fused = VolumePredictor(m, GEO, batch_size=4, dtype=torch.float32, device="cpu",
                            cnn_impl="fused")
    calls = []
    import tcct_tpu_torch.ops.kernels.crosscnn_fused as kf
    ref = kf.fused_cross_block_reference
    kf.fused_cross_block_reference = lambda x, b: calls.append(tuple(x.shape)) or ref(x, b)
    try:
        a, b = plain.predict_scans(vol), fused.predict_scans(vol)
    finally:
        kf.fused_cross_block_reference = ref
    assert len(calls) == 2 * 5 and fused_cross_block.launches == 0
    assert calls[:5] == [(4, 64 >> i, 96 >> i, c) for i, c in
                         enumerate((32,) + tuple(m.base.base_cnn.layer_dims[:-1]))]
    assert a.shape == b.shape == (5,) + HW and len(np.unique(a)) > 1
    assert (a == b).mean() >= 0.999
    if net is not None:
        want = JaxVolumePredictor(net, jv, GEO, batch_size=4, dtype=jnp.float32,
                                  cnn_impl="plain").predict_scans(vol)
        assert (b == want).mean() >= 0.999 and (a == want).mean() >= 0.999


def test_load_predictor_net_and_cnn_impl_cpu():
    """``load_predictor``'s new arguments: a registry name, the fused
    branch, and the default, which builds what it built before."""
    vol = np.random.default_rng(5).integers(0, 256, (2, 256, 512, 3), dtype=np.uint8)
    base = load_predictor("hcms", batch_size=2, dtype=torch.float32, device="cpu", seed=0)
    assert base.cnn_impl == "plain" and not base.model.base.flag_gate
    same = load_predictor("hcms", net="stc_tt", variant="infer", cnn_impl="plain",
                          mixer="metapool_pallas", batch_size=2, dtype=torch.float32,
                          device="cpu", seed=0)
    np.testing.assert_array_equal(base.predict_scans(vol[:1]), same.predict_scans(vol[:1]))
    fused = load_predictor("hcms", net="cnnu", cnn_impl="fused", batch_size=2,
                           dtype=torch.float32, device="cpu", seed=0)
    plain = load_predictor("hcms", net="cnnu", batch_size=2, dtype=torch.float32, device="cpu",
                           seed=0)
    a, b = plain.predict_scans(vol), fused.predict_scans(vol)
    assert a.shape == (2, 256, 512) and int(a.max()) < 9
    assert (a == b).mean() >= 0.999


def test_zoo_raises():
    with pytest.raises(ValueError, match="lane layout|space-to-depth"):
        load_predictor("duke", cnn_impl="packed", device="cpu")
    with pytest.raises(ValueError, match="cnn_impl"):
        load_predictor("duke", cnn_impl="winograd", device="cpu")
    with pytest.raises(ValueError, match="no CrossCNN blocks"):
        VolumePredictor(torch.nn.Conv2d(3, 3, 1), GEO, device="cpu", cnn_impl="fused")
    for mixer in ("factor", "hydra", "metapool2d", "nope"):
        with pytest.raises(ValueError, match="A\.6"):
            get_model("stc_tt", 5, mixer=mixer)
    for name in ("msca", "tcct32", "relay"):
        with pytest.raises(KeyError, match="stc_tt"):
            get_model(name, 5)
    with pytest.raises(ValueError, match="variant"):
        get_model("gtc_tb", 5, variant="t32")
    # gated fusion in train mode needs the random alpha map: not ported
    gtc = get_model("gtc_tt", 5, variant="train", drop_path_rate=0.0).train()
    with pytest.raises(NotImplementedError, match="A\.6"):
        gtc(torch.rand(2, 32, 32, 3))
    # ... while simple fusion trains, and gated fusion serves
    with torch.no_grad():
        assert gtc.eval()(torch.rand(1, 32, 32, 3))[0].shape == (1, 32, 32, 5)


@pytest.mark.parametrize("name", ["stc_sb", "gtc_tb", "cnnu", "vitu"])
def test_chip_smoke_expected_launches_match_the_model(monkeypatch, name):
    """chip_smoke.py's per-batch launch counts, derived from a model's
    config, are what its forward really asks of each kernel wrapper (on the
    CPU: calls of the plain versions), with the CNN branch plain and fused."""
    from collections import Counter

    import chip_smoke
    import tcct_tpu_torch.ops.kernels.crosscnn_fused as kf
    import tcct_tpu_torch.ops.kernels.dwconv as dw
    import tcct_tpu_torch.ops.kernels.metapool as mp

    seen, in_site = Counter(), []
    ref_mp, ref_dw, ref_kf = (mp.metapool_tokens_reference, dw.dwconv3x3_reference,
                              kf.fused_cross_block_reference)
    ref_site = mp.metapool_block_reference

    def site(*args, **kw):  # the eval block's site: one launch, the mixer inside it
        seen.update(["metapool_block"])
        in_site.append(1)
        try:
            return ref_site(*args, **kw)
        finally:
            in_site.pop()

    def tokens(x):  # bare K1 (the train path's)
        if not in_site:
            seen.update(["metapool_tokens"])
        return ref_mp(x)

    monkeypatch.setattr(mp, "metapool_block_reference", site)
    monkeypatch.setattr(mp, "metapool_tokens_reference", tokens)
    monkeypatch.setattr(dw, "dwconv3x3_reference",
                        lambda x, w, s: seen.update([f"dwconv3x3_s{s}"]) or ref_dw(x, w, s))
    monkeypatch.setattr(kf, "fused_cross_block_reference",
                        lambda x, b: seen.update(["fused_cross_block"]) or ref_kf(x, b))
    m = RegNet(get_model(name, 5), out_channels=5)
    init_weights(m, torch.Generator().manual_seed(0))
    vol = np.random.default_rng(0).integers(0, 255, (2, 64, 96, 3), dtype=np.uint8)
    geo = DatasetGeometry("tinyl", 5, 0, 64, "resize", (64, 96))
    for impl in ("plain", "fused"):
        seen.clear()
        pred = VolumePredictor(m, geo, batch_size=2, dtype=torch.float32, device="cpu",
                               cnn_impl=impl)
        pred.predict_scans(vol)
        want = chip_smoke.expected_launches(pred.model, 2, (64, 96), impl == "fused")
        assert dict(seen) == {k: n for k, n in want.items() if n}
