"""PyTorch port serving path vs the JAX package (CPU, f32), plus the
port's boundaries: geometry table, prep/postprocess, weight loading, the
imports it may not make, and chip_smoke.py's refusal to run without a
card."""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcct_tpu.data.eyeset import EyeSet, _prep
from tcct_tpu.data.geometry import GEOMETRY as JAX_GEOMETRY
from tcct_tpu.infer.importer import import_torch_state
from tcct_tpu.infer.predictor import VolumePredictor as JaxVolumePredictor
from tcct_tpu.models import RegNet as JaxRegNet
from tcct_tpu.models import get_model as jax_get_model
from tcct_tpu_torch.data import GEOMETRY, DatasetGeometry, get_geometry, postprocess, prep
from tcct_tpu_torch.infer import VolumePredictor, load_into, load_predictor, load_reference_pt
from tcct_tpu_torch.models import RegNet, get_model
from tcct_tpu_torch.models.layers import init_weights
from tests.test_torch_models import calibrate_bn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NC = 9
GEO = DatasetGeometry("tinyp", NC, 0, 64, "resize", (64, 96))


@pytest.fixture(scope="module")
def calibrated():
    """A port model with calibrated BN statistics and the same weights in
    JAX variables."""
    vol = np.random.default_rng(3).integers(0, 255, (6, 64, 96, 3), dtype=np.uint8)
    m = RegNet(get_model("stc_tt", NC), out_channels=NC)
    init_weights(m, torch.Generator().manual_seed(0))
    calibrate_bn(m, torch.from_numpy(vol[:4].astype(np.float32) / 255.0))
    net = JaxRegNet(base=jax_get_model("stc_tt", NC, variant="infer", mixer="metapool_pallas"),
                    out_channels=NC)
    v = jax.jit(lambda: net.init({"params": jax.random.PRNGKey(0)},
                                 jnp.zeros((1, 64, 96, 3)), train=False))()
    v, _ = import_torch_state({k: t.numpy() for k, t in m.state_dict().items()}, v)
    return m, net, v, vol


@pytest.mark.parametrize("cnn_impl", ["plain", "packed"])
def test_predictor_f32_matches_jax(calibrated, cnn_impl):
    """6 scans through a batch-4 bucket (padded tail): the port's f32
    class maps equal the JAX predictor's."""
    m, net, v, vol = calibrated
    want = JaxVolumePredictor(net, v, GEO, batch_size=4, dtype=jnp.float32,
                              cnn_impl=cnn_impl).predict_scans(vol)
    got = VolumePredictor(m, GEO, batch_size=4, dtype=torch.float32, device="cpu").predict_scans(vol)
    assert got.shape == (6, 64, 96) and got.dtype == np.uint8
    assert len(np.unique(got)) > 1
    np.testing.assert_array_equal(got, want)


def test_predictor_padding_is_inert(calibrated):
    m, _, _, vol = calibrated
    a = VolumePredictor(m, GEO, batch_size=4, dtype=torch.float32, device="cpu").predict_scans(vol)
    b = VolumePredictor(m, GEO, batch_size=6, dtype=torch.float32, device="cpu").predict_scans(vol)
    np.testing.assert_array_equal(a, b)
    assert VolumePredictor(m, GEO, 4, torch.float32, "cpu").predict_scans(vol[:0]).shape == (0, 64, 96)


def test_load_predictor_duke_bucket_cpu():
    """The serving entry point at duke's full bucket and full width, seeded
    random weights, on the CPU path."""
    pred = load_predictor("duke", batch_size=2, dtype=torch.float32, device="cpu", seed=0)
    H, W = pred.geo.prep_hw
    assert (H, W) == (256, 576)
    vol = np.random.default_rng(0).integers(0, 256, (3, H, W, 3), dtype=np.uint8)
    seg = pred.predict_scans(vol)
    assert seg.shape == (3, H, W) and seg.dtype == np.uint8
    assert int(seg.max()) < 9
    again = load_predictor("duke", batch_size=2, dtype=torch.float32, device="cpu", seed=0)
    np.testing.assert_array_equal(again.predict_scans(vol[:1]), seg[:1])
    out = pred.predict_volume(vol[:1], native_hw=(496, 512))
    assert out.shape == (1, 496, 512)


def test_reference_pt_roundtrip(tmp_path):
    """A reference-style .pt (state dict with training-only extras) loads
    into a fresh model and reproduces its outputs."""
    m = RegNet(get_model("stc_tt", 5), out_channels=5)
    init_weights(m, torch.Generator().manual_seed(2))
    sd = dict(m.state_dict())
    sd["aug.flip.p"] = torch.zeros(1)
    path = str(tmp_path / "tcct_x.pt")
    torch.save(sd, path)
    loaded = load_reference_pt(path)
    assert "aug.flip.p" not in loaded
    m2 = RegNet(get_model("stc_tt", 5), out_channels=5)
    missing, unexpected = load_into(m2, loaded)
    assert missing == [] and unexpected == []
    x = torch.rand(1, 32, 64, 3)
    with torch.inference_mode():
        for a, b in zip(m.eval()(x), m2.eval()(x)):
            assert torch.equal(a, b)
    del loaded["base.head.0.weight"]
    with pytest.raises(KeyError, match="head"):
        load_into(m2, loaded)


def test_geometry_table_is_a_copy():
    assert {k: dataclasses.asdict(g) for k, g in GEOMETRY.items()} == {
        k: dataclasses.asdict(g) for k, g in JAX_GEOMETRY.items()}
    with pytest.raises(KeyError):
        get_geometry("nope")


@pytest.mark.parametrize("db,native", [("duke", (496, 512)), ("duke2", (496, 512)),
                                       ("heg", (496, 610)), ("goals", (800, 1100)),
                                       ("hcms", (496, 1024))])
def test_prep_and_postprocess_match_jax(db, native):
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, native + (3,), dtype=np.uint8)
    lab = rng.integers(0, 9, native, dtype=np.uint8)
    geo = get_geometry(db)
    want_img, want_lab = _prep(JAX_GEOMETRY[db], img, lab)
    got_img, got_lab = prep(geo, img, lab)
    np.testing.assert_array_equal(got_img, want_img)
    np.testing.assert_array_equal(got_lab, want_lab)
    eye = EyeSet(db, JAX_GEOMETRY[db], {}, {})
    np.testing.assert_array_equal(postprocess(geo, got_lab, native), eye.postprocess(want_lab, native))


# jax, flax, cv2, the JAX package, and the attic (as a package or as the
# top-level module its own test imports)
# what the port must not import: the JAX package and its stack, and the host
# libraries the card's machine lacks (cv2, pandas, openpyxl, sklearn, torchvision)
_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax|orbax|cv2|pandas|openpyxl|sklearn|torchvision|attic"
    r"|crosscnn_fused|tcct_tpu(?!_torch))\b", re.M)


def test_port_imports_no_jax_no_tcct_tpu_no_cv2():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "tcct_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = []
    for f in files:
        with open(f) as fh:
            bad += [f"{f}: {m.group(0).strip()}" for m in _FORBIDDEN.finditer(fh.read())]
    assert len(files) > 15 and bad == []
    names = {os.path.relpath(f, REPO) for f in files}
    assert {"tcct_tpu_torch/ops/kernels/crosscnn_fused.py", "tcct_tpu_torch/models/registry.py",
            "tcct_tpu_torch/infer/predictor.py", "chip_smoke.py",
            "tcct_tpu_torch/task2/data.py", "tcct_tpu_torch/task2/train.py"} <= names
    assert _FORBIDDEN.search("import os\nfrom attic.crosscnn_fused import fused_cross_block\n")
    for mod in ("pandas as pd", "openpyxl", "sklearn.metrics", "torchvision", "optax"):
        assert _FORBIDDEN.search(f"    import {mod}\n")
    assert _FORBIDDEN.search("    import crosscnn_fused as attic\n")
    assert not _FORBIDDEN.search("from tcct_tpu_torch.ops.kernels.crosscnn_fused import x\n")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA, and alone outside a checkout, chip_smoke.py exits
    non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    src = os.path.join(REPO, "chip_smoke.py")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(src).read())
    for script in (src, str(alone)):
        r = subprocess.run([sys.executable, script], capture_output=True, text=True,
                           timeout=120, cwd=os.path.dirname(script))
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_chip_smoke_path_shapes_match_the_model(monkeypatch):
    """chip_smoke.py's per-batch launch table (the shapes it checks the
    kernels at) is the one the model really produces."""
    from collections import Counter

    import chip_smoke
    import tcct_tpu_torch.ops.kernels.dwconv as dw
    import tcct_tpu_torch.ops.kernels.metapool as mp
    from tcct_tpu_torch.models.mpvit import MPViTConfig

    seen = {"mp": Counter(), 1: Counter(), 2: Counter()}
    ref_mp, ref_dw = mp.metapool_tokens_reference, dw.dwconv3x3_reference
    monkeypatch.setattr(mp, "metapool_tokens_reference",
                        lambda x: seen["mp"].update([tuple(x.shape)]) or ref_mp(x))
    monkeypatch.setattr(dw, "dwconv3x3_reference",
                        lambda x, w, s: seen[s].update([tuple(x.shape)]) or ref_dw(x, w, s))
    m = RegNet(get_model("stc_tt", 5), out_channels=5).eval()
    with torch.inference_mode():
        m(torch.rand(2, 64, 96, 3))
    want_mp, want_s1, want_s2 = chip_smoke.path_shapes(MPViTConfig(), 2, (64, 96))
    assert (seen["mp"], seen[1], seen[2]) == (want_mp, want_s1, want_s2)
