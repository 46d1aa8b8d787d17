"""Task 2 in the port (``tcct_tpu_torch/task2``) against the JAX package's
(``tcct_tpu/task2``) on the CPU, at 64x64: the metrics, the ResNet's eval
logits at JAX's variables (``from_jax_variables``), the ImageNet graft,
the data (synthetic images, the PNG prep without cv2, the xlsx labels),
the augmentation at JAX's draws, and the TTA ensemble and its CSVs.

Tolerances: eval logits within ``1e-4 + 1e-5 * |JAX's|`` (f32 convs in
another order; res50's random BN statistics leave logits near 70) with
equal argmax; the augmentation within 1e-6 of JAX run op by op
(``jax.disable_jit()``, as ``test_torch_augment.py``: jitted JAX contracts
multiply-adds); everything else equal, byte for byte where files or uint8
arrays."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcct_tpu.task2 import data as jdata
from tcct_tpu.task2 import ensemble as jens
from tcct_tpu.task2 import metrics as jmetrics
from tcct_tpu.task2.model import ClsModel as JaxClsModel
from tcct_tpu.task2.model import load_resnet_checkpoint as jax_graft
from tcct_tpu_torch.infer.importer import flatten_variables, from_jax_variables
from tcct_tpu_torch.task2 import ensemble, metrics
from tcct_tpu_torch.task2.data import (
    ClsDraws,
    GoalClsSet,
    apply_cls_train,
    load_labels,
    prep_image,
    resize_linear_u8,
    resized_crop,
    synthesize_cls,
    write_labels_xlsx,
)
from tcct_tpu_torch.task2.model import ClsModel, load_resnet_checkpoint
from tcct_tpu_torch.task2.train import ClsTrainer, bn_modules

HW = 64


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nest(flat):
    out = {}
    for k, a in flat.items():
        d = out
        *heads, leaf = k.split("/")
        for h in heads:
            d = d.setdefault(h, {})
        d[leaf] = a
    return out


def jax_variables(net: str, seed: int = 0):
    """JAX ClsModel variables at 64x64, with BatchNorm scales, biases and
    statistics and the Dense biases made random (the init's are 1 and 0),
    flattened to ``"params/.../kernel"`` numpy arrays."""
    m = JaxClsModel(net=net)
    x = jnp.zeros((1, HW, HW, 3))
    v = jax.jit(lambda: m.init({"params": jax.random.PRNGKey(seed),
                                "dropout": jax.random.PRNGKey(1)}, x, train=False))()
    flat = flatten_variables(jax.device_get(v))
    rng = np.random.default_rng(seed + 1)
    for k, a in flat.items():
        leaf = k.rsplit("/", 1)[1]
        if leaf == "scale":
            flat[k] = (1 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        elif leaf in ("bias", "mean"):
            flat[k] = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        elif leaf == "var":
            flat[k] = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
    return m, flat


def port_model(net: str, flat) -> ClsModel:
    p = ClsModel(net)
    res = p.load_state_dict(from_jax_variables(flat), strict=False)
    assert res.unexpected_keys == []
    assert all(k.endswith("num_batches_tracked") for k in res.missing_keys)
    return p.to(memory_format=torch.channels_last)


def images(n=2, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, HW, HW, 3), dtype=np.uint8)


# --- metrics -------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_jax_and_sklearn(seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, 50)
    s = rng.random(50).round(2)  # ties
    for name in ("roc_auc", "f1_score", "accuracy"):
        arg = s if name == "roc_auc" else s.round()
        assert getattr(metrics, name)(y, arg) == getattr(jmetrics, name)(y, arg)
    assert np.isnan(metrics.roc_auc(np.ones(4), np.arange(4)))
    try:
        import sklearn.metrics as skm
    except ImportError:
        return
    np.testing.assert_allclose(metrics.roc_auc(y, s), skm.roc_auc_score(y, s), rtol=1e-9)
    np.testing.assert_allclose(metrics.f1_score(y, s.round()), skm.f1_score(y, s.round()),
                               rtol=1e-9)
    np.testing.assert_allclose(metrics.accuracy(y, s.round()),
                               skm.accuracy_score(y, s.round()), rtol=1e-9)


# --- the model ------------------------------------------------------------------

@pytest.mark.parametrize("net", ["res18", "res50"])
def test_eval_logits_match_jax(net):
    m, flat = jax_variables(net)
    x = images(2, seed=3).astype(np.float32) / 255.0
    want = np.asarray(jax.jit(lambda v, x: m.apply(v, x, train=False))(_nest(flat),
                                                                      jnp.asarray(x)))
    p = port_model(net, flat).eval()
    with torch.no_grad():
        got = p(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_res34_forward_shape_and_bn_count():
    p = ClsModel("res34").eval()
    with torch.no_grad():
        y = p(torch.zeros(2, 3, HW, HW).to(memory_format=torch.channels_last))
    assert y.shape == (2, 2)
    assert [len(bn_modules(ClsModel(n))) for n in ("res18", "res34", "res50")] == [20, 36, 53]
    names = set(ClsModel("res50").state_dict())
    assert {"layer1.0.downsample.0.weight", "layer1.0.downsample.1.running_var",
            "layer4.2.conv3.weight", "fc.0.weight", "fc.1.bias"} <= names


def test_max_pool_stem_is_jax_padded_pool():
    """The stem's 3x3/2 pool with pad 1 is JAX's VALID pool of the
    -inf-padded input, on odd and even sizes."""
    from tcct_tpu.ops.pool import max_pool_2d as jax_pool
    from tcct_tpu_torch.ops.pool import max_pool_2d

    for hw in (16, 17):
        x = np.random.default_rng(hw).standard_normal((2, hw, hw, 3)).astype(np.float32)
        want = jax_pool(jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 1), (0, 0)),
                                constant_values=-jnp.inf), 3, 2)
        got = max_pool_2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, padding=1)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


# --- the ImageNet graft ------------------------------------------------------------

def _tv_resnet18_state(rng):
    """A torchvision-named resnet18 state dict of random values."""
    sd = {}

    def conv(name, o, i, k):
        sd[name + ".weight"] = rng.standard_normal((o, i, k, k)).astype(np.float32)

    def bn(name, c):
        sd[name + ".weight"] = rng.standard_normal(c).astype(np.float32)
        sd[name + ".bias"] = rng.standard_normal(c).astype(np.float32)
        sd[name + ".running_mean"] = rng.standard_normal(c).astype(np.float32)
        sd[name + ".running_var"] = (np.abs(rng.standard_normal(c)) + 0.5).astype(np.float32)
        sd[name + ".num_batches_tracked"] = np.asarray(1)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    inc = 64
    for li, c in enumerate([64, 128, 256, 512]):
        for b in range(2):
            pre = f"layer{li + 1}.{b}"
            conv(pre + ".conv1", c, inc if b == 0 else c, 3)
            bn(pre + ".bn1", c)
            conv(pre + ".conv2", c, c, 3)
            bn(pre + ".bn2", c)
            if b == 0 and li > 0:
                conv(pre + ".downsample.0", c, inc, 1)
                bn(pre + ".downsample.1", c)
        inc = c
    sd["fc.weight"] = rng.standard_normal((1000, 512)).astype(np.float32)
    sd["fc.bias"] = rng.standard_normal(1000).astype(np.float32)
    return sd


def _wrapped_paddle(sd):
    out = {}
    for k, v in sd.items():
        k2 = k.replace(".running_mean", "._mean").replace(".running_var", "._variance")
        out["base." + re.sub(r"^(layer\d)\.", r"\1.0.", k2)] = v
    return out


def test_graft_names_agree_and_match_jax(tmp_path):
    """torchvision, wrapped and paddle names graft the same weights, those
    of the JAX package's graft; the head is kept; a .pt file reads too."""
    sd = _tv_resnet18_state(np.random.default_rng(0))
    a, b = ClsModel("res18"), ClsModel("res18")
    head = a.fc[0].weight.detach().clone()
    b.load_state_dict(a.state_dict())
    rep = load_resnet_checkpoint(sd, a)
    load_resnet_checkpoint(_wrapped_paddle(sd), b)
    assert torch.equal(a.fc[0].weight, head) and not [k for k in rep.loaded if "fc" in k]
    for (k, va), (_, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(va, vb), k
    np.testing.assert_array_equal(a.layer3[0].downsample[1].running_mean.numpy(),
                                  sd["layer3.0.downsample.1.running_mean"])
    m, flat = jax_variables("res18")
    jv, _ = jax_graft(sd, _nest(flat))
    want = from_jax_variables(flatten_variables(jax.device_get(jv)))
    got = a.state_dict()
    for k, v in want.items():
        if not k.startswith("fc."):
            assert torch.equal(got[k], v), k
    path = str(tmp_path / "r18.pth")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    c = ClsModel("res18")
    load_resnet_checkpoint(path, c)
    assert torch.equal(c.layer4[1].conv2.weight, a.layer4[1].conv2.weight)


def test_graft_rejects_partial_state():
    sd = _tv_resnet18_state(np.random.default_rng(2))
    partial = {k: v for k, v in sd.items() if "layer4" not in k}
    with pytest.raises(ValueError, match="untouched"):
        load_resnet_checkpoint(partial, ClsModel("res18"))
    with pytest.raises(ValueError, match="untouched"):  # another architecture
        load_resnet_checkpoint(sd, ClsModel("res50"))


# --- data ------------------------------------------------------------------------

@pytest.mark.parametrize("n,size,seed", [(6, 64, 0), (3, 224, 5)])
def test_synthesize_cls_equals_jax(n, size, seed):
    ours, want = synthesize_cls(n, size, seed), jdata.synthesize_cls(n, size, seed)
    for a, b in zip(ours, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    s = GoalClsSet.load(img_size=size, synthetic_n=n, seed=seed)
    r = jdata.GoalClsSet.load(img_size=size, synthetic_n=n, seed=seed)
    assert s.synthetic and s.names == r.names and s.oversample == r.oversample == 20
    np.testing.assert_array_equal(s.imgs, r.imgs)
    np.testing.assert_array_equal(s.labels, r.labels)


@pytest.mark.parametrize("hw,out", [((1120, 1120), (224, 224)), ((1120, 1120), (64, 64)),
                                    ((1200, 1300), (224, 224)), ((1120, 1120), (100, 100)),
                                    ((1500, 1120), (96, 160)), ((40, 50), (64, 64))])
def test_resize_is_cv2_inter_linear(hw, out):
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(hw[0] + out[0]).integers(0, 256, hw + (3,), dtype=np.uint8)
    want = cv2.resize(img, (out[1], out[0]), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(resize_linear_u8(img, *out), want)


@pytest.fixture(scope="module")
def goals_folder(tmp_path_factory):
    """Six colour PNGs (smaller, equal to and larger than 1120 on a side)
    and an xlsx of labels for four of them."""
    cv2 = pytest.importorskip("cv2")
    d = tmp_path_factory.mktemp("goals")
    rng = np.random.default_rng(7)
    for i, hw in enumerate([(800, 1100), (1120, 1120), (1200, 1300), (640, 900), (1150, 1000),
                            (300, 500)]):
        img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
        img[hw[0] // 4: hw[0] // 2, hw[1] // 3: hw[1] // 2] = (20, 200, 90)  # a colour block
        cv2.imwrite(str(d / f"{i + 1:04d}.png"), img)
    write_labels_xlsx(str(d / "labels.xlsx"), [(1, 0), (2, 1), ("0003.png", 1), (5, 0)])
    return d


@pytest.mark.parametrize("size", [224, 64])
def test_png_prep_equals_jax_cv2(goals_folder, size):
    for f in sorted(os.listdir(goals_folder)):
        if f.endswith(".png"):
            p = str(goals_folder / f)
            np.testing.assert_array_equal(prep_image(p, size), jdata._prep_image(p, size))


def test_xlsx_labels_and_folder_load(goals_folder):
    assert load_labels(str(goals_folder / "labels.xlsx")) == {"1": 0, "2": 1, "3": 1, "5": 0}
    ds = GoalClsSet.load(str(goals_folder), str(goals_folder / "labels.xlsx"), img_size=64)
    assert not ds.synthetic and ds.names == [f"{i:04d}.png" for i in range(1, 7)]
    assert ds.labels.tolist() == [0, 1, 1, 9, 0, 9] and ds.labels.dtype == np.int32
    ref = jdata.GoalClsSet.load(str(goals_folder), "", img_size=64)  # JAX reads xlsx via pandas
    np.testing.assert_array_equal(ds.imgs, ref.imgs)
    assert ds.names == ref.names


# --- augmentation at JAX's draws -------------------------------------------------------

def _jax_cls_draws(key, B):
    """The parameters ``cls_train_augment`` draws from ``key``, through the
    JAX package's own splits (``task2/data.py:108-150``)."""
    cols = {k: [] for k in ("scale", "y0", "x0", "flip_h", "flip_v", "rgb", "hsv", "contrast",
                            "brightness")}
    for k in jax.random.split(key, B):
        k_crop, k_flip, k_rgb, k_hsv, k_con, k_bri = jax.random.split(k, 6)
        ks, ky, kx = jax.random.split(k_crop, 3)
        kh, kv = jax.random.split(k_flip)
        hh, hs, hv = jax.random.split(k_hsv, 3)
        cols["scale"].append(float(jax.random.uniform(ks, (), minval=0.6, maxval=1.5)))
        cols["y0"].append(float(jax.random.uniform(ky, ())))
        cols["x0"].append(float(jax.random.uniform(kx, ())))
        cols["flip_h"].append(bool(jax.random.bernoulli(kh, 0.5)))
        cols["flip_v"].append(bool(jax.random.bernoulli(kv, 0.5)))
        lim = 20.0 / 255.0
        cols["rgb"].append(np.asarray(jax.random.uniform(k_rgb, (3,), minval=-lim, maxval=lim)))
        cols["hsv"].append([float(jax.random.uniform(hh, (), minval=-20 / 180, maxval=20 / 180)),
                            float(jax.random.uniform(hs, (), minval=-30 / 255, maxval=30 / 255)),
                            float(jax.random.uniform(hv, (), minval=-20 / 255, maxval=20 / 255))])
        cols["contrast"].append(1.0 + float(jax.random.uniform(k_con, (), minval=-0.2,
                                                                 maxval=0.2)))
        cols["brightness"].append(1.0 + float(jax.random.uniform(k_bri, (), minval=-0.2,
                                                                   maxval=0.2)))
    f32 = lambda v: torch.tensor(np.asarray(v, np.float32))  # noqa: E731
    return ClsDraws(f32(cols["scale"]), f32(cols["y0"]), f32(cols["x0"]),
                    torch.tensor(cols["flip_h"]), torch.tensor(cols["flip_v"]), f32(cols["rgb"]),
                    f32(cols["hsv"]), f32(cols["contrast"]), f32(cols["brightness"]))


def test_augmentation_matches_jax_at_its_draws():
    """Seeds whose draws hold zoom-in and zoom-out (scale > 1) samples and
    both flips."""
    scales, flips = [], []
    for seed in (0, 1, 2):
        imgs = images(4, seed=seed)
        key = jax.random.PRNGKey(seed)
        with jax.disable_jit():  # the draws too: jitted, uniform() contracts its multiply-add
            want = np.asarray(jdata.cls_train_augment(jnp.asarray(imgs), key))
            draws = _jax_cls_draws(key, 4)
        scales += draws.scale.tolist()
        flips += draws.flip_h.tolist() + draws.flip_v.tolist()
        got = apply_cls_train(torch.from_numpy(imgs), draws, HW)
        assert got.dtype == torch.float32 and got.shape == (4, HW, HW, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert min(scales) < 1.0 < max(scales) and any(flips) and not all(flips)


def test_zoom_out_repeats_the_last_row_and_column():
    """At scale > 1 (here 1.5, origin anywhere: no slack) the window starts
    at 0 and runs past the image: the image sits top-left, shrunk, and the
    rest repeats its last row and column (JAX's code; its docstring says
    it pads)."""
    S = 32
    img = torch.arange(S * S * 3, dtype=torch.float32).reshape(1, S, S, 3)
    d = ClsDraws(torch.tensor([1.5]), torch.tensor([0.7]), torch.tensor([0.3]),
                 *([torch.tensor([False])] * 2), torch.zeros(1, 3), torch.zeros(1, 3),
                 torch.ones(1), torch.ones(1))
    out = resized_crop(img, d)
    assert torch.equal(out[0, 0, 0], img[0, 0, 0])
    edge = int(np.ceil((S - 1) / (S * 1.5 - 1) * (S - 1)))  # first output row past the image
    assert torch.equal(out[0, edge:, edge:], img[0, -1, -1].expand(S - edge, S - edge, 3))
    assert torch.equal(out[0, edge:, 0], img[0, -1, 0].expand(S - edge, 3))


# --- TTA and the ensemble ---------------------------------------------------------------

def test_tta_means_and_csvs_equal_jax(tmp_path):
    m, flat = jax_variables("res18", seed=4)
    imgs = images(6, seed=9)
    want = np.asarray(jens.build_tta_predict(m)(_nest(flat)["params"], _nest(flat)["batch_stats"],
                                                jnp.asarray(imgs)))
    got = ensemble.build_tta_predict(port_model("res18", flat), device="cpu")(imgs)
    assert got.dtype == torch.float32 and got.shape == (6,)
    np.testing.assert_array_equal(got.numpy(), want)
    names = [f"{i:04d}.png" for i in (3, 1, 2, 6, 5, 4)]
    for mod, sub in ((ensemble, "ours"), (jens, "jax")):
        mod.write_csv(str(tmp_path / sub / "r0.csv"), names, list(got.numpy()))
        mod.write_csv(str(tmp_path / sub / "r1.csv"), names, [0.75, 0.25, 1.0, 0.0, 0.5, 0.5])
        final = mod.ensemble_csvs([str(tmp_path / sub / "r0.csv"), str(tmp_path / sub / "r1.csv")],
                                  str(tmp_path / sub / "final.csv"))
        assert set(final) == set(names)
    for f in ("r0.csv", "r1.csv", "final.csv"):
        assert (tmp_path / "ours" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    assert ensemble.read_csv(str(tmp_path / "ours" / "r0.csv")) == jens.read_csv(
        str(tmp_path / "jax" / "r0.csv"))


def test_ensemble_cli_on_the_cpu(tmp_path):
    """Two saved checkpoints (res18, res34 by folder name) -> TTA CSVs per
    model and the rounded mean."""
    ds = GoalClsSet.load(img_size=HW)  # the CLI's own synthetic set
    for i, net in enumerate(("res18", "res34")):
        tr = ClsTrainer(net=net, bs=2, root=str(tmp_path / "run"), img_size=HW, dataset=ds,
                        seed=i, device="cpu")
        tr.save(str(tmp_path / "weights" / f"{net}_fold{i}"))
    out = tmp_path / "pred"
    final = ensemble.main(["--weights", str(tmp_path / "weights"), "--out", str(out),
                           "--img_size", str(HW), "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["Classification_Results.csv",
                                       "Classification_Results0.csv",
                                       "Classification_Results1.csv"]
    assert set(final) == set(ds.names) and set(final.values()) <= {0, 1}
    assert ensemble.net_of(str(tmp_path / "weights" / "res34_fold1")) == "res34"
