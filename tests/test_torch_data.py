"""The port's data modules (``tcct_tpu_torch/data``) against the JAX
package's on the CPU: the synthetic ``EyeSet`` splits and a PNG folder
loaded by the port (native decoder) byte-equal to JAX's ``EyeSet.load``
(cv2), the port's native binding equal to JAX's on the same files, and the
prefetcher streaming every batch and raising a decode error."""

import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from tcct_tpu.data import EyeSet as JaxEyeSet
from tcct_tpu.data import native as jax_native
from tcct_tpu.data.geometry import GEOMETRY
from tcct_tpu_torch.data import EyeSet, get_geometry, synthesize_oct
from tcct_tpu_torch.data import native
from tcct_tpu_torch.data.prefetch import BatchPrefetcher


def _same_splits(a, b):
    assert set(a.splits) == set(b.splits)
    for k in a.splits:
        for x, y in zip(a.splits[k], b.splits[k]):
            assert x.dtype == y.dtype == np.uint8 and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)


def test_synthetic_splits_equal_jax_under_the_env(monkeypatch):
    monkeypatch.setenv("TCCT_SYNTH_N", "8")
    monkeypatch.setenv("TCCT_SYNTH_HW", "96x128")
    ours, ref = EyeSet.load("goals"), JaxEyeSet.load("goals")
    assert ours.synthetic and ref.synthetic
    assert ours.geo.prep_hw == ref.geo.prep_hw == (96, 128)
    _same_splits(ours, ref)
    assert ours.oversample == ref.oversample and ours.out_channels == 5
    assert ours.epoch_length("train") == ref.epoch_length("train")
    assert ours.epoch_length("val") == ref.epoch_length("val") == 2
    rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(1)
    np.testing.assert_array_equal(ours.sample_indices(rng_a, 5), ref.sample_indices(rng_b, 5))


@pytest.mark.parametrize("db", sorted(GEOMETRY))
def test_synthetic_full_geometry_equals_jax(db, monkeypatch):
    monkeypatch.delenv("TCCT_SYNTH_N", raising=False)
    monkeypatch.delenv("TCCT_SYNTH_HW", raising=False)
    monkeypatch.delenv("TCCT_DATA_ROOT", raising=False)
    ours, ref = EyeSet.load(db, synthetic_n=2), JaxEyeSet.load(db, synthetic_n=2)
    assert ours.splits["train"][0].shape[1:3] == get_geometry(db).prep_hw
    _same_splits(ours, ref)
    seg = (ours.splits["val"][1][0] % ours.out_channels).astype(np.uint8)
    native_hw = (496, 1100) if db == "goals" else (496, 610)
    np.testing.assert_array_equal(ours.postprocess(seg, native_hw),
                                  ref.postprocess(seg, native_hw))


def _write_folder(root, db, shapes, nested=False, missing_lab=None):
    rng = np.random.default_rng(len(shapes))
    for split in ("train", "val"):
        for i, (h, w) in enumerate(shapes):
            sub = os.path.join(root, db, f"{split}_img", "vol0" if nested else "")
            lsub = sub.replace(f"{split}_img", f"{split}_lab")
            os.makedirs(sub, exist_ok=True)
            os.makedirs(lsub, exist_ok=True)
            img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            cv2.imwrite(os.path.join(sub, f"s{i}.png"), img)
            if (split, i) != missing_lab:
                lab = (rng.integers(0, 5, (h, w)) * 30).astype(np.uint8)
                cv2.imwrite(os.path.join(lsub, f"s{i}.png"), lab)


@pytest.mark.parametrize("db,shapes,nested", [
    ("duke", [(496, 536), (300, 500), (230, 610)], False),  # pad
    ("duke2", [(360, 500), (400, 600)], True),  # pad with reflection, nested folders
    ("hcms", [(496, 1024), (500, 700)], False),  # nearest resize
])
def test_png_folder_equals_jax_cv2_load(tmp_path, db, shapes, nested):
    root = str(tmp_path)
    _write_folder(root, db, shapes, nested=nested, missing_lab=("val", 1))
    ours, ref = EyeSet.load(db, root=root), JaxEyeSet.load(db, root=root)
    assert not ours.synthetic and not ref.synthetic
    _same_splits(ours, ref)
    assert ours.paths == ref.paths and ours.pairs == ref.pairs
    assert ours.pairs["val"][1][1] is None


def test_png_folder_without_val_aliases_train(tmp_path):
    root = str(tmp_path)
    _write_folder(root, "heg", [(496, 610)])
    import shutil

    shutil.rmtree(os.path.join(root, "heg", "val_img"))
    ours, ref = EyeSet.load("heg", root=root), JaxEyeSet.load("heg", root=root)
    _same_splits(ours, ref)
    np.testing.assert_array_equal(ours.splits["val"][0], ours.splits["train"][0])


def test_unreadable_image_raises(tmp_path):
    root = str(tmp_path)
    _write_folder(root, "duke", [(64, 64)])
    with open(os.path.join(root, "duke", "train_img", "bad.png"), "wb") as f:
        f.write(b"not a png")
    with pytest.raises(IOError, match="bad.png"):
        EyeSet.load("duke", root=root)


def test_folder_without_the_loader_raises_no_synthetic_fallback(tmp_path, monkeypatch):
    root = str(tmp_path)
    _write_folder(root, "duke", [(64, 64)])

    def missing():
        raise native.NativeLoaderError("the native PNG loader needs a C++ compiler: g++ not found")

    monkeypatch.setattr(native, "_get", missing)
    with pytest.raises(native.NativeLoaderError, match="g\\+\\+"):
        EyeSet.load("duke", root=root)


def test_build_names_the_missing_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "LIBRARY", str(tmp_path / "liboct_loader.so"))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.available()
    with pytest.raises(native.NativeLoaderError, match="g\\+\\+ not found"):
        native.png_info("x.png")
    assert not os.listdir(tmp_path)


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    pairs = []
    for i, (h, w) in enumerate([(496, 536), (128, 256), (64, 64), (230, 500), (300, 300)]):
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        lab = (rng.integers(0, 5, (h, w)) * 30).astype(np.uint8)
        ip, lp = str(d / f"img{i}.png"), str(d / f"lab{i}.png")
        cv2.imwrite(ip, img)
        cv2.imwrite(lp, lab)
        pairs.append((ip, lp))
    return pairs


def test_decode_and_load_batch_equal_jax_native(pngs):
    if not jax_native.available():
        pytest.skip("the JAX package's native loader does not build here")
    assert native.available()
    for ip, lp in pngs:
        assert native.png_info(ip) == jax_native.png_info(ip)
        np.testing.assert_array_equal(native.decode_png(ip), jax_native.decode_png(ip))
        np.testing.assert_array_equal(native.decode_png(lp, channels=1),
                                      jax_native.decode_png(lp, channels=1))
    for kw in (dict(hw=(256, 576), height_end=224, prep_mode="pad"),
               dict(hw=(384, 576), height_end=384, prep_mode="pad", prep_reflect=True),
               dict(hw=(128, 128), prep_mode="resize", divide=30)):
        a = native.load_batch([p[0] for p in pngs], [p[1] for p in pngs], **kw)
        b = jax_native.load_batch([p[0] for p in pngs], [p[1] for p in pngs], **kw)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2] == len(pngs)
    # into caller-owned arrays, a failing file zero-filled and not counted
    out = (np.full((8, 64, 64, 3), 7, np.uint8), np.full((8, 64, 64), 7, np.uint8))
    imgs, labs, n_ok = native.load_batch([pngs[0][0], "/nope.png"], None, hw=(64, 64),
                                         prep_mode="resize", out=out)
    assert n_ok == 1 and np.shares_memory(imgs, out[0])
    assert int(out[0][1].max()) == 0 and int(out[0][2].min()) == 7
    with pytest.raises(ValueError, match="C-contiguous"):
        native.load_batch([pngs[0][0]], None, hw=(64, 64), out=(out[0][:, ::2], out[1]))


@pytest.mark.parametrize("device", [None, "cpu"])
def test_prefetcher_streams_every_batch(pngs, device):
    geo = get_geometry("duke")
    pf = BatchPrefetcher(pngs, geo, batch_size=2, device=device)
    assert len(pf) == 3
    batches = list(pf)
    assert [b[0].shape[0] for b in batches] == [2, 2, 1]  # the tail at its natural size
    want = native.load_batch([p[0] for p in pngs], [p[1] for p in pngs], hw=geo.prep_hw,
                             height_end=geo.height_end)
    got_i = np.concatenate([np.asarray(b[0]) for b in batches])
    got_l = np.concatenate([np.asarray(b[1]) for b in batches])
    np.testing.assert_array_equal(got_i, want[0])
    np.testing.assert_array_equal(got_l, want[1])
    if device is not None:
        assert all(isinstance(b[0], torch.Tensor) for b in batches)
    assert pf.decoded_scans == 5 and pf.decoded_bytes == want[0].nbytes + want[1].nbytes
    assert pf.decode_s > 0


def test_prefetcher_surfaces_a_decode_error(pngs, monkeypatch):
    calls = []

    def failing(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise ValueError("decode failed in the producer")
        return real(*a, **k)

    real = native.load_batch
    monkeypatch.setattr(native, "load_batch", failing)
    it = iter(BatchPrefetcher(pngs, get_geometry("duke"), batch_size=2, device=None))
    next(it)
    with pytest.raises(ValueError, match="decode failed in the producer"):
        next(it)


def test_prefetcher_stops_its_producer_when_left_early(pngs):
    pf = BatchPrefetcher(pngs * 4, get_geometry("duke"), batch_size=1, depth=1, device=None)
    it = iter(pf)
    next(it)
    it.close()  # the generator's finally drains the queue and joins the producer
    assert pf.decoded_scans < 20


def test_synthesize_oct_is_layered():
    imgs, labs = synthesize_oct(get_geometry("duke"), 2, seed=3)
    # classes 0..nc-2: the region below the last boundary is background again
    assert imgs.shape == (2, 256, 576, 3) and labs.max() == 7
    assert np.array_equal(imgs[..., 0], imgs[..., 2])
