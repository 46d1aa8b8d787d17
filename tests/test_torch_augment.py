"""The port's augmentation (``tcct_tpu_torch/data/augment.py``) against the
JAX package's (``tcct_tpu/data/augment.py``) on the CPU.

RNG streams cannot match across frameworks, so the JAX test side draws
every per-sample parameter with ``jax.random``, following the JAX
package's own key splits (``augment.py:158-176``), hands them to the
port's ``apply_*`` and holds the result against ``train_augment_batch`` /
``val_augment_batch`` at the same key: images within 1e-6 (f32), labels
equal.  JAX runs the train chain op by op (``jax.disable_jit()``), each op
rounded as written: its fused program contracts multiply-adds (4.5e-7 in
the HSV step alone), which the port's eager ops do not.  The port's own
draws are held to the crop's invariants, as ``tests/test_augment.py``
holds JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcct_tpu.data import augment as jaug
from tcct_tpu_torch.data.augment import (
    TrainDraws,
    _hsv_to_rgb,
    _rgb_to_hsv,
    apply_train,
    apply_val,
    crop_origin,
    draw_train,
    draw_val,
    val_generator,
)

CROP = (64, 64)


def _batch(B=4, H=96, W=128, nc=5, seed=0, empty=()):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 255, (B, H, W, 3), dtype=np.uint8)
    labs = np.zeros((B, H, W), np.uint8)
    labs[:, 40:70, 30:100] = rng.integers(1, nc, (B, 30, 70))
    for i in empty:
        labs[i] = 0
    return imgs, labs


def _jax_draws(labs, key, crop_hw):
    """The parameters train_augment_batch draws from ``key``, per sample,
    through the JAX package's own splits."""
    cols = {k: [] for k in ("y0", "x0", "flip_h", "flip_v", "rgb", "hsv", "contrast",
                            "brightness")}
    for lab, k in zip(labs, jax.random.split(key, labs.shape[0])):
        k_crop, k_flip, k_rgb, k_hsv, k_con, k_bri = jax.random.split(k, 6)
        y0, x0 = jaug._crop_offsets(jnp.asarray(lab), k_crop, crop_hw)
        kh, kv = jax.random.split(k_flip)
        lim = 20.0 / 255.0
        hh, hs, hv = jax.random.split(k_hsv, 3)
        cols["y0"].append(int(y0))
        cols["x0"].append(int(x0))
        cols["flip_h"].append(bool(jax.random.bernoulli(kh, 0.5)))
        cols["flip_v"].append(bool(jax.random.bernoulli(kv, 0.5)))
        cols["rgb"].append(np.asarray(jax.random.uniform(k_rgb, (3,), minval=-lim, maxval=lim)))
        cols["hsv"].append([float(jax.random.uniform(hh, (), minval=-20 / 180, maxval=20 / 180)),
                            float(jax.random.uniform(hs, (), minval=-30 / 255, maxval=30 / 255)),
                            float(jax.random.uniform(hv, (), minval=-20 / 255, maxval=20 / 255))])
        cols["contrast"].append(1.0 + float(jax.random.uniform(k_con, (), minval=-0.2,
                                                                 maxval=0.2)))
        cols["brightness"].append(1.0 + float(jax.random.uniform(k_bri, (), minval=-0.2,
                                                                   maxval=0.2)))
    f32 = lambda v: torch.tensor(np.asarray(v, np.float32))  # noqa: E731
    return TrainDraws(torch.tensor(cols["y0"]), torch.tensor(cols["x0"]),
                      torch.tensor(cols["flip_h"]), torch.tensor(cols["flip_v"]),
                      f32(cols["rgb"]), f32(cols["hsv"]), f32(cols["contrast"]),
                      f32(cols["brightness"]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_train_matches_jax_at_its_draws(seed):
    imgs, labs = _batch(B=4, seed=seed, empty=(3,))
    key = jax.random.PRNGKey(seed)
    with jax.disable_jit():
        want_img, want_lab = jaug.train_augment_batch(jnp.asarray(imgs), jnp.asarray(labs), key,
                                                      CROP)
    draws = _jax_draws(labs, key, CROP)
    got_img, got_lab = apply_train(torch.from_numpy(imgs), torch.from_numpy(labs), draws, CROP)
    assert got_img.dtype == torch.float32 and got_img.shape == (4, 64, 64, 3)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_lab.numpy(), np.asarray(want_lab))


def test_hsv_round_trip_matches_jax():
    rng = np.random.default_rng(5)
    rgb = rng.uniform(0, 1, (2000, 3)).astype(np.float32)
    rgb[:50] = rgb[:50, :1]  # grey pixels: diff == 0
    rgb[50:100, 0] = rgb[50:100, 1]  # ties between channels
    h, s, v = _rgb_to_hsv(torch.from_numpy(rgb))
    want = np.asarray(jaug._rgb_to_hsv(jnp.asarray(rgb)))
    np.testing.assert_allclose(torch.stack([h, s, v], -1).numpy(), want, rtol=0, atol=1e-7)
    back = _hsv_to_rgb(h, s, v).numpy()
    np.testing.assert_allclose(back, np.asarray(jaug._hsv_to_rgb(jnp.asarray(want))), rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("stochastic", [True, False])
def test_apply_val_matches_jax_at_its_draws(stochastic):
    imgs, labs = _batch(B=4, seed=3)
    key = jax.random.PRNGKey(11)
    want_img, want_lab = jaug.val_augment_batch(jnp.asarray(imgs), jnp.asarray(labs), key,
                                                stochastic=stochastic)
    flips = torch.tensor([bool(jax.random.bernoulli(k, 0.5))
                          for k in jax.random.split(key, imgs.shape[0])])
    got_img, got_lab = apply_val(torch.from_numpy(imgs), torch.from_numpy(labs), flips,
                                 stochastic=stochastic)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_lab.numpy(), np.asarray(want_lab))


def test_crop_contains_mask():
    _, labs = _batch(B=8, seed=4)
    labs_t = torch.from_numpy(labs)
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        y0, x0 = crop_origin(labs_t, gen, CROP)
        for b in range(8):
            win = labs[b, int(y0[b]):int(y0[b]) + 64, int(x0[b]):int(x0[b]) + 64]
            assert win.shape == CROP and (win > 0).any()


def test_crop_empty_mask_fallback():
    """An empty mask draws both coordinates from [0, max(H - ch, 1)) and
    clips x to W - cw, as JAX's _crop_offsets does."""
    labs = torch.zeros((64, 96, 200), dtype=torch.uint8)
    y0, x0 = crop_origin(labs, torch.Generator().manual_seed(1), CROP)
    assert int(y0.max()) <= 96 - 64 and int(x0.max()) <= 96 - 64 - 1
    assert len(set(y0.tolist())) > 8 and len(set(x0.tolist())) > 8
    imgs = torch.zeros((64, 96, 200, 3), dtype=torch.uint8)
    draws = draw_train(labs, torch.Generator().manual_seed(1), CROP)
    img, lab = apply_train(imgs, labs, draws, CROP)
    assert img.shape == (64, 64, 64, 3) and int(lab.sum()) == 0


def test_draws_advance_the_generator_alike_whatever_the_labels():
    """Fixed-shape draws: an empty and a full mask leave the generator in
    the same state, and one generator state gives one set of draws."""
    states = []
    for labs in (torch.zeros((4, 96, 128), dtype=torch.uint8),
                 torch.ones((4, 96, 128), dtype=torch.uint8)):
        gen = torch.Generator().manual_seed(3)
        draw_train(labs, gen, CROP)
        states.append(gen.get_state())
    assert torch.equal(states[0], states[1])
    _, labs = _batch(seed=6)
    a = draw_train(torch.from_numpy(labs), torch.Generator().manual_seed(9), CROP)
    b = draw_train(torch.from_numpy(labs), torch.Generator().manual_seed(9), CROP)
    for f in ("y0", "x0", "flip_h", "flip_v", "rgb", "hsv", "contrast", "brightness"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_draw_ranges_and_output_range():
    imgs, labs = _batch(B=64, seed=7)
    d = draw_train(torch.from_numpy(labs), torch.Generator().manual_seed(0), CROP)
    assert float(d.rgb.abs().max()) < 20 / 255
    assert float(d.hsv[:, 0].abs().max()) < 20 / 180
    assert float(d.hsv[:, 1].abs().max()) < 30 / 255
    assert float((d.contrast - 1).abs().max()) < 0.2
    assert float((d.brightness - 1).abs().max()) < 0.2
    assert 0 < int(d.flip_h.sum()) < 64 and 0 < int(d.flip_v.sum()) < 64
    img, lab = apply_train(torch.from_numpy(imgs), torch.from_numpy(labs), d, CROP)
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0 and lab.dtype == torch.int64


def test_val_flips_are_one_vector_per_epoch():
    a = draw_val(9, val_generator(4))
    assert a.shape == (9,) and a.dtype == torch.bool
    assert torch.equal(a[:5], draw_val(5, val_generator(4)))
    assert not torch.equal(draw_val(64, val_generator(4)), draw_val(64, val_generator(5)))
