"""On-device augmentation (JAX counterpart ``tcct_tpu/data/augment.py``).

The reference's albumentations pipeline (task1/data/octgen.py:9-25):

  train: CropNonEmptyMaskIfExists -> HFlip(0.5) -> VFlip(0.5) -> RGBShift
         -> HueSaturationValue -> RandomContrast -> RandomBrightness
  val:   HFlip(p=1) -> VFlip(0.5), the reference's random val-time flips.

Each pipeline is split into its draws and their application.
``draw_train`` draws every per-sample parameter for the whole batch as
device tensors of fixed shapes, so a generator advances by the same amount
every step whatever the labels hold (resume and the bitwise repeat rest on
that).  ``apply_train`` computes the chain from them: the crop and both
flips are one gather per tensor, the colour chain runs on the batch in f32
(``_rgb_to_hsv`` and ``_hsv_to_rgb`` follow the JAX package op for op).
Nothing reads a device value on the host, and nothing uses float atomics.

The crop keeps ``_crop_offsets``' semantics: a uniform pick among the
foreground pixels (the argmax of masked i.i.d. uniforms, where JAX takes a
Gumbel argmax: both are uniform picks), offsets in ``[0, ch)`` and
``[0, cw)``, clipped into the image; an empty mask draws both coordinates
from ``[0, max(H - ch, 1))`` and clips x to ``W - cw``, as JAX does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

RGB_LIMIT = 20.0 / 255.0
HUE_LIMIT, SAT_LIMIT, VAL_LIMIT = 20.0 / 180.0, 30.0 / 255.0, 20.0 / 255.0
CONTRAST_LIMIT = BRIGHTNESS_LIMIT = 0.2


@dataclasses.dataclass
class TrainDraws:
    """Per-sample parameters of the train chain, [B] or [B, 3] tensors."""

    y0: torch.Tensor  # crop origin, int64
    x0: torch.Tensor
    flip_h: torch.Tensor  # bool
    flip_v: torch.Tensor
    rgb: torch.Tensor  # [B, 3] f32 shift of each channel
    hsv: torch.Tensor  # [B, 3] f32 hue, saturation and value shifts
    contrast: torch.Tensor  # f32 factors, 1 + U(-0.2, 0.2)
    brightness: torch.Tensor

    def rows(self, start: int, stop: int) -> "TrainDraws":
        """The draws of samples ``[start:stop)`` (a data-parallel rank's rows
        of draws made for the global batch)."""
        return TrainDraws(*(getattr(self, f.name)[start:stop] for f in dataclasses.fields(self)))


def _uniform(shape, lo: float, hi: float, generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo


def crop_origin(labs: torch.Tensor, generator: Optional[torch.Generator],
                crop_hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """CropNonEmptyMaskIfExists window origins ``(y0, x0)``, [B] int64, of a
    [B, H, W] label batch: each window holds a uniformly picked nonzero
    label pixel; an empty mask gives a uniform window."""
    B, H, W = labs.shape
    ch, cw = crop_hw
    dev = labs.device
    fg = (labs > 0).reshape(B, H * W)
    u = torch.rand((B, H * W), generator=generator, device=dev)
    pick = torch.argmax(torch.where(fg, u, -1.0), dim=1)
    py, px = pick // W, pick % W
    y_off = torch.randint(0, ch, (B,), generator=generator, device=dev)
    x_off = torch.randint(0, cw, (B,), generator=generator, device=dev)
    fall = torch.randint(0, max(H - ch, 1), (B, 2), generator=generator, device=dev)
    has_fg = fg.any(dim=1)
    y0 = torch.clamp(py - y_off, 0, max(H - ch, 0))
    x0 = torch.clamp(px - x_off, 0, max(W - cw, 0))
    y0 = torch.where(has_fg, y0, torch.clamp(fall[:, 0], 0, max(H - ch, 0)))
    x0 = torch.where(has_fg, x0, torch.clamp(fall[:, 1], 0, max(W - cw, 0)))
    return y0, x0


def draw_train(labs: torch.Tensor, generator: Optional[torch.Generator],
               crop_hw: Tuple[int, int]) -> TrainDraws:
    """Every draw of the train chain for the batch, in a fixed order (crop,
    flips, RGB, HSV, contrast, brightness), on ``labs``' device."""
    y0, x0 = crop_origin(labs, generator, crop_hw)
    return TrainDraws(y0, x0, *draw_flips_colour(labs.shape[0], generator, labs.device))


def draw_flips_colour(B: int, generator: Optional[torch.Generator], dev):
    """The draws after the crop, shared with Task 2's chain: ``(flip_h,
    flip_v, rgb, hsv, contrast, brightness)`` for B samples, in that order."""
    flips = torch.rand((B, 2), generator=generator, device=dev) < 0.5
    rgb = _uniform((B, 3), -RGB_LIMIT, RGB_LIMIT, generator, dev)
    u = torch.rand((B, 3), generator=generator, device=dev) * 2 - 1
    hsv = torch.stack([u[:, 0] * HUE_LIMIT, u[:, 1] * SAT_LIMIT, u[:, 2] * VAL_LIMIT], dim=1)
    contrast = 1.0 + _uniform((B,), -CONTRAST_LIMIT, CONTRAST_LIMIT, generator, dev)
    brightness = 1.0 + _uniform((B,), -BRIGHTNESS_LIMIT, BRIGHTNESS_LIMIT, generator, dev)
    return flips[:, 0], flips[:, 1], rgb, hsv, contrast, brightness


# ---------------------------------------------------------------------------
# colour ops (f32 images in [0, 1], channels last)
# ---------------------------------------------------------------------------

def _rgb_to_hsv(rgb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r, g, b = rgb.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    diff = maxc - minc
    s = torch.where(maxc > 0, diff / torch.clamp(maxc, min=1e-12), 0.0)
    diff_safe = torch.clamp(diff, min=1e-12)
    rc = (maxc - r) / diff_safe
    gc = (maxc - g) / diff_safe
    bc = (maxc - b) / diff_safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(diff > 0, torch.remainder(h / 6.0, 1.0), 0.0)  # floor-mod, jnp's %
    return h, s, v


def _select(i: torch.Tensor, choices: Sequence[torch.Tensor]) -> torch.Tensor:
    """``jnp.select([i == 0, ..., i == 5], choices)``: the first true wins."""
    out = torch.zeros_like(choices[0])
    for k in reversed(range(len(choices))):
        out = torch.where(i == k, choices[k], out)
    return out


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    r = _select(i, [v, q, p, p, t, v])
    g = _select(i, [t, v, v, q, p, p])
    b = _select(i, [p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-1)


def hue_saturation_value(img: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] f32, shifts [B, 3] (hue, saturation, value)."""
    h, s, v = _rgb_to_hsv(torch.clamp(img, 0.0, 1.0))
    sh = shifts[:, None, None, :]
    h = torch.remainder(h + sh[..., 0], 1.0)
    s = torch.clamp(s + sh[..., 1], 0, 1)
    v = torch.clamp(v + sh[..., 2], 0, 1)
    return _hsv_to_rgb(h, s, v)


# ---------------------------------------------------------------------------
# batch pipelines
# ---------------------------------------------------------------------------

def _crop_index(params: TrainDraws, crop_hw: Tuple[int, int], dev):
    """The gather indices of the crop with both flips folded in: (batch,
    rows, cols), broadcasting to [B, ch, cw]."""
    ch, cw = crop_hw
    dy = torch.arange(ch, device=dev)
    dx = torch.arange(cw, device=dev)
    rows = params.y0[:, None] + torch.where(params.flip_v[:, None], ch - 1 - dy, dy)
    cols = params.x0[:, None] + torch.where(params.flip_h[:, None], cw - 1 - dx, dx)
    bi = torch.arange(rows.shape[0], device=dev)[:, None, None]
    return bi, rows[:, :, None], cols[:, None, :]


def apply_train(imgs_u8: torch.Tensor, labs_u8: torch.Tensor, params: TrainDraws,
                crop_hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W, 3] uint8, [B, H, W] uint8 -> ([B, ch, cw, 3] f32 in [0, 1],
    [B, ch, cw] int64): the crop (flips folded into its gather), then the
    RGB shift, HSV shift, contrast and brightness, then the clip."""
    idx = _crop_index(params, crop_hw, imgs_u8.device)
    img = imgs_u8[idx].float() / 255.0
    return colour_chain(img, params), crop_labels(labs_u8, params, crop_hw)


def crop_labels(labs_u8: torch.Tensor, params: TrainDraws,
                crop_hw: Tuple[int, int]) -> torch.Tensor:
    """The labels of :func:`apply_train` alone: [B, H, W] uint8 -> [B, ch,
    cw] int64 (what a data-parallel rank forms for the whole batch, the
    images only for its rows)."""
    return labs_u8[_crop_index(params, crop_hw, labs_u8.device)].long()


def colour_chain(img: torch.Tensor, params) -> torch.Tensor:
    """The RGB shift, HSV shift, contrast and brightness of [B, H, W, 3] f32
    images at ``params``' draws (``rgb``, ``hsv``, ``contrast``,
    ``brightness``), then the clip to [0, 1]; shared with Task 2's chain."""
    img = img + params.rgb[:, None, None, :]
    img = hue_saturation_value(img, params.hsv)
    mean = torch.mean(img, dim=(1, 2, 3), keepdim=True)
    img = (img - mean) * params.contrast[:, None, None, None] + mean
    img = img * params.brightness[:, None, None, None]
    return torch.clamp(img, 0.0, 1.0)


def val_generator(epoch: int) -> torch.Generator:
    """The CPU generator of an epoch's val flips, seeded from (777, epoch)."""
    seed = int(np.random.SeedSequence([777, epoch]).generate_state(1)[0])
    return torch.Generator().manual_seed(seed)


def draw_val(n: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """The VFlip(0.5) draw of each of ``n`` scans, [n] bool on the
    generator's device."""
    dev = generator.device if generator is not None else None
    return torch.rand((n,), generator=generator, device=dev) < 0.5


def apply_val(imgs_u8: torch.Tensor, labs_u8: torch.Tensor, flip_v: torch.Tensor,
              stochastic: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W, 3] uint8, [B, H, W] uint8 -> (f32 in [0, 1], int64); with
    ``stochastic`` the reference's HFlip(p=1), then VFlip where ``flip_v``."""
    img = imgs_u8.float() / 255.0
    lab = labs_u8.long()
    if stochastic:
        img, lab = img.flip(2), lab.flip(2)
        img = torch.where(flip_v[:, None, None, None], img.flip(1), img)
        lab = torch.where(flip_v[:, None, None], lab.flip(1), lab)
    return torch.clamp(img, 0.0, 1.0), lab
