"""Task-2 dataset and augmentation (JAX counterpart
``tcct_tpu/task2/data.py``; reference task2/t2_train.py:65-124): the GOALS
fundus-OCT classification PNGs and their xlsx labels, or label-correlated
synthetic images.

Host decode and prep happen once, without cv2: the native loader decodes a
PNG in cv2's BGR order (``data/native.py``), the image is zero-padded to
1120x1120 about its centre and resized to ``img_size`` as
``cv2.resize(..., INTER_LINEAR)`` does on uint8 (:func:`resize_linear_u8`).
Labels come from ``Train_GC_GT.xlsx`` through the standard library
(``zipfile`` and ``xml.etree``; JAX reads it with pandas).  Oversampling
x20 (t2_train.py:123) is an epoch-length multiplier.

The train augmentation (RandomResizedCrop 0.6-1.5, flips, colour jitter;
t2_train.py:65-73) runs on the device, split as ``data/augment.py`` splits
Task 1's: :func:`draw_cls_train` draws every per-sample parameter at fixed
shapes, :func:`apply_cls_train` applies them.  Nothing reads a device
value on the host.
"""

from __future__ import annotations

import dataclasses
import os
import posixpath
import re
import zipfile
from typing import Dict, List, Optional
from xml.etree import ElementTree

import numpy as np
import torch

from tcct_tpu_torch.data import native
from tcct_tpu_torch.data.augment import colour_chain, draw_flips_colour

PAD_TO = 1120  # t2_train.py:86-90
SCALE = (0.6, 1.5)  # the crop's scale range


# ---------------------------------------------------------------------------
# labels: the first sheet of an xlsx workbook, read with the standard library
# ---------------------------------------------------------------------------

_M = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
_R = "{http://schemas.openxmlformats.org/officeDocument/2006/relationships}"


def _column(ref: str) -> int:
    """Zero-based column of a cell reference (``"B12"`` -> 1)."""
    n = 0
    for ch in re.match(r"[A-Z]+", ref).group(0):
        n = n * 26 + ord(ch) - ord("A") + 1
    return n - 1


def _xlsx_rows(path: str) -> List[Dict[int, str]]:
    """The cells of the workbook's first sheet as text, a dict of column ->
    value per row, in row order (shared, inline and number cells)."""
    with zipfile.ZipFile(path) as z:
        sheets = ElementTree.fromstring(z.read("xl/workbook.xml")).find(f"{_M}sheets")
        rid = sheets[0].get(f"{_R}id")
        rels = ElementTree.fromstring(z.read("xl/_rels/workbook.xml.rels"))
        target = next(r.get("Target") for r in rels if r.get("Id") == rid)
        sheet_path = (target.lstrip("/") if target.startswith("/")
                      else posixpath.normpath(posixpath.join("xl", target)))
        shared = []
        if "xl/sharedStrings.xml" in z.namelist():
            for si in ElementTree.fromstring(z.read("xl/sharedStrings.xml")).iter(f"{_M}si"):
                shared.append("".join(t.text or "" for t in si.iter(f"{_M}t")))
        sheet = ElementTree.fromstring(z.read(sheet_path))
    rows = []
    for row in sheet.iter(f"{_M}row"):
        cells = {}
        for c in row.iter(f"{_M}c"):
            kind, v = c.get("t"), c.find(f"{_M}v")
            if kind == "s":
                cells[_column(c.get("r"))] = shared[int(v.text)]
            elif kind == "inlineStr":
                cells[_column(c.get("r"))] = "".join(t.text or "" for t in c.iter(f"{_M}t"))
            elif v is not None and v.text is not None:
                cells[_column(c.get("r"))] = v.text
        rows.append(cells)
    return rows


def _number(text: str):
    """A cell's value as pandas reads it: an integral number as int."""
    try:
        f = float(text)
    except ValueError:
        return text
    return int(f) if f.is_integer() else f


def load_labels(label_file: str) -> Dict[str, int]:
    """``{image number: label}`` from the first two columns of the first
    sheet, the header row skipped; the key rule of the JAX package
    (``str(int(str(name).split(".")[0]))``: ``"0001.png"``, ``1`` and
    ``1.0`` all give ``"1"``)."""
    rows = _xlsx_rows(label_file)
    if not rows:
        return {}
    cols = sorted(rows[0])[:2]
    out = {}
    for cells in rows[1:]:
        if not all(c in cells for c in cols):
            continue
        name, label = (_number(cells[c]) for c in cols)
        out[str(int(str(name).split(".")[0]))] = int(label)
    return out


def write_labels_xlsx(path: str, rows, header=("ImgName", "GC_Label")) -> None:
    """A minimal xlsx workbook of one sheet, ``header`` then ``rows`` (ints
    as number cells, anything else as shared strings), with the standard
    library: the inverse of :func:`load_labels`, for synthetic folders."""
    strings: List[str] = []

    def cell(ref: str, v) -> str:
        if isinstance(v, (int, np.integer)):
            return f'<c r="{ref}"><v>{int(v)}</v></c>'
        strings.append(str(v))
        return f'<c r="{ref}" t="s"><v>{len(strings) - 1}</v></c>'

    body = "".join(
        f'<row r="{i + 1}">' + "".join(cell(f"{chr(65 + j)}{i + 1}", v) for j, v in enumerate(r))
        + "</row>" for i, r in enumerate([header, *rows]))
    main = 'xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main"'
    rel = "http://schemas.openxmlformats.org/officeDocument/2006/relationships"
    pkg = "http://schemas.openxmlformats.org/package/2006/relationships"
    sst = "".join(f"<si><t>{t}</t></si>" for t in strings)
    ct = "application/vnd.openxmlformats-officedocument.spreadsheetml"
    files = {
        "[Content_Types].xml":
            '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
            '<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.'
            'relationships+xml"/><Default Extension="xml" ContentType="application/xml"/>'
            f'<Override PartName="/xl/workbook.xml" ContentType="{ct}.sheet.main+xml"/>'
            f'<Override PartName="/xl/worksheets/sheet1.xml" ContentType="{ct}.worksheet+xml"/>'
            f'<Override PartName="/xl/sharedStrings.xml" ContentType="{ct}.sharedStrings+xml"/>'
            "</Types>",
        "_rels/.rels":
            f'<Relationships xmlns="{pkg}"><Relationship Id="rId1" Type="{rel}/officeDocument" '
            'Target="xl/workbook.xml"/></Relationships>',
        "xl/workbook.xml":
            f'<workbook {main} xmlns:r="{rel}"><sheets><sheet name="Sheet1" sheetId="1" '
            'r:id="rId1"/></sheets></workbook>',
        "xl/_rels/workbook.xml.rels":
            f'<Relationships xmlns="{pkg}"><Relationship Id="rId1" Type="{rel}/worksheet" '
            f'Target="worksheets/sheet1.xml"/><Relationship Id="rId2" Type="{rel}/sharedStrings" '
            'Target="sharedStrings.xml"/></Relationships>',
        "xl/worksheets/sheet1.xml": f"<worksheet {main}><sheetData>{body}</sheetData></worksheet>",
        "xl/sharedStrings.xml": f'<sst {main} count="{len(strings)}">{sst}</sst>',
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        for name, text in files.items():
            z.writestr(name, '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>\n' + text)


# ---------------------------------------------------------------------------
# image prep: pad to 1120^2, cv2's INTER_LINEAR resize on uint8
# ---------------------------------------------------------------------------

def _taps(src: int, dst: int):
    """cv2's source index and f32 fraction of each output index: ``f =
    float((d + 0.5) * scale - 0.5)`` in double, ``s = floor(f)``."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, f - s.astype(np.float32)


def _coef(frac: np.ndarray):
    """The 11-bit fixed-point pair ``(1 - f, f)``, each rounded to nearest
    even as ``saturate_cast<short>(v * 2048)``."""
    return (np.round((np.float32(1) - frac) * np.float32(2048)).astype(np.int64),
            np.round(frac * np.float32(2048)).astype(np.int64))


def resize_linear_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=INTER_LINEAR)`` of an
    [H, W, C] uint8 image, bit for bit.  cv2 works in fixed point: each
    output column is ``S[x0] * a0 + S[x1] * a1`` with 11-bit coefficients
    (a column left of 0 or right of W-1 clamps to the edge with weight
    2048), each output row combines two such rows, clamped into the image,
    with 11-bit ``b0, b1`` as cv2's vector path does:
    ``((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16)``, then a rounded
    shift by 2 and a saturation to [0, 255] (a rounded 22-bit shift in all;
    the scalar formula differs by one grey level now and then, and cv2
    takes the vector one)."""
    H, W = img.shape[:2]
    sx, fx = _taps(W, out_w)
    edge = (sx < 0) | (sx >= W - 1)
    fx[edge] = 0.0
    sx = np.clip(sx, 0, W - 1)
    ax0, ax1 = _coef(fx)
    sy, fy = _taps(H, out_h)
    by0, by1 = _coef(fy)
    s = img.astype(np.int64)
    rows = (s[:, sx] * ax0[None, :, None] + s[:, np.minimum(sx + 1, W - 1)] * ax1[None, :, None])
    r0 = rows[np.clip(sy, 0, H - 1)] >> 4
    r1 = rows[np.clip(sy + 1, 0, H - 1)] >> 4
    v = ((r0 * by0[:, None, None]) >> 16) + ((r1 * by1[:, None, None]) >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)


def prep_image(path: str, img_size: int) -> np.ndarray:
    """A GOALS PNG as [img_size, img_size, 3] uint8 BGR: decoded, zero-padded
    about its centre to at least 1120 on each side, resized as cv2 does
    (JAX ``_prep_image``)."""
    img = native.decode_png(path, channels=3)
    h, w = img.shape[:2]
    ph, pw = max(PAD_TO - h, 0), max(PAD_TO - w, 0)
    img = np.pad(img, ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2), (0, 0)))
    return resize_linear_u8(img, img_size, img_size)


def synthesize_cls(n: int, img_size: int = 224, seed: int = 0):
    """Label-correlated synthetic fundus images (cup/disc-like blobs whose
    size follows the glaucoma label), the JAX package's numpy code: the
    same arrays byte for byte."""
    rng = np.random.default_rng(seed)
    imgs = np.zeros((n, img_size, img_size, 3), np.uint8)
    labels = rng.integers(0, 2, size=(n,)).astype(np.int32)
    yy, xx = np.mgrid[0:img_size, 0:img_size]
    for i in range(n):
        cy, cx = rng.uniform(0.3, 0.7, 2) * img_size
        r_disc = img_size * rng.uniform(0.12, 0.18)
        r_cup = r_disc * (0.75 if labels[i] else 0.4) * rng.uniform(0.9, 1.1)
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        img = rng.normal(90, 12, (img_size, img_size))
        img[d < r_disc] += 70
        img[d < r_cup] += 60
        imgs[i] = np.clip(img, 0, 255).astype(np.uint8)[..., None].repeat(3, -1)
    return imgs, labels


@dataclasses.dataclass
class GoalClsSet:
    imgs: np.ndarray  # [N, S, S, 3] uint8
    labels: np.ndarray  # [N] int32 (9: unlabelled, or inference)
    names: List[str]
    synthetic: bool = False
    oversample: int = 20  # t2_train.py:123

    @classmethod
    def load(cls, dataset_root: str = "", label_file: str = "", img_size: int = 224,
             synthetic_n: int = 40, seed: int = 0) -> "GoalClsSet":
        """The PNGs of ``dataset_root`` (sorted by name) with the labels of
        ``label_file`` (9 where it has none, or without one), or, without a
        folder, ``synthetic_n`` synthetic images.  A folder needs the native
        loader: where it cannot be built the call raises, with no
        synthetic fallback."""
        if dataset_root and os.path.isdir(dataset_root):
            files = sorted(f for f in os.listdir(dataset_root) if f.endswith(".png"))
            labels_map = load_labels(label_file) if label_file else {}
            imgs = [prep_image(os.path.join(dataset_root, f), img_size) for f in files]
            labels = [labels_map.get(str(int(f.split(".")[0])), 9) for f in files]
            return cls(np.stack(imgs), np.asarray(labels, np.int32), files)
        imgs, labels = synthesize_cls(synthetic_n, img_size, seed)
        names = [f"{i:04d}.png" for i in range(len(imgs))]
        return cls(imgs, labels, names, synthetic=True)


# ---------------------------------------------------------------------------
# train augmentation on the device (t2_train.py:65-73)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ClsDraws:
    """Per-sample parameters of the train chain, [B] or [B, 3] tensors."""

    scale: torch.Tensor  # f32, U(0.6, 1.5): the crop's side over the image's
    y0: torch.Tensor  # f32 U(0, 1): the crop's origin as a share of its slack
    x0: torch.Tensor
    flip_h: torch.Tensor  # bool
    flip_v: torch.Tensor
    rgb: torch.Tensor  # [B, 3] f32
    hsv: torch.Tensor  # [B, 3] f32
    contrast: torch.Tensor  # f32 factors
    brightness: torch.Tensor


def draw_cls_train(batch: int, generator: Optional[torch.Generator], device) -> ClsDraws:
    """Every draw of the train chain for ``batch`` images, in a fixed order
    (scale, origin, flips, RGB, HSV, contrast, brightness) and at fixed
    shapes: the generator advances alike whatever the images hold."""
    scale = torch.rand((batch,), generator=generator, device=device) * (SCALE[1] - SCALE[0])
    scale = scale + SCALE[0]
    origin = torch.rand((batch, 2), generator=generator, device=device)
    flip_h, flip_v, rgb, hsv, contrast, brightness = draw_flips_colour(batch, generator, device)
    return ClsDraws(scale, origin[:, 0], origin[:, 1], flip_h, flip_v, rgb, hsv, contrast,
                    brightness)


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as a true division on any device (CUDA divides by a Python
    number through its reciprocal), as JAX divides."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def resized_crop(img: torch.Tensor, draws: ClsDraws) -> torch.Tensor:
    """The JAX package's ``_random_resized_crop`` of an [B, S, S, C] f32
    batch: a window of side ``crop = clip(S * scale, 16, 2S)`` from
    ``origin * max(S - crop, 0)``, resampled bilinearly to S x S with each
    source index clipped to [0, S - 1].  So where scale > 1 the window
    starts at 0 and its part past the image repeats the last row and
    column (the image sits top-left), as JAX's code does (its docstring
    says it pads)."""
    B, S = img.shape[0], img.shape[1]
    dev = img.device
    crop = torch.clamp(S * draws.scale, 16, 2 * S)
    slack = torch.clamp(S - crop, min=0.0)
    pos = true_div(torch.arange(S, dtype=torch.float32, device=dev), S - 1)

    def taps(origin):
        v = torch.clamp(origin[:, None] * slack[:, None] + pos[None] * (crop[:, None] - 1),
                        0, S - 1)
        lo = torch.floor(v).long()
        return lo, torch.clamp(lo + 1, max=S - 1), v - lo.float()

    y_lo, y_hi, wy = taps(draws.y0)
    x_lo, x_hi, wx = taps(draws.x0)
    bi = torch.arange(B, device=dev)[:, None, None]
    wy, wx = wy[:, :, None, None], wx[:, None, :, None]

    def g(rows, cols):
        return img[bi, rows[:, :, None], cols[:, None, :]]

    return (g(y_lo, x_lo) * (1 - wy) * (1 - wx) + g(y_lo, x_hi) * (1 - wy) * wx
            + g(y_hi, x_lo) * wy * (1 - wx) + g(y_hi, x_hi) * wy * wx)


def apply_cls_train(imgs_u8: torch.Tensor, draws: ClsDraws, img_size: int) -> torch.Tensor:
    """[B, S, S, 3] uint8 (S = ``img_size``) -> [B, S, S, 3] f32 in [0, 1]:
    ``/ 255``, the resized crop, the flips (W, then H), then the RGB shift,
    HSV shift, contrast and brightness, then the clip (JAX ``_train_one``)."""
    if tuple(imgs_u8.shape[1:3]) != (img_size, img_size):
        raise ValueError(f"want [B, {img_size}, {img_size}, 3] images, got "
                         f"{tuple(imgs_u8.shape)}")
    img = resized_crop(true_div(imgs_u8.float(), 255.0), draws)
    img = torch.where(draws.flip_h[:, None, None, None], img.flip(2), img)
    img = torch.where(draws.flip_v[:, None, None, None], img.flip(1), img)
    return colour_chain(img, draws)
