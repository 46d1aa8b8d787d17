"""The dataset (JAX counterpart ``tcct_tpu/data/eyeset.py``): host-side
decode and geometry prep, once at load time, into uint8 stacks that the
engine keeps on the device; augmentation runs on the device in the train
step (``data/augment.py``).

prep: crop the dataset's height band, then either pad to the static
working shape (centred; constant zeros, or edge-including symmetric
reflection for duke2) or resize to it with nearest-neighbour sampling
(reference task1/data/octnpy.py:58-129).  postprocess inverts it back to
the native resolution.

The directory layout is the reference's: ``<root>/<db>/{train,val,test}_
{img,lab}/`` (optionally nested one level); labels decode as ``gray //
divide``.  PNG folders are decoded by the native loader
(``data/native.py``; this package has no cv2).  Without a dataset folder
a deterministic synthetic layered-OCT set stands in, the JAX package's own
numpy generator, so its splits are the JAX package's byte for byte.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from tcct_tpu_torch.data.geometry import DatasetGeometry, get_geometry


def _nearest_idx(in_size: int, out_size: int) -> np.ndarray:
    # nearest: src = floor(i * in / out)
    i = np.arange(out_size, dtype=np.float64)
    return np.minimum((i * in_size / out_size).astype(np.int64), in_size - 1)


def resize_nearest(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize of an [H, W, ...] array to ``hw``."""
    return img[_nearest_idx(img.shape[0], hw[0])][:, _nearest_idx(img.shape[1], hw[1])]


def prep(geo: DatasetGeometry, img: np.ndarray,
         lab: Optional[np.ndarray] = None) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Crop band + pad/resize a native B-scan ([H, W, 3] uint8) and its
    optional label map to the geometry's working shape."""
    img = img[geo.height_stt: geo.height_end]
    if lab is not None:
        lab = lab[geo.height_stt: geo.height_end]
    H, W = geo.prep_hw
    if geo.prep_mode == "resize":
        img = resize_nearest(img, (H, W))
        if lab is not None:
            lab = resize_nearest(lab, (H, W))
        return img, lab
    h, w = img.shape[:2]
    ph, pw = max(H - h, 0), max(W - w, 0)
    top, left = ph // 2, pw // 2
    mode = "symmetric" if geo.prep_reflect else "constant"
    img = np.pad(img, ((top, ph - top), (left, pw - left), (0, 0)), mode=mode)[:H, :W]
    if lab is not None:
        lab = np.pad(lab, ((top, ph - top), (left, pw - left)), mode=mode)[:H, :W]
    return img, lab


def postprocess(geo: DatasetGeometry, seg: np.ndarray, native_hw: Tuple[int, int]) -> np.ndarray:
    """Inverse of :func:`prep` for a working-resolution class map."""
    H, W = native_hw
    out = np.zeros((H, W), seg.dtype)
    band = seg
    if geo.post_hw is not None:
        band = resize_nearest(seg.astype(np.uint8), geo.post_hw)
    else:
        # centre-crop back (pad datasets)
        bh = min(geo.height_end - geo.height_stt, H) if geo.height_end < 9999 else H
        h, w = band.shape
        y0 = max((h - bh) // 2, 0)
        x0 = max((w - W) // 2, 0)
        band = band[y0: y0 + bh, x0: x0 + W]
    bh, bw = band.shape
    he = min(geo.height_stt + bh, H)
    out[geo.height_stt: he, : min(bw, W)] = band[: he - geo.height_stt, :W]
    return out


def _glob_pair(folder: str, sub: str) -> List[str]:
    return sorted(
        glob.glob(os.path.join(folder, sub, "*", "*.*"))
        + glob.glob(os.path.join(folder, sub, "*.*"))
    )


def synthesize_oct(geo: DatasetGeometry, n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic synthetic layered B-scans, the JAX package's generator
    line for line: smooth ordered layer boundaries, a grey level per layer
    plus speckle noise, at the geometry's working shape and class count."""
    rng = np.random.default_rng(seed)
    H, W = geo.prep_hw
    nc = geo.out_channels
    imgs = np.zeros((n, H, W, 3), np.uint8)
    labs = np.zeros((n, H, W), np.uint8)
    yy = np.arange(H)[:, None]
    for i in range(n):
        # nc-1 ordered smooth boundaries in a central band
        base = np.sort(rng.uniform(0.2 * H, 0.8 * H, size=(nc - 1,)))
        freq = rng.uniform(0.5, 2.0, size=(nc - 1, 1))
        phase = rng.uniform(0, 2 * np.pi, size=(nc - 1, 1))
        amp = rng.uniform(2, max(H * 0.03, 2.1), size=(nc - 1, 1))
        xs = np.linspace(0, 2 * np.pi, W)[None, :]
        bounds = base[:, None] + amp * np.sin(freq * xs + phase)
        bounds = np.sort(bounds, axis=0)  # keep layers ordered
        # class = number of boundaries above y (0..nc-1); the region below
        # the last boundary maps back to background
        cnt = (yy[None] >= bounds[:, None, :]).sum(0)
        lab = np.where(cnt == nc - 1, 0, cnt).astype(np.uint8)
        intens = rng.uniform(40, 220, size=(nc,))
        img = intens[lab]
        img = img + rng.normal(0, 18, size=(H, W))  # speckle
        img = np.clip(img, 0, 255).astype(np.uint8)
        imgs[i] = img[..., None].repeat(3, axis=-1)
        labs[i] = lab
    return imgs, labs


@dataclasses.dataclass
class EyeSet:
    """A loaded, geometry-prepped dataset: uint8 stacks per split."""

    name: str
    geo: DatasetGeometry
    splits: Dict[str, Tuple[np.ndarray, np.ndarray]]  # split -> (imgs, labs)
    paths: Dict[str, List[str]]
    synthetic: bool = False
    # (img_path, lab_path or None) as resolved at load time; the streaming
    # pipeline reads these
    pairs: Dict[str, List[Tuple[str, Optional[str]]]] = dataclasses.field(default_factory=dict)

    @property
    def out_channels(self) -> int:
        return self.geo.out_channels

    @property
    def oversample(self) -> int:
        """exeNums['train'] = max(1, 735 // n_train) (octgen.py:64)."""
        n = len(self.splits["train"][0])
        return max(1, self.geo.oversample_target // max(n, 1))

    def epoch_length(self, split: str = "train") -> int:
        n = len(self.splits[split][0])
        return n * (self.oversample if split == "train" else 1)

    def sample_indices(self, rng: np.random.Generator, bs: int) -> np.ndarray:
        return rng.integers(0, len(self.splits["train"][0]), size=(bs,))

    @classmethod
    def load(cls, dbname: str, root: Optional[str] = None, synthetic_n: int = 24,
             synthetic_seed: int = 0) -> "EyeSet":
        """The dataset ``dbname`` from ``<root>/<dbname>`` (``root`` or
        ``$TCCT_DATA_ROOT``), decoded by the native loader, which raises
        :class:`~tcct_tpu_torch.data.native.NativeLoaderError` if it cannot
        be built.  Without such a folder, or without train images in it: the
        synthetic set, ``TCCT_SYNTH_N`` scans (else ``synthetic_n``) at
        ``TCCT_SYNTH_HW`` ("96x128"; else the geometry's shape)."""
        geo = get_geometry(dbname)
        root = root or os.environ.get("TCCT_DATA_ROOT", "")
        folder = os.path.join(root, dbname) if root else ""
        if folder and os.path.isdir(folder):
            from tcct_tpu_torch.data import native

            splits: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
            paths: Dict[str, List[str]] = {}
            pairs: Dict[str, List[Tuple[str, Optional[str]]]] = {}
            train_imgs = _glob_pair(folder, "train_img")
            val_imgs = _glob_pair(folder, "val_img") or list(train_imgs)
            test_imgs = _glob_pair(folder, "test_img")
            for split, img_paths, img_key, lab_key in [
                ("train", train_imgs, "train_img", "train_lab"),
                ("val", val_imgs, "val_img", "val_lab"),
                ("test", test_imgs, "test_img", "test_lab"),
            ]:
                ims, lbs = [], []
                split_pairs: List[Tuple[str, Optional[str]]] = []
                for p in img_paths:
                    lp = p.replace(img_key, lab_key).replace("train_img", "train_lab")
                    try:
                        img = native.decode_png(p, channels=3)
                    except ValueError as e:
                        raise IOError(f"unreadable image file in {split} split: {p}") from e
                    has_lab = os.path.exists(lp)
                    lab = (native.decode_png(lp, channels=1) if has_lab
                           else np.zeros(img.shape[:2], np.uint8))
                    img, lab = prep(geo, img, lab // geo.divide)
                    ims.append(img)
                    lbs.append(lab)
                    split_pairs.append((p, lp if has_lab else None))
                if ims:
                    splits[split] = (np.stack(ims), np.stack(lbs))
                    paths[split] = img_paths
                    pairs[split] = split_pairs
            if "train" in splits:
                splits.setdefault("val", splits["train"])
                splits.setdefault("test", splits["val"])
                return cls(dbname, geo, splits, paths, pairs=pairs)
        synthetic_n = int(os.environ.get("TCCT_SYNTH_N", synthetic_n))
        hw_env = os.environ.get("TCCT_SYNTH_HW", "")
        if hw_env:
            h, w = (int(v) for v in hw_env.lower().split("x"))
            geo = dataclasses.replace(geo, prep_hw=(h, w))
        tr = synthesize_oct(geo, synthetic_n, seed=synthetic_seed)
        va = synthesize_oct(geo, max(synthetic_n // 3, 2), seed=synthetic_seed + 1)
        te = synthesize_oct(geo, max(synthetic_n // 3, 2), seed=synthetic_seed + 2)
        return cls(dbname, geo, {"train": tr, "val": va, "test": te},
                   {"train": [], "val": [], "test": []}, synthetic=True)

    def postprocess(self, seg: np.ndarray, native_hw: Tuple[int, int]) -> np.ndarray:
        """Inverse of the prep: a working-resolution class map back to the
        native resolution (reference octnpy.py:95-112)."""
        return postprocess(self.geo, seg, native_hw)
