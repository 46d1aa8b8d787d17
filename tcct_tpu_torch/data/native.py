"""ctypes binding of the native data plane, ``csrc/oct_loader.cpp`` (JAX
counterpart ``tcct_tpu/data/native.py``, same signatures): a PNG decoder
and a threaded batch load with the geometry prep (crop band, pad or
nearest resize, label ``// divide``) into caller-owned uint8 arrays.

The library is built from the checkout's source with ``g++ ... -lz
-lpthread`` at its first use in a process, into ``build/tcct_tpu_torch/``
(written under a temporary name and renamed, so processes building at once
do not clash).  Nothing is written into ``csrc/``, and the library
committed there is not loaded.  Where the build fails,
:class:`NativeLoaderError` names the missing compiler or zlib.  Decoded
images are in cv2's BGR channel order, as ``cv2.imread`` returns them.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "csrc", "oct_loader.cpp")
LIBRARY = os.path.join(_REPO, "build", "tcct_tpu_torch", "liboct_loader.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None

_U8P = ctypes.POINTER(ctypes.c_uint8)


class NativeLoaderError(RuntimeError):
    """The native loader could not be built or loaded."""


def _build() -> None:
    if os.path.exists(LIBRARY) and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE):
        return
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeLoaderError("the native PNG loader needs a C++ compiler: g++ not found")
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = [cxx, "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, SOURCE, "-lz", "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        out = proc.stderr + proc.stdout
        if "zlib.h" in out or "-lz" in out:
            raise NativeLoaderError(f"the native PNG loader needs zlib (zlib.h and -lz): {out}")
        raise NativeLoaderError(f"g++ failed to build {SOURCE}: {out}")
    os.replace(tmp, LIBRARY)


def _get() -> ctypes.CDLL:
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise NativeLoaderError(_error)
        try:
            _build()
            lib = ctypes.CDLL(LIBRARY)
        except (NativeLoaderError, OSError) as e:
            _error = str(e)
            raise NativeLoaderError(_error) from e
        lib.oct_png_info.argtypes = [ctypes.c_char_p] + [ctypes.POINTER(ctypes.c_int)] * 3
        lib.oct_png_info.restype = ctypes.c_int
        lib.oct_decode_png.argtypes = [ctypes.c_char_p, _U8P, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int]
        lib.oct_decode_png.restype = ctypes.c_int
        lib.oct_load_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                       ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _U8P, _U8P,
                                       *[ctypes.c_int] * 8]
        lib.oct_load_batch.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    """Whether the loader builds and loads here."""
    try:
        _get()
        return True
    except NativeLoaderError:
        return False


def png_info(path: str) -> Tuple[int, int, int]:
    """(height, width, channels) of a PNG file."""
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if _get().oct_png_info(path.encode(), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c)):
        raise ValueError(f"failed to read PNG {path}")
    return h.value, w.value, c.value


def decode_png(path: str, channels: int = 3) -> np.ndarray:
    """[H, W, 3] BGR (``channels=3``) or [H, W] grey (cv2's luma) uint8."""
    h, w, _ = png_info(path)
    out = np.empty((h, w, channels) if channels == 3 else (h, w), np.uint8)
    rc = _get().oct_decode_png(path.encode(), out.ctypes.data_as(_U8P), h, w, channels)
    if rc:
        raise ValueError(f"failed to decode PNG {path} (rc={rc})")
    return out


def load_batch(
    img_paths: Sequence[str],
    lab_paths: Optional[Sequence[Optional[str]]],
    hw: Tuple[int, int],
    height_stt: int = 0,
    height_end: int = 1 << 30,
    prep_mode: str = "pad",
    prep_reflect: bool = False,
    divide: int = 30,
    n_threads: int = 0,
    out: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Decode and geometry-prep a batch in native threads.  Returns (imgs
    [n, H, W, 3] u8, labs [n, H, W] u8, n_ok); a file that fails to decode
    leaves its slot zero and is not counted in n_ok.  ``out``: C-contiguous
    uint8 arrays of at least n rows to fill (pinned host memory, say); the
    first n rows are returned."""
    n = len(img_paths)
    H, W = hw
    if out is None:
        imgs = np.zeros((n, H, W, 3), np.uint8)
        labs = np.zeros((n, H, W), np.uint8)
    else:
        imgs, labs = out[0][:n], out[1][:n]
        if (imgs.dtype != np.uint8 or labs.dtype != np.uint8 or imgs.shape != (n, H, W, 3)
                or labs.shape != (n, H, W) or not imgs.flags.c_contiguous
                or not labs.flags.c_contiguous):
            raise ValueError(f"out: need C-contiguous uint8 arrays of [{n}, {H}, {W}, 3] and "
                             f"[{n}, {H}, {W}], got {imgs.shape} {imgs.dtype}, {labs.shape} "
                             f"{labs.dtype}")
    lib = _get()
    arr = ctypes.c_char_p * n
    c_imgs = arr(*[p.encode() for p in img_paths])
    c_labs = arr(*[(p or "").encode() for p in (lab_paths or [""] * n)])
    n_ok = lib.oct_load_batch(c_imgs, c_labs, n, imgs.ctypes.data_as(_U8P),
                              labs.ctypes.data_as(_U8P), H, W, height_stt, height_end,
                              1 if prep_mode == "resize" else 0, 1 if prep_reflect else 0,
                              divide, n_threads)
    return imgs, labs, n_ok
