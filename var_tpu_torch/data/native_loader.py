"""ctypes bindings for the native C++ image pipeline ``native/varloader.cc``
(counterpart of ``var_tpu/data/native_loader.py``).

The shared library is built from the repository's source with ``g++``
(``-ljpeg -lpng``) at first use, into this package's own ``_build/``
directory. When it cannot be built, a line says so and the callers use the
Python/PIL transform of ``imagenet.make_transform`` instead, as the JAX
package does.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native", "varloader.cc")
_LIB_DIR = os.path.join(_HERE, "_build")
_LIB = os.path.join(_LIB_DIR, "libvarloader.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> str:
    os.makedirs(_LIB_DIR, exist_ok=True)
    if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
        # a per-process temporary name: concurrent builds each swap in a
        # whole library, never a half-written one
        tmp = f"{_LIB}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
               "-ljpeg", "-lpng", "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB)
    return _LIB


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(_build())
            except (OSError, subprocess.CalledProcessError) as e:
                print(f"[native_loader] build unavailable ({e}); using PIL fallback")
                _lib = False  # sentinel: do not try again
            else:
                lib.vl_load_image.argtypes = [
                    ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                    ctypes.c_float, ctypes.c_int,
                    np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                ]
                lib.vl_load_image.restype = ctypes.c_int
                lib.vl_load_batch.argtypes = [
                    ctypes.c_char_p,
                    np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                    ctypes.c_int,
                    np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                ]
                lib.vl_load_batch.restype = ctypes.c_int
                _lib = lib
        return _lib or None


def available() -> bool:
    return get_lib() is not None


def load_image(path: str, mid: int, reso: int, crop_fxy=(-1.0, -1.0),
               hflip=False) -> np.ndarray:
    """One image: shorter side resized to ``mid``, a ``reso`` crop at the
    origin fractions ``crop_fxy`` ((-1, -1): centre), optionally flipped;
    (reso, reso, 3) float32 in [-1, 1]."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native image pipeline could not be built")
    out = np.empty((reso, reso, 3), np.float32)
    rc = lib.vl_load_image(path.encode(), mid, reso, float(crop_fxy[0]),
                           float(crop_fxy[1]), int(hflip), out)
    if rc != 0:
        raise IOError(f"native decode failed: {path}")
    return out


def load_batch(paths: Sequence[str], mid: int, reso: int,
               crops: Optional[np.ndarray] = None, num_threads: int = 16) -> np.ndarray:
    """Decode, resize and crop a batch in parallel C++ threads.

    ``crops``: (N, 3) float32 [fx, fy, hflip] with fx, fy in [0, 1] picking
    the crop origin fraction; (-1, -1, 0) is a centre crop. Images that fail
    to decode come back as zeros (the count is printed)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native image pipeline could not be built")
    n = len(paths)
    encoded = [p.encode() for p in paths]
    blob = b"".join(p + b"\0" for p in encoded)
    offsets = np.zeros(n, np.int64)
    if n > 1:
        offsets[1:] = np.cumsum([len(p) + 1 for p in encoded[:-1]])
    if crops is None:
        crops = np.full((n, 3), -1.0, np.float32)
        crops[:, 2] = 0.0
    crops = np.ascontiguousarray(crops, np.float32)
    if crops.shape != (n, 3):
        raise ValueError(f"crops has shape {crops.shape}, want ({n}, 3)")
    out = np.empty((n, reso, reso, 3), np.float32)
    failed = lib.vl_load_batch(blob, offsets, n, mid, reso, crops, num_threads, out)
    if failed:
        print(f"[native_loader] {failed}/{n} images failed to decode (zero-filled)")
    return out


def make_native_transform(final_reso: int, mid_reso: float = 1.125,
                          train: bool = True, hflip: bool = False):
    """Drop-in for ``imagenet.make_transform`` through the C++ pipeline."""
    mid = round(mid_reso * final_reso)

    def tf(path: str, rng: np.random.Generator) -> np.ndarray:
        if train:
            flip = bool(hflip and rng.random() < 0.5)
            return load_image(path, mid, final_reso, (rng.random(), rng.random()), flip)
        return load_image(path, mid, final_reso)

    return tf


def make_native_batch_transform(final_reso: int, mid_reso: float = 1.125,
                                train: bool = True, hflip: bool = False,
                                num_threads: int = 16):
    """Whole-batch transform for ``imagenet.DataLoader``: one call decodes,
    resizes and crops N images in C++ threads (the GIL released).

    ``rngs``: one per-sample generator per path (``imagenet.sample_rng``),
    so the crop and flip draws depend on (seed, epoch, index) alone."""
    mid = round(mid_reso * final_reso)

    def tf(paths: Sequence[str], rngs: Sequence[np.random.Generator]) -> np.ndarray:
        n = len(paths)
        if train:
            crops = np.empty((n, 3), np.float32)
            for i, rng in enumerate(rngs):
                crops[i, 0] = rng.random()
                crops[i, 1] = rng.random()
                crops[i, 2] = (rng.random() < 0.5) if hflip else 0.0
        else:
            crops = None
        return load_batch(paths, mid, final_reso, crops, num_threads)

    return tf
