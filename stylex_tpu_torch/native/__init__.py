"""The host pixel pipeline in C++ (``pixel_ops.cpp``), loaded with ctypes.

``g++ -O3`` builds it at first use into the package's build directory
(:data:`stylex_tpu_torch.csrc.BUILD_DIR`, by default
``build/stylex_tpu_torch/`` at the root of the checkout), named by a hash of
the source and the flags, under a private name that is then renamed, so a
concurrent build never loads a half-written library. Nothing is built when
this module is imported.

:func:`available` says whether the library is built and loaded (where
``g++`` is missing or fails it is False, and :data:`build_error` says
why); :func:`resize_crop_normalize` is PIL's bilinear resize, a center crop
and the float conversion in one pass, equal to the PIL path bit for bit
(``data.dataset.load_and_transform`` takes it for RGB images when
available, and PIL otherwise); :func:`normalize_u8` the conversion alone.
``CALLS`` counts the native calls, so a run can show it took this path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from stylex_tpu_torch import csrc

__all__ = ["available", "resize_crop_normalize", "normalize_u8", "CALLS", "library_path"]

_SRC = Path(__file__).resolve().parent / "pixel_ops.cpp"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error: Optional[str] = None
CALLS: Dict[str, int] = {"resize_crop_normalize": 0, "normalize_u8": 0}

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()
    return Path(csrc.BUILD_DIR) / f"pixel_ops-{digest[:16]}.so"


def _build() -> ctypes.CDLL:
    path = library_path()
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
        os.close(fd)
        try:
            subprocess.run(["g++", *_FLAGS, "-o", tmp, str(_SRC)], check=True,
                           capture_output=True, text=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(path))
    lib.resize_crop_normalize_u8.restype = ctypes.c_int
    lib.resize_crop_normalize_u8.argtypes = [
        _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _F32P, _F32P, ctypes.c_int, _F32P]
    lib.normalize_u8.restype = ctypes.c_int
    lib.normalize_u8.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _F32P, _F32P,
                                 ctypes.c_int, _F32P]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    """The library, built on the first call; None where the build failed."""
    global _lib, _tried, build_error
    if not _tried:
        with _lock:
            if not _tried:
                try:
                    _lib = _build()
                except (OSError, subprocess.CalledProcessError) as e:
                    build_error = getattr(e, "stderr", None) or str(e)
                _tried = True
    return _lib


def available() -> bool:
    return _get_lib() is not None


def _f32p(arr: Optional[np.ndarray]):
    return ctypes.cast(None, _F32P) if arr is None else arr.ctypes.data_as(_F32P)


def _prepare(src, mean, std, out, shape) -> Tuple:
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(f"native pixel ops unavailable: {build_error}")
    src = np.ascontiguousarray(src, np.uint8)
    if src.ndim != 3:
        raise ValueError(f"expected an (H, W, C) uint8 image, got shape {src.shape}")
    c = src.shape[2]
    if out is None:
        out = np.empty(shape + (c,), np.float32)
    elif (out.shape != shape + (c,) or out.dtype != np.float32
          or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(f"out must be a writable C-contiguous float32 {shape + (c,)} array")
    mean = None if mean is None else np.ascontiguousarray(mean, np.float32)
    std = None if std is None else np.ascontiguousarray(std, np.float32)
    for a in (mean, std):
        if a is not None and a.shape != (c,):
            raise ValueError(f"mean and std need {c} values")
    return lib, src, mean, std, out


def resize_crop_normalize(src: np.ndarray, out_size: Tuple[int, int],
                          crop_size: Tuple[int, int], mean: Optional[np.ndarray] = None,
                          std: Optional[np.ndarray] = None, hflip: bool = False,
                          out: Optional[np.ndarray] = None) -> np.ndarray:
    """PIL's bilinear resize of ``src`` ((H, W, C) uint8) to ``out_size``
    (out_h, out_w), the center ``crop_size`` (crop_h, crop_w), as float32 in
    [0, 1] (then ``(x - mean) / std`` where both are given; mirrored with
    ``hflip``), written into ``out`` (e.g. a batch row) when given."""
    lib, src, mean, std, out = _prepare(src, mean, std, out, tuple(crop_size))
    h, w, c = src.shape
    rc = lib.resize_crop_normalize_u8(src.ctypes.data_as(_U8P), h, w, c, int(out_size[0]),
                                      int(out_size[1]), int(crop_size[0]), int(crop_size[1]),
                                      _f32p(mean), _f32p(std), int(hflip),
                                      out.ctypes.data_as(_F32P))
    if rc != 0:
        raise ValueError(f"resize_crop_normalize: invalid sizes {src.shape} -> {out_size}, "
                         f"crop {crop_size}")
    CALLS["resize_crop_normalize"] += 1
    return out


def normalize_u8(src: np.ndarray, mean: Optional[np.ndarray] = None,
                 std: Optional[np.ndarray] = None, hflip: bool = False,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
    """(H, W, C) uint8 -> float32 in [0, 1], normalised and mirrored as
    :func:`resize_crop_normalize` does."""
    src_arr = np.asarray(src)
    lib, src, mean, std, out = _prepare(src, mean, std, out, tuple(src_arr.shape[:2]))
    h, w, c = src.shape
    rc = lib.normalize_u8(src.ctypes.data_as(_U8P), h, w, c, _f32p(mean), _f32p(std),
                          int(hflip), out.ctypes.data_as(_F32P))
    if rc != 0:
        raise ValueError(f"normalize_u8: invalid shape {src.shape}")
    CALLS["normalize_u8"] += 1
    return out
