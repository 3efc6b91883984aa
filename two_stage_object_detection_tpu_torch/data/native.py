"""ctypes bindings to the repository's native preprocessing library.

The port's copy of the JAX package's ``data/native.py``.  It builds
``native/preprocess.cpp`` (libjpeg/libpng decode, antialiased resize) itself,
at first use, with the flags of ``native/Makefile``, into
``two_stage_object_detection_tpu_torch/_build/native/``: one library for each
version of the source and each host CPU (``-march=native`` code runs only on
a CPU like the one that built it).  Processes that build at once each write a
temporary file and move it into place with ``os.replace``.

Every entry point returns ``None`` when the library cannot be built or
loaded (no compiler, no libjpeg/libpng headers), and the callers fall back
to PIL, as the JAX package's do.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parents[2] / "native" / "preprocess.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build" / "native"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared")
LIBS = ("-ljpeg", "-lpng")

_lib = None
_tried = False
_lock = threading.Lock()


def _cpu_flags() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        return ""


def lib_path() -> Path:
    """Where this source, these flags and this CPU's library lives."""
    h = hashlib.sha256(" ".join(CXXFLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes() if SOURCE.exists() else b"")
    h.update(_cpu_flags().encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libpreprocess.so"


def _build(so: Path) -> bool:
    if not SOURCE.exists():
        return False
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", tmp, str(SOURCE),
           *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        log.info("native preprocess library not built (%s): PIL is used", e)
        return False
    if proc.returncode != 0:
        os.unlink(tmp)
        log.info("native preprocess library not built: PIL is used\n%s",
                 "\n".join(proc.stderr.strip().splitlines()[-3:]))
        return False
    os.replace(tmp, so)                 # atomic publish
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it on demand; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = lib_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            log.info("native preprocess library not loaded (%s): PIL is "
                     "used", e)
            return None
        lib.decode_resize_normalize.restype = ctypes.c_int
        lib.decode_resize_normalize.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.resize_bilinear_normalize.restype = None
        lib.resize_bilinear_normalize.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ]
        lib.resize_f32.restype = None
        lib.resize_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ]
        lib.decode_into.restype = ctypes.c_int
        lib.decode_into.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.rgb_to_yuv420_u8.restype = None
        lib.rgb_to_yuv420_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def decode_resize(path: str, size: Tuple[int, int]
                  ) -> Optional[Tuple[np.ndarray, int, int]]:
    """Decode an image file and resize to ``(H, W)`` float32 [0,1] HWC.

    Returns ``(image, orig_h, orig_w)`` or None (unsupported format / no lib).
    """
    if get_lib() is None:
        return None
    with open(path, "rb") as f:
        data = f.read()
    return decode_resize_bytes(data, size)


def decode_resize_bytes(data: bytes, size: Tuple[int, int]
                        ) -> Optional[Tuple[np.ndarray, int, int]]:
    """:func:`decode_resize` from JPEG/PNG bytes in memory (the serving
    ingest path: request bodies never touch the file system)."""
    lib = get_lib()
    if lib is None:
        return None
    dh, dw = size
    out = np.empty((dh, dw, 3), np.float32)
    oh = ctypes.c_int(0)
    ow = ctypes.c_int(0)
    rc = lib.decode_resize_normalize(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dh, dw, ctypes.byref(oh), ctypes.byref(ow))
    if rc != 0:
        return None
    return out, oh.value, ow.value


def resize_normalize(img_u8: np.ndarray, size: Tuple[int, int]
                     ) -> Optional[np.ndarray]:
    """Bilinear resize + normalise an RGB u8 HWC array -> float32 [0, 1];
    None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    sh, sw = img_u8.shape[:2]
    dh, dw = size
    out = np.empty((dh, dw, 3), np.float32)
    lib.resize_bilinear_normalize(
        img_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), sh, sw,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), dh, dw)
    return out


def resize_f32(img: np.ndarray, size: Tuple[int, int]) -> Optional[np.ndarray]:
    """Antialiased triangle resize of a float32 HWC image."""
    lib = get_lib()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.float32)
    sh, sw = img.shape[:2]
    dh, dw = size
    out = np.empty((dh, dw, 3), np.float32)
    lib.resize_f32(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), sh, sw,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), dh, dw)
    return out


def rgb_to_yuv420(images: np.ndarray) -> Optional[np.ndarray]:
    """Pack RGB u8 ``[N, H, W, 3]`` into the yuv420 wire layout ``[N, H +
    H//2, W]`` (``serving.rgb_to_yuv420`` describes it); None without the
    library, and the caller packs with numpy."""
    lib = get_lib()
    if lib is None:
        return None
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w, _ = images.shape
    out = np.empty((n, h + h // 2, w), np.uint8)
    for i in range(n):
        lib.rgb_to_yuv420_u8(
            images[i].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
            out[i].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def decode(path: str) -> Optional[np.ndarray]:
    """Decode a JPEG/PNG file to an RGB uint8 HWC array (None if no lib or
    unsupported format)."""
    lib = get_lib()
    if lib is None:
        return None
    with open(path, "rb") as f:
        data = f.read()
    cap = 2048 * 2048 * 3
    for _ in range(2):
        buf = np.empty((cap,), np.uint8)
        h = ctypes.c_int(0)
        w = ctypes.c_int(0)
        rc = lib.decode_into(data, len(data),
                             buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                             cap, ctypes.byref(h), ctypes.byref(w))
        if rc == 0:
            return buf[: h.value * w.value * 3].reshape(h.value, w.value, 3).copy()
        if rc == -2:
            cap = h.value * w.value * 3
            continue
        return None
    return None
