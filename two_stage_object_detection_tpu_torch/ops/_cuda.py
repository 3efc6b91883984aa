"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, bound with ``ctypes``.  The build runs at first use, all
sources at once (one ``nvcc`` process each), into
``<package>/_build/<hash of the sources and flags>/``, so an edited source
rebuilds and an unchanged one loads from disk.  A missing ``nvcc`` or a
failed build raises: there is no fallback to the plain versions.

This is the op modules' one seam to the kernels: :data:`ENTRIES` holds the
C signature of every entry point, :func:`entry` looks one up, and
:func:`launch` calls a launch function on a device's current stream,
checks its status and counts the call in ``utils.profiling.counters``.
The kernels' ABI rules that more than one kernel follows live here too
(:data:`DTYPES`, :func:`align_vector_width`).

Nothing here runs at import time; the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from two_stage_object_detection_tpu_torch.utils.profiling import counters

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("nms", "windowed_align", "proposals", "roi_pool", "roi_pool_bwd",
           "conv_epilogue", "depthwise_store")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}

#: every entry point of ``csrc/*.cu``: its source and its C argument types,
#: a letter each (``p`` a pointer, ``i`` int, ``l`` long long, ``f``
#: float), all returning an int.  A launch function's last argument is the
#: stream it launches on; it returns ``cudaGetLastError()``.
ENTRIES = {
    "nms_launch": ("nms", "ppiiiifippppipp"),
    "nms_pick_cluster": ("nms", "iiii"),
    "proposals_sort_launch": ("proposals", "pppiifffpppp"),
    "windowed_align_launch": ("windowed_align", "pppipppiiiiiiiiip"),
    "roi_pool_launch": ("roi_pool", "ppppiiiiiifiiiiip"),
    "roi_pool_bwd_recompute_launch": ("roi_pool_bwd", "ppppiiiiiifiiiiip"),
    "roi_pool_bwd_scatter_launch": ("roi_pool_bwd", "pppiiiiiip"),
    "conv_epilogue_launch": ("conv_epilogue", "ppppliiiip"),
    "depthwise_store_launch": ("depthwise_store", "ppppiiiiiiiip"),
}
_C_TYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int,
            "l": ctypes.c_longlong, "f": ctypes.c_float}

#: the kernels' code of a map's float format (their ``dtype`` argument)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if Path("/usr/local/cuda/bin/nvcc").exists() else None)
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of this package are built from source at first use")
    return found


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((SRC_DIR / f"{name}.cu").read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every missing kernel library, all in parallel; returns
    ``{name: ptxas report}`` for the sources built by this call."""
    out_dir = build_dir()
    todo = [n for n in SOURCES if not (out_dir / f"lib{n}.so").exists()]
    if not todo:
        return {}
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")   # atomic publish
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
            _libs[name] = lib
        return lib


def bind(lib: ctypes.CDLL, name: str):
    """``lib``'s entry point ``name`` with the argument types of
    :data:`ENTRIES` (``lib`` may be another build of its source)."""
    fn = getattr(lib, name)
    fn.argtypes = [_C_TYPES[a] for a in ENTRIES[name][1]]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def entry(name: str):
    """The entry point ``name`` of :data:`ENTRIES`, bound once."""
    return bind(library(ENTRIES[name][0]), name)


def launch(name: str, device: torch.device, *args,
           count: str | None = None) -> None:
    """Call the launch function ``name`` with ``args`` and ``device``'s
    current stream, with ``device`` current; raise on the status it
    returns, and count the call in ``counters[count]`` where one is
    named."""
    fn = entry(name)
    with torch.cuda.device(device):
        status = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(status, name)
    if count is not None:
        counters[count] += 1


def dtype_code(dtype: torch.dtype, kernel: str) -> int:
    """:data:`DTYPES`' code of ``dtype``; raises for a format the kernels
    do not take."""
    if dtype not in DTYPES:
        raise ValueError(f"{kernel} kernel takes f32 or bf16, got {dtype}")
    return DTYPES[dtype]


def align_vector_width(c: int, dtype: torch.dtype) -> int:
    """Channels kernels 2 and E load at once: the widest vector of 16, 8, 4
    or 2 bytes (one element at least) that divides a pixel's ``c``
    channels, so every pixel of a 16-byte aligned ``[..., c]`` map starts on
    a vector and no channel is left over (bf16: 8 for C=256, 4 for C=260;
    f32: 4 for C=256, 2 for C=30)."""
    dtype_code(dtype, "windowed_align")
    size = dtype.itemsize
    return next(n // size for n in (16, 8, 4, 2)
                if n >= size and (c * size) % n == 0)


def check(status: int, what: str) -> None:
    """Raise on the ``cudaGetLastError()`` code a launch function returned."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def require(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Validate a kernel argument: CUDA, dtype, shape, contiguity, alignment."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in ((dtype,) if isinstance(dtype, torch.dtype) else dtype):
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    check_aligned(t, name)


def check_aligned(t: torch.Tensor, name: str) -> None:
    """Raise unless ``t``'s data starts on a 16-byte boundary: the kernels
    load their inputs in vectors of up to 16 bytes."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
