"""ctypes bridge to the native preprocessing library (torch port of
``effectivediffusivityfvm_tpu.models._native``).

``csrc/preprocess.cpp`` (the package's own copy) is built with ``g++`` on
first use into ``<checkout>/build/native/``, under a file name that carries
a hash of the source, the flags and the machine, and loaded with ctypes.
Each entry point returns ``None`` when no compiler or no build is
available, and the callers then take the numpy/scipy route, which gives
the same results (as in the JAX package).

The C functions run without the GIL (ctypes releases it), so a pipeline
thread can preprocess one batch while the device solves another.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["get_lib", "native_available", "flood_fill_native",
           "porosity_native", "classify_two_phase_native",
           "classify_three_phase_native", "SOURCE", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "preprocess.cpp"
BUILD_DIR = _PKG.parent / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_LOCK = threading.Lock()    # one build at a time in a process


def _lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + [platform.machine()]).encode())
    return BUILD_DIR / f"libdeffpre_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    """Compile into a file of this process's own and move it into place,
    so that processes building at once never load a half-written one."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; ``None`` when it cannot
    be built or loaded."""
    with _LOCK:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    if not SOURCE.exists():
        return None
    path = _lib_path()
    if not path.exists() and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.classify_two_phase.argtypes = [u8p, ctypes.c_int64, u8p]
    lib.classify_two_phase.restype = None
    lib.classify_three_phase.argtypes = [u8p, ctypes.c_int64, u8p]
    lib.classify_three_phase.restype = None
    lib.porosity.argtypes = [u8p, ctypes.c_int64]
    lib.porosity.restype = ctypes.c_double
    lib.flood_fill.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32, u8p, u8p]
    lib.flood_fill.restype = ctypes.c_int
    lib.flood_fill_batch.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32,
                                     ctypes.c_int32, u8p, u8p, i32p]
    lib.flood_fill_batch.restype = None
    return lib


def native_available() -> bool:
    return get_lib() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def flood_fill_native(solid: np.ndarray):
    """The C++ union-find flood fill of a ``(ny, nx)`` solid mask:
    ``(participating, isolated, path_flag)``, or ``None`` without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    solid = np.ascontiguousarray(solid, dtype=np.uint8)
    if solid.ndim != 2:
        raise ValueError(f"flood_fill_native takes one (ny, nx) mask, got "
                         f"{solid.shape}")
    ny, nx = solid.shape
    part = np.empty_like(solid)
    iso = np.empty_like(solid)
    flag = lib.flood_fill(_u8(solid), ny, nx, _u8(part), _u8(iso))
    return part.astype(bool), iso.astype(bool), bool(flag)


def porosity_native(img: np.ndarray) -> Optional[float]:
    """The fraction of pixels below 150, or ``None`` without the library."""
    lib = get_lib()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, dtype=np.uint8)
    return float(lib.porosity(_u8(img), img.size))


def _classify(name, img):
    lib = get_lib()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, dtype=np.uint8)
    out = np.empty_like(img)
    getattr(lib, name)(_u8(img), img.size, _u8(out))
    return out


def classify_two_phase_native(img: np.ndarray) -> Optional[np.ndarray]:
    """0 (fluid) below 150, else 1 (solid); ``None`` without the library."""
    return _classify("classify_two_phase", img)


def classify_three_phase_native(img: np.ndarray) -> Optional[np.ndarray]:
    """1 (solid) above 200, 2 (gas) below 50, else 0 (fluid); ``None``
    without the library."""
    return _classify("classify_three_phase", img)
