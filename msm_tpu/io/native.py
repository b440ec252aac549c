"""ctypes binding for the native I/O core (native/libmsm_io.so).

The C++ writer streams interleaved complex data straight into the two npy
plane files without numpy `.real`/`.imag` temporaries and releases the GIL
for the whole write (see native/msm_io.cpp). The library is built from
source on first use, and again whenever native/msm_io.cpp is newer than
it (`make -C native`, into a temporary name renamed into place, so
concurrent first uses cannot corrupt it). Without a compiler the numpy
writers are used and a warning says so.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _native_dir() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "native")


def _lib_path() -> str:
    return os.path.join(_native_dir(), "libmsm_io.so")


def build() -> str:
    """Compile native/msm_io.cpp into native/libmsm_io.so; returns the path.

    Builds to a per-process, per-thread temporary name and `os.replace`s
    it into place: the rename is atomic, so parallel builders (test
    workers) each install a complete library and a loader never sees a
    partial file."""
    path = _lib_path()
    tmp = f".libmsm_io.{os.getpid()}.{threading.get_ident()}.tmp.so"
    subprocess.run(
        ["make", "-s", "-C", _native_dir(), f"OUT={tmp}"],
        check=True,
        capture_output=True,
    )
    os.replace(os.path.join(_native_dir(), tmp), path)
    return path


def is_stale(path: str) -> bool:
    """Whether the library at `path` is missing or older than its source."""
    src = os.path.join(_native_dir(), "msm_io.cpp")
    return not os.path.exists(path) or (
        os.path.exists(src) and os.path.getmtime(src) > os.path.getmtime(path)
    )


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if is_stale(path):
        try:
            build()
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            log.warning(
                "native I/O library not built (%s%s); using the numpy writers",
                e,
                f": {detail.decode(errors='replace').strip()}" if detail else "",
            )
            return None
    try:
        lib = ctypes.CDLL(path)
        lib.msm_write_complex_pair.restype = ctypes.c_int
        lib.msm_write_complex_pair.argtypes = [
            ctypes.c_char_p,
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int,
        ]
        lib.msm_write_npy.restype = ctypes.c_int
        lib.msm_write_npy.argtypes = lib.msm_write_complex_pair.argtypes
        if hasattr(lib, "msm_read_complex_pair"):
            lib.msm_read_complex_pair.restype = ctypes.c_int
            lib.msm_read_complex_pair.argtypes = [
                ctypes.c_char_p,
                ctypes.c_void_p,
                ctypes.c_uint64,
                ctypes.c_int,
            ]
        _LIB = lib
    except OSError as e:
        log.warning("native I/O library failed to load (%s); using the numpy writers", e)
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def _shape_arr(shape) -> "ctypes.Array":
    return (ctypes.c_uint64 * len(shape))(*shape)


def write_complex_pair(path_base: str, arr: np.ndarray) -> None:
    """Write `{base}_real`/`{base}_imag` from an interleaved complex array."""
    lib = _load()
    assert lib is not None
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.complex64:
        is_double = 0
    elif arr.dtype == np.complex128:
        is_double = 1
    else:
        raise TypeError(f"expected complex array, got {arr.dtype}")
    rc = lib.msm_write_complex_pair(
        path_base.encode(),
        arr.ctypes.data_as(ctypes.c_void_p),
        arr.size,
        is_double,
        _shape_arr(arr.shape),
        arr.ndim,
    )
    if rc != 0:
        raise OSError(f"native complex pair write failed ({rc}): {path_base}")


def can_read() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "msm_read_complex_pair")


def read_complex_pair(path_base: str, shape, dtype) -> np.ndarray:
    """Read `{base}_real`/`{base}_imag` planes into one interleaved complex
    array in a single GIL-free pass (no real+imag numpy temporaries)."""
    lib = _load()
    assert lib is not None
    dtype = np.dtype(dtype)
    assert dtype in (np.complex64, np.complex128)
    out = np.empty(shape, dtype)
    rc = lib.msm_read_complex_pair(
        path_base.encode(),
        out.ctypes.data_as(ctypes.c_void_p),
        out.size,
        1 if dtype == np.complex128 else 0,
    )
    if rc != 0:
        raise OSError(f"native complex pair read failed ({rc}): {path_base}")
    return out


def write_npy(path: str, arr: np.ndarray) -> None:
    """Write a real float32/float64 npy file at exactly `path`."""
    lib = _load()
    assert lib is not None
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.float32:
        is_double = 0
    elif arr.dtype == np.float64:
        is_double = 1
    else:
        raise TypeError(f"native writer supports f32/f64, got {arr.dtype}")
    rc = lib.msm_write_npy(
        path.encode(),
        arr.ctypes.data_as(ctypes.c_void_p),
        arr.size,
        is_double,
        _shape_arr(arr.shape),
        arr.ndim,
    )
    if rc != 0:
        raise OSError(f"native npy write failed ({rc}): {path}")
