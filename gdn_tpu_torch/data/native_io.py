"""ctypes binding of the native decode library ``native/libgdn_io.so``
(port of ``gdn_tpu/data/native_io.py``; both bind the same library).

``decode_rgb_batch`` and ``decode_depth_batch`` decode and resize a
whole batch on a C++ thread pool into one numpy buffer, with the GIL
released.  The library is built from ``native/gdn_io.cpp`` by
``make -C native`` at first use, which writes nothing under ``native/``
but the ``.so``; without a toolchain or the libpng/libjpeg headers the
build fails, ``available()`` is False and the loaders decode with PIL.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
BUILD_LOG = ""  # make's output when the library had to be built

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libgdn_io.so")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, BUILD_LOG
    if _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_SO_PATH):
        try:
            out = subprocess.run(["make", "-C", _NATIVE_DIR], capture_output=True,
                                 text=True, timeout=120)
            BUILD_LOG = out.stdout + out.stderr
        except (OSError, subprocess.SubprocessError) as e:
            BUILD_LOG = f"{type(e).__name__}: {e}"
    if not os.path.exists(_SO_PATH):
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError as e:
        BUILD_LOG += f"\n{e}"
        return None
    lib.gdn_last_error.restype = ctypes.c_char_p
    fp = ctypes.POINTER(ctypes.c_float)
    lib.gdn_decode_rgb.argtypes = [ctypes.c_char_p, fp, ctypes.c_int, ctypes.c_int]
    lib.gdn_decode_depth.argtypes = [ctypes.c_char_p, fp, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float]
    lib.gdn_decode_rgb_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, fp,
                                         ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.gdn_decode_depth_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                           fp, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int]
    _LIB = lib
    return _LIB


def available() -> bool:
    """Whether the native library is loaded (built first if need be)."""
    return _load() is not None


def _paths_array(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def _as_float_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_rgb_batch(paths: Sequence[str], height: int, width: int,
                     num_threads: int = 0) -> np.ndarray:
    """(N, H, W, 3) float32 in [0, 1] (bilinear, antialiased when it
    shrinks); raises RuntimeError when a decode fails."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    out = np.empty((len(paths), height, width, 3), np.float32)
    threads = num_threads or min(len(paths), os.cpu_count() or 4)
    rc = lib.gdn_decode_rgb_batch(_paths_array(paths), len(paths), _as_float_ptr(out),
                                  height, width, threads)
    if rc != 0:
        raise RuntimeError(f"native rgb decode failed: {lib.gdn_last_error().decode()}")
    return out


def decode_depth_batch(paths: Sequence[str], height: int, width: int,
                       scale: float = 1.0 / 256.0, num_threads: int = 0) -> np.ndarray:
    """(N, H, W) float32 meters: 16-bit PNG counts * ``scale``, nearest
    resize."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    out = np.empty((len(paths), height, width), np.float32)
    threads = num_threads or min(len(paths), os.cpu_count() or 4)
    rc = lib.gdn_decode_depth_batch(_paths_array(paths), len(paths), _as_float_ptr(out),
                                    height, width, ctypes.c_float(scale), threads)
    if rc != 0:
        raise RuntimeError(f"native depth decode failed: {lib.gdn_last_error().decode()}")
    return out
