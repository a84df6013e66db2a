"""ctypes bindings for the native IO runtime (``native/scloam_io.cpp``, the
prefetching scan loader and the binary PCD / PLY writers).

The library is built with ``g++`` at first use into the package's
``_build/`` directory, keyed by a hash of the source.  ``available()`` says
whether it could be built and loaded; callers that can do without it use
the numpy loaders in ``utils/mulran.py`` instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "scloam_io.cpp")
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_LOCK = threading.Lock()
_lib = None
_error: str | None = None


def _compile() -> str:
    """Path of the built library; raises with the reason when the source
    is missing or ``g++`` fails."""
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()
                             ).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libscloam_io_{tag}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE],
                                  capture_output=True, text=True, timeout=120)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def _load():
    """The loaded library, or None (``why_unavailable()`` then says why).
    One attempt per process."""
    global _lib, _error
    with _LOCK:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(_compile())
            except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
                _error = f"{type(e).__name__}: {e}"
                return None
            lib.sl_open.restype = ctypes.c_void_p
            lib.sl_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.sl_next.restype = ctypes.c_int64
            lib.sl_next.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.POINTER(ctypes.c_uint8)]
            lib.sl_close.restype = None
            lib.sl_close.argtypes = [ctypes.c_void_p]
            for name in ("sl_write_pcd", "sl_write_ply"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
            _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def why_unavailable() -> str | None:
    _load()
    return _error


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native IO library unavailable: {_error}")
    return lib


class NativeScanLoader:
    """Background-threaded prefetching loader over raw .bin scan files;
    iterates (points (max_points,3) float32, mask (max_points,) bool) in
    file order.  ``close()`` stops its threads."""

    def __init__(self, files: list[str], max_points: int,
                 n_threads: int = 2, prefetch_depth: int = 4):
        self._h = None
        self._lib = _require()
        self._max_points = max_points
        blob = b"".join(f.encode() + b"\x00" for f in files)
        self._h = self._lib.sl_open(blob, len(files), max_points, n_threads,
                                    prefetch_depth)
        self._xyz = np.zeros((max_points, 3), np.float32)
        self._mask = np.zeros((max_points,), np.uint8)

    def __iter__(self):
        return self

    def __next__(self):
        if not self._h:
            raise StopIteration
        n = self._lib.sl_next(
            self._h,
            self._xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if n < 0:
            raise StopIteration
        return self._xyz.copy(), self._mask.astype(bool)

    def close(self):
        if self._h:
            self._lib.sl_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def _write(fn_name: str, path: str, points: np.ndarray) -> None:
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    r = getattr(_require(), fn_name)(
        path.encode(), pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(pts))
    if r != 0:
        raise IOError(f"{fn_name} failed: {path}")


def write_pcd(path: str, points: np.ndarray) -> None:
    """Binary PCD (pcl-compatible), as the reference's end-of-run dump."""
    _write("sl_write_pcd", path, points)


def write_ply(path: str, points: np.ndarray) -> None:
    """Binary little-endian PLY."""
    _write("sl_write_ply", path, points)
