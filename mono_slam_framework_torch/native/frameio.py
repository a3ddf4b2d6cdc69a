"""ctypes binding for the native frame-IO library (frameio.cc).

PyTorch port's counterpart of `mono_slam_framework_tpu/native/frameio.py`:
native twin of the reference app's C++ frame-acquisition path
(src/main.cpp:122-128 camera grab + the GammaCorrector LUT at
src/main.cpp:21-39), repurposed for on-disk dataset sequences: C++ PNG/PGM
decode (zlib) plus a decode-ahead worker thread, so the per-frame SLAM step
never blocks on disk reads or inflate. Falls back to None (callers use PIL)
when the toolchain or zlib is unavailable. The library is built by
`native.build` (race-free, under `_build/`).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from mono_slam_framework_torch import native

LIBS = ("-lz", "-lpthread")
_lock = threading.Lock()
_lib = None
_tried = False

# error codes mirrored from frameio.cc
OK = 0
ERR_OPEN = -1
ERR_FORMAT = -2
ERR_UNSUPPORTED = -3
ERR_TOO_LARGE = -4
ERR_INFLATE = -5
END_OF_STREAM = -100


def load_library():
    """Load (building if needed) libframeio; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = native.build("frameio.cc", LIBS)
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            native.build_errors["libframeio"] = repr(e)
            return None
        c_int_p = ctypes.POINTER(ctypes.c_int)
        f32_p = ctypes.POINTER(ctypes.c_float)
        lib.fio_decode.argtypes = [
            ctypes.c_char_p, f32_p, c_int_p, c_int_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ]
        lib.fio_decode.restype = ctypes.c_int
        lib.fio_prefetch_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ]
        lib.fio_prefetch_create.restype = ctypes.c_void_p
        lib.fio_prefetch_next.argtypes = [
            ctypes.c_void_p, f32_p, c_int_p, c_int_p,
        ]
        lib.fio_prefetch_next.restype = ctypes.c_int
        lib.fio_prefetch_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


# generous bound for any monocular dataset frame (KITTI is 1241x376)
MAX_H, MAX_W = 2048, 2048


def decode(path: str, gamma: float = 0.0) -> Optional[np.ndarray]:
    """Decode one PNG/PGM file to grayscale f32 [H,W] 0..255 natively.

    Returns None when the library is unavailable or the file uses an
    encoding the native decoder doesn't handle (caller falls back to PIL).
    """
    lib = load_library()
    if lib is None:
        return None
    buf = np.empty(MAX_H * MAX_W, np.float32)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.fio_decode(
        path.encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(h), ctypes.byref(w), MAX_H, MAX_W,
        ctypes.c_float(gamma),
    )
    if rc != OK:
        return None
    return buf[: h.value * w.value].reshape(h.value, w.value).copy()


class FramePrefetcher:
    """Decode-ahead iterator over an image-path sequence.

    A C++ worker thread reads and decodes `ring` frames ahead of the
    consumer; `__next__` returns (index, image f32 [H,W]) and raises
    StopIteration at end of stream. Frames the native decoder can't handle
    yield (index, None) so the caller can PIL-decode just those.
    """

    def __init__(
        self,
        paths: Sequence[str],
        ring: int = 4,
        gamma: float = 0.0,
    ):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native frameio unavailable")
        self._lib = lib
        self._paths = [p.encode() for p in paths]
        self._n = len(self._paths)
        arr = (ctypes.c_char_p * self._n)(*self._paths)
        self._keepalive = arr
        self._handle = lib.fio_prefetch_create(
            arr, self._n, MAX_H, MAX_W, ring, ctypes.c_float(gamma)
        )
        self._buf = np.empty(MAX_H * MAX_W, np.float32)
        self._i = 0

    def __iter__(self) -> Iterator[Tuple[int, Optional[np.ndarray]]]:
        return self

    def __next__(self):
        if self._handle is None:
            raise StopIteration
        h = ctypes.c_int()
        w = ctypes.c_int()
        rc = self._lib.fio_prefetch_next(
            self._handle,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(h), ctypes.byref(w),
        )
        if rc == END_OF_STREAM:
            self.close()
            raise StopIteration
        i = self._i
        self._i += 1
        if rc != OK:
            return i, None
        img = (
            self._buf[: h.value * w.value]
            .reshape(h.value, w.value)
            .copy()
        )
        return i, img

    def close(self):
        if self._handle is not None:
            self._lib.fio_prefetch_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
