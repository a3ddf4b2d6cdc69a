"""Native (C++) runtime components, bound via ctypes.

PyTorch port's counterpart of `mono_slam_framework_tpu/native/__init__.py`.
`slamgraph.cc` and `frameio.cc` are byte-identical copies of the JAX
package's sources. Each library is built lazily with g++ into
`_build/native-<hash>/` inside this package (ignored by git), keyed by a
hash of its source and compiler flags. The compiler writes a temporary file
in that directory which is then renamed onto the library's name, so
processes that build at once each load a whole library. If the toolchain is
unavailable the callers fall back to the pure-Python implementations, as in
the JAX package (`Map` to the Python covisibility scan, the dataset loaders
to PIL).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading
import time

import numpy as np

HERE = pathlib.Path(__file__).parent
BUILD_ROOT = HERE.parent / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

# per library name: seconds its build (or load of an earlier build) took,
# and the compiler's output when it failed
build_seconds: dict[str, float] = {}
build_errors: dict[str, str] = {}


def library_path(src: str, libs: tuple = ()) -> pathlib.Path:
    """Where `src`'s library lives: `_build/native-<hash>/lib<stem>.so`."""
    h = hashlib.sha256(" ".join(("g++", *CXX_FLAGS, *libs)).encode())
    h.update((HERE / src).read_bytes())
    stem = pathlib.Path(src).stem
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / f"lib{stem}.so"


def build(src: str, libs: tuple = ()) -> pathlib.Path | None:
    """Build (if needed) the shared library of `src` with g++ and return its
    path; None if the compiler fails or is missing (the reason is kept in
    `build_errors`)."""
    t0 = time.perf_counter()
    lib = library_path(src, libs)
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=lib.parent, prefix=f".{lib.stem}-", suffix=".so")
        os.close(fd)
        try:
            subprocess.run(
                ["g++", *CXX_FLAGS, "-o", tmp, str(HERE / src), *libs],
                check=True, capture_output=True, text=True, timeout=120,
            )
            os.replace(tmp, lib)
        except subprocess.CalledProcessError as e:
            build_errors[lib.stem] = e.stderr
            return None
        except (OSError, subprocess.SubprocessError) as e:
            build_errors[lib.stem] = repr(e)
            return None
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    build_seconds[lib.stem] = time.perf_counter() - t0
    return lib


_lock = threading.Lock()
_lib = None
_tried = False


def load_library():
    """Load (building if needed) the observation-graph library; None if
    unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build("slamgraph.cc")
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            build_errors["libslamgraph"] = repr(e)
            return None
        lib.sg_create.restype = ctypes.c_void_p
        lib.sg_destroy.argtypes = [ctypes.c_void_p]
        lib.sg_clear.argtypes = [ctypes.c_void_p]
        lib.sg_add_obs.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        lib.sg_add_obs.restype = ctypes.c_int
        lib.sg_erase_obs.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        lib.sg_erase_obs.restype = ctypes.c_int
        lib.sg_erase_mp.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.sg_erase_kf.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.sg_n_obs_kf.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.sg_n_obs_kf.restype = ctypes.c_int64
        lib.sg_n_obs_mp.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.sg_n_obs_mp.restype = ctypes.c_int64
        lib.sg_covis_counts.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        lib.sg_covis_counts.restype = ctypes.c_int64
        _lib = lib
        return _lib


class ObservationGraph:
    """Native (map-point, keyframe) incidence store with covisibility counts.

    Mirrors MapPoint.observations; KeyFrame.update_connections queries it.
    """

    def __init__(self):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native slamgraph unavailable")
        self._lib = lib
        self._h = ctypes.c_void_p(lib.sg_create())

    def __del__(self):
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_h", None)
        if lib is not None and h:
            lib.sg_destroy(h)

    def clear(self) -> None:
        self._lib.sg_clear(self._h)

    def add(self, mp_id: int, kf_id: int) -> bool:
        return bool(self._lib.sg_add_obs(self._h, mp_id, kf_id))

    def erase(self, mp_id: int, kf_id: int) -> bool:
        return bool(self._lib.sg_erase_obs(self._h, mp_id, kf_id))

    def erase_map_point(self, mp_id: int) -> None:
        self._lib.sg_erase_mp(self._h, mp_id)

    def erase_keyframe(self, kf_id: int) -> None:
        self._lib.sg_erase_kf(self._h, kf_id)

    def n_obs_kf(self, kf_id: int) -> int:
        return int(self._lib.sg_n_obs_kf(self._h, kf_id))

    def n_obs_mp(self, mp_id: int) -> int:
        return int(self._lib.sg_n_obs_mp(self._h, mp_id))

    def covis_counts(self, kf_id: int) -> dict[int, int]:
        """{other keyframe id: shared map points}, in the library's
        (unordered_map) order; grows its buffers and asks again when the
        answer does not fit."""
        cap = 256
        while True:
            ids = np.empty(cap, np.int64)
            wts = np.empty(cap, np.int64)
            n = self._lib.sg_covis_counts(
                self._h,
                kf_id,
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                wts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                cap,
            )
            if n >= 0:
                return {int(i): int(w) for i, w in zip(ids[:n], wts[:n])}
            cap = -n


def available() -> bool:
    return load_library() is not None
