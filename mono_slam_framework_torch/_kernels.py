"""Builds and loads the CUDA kernels of `csrc/`.

The kernels are CUDA C++ for Hopper (`sm_90a`) with a plain C interface.
On first use, `nvcc` compiles every `csrc/*.cu` into one shared library,
which is loaded with `ctypes`. The library lands in `_build/<hash>/`
inside this package (ignored by git), keyed by a hash of the sources, so
an edited source rebuilds and an unchanged one loads what is there.

Nothing here runs at import: the CPU-only test machine imports every
module but never calls `load`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# every pointer and the stream are c_void_p: without argtypes ctypes would
# pass Python ints as 32-bit C ints and cut the pointers
_SIGNATURES = {
    # (img, out5, table, n_levels, n_tile_rows, rows, w0, threshold, border,
    #  stream)
    "detect_maps_launch": (_P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    # (xw, uv, valid, info, k4, t_init, t_out, inlier, B, E, stream)
    "pose_lm_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
}


class BuildInfo:
    """What the last `load` did: library path, seconds spent, compiler log."""

    path: pathlib.Path | None = None
    seconds: float = 0.0
    log: str = ""
    built: bool = False


build_info = BuildInfo()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    t0 = time.perf_counter()
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / "libmsf_kernels.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        cu = [str(p) for p in sorted(CSRC.glob("*.cu"))]
        # build into a temporary name and rename: a concurrent or cut build
        # never leaves a half-written library under the final name
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_info.log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{build_info.log}"
            )
        os.replace(tmp, lib_path)
        build_info.built = True
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    build_info.path = lib_path
    build_info.seconds = time.perf_counter() - t0
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
