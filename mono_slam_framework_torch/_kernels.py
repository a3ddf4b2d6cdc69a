"""Builds and loads the CUDA kernels of `csrc/`.

The kernels are CUDA C++ for Hopper (`sm_90a`) with a plain C interface.
On first use, one `nvcc` per `csrc/*.cu`, all started together, compiles
each source to an object, and one more links them into a shared library,
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
import re
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).parent / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# every pointer and the stream are c_void_p: without argtypes ctypes would
# pass Python ints as 32-bit C ints and cut the pointers
_SIGNATURES = {
    # (img, out5, table, n_levels, grid_x, grid_y, rows, w0, threshold,
    #  border, stream)
    "detect_maps_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P),
    # (img, out5, table, n_levels, grid_x, grid_y, n_streams, rows, w0,
    #  threshold, border, stream)
    "detect_maps_batch_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    # (xw, uv, valid, info, K, t_init, t_out, inlier, n_good, B, E, cluster,
    #  slice, resident, smem, stream)
    "pose_lm_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}


class BuildInfo:
    """What the last `load` did: library path, seconds spent, compiler log
    (kept beside the library, so a library loaded as built keeps it too)."""

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
        # build into a temporary directory and rename the library: a
        # concurrent or cut build never leaves a half-written library under
        # the final name
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            tmp = pathlib.Path(tmp)
            jobs = []
            for src in sorted(CSRC.glob("*.cu")):
                cmd = [_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(tmp / f"{src.stem}.o")]
                jobs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            logs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in jobs]
            link = [_nvcc(), *ARCH, "-shared", "-o", str(tmp / lib_path.name),
                    *(cmd[-1] for cmd, _, _ in logs)]
            if all(rc == 0 for _, _, rc in logs):
                proc = subprocess.run(link, capture_output=True, text=True)
                logs.append((link, proc.stdout + proc.stderr, proc.returncode))
            build_info.log = "".join(log for _, log, _ in logs)
            failed = [(cmd, log, rc) for cmd, log, rc in logs if rc != 0]
            if failed:
                cmd, log, rc = failed[0]
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{log}")
            (out_dir / "nvcc.log").write_text(build_info.log)
            os.replace(tmp / lib_path.name, lib_path)
        build_info.built = True
    else:
        log = out_dir / "nvcc.log"
        build_info.log = log.read_text() if log.exists() else ""
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    build_info.path = lib_path
    build_info.seconds = time.perf_counter() - t0
    return lib


def ptxas_report(log: str) -> dict:
    """Per kernel (mangled name) what `-Xptxas -v` reported: registers,
    stack frame, spill stores and loads, and shared memory, in bytes."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": None, "stack_frame": 0, "spill_stores": 0,
                         "spill_loads": 0, "smem": 0}
            continue
        if name is None:
            continue
        rec = out[name]
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            rec["stack_frame"], rec["spill_stores"], rec["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rec["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            rec["smem"] = int(m.group(1)) if m else 0
            m = re.search(r"(\d+) bytes cumulative stack size", line)
            rec["stack_frame"] = max(rec["stack_frame"], int(m.group(1)) if m else 0)
    return out


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
