#!/usr/bin/env python3
"""Where the time goes inside kernels B1 and B2, from clock64() stamps.

    python3 tools/torch_kernel_clocks.py

Needs the CUDA card and the toolkit. It copies `csrc/detect.cu` and
`csrc/pose_lm.cu`, inserts clock64() stamps into the copies (B1: at each of
its six phase barriers, summed over the block's thread 0; B2: around the edge
loops, the cluster reduction and the LM step, on thread 0 of CTA 0 of problem
0), builds each copy with nvcc into a temporary directory, runs it at the main
path's shapes and prints one JSON line per kernel: cycles per tile per phase
(B1, 640x480 pyramid) and cycles per launch per section (B2, at 16 and 2000
edges and at the steady step's shape, for clusters of 1 and 8), beside the
instrumented copy's ms per launch. The stamps cost a few percent; the
repository's kernels are untouched. A stamp anchor that no longer matches the
source stops the tool with an error.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from mono_slam_framework_torch import _kernels  # noqa: E402
from mono_slam_framework_torch.ops import detect, orb  # noqa: E402
from mono_slam_framework_torch.optim import pose_opt_cuda  # noqa: E402

_P = ctypes.c_void_p
CLOCKS = '''
extern "C" int clk_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk)));
}
extern "C" int clk_zero() {
  unsigned long long z[8] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(g_clk, z, sizeof(z)));
}
'''


def _replace(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"stamp anchor not found: {old!r}")
    return src.replace(old, new)


def b1_source() -> str:
    """detect.cu with the block's thread 0 summing the cycles of each phase
    into g_clk[0..5] and counting real tiles in g_clk[7]."""
    src = (_kernels.CSRC / "detect.cu").read_text()
    src = _replace(src, "namespace {\n", "namespace {\n__device__ unsigned long long g_clk[8];\n")
    start, end = src.index("detect_kernel(const float*"), src.index("}  // namespace")
    kern = _replace(src[start:end], "  // ---- P1",
                    "  long long t_prev = clock64();\n  int ph = 0;\n  // ---- P1")
    stamp = ("{ __syncthreads(); if (tid == 0) { const long long t = clock64(); "
             "atomicAdd(&g_clk[ph], static_cast<unsigned long long>(t - t_prev)); "
             "t_prev = t; } ++ph; }")
    kern = _replace(kern, "  __syncthreads();\n", f"  {stamp}\n")
    last = kern.rindex("}\n")
    kern = kern[:last] + f"  {stamp}\n  if (tid == 0) atomicAdd(&g_clk[7], 1ull);\n" + kern[last:]
    return src[:start] + kern + src[end:] + CLOCKS


def b2_source() -> str:
    """pose_lm.cu with thread 0 of CTA 0 of problem 0 summing the cycles of
    the edge loops (g_clk[0]), the cluster reductions (g_clk[1]) and the LM
    steps between passes (g_clk[2]); g_clk[3] counts launches."""
    src = (_kernels.CSRC / "pose_lm.cu").read_text()
    src = _replace(src, "namespace {\n", "namespace {\n__device__ unsigned long long g_clk[8];\n")
    src = _replace(src, "  int n_pass = 0;",
                   "  long long c0 = 0, c1 = 0, c2 = 0, tlast = clock64();\n  int n_pass = 0;")
    src = _replace(src, "    float acc[NV];\n", "    const long long ta = clock64();\n    float acc[NV];\n")
    src = _replace(src, "    const int b = n_pass & 1;",
                   "    const long long tb = clock64();\n    c0 += tb - ta;\n    const int b = n_pass & 1;")
    src = _replace(src, "    ++n_pass;", "    ++n_pass;\n    tlast = clock64();\n    c1 += tlast - tb;")
    src = _replace(src, "      pass(Tn, huber, false, rnd, tot);",
                   "      c2 += clock64() - tlast;\n      pass(Tn, huber, false, rnd, tot);")
    src = _replace(src, "  // ---- epilogue",
                   "  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) {\n"
                   "    atomicAdd(&g_clk[0], static_cast<unsigned long long>(c0));\n"
                   "    atomicAdd(&g_clk[1], static_cast<unsigned long long>(c1));\n"
                   "    atomicAdd(&g_clk[2], static_cast<unsigned long long>(c2));\n"
                   "    atomicAdd(&g_clk[3], 1ull);\n  }\n"
                   "  // ---- epilogue")
    return src + CLOCKS


def build(src: str, tmp: pathlib.Path, name: str) -> ctypes.CDLL:
    cu, so = tmp / f"{name}.cu", tmp / f"{name}.so"
    cu.write_text(src)
    cmd = [_kernels._nvcc(), *_kernels.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
           "-shared", "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _kernels._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = list(argtypes)
    lib.clk_read.argtypes = [_P]
    return lib


def clocks(lib, fn, n: int = 50) -> list[int]:
    fn()
    torch.cuda.synchronize()
    lib.clk_zero()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 8)()
    lib.clk_read(ctypes.addressof(buf))
    return list(buf)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_clocks: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        # B1 over the 640x480 stack
        lib = build(b1_source(), tmp, "b1")
        _, _, images = chip_smoke.render(chip_smoke.FULL._replace(n_frames=1))
        dims = tuple(orb._level_dims(*images[0].shape))
        stack = orb.pyramid(torch.from_numpy(images[0]).to(dev))
        _, rows, w0 = detect.level_layout(dims)
        (gx, gy), table = detect.tile_plan(dims).grid, detect._device_table(dims, dev)
        out = torch.empty((5, rows, w0), device=dev)
        args = (stack.data_ptr(), out.data_ptr(), table.data_ptr(), len(dims), gx, gy, rows, w0,
                chip_smoke.FAST_THRESHOLD, orb.BORDER, stream)
        c = clocks(lib, lambda: lib.detect_maps_launch(*args))
        print(json.dumps({
            "kernel": "B1", "card": card, "real_tiles_per_launch": c[7] // 50,
            "cycles_per_tile_by_phase": [round(x / c[7]) for x in c[:6]],
            "phases": ["P1 window", "P2 moment rows", "P3 moment columns + Gaussian columns",
                       "P4 Harris columns + Gaussian rows", "P5 Harris rows + FAST", "P6 NMS"],
            "ms": chip_smoke._per_launch_ms(lambda: lib.detect_maps_launch(*args))}))
        # B2 at three shapes, clusters of 1 and 8
        lib = build(b2_source(), tmp, "b2")
        probs = {"edges_16": chip_smoke.pose_problem(n=16, n_outliers=0, n_pad=0),
                 "edges_2000": chip_smoke.pose_problem(),
                 "steady_2000_slots": chip_smoke.steady_problem()}
        rec = {"kernel": "B2", "card": card, "sections": ["edge loops", "cluster reduction",
                                                          "LM step, solve and exp"]}
        for name, prob in probs.items():
            T0, X, uv, valid, K, info = (torch.from_numpy(a).to(dev) for a in prob)
            E = X.shape[0]
            for cl in (1, 8):
                t = [X, uv, valid, info, K, T0, torch.empty((4, 4), device=dev),
                     torch.empty(E, dtype=torch.bool, device=dev),
                     torch.empty((), dtype=torch.int32, device=dev)]
                a = (*(x.data_ptr() for x in t), 1, E, *pose_opt_cuda.lm_plan(E, cl), stream)
                c = clocks(lib, lambda: lib.pose_lm_launch(*a))
                rec[f"{name}_cluster_{cl}"] = {
                    "cycles_per_launch": [x // c[3] for x in c[:3]],
                    "ms": chip_smoke._per_launch_ms(lambda: lib.pose_lm_launch(*a))}
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
