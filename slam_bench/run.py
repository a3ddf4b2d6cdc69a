"""Run one cell of the benchmark once and print its result line.

    python3 -m slam_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of the repository. The program under test is
`mono_slam_framework_torch` on one NVIDIA GPU; without one (or with fewer
than the cell asks for) the run exits with code 2 and prints no result.
The last line of standard output is the result as one JSON object; the
last lines of standard error give each number the comparison read beside
its limit. A run whose process holds `jax`, `jaxlib`, `flax` or
`mono_slam_framework_tpu` once the window has closed exits with code 3 and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "mono_slam_framework_tpu")
# the program's build caches stay inside the checkout, at fixed paths
CACHES = {"TRITON_CACHE_DIR": "slam_bench/.cache/triton",
          "TORCH_EXTENSIONS_DIR": "slam_bench/.cache/torch_extensions"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted(m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    root = pathlib.Path(__file__).resolve().parent.parent
    for var, rel in CACHES.items():
        os.environ[var] = str(root / rel)
    os.environ["USE_FLAX"] = "0"
    # one process with one compute thread: the steadiest host timing
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"

    from slam_bench import harness, manifest  # noqa: E402

    bench = manifest.load_manifest(root / "BENCHMARK.json")
    cell = manifest.workload(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"slam_bench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), bench)
    found = forbidden_modules()
    if found:
        print(f"slam_bench: the process holds {found} after the window", file=sys.stderr)
        return 3
    print(json.dumps({"info": out.info, "control": out.control}), file=sys.stderr)
    for name, value in out.numbers.items():
        limit = out.result["checks"][name]["limit"]
        print(f"check {name} = {value!r} (limit {limit})", file=sys.stderr)
    print(json.dumps(out.result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
