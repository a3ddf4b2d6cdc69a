"""The benchmark of `mono_slam_framework_torch` on NVIDIA GPUs.

`python3 -m slam_bench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once. The benchmark's
files: `harness.py` (window, clock, trace, result), `port.py` (the only
module that imports the program), `world.py` (frames from the seed),
`compare.py` and `reference/` (what decides `correct`), `bounds.py` (peaks
and the kernels' work), `trace.py` (the profiler's reading),
`configs/`, `traffic/` and `metrics/` (one file per configuration, traffic
mix and per-layer metric, found by name).
"""
