"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level module names (the port's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

from slam_bench import run

HERE = pathlib.Path(__file__).resolve().parent.parent
MODULES = ["slam_bench.run", "slam_bench.harness", "slam_bench.port", "slam_bench.compare",
           "slam_bench.control", "slam_bench.trace", "slam_bench.bounds", "slam_bench.world",
           "slam_bench.reference.pose_lm", "slam_bench.reference.detect", "slam_bench.reference.loftr",
           "slam_bench.reference.hamming", "slam_bench.reference.ate"]


def test_whole_names_not_prefixes():
    sys.modules["mono_slam_framework_torch_probe"] = sys
    try:
        assert "mono_slam_framework_torch_probe" not in run.forbidden_modules()
    finally:
        del sys.modules["mono_slam_framework_torch_probe"]


def test_harness_loads_no_jax():
    code = ("import sys, importlib\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "import pathlib\n"
            "from slam_bench import manifest\n"
            "for p in (manifest.HERE / 'metrics').glob('*.py'): manifest.metric_reader(p.stem)\n"
            "for p in (manifest.HERE / 'drivers').glob('*.py'): manifest.driver_class(p.stem)\n"
            "from slam_bench.run import forbidden_modules\n"
            "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent, capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_sources_import_neither_jax_nor_the_jax_package():
    """Also the references import nothing of the program."""
    for path in HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        tops = {n.split(".")[0] for n in names}
        assert not tops & set(run.FORBIDDEN), path
        if "reference" in path.parts:
            assert "mono_slam_framework_torch" not in tops, path
