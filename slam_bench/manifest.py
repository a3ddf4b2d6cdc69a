"""Finding a cell's files by the names in `BENCHMARK.json`.

A configuration is `configs/<config>.json`, a traffic mix
`traffic/<traffic>.json`, the entry point a mix drives `drivers/<driver>.py`
(named by the mix's `"driver"`; a class `Driver`), a per-layer metric
`metrics/<name>.py` (a module with `read(run) -> float | None`), a cell's
limits of `correct` `limits/<cell>.json` (each number's readings differ by
configuration and mix), a check `checks/<name>.py` (named by a
`<name>_checked` key of the limits; see `port.Hooks` and `compare.judge`),
and a model's work `work/<name>.py` (named by the configuration's
`"model_work"`; a module with `flops(hooks) -> float`), all beside this
file. Adding one is adding its file and its entry in the manifest.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_manifest(path=None) -> dict:
    return json.loads(pathlib.Path(path or ROOT / "BENCHMARK.json").read_text())


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(name: str) -> pathlib.Path:
    return HERE / "configs" / f"{name}.json"


def traffic_file(name: str) -> pathlib.Path:
    return HERE / "traffic" / f"{name}.json"


def limits_file(cell: str) -> pathlib.Path:
    return HERE / "limits" / f"{cell}.json"


def metric_file(name: str) -> pathlib.Path:
    return HERE / "metrics" / f"{name}.py"


def driver_file(name: str) -> pathlib.Path:
    return HERE / "drivers" / f"{name}.py"


def check_file(name: str) -> pathlib.Path:
    return HERE / "checks" / f"{name}.py"


def work_file(name: str) -> pathlib.Path:
    return HERE / "work" / f"{name}.py"


def load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def _load(kind: str, name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(f"slam_bench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str):
    """The `read` function of metrics/<name>.py."""
    return _load("metric", name, metric_file(name)).read


def driver_class(name: str):
    """The `Driver` class of drivers/<name>.py."""
    return _load("driver", name, driver_file(name)).Driver


def check_names(limits: dict) -> list[str]:
    """The checks a cell's limits name, in the file's order: each
    `<name>_checked` key names checks/<name>.py."""
    return [k[: -len("_checked")] for k in limits if k.endswith("_checked")]


def check_module(name: str):
    """checks/<name>.py, a module with `NUMBERS` (the numbers it reports),
    `wrappers(op)` and `judge(records, config, control)`."""
    path = check_file(name)
    if not path.is_file():
        raise ValueError(f"unknown check {name!r}: no {path}")
    return _load("check", name, path)


def model_work(config: dict):
    """The work file the configuration's `"model_work"` names, or None
    where it names none (a configuration without a model)."""
    name = config.get("model_work")
    return None if name is None else _load("work", name, work_file(name))


def metrics_for(manifest: dict, cell: str, kind: str) -> list[dict]:
    """The `end_to_end` or `per_layer` entries a cell reports: those with no
    `workloads` key, and those that list it."""
    return [m for m in manifest[kind] if cell in m.get("workloads", [cell])]
