"""The port held to the JAX package as a whole: its surface, its kernels and
its device defaults. Imports and `ast` only; nothing is compiled or driven.

(a) Surface. For each Python module of the JAX package (pkgutil's walk; the
    native libraries are not Python modules), every public function and
    class defined there, every public method, property, staticmethod and
    classmethod of those classes, and every name of the module's `__all__`
    is an attribute of the same name and kind on the port's module at the
    same path, or has an entry in COUNTERPARTS (the port's name for it) or in
    NOT_PORTED (each entry a bullet of ROADMAP.md's "Not ported"). No entry of
    either table is stale. The port's command-line apps take every option of
    the JAX apps, and no other but `--device`.
(b) Kernels. Every `pallas_call` in the JAX package's source, resolved to its
    kernel's `def` through the `functools.partial` that binds it, is replaced
    by one record of chip_smoke.py's `kernels` line, and each record's source
    is a file of the port's `csrc/`. Both are read with `ast`.
(c) Device defaults. No public function, method or class of the port gives a
    parameter `device` a default other than `device.DEFAULT` (the card), but
    the entries of CPU_DEFAULTS.
"""

import argparse
import ast
import functools
import importlib
import importlib.machinery
import importlib.util
import inspect
import pathlib
import pkgutil
import re
from unittest import mock

import pytest
import torch

import mono_slam_framework_torch as port_pkg
import mono_slam_framework_tpu as jax_pkg
from mono_slam_framework_torch import device as device_mod
from mono_slam_framework_torch.models import loftr_native as pln

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX, PORT = jax_pkg.__name__, port_pkg.__name__
N_JAX_MODULES = 67

# JAX name -> (the port's name for it, why it differs). "module:attr.path".
COUNTERPARTS = {
    "models.loftr_native:load_params": (
        "models.loftr_native:load_model",
        "the weights load into the LoftrCoarse module on a device, not a dict of arrays"),
    "models.loftr_native:backbone": (
        "models.loftr_native:LoftrCoarse.backbone",
        "the CNN is the module LoftrCoarse().backbone, whose forward is the JAX function"),
    "optim:bundle_adjust": (
        "optim.bundle_adjust:bundle_adjust",
        "the JAX optim/__init__ re-export of the function shadows its submodule; "
        "the port keeps the submodule under that name"),
    "parallel.server:chain_T_init_batch": (
        "slam.fused_tracking:chain_T_init",
        "the port's chain_T_init takes a leading stream axis as it is, with no vmap"),
}

# JAX name -> why the port has no counterpart (ROADMAP.md, "Not ported").
NOT_PORTED = {
    "ops.pallas_detect": "the Pallas detection kernels B1, B1-banded and B1-full: on the "
                         "card csrc/detect.cu, through ops/detect.py",
    "optim.pose_opt_pallas": "the Pallas pose LM, kernel B2: on the card csrc/pose_lm.cu, "
                             "through optim/pose_opt_cuda.py",
    "utils.buckets": "shape-bucket ladders: eager PyTorch compiles nothing per shape, so "
                     "every problem keeps its own size",
    "estimation.epnp:prewarm_shapes": "a compile-cache warm of EPnP's ladder rungs",
    "estimation.initializer:Initializer.prewarm_shapes": "a compile-cache warm of the "
                                                         "initializer's shapes",
    "matchers.orb_matcher:OrbFeatureMatcher.prewarm_match_many": "a compile-cache warm of "
                                                                 "batched matching's rungs",
}

# the four Pallas kernels (their defs) and the files of the port that replace them
PALLAS_KERNELS = [
    "mono_slam_framework_tpu/ops/pallas_detect.py:202",
    "mono_slam_framework_tpu/ops/pallas_detect.py:215",
    "mono_slam_framework_tpu/ops/pallas_detect.py:306",
    "mono_slam_framework_tpu/optim/pose_opt_pallas.py:203",
]
KERNEL_RECORD_KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                      "plain_ms", "bound_ms", "bound_by", "library_ms"}

# port "module:attr" -> why its `device` defaults to the CPU
CPU_DEFAULTS = {
    "utils.prewarm:Spec": "a field of the warm's description of a tensor (the place of "
                          "jax.ShapeDtypeStruct, which has no device), not an entry point; "
                          "the System's one request passes its device",
}

CLI_APPS = ("run", "ab_sweep", "interactive", "quality_bench")


def _python_modules(pkg) -> list:
    """Dotted names, relative to `pkg`, of its Python modules."""
    names = []
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        spec = info.module_finder.find_spec(info.name)
        if isinstance(spec.loader, importlib.machinery.ExtensionFileLoader):
            continue
        if "._build" not in info.name:
            names.append(info.name[len(pkg.__name__) + 1:])
    return sorted(names)


JAX_MODULES = _python_modules(jax_pkg)


def _split(key: str):
    mod, _, attr = key.partition(":")
    return mod, attr


def _port_module(rel: str):
    try:
        return importlib.import_module(f"{PORT}.{rel}")
    except ModuleNotFoundError as e:
        if e.name != f"{PORT}.{rel}":
            raise
        return None


def _kind(obj) -> str:
    if isinstance(obj, (staticmethod, classmethod)):
        obj = obj.__func__
    if isinstance(obj, property):
        return "property"
    if inspect.ismodule(obj):
        return "module"
    if inspect.isclass(obj):
        return "class"
    return "callable" if callable(obj) else "value"


def _resolve(module, path: str):
    """`module`'s attribute at the dotted `path`. An `nn.Module` class's
    submodules, which each instance sets, are looked up on an instance made
    with no arguments; a package's submodule is imported. Raises
    AttributeError."""
    obj = module
    for part in path.split("."):
        if inspect.isclass(obj) and issubclass(obj, torch.nn.Module) and not hasattr(obj, part):
            obj = obj()
        if hasattr(obj, "__path__") and not hasattr(obj, part):  # a package
            if importlib.util.find_spec(f"{obj.__name__}.{part}") is not None:
                importlib.import_module(f"{obj.__name__}.{part}")
        obj = inspect.getattr_static(obj, part) if inspect.isclass(obj) else getattr(obj, part)
    return obj


def _defined_here(obj, module) -> bool:
    return (callable(obj) or isinstance(obj, property)) and \
        getattr(obj, "__module__", None) == module.__name__


def _surface(module) -> dict:
    """name -> object: the public functions and classes `module` defines,
    their public methods and properties, and its `__all__`."""
    out = {name: getattr(module, name) for name in getattr(module, "__all__", ())}
    for name, obj in vars(module).items():
        if name.startswith("_") or not _defined_here(obj, module):
            continue
        out[name] = obj
        if inspect.isclass(obj):
            for attr, v in vars(obj).items():
                if not attr.startswith("_") and not inspect.isclass(v) and (
                        callable(v) or isinstance(v, (staticmethod, classmethod, property))):
                    out[f"{name}.{attr}"] = v
    return out


# ---------------------------------------------------------------------------
# (a) surface


def test_the_walk_finds_every_jax_module():
    # a subpackage that fails to import drops its modules from the walk
    assert len(JAX_MODULES) == N_JAX_MODULES, JAX_MODULES
    files = [p.relative_to(ROOT / JAX).with_suffix("").parts for p in (ROOT / JAX).rglob("*.py")]
    names = {".".join(f[:-1] if f[-1] == "__init__" else f) for f in files}
    assert sorted(names - {""}) == JAX_MODULES


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_module_surface(rel):
    jmod = importlib.import_module(f"{JAX}.{rel}")
    pmod = _port_module(rel)
    if rel in NOT_PORTED:
        assert pmod is None, f"{rel} is ported now: take it out of NOT_PORTED"
        for path in re.findall(r"csrc/\w+\.cu", NOT_PORTED[rel]):
            assert (ROOT / PORT / path).is_file(), path
        return
    assert pmod is not None, f"the port has no module {rel}"
    missing = []
    for name, obj in _surface(jmod).items():
        key = f"{rel}:{name}"
        if key in COUNTERPARTS or key in NOT_PORTED:
            continue
        try:
            mine = _resolve(pmod, name)
        except AttributeError:
            missing.append(name)
            continue
        assert _kind(mine) == _kind(obj), (key, _kind(mine), _kind(obj))
    assert not missing, f"{rel}: no counterpart of {missing}"


@pytest.mark.parametrize("key", sorted(COUNTERPARTS) + sorted(k for k in NOT_PORTED if ":" in k))
def test_table_entry_is_not_stale(key):
    rel, name = _split(key)
    assert rel in JAX_MODULES, key
    jmod = importlib.import_module(f"{JAX}.{rel}")
    assert name in _surface(jmod), f"the JAX package defines no {key}"
    pmod = _port_module(rel)
    if pmod is not None:
        try:
            mine = _resolve(pmod, name)
        except AttributeError:
            mine = None
        assert mine is None or _kind(mine) != _kind(_surface(jmod)[name]), \
            f"the port has {key} now: take it out of the table"
    if key in COUNTERPARTS:
        target, reason = COUNTERPARTS[key]
        trel, tname = _split(target)
        assert reason and _resolve(importlib.import_module(f"{PORT}.{trel}"), tname) is not None
    else:
        assert NOT_PORTED[key]


def _options(module) -> dict:
    """option string (or positional dest) -> choices, of the parser that
    `module.main` builds; empty where the module builds none (the JAX
    quality_bench reads only its environment)."""
    if "ArgumentParser" not in inspect.getsource(module):
        return {}

    class Parsed(Exception):
        pass

    def capture(parser, *args, **kwargs):
        raise Parsed(parser)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", capture):
        with pytest.raises(Parsed) as caught:
            module.main([])
    parser = caught.value.args[0]
    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._HelpAction):
            continue
        for key in action.option_strings or [action.dest]:
            out[key] = set(action.choices or ())
    return out


@pytest.mark.parametrize("app", CLI_APPS)
def test_cli_takes_the_jax_options(app):
    theirs = _options(importlib.import_module(f"{JAX}.{app}"))
    mine = _options(importlib.import_module(f"{PORT}.{app}"))
    assert set(theirs) <= set(mine), sorted(set(theirs) - set(mine))
    assert set(mine) - set(theirs) <= {"--device"}, sorted(set(mine) - set(theirs))
    for key, choices in theirs.items():
        assert choices <= mine[key], (key, choices - mine[key])


# ---------------------------------------------------------------------------
# (b) kernels


def _call_name(func) -> str | None:
    if isinstance(func, ast.Attribute):
        return func.attr
    return func.id if isinstance(func, ast.Name) else None


@functools.cache
def _pallas_kernels() -> list:
    """'path:line' of the kernel def of every pallas_call in the JAX
    package, one per call."""
    found = []
    for path in sorted((ROOT / JAX).rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        defs = {n.name: n.lineno for n in tree.body if isinstance(n, ast.FunctionDef)}
        scopes = [tree] + [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)]
        for scope in scopes:  # each call is read in its innermost function, or the module
            inner = {id(n) for f in ast.walk(scope)
                     if f is not scope and isinstance(f, ast.FunctionDef) for n in ast.walk(f)}
            nodes = [n for n in ast.walk(scope) if id(n) not in inner]
            partials = [(n.lineno, t.id, n.value) for n in nodes if isinstance(n, ast.Assign)
                        for t in n.targets if isinstance(t, ast.Name)
                        and isinstance(n.value, ast.Call) and _call_name(n.value.func) == "partial"]
            for call in nodes:
                if not (isinstance(call, ast.Call) and _call_name(call.func) == "pallas_call"):
                    continue
                kernel = call.args[0]
                if isinstance(kernel, ast.Name):  # the nearest partial bound to that name above
                    bound = [(line, v) for line, name, v in partials
                             if name == kernel.id and line < call.lineno]
                    kernel = max(bound, key=lambda b: b[0])[1] if bound else kernel
                if isinstance(kernel, ast.Call) and _call_name(kernel.func) == "partial":
                    kernel = kernel.args[0]
                where = f"{path.relative_to(ROOT)}:{call.lineno}"
                assert isinstance(kernel, ast.Name) and kernel.id in defs, \
                    f"the pallas_call at {where} names no kernel def of its module"
                found.append(f"{path.relative_to(ROOT)}:{defs[kernel.id]}")
    return sorted(found)


@functools.cache
def _chip_smoke_kernel_records() -> list:
    """The records of chip_smoke.py's `kernels` line: each record's keys,
    with the constant values."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    lists = [v for node in ast.walk(tree) if isinstance(node, ast.Dict)
             for k, v in zip(node.keys, node.values)
             if isinstance(k, ast.Constant) and k.value == "kernels" and isinstance(v, ast.List)]
    assert len(lists) == 1, "chip_smoke.py prints one kernels line"
    return [{k.value: (v.value if isinstance(v, ast.Constant) else v)
             for k, v in zip(d.keys, d.values)} for d in lists[0].elts]


def test_the_jax_package_has_four_pallas_kernels():
    assert _pallas_kernels() == PALLAS_KERNELS


def test_chip_smoke_replaces_every_pallas_kernel():
    records = _chip_smoke_kernel_records()
    assert sorted(r["replaces"] for r in records) == _pallas_kernels()
    for r in records:
        assert KERNEL_RECORD_KEYS <= set(r), (r["name"], KERNEL_RECORD_KEYS - set(r))
        assert r["route"] in ("cuda", "triton"), r["name"]


def test_every_kernel_source_is_in_the_port():
    for r in _chip_smoke_kernel_records():
        source = pathlib.Path(r["source"])
        assert source.parent == pathlib.Path(PORT, "csrc"), r["source"]
        assert (ROOT / source).is_file(), r["source"]


# ---------------------------------------------------------------------------
# (c) device defaults


def _port_callables():
    """('module:name', callable) of each public function, class and method
    the port defines."""
    for rel in _python_modules(port_pkg):
        module = importlib.import_module(f"{PORT}.{rel}")
        for name, obj in vars(module).items():
            if name.startswith("_") or not _defined_here(obj, module):
                continue
            yield f"{rel}:{name}", obj
            if inspect.isclass(obj):
                for attr, v in vars(obj).items():
                    v = v.__func__ if isinstance(v, (staticmethod, classmethod)) else v
                    if not attr.startswith("_") and inspect.isfunction(v):
                        yield f"{rel}:{name}.{attr}", v


def test_device_defaults_to_the_card():
    cpu, checked = [], 0
    for key, fn in _port_callables():
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):  # a builtin without a signature
            continue
        p = sig.parameters.get("device")
        if p is None:
            continue
        checked += 1
        if p.default is not p.empty and p.default != device_mod.DEFAULT:
            cpu.append(key)
    assert checked > 20  # the walk reached the entry points
    assert sorted(cpu) == sorted(CPU_DEFAULTS), sorted(set(cpu) ^ set(CPU_DEFAULTS))


def test_positional_encoding_defaults_to_the_card():
    if torch.cuda.is_available():
        assert pln.positional_encoding(15, 20).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            pln.positional_encoding(15, 20)
    assert pln.positional_encoding(15, 20, device="cpu").device.type == "cpu"
