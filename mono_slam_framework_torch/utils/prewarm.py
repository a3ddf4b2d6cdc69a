"""Background warm of a System's first loop correction.

PyTorch counterpart of `mono_slam_framework_tpu/utils/prewarm.py`. The JAX
package warms executables because a fresh XLA compile would stall the first
keyframe event, relocalization and loop correction. Eager PyTorch compiles
nothing per shape; what a process pays the first time it runs a function on
the card is one-time set-up (CUDA modules loaded lazily, cuBLAS and
cuSOLVER handles and workspaces). This module calls a function once, in one
background daemon thread, so that such costs are paid before the System
needs them. The System asks for one thing: the essential-graph solve at
the JAX package's sizes (slam/device_io.prewarm_startup_shapes). No problem
of the System changes its size.

A request names its arguments with `Spec`s (the place of
`jax.ShapeDtypeStruct`) or `Build`s. The worker makes a Spec's tensor
itself (floats ones, masks True, integers zeros); a Build's `make(device)`
makes a well-posed one where those would not do: a graph's poses,
measurements and indices, whose zeros would make `torch.linalg.solve`
singular. Nothing is drawn from a generator, so a warm cannot move the
tracker's RANSAC draws.

Modes (`set_execute`):
  * None (default, auto): execute requests whose tensors live on a CUDA
    device; a request on the CPU is a no-op, as the JAX package's auto mode
    is on its CPU backend (the host cores are the pipeline's);
  * True: execute on any device (the CPU tests pin it to exercise the
    worker);
  * False: drain the queue without calling anything. The JAX package
    compiles ahead in this mode; eager PyTorch has nothing to compile ahead.

Each item runs with its device current (`torch.cuda.device`: a new thread's
current card is cuda:0), on the worker's own `torch.cuda.Stream`, under the
grad and inference modes of the thread that asked for it (both are
thread-local), and counts as done only once that stream is synchronized, so
`pending() == 0` means the work has finished. Best effort, as in the JAX
package: a failed warm is swallowed, and recorded in `failures()`;
`timings()` lists what each warm that ran took.
Duplicate requests are dropped by key: `id(fn)` and each leaf's shape, dtype
and device. `set_enabled(False)` turns every request into a no-op for the
whole process; a System instead asks for its warm only when its own
`SlamParameters.prewarmShapes` is set.
"""

from __future__ import annotations

import atexit
import dataclasses
import queue
import threading
import time
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Spec:
    """A tensor of `shape` and `dtype` on `device`, made by the worker:
    floats ones, bools True, integers zeros."""

    shape: tuple
    dtype: torch.dtype
    device: torch.device | str = "cpu"


@dataclasses.dataclass(frozen=True)
class Build:
    """An argument that the call site makes itself: `make(device)` returns
    it; `spec` gives its shape, dtype and device for the key."""

    spec: Spec
    make: Callable


_queue: "queue.Queue" = queue.Queue()
_seen: set = set()
_lock = threading.Lock()
_worker: threading.Thread | None = None
_enabled = True
_execute: bool | None = None
_failures: list = []
_timings: list = []
_inflight = threading.Event()
_streams: dict = {}  # device -> the worker's stream (worker thread only)


def set_enabled(flag: bool) -> None:
    """Process-wide switch: False makes every request a no-op."""
    global _enabled
    _enabled = bool(flag)


def set_execute(flag: bool | None) -> None:
    """Pin the mode: None auto (execute on CUDA), True execute, False drain."""
    global _execute
    _execute = flag


def _map(fn, x):
    """fn over the leaves of nested tuples, lists and dicts."""
    if isinstance(x, (tuple, list)):
        return type(x)(_map(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    return fn(x)


def _leaves(x) -> list:
    out: list = []
    _map(out.append, x)
    return out


def _leaf_key(x):
    if isinstance(x, Build):
        x = x.spec
    if isinstance(x, (Spec, torch.Tensor)):
        return (tuple(x.shape), str(x.dtype), str(torch.device(x.device)))
    return repr(x)


def _key_of(fn, args, kwargs):
    return (id(fn), tuple(_leaf_key(x) for x in _leaves((args, kwargs))))


def _device_of(args, kwargs) -> torch.device:
    """The first CUDA device among the request's leaves, else the CPU."""
    for x in _leaves((args, kwargs)):
        s = x.spec if isinstance(x, Build) else x
        if isinstance(s, (Spec, torch.Tensor)) and torch.device(s.device).type == "cuda":
            return torch.device(s.device)
    return torch.device("cpu")


def _make(x, device: torch.device):
    if isinstance(x, Build):
        return x.make(device)
    if isinstance(x, Spec):
        fill = torch.ones if x.dtype.is_floating_point or x.dtype == torch.bool else torch.zeros
        return fill(x.shape, dtype=x.dtype, device=x.device)
    return x


def _call(fn, args, kwargs, device: torch.device) -> None:
    fn(*_map(lambda x: _make(x, device), args), **_map(lambda x: _make(x, device), kwargs))


def _run_on_card(fn, args, kwargs, device: torch.device) -> None:
    """_call with `device` current, on the worker's stream of that device,
    then wait for that stream."""
    with torch.cuda.device(device):
        stream = _streams.get(device)
        if stream is None:
            stream = _streams[device] = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            _call(fn, args, kwargs, device)
        stream.synchronize()


def _drain() -> None:
    while True:
        fn, args, kwargs, device, grad, inference = _queue.get()
        try:
            do_exec = _execute if _execute is not None else device.type == "cuda"
            if not (_enabled and do_exec):
                continue  # drain mode, or shutdown: discard queued work
            _inflight.set()
            t0 = time.perf_counter()
            with torch.inference_mode(inference), torch.set_grad_enabled(grad):
                if device.type != "cuda":
                    _call(fn, args, kwargs, device)
                else:
                    _run_on_card(fn, args, kwargs, device)
            _timings.append((getattr(fn, "__name__", repr(fn)), (time.perf_counter() - t0) * 1e3))
        except Exception as e:  # best effort: counted, never raised
            _failures.append((getattr(fn, "__name__", repr(fn)), repr(e)))
        finally:
            _inflight.clear()
            _queue.task_done()


@atexit.register
def _shutdown() -> None:
    """Give an in-flight warm a bounded window to finish.

    Daemon threads are killed abruptly at interpreter exit, and one killed
    inside a CUDA call can crash the process. Disabling new work and
    briefly joining the worker closes most of that window."""
    global _enabled
    _enabled = False
    w = _worker
    if w is not None and w.is_alive() and _inflight.is_set():
        w.join(timeout=15.0)


def _ensure_worker() -> None:
    global _worker
    if _worker is None or not _worker.is_alive():
        _worker = threading.Thread(target=_drain, name="shape-prewarm", daemon=True)
        _worker.start()


def prewarm(fn, *args, **kwargs) -> bool:
    """Queue a background call of `fn` on the given Specs / Builds (and
    plain values). Returns False if prewarming is disabled, if auto mode
    finds no CUDA device in the request, or if this key was queued before."""
    if not _enabled:
        return False
    device = _device_of(args, kwargs)
    if _execute is None and device.type != "cuda":
        return False
    key = _key_of(fn, args, kwargs)
    with _lock:
        if key in _seen:
            return False
        _seen.add(key)
        _ensure_worker()
    _queue.put((fn, args, kwargs, device, torch.is_grad_enabled(),
                torch.is_inference_mode_enabled()))
    return True


def pending() -> int:
    """Requests queued or running; 0 once every warm has finished."""
    with _queue.mutex:
        return _queue.unfinished_tasks


def wait(timeout: float | None = None) -> bool:
    """Block until every queued warm has finished (or `timeout` seconds);
    True if none is pending."""
    with _queue.all_tasks_done:
        return _queue.all_tasks_done.wait_for(lambda: _queue.unfinished_tasks == 0, timeout)


def timings() -> list:
    """(function name, ms) of every warm that ran, in order."""
    return list(_timings)


def failures() -> list:
    """(function name, exception repr) of every warm that raised."""
    return list(_failures)
