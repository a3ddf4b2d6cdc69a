"""A 1-D device mesh driven from one process.

The port's form of `jax.sharding.Mesh` together with the plumbing that
`jax.shard_map` gives the JAX package's multi-device functions
(`parallel/sweep.py`, `multistream.py`'s sharded steps, `ba_sharded.py`,
`loftr_tp.py`). Their contract is one caller with the whole batch: it
passes a mesh and gets the whole result back, and a System's loop-closing
step switches its global BA to the sharded solver on its own. Under SPMD
processes (`torch.distributed`) every rank would have to enter each such
call, which a System's loop-closing step cannot arrange, so the port keeps
the JAX contract:

  * one host process issues each shard's work to that shard's device; CUDA
    launches are asynchronous, so shards on different cards overlap as long
    as nothing waits on the host between the issue and the final gather
    (copies between cards are ordered by events on the device, not by the
    host);
  * each collective of the JAX code (`psum`, `pmax`, `all_gather`) is an
    explicit reduction over per-shard partials on the mesh's first device,
    in mesh order, whose result is copied to every shard's device. The order
    is fixed, so a sharded result is the same on every run.

A mesh may name one device more than once: `["cpu"] * 8` stands for the JAX
tests' 8 virtual CPU devices, `["cuda:0"] * 4` runs four shards on one card
(every step of a sharded call, all but the traffic between cards).
"""

from __future__ import annotations

import copy

import torch

from mono_slam_framework_torch import device as device_mod


class Mesh:
    """`devices` in mesh order (repeats allowed) along one named axis."""

    def __init__(self, devices, axis: str = "data"):
        self.devices = [_indexed(torch.device(d)) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    # ---- moving data onto and off the mesh ----

    def split(self, x, dim: int = 0) -> list:
        """x cut into `size` equal blocks along `dim`, block i on device i.
        A NamedTuple of tensors splits field by field. Raises ValueError
        when the axis is not divisible by the mesh size."""
        if is_namedtuple(x):
            return [type(x)(*fields) for fields in zip(*(self.split(f, dim) for f in x))]
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(
                f"axis {dim} of size {n} does not divide over a mesh of {self.size}")
        return [b.to(d) for b, d in zip(torch.chunk(x, self.size, dim), self.devices)]

    def gather(self, parts: list, dim: int = 0):
        """The shards' blocks joined along `dim` on the first device (field by
        field for NamedTuples, nested ones included)."""
        if is_namedtuple(parts[0]):
            return type(parts[0])(*(self.gather(list(f), dim) for f in zip(*parts)))
        return torch.cat([p.to(self.first) for p in parts], dim)

    def broadcast(self, x) -> list:
        """x on every shard's device, one copy per distinct device."""
        copies = {}
        return [copies.setdefault(d, x.to(d)) for d in self.devices]

    def replicate(self, module: torch.nn.Module) -> list:
        """A module (weights) on every shard's device: the module itself where
        it already lies, one copy per other distinct device."""
        copies = {next(module.parameters()).device: module}
        for d in self.devices:
            if d not in copies:
                copies[d] = copy.deepcopy(module).to(d)
        return [copies[d] for d in self.devices]

    # ---- collectives over per-shard partials ----

    def reduce_sum(self, parts: list) -> torch.Tensor:
        """The sum of the shards' partials on the first device, added in mesh
        order. One partial on the first device comes back as it is."""
        out = parts[0].to(self.first)
        for p in parts[1:]:
            out = out + p.to(self.first)
        return out

    def reduce_max(self, parts: list) -> torch.Tensor:
        out = parts[0].to(self.first)
        for p in parts[1:]:
            out = torch.maximum(out, p.to(self.first))
        return out

    def psum(self, parts: list) -> list:
        """`lax.psum`: the sum of the partials, on every shard's device."""
        return self.broadcast(self.reduce_sum(parts))

    def pmax(self, parts: list) -> list:
        """`lax.pmax`: the elementwise max of the partials on every shard."""
        return self.broadcast(self.reduce_max(parts))

    def all_gather(self, parts: list, dim: int = 0) -> list:
        """`lax.all_gather(tiled=True)`: the blocks joined along `dim`, on
        every shard's device."""
        return self.broadcast(self.gather(parts, dim))


def _indexed(d: torch.device) -> torch.device:
    """`cuda` as the card it names now (`cuda:<current>`), so that equal
    devices compare equal."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def make_mesh(n_devices: int | None = None, axis: str = "data", devices=None) -> Mesh:
    """A mesh over every visible card, the first `n_devices` of them when
    that is given, or over `devices` (an explicit list; repeats allowed).
    Without a card, and with no `devices`, it raises: it never builds a
    mesh on the CPU unless asked to."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() needs a CUDA card; pass devices=['cpu'] * n for a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    return Mesh([device_mod.resolve(d) for d in devices], axis)

