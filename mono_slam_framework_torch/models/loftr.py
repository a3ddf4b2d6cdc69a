"""LoFTR coarse matcher: ONNX-graph interpreter (the golden oracle).

PyTorch counterpart of `mono_slam_framework_tpu/models/loftr.py`. The
runtime model is models/loftr_native.py (hand-written forward, repo-owned
weights). This interpreter executes an ONNX export of the coarse model op by
op, with the weights taken from the graph's initializers; it is on no
runtime path. On the reference export it is the independent check of the
native forward. On the graphs tests/torch_onnx_graphs.py writes, which encode
the native forward's own decoding, it is held against the JAX interpreter and
the card against the CPU (tests/test_torch_onnx_oracle.py, chip_smoke.py's
`onnx_oracle` phase); the native comparison there checks the writer.

The reference runs model/LoFTR_teacher.onnx through ONNX Runtime on CPU
(src/dnnfeaturematcher.cpp:50-74): inputs two [1,1,480,640] f32 images,
output a [1,1200,1200] coarse confidence matrix over 16px cells (ResNet-FPN
backbone, positional encoding, 4x(self+cross) linear-attention blocks, dual
softmax — graph census: 21 Conv, 65 MatMul, 16 Elu, 2 Softmax).

Semantics are the JAX interpreter's, not the ONNX specification's, where the
two differ (Reshape has no "0 copies the dimension" rule, Softmax runs along
its axis at every opset, Squeeze without axes squeezes every size-1 axis).
Values are host numpy arrays or tensors on the model's device: shape
subgraphs (Shape / Slice / Concat / Cast and host arithmetic feeding a
Reshape) stay numpy with concrete ints, and a host value that meets a device
op becomes a tensor canonicalised as JAX does with x64 off (float64 ->
float32, int64 -> int32).

Precision: the oracle is the f32 reference on every device. Products and
convolutions take f32 operands, never bf16, and TF32 stays off (the port's
pin in `mono_slam_framework_torch/__init__.py`) — unlike the native forward's
bf16 products on a card (`loftr_native._lowp`); the JAX package runs its
interpreter under its global "highest" matmul precision. The JAX package
jits the whole graph into one program; the port runs it eagerly, op by op.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from mono_slam_framework_torch import device as device_mod
from mono_slam_framework_torch.models.onnx_reader import OnnxGraph, load_graph

_REDUCE_OPS = {"ReduceSum": torch.sum, "ReduceMean": torch.mean}
_HOST_BINARY = {"Add": np.add, "Sub": np.subtract, "Mul": np.multiply,
                "Div": np.divide, "Pow": np.power}
_DEVICE_BINARY = {"Add": torch.add, "Sub": torch.sub, "Mul": torch.mul,
                  "Div": torch.div, "Pow": torch.pow}
# ONNX TensorProto.DataType of Cast's `to`, float32 for any other code; on the
# host as numpy casts, on the device as JAX casts with x64 off
_CAST_HOST = {1: np.float32, 6: np.int32, 7: np.int64, 11: np.float64, 9: np.bool_}
_CAST_DEVICE = {1: torch.float32, 6: torch.int32, 7: torch.int32, 11: torch.float32,
                9: torch.bool}
# JAX's dtype canonicalisation with x64 off
_X64_OFF = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
            np.dtype(np.uint64): np.uint32}
_INT32_MAX = int(np.iinfo(np.int32).max)


def _is_host(v) -> bool:
    return isinstance(v, np.ndarray)


def _to_device(v, device) -> torch.Tensor:
    """A value as a tensor on `device`; a host value (numpy array or scalar)
    canonicalised as JAX canonicalises it with x64 off."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    a = np.asarray(v)
    a = a.astype(_X64_OFF.get(a.dtype, a.dtype))
    return torch.from_numpy(np.array(a)).to(device)


def _host_list(v) -> list:
    """A shape-like argument (host array or tensor) as a list of ints."""
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return np.asarray(v).tolist()


def _slice_axis(x: torch.Tensor, axis: int, start, stop, step) -> torch.Tensor:
    """x[start:stop:step] along one axis with numpy's semantics, negative
    steps included (torch slicing takes positive steps only)."""
    lo, hi, st = slice(start, stop, step).indices(x.shape[axis])
    lead = (slice(None),) * axis
    if st > 0:
        return x[lead + (slice(lo, hi, st),)]
    n = len(range(lo, hi, st))
    first = x.shape[axis] - 1 - lo  # lo's place on the flipped axis
    return x.flip(axis)[lead + (slice(first, first + n * -st if n else first, -st),)]


def _squeeze(x: torch.Tensor, axes) -> torch.Tensor:
    """jnp.squeeze: every size-1 axis without axes; raises on a named axis
    whose size is not 1 (torch.squeeze would keep it silently)."""
    if not axes:
        return x.squeeze()
    dims = sorted({a % x.ndim for a in axes})
    for a in dims:
        if x.shape[a] != 1:
            raise ValueError(f"cannot select an axis to squeeze out which has size "
                             f"not equal to one, got shape={tuple(x.shape)} and "
                             f"dimensions={tuple(axes)}")
    for a in reversed(dims):
        x = x.squeeze(a)
    return x


def _reduce(f, x: torch.Tensor, axes, keep: bool) -> torch.Tensor:
    dims = tuple(axes) if axes else tuple(range(x.ndim))
    if f is torch.mean and not x.is_floating_point():
        x = x.to(torch.float32)
    if f is torch.sum and not x.is_floating_point():
        # jnp.sum keeps an integer width (bool sums as int32); torch widens to int64
        dt = torch.int32 if x.dtype == torch.bool else x.dtype
        return torch.sum(x, dim=dims, keepdim=keep, dtype=dt)
    return f(x, dim=dims, keepdim=keep)


def _run_node(node, env, params, device):
    op = node.op_type
    ins = [env[i] if i in env else params[i] for i in node.inputs if i]

    def dev(v):
        return _to_device(v, device)

    if op == "Constant":
        out = node.attrs.get("value")
        if out is None:
            out = np.asarray(node.attrs.get("value_float", 0.0), np.float32)
        return [np.asarray(out)]
    if op == "Shape":
        return [np.asarray(tuple(ins[0].shape), np.int64)]
    if op in _HOST_BINARY:
        a, b = ins
        if _is_host(a) and _is_host(b):
            return [_HOST_BINARY[op](a, b)]
        return [_DEVICE_BINARY[op](dev(a), dev(b))]
    if op == "Sqrt":
        return [np.sqrt(ins[0]) if _is_host(ins[0]) else torch.sqrt(dev(ins[0]))]
    if op == "Relu":
        x = dev(ins[0])
        return [torch.relu(x if x.is_floating_point() else x.to(torch.float32))]
    if op == "Elu":
        alpha = node.attrs.get("alpha", 1.0) or 1.0
        x = dev(ins[0])
        return [torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))]
    if op == "Cast":
        to = node.attrs.get("to", 1)
        x = ins[0]
        if _is_host(x):
            return [x.astype(_CAST_HOST.get(to, np.float32))]
        return [dev(x).to(_CAST_DEVICE.get(to, torch.float32))]
    if op == "Concat":
        axis = node.attrs.get("axis", 0)
        if all(_is_host(v) for v in ins):
            return [np.concatenate(ins, axis=axis)]
        return [torch.cat([dev(v) for v in ins], dim=axis)]
    if op == "Split":
        axis = node.attrs.get("axis", 0)
        n_out = len(node.outputs)
        x = dev(ins[0])
        if x.shape[axis] % n_out:
            raise ValueError("array split does not result in an equal division: "
                             f"{x.shape[axis]} into {n_out}")
        return list(torch.split(x, x.shape[axis] // n_out, dim=axis))
    if op == "Reshape":
        x, shape = ins
        shape = np.asarray(_host_list(shape)).astype(np.int64).tolist()
        return [x.reshape(shape)]
    if op == "Transpose":
        x = dev(ins[0])
        perm = node.attrs.get("perm")
        return [x.permute(tuple(perm) if perm is not None else tuple(reversed(range(x.ndim))))]
    if op in ("Squeeze", "Unsqueeze"):
        axes = node.attrs.get("axes")
        if axes is None and len(ins) > 1:
            axes = _host_list(ins[1])
        x = ins[0]
        if op == "Squeeze":
            return [_squeeze(dev(x), axes)]
        for a in sorted(axes):
            x = np.expand_dims(x, a) if _is_host(x) else torch.unsqueeze(x, a)
        return [x]
    if op == "Slice":
        # opset-10+ style: data, starts, ends, axes, steps as inputs
        x = ins[0]
        starts = _host_list(ins[1])
        ends = _host_list(ins[2])
        axes = _host_list(ins[3]) if len(ins) > 3 else list(range(len(starts)))
        steps = _host_list(ins[4]) if len(ins) > 4 else [1] * len(starts)
        sl = [slice(None)] * x.ndim
        for s, e, a, st in zip(starts, ends, axes, steps):
            sl[a] = slice(s, min(e, _INT32_MAX), st)
        if _is_host(x):
            return [x[tuple(sl)]]
        for a, s in enumerate(sl):
            if s != slice(None):
                x = _slice_axis(x, a, s.start, s.stop, s.step)
        return [x]
    if op in _REDUCE_OPS:
        axes = node.attrs.get("axes")
        if axes is None and len(ins) > 1:
            axes = _host_list(ins[1])
        keep = bool(node.attrs.get("keepdims", 1))
        return [_reduce(_REDUCE_OPS[op], dev(ins[0]), axes, keep)]
    if op == "MatMul":
        a, b = (dev(v).to(torch.float32) for v in ins)
        return [torch.matmul(a, b)]
    if op == "Softmax":
        axis = node.attrs.get("axis", -1)
        return [torch.softmax(dev(ins[0]), dim=axis)]
    if op == "Conv":
        x, w = dev(ins[0]), dev(ins[1])
        b = dev(ins[2]) if len(ins) > 2 else None
        strides = node.attrs.get("strides") or [1, 1]
        pads = node.attrs.get("pads") or [0, 0, 0, 0]  # [top, left, bottom, right]
        dil = node.attrs.get("dilations") or [1, 1]
        groups = node.attrs.get("group", 1) or 1
        if pads[0] == pads[2] and pads[1] == pads[3]:
            padding = (pads[0], pads[1])
        else:
            x = F.pad(x, (pads[1], pads[3], pads[0], pads[2]))
            padding = (0, 0)
        out = F.conv2d(x, w, None, stride=tuple(strides), padding=padding,
                       dilation=tuple(dil), groups=groups)
        if b is not None:
            out = out + b[None, :, None, None]
        return [out]
    raise NotImplementedError(f"ONNX op not supported: {op}")


@torch.no_grad()
def execute_graph(graph: OnnxGraph, params: dict, feeds: dict, device=device_mod.DEFAULT):
    """Run the graph on `device` (the card unless the caller asks for the
    CPU); `feeds` maps input names to tensors or host arrays."""
    device = device_mod.resolve(device)
    env: dict = dict(feeds)
    for node in graph.nodes:
        outs = _run_node(node, env, params, device)
        for name, val in zip(node.outputs, outs):
            env[name] = val
    return [env[o] for o in graph.outputs]


class LoftrModel:
    """A loaded LoFTR_teacher graph run op by op on `device` (the card
    unless the caller asks for the CPU)."""

    def __init__(self, onnx_path: str, device=device_mod.DEFAULT):
        self.device = device_mod.resolve(device)
        self.graph = load_graph(onnx_path)
        # float weights live on the device; integer shape tensors stay host
        # numpy so Reshape targets remain concrete
        self.params = {
            k: torch.from_numpy(np.array(v)).to(self.device)
            for k, v in self.graph.initializers.items()
            if v.dtype in (np.float32, np.float16)
        }
        self._host_consts = {
            k: v
            for k, v in self.graph.initializers.items()
            if v.dtype not in (np.float32, np.float16)
        }

    def confidence(self, img0, img1) -> torch.Tensor:
        """img0/img1: [1,1,H,W] f32 in [0,1] -> [1, L, L] confidence."""
        feeds = {"img0": _to_device(img0, self.device),
                 "img1": _to_device(img1, self.device)}
        merged = {**self._host_consts, **self.params}
        return execute_graph(self.graph, merged, feeds, self.device)[0]


@functools.lru_cache(maxsize=1)
def default_model(path: str, device=device_mod.DEFAULT) -> LoftrModel:
    """Interpreter for an explicit .onnx path.

    The runtime model is models/loftr_native.py (repo-owned weights); this
    interpreter remains the golden oracle the native forward is held against
    when an ONNX export is present.
    """
    return LoftrModel(path, device)
