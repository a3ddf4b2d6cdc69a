"""ONNX files written for the LoFTR oracle's tests and chip_smoke.py.

The reference export (model/LoFTR_teacher.onnx) is not in the repo, so the
tests of both packages' ONNX readers and interpreters read files written
here, in the protobuf wire format of the public onnx.proto3 schema (numpy
and struct only; this module imports neither JAX nor the port):

* `reader_graph()`: nodes whose attributes take every type the readers parse
  (FLOAT, INT, STRING, TENSOR, FLOATS, INTS; packed and unpacked, negative
  ints) and tensors in every encoding (`raw_data`, packed and repeated
  `float_data`, packed and repeated `int64_data` and `int32_data`);
* `op_graph(...)`: one node over named graph inputs, for per-op parity;
* `loftr_coarse_graph(h, w, npz, tool)`: the coarse LoFTR forward as
  `loftr_native`'s docstring decodes it — both images concatenated on the
  batch axis through the backbone once, a Split, the positional encoding
  added as Constant "248", four layers [self, cross, self, cross] with
  sequential cross, elu+1 linear attention, LayerNorm built from ReduceMean /
  Sub / Pow / Sqrt / Div, the dual softmax — under the exporter's initializer
  names (the maps of `tool`, tools/torch_extract_loftr_weights.py as its
  callers import it; each layer's second application under the
  `_COARSE_DUP` names). Its census is the real
  export's: 21 Conv, 65 MatMul, 16 Elu, 2 Softmax.
"""

from __future__ import annotations

import math
import pathlib
import struct

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOFTR_CENSUS = {"Conv": 21, "MatMul": 65, "Elu": 16, "Softmax": 2}
C = 32
ATTN_EPS = 1e-6
LN_EPS = 1e-7
TEMPERATURE = 0.1

# ONNX TensorProto.DataType
_CODES = {np.dtype(np.float32): 1, np.dtype(np.uint8): 2, np.dtype(np.int8): 3,
          np.dtype(np.uint16): 4, np.dtype(np.int16): 5, np.dtype(np.int32): 6,
          np.dtype(np.int64): 7, np.dtype(np.bool_): 9, np.dtype(np.float16): 10,
          np.dtype(np.float64): 11, np.dtype(np.uint32): 12, np.dtype(np.uint64): 13}


# ---- protobuf wire format ----

def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # negative ints as 64-bit two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _vint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _bytes(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _str(field: int, s: str) -> bytes:
    return _bytes(field, s.encode())


def _fixed32(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


class Tensor:
    """An array and the TensorProto encoding it is written in: "raw",
    "float_packed", "float_repeated", "int64_packed", "int64_repeated",
    "int32_packed" or "int32_repeated"."""

    def __init__(self, array, encoding: str = "raw"):
        self.array = np.asarray(array)
        self.encoding = encoding


class Ints(list):
    """An INTS attribute written unpacked (one varint per value)."""


class Floats(list):
    """A FLOATS attribute written unpacked (one fixed32 per value)."""


def tensor_proto(t, name: str = "") -> bytes:
    t = t if isinstance(t, Tensor) else Tensor(t)
    a, enc = t.array, t.encoding
    out = b"".join(_vint(1, d) for d in a.shape) + _vint(2, _CODES[a.dtype])
    flat = a.reshape(-1)
    if enc == "raw":
        out += _bytes(9, a.tobytes())
    elif enc == "float_packed":
        out += _bytes(4, flat.astype("<f4").tobytes())
    elif enc == "float_repeated":
        out += b"".join(_fixed32(4, float(v)) for v in flat)
    elif enc in ("int64_packed", "int32_packed"):
        out += _bytes(7 if enc == "int64_packed" else 5,
                      b"".join(_varint(int(v)) for v in flat))
    elif enc in ("int64_repeated", "int32_repeated"):
        out += b"".join(_vint(7 if enc == "int64_repeated" else 5, int(v)) for v in flat)
    else:
        raise ValueError(enc)
    return out + (_str(8, name) if name else b"")


def attribute_proto(name: str, v) -> bytes:
    """AttributeProto; the type follows the Python value."""
    out = _str(1, name)
    if isinstance(v, (bool, int, np.integer)):
        return out + _vint(3, int(v)) + _vint(20, 2)
    if isinstance(v, (float, np.floating)):
        return out + _fixed32(2, float(v)) + _vint(20, 1)
    if isinstance(v, str):
        return out + _str(4, v) + _vint(20, 3)
    if isinstance(v, (Tensor, np.ndarray)):
        return out + _bytes(5, tensor_proto(v)) + _vint(20, 4)
    if isinstance(v, Floats):
        return out + b"".join(_fixed32(7, x) for x in v) + _vint(20, 6)
    if isinstance(v, Ints):
        return out + b"".join(_vint(8, int(x)) for x in v) + _vint(20, 7)
    if isinstance(v, (list, tuple)) and v and all(isinstance(x, float) for x in v):
        return out + _bytes(7, np.asarray(v, "<f4").tobytes()) + _vint(20, 6)
    if isinstance(v, (list, tuple)):
        return out + _bytes(8, b"".join(_varint(int(x)) for x in v)) + _vint(20, 7)
    raise TypeError(f"attribute {name}: {type(v)}")


class GraphWriter:
    """Nodes, initializers, graph inputs and outputs, written as a
    ModelProto."""

    def __init__(self):
        self.nodes: list[bytes] = []
        self.inits: list[bytes] = []
        self.inputs: list[str] = []
        self.outputs: list[str] = []
        self._n = 0

    def name(self) -> str:
        self._n += 1
        return f"v{self._n}"

    def init(self, name: str, array, encoding: str = "raw") -> str:
        self.inits.append(tensor_proto(Tensor(array, encoding), name))
        return name

    def node(self, op: str, inputs, outputs=1, name: str | None = None, **attrs):
        """Appends one node; returns its output name (or names, when
        `outputs` is a count above 1 or a list)."""
        outs = outputs if isinstance(outputs, list) else [self.name() for _ in range(outputs)]
        body = b"".join(_str(1, i) for i in inputs) + b"".join(_str(2, o) for o in outs)
        body += _str(3, name if name is not None else f"{op}_{len(self.nodes)}") + _str(4, op)
        body += b"".join(_bytes(5, attribute_proto(k, v)) for k, v in attrs.items())
        self.nodes.append(body)
        return outs[0] if len(outs) == 1 and not isinstance(outputs, list) else outs

    def const(self, value, output: str | None = None) -> str:
        return self.node("Constant", [], [output or self.name()], value=value)[0]

    def to_bytes(self) -> bytes:
        graph = b"".join(_bytes(1, n) for n in self.nodes) + _str(2, "graph")
        graph += b"".join(_bytes(5, t) for t in self.inits)
        graph += b"".join(_bytes(11, _str(1, i)) for i in self.inputs)
        graph += b"".join(_bytes(12, _str(1, o)) for o in self.outputs)
        opset = _str(1, "") + _vint(2, 13)
        return _vint(1, 7) + _str(2, "torch_onnx_graphs") + _bytes(7, graph) + _bytes(8, opset)

    def save(self, path) -> str:
        pathlib.Path(path).write_bytes(self.to_bytes())
        return str(path)


# ---- the reader's coverage ----

def reader_graph() -> GraphWriter:
    """Every attribute type and tensor encoding the readers parse."""
    g = GraphWriter()
    g.inputs = ["x"]
    rng = np.random.default_rng(0)
    g.init("raw_f32", rng.standard_normal((2, 3, 4)).astype(np.float32))
    g.init("raw_f16", rng.standard_normal((5,)).astype(np.float16))
    g.init("raw_i64", np.array([[-3, 0], [7, 2**40]], np.int64))
    g.init("raw_u8", np.arange(6, dtype=np.uint8).reshape(2, 3))
    g.init("raw_bool", np.array([True, False, True]))
    g.init("raw_f64_scalar", np.array(2.5))
    g.init("float_packed", rng.standard_normal((3, 2)).astype(np.float32), "float_packed")
    g.init("float_repeated", rng.standard_normal((4,)).astype(np.float32), "float_repeated")
    g.init("float_one", np.array([1.5], np.float32), "float_repeated")
    g.init("int64_packed", np.array([-1, 0, 5, -(2**40)], np.int64), "int64_packed")
    g.init("int64_repeated", np.array([[3, -4], [-(2**62), 9]], np.int64), "int64_repeated")
    g.init("int32_packed", np.array([0, 1, 300, 2**31 - 1], np.int32), "int32_packed")
    g.init("int32_repeated", np.array([7, 128, 65535], np.int32), "int32_repeated")
    g.init("empty", np.zeros((0,), np.float32))
    g.node("Elu", ["x"], alpha=0.25)
    g.node("Concat", ["x", "raw_f32"], axis=-2)
    g.node("Conv", ["x", "raw_f32", ""], auto_pad="NOTSET", group=1,
           pads=[0, 1, -2, 3], strides=Ints([2, 1]), kernel_shape=Ints([-7]))
    g.node("Resize", ["x"], scales=[1.0, 2.0, -0.5], weights=Floats([0.25, 4.0]),
           one=Floats([3.0]), mode="nearest")
    for enc in ("raw", "float_packed", "float_repeated"):
        g.const(Tensor(rng.standard_normal((2, 2)).astype(np.float32), enc))
    for enc in ("int64_packed", "int64_repeated", "int32_packed", "int32_repeated"):
        dt = np.int64 if enc.startswith("int64") else np.int32
        g.const(Tensor(np.array([0, 2, 1, 5], dt), enc))
    g.node("Constant", [], 1, name="", value_float=-0.125)
    g.node("Unknown", ["x", "", "raw_i64"], 2, untyped=5)
    g.outputs = [g.name()]
    return g


def op_graph(op: str, inputs: dict, n_outputs: int = 1, **attrs) -> GraphWriter:
    """One `op` node over graph inputs named as `inputs`' keys (their values
    are fed at run time; only the names are written)."""
    g = GraphWriter()
    g.inputs = list(inputs)
    outs = g.node(op, list(inputs), n_outputs, **attrs)
    g.outputs = outs if isinstance(outs, list) else [outs]
    return g


# ---- the LoFTR coarse graph ----

def loftr_coarse_graph(h: int, w: int, npz, tool) -> GraphWriter:
    """The coarse forward at an h x w input (multiples of 16, at most
    480 x 640) with the arrays of `npz` (a path or a dict of the checkpoint's
    arrays), under the initializer names of `tool`, the extraction tool's
    module (its `_BACKBONE`, `_COARSE`, `_COARSE_DUP` and `_POSENC_CONSTANT`).
    The positional encoding is the stored 480x640 table's top-left
    h/16 x w/16 block (1-indexed positions)."""
    if isinstance(npz, (str, pathlib.Path)):
        with np.load(npz) as z:
            params = {k: z[k] for k in z.files}
    else:
        params = dict(npz)
    g = GraphWriter()
    g.inputs = ["img0", "img1"]
    f32 = lambda v: np.array(v, np.float32)  # noqa: E731
    i64 = lambda v: np.array(v, np.int64)  # noqa: E731

    def conv(x, key, w_name, b_name, k, stride, pad):
        g.init(w_name, params[f"backbone/{key}/w"])
        ins = [x, w_name]
        if b_name is not None:
            g.init(b_name, params[f"backbone/{key}/b"])
            ins.append(b_name)
        return g.node("Conv", ins, dilations=[1, 1], group=1, kernel_shape=[k, k],
                      pads=[pad] * 4, strides=[stride, stride])

    # backbone, both images as one batch
    convs = {key: (wn, bn) for key, wn, bn in tool._BACKBONE}
    x = g.node("Concat", ["img0", "img1"], axis=0)
    x = g.node("Relu", [conv(x, "conv1", *convs["conv1"], 7, 2, 3)])
    for layer, stride in (("layer1", 1), ("layer2", 2), ("layer3", 2), ("layer4", 2)):
        for blk in ("block0", "block1"):
            s = stride if blk == "block0" else 1
            pre = f"{layer}/{blk}"
            y = g.node("Relu", [conv(x, f"{pre}/conv1", *convs[f"{pre}/conv1"], 3, s, 1)])
            y = conv(y, f"{pre}/conv2", *convs[f"{pre}/conv2"], 3, 1, 1)
            if f"{pre}/down" in convs:
                x = conv(x, f"{pre}/down", *convs[f"{pre}/down"], 1, s, 0)
            x = g.node("Relu", [g.node("Add", [x, y])])
    x = conv(x, "outconv", *convs["outconv"], 1, 1, 0)

    # split, positional encoding, flatten to [1, L, C] (shape subgraph on the host)
    f0, f1 = g.node("Split", [x], 2, axis=0)
    pe = params["posenc"][:, : h // 16, : w // 16][None]
    pe = g.const(np.ascontiguousarray(pe), tool._POSENC_CONSTANT)

    def flatten(f):
        f = g.node("Add", [f, pe])
        s = g.node("Shape", [f])
        lead = g.node("Slice", [s, g.const(i64([0])), g.const(i64([2]))])
        hh = g.node("Slice", [s, g.const(i64([2])), g.const(i64([3])), g.const(i64([0]))])
        ww = g.node("Slice", [s, g.const(i64([-1])), g.const(i64([2**63 - 1]))])
        hw = g.node("Cast", [g.node("Mul", [hh, ww])], to=7)
        f = g.node("Reshape", [f, g.node("Concat", [lead, hw], axis=0)])
        return g.node("Transpose", [f], perm=[0, 2, 1])

    f0, f1 = flatten(f0), flatten(f1)
    n_tok = (h // 16) * (w // 16)
    one = g.node("Constant", [], value_float=1.0)
    two = g.const(f32(2.0))
    attn_eps, ln_eps = g.const(f32(ATTN_EPS)), g.const(f32(LN_EPS))
    v_len = g.const(f32(n_tok))

    norms = set()  # LayerNorm initializers are shared by a layer's two applications

    def layernorm(v, i, n):
        wt = f"loftr_coarse.layers.{i}.{n}.weight"
        bs = f"loftr_coarse.layers.{i}.{n}.bias"
        if wt not in norms:
            norms.add(wt)
            g.init(wt, params[f"coarse/{i}/{n}_w"])
            g.init(bs, params[f"coarse/{i}/{n}_b"])
        mu = g.node("ReduceMean", [v], axes=[-1], keepdims=1)
        xc = g.node("Sub", [v, mu])
        var = g.node("ReduceMean", [g.node("Pow", [xc, two])], axes=[-1])
        d = g.node("Sqrt", [g.node("Add", [var, ln_eps])])
        return g.node("Add", [g.node("Mul", [g.node("Div", [xc, d]), wt]), bs])

    def encoder_layer(i, names, xs, src):
        wq, wk, wv, merge, mlp0, mlp1 = names
        for role, nm in zip(("wq", "wk", "wv", "merge", "mlp0", "mlp1"), names):
            g.init(nm, params[f"coarse/{i}/{role}"])
        q = g.node("Add", [g.node("Elu", [g.node("MatMul", [xs, wq])], alpha=1.0), one])
        k = g.node("Add", [g.node("Elu", [g.node("MatMul", [src, wk])]), one])
        v = g.node("Div", [g.node("MatMul", [src, wv]), v_len])
        kv = g.node("MatMul", [g.node("Transpose", [k], perm=[0, 2, 1]), v])
        ksum = g.node("ReduceSum", [k, g.const(i64([1]))], keepdims=1)
        qk = g.node("ReduceSum", [g.node("Mul", [q, ksum])], axes=[-1], keepdims=1)
        z = g.node("Div", [one, g.node("Add", [qk, attn_eps])])
        msg = g.node("Mul", [g.node("Mul", [g.node("MatMul", [q, kv]), z]), v_len])
        msg = layernorm(g.node("MatMul", [msg, merge]), i, "norm1")
        m = g.node("MatMul", [g.node("Concat", [xs, msg], axis=-1), mlp0])
        m = g.node("MatMul", [g.node("Relu", [m]), mlp1])
        return g.node("Add", [xs, layernorm(m, i, "norm2")])

    for i, kind in enumerate(("self", "cross", "self", "cross")):
        first, second = tool._COARSE[i], tool._COARSE_DUP[i]
        if kind == "self":
            f0, f1 = encoder_layer(i, first, f0, f0), encoder_layer(i, second, f1, f1)
        else:
            f0 = encoder_layer(i, first, f0, f1)
            f1 = encoder_layer(i, second, f1, f0)

    # dual-softmax head
    root_c = g.const(f32(math.sqrt(C)))
    f0 = g.node("Div", [f0, root_c])
    f1 = g.node("Transpose", [g.node("Div", [f1, root_c])], perm=[0, 2, 1])
    sim = g.node("Div", [g.node("MatMul", [f0, f1]), g.const(f32(TEMPERATURE))])
    conf = g.node("Mul", [g.node("Softmax", [sim], axis=1), g.node("Softmax", [sim], axis=2)],
                  ["conf"])
    g.outputs = conf
    return g
