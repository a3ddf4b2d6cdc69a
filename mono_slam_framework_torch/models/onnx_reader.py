"""Minimal ONNX (protobuf wire format) reader.

The port's own copy of `mono_slam_framework_tpu/models/onnx_reader.py`
(numpy and struct only; the port imports nothing of the JAX package). It
parses the protobuf wire format directly, with no `onnx` package: just
enough of ModelProto/GraphProto/NodeProto/AttributeProto/TensorProto to
extract the reference's LoFTR_teacher.onnx graph structure and weights
(reference consumer: src/dnnfeaturematcher.cpp; asset:
model/LoFTR_teacher.onnx).

Field numbers follow the public onnx.proto3 schema.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any

import numpy as np


def _read_varint(buf: memoryview, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _parse_message(buf: memoryview):
    """Generic protobuf message -> {field_number: [raw values]}.

    Wire types: 0 varint, 1 fixed64, 2 length-delimited (memoryview), 5 fixed32.
    """
    fields: dict[int, list] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field = key >> 3
        wire = key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = bytes(buf[pos : pos + 8])
            pos += 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            val = buf[pos : pos + length]
            pos += length
        elif wire == 5:
            val = bytes(buf[pos : pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire} at {pos}")
        fields.setdefault(field, []).append(val)
    return fields


def _as_str(v) -> str:
    return bytes(v).decode("utf-8", errors="replace")


# ONNX TensorProto.DataType -> numpy
_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}


def _zigzag_ints(vals):
    return [v - (1 << 64) if v >= (1 << 63) else v for v in vals]


@dataclasses.dataclass
class OnnxTensor:
    name: str
    array: np.ndarray


def _parse_tensor(buf: memoryview) -> OnnxTensor:
    f = _parse_message(buf)
    dims = _zigzag_ints(f.get(1, []))
    dtype_code = f.get(2, [1])[0]
    name = _as_str(f[8][0]) if 8 in f else ""
    dtype = _DTYPES.get(dtype_code, np.float32)
    if 9 in f:  # raw_data
        arr = np.frombuffer(bytes(f[9][0]), dtype=dtype)
    elif 4 in f:  # float_data (packed or repeated)
        chunks = f[4]
        if len(chunks) == 1 and isinstance(chunks[0], memoryview):
            arr = np.frombuffer(bytes(chunks[0]), dtype=np.float32)
        else:
            arr = np.array(
                [struct.unpack("<f", c)[0] if isinstance(c, bytes) else c for c in chunks],
                np.float32,
            )
    elif 7 in f:  # int64_data
        chunks = f[7]
        if len(chunks) == 1 and isinstance(chunks[0], memoryview):
            vals = []
            pos = 0
            mv = chunks[0]
            while pos < len(mv):
                v, pos = _read_varint(mv, pos)
                vals.append(v)
            arr = np.array(_zigzag_ints(vals), np.int64)
        else:
            arr = np.array(_zigzag_ints(chunks), np.int64)
    elif 5 in f:  # int32_data
        chunks = f[5]
        if len(chunks) == 1 and isinstance(chunks[0], memoryview):
            vals = []
            pos = 0
            mv = chunks[0]
            while pos < len(mv):
                v, pos = _read_varint(mv, pos)
                vals.append(v)
            arr = np.array(vals, np.int32)
        else:
            arr = np.array(chunks, np.int32)
    else:
        arr = np.zeros(0, dtype)
    if dims:
        arr = arr.reshape(dims)
    return OnnxTensor(name, arr)


@dataclasses.dataclass
class OnnxNode:
    op_type: str
    name: str
    inputs: list[str]
    outputs: list[str]
    attrs: dict[str, Any]


def _parse_attribute(buf: memoryview):
    f = _parse_message(buf)
    name = _as_str(f[1][0]) if 1 in f else ""
    # AttributeProto.type (field 20): 1 FLOAT, 2 INT, 3 STRING, 4 TENSOR,
    # 6 FLOATS, 7 INTS, 8 STRINGS
    atype = f.get(20, [0])[0]
    val: Any = None
    if atype == 1 and 2 in f:
        val = struct.unpack("<f", f[2][0])[0]
    elif atype == 2 and 3 in f:
        val = _zigzag_ints([f[3][0]])[0]
    elif atype == 3 and 4 in f:
        val = _as_str(f[4][0])
    elif atype == 4 and 5 in f:
        val = _parse_tensor(f[5][0]).array
    elif atype == 6 and 7 in f:  # FLOATS live in field 7
        chunks = f[7]
        if len(chunks) == 1 and isinstance(chunks[0], memoryview) and len(chunks[0]) % 4 == 0 and len(chunks[0]) > 4:
            val = list(np.frombuffer(bytes(chunks[0]), np.float32))
        else:
            val = [struct.unpack("<f", c)[0] for c in chunks]
    elif atype == 7 and 8 in f:  # INTS live in field 8
        chunks = f[8]
        vals = []
        for c in chunks:
            if isinstance(c, memoryview):  # packed
                pos = 0
                while pos < len(c):
                    v, pos = _read_varint(c, pos)
                    vals.append(v)
            else:
                vals.append(c)
        val = _zigzag_ints(vals)
    elif 3 in f:  # untyped int fallback
        val = _zigzag_ints([f[3][0]])[0]
    return name, val


def _parse_node(buf: memoryview) -> OnnxNode:
    f = _parse_message(buf)
    return OnnxNode(
        op_type=_as_str(f[4][0]) if 4 in f else "",
        name=_as_str(f[3][0]) if 3 in f else "",
        inputs=[_as_str(v) for v in f.get(1, [])],
        outputs=[_as_str(v) for v in f.get(2, [])],
        attrs=dict(_parse_attribute(a) for a in f.get(5, [])),
    )


@dataclasses.dataclass
class OnnxGraph:
    nodes: list[OnnxNode]
    initializers: dict[str, np.ndarray]
    inputs: list[str]
    outputs: list[str]


def load_graph(path: str) -> OnnxGraph:
    with open(path, "rb") as fh:
        data = memoryview(fh.read())
    model = _parse_message(data)
    graph = _parse_message(model[7][0])  # ModelProto.graph
    nodes = [_parse_node(n) for n in graph.get(1, [])]
    inits = {}
    for t in graph.get(5, []):
        tensor = _parse_tensor(t)
        inits[tensor.name] = tensor.array

    def _value_info_name(buf):
        f = _parse_message(buf)
        return _as_str(f[1][0]) if 1 in f else ""

    inputs = [_value_info_name(v) for v in graph.get(11, [])]
    outputs = [_value_info_name(v) for v in graph.get(12, [])]
    return OnnxGraph(nodes, inits, inputs, outputs)


def op_census(graph: OnnxGraph) -> dict[str, int]:
    census: dict[str, int] = {}
    for n in graph.nodes:
        census[n.op_type] = census.get(n.op_type, 0) + 1
    return census
