"""Minimal ONNX protobuf codec (writer and reader), no onnx package needed.

The port's copy of neoplanner_tpu/io/onnx_proto.py. ONNX files are
protobuf messages; the subset of ``onnx.proto3`` that a PlannerNet graph
needs (ModelProto, GraphProto, NodeProto, TensorProto, AttributeProto,
ValueInfoProto) is encoded and decoded here at the wire level.

Field numbers follow onnx.proto3 (the stable public schema):
  ModelProto:    ir_version=1, producer_name=2, graph=7, opset_import=8
  OperatorSetId: domain=1, version=2
  GraphProto:    node=1, name=2, initializer=5, input=11, output=12
  NodeProto:     input=1, output=2, name=3, op_type=4, attribute=5
  AttributeProto:name=1, f=2, i=3, s=4, floats=7, ints=8, type=20
  TensorProto:   dims=1, data_type=2, name=8, raw_data=9   (FLOAT=1)
  ValueInfoProto:name=1, type=2; TypeProto.tensor_type=1;
  Tensor type:   elem_type=1, shape=2; TensorShapeProto.dim=1; dim_value=1

Pure Python and numpy: learn/onnx_interop.py writes and runs PlannerNet
graphs with it, and learn/weights.py reads their initializers.
"""

from __future__ import annotations

import struct

import numpy as np

FLOAT = 1
INT64 = 7

# AttributeProto.AttributeType
ATTR_FLOAT = 1
ATTR_INT = 2
ATTR_STRING = 3
ATTR_FLOATS = 6
ATTR_INTS = 7


# ---------------------------------------------------------------------------
# wire-level encoding
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wiretype: int) -> bytes:
    return _varint((field << 3) | wiretype)


def f_int(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def f_f32(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def f_bytes(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def f_str(field: int, s: str) -> bytes:
    return f_bytes(field, s.encode())


def f_msg(field: int, msg: bytes) -> bytes:
    return f_bytes(field, msg)


# ---------------------------------------------------------------------------
# message builders
# ---------------------------------------------------------------------------

def tensor(name: str, array: np.ndarray) -> bytes:
    array = np.asarray(array)
    if array.dtype == np.float32:
        dt = FLOAT
    elif array.dtype == np.int64:
        dt = INT64
    else:
        raise ValueError(f"unsupported tensor dtype {array.dtype}")
    msg = b"".join(f_int(1, int(d)) for d in array.shape)
    msg += f_int(2, dt)
    msg += f_str(8, name)
    msg += f_bytes(9, array.tobytes())
    return msg


def attr_i(name: str, value: int) -> bytes:
    return f_str(1, name) + f_int(3, int(value)) + f_int(20, ATTR_INT)


def attr_f(name: str, value: float) -> bytes:
    return f_str(1, name) + f_f32(2, float(value)) + f_int(20, ATTR_FLOAT)


def attr_ints(name: str, values) -> bytes:
    msg = f_str(1, name)
    for v in values:
        msg += f_int(8, int(v))
    return msg + f_int(20, ATTR_INTS)


def attr_s(name: str, value: str) -> bytes:
    return f_str(1, name) + f_bytes(4, value.encode()) + f_int(20, ATTR_STRING)


def node(op_type: str, inputs, outputs, name: str = "", attrs=()) -> bytes:
    msg = b"".join(f_str(1, i) for i in inputs)
    msg += b"".join(f_str(2, o) for o in outputs)
    msg += f_str(3, name or f"{op_type}_{outputs[0]}")
    msg += f_str(4, op_type)
    msg += b"".join(f_msg(5, a) for a in attrs)
    return msg


def value_info(name: str, shape, elem_type: int = FLOAT) -> bytes:
    dims = b"".join(f_msg(1, f_int(1, int(d))) for d in shape)
    shp = f_msg(2, dims)
    ten = f_int(1, elem_type) + shp
    typ = f_msg(1, ten)
    return f_str(1, name) + f_msg(2, typ)


def graph(nodes, name: str, initializers, inputs, outputs) -> bytes:
    msg = b"".join(f_msg(1, n) for n in nodes)
    msg += f_str(2, name)
    msg += b"".join(f_msg(5, t) for t in initializers)
    msg += b"".join(f_msg(11, vi) for vi in inputs)
    msg += b"".join(f_msg(12, vi) for vi in outputs)
    return msg


def model(graph_msg: bytes, opset: int = 13,
          producer: str = "neoplanner_tpu") -> bytes:
    msg = f_int(1, 8)                       # ir_version 8
    msg += f_str(2, producer)
    msg += f_msg(7, graph_msg)
    msg += f_msg(8, f_str(1, "") + f_int(2, opset))
    return msg


# ---------------------------------------------------------------------------
# wire-level decoding
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse(buf: bytes) -> dict:
    """Parse one protobuf message into {field_number: [raw values]}.
    Wiretype 0 -> int, 2 -> bytes (parse nested messages recursively with
    this same function), 5 -> float32."""
    out: dict = {}
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            val = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        elif wt == 1:
            val = struct.unpack("<d", buf[pos:pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wiretype {wt}")
        out.setdefault(field, []).append(val)
    return out


def parse_tensor(buf: bytes):
    """TensorProto bytes -> (name, np.ndarray)."""
    f = parse(buf)
    dims = [int(d) for d in f.get(1, [])]
    dt = int(f[2][0]) if 2 in f else FLOAT
    name = f[8][0].decode() if 8 in f else ""
    dtype = {FLOAT: np.float32, INT64: np.int64}[dt]
    if 9 in f:
        arr = np.frombuffer(f[9][0], dtype=dtype).reshape(dims)
    elif 4 in f:       # packed float_data fallback
        raw = f[4][0]
        arr = np.frombuffer(raw, dtype="<f4").reshape(dims)
    else:
        arr = np.zeros(dims, dtype)
    return name, arr


def parse_attr(buf: bytes):
    """AttributeProto bytes -> (name, value)."""
    f = parse(buf)
    name = f[1][0].decode()
    atype = int(f[20][0]) if 20 in f else None
    if atype == ATTR_INT or (atype is None and 3 in f):
        return name, int(f[3][0])
    if atype == ATTR_FLOAT or (atype is None and 2 in f):
        return name, float(f[2][0])
    if atype == ATTR_INTS or (atype is None and 8 in f):
        return name, [int(v) for v in f.get(8, [])]
    if atype == ATTR_STRING or (atype is None and 4 in f):
        return name, f[4][0].decode()
    raise ValueError(f"unsupported attribute {name} type {atype}")


def parse_model(buf: bytes):
    """ModelProto bytes -> dict with nodes/initializers/inputs/outputs."""
    m = parse(buf)
    g = parse(m[7][0])
    nodes = []
    for nb in g.get(1, []):
        f = parse(nb)
        nodes.append({
            "op": f[4][0].decode(),
            "inputs": [s.decode() for s in f.get(1, [])],
            "outputs": [s.decode() for s in f.get(2, [])],
            "attrs": dict(parse_attr(a) for a in f.get(5, [])),
        })
    inits = dict(parse_tensor(t) for t in g.get(5, []))

    def names(field):
        out = []
        for vb in g.get(field, []):
            out.append(parse(vb)[1][0].decode())
        return out

    return {
        "ir_version": int(m.get(1, [0])[0]),
        "opset": int(parse(m[8][0]).get(2, [0])[0]) if 8 in m else 0,
        "nodes": nodes,
        "initializers": inits,
        "inputs": names(11),
        "outputs": names(12),
    }
