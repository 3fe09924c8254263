"""PlannerNet weights into the port's ``state_dict``: from the JAX package's
flax parameters, or from the committed ONNX export.

``from_flax`` maps flax Dense kernels (in, out) to Linear weights (out, in)
and HWIO convolution kernels to OIHW. ``from_onnx`` reads the initializers
of a PlannerNet exported by neoplanner_tpu/learn/onnx_interop.py
(``artifacts/planner_net_smallconv.onnx``) with the minimal protobuf decoder
below, a copy of the reading half of neoplanner_tpu/io/onnx_proto.py.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

_FLOAT, _INT64 = 1, 7


def _linear(kernel, bias):
    k = np.asarray(kernel, np.float32)
    return torch.from_numpy(k.T.copy()), torch.from_numpy(
        np.asarray(bias, np.float32).copy())


def from_flax(variables) -> dict:
    """flax PlannerNet variables (or their 'params'), as numpy arrays ->
    state_dict of neoplanner_tpu_torch.models.planner_net.PlannerNet."""
    params = variables.get("params", variables)
    sd = {}
    img = params["img_backbone"]
    for i in range(4):
        conv = img[f"Conv_{i}"]
        w = np.asarray(conv["kernel"], np.float32).transpose(3, 2, 0, 1)
        sd[f"img_backbone.convs.{i}.weight"] = torch.from_numpy(w.copy())
        sd[f"img_backbone.convs.{i}.bias"] = torch.from_numpy(
            np.asarray(conv["bias"], np.float32).copy())
    w, b = _linear(img["Dense_0"]["kernel"], img["Dense_0"]["bias"])
    sd["img_backbone.head.weight"], sd["img_backbone.head.bias"] = w, b
    for name in ("motion_backbone", "mlp"):
        for i in range(4):
            p = params[f"{name}_{i}"]
            w, b = _linear(p["kernel"], p["bias"])
            sd[f"{name}.{i}.weight"], sd[f"{name}.{i}.bias"] = w, b
    return sd


# ---------------------------------------------------------------------------
# minimal ONNX (protobuf wire format) reader
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int):
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _parse(buf: bytes) -> dict:
    """One protobuf message -> {field number: [raw values]}."""
    out: dict = {}
    pos, n = 0, len(buf)
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
            raise ValueError(f"unsupported protobuf wiretype {wt}")
        out.setdefault(field, []).append(val)
    return out


def _tensor(buf: bytes):
    """TensorProto -> (name, array): dims=1, data_type=2, name=8, raw=9."""
    f = _parse(buf)
    dims = [int(d) for d in f.get(1, [])]
    dtype = {_FLOAT: np.float32, _INT64: np.int64}[int(f.get(2, [_FLOAT])[0])]
    name = f[8][0].decode() if 8 in f else ""
    if 9 in f:
        arr = np.frombuffer(f[9][0], dtype=dtype).reshape(dims)
    elif 4 in f:
        arr = np.frombuffer(f[4][0], dtype="<f4").reshape(dims)
    else:
        arr = np.zeros(dims, dtype)
    return name, arr


def _int_attrs(buf_list) -> dict:
    """AttributeProto list -> {name: int} for integer attributes (i=3)."""
    out = {}
    for a in buf_list:
        f = _parse(a)
        if 3 in f:
            out[f[1][0].decode()] = int(f[3][0])
    return out


def from_onnx(path: str) -> dict:
    """state_dict of PlannerNet from an exported smallconv PlannerNet .onnx.

    Walks the graph's nodes in order: the four Conv nodes are the encoder's
    convolutions (OIHW already); the Gemm nodes are the encoder head, then
    the four motion layers, then the four fusion layers (x @ W + b, so W is
    (in, out) unless the node sets transB)."""
    with open(path, "rb") as fh:
        model = _parse(fh.read())
    graph = _parse(model[7][0])
    inits = dict(_tensor(t) for t in graph.get(5, []))
    convs, gemms = [], []
    for nb in graph.get(1, []):
        node = _parse(nb)
        op = node[4][0].decode()
        ins = [s.decode() for s in node.get(1, [])]
        if op == "Conv":
            convs.append((inits[ins[1]], inits[ins[2]]))
        elif op == "Gemm":
            w = inits[ins[1]]
            if not _int_attrs(node.get(5, [])).get("transB", 0):
                w = w.T
            gemms.append((w, inits[ins[2]]))
    if len(convs) != 4 or len(gemms) != 9:
        raise ValueError(f"{path}: not a smallconv/mlp PlannerNet export "
                         f"({len(convs)} Conv, {len(gemms)} Gemm nodes)")
    sd = {}
    for i, (w, b) in enumerate(convs):
        sd[f"img_backbone.convs.{i}.weight"] = torch.from_numpy(w.copy())
        sd[f"img_backbone.convs.{i}.bias"] = torch.from_numpy(b.copy())
    names = (["img_backbone.head"] + [f"motion_backbone.{i}" for i in range(4)]
             + [f"mlp.{i}" for i in range(4)])
    for name, (w, b) in zip(names, gemms):
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        sd[f"{name}.bias"] = torch.from_numpy(b.copy())
    return sd
