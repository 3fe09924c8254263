"""PlannerNet weights into the port's ``state_dict``: from the JAX package's
flax parameters, or from the committed ONNX export.

``from_flax`` maps flax Dense kernels (in, out) to Linear weights (out, in)
and HWIO convolution kernels to OIHW. ``from_onnx`` reads the initializers
of a PlannerNet exported by neoplanner_tpu/learn/onnx_interop.py or by the
port's learn/onnx_interop.py (``artifacts/planner_net_smallconv.onnx``)
with the port's protobuf codec, io/onnx_proto.py.
"""

from __future__ import annotations

import numpy as np
import torch

from neoplanner_tpu_torch.io import onnx_proto


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


def from_onnx(path: str) -> dict:
    """state_dict of PlannerNet from an exported smallconv PlannerNet .onnx.

    Walks the graph's nodes in order: the four Conv nodes are the encoder's
    convolutions (OIHW already); the Gemm nodes are the encoder head, then
    the four motion layers, then the four fusion layers (x @ W + b, so W is
    (in, out) unless the node sets transB)."""
    with open(path, "rb") as fh:
        model = onnx_proto.parse_model(fh.read())
    inits = model["initializers"]
    convs, gemms = [], []
    for node in model["nodes"]:
        ins = node["inputs"]
        if node["op"] == "Conv":
            convs.append((inits[ins[1]], inits[ins[2]]))
        elif node["op"] == "Gemm":
            w = inits[ins[1]]
            if not node["attrs"].get("transB", 0):
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
