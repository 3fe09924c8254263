"""PlannerNet weights into the port's ``state_dict``: from the JAX package's
flax variables, or from an ONNX export.

``from_flax`` maps flax Dense kernels (in, out) to Linear weights (out, in),
HWIO convolution kernels to OIHW, the conv1d stacks' (W, I, O) kernels to
(O, I, W), and the ResNet's BatchNorm ``scale``/``bias`` (params) and
``mean``/``var`` (batch_stats) to ``weight``/``bias``/``running_mean``/
``running_var``. ``from_onnx`` reads the initializers of a PlannerNet
exported by neoplanner_tpu/learn/onnx_interop.py or by the port's
learn/onnx_interop.py (``artifacts/planner_net_smallconv.onnx``) with the
port's protobuf codec, io/onnx_proto.py: the smallconv backbone or the
ResNet-18 (Conv without bias, BatchNormalization), 'mlp' fusion.
"""

from __future__ import annotations

import numpy as np
import torch

from neoplanner_tpu_torch.io import onnx_proto


def _tensor(a) -> torch.Tensor:
    """A copy of the array as a tensor of its own dtype (float32 from the
    JAX package and from ONNX files)."""
    return torch.from_numpy(np.array(a))


def _linear(sd, name, dense):
    sd[f"{name}.weight"] = _tensor(np.asarray(dense["kernel"]).T)
    sd[f"{name}.bias"] = _tensor(dense["bias"])


def _conv(sd, name, conv):
    k = np.asarray(conv["kernel"])
    # HWIO -> OIHW (2-D), WIO -> OIW (1-D)
    sd[f"{name}.weight"] = _tensor(k.transpose(3, 2, 0, 1) if k.ndim == 4
                                else k.transpose(2, 1, 0))
    if "bias" in conv:
        sd[f"{name}.bias"] = _tensor(conv["bias"])


def _bn(sd, name, params, stats):
    sd[f"{name}.weight"] = _tensor(params["scale"])
    sd[f"{name}.bias"] = _tensor(params["bias"])
    sd[f"{name}.running_mean"] = _tensor(stats["mean"])
    sd[f"{name}.running_var"] = _tensor(stats["var"])


DOWNSAMPLE_BLOCKS = (2, 4, 6)   # the first block of stages 1-3


def resnet_convs():
    """The ResNet-18 convolutions of the port's state_dict in the order
    that its forward pass (and an ONNX export) runs them, each followed by
    its BatchNorm: [(conv name, BatchNorm name)]."""
    out = [("img_backbone.conv_0", "img_backbone.bn_0")]
    for k in range(8):
        for i in ((0, 1, 2) if k in DOWNSAMPLE_BLOCKS else (0, 1)):
            out.append((f"img_backbone.blocks.{k}.conv_{i}",
                        f"img_backbone.blocks.{k}.bn_{i}"))
    return out


def from_flax(variables) -> dict:
    """flax PlannerNet variables ({'params', 'batch_stats'}, or the params
    alone for a net without BatchNorm), as numpy arrays -> state_dict of
    neoplanner_tpu_torch.models.planner_net.PlannerNet, each tensor in its
    array's dtype."""
    params = variables.get("params", variables)
    stats = variables.get("batch_stats", {})
    sd = {}
    img = params["img_backbone"]
    if "BatchNorm_0" in img:               # ResNet-18
        st = stats["img_backbone"]
        _conv(sd, "img_backbone.conv_0", img["Conv_0"])
        _bn(sd, "img_backbone.bn_0", img["BatchNorm_0"], st["BatchNorm_0"])
        for k in range(8):
            bp, bs = img[f"BasicBlock_{k}"], st[f"BasicBlock_{k}"]
            for i in range(3):
                if f"Conv_{i}" in bp:
                    name = f"img_backbone.blocks.{k}"
                    _conv(sd, f"{name}.conv_{i}", bp[f"Conv_{i}"])
                    _bn(sd, f"{name}.bn_{i}", bp[f"BatchNorm_{i}"],
                        bs[f"BatchNorm_{i}"])
    else:
        for i in range(4):
            _conv(sd, f"img_backbone.convs.{i}", img[f"Conv_{i}"])
    _linear(sd, "img_backbone.head", img["Dense_0"])
    if "motion_backbone" in params:        # conv1d fusion
        for name in ("motion_backbone", "mlp"):
            for i in range(3):
                _conv(sd, f"{name}.convs.{i}", params[name][f"Conv_{i}"])
            _linear(sd, f"{name}.head", params[name]["Dense_0"])
        return sd
    for name in ("motion_backbone", "mlp"):
        for i in range(4):
            _linear(sd, f"{name}.{i}", params[f"{name}_{i}"])
    return sd


def from_onnx(path: str) -> dict:
    """state_dict of PlannerNet from an exported 'mlp' PlannerNet .onnx.

    Walks the graph's nodes in order: the Conv nodes are the image
    backbone's convolutions (OIHW already), four with biases for the
    smallconv net, or the ResNet-18's twenty without, each followed by its
    BatchNormalization (scale, bias, mean, var); the Gemm nodes are the
    backbone's head, then the four motion layers, then the four fusion
    layers (x @ W + b, so W is (in, out) unless the node sets transB)."""
    with open(path, "rb") as fh:
        model = onnx_proto.parse_model(fh.read())
    inits = model["initializers"]
    convs, bns, gemms = [], [], []
    for node in model["nodes"]:
        ins = node["inputs"]
        if node["op"] == "Conv":
            convs.append([inits[i] for i in ins[1:]])
        elif node["op"] == "BatchNormalization":
            bns.append([inits[i] for i in ins[1:5]])
        elif node["op"] == "Gemm":
            w = inits[ins[1]]
            if not node["attrs"].get("transB", 0):
                w = w.T
            gemms.append((w, inits[ins[2]]))
    resnet = resnet_convs()
    if (len(convs), len(bns)) == (4, 0):
        names = [(f"img_backbone.convs.{i}", None) for i in range(4)]
    elif (len(convs), len(bns)) == (len(resnet), len(resnet)):
        names = resnet
    else:
        names = None
    if names is None or len(gemms) != 9:
        raise ValueError(f"{path}: not a smallconv or resnet18 'mlp' "
                         f"PlannerNet export ({len(convs)} Conv, {len(bns)} "
                         f"BatchNormalization, {len(gemms)} Gemm nodes)")
    sd = {}
    for (conv, bn), arrays in zip(names, convs):
        sd[f"{conv}.weight"] = _tensor(arrays[0])
        if len(arrays) > 1:
            sd[f"{conv}.bias"] = _tensor(arrays[1])
    for (_, bn), arrays in zip(names, bns):
        for key, a in zip(("weight", "bias", "running_mean", "running_var"),
                          arrays):
            sd[f"{bn}.{key}"] = _tensor(a)
    heads = (["img_backbone.head"] + [f"motion_backbone.{i}" for i in range(4)]
             + [f"mlp.{i}" for i in range(4)])
    for name, (w, b) in zip(heads, gemms):
        sd[f"{name}.weight"] = _tensor(w)
        sd[f"{name}.bias"] = _tensor(b)
    return sd


def digest(state_dict) -> str:
    """SHA-256 (hex) over a state_dict: for each key in sorted order, the
    key, the tensor's dtype and shape, and its bytes (C order, on the
    CPU)."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(state_dict):
        t = state_dict[k].detach().cpu().contiguous()
        h.update(f"{k}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()
