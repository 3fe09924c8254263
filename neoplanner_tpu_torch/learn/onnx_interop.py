"""PlannerNet <-> ONNX: write the port's PlannerNet as a real .onnx file, and
run such a file in numpy.

The port of neoplanner_tpu/learn/onnx_interop.py, for both backbones
(smallconv and resnet18) with 'mlp' fusion, as the JAX package exports. The
file is a standard opset-13 ONNX model (Slice/Reshape/Conv/
BatchNormalization/MaxPool/Relu/Add/GlobalAveragePool/Flatten/Gemm/
LeakyRelu/Concat) with the reference's flat I/O contract, (1, W*H + 24)
float32 in, (1, 9) out (nn_planner.py:87-111), serialized by io/onnx_proto.
The graph, its node and initializer names and the initializers' bytes are
those that the JAX package writes for the same weights: flax keeps conv
kernels HWIO and dense kernels (in, out), and its export writes them as
OIHW and (in, out), which are the port's conv weights as they are and its
Linear weights transposed; BatchNorm is written with its running stats and
ε 1e-5. ``run_onnx`` executes the same op subset in numpy.
"""

from __future__ import annotations

import numpy as np

from neoplanner_tpu_torch.config import NetParams
from neoplanner_tpu_torch.io import onnx_proto as op
from neoplanner_tpu_torch.learn.weights import (DOWNSAMPLE_BLOCKS,
                                                 resnet_convs)
from neoplanner_tpu_torch.models.resnet import BN_EPS, same_pads


class _Builder:
    def __init__(self):
        self.nodes = []
        self.inits = []
        self._n = 0

    def uniq(self, base):
        self._n += 1
        return f"{base}_{self._n}"

    def init_tensor(self, base, array):
        name = self.uniq(base)
        self.inits.append(op.tensor(name, np.asarray(array)))
        return name

    def add(self, op_type, inputs, outputs=None, attrs=()):
        if outputs is None:
            outputs = [self.uniq(op_type.lower())]
        self.nodes.append(op.node(op_type, inputs, outputs, attrs=list(attrs)))
        return outputs[0]

    def gemm(self, x, sd, name, out=None):
        """A Linear layer as Gemm: W (in, out), the port's weight
        transposed."""
        b = self.init_tensor("W", sd[f"{name}.weight"].T)
        c = self.init_tensor("b", sd[f"{name}.bias"])
        return self.add("Gemm", [x, b, c], [out] if out else None)

    def conv(self, x, weight_oihw, bias, strides, pads):
        inputs = [x, self.init_tensor("convW", weight_oihw)]
        if bias is not None:
            inputs.append(self.init_tensor("convB", bias))
        kh, kw = weight_oihw.shape[2], weight_oihw.shape[3]
        return self.add("Conv", inputs, attrs=[
            op.attr_ints("kernel_shape", (kh, kw)),
            op.attr_ints("strides", strides),
            op.attr_ints("pads", pads),
        ])

    def batchnorm(self, x, sd, name):
        ins = [x] + [self.init_tensor(base, sd[f"{name}.{key}"]) for base, key
                     in (("bnS", "weight"), ("bnB", "bias"),
                         ("bnM", "running_mean"), ("bnV", "running_var"))]
        return self.add("BatchNormalization", ins,
                        attrs=[op.attr_f("epsilon", BN_EPS)])

    def slice(self, x, starts, ends, axes):
        return self.add("Slice", [
            x,
            self.init_tensor("starts", np.asarray(starts, np.int64)),
            self.init_tensor("ends", np.asarray(ends, np.int64)),
            self.init_tensor("axes", np.asarray(axes, np.int64)),
        ])

    def reshape(self, x, shape):
        return self.add("Reshape", [
            x, self.init_tensor("shape", np.asarray(shape, np.int64))])


def _smallconv(b: _Builder, sd, x, h, w):
    for i in range(4):
        pt, pb = same_pads(h, 3, 2)
        pl_, pr = same_pads(w, 3, 2)
        h, w = -(-h // 2), -(-w // 2)
        x = b.conv(x, sd[f"img_backbone.convs.{i}.weight"],
                   sd[f"img_backbone.convs.{i}.bias"], (2, 2),
                   (pt, pl_, pb, pr))
        x = b.add("Relu", [x])
    x = b.add("GlobalAveragePool", [x])
    x = b.add("Flatten", [x], attrs=[op.attr_i("axis", 1)])
    return b.gemm(x, sd, "img_backbone.head")


def _resnet18(b: _Builder, sd, x):
    """The ResNet-18 trunk as _resnet18 (onnx_interop.py:120-153) writes
    it: each convolution (no bias) and its BatchNormalization in the
    forward pass's order, the residual's Add before each block's ReLU."""
    convs = iter(resnet_convs())

    def conv_bn(x, stride, pad):
        conv, bn = next(convs)
        x = b.conv(x, sd[f"{conv}.weight"], None, (stride, stride),
                   (pad,) * 4)
        return b.batchnorm(x, sd, bn)

    x = b.add("Relu", [conv_bn(x, 2, 3)])
    x = b.add("MaxPool", [x], attrs=[
        op.attr_ints("kernel_shape", (3, 3)),
        op.attr_ints("strides", (2, 2)),
        op.attr_ints("pads", (1, 1, 1, 1)),
    ])
    for k in range(8):
        stride = 2 if k in DOWNSAMPLE_BLOCKS else 1
        res = x
        y = b.add("Relu", [conv_bn(x, stride, 1)])
        y = conv_bn(y, 1, 1)
        if stride == 2:          # the downsample (shape change)
            res = conv_bn(res, stride, 0)
        x = b.add("Relu", [b.add("Add", [y, res])])
    x = b.add("GlobalAveragePool", [x])
    x = b.add("Flatten", [x], attrs=[op.attr_i("axis", 1)])
    return b.gemm(x, sd, "img_backbone.head")


def export_planner_net(state_dict, np_cfg: NetParams, path: str) -> str:
    """Write a PlannerNet state_dict (smallconv or resnet18, 'mlp' fusion)
    as a reference-contract .onnx model: flat (1, W*H + 24) float32 in,
    (1, 9) out (export_planner_net, onnx_interop.py:156)."""
    if np_cfg.fusion_arch != "mlp":
        raise NotImplementedError(
            "ONNX export covers the reference's deployed architecture "
            "(fusion_arch='mlp', nn_trainer.py:109-155)")
    if np_cfg.backbone not in ("smallconv", "resnet18"):
        raise NotImplementedError(np_cfg.backbone)
    sd = {k: np.ascontiguousarray(v.detach().cpu().numpy(), np.float32)
          for k, v in state_dict.items()}
    n_img = np_cfg.img_width * np_cfg.img_height
    b = _Builder()
    img_flat = b.slice("input", [0], [n_img], [1])
    motion = b.slice("input", [n_img], [n_img + np_cfg.motion_input_size],
                     [1])
    # (1, H*W) -> (1, 1, H, W): one channel, so NCHW keeps the order
    img = b.reshape(img_flat, (1, 1, np_cfg.img_height, np_cfg.img_width))
    if np_cfg.backbone == "resnet18":
        img_feat = _resnet18(b, sd, img)
    else:
        img_feat = _smallconv(b, sd, img, np_cfg.img_height,
                              np_cfg.img_width)
    x = motion
    for i in range(4):
        x = b.gemm(x, sd, f"motion_backbone.{i}")
        if i < 3:
            x = b.add("LeakyRelu", [x], attrs=[op.attr_f("alpha", 0.01)])
    y = b.add("Concat", [img_feat, x], attrs=[op.attr_i("axis", 1)])
    for i in range(4):
        y = b.gemm(y, sd, f"mlp.{i}", out="output" if i == 3 else None)
        if i < 3:
            y = b.add("LeakyRelu", [y], attrs=[op.attr_f("alpha", 0.01)])
    g = op.graph(b.nodes, "planner_net", b.inits,
                 [op.value_info("input", (1, n_img
                                          + np_cfg.motion_input_size))],
                 [op.value_info("output", (1, np_cfg.output_size))])
    with open(path, "wb") as f:
        f.write(op.model(g))
    return path


def _np_conv(x, w, bias, strides, pads):
    """x (1, C, H, W), w (O, C, kh, kw) -> (1, O, oh, ow)."""
    sh, sw = strides
    pt, pl_, pb, pr = pads
    xp = np.pad(x, ((0, 0), (0, 0), (pt, pb), (pl_, pr)))
    hp, wp = xp.shape[2:]
    o, _, kh, kw = w.shape
    oh = (hp - kh) // sh + 1
    ow = (wp - kw) // sw + 1
    out = np.zeros((1, o, oh, ow), np.float32)
    wf = w.reshape(o, -1)                             # (O, C*kh*kw)
    for yy in range(oh):
        rows = xp[0, :, yy * sh:yy * sh + kh, :]       # (C, kh, wp)
        patch = np.stack([rows[:, :, xx * sw:xx * sw + kw]
                          for xx in range(ow)])        # (ow, C, kh, kw)
        out[0, :, yy, :] = wf @ patch.reshape(ow, -1).T
    if bias is not None:
        out += bias[None, :, None, None]
    return out


def _np_maxpool(x, k, strides, pads):
    """x (1, C, H, W): the max over k windows, padded with -inf."""
    sh, sw = strides
    pt, pl_, pb, pr = pads
    xp = np.pad(x, ((0, 0), (0, 0), (pt, pb), (pl_, pr)),
                constant_values=-np.inf)
    hp, wp = xp.shape[2:]
    kh, kw = k
    oh = (hp - kh) // sh + 1
    ow = (wp - kw) // sw + 1
    out = np.full((1, x.shape[1], oh, ow), -np.inf, np.float32)
    for dy in range(kh):
        for dx in range(kw):
            out = np.maximum(
                out, xp[:, :, dy:dy + oh * sh:sh, dx:dx + ow * sw:sw])
    return out


def run_onnx(path_or_bytes, feed: dict) -> dict:
    """Execute a PlannerNet .onnx model (the port's or the JAX package's
    export, either backbone) in numpy. feed maps graph input names to
    arrays; returns {output name: array}."""
    blob = path_or_bytes
    if isinstance(blob, str):
        with open(blob, "rb") as f:
            blob = f.read()
    m = op.parse_model(blob)
    vals = dict(m["initializers"])
    for k, v in feed.items():
        vals[k] = np.asarray(v, np.float32)
    for n in m["nodes"]:
        a = n["attrs"]
        x = [vals[i] for i in n["inputs"]]
        t = n["op"]
        if t == "Slice":
            sl = [slice(None)] * x[0].ndim
            for s0, e0, ax in zip(x[1], x[2], x[3]):
                sl[int(ax)] = slice(int(s0), int(e0))
            out = x[0][tuple(sl)]
        elif t == "Reshape":
            out = x[0].reshape([int(d) for d in x[1]])
        elif t == "Conv":
            out = _np_conv(x[0], x[1], x[2] if len(x) > 2 else None,
                           a["strides"], a["pads"])
        elif t == "BatchNormalization":
            scale, shift, mean, var = (v[None, :, None, None]
                                       for v in x[1:5])
            out = (x[0] - mean) / np.sqrt(var + a.get("epsilon", BN_EPS)) \
                * scale + shift
        elif t == "MaxPool":
            out = _np_maxpool(x[0], a["kernel_shape"], a["strides"],
                              a["pads"])
        elif t == "Add":
            out = x[0] + x[1]
        elif t == "Relu":
            out = np.maximum(x[0], 0.0)
        elif t == "LeakyRelu":
            out = np.where(x[0] > 0, x[0], a.get("alpha", 0.01) * x[0])
        elif t == "GlobalAveragePool":
            out = x[0].mean(axis=(2, 3), keepdims=True)
        elif t == "Flatten":
            out = x[0].reshape(x[0].shape[0], -1)
        elif t == "Gemm":
            out = x[0] @ x[1] + x[2]
        elif t == "Concat":
            out = np.concatenate(x, axis=a.get("axis", 1))
        else:
            raise NotImplementedError(f"op {t} (the port runs PlannerNet "
                                      f"graphs)")
        vals[n["outputs"][0]] = out.astype(np.float32)
    return {name: vals[name] for name in m["outputs"]}
