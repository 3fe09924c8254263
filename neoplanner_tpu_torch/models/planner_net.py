"""PlannerNet: the trajectory-initializer network.

The port of neoplanner_tpu/models/planner_net.py ``PlannerNet`` (:45), with
both backbones (NetParams.backbone: 'resnet18', the reference's, or
'smallconv') and both fusions (NetParams.fusion_arch):

  'mlp'    depth (B, H, W, 1) --backbone--> 24   motion (24) --MLP
           48/24/24/24--> 24; concat (48) --MLP 48/96/96--> 9 outputs
           (2 body-frame 3-D waypoints + 3 durations), LeakyReLU (slope
           0.01) between the dense layers, none after the last;
  'conv1d' the motion branch and the fusion head are each a
           ``Conv1dStack`` (nn_trainer_conv.py:123-145): the fused vector
           is [image feature, motion feature].

The ResNet's BatchNorm follows the module's mode: eval() (the JAX package's
train=False) normalizes by the running stats, train() by the batch's.

On the card the net computes in IEEE f32 whoever calls it: its forward
pass (and learn/train's backward pass) run under :func:`ieee_f32`, which
turns TF32 off for cuDNN's convolutions and for matrix products and puts
the caller's settings back afterwards.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from neoplanner_tpu_torch.config import NetParams
from neoplanner_tpu_torch.models.resnet import ResNet18, SmallConvEncoder

BACKBONES = ("resnet18", "smallconv")
FUSIONS = ("mlp", "conv1d")


@contextlib.contextmanager
def ieee_f32():
    """TF32 off for cuDNN's convolutions and for matrix products inside;
    the caller's torch.backends settings restored on the way out."""
    conv = torch.backends.cudnn.allow_tf32
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = matmul


class Conv1dStack(nn.Module):
    """_Conv1dStack (planner_net.py:28): the input vector (B, L) as one
    channel through Conv1d 1 -> 16 -> 32 -> 64 (k 3, padding 1, LeakyReLU),
    flattened channel-last as flax does, (B, L, C), then a dense layer."""

    def __init__(self, length: int, out_features: int):
        super().__init__()
        chans = (1, 16, 32, 64)
        self.convs = nn.ModuleList(nn.Conv1d(chans[i], chans[i + 1], 3,
                                             padding=1) for i in range(3))
        self.head = nn.Linear(length * 64, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x[:, None, :]
        for conv in self.convs:
            y = F.leaky_relu(conv(y), 0.01)
        return self.head(y.permute(0, 2, 1).reshape(y.shape[0], -1))


class MLP(nn.ModuleList):
    """Dense layers of the given widths with LeakyReLU (slope 0.01)
    between them, none after the last."""

    def __init__(self, dims):
        super().__init__(nn.Linear(dims[i], dims[i + 1])
                         for i in range(len(dims) - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self):
            x = layer(x)
            if i < len(self) - 1:
                x = F.leaky_relu(x, 0.01)
        return x


class PlannerNet(nn.Module):
    def __init__(self, np_cfg: NetParams = NetParams()):
        super().__init__()
        if np_cfg.backbone not in BACKBONES:
            raise ValueError(f"unknown backbone: {np_cfg.backbone}")
        if np_cfg.fusion_arch not in FUSIONS:
            raise ValueError(f"unknown fusion_arch: {np_cfg.fusion_arch}")
        self.np_cfg = np_cfg
        backbone = (ResNet18 if np_cfg.backbone == "resnet18"
                    else SmallConvEncoder)
        self.img_backbone = backbone(np_cfg.img_feature_size)
        fused = np_cfg.img_feature_size + np_cfg.motion_feature_size
        if np_cfg.fusion_arch == "conv1d":
            self.motion_backbone = Conv1dStack(np_cfg.motion_input_size,
                                               np_cfg.motion_feature_size)
            self.mlp = Conv1dStack(fused, np_cfg.output_size)
            return
        self.motion_backbone = MLP((np_cfg.motion_input_size, 48, 24, 24,
                                    np_cfg.motion_feature_size))
        self.mlp = MLP((fused, 48, 96, 96, np_cfg.output_size))

    def forward(self, img: torch.Tensor, motion: torch.Tensor) -> torch.Tensor:
        """img (B, H, W, 1) in [0, 255] (NHWC, as the JAX net); motion (B, 24).
        -> (B, 9), in IEEE f32 (:func:`ieee_f32`)."""
        with ieee_f32():
            feat = self.img_backbone(img.permute(0, 3, 1, 2))
            x = self.motion_backbone(motion)
            return self.mlp(torch.cat([feat, x], dim=-1))

    def forward_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """The ONNX I/O contract (apply_flat, planner_net.py:108): flat
        (B, W*H + 24), the frame row-major then the motion vector ->
        (B, 9)."""
        cfg = self.np_cfg
        n_img = cfg.img_width * cfg.img_height
        img = flat[:, :n_img].reshape(-1, cfg.img_height, cfg.img_width, 1)
        return self(img, flat[:, n_img:])


def create(np_cfg: NetParams = NetParams()) -> PlannerNet:
    """A PlannerNet of np_cfg with PyTorch's initial weights, on the CPU
    (planner_net.py:108; learn/train.init_params draws the JAX package's
    initialization from a generator)."""
    return PlannerNet(np_cfg)


def load(path: str, np_cfg: NetParams, device="cuda") -> PlannerNet:
    """PlannerNet in eval mode on ``device`` with the weights of an exported
    .onnx file (learn/weights.from_onnx) or of the JAX package's orbax
    checkpoint directory (learn/train.load_checkpoint)."""
    import os
    from neoplanner_tpu_torch import _cuda
    from neoplanner_tpu_torch.learn import train, weights
    net = PlannerNet(np_cfg)
    net.load_state_dict(train.load_checkpoint(path)[0] if os.path.isdir(path)
                        else weights.from_onnx(path))
    return net.to(_cuda.resolve_device(device)).eval()
