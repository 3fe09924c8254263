"""Depth-image encoders of the PlannerNet: ResNet-18 and the smallconv net.

The port of neoplanner_tpu/models/resnet.py:

- ``ResNet18`` (:48), the reference's depth backbone (torchvision resnet18
  with a one-channel conv1 and a ``num_features`` head): a 7x7/2
  convolution with padding 3 and no bias, BatchNorm, ReLU and a 3x3/2
  max-pool with padding 1; four stages of two ``BasicBlock`` (:24) at
  64·2^i features, the first block of stages 1-3 with stride 2 and a 1x1/2
  downsample with BatchNorm (flax's 'SAME' pad of a 1x1/2 convolution is
  0 and its explicit pads are 1, at every size); global average pooling and
  a dense head.
- ``SmallConvEncoder`` (:71): four stride-2 3x3 convolutions (16, 32, 64,
  128 channels) with flax's 'SAME' padding and ReLU, global average pooling
  and a dense head.

Input and output follow PyTorch's NCHW inside; the public PlannerNet keeps
NHWC. BatchNorm is flax's (:31-33): ε 1e-5, and in training the batch's
mean and biased variance normalize and move the running averages by
momentum 0.9 (PyTorch's BatchNorm2d would move running_var by the
unbiased variance).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5       # flax nn.BatchNorm's default (torchvision's too)
BN_MOMENTUM = 0.9   # flax's: running = 0.9 running + 0.1 batch


def same_pads(n: int, k: int, s: int):
    """TF/flax 'SAME' padding of one spatial dim: (before, after)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class BatchNorm(nn.Module):
    """flax's nn.BatchNorm over the channels of (B, C, H, W): ``weight``
    and ``bias`` (flax's scale and bias) and the buffers ``running_mean``
    and ``running_var`` (its batch_stats). In train() mode it normalizes by
    the batch's mean and biased variance and moves the running stats
    toward them; in eval() mode it normalizes by the running stats."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, BN_EPS)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.mul_(BN_MOMENTUM).add_(
                mean, alpha=1.0 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(
                var, alpha=1.0 - BN_MOMENTUM)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            BN_EPS)


class BasicBlock(nn.Module):
    """Two 3x3 convolutions with BatchNorm and a residual (a 1x1
    convolution with BatchNorm where the shape changes)."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.conv_0 = nn.Conv2d(in_features, features, 3, stride, 1,
                                bias=False)
        self.bn_0 = BatchNorm(features)
        self.conv_1 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn_1 = BatchNorm(features)
        self.downsample = stride != 1 or in_features != features
        if self.downsample:
            self.conv_2 = nn.Conv2d(in_features, features, 1, stride, 0,
                                    bias=False)
            self.bn_2 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn_0(self.conv_0(x)))
        y = self.bn_1(self.conv_1(y))
        res = self.bn_2(self.conv_2(x)) if self.downsample else x
        return F.relu(y + res)


class ResNet18(nn.Module):
    def __init__(self, num_features: int = 24):
        super().__init__()
        self.conv_0 = nn.Conv2d(1, 64, 7, 2, 3, bias=False)
        self.bn_0 = BatchNorm(64)
        blocks, features = [], 64
        for i in range(4):
            for j in range(2):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(BasicBlock(features, 64 * 2 ** i, stride))
                features = 64 * 2 ** i
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(features, num_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) -> (B, num_features)."""
        x = F.relu(self.bn_0(self.conv_0(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for block in self.blocks:
            x = block(x)
        return self.head(x.mean(dim=(2, 3)))


class SmallConvEncoder(nn.Module):
    def __init__(self, num_features: int = 24, in_channels: int = 1):
        super().__init__()
        chans = (in_channels, 16, 32, 64, 128)
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], 3, stride=2)
            for i in range(4))
        self.head = nn.Linear(128, num_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) -> (B, num_features)."""
        for conv in self.convs:
            pt, pb = same_pads(x.shape[2], 3, 2)
            pl, pr = same_pads(x.shape[3], 3, 2)
            x = F.relu(conv(F.pad(x, (pl, pr, pt, pb))))
        return self.head(x.mean(dim=(2, 3)))
