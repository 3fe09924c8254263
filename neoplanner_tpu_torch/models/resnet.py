"""Depth-image encoder of the PlannerNet: the smallconv backbone.

The port of neoplanner_tpu/models/resnet.py ``SmallConvEncoder`` (:71):
four stride-2 3x3 convolutions (16, 32, 64, 128 channels) with flax's 'SAME'
padding and ReLU, global average pooling and a dense head. Input and output
follow PyTorch's NCHW inside; the public PlannerNet keeps NHWC. ResNet18 is
not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def same_pads(n: int, k: int, s: int):
    """TF/flax 'SAME' padding of one spatial dim: (before, after)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


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
