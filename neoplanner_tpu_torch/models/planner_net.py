"""PlannerNet: the trajectory-initializer network, 'mlp' fusion.

The port of neoplanner_tpu/models/planner_net.py ``PlannerNet`` (:45):

  depth (B, H, W, 1) --smallconv--> 24     motion (24) --MLP 48/24/24/24--> 24
                          concat (48) --MLP 48/96/96--> 9 outputs
                          (2 body-frame 3-D waypoints + 3 durations)

LeakyReLU (slope 0.01) between the dense layers, none after the last.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from neoplanner_tpu_torch.config import NetParams
from neoplanner_tpu_torch.models.resnet import SmallConvEncoder


class PlannerNet(nn.Module):
    def __init__(self, np_cfg: NetParams = NetParams()):
        super().__init__()
        if np_cfg.backbone != "smallconv" or np_cfg.fusion_arch != "mlp":
            raise NotImplementedError(
                "the port has the smallconv backbone with 'mlp' fusion; "
                f"got {np_cfg.backbone}/{np_cfg.fusion_arch}")
        self.np_cfg = np_cfg
        self.img_backbone = SmallConvEncoder(np_cfg.img_feature_size)
        dims = (np_cfg.motion_input_size, 48, 24, 24,
                np_cfg.motion_feature_size)
        self.motion_backbone = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1]) for i in range(4))
        fdims = (np_cfg.img_feature_size + np_cfg.motion_feature_size, 48, 96,
                 96, np_cfg.output_size)
        self.mlp = nn.ModuleList(
            nn.Linear(fdims[i], fdims[i + 1]) for i in range(4))

    @staticmethod
    def _stack(layers, x):
        for i, layer in enumerate(layers):
            x = layer(x)
            if i < len(layers) - 1:
                x = F.leaky_relu(x, 0.01)
        return x

    def forward(self, img: torch.Tensor, motion: torch.Tensor) -> torch.Tensor:
        """img (B, H, W, 1) in [0, 255] (NHWC, as the JAX net); motion (B, 24).
        -> (B, 9)."""
        feat = self.img_backbone(img.permute(0, 3, 1, 2))
        x = self._stack(self.motion_backbone, motion)
        return self._stack(self.mlp, torch.cat([feat, x], dim=-1))

    def forward_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """The ONNX I/O contract (apply_flat, planner_net.py:108): flat
        (B, W*H + 24), the frame row-major then the motion vector ->
        (B, 9)."""
        cfg = self.np_cfg
        n_img = cfg.img_width * cfg.img_height
        img = flat[:, :n_img].reshape(-1, cfg.img_height, cfg.img_width, 1)
        return self(img, flat[:, n_img:])


def load(path: str, np_cfg: NetParams, device="cuda") -> PlannerNet:
    """PlannerNet in eval mode on ``device`` with the weights of an exported
    .onnx file (learn/weights.from_onnx)."""
    from neoplanner_tpu_torch import _cuda
    from neoplanner_tpu_torch.learn import weights
    net = PlannerNet(np_cfg)
    net.load_state_dict(weights.from_onnx(path))
    return net.to(_cuda.resolve_device(device)).eval()
