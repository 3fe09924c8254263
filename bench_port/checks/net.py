"""The net's 9 raw outputs: ``net_gap``, the largest gap over the largest
output. The program's outputs are read by a forward hook on its net; the
reference net is the plain one, with the same weights from the seed. The
control runs it with TF32 convolutions and products."""

import torch

from harness.check import blocks
from reference import data as rdata
from reference.planner_net import PlannerNet as RefNet

HOOKS = (("neoplanner_tpu_torch.plan.nn_init", "predict"),)


def _forward(net, img, motion, tf32: bool):
    """The plain net's raw outputs (B, 9), TF32 on or off for the
    convolutions and products."""
    conv, mm = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.no_grad():
            feat = net.img_backbone(img.permute(0, 3, 1, 2))
            x = net.motion_backbone(motion)
            return net.mlp(torch.cat([feat, x], dim=-1))
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def read(cap, exact, low, control, system) -> dict:
    calls = cap.of("predict")
    if not calls or system.net is None or not cap.net_out:
        return {}
    net = RefNet(exact(system.net.np_cfg))
    net.load_state_dict(system.weights, strict=True)
    net = net.to(next(iter(system.weights.values())).device).eval()
    gap, scale = 0.0, 0.0
    for (_, args, kw, _out), raw in zip(calls, cap.net_out):
        motion = rdata.motion_vector(exact(args[2]), args[3], exact(args[4]),
                                     exact(args[5]))
        img = rdata.normalize_depth(exact(args[1]))[..., None]

        def run(tf32):
            return torch.cat([_forward(net, img[s], motion[s], tf32)
                              for s in blocks(img.shape[0], 32)])
        ref = run(False)
        got = run(True) if control else exact.t(raw)
        gap = max(gap, float((got - ref).abs().max()))
        scale = max(scale, float(ref.abs().max()))
    return {"net_gap": gap / max(scale, 1e-6)}
