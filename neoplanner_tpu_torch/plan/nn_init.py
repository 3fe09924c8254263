"""The initializer network's prediction: the port of
neoplanner_tpu/plan/nn_init.py ``predict`` (:41), f32 only."""

from __future__ import annotations

import torch

from neoplanner_tpu_torch.config import PlannerParams
from neoplanner_tpu_torch.core.types import DroneState
from neoplanner_tpu_torch.learn import data


@torch.no_grad()
def predict(net, depth: torch.Tensor, drone: DroneState, des_pos_z: float,
            plan_init_state: torch.Tensor, target_state: torch.Tensor,
            pp: PlannerParams):
    """One forward pass for B envs -> (int_wpts (B, D, M-1) world frame,
    ts (B, M)). Durations are clipped into (t_min, t_max) so the optimizer's
    tau map stays finite (nn_planner.py:67-111)."""
    motion = data.motion_vector(drone, des_pos_z, plan_init_state,
                                target_state)
    out = net(data.normalize_depth(depth)[..., None], motion)
    n3 = 3 * pp.num_wpts
    int_wpts = data.wpts_from_body(drone, out[:, :n3], pp.dims)
    ts = torch.clamp(out[:, n3:], pp.t_min + 1e-3, pp.t_max - 1e-3)
    return int_wpts, ts
