"""The initializer network's prediction: the port of
neoplanner_tpu/plan/nn_init.py ``predict`` (:41) and ``nn_trajectory``
(:65), f32 only."""

from __future__ import annotations

import torch

from neoplanner_tpu_torch.config import PlannerParams
from neoplanner_tpu_torch.core.types import DroneState, Trajectory
from neoplanner_tpu_torch.learn import data
from neoplanner_tpu_torch.ops import minco


@torch.no_grad()
def predict(net, depth: torch.Tensor, drone: DroneState, des_pos_z: float,
            plan_init_state: torch.Tensor, target_state: torch.Tensor,
            pp: PlannerParams):
    """One forward pass for B envs -> (int_wpts (B, D, M-1) world frame,
    ts (B, M)). Durations are clipped into (t_min, t_max) so the optimizer's
    tau map stays finite (nn_planner.py:67-111). The net runs in eval()
    mode (the JAX package's train=False: BatchNorm on its running stats)
    and is left in the mode it came in."""
    motion = data.motion_vector(drone, des_pos_z, plan_init_state,
                                target_state)
    was_training = net.training
    net.eval()
    try:
        out = net(data.normalize_depth(depth)[..., None], motion)
    finally:
        net.train(was_training)
    n3 = 3 * pp.num_wpts
    int_wpts = data.wpts_from_body(drone, out[:, :n3], pp.dims)
    ts = torch.clamp(out[:, n3:], pp.t_min + 1e-3, pp.t_max - 1e-3)
    return int_wpts, ts


@torch.no_grad()
def nn_trajectory(net, depth: torch.Tensor, drone: DroneState,
                  des_pos_z: float, plan_init_state: torch.Tensor,
                  target_state: torch.Tensor, head: torch.Tensor,
                  tail: torch.Tensor, pp: PlannerParams) -> Trajectory:
    """The 'nn' planner: the prediction used as it is, its coefficients
    solved between the boundary states head/tail (B, 3, 2); no optimization
    and no costs (zeros), always accepted — the reference's 'nn' mode
    trusts the network."""
    int_wpts, ts = predict(net, depth, drone, des_pos_z, plan_init_state,
                           target_state, pp)
    coeffs = minco.solve_coeffs(head, tail, int_wpts, ts)
    B = ts.shape[0]
    return Trajectory(int_wpts=int_wpts, ts=ts, coeffs=coeffs,
                      costs=ts.new_zeros((B, 4)),
                      ok=torch.ones(B, dtype=torch.bool, device=ts.device),
                      iters=torch.zeros(B, dtype=torch.int32,
                                        device=ts.device))
