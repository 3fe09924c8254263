"""Network input formation: depth + state -> PlannerNet inputs, expert
solutions -> training labels, and the network's body-frame waypoints back
to the world.

The port of neoplanner_tpu/learn/data.py (``normalize_depth``,
``motion_vector``, ``wpts_to_body``, ``wpts_from_body``, ``make_label``,
``flat_input``), batched over a leading axis. The recorder (labels), the
trainer (its dataset) and the net planners (inference) share them.
"""

from __future__ import annotations

import torch

from . import frames
from .types import DroneState

MOTION_DIM = 24


def normalize_depth(depth: torch.Tensor) -> torch.Tensor:
    """Scale each frame (B, H, W) so its max is 255 (record_planner.py:15)."""
    peak = depth.amax(dim=(-2, -1), keepdim=True)
    return depth / torch.clamp(peak, min=1e-6) * 255.0


def motion_vector(drone: DroneState, des_pos_z: float,
                  plan_init_state: torch.Tensor,
                  target_state: torch.Tensor) -> torch.Tensor:
    """The 24-dim motion input (record_planner.py:17-49), (B, 24):
    [local_vel(3), R row-major(9), body-frame plan-init pos(3)/vel(3),
     body-frame target pos(3)/vel(3)]. States are (B, 2, 2) [pos; vel]."""
    q = drone.quat
    local_vel = frames.quat_rotate_inv(q, drone.vel)
    rot = frames.quat_to_matrix(q).reshape(q.shape[0], 9)

    def lift(s):
        zero = torch.zeros_like(s[:, 0, 0])
        pos3 = torch.stack([s[:, 0, 0], s[:, 0, 1], zero + des_pos_z], -1)
        vel3 = torch.stack([s[:, 1, 0], s[:, 1, 1], zero], -1)
        return pos3, vel3

    init_pos3, init_vel3 = lift(plan_init_state)
    tgt_pos3, tgt_vel3 = lift(target_state)
    return torch.cat([
        local_vel, rot,
        frames.quat_rotate_inv(q, init_pos3 - drone.pos),
        frames.quat_rotate_inv(q, init_vel3 - drone.vel),
        frames.quat_rotate_inv(q, tgt_pos3 - drone.pos),
        frames.quat_rotate_inv(q, tgt_vel3 - drone.vel)], dim=-1)


def wpts_to_body(drone: DroneState, des_pos_z: float,
                 int_wpts: torch.Tensor) -> torch.Tensor:
    """Expert waypoints (B, D=2, n) world -> body-frame 3-D labels (B, 3n),
    waypoint-major, z at des_pos_z (form_nn_output, record_planner.py:61-72).
    """
    B, _, n = int_wpts.shape
    w3 = torch.cat([int_wpts, int_wpts.new_full((B, 1, n), des_pos_z)], 1)
    rel = (w3 - drone.pos[:, :, None]).transpose(1, 2)      # (B, n, 3)
    return frames.quat_rotate_inv(drone.quat[:, None, :], rel).reshape(
        B, 3 * n)


def make_label(drone: DroneState, des_pos_z: float, int_wpts: torch.Tensor,
               ts: torch.Tensor) -> torch.Tensor:
    """The 9-dim training label (B, 9): body-frame waypoints, then the
    durations (record_planner.py:173; csv columns wpts1_* wpts2_* ts1-3)."""
    return torch.cat([wpts_to_body(drone, des_pos_z, int_wpts), ts], -1)


def flat_input(depth_norm: torch.Tensor, motion: torch.Tensor) -> torch.Tensor:
    """The ONNX-contract flat vector (B, h*w + 24): the flattened frame,
    then the motion vector (process_input_np, nn_trainer.py:52-59)."""
    return torch.cat([depth_norm.flatten(-2), motion], -1)


def wpts_from_body(drone: DroneState, wpts_local_flat: torch.Tensor,
                   dims: int) -> torch.Tensor:
    """Network waypoints (B, 3n) body frame -> world, z dropped: (B, D, n)."""
    B = wpts_local_flat.shape[0]
    local = wpts_local_flat.reshape(B, -1, 3)
    world = frames.quat_rotate(drone.quat[:, None, :], local) \
        + drone.pos[:, None, :]
    return world[..., :dims].transpose(1, 2)
