"""Quadrotor point dynamics + cascaded setpoint controller, batched over envs.

The port of neoplanner_tpu/sim/dynamics.py (``init_state`` :29, ``step``
:34): a_cmd = acc_ff + kp_pos (pos_des - pos) + kp_vel (vel_des - vel),
clamped to a_max, integrated semi-implicitly with linear drag; yaw is
rate-limited toward its setpoint and the attitude is the differential-
flatness attitude of (a_cmd, yaw).
"""

from __future__ import annotations

import torch

from .config import SimParams
from . import frames
from .types import DroneState


def init_state(pos: torch.Tensor) -> DroneState:
    """Drones at rest at pos (B, 3), level, yaw 0."""
    B = pos.shape[0]
    return DroneState(pos=pos, vel=torch.zeros_like(pos),
                      quat=frames.quat_identity((B,), device=pos.device),
                      yaw=torch.zeros(B, device=pos.device))


def step(state: DroneState, pos_des, vel_des, acc_des, yaw_des,
         sp: SimParams) -> DroneState:
    """One control + physics step at the command rate; setpoints (B, 3)."""
    a_cmd = acc_des + sp.kp_pos * (pos_des - state.pos) \
        + sp.kp_vel * (vel_des - state.vel)
    a_norm = torch.linalg.vector_norm(a_cmd, dim=-1, keepdim=True)
    a_cmd = a_cmd * torch.clamp(sp.a_max / torch.clamp(a_norm, min=1e-9),
                                max=1.0)
    vel = state.vel + (a_cmd - sp.drag * state.vel) * sp.dt
    pos = state.pos + vel * sp.dt
    dyaw = torch.atan2(torch.sin(yaw_des - state.yaw),
                       torch.cos(yaw_des - state.yaw))
    lim = sp.yaw_rate_max * sp.dt
    yaw = state.yaw + torch.clamp(dyaw, -lim, lim)
    quat = frames.quat_from_accel_yaw(a_cmd, yaw, sp.g)
    return DroneState(pos=pos, vel=vel, quat=quat, yaw=yaw)
