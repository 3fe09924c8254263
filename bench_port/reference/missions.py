"""Mission logic: local-target selection, goal sampling, FSM phases.

The port of neoplanner_tpu/sim/missions.py (``set_local_target`` :28,
``save_fsm_graph`` :83, ``sample_clear_goal`` :99), batched over envs. The
JAX functions draw their own random numbers from a key; these take the
draws as arguments (a standard normal pair for the local-target noise, a
uniform for the goal), so a caller can feed either a ``torch.Generator``'s
draws or another framework's.
"""

from __future__ import annotations

import math

import torch

from .config import MissionParams, PlannerParams
from . import query

PHASE_TAKEOFF = 0
PHASE_HOVER = 1
PHASE_MISSION = 2
PHASE_DONE = 3

_ESCAPE_STEPS = 16  # static bound of the reference's escape while-loop


def set_local_target(pmap, pos2d: torch.Tensor, goal2d: torch.Tensor,
                     noise: torch.Tensor, retry_seed: torch.Tensor,
                     mp: MissionParams, pp: PlannerParams):
    """Receding-horizon local targets (traj_planner_node.py:450-488) on the
    planning map pmap (the scene SDF or the sensed grid ESDF).

    pos2d/goal2d (B, 2); noise (B, 2) standard normal, applied where
    retry_seed > 0. Returns (target_state (B, 2, 2) = [pos; vel], near (B,)).
    """
    diff = goal2d - pos2d
    dist = torch.linalg.vector_norm(diff, dim=-1)
    near = dist < mp.longitu_step_dis
    longi = diff / torch.clamp(dist, min=1e-9)[:, None]
    lat = torch.stack([longi[:, 1], -longi[:, 0]], dim=-1)
    lt = pos2d + mp.longitu_step_dis * longi \
        + noise * (retry_seed > 0).to(noise.dtype)[:, None]
    flag = torch.zeros_like(dist, dtype=torch.int32)
    move = torch.full_like(dist, mp.lateral_step_length)
    for _ in range(_ESCAPE_STEPS):
        blocked = query.has_collision(pmap, lt[:, None], pp.safe_dis)[:, 0]
        direction = torch.where(flag == 0, 1.0, -1.0).to(lt.dtype)
        lt = torch.where(blocked[:, None], lt + (direction * move)[:, None]
                         * lat, lt)
        flag = torch.where(blocked, 1 - flag, flag)
        move = torch.where(blocked, move + mp.lateral_step_length, move)
    to_goal = goal2d - lt
    goal_dir = to_goal / torch.clamp(
        torch.linalg.vector_norm(to_goal, dim=-1, keepdim=True), min=1e-9)
    tvel = mp.move_vel_frac * pp.v_max * goal_dir
    target_pos = torch.where(near[:, None], goal2d, lt)
    target_vel = torch.where(near[:, None], torch.zeros_like(tvel), tvel)
    return torch.stack([target_pos, target_vel], dim=1), near


def sample_random_goal(u: torch.Tensor, flap: torch.Tensor):
    """The data-collection goal sampler (manager_node.py:179-193) from
    uniforms u (B,) in [0, 1): x flips between -1 and 26 each mission,
    y = 4 (u - 0.6). Returns (goal (B, 2), next_flap)."""
    y = 4.0 * (u - 0.6)
    x = torch.where(flap == 0, -1.0, 26.0).to(u.dtype)
    return torch.stack([x, y], dim=-1), 1 - flap


def sample_clear_goal(u: torch.Tensor, flap: torch.Tensor, scene,
                      clear_dis: float):
    """sample_random_goal, nudged to the first clear spot of a ring search
    when it lands within clear_dis of an obstacle (clear_dis <= 0: raw)."""
    goal, flap = sample_random_goal(u, flap)
    if clear_dis <= 0.0:
        return goal, flap
    rs = torch.arange(0.0, 4.1, 0.5, device=u.device)
    angs = torch.arange(8, device=u.device) * (2.0 * math.pi / 8)
    offs = torch.stack([rs[:, None] * torch.cos(angs)[None, :],
                        rs[:, None] * torch.sin(angs)[None, :]],
                       dim=-1).reshape(-1, 2).to(goal.dtype)
    cand = goal[:, None, :] + offs                              # (B, 72, 2)
    dis = query.distance(scene, cand)
    ok = dis > clear_dis
    idx = torch.argmax(ok.to(torch.int8), dim=1)
    picked = cand[torch.arange(cand.shape[0], device=u.device), idx]
    return torch.where(ok.any(1)[:, None], picked, goal), flap
