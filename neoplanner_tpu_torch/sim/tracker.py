"""Object-tracking mission: continuous replanning toward a moving target.

The port of neoplanner_tpu/sim/tracker.py (the reference's tracker pair,
tracker_planner_node.py:284-295: an endless replanning loop toward the
last goal message). The moving target is an explicit per-segment array,
and the mission never ends: each segment first clears the reached, near,
failed, steps and phase state, then steps the 'manual' mission mode. The
fail count is kept, so consecutive failures still widen the local
target's noise (the reference's retry ladder).
"""

from __future__ import annotations

from typing import Optional

import torch

from neoplanner_tpu_torch.config import (CameraParams, MissionParams,
                                         PlannerParams, SimParams)
from neoplanner_tpu_torch.sim import env, missions


def _clear(state: env.EnvState) -> env.EnvState:
    """The per-segment reset of the mission flags (tracker.py:39-46)."""
    false = torch.zeros_like(state.reached)
    return state.replace(
        reached=false, near_goal=false, failed=false,
        steps=torch.zeros_like(state.steps),
        phase=torch.full_like(state.phase, missions.PHASE_MISSION))


def track_segment(state: env.EnvState, target: torch.Tensor,
                  pp: PlannerParams, mp: MissionParams, sp: SimParams,
                  cam: Optional[CameraParams] = None, net=None,
                  planner: str = "expert", **step_kw):
    """One replan period chasing each env's current target (B, 2) or one
    target (2,) for all: the goal becomes the target, the mission flags
    are cleared, and env.step_segment runs in the 'manual' mission mode
    with ``planner`` ('expert' as the JAX package defaults) and step_kw
    (draws, timer, solver, replan_mode). Returns (state, SegmentInfo)."""
    goal = torch.as_tensor(target, dtype=state.goal.dtype,
                           device=state.goal.device).expand_as(state.goal)
    state = _clear(state).replace(goal=goal.clone())
    return env.step_segment(state, pp, mp, sp, cam or CameraParams(), net,
                            planner=planner, mission_mode="manual",
                            **step_kw)


def track_segment_stream(state: env.EnvState, targets: torch.Tensor,
                         pp: PlannerParams, mp: MissionParams,
                         sp: SimParams, cam: Optional[CameraParams] = None,
                         net=None, planner: str = "expert", **step_kw):
    """One replan period with C target updates during it, targets (B, C, 2)
    (tracker_planner_node.py:160-162, 284-295): the replan reads the target
    stored by the previous segment's last update, and the stored goal
    follows the targets chunk by chunk (env.step_segment's goal_stream),
    so the next replan starts from the freshest one."""
    return env.step_segment(_clear(state), pp, mp, sp, cam or CameraParams(),
                            net, planner=planner, mission_mode="manual",
                            goal_stream=targets, **step_kw)


def track_rollout(state: env.EnvState, targets: torch.Tensor,
                  pp: PlannerParams, mp: MissionParams, sp: SimParams,
                  **kwargs):
    """Chase a target path: targets (S, 2), one path for every env, or
    (S, B, 2). Returns (final state, drone positions (S, B, 3) at the
    segments' ends)."""
    positions = []
    for target in targets:
        state, _ = track_segment(state, target, pp, mp, sp, **kwargs)
        positions.append(state.drone.pos)
    return state, torch.stack(positions)


def circular_target_path(num_segments: int, center, radius: float,
                         angular_rate: float, replan_period: float,
                         device=None) -> torch.Tensor:
    """A circle traced at angular_rate, sampled once a replan period:
    (S, 2) targets around center (2,)."""
    t = torch.arange(num_segments, device=device,
                     dtype=torch.float32) * replan_period
    ang = angular_rate * t
    center = torch.as_tensor(center, dtype=torch.float32, device=device)
    return center[None, :] + radius * torch.stack([torch.cos(ang),
                                                   torch.sin(ang)], -1)
