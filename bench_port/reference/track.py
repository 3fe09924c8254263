"""One tracking segment per env: kernels B3 and B10 and their plain
versions.

:func:`track_segment` runs the segment's substeps (the cascaded controller
and dynamics, the goal latch, the freeze outside the mission phase, the
10 Hz weighted metric on the scene SDF and the per-substep trace) for every
env. ``i0`` is the segment's first substep: the metric ticks where
(t + i0) % 6 == 0, so a segment tracked in chunks (the sensor-rate loop)
keeps the cadence of one unchunked segment. For CUDA tensors it launches
``csrc/track.cu`` (one warp per env, looping over the substeps); for CPU
tensors it runs :func:`_track_plain`, the substep loop of
neoplanner_tpu/sim/env.py ``_track_segment`` (:295).
:func:`track_segment_grid` is the same loop for the sensed-grid metric: the
kernel (B10, or :func:`_track_grid_plain`) runs without a distance query
and returns the 10 Hz tick mask; the collision term then comes from a
nearest sample of each env's ESDF at the tick positions, outside the kernel
(the map never feeds back into the dynamics, so this is exact).

Replaces: neoplanner_tpu/sim/track_pallas.py ``_make_track_kernel`` (:94),
with_dis=True via ``track_segment`` (:284) (B3), with_dis=False via
``track_segment_grid`` (:322) (B10). Bound on the H100: device memory —
~1.4 KB of commands in and 3.6 KB of trace out per env against ~150 flops
per substep, but the substep chain is serial. Design: one warp per env
reads its commands coalesced into shared memory, its lanes compute the
command-only terms of all substeps at once, every lane runs the chain on
the same values, and the lanes store the trace coalesced after it; the
attitude is computed once, after the chain. B3 reads its env's primitive
table once into the warp's shared memory, and its lanes split the
tick-time distance query (a warp min), up to :data:`MAX_PRIMS` primitives
an env.
"""

from __future__ import annotations

import torch

from .config import MissionParams, PlannerParams, SimParams
from .types import DroneState
from . import esdf as esdf_map
from . import query
from . import scene as scene_map
from . import dynamics, missions

METRIC_EVERY = 6   # 60 Hz commands, 10 Hz metric


def track_segment(state, cmds: torch.Tensor, pp: PlannerParams,
                  mp: MissionParams, sp: SimParams, i0: int = 0):
    """Track cmds (B, spr, 3, 2) [pos; vel; acc] setpoints from ``state`` (an
    env.EnvState), the first being substep i0 of the segment. Returns
    (drone, reached (B,), steps (B,) int32, metrics (B, 3), metric_pos
    (B, 2), trace (B, spr, 5, 3))."""
    return _track_plain(state, cmds, pp, mp, sp, i0)


def _track_plain(state, cmds, pp, mp, sp, i0=0):
    """B3's plain version."""
    return _substeps(state, cmds, pp, mp, sp, True, i0)[:6]


def _track_grid_plain(state, cmds, pp, mp, sp, i0=0):
    """B10's plain version: the metric without the collision term, and the
    tick mask (B, spr) as a seventh output."""
    return _substeps(state, cmds, pp, mp, sp, False, i0)


def _substeps(state, cmds, pp, mp, sp, with_dis: bool, i0: int):
    B, spr = cmds.shape[:2]
    active = state.phase == missions.PHASE_MISSION
    moving = active | (state.phase == missions.PHASE_TAKEOFF)
    freeze_phase = ~moving
    drone, reached, steps = state.drone, state.reached, state.steps
    metrics, metric_pos = state.metrics, state.metric_pos
    zeros = torch.zeros(B, dtype=cmds.dtype, device=cmds.device)
    rows, ticks = [], []
    for i in range(spr):
        cmd = cmds[:, i]
        pos_des = torch.stack([cmd[:, 0, 0], cmd[:, 0, 1],
                               torch.full_like(zeros, mp.des_pos_z)], -1)
        vel_des = torch.stack([cmd[:, 1, 0], cmd[:, 1, 1], zeros], -1)
        acc_des = torch.stack([cmd[:, 2, 0], cmd[:, 2, 1], zeros], -1)
        speed = torch.linalg.vector_norm(cmd[:, 1], dim=-1)
        yaw_des = torch.where(speed > 0.05,
                              torch.atan2(cmd[:, 1, 1], cmd[:, 1, 0]),
                              drone.yaw)
        stepped = dynamics.step(drone, pos_des, vel_des, acc_des, yaw_des, sp)
        frz = reached | freeze_phase
        drone = DroneState(
            pos=torch.where(frz[:, None], drone.pos, stepped.pos),
            vel=torch.where(frz[:, None], drone.vel, stepped.vel),
            quat=torch.where(frz[:, None], drone.quat, stepped.quat),
            yaw=torch.where(frz, drone.yaw, stepped.yaw))
        pos2 = drone.pos[:, :2]
        reached = reached | (active & (torch.linalg.vector_norm(
            pos2 - state.goal, dim=-1) < mp.target_reach_threshold))
        tick = ((i + i0) % METRIC_EVERY == 0) & active & ~reached
        d_dist = torch.linalg.vector_norm(pos2 - metric_pos, dim=-1)
        violate_vel = (drone.vel[:, :2] ** 2).sum(-1) - pp.v_max ** 2
        if with_dis:
            dis = query.distance(state.scene, pos2[:, None])[:, 0]
            violate_dis = torch.clamp(
                pp.safe_dis - torch.clamp(dis, min=0.0), min=0.0) ** 3
        else:
            violate_dis = zeros
        delta = torch.stack([d_dist, torch.clamp(violate_vel, min=0.0) ** 3,
                             violate_dis], -1)
        metrics = metrics + torch.where(tick[:, None], delta,
                                        torch.zeros_like(delta))
        metric_pos = torch.where(tick[:, None], pos2, metric_pos)
        steps = steps + (active & ~reached).to(steps.dtype)
        rows.append(torch.stack([drone.pos, drone.vel, pos_des, vel_des,
                                 acc_des], dim=1))
        ticks.append(tick.to(cmds.dtype))
    return (drone, reached, steps, metrics, metric_pos, torch.stack(rows, 1),
            torch.stack(ticks, 1))


def track_segment_grid(state, cmds: torch.Tensor, pp: PlannerParams,
                       mp: MissionParams, sp: SimParams, i0: int = 0):
    """track_segment with the collision metric on each env's sensed grid
    (state.emap, nearest cell). Same arguments and outputs as
    :func:`track_segment`."""
    drone, reached, steps, metrics, metric_pos, trace, ticks = \
        _track_grid_plain(state, cmds, pp, mp, sp, i0)
    # the collision term at the statically known tick substeps
    t_ticks = [t for t in range(cmds.shape[1])
               if (t + i0) % METRIC_EVERY == 0]
    pos = trace[:, t_ticks, 0, :2]                            # (B, T, 2)
    dis = esdf_map.nearest_distance(state.emap, pos)
    dviol = torch.clamp(pp.safe_dis - torch.clamp(dis, min=0.0), min=0.0)
    m2 = (ticks[:, t_ticks] * dviol ** 3).sum(1)
    metrics = metrics + torch.stack(
        [torch.zeros_like(m2), torch.zeros_like(m2), m2], 1)
    return drone, reached, steps, metrics, metric_pos, trace

