"""One tracking segment per env: kernels B3 and B10 and their plain
versions.

:func:`track_segment` runs the segment's substeps (the cascaded controller
and dynamics, the goal latch, the freeze outside the mission phase, the
10 Hz weighted metric on the scene SDF and the per-substep trace) for every
env. For CUDA tensors it launches ``csrc/track.cu`` (one thread per env,
looping over the substeps); for CPU tensors it runs :func:`_track_plain`,
the substep loop of neoplanner_tpu/sim/env.py ``_track_segment`` (:295).
:func:`track_segment_grid` is the same loop for the sensed-grid metric: the
kernel (B10, or :func:`_track_grid_plain`) runs without a distance query
and returns the 10 Hz tick mask; the collision term then comes from a
nearest sample of each env's ESDF at the tick positions, outside the kernel
(the map never feeds back into the dynamics, so this is exact).

Replaces: neoplanner_tpu/sim/track_pallas.py ``_make_track_kernel`` (:94),
with_dis=True via ``track_segment`` (:284) (B3), with_dis=False via
``track_segment_grid`` (:322) (B10). Bound on the H100: device memory —
~1.4 KB of commands in and 3.6 KB of trace out per env against ~150 flops
per substep. Design: one thread per env holds the whole drone state in
registers for the segment; B3's env primitives sit in the thread's slice of
shared memory.
"""

from __future__ import annotations

import torch

from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import MissionParams, PlannerParams, SimParams
from neoplanner_tpu_torch.core.types import DroneState
from neoplanner_tpu_torch.mapping import esdf as esdf_map
from neoplanner_tpu_torch.mapping import query
from neoplanner_tpu_torch.mapping import scene as scene_map
from neoplanner_tpu_torch.sim import dynamics, missions

METRIC_EVERY = 6   # 60 Hz commands, 10 Hz metric
_BLOCK = 64        # threads per block of the kernel (csrc/track.cu)
_SMEM_LIMIT = 48 * 1024


def track_segment(state, cmds: torch.Tensor, pp: PlannerParams,
                  mp: MissionParams, sp: SimParams):
    """Track cmds (B, spr, 3, 2) [pos; vel; acc] setpoints from ``state`` (an
    env.EnvState). Returns (drone, reached (B,), steps (B,) int32,
    metrics (B, 3), metric_pos (B, 2), trace (B, spr, 5, 3))."""
    if not cmds.is_cuda:
        return _track_plain(state, cmds, pp, mp, sp)
    return _track_cuda(state, cmds, pp, mp, sp)


def _track_plain(state, cmds, pp, mp, sp):
    """B3's plain version."""
    return _substeps(state, cmds, pp, mp, sp, True)[:6]


def _track_grid_plain(state, cmds, pp, mp, sp):
    """B10's plain version: the metric without the collision term, and the
    tick mask (B, spr) as a seventh output."""
    return _substeps(state, cmds, pp, mp, sp, False)


def _substeps(state, cmds, pp, mp, sp, with_dis: bool):
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
        tick = (i % METRIC_EVERY == 0) & active & ~reached
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


def pack_state(state) -> torch.Tensor:
    """(B, 22) kernel state: pos3 vel3 yaw quat4 goal2 metric_pos2 metrics3
    reached steps active moving."""
    active = state.phase == missions.PHASE_MISSION
    moving = active | (state.phase == missions.PHASE_TAKEOFF)
    d = state.drone
    f32 = torch.float32
    return torch.cat([
        d.pos, d.vel, d.yaw[:, None], d.quat, state.goal, state.metric_pos,
        state.metrics,
        torch.stack([state.reached.to(f32), state.steps.to(f32),
                     active.to(f32), moving.to(f32)], dim=-1)],
        dim=-1).to(f32).contiguous()


def _track_cuda(state, cmds, pp, mp, sp):
    dev = cmds.device
    B, spr = cmds.shape[:2]
    out = torch.empty((B, 18), dtype=torch.float32, device=dev)
    trace = torch.empty((B, spr, 5, 3), dtype=torch.float32, device=dev)
    launch_tracker(cmds.to(torch.float32).contiguous(), pack_state(state),
                   scene_map.pack_prims(state.scene), out, trace, pp, mp, sp)
    drone = DroneState(pos=out[:, 0:3], vel=out[:, 3:6], quat=out[:, 7:11],
                       yaw=out[:, 6])
    return (drone, out[:, 16] > 0.5, out[:, 17].to(torch.int32),
            out[:, 13:16], out[:, 11:13], trace)


def launch_tracker(cmds, st, prims, out, trace, pp, mp, sp) -> None:
    """Launch B3 on prepared tensors: cmds (B, spr, 3, 2), st (B, 22)
    (:func:`pack_state`), prims (B, K, 6); writes out (B, 18) [pos3 vel3
    yaw quat4 metric_pos2 metrics3 reached steps] and trace (B, spr, 5, 3)."""
    dev = cmds.device
    B, spr = cmds.shape[:2]
    n_prims = prims.shape[1]
    if n_prims * 6 * _BLOCK * 4 > _SMEM_LIMIT:
        raise ValueError(f"{n_prims} primitives exceed the tracker's shared "
                         f"memory ({_SMEM_LIMIT} B per block)")
    for t, name, shape in ((cmds, "cmds", (B, spr, 3, 2)),
                           (st, "state", (B, 22)),
                           (prims, "prims", (B, n_prims, 6)),
                           (out, "out", (B, 18)),
                           (trace, "trace", (B, spr, 5, 3))):
        _cuda.require(t, name, shape, torch.float32, dev)
    if B == 0:
        return
    lib = _cuda.load()
    err = lib.neo_track_segment(
        _cuda.ptr(cmds), _cuda.ptr(st), _cuda.ptr(prims), _cuda.ptr(out),
        _cuda.ptr(trace), B, n_prims, spr, _params(pp, mp, sp),
        _cuda.stream_ptr(dev))
    _cuda.check(err, "track_segment")
    _cuda.launches["track_segment"] += 1


def track_segment_grid(state, cmds: torch.Tensor, pp: PlannerParams,
                       mp: MissionParams, sp: SimParams):
    """track_segment with the collision metric on each env's sensed grid
    (state.emap, nearest cell). Same outputs as :func:`track_segment`."""
    if not cmds.is_cuda:
        drone, reached, steps, metrics, metric_pos, trace, ticks = \
            _track_grid_plain(state, cmds, pp, mp, sp)
    else:
        drone, reached, steps, metrics, metric_pos, trace, ticks = \
            _track_grid_cuda(state, cmds, pp, mp, sp)
    # the collision term at the statically known tick substeps
    t_ticks = list(range(0, cmds.shape[1], METRIC_EVERY))
    pos = trace[:, t_ticks, 0, :2]                            # (B, T, 2)
    dis = esdf_map.sample_nearest(state.emap, pos)
    dviol = torch.clamp(pp.safe_dis - torch.clamp(dis, min=0.0), min=0.0)
    m2 = (ticks[:, t_ticks] * dviol ** 3).sum(1)
    metrics = metrics + torch.stack(
        [torch.zeros_like(m2), torch.zeros_like(m2), m2], 1)
    return drone, reached, steps, metrics, metric_pos, trace


def _track_grid_cuda(state, cmds, pp, mp, sp):
    dev = cmds.device
    B, spr = cmds.shape[:2]
    out = torch.empty((B, 18), dtype=torch.float32, device=dev)
    trace = torch.empty((B, spr, 5, 3), dtype=torch.float32, device=dev)
    ticks = torch.empty((B, spr), dtype=torch.float32, device=dev)
    launch_tracker_grid(cmds.to(torch.float32).contiguous(),
                        pack_state(state), out, trace, ticks, pp, mp, sp)
    drone = DroneState(pos=out[:, 0:3], vel=out[:, 3:6], quat=out[:, 7:11],
                       yaw=out[:, 6])
    return (drone, out[:, 16] > 0.5, out[:, 17].to(torch.int32),
            out[:, 13:16], out[:, 11:13], trace, ticks)


def _params(pp, mp, sp):
    return _cuda.host_floats([
        sp.dt, sp.kp_pos, sp.kp_vel, sp.a_max, sp.drag, sp.yaw_rate_max,
        sp.g, mp.des_pos_z, pp.v_max, pp.safe_dis,
        mp.target_reach_threshold])


def launch_tracker_grid(cmds, st, out, trace, ticks, pp, mp, sp) -> None:
    """Launch B10 on prepared tensors: cmds (B, spr, 3, 2), st (B, 22)
    (:func:`pack_state`); writes out (B, 18) (as :func:`launch_tracker`),
    trace (B, spr, 5, 3) and ticks (B, spr)."""
    dev = cmds.device
    B, spr = cmds.shape[:2]
    for t, name, shape in ((cmds, "cmds", (B, spr, 3, 2)),
                           (st, "state", (B, 22)), (out, "out", (B, 18)),
                           (trace, "trace", (B, spr, 5, 3)),
                           (ticks, "ticks", (B, spr))):
        _cuda.require(t, name, shape, torch.float32, dev)
    if B == 0:
        return
    lib = _cuda.load()
    err = lib.neo_track_segment_grid(
        _cuda.ptr(cmds), _cuda.ptr(st), _cuda.ptr(out), _cuda.ptr(trace),
        _cuda.ptr(ticks), B, spr, _params(pp, mp, sp), _cuda.stream_ptr(dev))
    _cuda.check(err, "track_segment_grid")
    _cuda.launches["track_segment_grid"] += 1
