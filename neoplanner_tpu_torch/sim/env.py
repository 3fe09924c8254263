"""The closed loop on the scene SDF with NEO planning: reset, step, rollout.

The port of neoplanner_tpu/sim/env.py for its flagship configuration
(bench.py:101-142): ground-truth sensing, the analytic scene SDF for every
distance query (``plan_map='scene'``, the scene-lite state of reset
:147-156), the NEO planner (``_replan`` :219-293), random missions and
periodic replanning (``step_segment`` :452), and ``rollout`` (:720). The
grid/vision paths, the other planners and mission modes are not ported.

B envs advance together. Each segment: pick the local target, render the
depth frame (kernel B4), run the PlannerNet, refine with the lazy L-BFGS
bank (kernel B1, acceptance and coefficients through kernel B5), sample the
new setpoints, then track them for steps_per_replan substeps (kernel B3).

Random draws come from the state's ``torch.Generator``, one :class:`Draws`
per segment; a caller may pass its own draws instead (the parity tests pass
the JAX package's threefry draws, which torch cannot replay).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, PlannerParams,
                                         SimParams)
from neoplanner_tpu_torch.core.types import BoxWorld, DroneState, _Replace
from neoplanner_tpu_torch.mapping import scene as scene_map
from neoplanner_tpu_torch.ops import minco
from neoplanner_tpu_torch.plan import neo
from neoplanner_tpu_torch.sense import raycast
from neoplanner_tpu_torch.sim import dynamics, missions, track
from neoplanner_tpu_torch.utils.profiling import stage

METRIC_WEIGHTS = (1.0, 1.0, 100.0)  # distance, feasibility, collision


@dataclass
class EnvState(_Replace):
    drone: DroneState
    scene: scene_map.SceneMap
    world: BoxWorld
    buffer: torch.Tensor        # (B, N_BUF, 3, 2) setpoints; 'now' = row 0
    goal: torch.Tensor          # (B, 2)
    phase: torch.Tensor         # (B,) int32 mission FSM phase
    near_goal: torch.Tensor     # (B,) bool: local target == global goal
    reached: torch.Tensor       # (B,) bool
    failed: torch.Tensor        # (B,) bool
    fail_count: torch.Tensor    # (B,) int32 consecutive replan failures
    steps: torch.Tensor         # (B,) int32 cmd steps in current mission
    flap: torch.Tensor          # (B,) int32 random-goal flip-flop
    metric_pos: torch.Tensor    # (B, 2) last 10 Hz-sampled position
    metrics: torch.Tensor       # (B, 3) distance / vel-viol / coll-viol
    carry_wpts: torch.Tensor    # (B, D, M-1) waypoints relative to plan init
    carry_ts: torch.Tensor      # (B, M)
    has_carry: torch.Tensor     # (B,) bool
    plan_count: torch.Tensor    # (B,) int32 optimizations run
    iter_sum: torch.Tensor      # (B,) int32 L-BFGS iterations
    missions_done: torch.Tensor  # (B,) int32
    missions_ok: torch.Tensor    # (B,) int32
    metric_ok_sum: torch.Tensor  # (B,) weighted metric of the ok missions
    generator: torch.Generator


@dataclass
class Draws(_Replace):
    """The random numbers of one segment."""

    target_noise: torch.Tensor  # (B, 2) N(0, 1): local-target retry noise
    bank_noise: torch.Tensor    # (B, retry_num, D, M-1) N(0, 1): retry seeds
    goal_u: torch.Tensor        # (B,) U[0, 1): next random goal


@dataclass
class SegmentInfo(_Replace):
    planned: torch.Tensor   # (B,) bool: a replan was attempted
    ok: torch.Tensor        # (B,) bool: the plan was accepted
    int_wpts: torch.Tensor  # (B, D, M-1)
    ts: torch.Tensor        # (B, M)
    iters: torch.Tensor     # (B,) L-BFGS iterations spent
    trace: torch.Tensor     # (B, spr, 5, 3) [pos, vel, des pos/vel/acc]


def n_traj_samples(pp: PlannerParams, mp: MissionParams) -> int:
    return int(math.ceil(pp.num_pieces * pp.t_max * mp.cmd_hz))


def n_buffer(pp: PlannerParams, mp: MissionParams) -> int:
    return n_traj_samples(pp, mp) + mp.steps_per_replan


def draw(gen: torch.Generator, B: int, pp: PlannerParams) -> Draws:
    dev = gen.device
    return Draws(
        target_noise=torch.randn((B, 2), generator=gen, device=dev),
        bank_noise=torch.randn((B, pp.retry_num, pp.dims, pp.num_wpts),
                               generator=gen, device=dev),
        goal_u=torch.rand((B,), generator=gen, device=dev))


def reset(world: BoxWorld, pp: PlannerParams, mp: MissionParams,
          mapp: MapParams, generator: torch.Generator,
          goal: Optional[torch.Tensor] = None,
          goal_u: Optional[torch.Tensor] = None) -> EnvState:
    """B envs hovering at (0, 0, hover_height) in the mission phase (the
    JAX reset's skip_takeoff=True; takeoff is not ported). Without a goal,
    each env samples a random goal (from goal_u, else from the generator),
    as in random missions."""
    B = world.centers.shape[0]
    dev = world.centers.device
    scene = scene_map.build(world, mapp)
    flap = torch.zeros(B, dtype=torch.int32, device=dev)
    if goal is None:
        if goal_u is None:
            goal_u = torch.rand((B,), generator=generator, device=dev)
        goal, flap = missions.sample_clear_goal(goal_u, flap, scene,
                                                mp.goal_clear_dis)
    start = torch.zeros((B, 2), device=dev)
    drone = dynamics.init_state(torch.cat(
        [start, torch.full((B, 1), mp.hover_height, device=dev)], dim=1))
    buffer = torch.zeros((B, n_buffer(pp, mp), 3, 2), device=dev)
    buffer[:, :, 0, :] = start[:, None, :]

    def zeros_i():
        return torch.zeros(B, dtype=torch.int32, device=dev)

    def false():
        return torch.zeros(B, dtype=torch.bool, device=dev)

    return EnvState(
        drone=drone, scene=scene, world=world, buffer=buffer,
        goal=goal.to(torch.float32),
        phase=torch.full((B,), missions.PHASE_MISSION, dtype=torch.int32,
                         device=dev),
        near_goal=false(), reached=false(), failed=false(),
        fail_count=zeros_i(), steps=zeros_i(), flap=flap,
        metric_pos=start.clone(), metrics=torch.zeros((B, 3), device=dev),
        carry_wpts=torch.zeros((B, pp.dims, pp.num_wpts), device=dev),
        carry_ts=torch.full((B, pp.num_pieces), pp.init_t, device=dev),
        has_carry=false(), plan_count=zeros_i(), iter_sum=zeros_i(),
        missions_done=zeros_i(), missions_ok=zeros_i(),
        metric_ok_sum=torch.zeros(B, device=dev), generator=generator)


def _replan(state: EnvState, pp, mp, cam, net, draws: Draws, timer=None):
    """NEO plan from the state one replan period ahead (buffer row spr)."""
    ahead = state.buffer[:, mp.steps_per_replan]            # (B, 3, 2)
    target_state, near = missions.set_local_target(
        state.scene, ahead[:, 0], state.goal, draws.target_noise,
        state.fail_count, mp, pp)
    with stage(timer, "render"):
        depth = raycast.render_depth_auto(state.world, state.drone.pos,
                                          state.drone.quat, cam)
    traj = neo.enhanced_plan(state.scene, net, depth, state.drone,
                             mp.des_pos_z, ahead[:, :2], target_state,
                             draws.bank_noise, pp, timer=timer)
    with stage(timer, "plan"):
        new_cmd, _, _ = minco.full_state_cmd(traj.coeffs, traj.ts,
                                             mp.cmd_hz, n_traj_samples(pp, mp))
    return traj, new_cmd, near, ahead[:, :2]


def step_segment(state: EnvState, pp: PlannerParams, mp: MissionParams,
                 sp: SimParams, cam: CameraParams, net,
                 draws: Optional[Draws] = None, timer=None):
    """One replan period for every env: (maybe) replan, then track
    steps_per_replan setpoints; finished missions count and draw a new goal.
    Returns (state, SegmentInfo). ``timer`` (a utils.profiling.StageTimer)
    records the render, net, plan and track stages."""
    spr = mp.steps_per_replan
    B, nbuf = state.buffer.shape[:2]
    if draws is None:
        draws = draw(state.generator, B, pp)

    do_replan = ((state.phase == missions.PHASE_MISSION) & ~state.reached
                 & ~state.failed & ~state.near_goal)
    traj, new_cmd, near, plan_init = _replan(state, pp, mp, cam, net, draws,
                                             timer)
    plan_ok = traj.ok & do_replan

    track_cmds = state.buffer[:, :spr].contiguous()
    shifted = torch.cat([state.buffer[:, spr:],
                         state.buffer[:, -1:].expand(B, spr, 3, 2)], dim=1)
    planned = torch.cat([new_cmd, new_cmd[:, -1:].expand(
        B, nbuf - new_cmd.shape[1], 3, 2)], dim=1)
    ok4 = plan_ok[:, None, None, None]
    zero_i = torch.zeros_like(state.fail_count)
    state = state.replace(
        buffer=torch.where(ok4, planned, shifted),
        fail_count=torch.where(do_replan, torch.where(
            plan_ok, zero_i, state.fail_count + 1), state.fail_count),
        near_goal=torch.where(plan_ok, near, state.near_goal),
        plan_count=state.plan_count + do_replan.to(torch.int32),
        iter_sum=state.iter_sum + torch.where(do_replan, traj.iters, zero_i),
        carry_wpts=torch.where(plan_ok[:, None, None],
                               traj.int_wpts - plan_init[:, 0, :, None],
                               state.carry_wpts),
        carry_ts=torch.where(plan_ok[:, None], traj.ts, state.carry_ts),
        has_carry=state.has_carry | plan_ok)

    with stage(timer, "track"):
        drone, reached, steps, metrics, metric_pos, trace = \
            track.track_segment(state, track_cmds, pp, mp, sp)
    info = SegmentInfo(planned=do_replan, ok=plan_ok, int_wpts=traj.int_wpts,
                       ts=traj.ts, iters=traj.iters, trace=trace)

    failed = state.failed | (state.fail_count > mp.local_target_retries) \
        | (steps > mp.max_mission_steps)
    done = reached | failed
    wm = metrics @ metrics.new_tensor(METRIC_WEIGHTS)
    mission_ok = reached & (wm <= 10.0 * pp.collision_cost_tol)
    new_goal, new_flap = missions.sample_clear_goal(
        draws.goal_u, state.flap, state.scene, mp.goal_clear_dis)
    keep = ~done
    state = state.replace(
        drone=drone, metric_pos=metric_pos,
        metric_ok_sum=state.metric_ok_sum + torch.where(
            done & mission_ok, wm, torch.zeros_like(wm)),
        goal=torch.where(done[:, None], new_goal, state.goal),
        flap=torch.where(done, new_flap, state.flap),
        reached=reached & keep, failed=failed & keep,
        near_goal=state.near_goal & keep,
        fail_count=torch.where(done, zero_i, state.fail_count),
        steps=torch.where(done, zero_i, steps),
        metrics=torch.where(done[:, None], torch.zeros_like(metrics), metrics),
        missions_done=state.missions_done + done.to(torch.int32),
        missions_ok=state.missions_ok + (done & mission_ok).to(torch.int32))
    return state, info


def rollout(state: EnvState, num_segments: int, pp: PlannerParams,
            mp: MissionParams, sp: SimParams, cam: CameraParams,
            net) -> EnvState:
    """num_segments replan periods."""
    for _ in range(num_segments):
        state, _ = step_segment(state, pp, mp, sp, cam, net)
    return state
