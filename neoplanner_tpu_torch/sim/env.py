"""The closed loop: reset, step, rollout.

The port of neoplanner_tpu/sim/env.py for three paths, with the 'expert',
'warmstart', 'geo', 'nn' and 'neo' planners (``_replan`` :219-293), the
'random', 'predefined' and 'manual' mission modes and the 'periodic',
'online' and 'global' replan modes (``step_segment`` :452), the takeoff
phase (reset :187-193, step_segment :518-522), and ``rollout`` (:720):

- the flagship (bench.py:101-142): ground-truth sensing and the analytic
  scene SDF for every distance query (``sensing='gt', plan_map='scene'``,
  the scene-lite state of reset :147-156: no per-env grids);
- the ground-truth grid (the reference's defaults, reset :157-159):
  ``sensing='gt', plan_map='grid'``, the world rasterized at reset into a
  full-profile exact ESDF (kernel B9 exact) that planning, local targets
  and tracking read;
- the vision loop (examples/profile_vision.py:33-71):
  ``sensing='depth', plan_map='grid'``, the onboard mode in which each
  drone builds its map from its own depth frames (reset :160-166,
  ``fuse_frame`` :363, ``rebuild_esdf`` :408, ``sense_and_map`` :440, the
  depth branch of step_segment :503-516), with ``fuse_frames`` frames fused
  per segment (the sensor-rate loop, step_segment :567-633), with every
  fusion of ``MapParams.fusion`` and an exact or truncated lite ESDF.

The 'geo' planner (the paper's geometric baseline, plan/geo.py) relaxes
a cost-to-go field over the rasterized grid, so it runs on the gt+grid
and vision paths; on the scene path it raises, as the JAX package does.

B envs advance together. Each segment: render the depth frame (kernel B4)
where a net planner reads it or the vision loop fuses it; in the vision
loop fuse it into the log-odds grid (the '2d_dense' fusion: kernel B8 v2,
or B8 v1 on maps that v2 does not take; the '2d' and '3d' scatter
fusions) and rebuild the ESDF (kernel B9 fused for a truncated field, B9
exact for an exact one); pick the local target and plan: the PlannerNet on
the frame and, but for 'nn', a lazy L-BFGS bank (solver 'fused': kernel
B1 on the scene, B6 on per-env ESDF windows; 'per_eval': the loop in
PyTorch with kernel B2s or B7 per evaluation; acceptance and coefficients
through kernel B5); sample the new setpoints, then track them for
steps_per_replan substeps (kernel B3 on the scene, B10 with the grid
metric). With ``fuse_frames`` F > 1 the tracking runs in F chunks and
F - 1 more frames, rendered at ``mapp.fusion_row_stride`` from the poses
after the first F - 1 chunks, are fused: all in one B4 launch and one B8 v3
launch after the last chunk when the ESDF rebuilds once per segment
(``esdf_rate`` 1) and the map and camera suit the dense whole-grid fusion,
else frame by frame after each chunk (B4, the map's fusion, and every
F // esdf_rate chunks the rebuild).

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
from neoplanner_tpu_torch.core.types import (BoxWorld, DroneState, ESDFMap,
                                             _Replace)
from neoplanner_tpu_torch.mapping import esdf as esdf_map
from neoplanner_tpu_torch.mapping import fusion, occupancy
from neoplanner_tpu_torch.mapping import scene as scene_map
from neoplanner_tpu_torch.ops import edt, minco
from neoplanner_tpu_torch.plan import expert, geo, neo, nn_init
from neoplanner_tpu_torch.sense import raycast
from neoplanner_tpu_torch.sim import dynamics, missions, track
from neoplanner_tpu_torch.utils import profiling
from neoplanner_tpu_torch.utils.profiling import stage
from neoplanner_tpu_torch.world import voxelize

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
    goal_list: torch.Tensor     # (B, G, 2) predefined goal tour ((B, 1, 2)
    #                             zeros without one)
    goal_idx: torch.Tensor      # (B,) int32 next tour entry to dispatch
    generator: torch.Generator
    # the grid paths' maps (None on the scene path): the ground-truth
    # full-profile ESDF, or the vision loop's sensed lite ESDF with its
    # log-odds grid and the map parameters that fusion and the ESDF rebuild
    # read (logodds and mapp None on the ground-truth grid)
    emap: Optional[ESDFMap] = None          # (B, H, W)
    logodds: Optional[torch.Tensor] = None  # (B, H, W) fused occupancy
    mapp: Optional[MapParams] = None


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
    drone: DroneState       # the drone at the segment's start
    plan_init: torch.Tensor  # (B, 2, 2) pos/vel the plan started from
    target: torch.Tensor    # (B, 2, 2) the local target state
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


PATHS = (("gt", "scene"), ("gt", "grid"), ("depth", "grid"))
FUSIONS = ("2d", "2d_dense", "3d")


def reset(world: BoxWorld, pp: PlannerParams, mp: MissionParams,
          mapp: MapParams, generator: torch.Generator,
          goal: Optional[torch.Tensor] = None,
          goal_u: Optional[torch.Tensor] = None, sensing: str = "gt",
          plan_map: str = "scene", start_pos: Optional[torch.Tensor] = None,
          skip_takeoff: bool = True,
          goal_list: Optional[torch.Tensor] = None) -> EnvState:
    """B envs at start_pos (B, 2) (default (0, 0)) on the device of the
    worlds: hovering at hover_height in the mission phase, or with
    skip_takeoff=False on the ground (z = 0) in the takeoff phase, which
    step_segment ends once the drone is within 5 cm of hover_height (JAX
    reset :187-193). goal_list (B, G, 2) arms the 'predefined' mission
    tour: without a goal, entry 0 becomes the goal, and the tour's cursor
    starts at 1 (reset :171-178). Without a goal or a tour, each env
    samples a random goal (from goal_u, else from the generator), as in
    random missions; goals are vetted against the ground-truth scene in
    every sensing mode. plan_map='grid' with sensing='gt' rasterizes each
    world (voxelize.occupancy_2d) and builds its exact full-profile ESDF.
    sensing='depth' starts the map unknown: a zero log-odds grid and its
    lite ESDF (exact for mapp.edt_truncation = 0, else truncated), and the
    state keeps mapp for fusing and rebuilding. The state's maps then choose
    the path that step_segment runs."""
    if (sensing, plan_map) not in PATHS:
        raise ValueError(f"unsupported sensing/plan_map {sensing}/{plan_map}"
                         f"; the port runs {PATHS}")
    B = world.centers.shape[0]
    dev = world.centers.device
    scene = scene_map.build(world, mapp)
    origin = (mapp.origin_x, mapp.origin_y)
    emap = logodds = None
    if sensing == "depth":
        if mapp.fusion not in FUSIONS:
            raise ValueError(f"unknown fusion {mapp.fusion!r}; the port "
                             f"runs {FUSIONS}")
        logodds = occupancy.logodds_init(mapp, B, dev)
        emap = esdf_map.build(torch.zeros_like(logodds), origin,
                              mapp.resolution, mapp.edt_truncation,
                              lite=True)
    elif plan_map == "grid":
        emap = esdf_map.build(voxelize.occupancy_2d(world, mapp), origin,
                              mapp.resolution)

    def zeros_i():
        return torch.zeros(B, dtype=torch.int32, device=dev)

    def false():
        return torch.zeros(B, dtype=torch.bool, device=dev)

    flap = zeros_i()
    goal_idx = zeros_i()
    if goal_list is not None:
        goal_list = goal_list.to(device=dev, dtype=torch.float32)
        if goal is None:
            goal = goal_list[:, 0]
        goal_idx = goal_idx + 1
    else:
        goal_list = torch.zeros((B, 1, 2), device=dev)
    if goal is None:
        if goal_u is None:
            goal_u = torch.rand((B,), generator=generator, device=dev)
        goal, flap = missions.sample_clear_goal(goal_u, flap, scene,
                                                mp.goal_clear_dis)
    start = (torch.zeros((B, 2), device=dev) if start_pos is None else
             start_pos.to(device=dev, dtype=torch.float32).expand(B, 2))
    z0 = mp.hover_height if skip_takeoff else 0.0
    drone = dynamics.init_state(torch.cat(
        [start, torch.full((B, 1), z0, device=dev)], dim=1))
    buffer = torch.zeros((B, n_buffer(pp, mp), 3, 2), device=dev)
    buffer[:, :, 0, :] = start[:, None, :]
    phase = missions.PHASE_MISSION if skip_takeoff else missions.PHASE_TAKEOFF
    return EnvState(
        drone=drone, scene=scene, world=world, buffer=buffer,
        goal=goal.to(torch.float32),
        phase=torch.full((B,), phase, dtype=torch.int32, device=dev),
        near_goal=false(), reached=false(), failed=false(),
        fail_count=zeros_i(), steps=zeros_i(), flap=flap,
        metric_pos=start.clone(), metrics=torch.zeros((B, 3), device=dev),
        carry_wpts=torch.zeros((B, pp.dims, pp.num_wpts), device=dev),
        carry_ts=torch.full((B, pp.num_pieces), pp.init_t, device=dev),
        has_carry=false(), plan_count=zeros_i(), iter_sum=zeros_i(),
        missions_done=zeros_i(), missions_ok=zeros_i(),
        metric_ok_sum=torch.zeros(B, device=dev), goal_list=goal_list,
        goal_idx=goal_idx, generator=generator, emap=emap, logodds=logodds,
        mapp=mapp if sensing == "depth" else None)


def fuse_frame(state: EnvState, cam: CameraParams,
               depth: Optional[torch.Tensor] = None,
               depth_stride: int = 1) -> EnvState:
    """Fuse a depth frame (B, h, w) taken from the current pose, rendered at
    depth_stride, into the log-odds grids by mapp.fusion (env.py :363-405)
    — no ESDF rebuild. Without a frame, render one first (kernel B4), at
    mapp.fusion_row_stride ('3d': at full resolution). '2d_dense' runs the
    dense fusion (kernels B8 v2 or v1) where its window covers the sensor's
    reach, else the '2d' scatter fusion, as the reference chooses by
    configuration; '3d' takes full-resolution frames."""
    mapp = state.mapp
    if depth is None:
        depth_stride = mapp.fusion_row_stride if mapp.fusion != "3d" else 1
        depth = raycast.render_depth_auto(state.world, state.drone.pos,
                                          state.drone.quat, cam,
                                          row_stride=depth_stride)
    args = (state.logodds, depth, state.drone.pos, state.drone.quat, cam,
            mapp)
    if mapp.fusion == "2d_dense" and fusion.window_fits(cam, mapp):
        logodds = fusion.insert_depth_2d_dense(*args,
                                               row_stride=depth_stride)
    elif mapp.fusion in ("2d", "2d_dense"):
        logodds = occupancy.insert_depth_2d(*args, row_stride=depth_stride)
    else:
        logodds = occupancy.insert_depth(*args)
    return state.replace(logodds=logodds)


def fuse_frames_multi(state: EnvState, cam: CameraParams, pos: torch.Tensor,
                      quat: torch.Tensor) -> EnvState:
    """Render F frames per env at mapp.fusion_row_stride from the poses pos
    (B, F, 3), quat (B, F, 4) in one launch (kernel B4) and fuse them in
    order into the log-odds grids in one pass (kernel B8 v3)."""
    rs = state.mapp.fusion_row_stride
    depths = raycast.render_depth_auto(state.world, pos, quat, cam,
                                       row_stride=rs)
    logodds = fusion.insert_depth_2d_dense_multi(state.logodds, depths, pos,
                                                 quat, cam, state.mapp,
                                                 row_stride=rs)
    return state.replace(logodds=logodds)


def rebuild_esdf(state: EnvState) -> EnvState:
    """Binarize the fused log-odds and rebuild the ESDF in the state's
    profile (env.py :408-437): a truncated lite field straight from the
    log-odds in one pass (kernel B9 fused) where the reference takes its
    fused kernel (lite, edt_truncation > 0, H % 8 == 0), else esdf.build
    on the binarized grid (kernel B9 exact or B9 banded)."""
    mapp = state.mapp
    lite = state.emap.lite
    if lite and mapp.edt_truncation > 0.0 and mapp.height % 8 == 0:
        field = edt.rebuild_truncated_lite(state.logodds,
                                           occupancy.occ_threshold(mapp),
                                           mapp.resolution,
                                           mapp.edt_truncation)
        return state.replace(emap=state.emap.replace(esdf=field))
    emap = esdf_map.build(occupancy.to_occupancy(state.logodds, mapp),
                          (mapp.origin_x, mapp.origin_y), mapp.resolution,
                          mapp.edt_truncation, lite=lite)
    return state.replace(emap=emap)


def sense_and_map(state: EnvState, cam: CameraParams,
                  depth: Optional[torch.Tensor] = None,
                  timer=None) -> EnvState:
    """Fuse the frame (without one, a frame rendered at the fusion's row
    stride) and rebuild the ESDF (depth cam -> octomap_server -> projected
    map -> ESDF in the reference)."""
    with stage(timer, "fuse"):
        state = fuse_frame(state, cam, depth)
    with stage(timer, "esdf"):
        return rebuild_esdf(state)


PLANNERS = ("expert", "warmstart", "geo", "nn", "neo")


def _check_planner(planner: str, solver: str, pp: PlannerParams) -> None:
    if planner not in PLANNERS:
        raise ValueError(f"unknown planner {planner!r}; the port runs "
                         f"{PLANNERS}")
    if planner in ("geo", "nn", "neo") and pp.num_pieces != 3:
        raise ValueError(f"the {planner!r} planner plans M=3 pieces: the "
                         f"net emits the 2 waypoints and 3 durations of "
                         f"M=3 (NetParams.output_size 9); got "
                         f"num_pieces={pp.num_pieces}")
    if solver not in expert.SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; the port runs "
                         f"{expert.SOLVERS}")


def _replan(state: EnvState, pp, mp, planner: str, solver: str, net,
            depth: Optional[torch.Tensor], pmap, draws: Draws,
            replan_mode: str, timer=None):
    """Plan from the state one replan period ahead (buffer row spr) on the
    planning map pmap with ``planner`` (env.py:258-282): 'expert' the
    multi-start bank, 'warmstart' that bank with the carried solution in
    lane 0, 'geo' the wavefront front end and the warm-started refine
    (the grid paths only), 'nn' the net's prediction as it is, 'neo' the
    prediction refined; the net reads the depth frame. The target is the receding
    horizon's local target, or with replan_mode 'global' the goal itself
    at rest, with near set (env.py:250-255). Returns (trajectory, new
    setpoints, near, plan-init state, target state)."""
    ahead = state.buffer[:, mp.steps_per_replan]            # (B, 3, 2)
    if replan_mode == "global":
        target_state = torch.stack([state.goal,
                                    torch.zeros_like(state.goal)], 1)
        near = torch.ones_like(state.near_goal)
    else:
        with profiling.span("target"):
            target_state, near = missions.set_local_target(
                pmap, ahead[:, 0], state.goal, draws.target_noise,
                state.fail_count, mp, pp)
    head = expert.pad_boundary_state(ahead[:, :2], pp)
    tail = expert.pad_boundary_state(target_state, pp)
    if planner == "expert":
        with stage(timer, "plan"):
            traj = expert.plan(pmap, head, tail, draws.bank_noise, pp,
                               solver=solver)
    elif planner == "warmstart":
        with stage(timer, "plan"):
            q0 = state.carry_wpts + ahead[:, 0, :, None]
            traj = expert.plan_with_carry(pmap, head, tail, q0,
                                          state.carry_ts, state.has_carry,
                                          draws.bank_noise, pp,
                                          solver=solver)
    elif planner == "geo":
        # the wavefront relaxes over the rasterized grid (env.py:264-271)
        if state.emap is None:
            raise ValueError("geo planner needs the rasterized grid; reset "
                             "with plan_map='grid' (scene-lite state has "
                             "none)")
        traj = geo.geo_plan_device(state.emap, head, tail, draws.bank_noise,
                                   pp, solver=solver, timer=timer)
    elif planner == "nn":
        with stage(timer, "net"):
            traj = nn_init.nn_trajectory(net, depth, state.drone,
                                         mp.des_pos_z, ahead[:, :2],
                                         target_state, head, tail, pp)
    else:
        traj = neo.enhanced_plan(pmap, net, depth, state.drone,
                                 mp.des_pos_z, ahead[:, :2], target_state,
                                 draws.bank_noise, pp, timer=timer,
                                 solver=solver)
    with stage(timer, "plan"), profiling.span("cmd"):
        new_cmd, _, _ = minco.full_state_cmd(traj.coeffs, traj.ts,
                                             mp.cmd_hz, n_traj_samples(pp, mp))
    return traj, new_cmd, near, ahead[:, :2], target_state


def _chunks(sensed: bool, spr: int, fuse_frames: int,
            goal_stream: Optional[torch.Tensor], esdf_rate: int) -> int:
    """Tracking chunks of a segment, with the reference's checks
    (step_segment :574-585)."""
    n_chunks = fuse_frames if sensed else 1
    if goal_stream is not None:
        c = goal_stream.shape[1]
        if n_chunks > 1 and c != n_chunks:
            raise ValueError(f"goal_stream length {c} must equal "
                             f"fuse_frames={n_chunks}")
        n_chunks = max(n_chunks, c)
    if esdf_rate > 1 and n_chunks <= 1:
        raise ValueError("esdf_rate > 1 requires fuse_frames chunking "
                         "(sensing='depth', fuse_frames > 1)")
    if n_chunks > 1 and spr % n_chunks != 0:
        raise ValueError(f"{n_chunks} chunks must divide "
                         f"steps_per_replan={spr}")
    return n_chunks


MISSION_MODES = ("random", "predefined", "manual")
REPLAN_MODES = ("periodic", "online", "global")


def step_segment(state: EnvState, pp: PlannerParams, mp: MissionParams,
                 sp: SimParams, cam: CameraParams, net=None,
                 draws: Optional[Draws] = None, timer=None,
                 fuse_frames: int = 1,
                 goal_stream: Optional[torch.Tensor] = None,
                 esdf_rate: int = 1, planner: str = "neo",
                 solver: str = "fused", mission_mode: str = "random",
                 replan_mode: str = "periodic"):
    """One replan period for every env: sense, (maybe) replan, then track
    steps_per_replan setpoints; then the mission mode handles the missions
    that ended. Returns (state, SegmentInfo).

    planner is 'neo' (the net's prediction refined, the default), 'nn' (the
    prediction as it is), 'expert' (the multi-start bank), 'warmstart'
    (that bank with the last accepted solution carried in lane 0) or 'geo'
    (plan/geo.geo_plan_device, on the grid paths); with
    PlannerParams(sampling="absolute") the banks solve off the kernels
    (plan/expert.py); solver
    is 'fused' or 'per_eval' (plan/expert.py). The JAX package defaults to
    'expert' and 'manual': the port's defaults are the flagship loop's.
    Sensing follows the JAX loop (env.py:503-516): with a net planner
    ('nn', 'neo') the frame is rendered once at full resolution for the net
    and, on the vision path (which reset chose with sensing='depth'), fused
    into the map before the ESDF rebuild; the expert planners need no net
    and render no frame for one, so on the vision path they fuse a frame
    rendered at mapp.fusion_row_stride, and on the ground-truth paths they
    render nothing.

    An env in the takeoff phase enters the mission phase once it is within
    5 cm of hover_height (env.py:518-522); only envs in the mission phase
    replan. mission_mode (env.py:653-711): 'random' counts an ended mission
    and draws the next random goal (the data-collection driver);
    'predefined' counts it once and dispatches the next entry of the tour
    that reset armed, then parks at PHASE_DONE; 'manual' parks at
    PHASE_DONE. replan_mode (env.py:526-532, :250-253): 'periodic' replans
    each segment until the local target is the goal, 'online' until the
    goal is reached, 'global' plans once, straight to the goal.

    fuse_frames F > 1 (vision path) tracks the segment in F chunks and
    fuses F - 1 more frames from the poses after the first F - 1 chunks,
    rendered at mapp.fusion_row_stride: after the last chunk, all at once,
    when esdf_rate is 1; else each after its chunk, with an ESDF rebuild
    every F // esdf_rate chunks. goal_stream (B, C, 2) replaces each env's
    goal at the start of each of C tracking chunks (C = F when both are
    given). ``timer`` (a utils.profiling.StageTimer) records the call as
    the span 'segment', and in it the render, fuse, esdf, net, plan and
    track stages, fuse_multi for the batched frames, geo for the 'geo'
    planner's front end, target (the local target), missions (the ended
    missions), and inside plan the bank's spans and counters
    (plan/expert.py) and cmd (the setpoints)."""
    _check_planner(planner, solver, pp)
    if mission_mode not in MISSION_MODES:
        raise ValueError(f"unknown mission_mode: {mission_mode}")
    if replan_mode not in REPLAN_MODES:
        raise ValueError(f"unknown replan_mode: {replan_mode}")
    if draws is None:
        draws = draw(state.generator, state.buffer.shape[0], pp)
    with stage(timer, "segment"):
        state, info = _plan_and_track(state, pp, mp, sp, cam, net, draws,
                                      timer, fuse_frames, goal_stream,
                                      esdf_rate, planner, solver,
                                      replan_mode)
        with profiling.span("missions"):
            state = _end_missions(state, mission_mode, draws, pp, mp)
    return state, info


def _plan_and_track(state: EnvState, pp, mp, sp, cam, net, draws: Draws,
                    timer, fuse_frames: int, goal_stream, esdf_rate: int,
                    planner: str, solver: str, replan_mode: str):
    """step_segment up to the missions' end: sense, (maybe) replan,
    track; returns (state, SegmentInfo)."""
    grid = state.emap is not None          # the gt+grid or vision path
    sensed = state.logodds is not None     # the vision path
    spr = mp.steps_per_replan
    B, nbuf = state.buffer.shape[:2]
    n_chunks = _chunks(sensed, spr, fuse_frames, goal_stream, esdf_rate)

    depth = None
    if planner in ("nn", "neo"):
        with stage(timer, "render"):
            depth = raycast.render_depth_auto(state.world, state.drone.pos,
                                              state.drone.quat, cam)
    if sensed:
        state = sense_and_map(state, cam, depth, timer)
    pmap = state.emap if grid else state.scene

    at_height = (state.drone.pos[:, 2] - mp.hover_height).abs() < 0.05
    state = state.replace(phase=torch.where(
        (state.phase == missions.PHASE_TAKEOFF) & at_height,
        torch.full_like(state.phase, missions.PHASE_MISSION), state.phase))
    do_replan = ((state.phase == missions.PHASE_MISSION) & ~state.reached
                 & ~state.failed)
    if replan_mode != "online":
        do_replan = do_replan & ~state.near_goal
    traj, new_cmd, near, plan_init, target = _replan(
        state, pp, mp, planner, solver, net, depth, pmap, draws, replan_mode,
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

    drone_at_plan = state.drone
    tracker = track.track_segment_grid if grid else track.track_segment
    # Mid-segment frames have no consumer before the segment ends when the
    # ESDF rebuilds once per segment: the tracking follows the command
    # buffer. So, where the dense whole-grid fusion takes the map and the
    # camera, the frames' poses are collected and every frame is fused in
    # one pass after the last chunk (the reference's batch_fuse, :596-601).
    fusing = sensed and fuse_frames > 1
    mapp = state.mapp
    batch_fuse = (fusing and esdf_rate == 1 and mapp.fusion == "2d_dense"
                  and fusion._v2_map(mapp) and fusion.window_fits(cam, mapp))
    chunk = spr // n_chunks
    traces, fuse_pos, fuse_quat = [], [], []
    for c in range(n_chunks):
        if goal_stream is not None:
            state = state.replace(goal=goal_stream[:, c])
        with stage(timer, "track"):
            drone, reached, steps, metrics, metric_pos, trace = tracker(
                state, track_cmds[:, c * chunk:(c + 1) * chunk], pp, mp, sp,
                i0=c * chunk)
        state = state.replace(drone=drone, reached=reached, steps=steps,
                              metrics=metrics, metric_pos=metric_pos)
        traces.append(trace)
        if fusing and c < fuse_frames - 1:
            if batch_fuse:
                fuse_pos.append(drone.pos)
                fuse_quat.append(drone.quat)
                continue
            with stage(timer, "fuse"):
                state = fuse_frame(state, cam)
            if esdf_rate > 1 and (c + 1) % max(fuse_frames // esdf_rate,
                                               1) == 0:
                with stage(timer, "esdf"):
                    state = rebuild_esdf(state)
    if fuse_pos:
        with stage(timer, "fuse_multi"):
            state = fuse_frames_multi(state, cam,
                                      torch.stack(fuse_pos, 1).contiguous(),
                                      torch.stack(fuse_quat, 1).contiguous())
    info = SegmentInfo(planned=do_replan, ok=plan_ok, int_wpts=traj.int_wpts,
                       ts=traj.ts, drone=drone_at_plan, plan_init=plan_init,
                       target=target, iters=traj.iters,
                       trace=torch.cat(traces, 1))
    failed = state.failed | (state.fail_count > mp.local_target_retries) \
        | (state.steps > mp.max_mission_steps)
    return state.replace(failed=failed), info


def _end_missions(state: EnvState, mission_mode: str, draws: Draws,
                  pp: PlannerParams, mp: MissionParams) -> EnvState:
    """The missions that ended this segment (reached or failed), by
    mission_mode (env.py:653-711). A mission is ok when it reached its goal
    with a weighted metric within 10 collision_cost_tol."""
    done = state.reached | state.failed
    if mission_mode == "manual":
        return state.replace(phase=torch.where(
            done, torch.full_like(state.phase, missions.PHASE_DONE),
            state.phase))
    wm = weighted_metric(state)
    mission_ok = state.reached & (wm <= 10.0 * pp.collision_cost_tol)
    if mission_mode == "random":
        counted = advance = done
        new_goal, new_flap = missions.sample_clear_goal(
            draws.goal_u, state.flap, state.scene, mp.goal_clear_dis)
        phase = state.phase
    else:
        # a tour parked at PHASE_DONE reports done every segment: count a
        # completion once; advance while the tour has entries left
        G = state.goal_list.shape[1]
        counted = done & (state.phase != missions.PHASE_DONE)
        have_next = state.goal_idx < G
        advance = counted & have_next
        envs = torch.arange(done.shape[0], device=done.device)
        new_goal = state.goal_list[envs, state.goal_idx.clamp(max=G - 1)
                                   .long()]
        new_flap = state.flap
        phase = torch.where(counted & ~have_next,
                            torch.full_like(state.phase, missions.PHASE_DONE),
                            state.phase)
    keep = ~advance
    zero_i = torch.zeros_like(state.fail_count)
    return state.replace(
        metric_ok_sum=state.metric_ok_sum + torch.where(
            counted & mission_ok, wm, torch.zeros_like(wm)),
        goal=torch.where(advance[:, None], new_goal, state.goal),
        flap=torch.where(advance, new_flap, state.flap),
        goal_idx=state.goal_idx + (advance.to(torch.int32)
                                   if mission_mode == "predefined" else 0),
        reached=state.reached & keep, failed=state.failed & keep,
        near_goal=state.near_goal & keep,
        fail_count=torch.where(advance, zero_i, state.fail_count),
        steps=torch.where(advance, zero_i, state.steps),
        metrics=torch.where(advance[:, None], torch.zeros_like(state.metrics),
                            state.metrics),
        missions_done=state.missions_done + counted.to(torch.int32),
        missions_ok=state.missions_ok + (counted & mission_ok).to(
            torch.int32),
        phase=phase)


def weighted_metric(state: EnvState) -> torch.Tensor:
    """(B,) closed-loop weighted cost of each env's mission so far
    (traj_planner_node.py:333-363; JAX env.py:715)."""
    return state.metrics @ state.metrics.new_tensor(METRIC_WEIGHTS)


def rollout(state: EnvState, num_segments: int, pp: PlannerParams,
            mp: MissionParams, sp: SimParams, cam: CameraParams,
            net=None, fuse_frames: int = 1, planner: str = "neo",
            solver: str = "fused", mission_mode: str = "random",
            replan_mode: str = "periodic") -> EnvState:
    """num_segments replan periods with ``planner`` and ``solver`` and the
    mission and replan modes, each fusing fuse_frames frames on the vision
    path."""
    for _ in range(num_segments):
        state, _ = step_segment(state, pp, mp, sp, cam, net,
                                fuse_frames=fuse_frames, planner=planner,
                                solver=solver, mission_mode=mission_mode,
                                replan_mode=replan_mode)
    return state
