"""Static configuration of the PyTorch port: frozen dataclasses of Python
scalars whose defaults are the deployed planner_config.yaml values.

A copy of ``neoplanner_tpu/config.py`` with its YAML loader (``load_yaml``
:275): the port imports nothing of the JAX package. Keep the two in step; the parity tests
construct both from the same field values.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class PlannerParams:
    """Trajectory-optimizer envelope.

    Defaults mirror the reference's src/planner/launch/config/planner_config.yaml:1-24
    and the L-BFGS budget at expert_planner.py:213-225.
    """

    # dynamics / feasibility
    v_max: float = 1.0            # [m/s] velocity bound (soft, cubic-penalty)
    t_min: float = 0.5            # [s] minimum duration of each polynomial piece
    t_max: float = 5.0            # [s] maximum duration of each polynomial piece
    safe_dis: float = 0.7         # [m] soft clearance to obstacles

    # cost weights: [energy, time, feasibility(vel), collision]
    w_energy: float = 1.0
    w_time: float = 1.0
    w_feas: float = 1.0
    w_collision: float = 10000.0

    # discretization of the sampled costs
    delta_t: float = 0.1          # [s] sampling interval of the penalty integrals

    # trajectory parameterization: M pieces of quintics (min-jerk, s=3), D spatial dims
    s: int = 3
    num_pieces: int = 3           # M (init_wpts_num=2 intermediate waypoints => M=3)
    dims: int = 2                 # D: planning is 2-D; z is held at des_pos_z

    # initialization
    init_t: float = 2.5           # [s] initial piece duration (first/last scaled 1.5x)
    batch_num: int = 3            # multi-start candidates (straight + 2 lateral offsets)
    lateral_move_dis: float = 0.6 # [m] lateral offset of multi-start seeds
    retry_num: int = 5            # noisy re-seeds after multi-start failure
    retry_noise_std: float = 0.5  # [m] N(0, 0.5) waypoint noise of the retries
    # extra wide lateral seeds (× lateral_move_dis), beyond the reference's ±1 —
    # parallel lanes are nearly free on TPU and escape the ESDF plateau behind
    # obstacles wider than ~1.2 m, where the reference's ladder stalls
    extra_lateral_scales: Tuple[float, ...] = (2.5, -2.5, 5.0, -5.0)

    # acceptance / optimizer budget
    collision_cost_tol: float = 5.0
    opt_tol: float = 1e-2         # relative-improvement stopping tolerance
    max_iters: int = 256          # L-BFGS iteration cap (static; reference uses 15000
                                  # but converges in far fewer — see tests)
    history: int = 10             # L-BFGS memory (maxcor)
    max_ls: int = 8               # parallel line-search candidates (halving from
                                  # the unit step; the reference's sequential
                                  # maxls=20 is an upper bound it rarely reaches)
    # line-search candidate axis: 'wide' = one widened vmap evaluation (cuts
    # the per-iteration sequential depth from max_ls+1 to 2 cost evals; costs
    # max_ls x the eval temporary), 'map' = sequential lax.map (memory-light,
    # for per-env-grid closures at large batch), 'auto' = wide on the analytic
    # scene backend, map on grids
    ls_mode: str = "auto"

    # cost sampling mode: 'absolute' reproduces the reference discretization
    # (samples at t=j*delta_t, j < floor(T/delta_t)); 'relative' samples at
    # t = T*j/(K-1), which is smooth in T and is the optimization default.
    sampling: str = "relative"
    samples_per_piece: int = 32   # K for 'relative' mode

    # ESDF interpolation: 'nearest' matches the reference (esdf.py:53-82),
    # 'bilinear' is the smooth default.
    esdf_interp: str = "bilinear"

    # side length (cells) of the ESDF crop the fused grid-objective kernels
    # keep in VMEM (plan/costs_pallas_grid.py): at 0.1 m/cell the default is
    # a 9.6 m window — the local target is at most ~5.1 m from the plan
    # start, so every multi-start candidate stays inside
    kernel_window_cells: int = 96

    @property
    def num_wpts(self) -> int:
        return self.num_pieces - 1

    @property
    def num_vars(self) -> int:
        """Flattened decision vector length: D*(M-1) waypoints + M durations."""
        return self.dims * self.num_wpts + self.num_pieces

    @property
    def max_abs_samples(self) -> int:
        """Static per-piece sample cap of the 'absolute' discretization."""
        return int(math.ceil(self.t_max / self.delta_t))


@dataclass(frozen=True)
class MissionParams:
    """Receding-horizon mission envelope (planner_config.yaml:15-24,
    traj_planner_node.py:75-95, manager_config values)."""

    planning_time_ahead: float = 1.0   # [s] replan from the setpoint 1 s in the future
    des_pos_z: float = 2.0             # [m] fixed flight altitude
    longitu_step_dis: float = 5.0      # [m] local-target stride toward the goal
    lateral_step_length: float = 1.0   # [m] local-target lateral escape stride
    target_reach_threshold: float = 0.2
    cmd_hz: int = 60                   # setpoint streaming rate
    replan_period: float = 1.0         # [s]
    max_target_find_time: float = 45.0 # [s] mission cap (demo_auto_stop.sh:21)
    hover_height: float = 2.0
    local_target_retries: int = 10     # randomized local-target retry ladder
    move_vel_frac: float = 0.8         # local-target speed = 0.8 * v_max
    # random-mission goal vetting: > 0 nudges sampled goals to the nearest
    # spot with at least this ground-truth clearance (the benchmark-harness
    # protocol; examples/multi_run.py does the same for its fixed goal).
    # 0 = the reference's raw sampler (manager_node.py:179-193), which drops
    # ~24% of far-leg goals within safe_dis of an obstacle
    goal_clear_dis: float = 0.0

    @property
    def steps_per_replan(self) -> int:
        return int(round(self.replan_period * self.cmd_hz))

    @property
    def max_mission_steps(self) -> int:
        return int(round(self.max_target_find_time * self.cmd_hz))


@dataclass(frozen=True)
class SimParams:
    """Quadrotor simulator envelope (replaces PX4 SITL + Gazebo physics)."""

    dt: float = 1.0 / 60.0        # [s] physics step = command period
    mass: float = 1.5             # [kg] iris-class quad
    g: float = 9.81
    a_max: float = 8.0            # [m/s^2] acceleration authority
    # cascaded tracking gains (position -> velocity -> acceleration)
    kp_pos: float = 2.4
    kp_vel: float = 3.6
    yaw_rate_max: float = 2.0     # [rad/s]
    drag: float = 0.05            # linear drag coefficient


@dataclass(frozen=True)
class CameraParams:
    """Depth camera intrinsics (the reference uses a 640x480 Gazebo depth cam with
    ~6 m max range: nn_planner.py:14-17, map_server_onboard.launch:20-22)."""

    width: int = 160
    height: int = 120
    hfov: float = 1.5009831       # [rad] ~86 deg, Gazebo default depth cam
    max_range: float = 6.0        # [m]
    min_range: float = 0.05       # [m]

    @property
    def fx(self) -> float:
        return (self.width / 2.0) / math.tan(self.hfov / 2.0)

    @property
    def fy(self) -> float:
        return self.fx


@dataclass(frozen=True)
class MapParams:
    """Occupancy/ESDF grid envelope (map_server_onboard.launch:17-32)."""

    resolution: float = 0.1       # [m/cell]
    width: int = 448              # cells along x (44.8 m arena, covers x in [-8, 36.8))
    height: int = 256             # cells along y (25.6 m, y in [-12.8, 12.8))
    origin_x: float = -8.0        # [m] world coordinate of cell (0, 0)
    origin_y: float = -12.8
    z_min: float = 1.8            # occupancy slice bounds
    z_max: float = 10.0
    # log-odds parameters (octomap defaults; plugin_build_octomap.cpp:271-275)
    prob_hit: float = 0.7
    prob_miss: float = 0.4
    clamp_min: float = 0.12
    clamp_max: float = 0.97
    occ_threshold: float = 0.5
    # ESDF truncation radius [m] for online (per-frame) rebuilds: 0 = exact
    # transform (reference parity); > 0 clamps distances beyond it, which every
    # loop consumer tolerates (all compare against safe_dis <= 0.7) and cuts
    # the rebuild's min-plus pass by ~H/(2*radius/resolution)
    edt_truncation: float = 0.0
    # depth-fusion backend: '2d_dense' = scatter-free polar window update as
    # a Pallas kernel (mapping/occupancy_pallas.py, the TPU fast path);
    # '2d' = per-column polar scatter fusion; '3d' = strided per-sample ray
    # carving (shaped like octomap's per-ray insertion)
    fusion: str = "2d"
    # vertical row stride for fusion-frame rendering (same FOV, every
    # stride-th row): the 2-D fusion reduces each column to one range, so a
    # coarse vertical sampling is enough — at 4 it cuts the dominant
    # vision-loop render cost ~4x. 1 = full resolution (reference cadence);
    # NN/planner frames always render full-res.
    fusion_row_stride: int = 1


@dataclass(frozen=True)
class WorldParams:
    """Procedural box-world envelope
    (the reference's src/simulator/scripts/generator_config.yaml:1-16)."""

    max_boxes: int = 24           # static capacity of the box array (>= num_boxes)
    num_boxes: int = 15
    pose_x_min: float = 3.0
    pose_x_max: float = 27.0
    pose_y_min: float = -5.0
    pose_y_max: float = 5.0
    size_x_min: float = 0.5
    size_x_max: float = 1.5
    size_y_min: float = 0.5
    size_y_max: float = 1.5
    size_z_min: float = 3.0
    size_z_max: float = 6.0
    x_clearance: float = 1.8
    y_clearance: float = 1.8
    rejection_rounds: int = 12    # vectorized rejection-sampling sweeps


@dataclass(frozen=True)
class NetParams:
    """PlannerNet architecture constants (nn_trainer.py:19-32, 109-155)."""

    img_width: int = 640
    img_height: int = 480
    motion_input_size: int = 24
    output_size: int = 9          # 2 body-frame 3-D waypoints + 3 piece durations
    img_feature_size: int = 24
    motion_feature_size: int = 24
    backbone: str = "resnet18"    # 'resnet18' (parity) or 'smallconv' (fast sim)
    fusion_arch: str = "mlp"      # 'mlp' (nn_trainer.py) or 'conv1d'
                                  # (nn_trainer_conv.py:123-145)


def replace(cfg, **kwargs):
    """Functional update of any frozen config dataclass."""
    return dataclasses.replace(cfg, **kwargs)

