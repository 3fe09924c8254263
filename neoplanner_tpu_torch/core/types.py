"""State containers: dataclasses of tensors with a leading env axis.

The counterparts of the JAX package's flax pytrees (core/types.py). Where the
JAX code vmaps a single-env function, every field here carries the env axis
(B, ...) explicitly.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

SHAPE_BOX = 0
SHAPE_CYLINDER = 1


class _Replace:
    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


@dataclass
class Trajectory(_Replace):
    """Solved piecewise-quintic trajectories (MINCO representation), (B, ...)."""

    int_wpts: torch.Tensor  # (B, D, M-1) intermediate waypoints
    ts: torch.Tensor        # (B, M) piece durations
    coeffs: torch.Tensor    # (B, 6M, D) stacked quintic coefficients
    costs: torch.Tensor     # (B, 4) unweighted [energy, time, feas, collision]
    ok: torch.Tensor        # (B,) bool: collision cost under tolerance
    iters: torch.Tensor     # (B,) int32 L-BFGS iterations spent


@dataclass
class DroneState(_Replace):
    """Vehicle state (traj_planner_node.py:49-55), (B, ...)."""

    pos: torch.Tensor       # (B, 3) world position
    vel: torch.Tensor       # (B, 3) world velocity
    quat: torch.Tensor      # (B, 4) wxyz attitude, body->world
    yaw: torch.Tensor       # (B,) yaw angle


@dataclass
class BoxWorld(_Replace):
    """Obstacle scenes of axis-aligned boxes and vertical cylinders."""

    centers: torch.Tensor     # (B, K, 3)
    half_sizes: torch.Tensor  # (B, K, 3); for cylinders [..., 0] is the radius
    active: torch.Tensor      # (B, K) bool
    shape: torch.Tensor       # (B, K) int32: SHAPE_BOX or SHAPE_CYLINDER


@dataclass
class ESDFMap(_Replace):
    """The lite ESDF of the vision loop (neoplanner_tpu/core/types.py
    ``ESDFMap`` built with lite=True): a truncated distance field stored in
    bf16, one per env. The occupancy and gradient planes of the full profile
    are not kept: every consumer reads distances only."""

    esdf: torch.Tensor      # (B, H, W) bf16 distance to the nearest occupied cell [m]
    origin: torch.Tensor    # (2,) f32 (x, y) world coordinates of the grid corner [m]
    resolution: float       # m per cell

    def index(self, idx) -> "ESDFMap":
        """The maps of the envs ``idx`` (an index tensor over B)."""
        return ESDFMap(self.esdf[idx], self.origin, self.resolution)
