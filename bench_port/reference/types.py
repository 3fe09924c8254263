"""State containers: dataclasses of tensors with a leading env axis.

The counterparts of the JAX package's flax pytrees (core/types.py). Where the
JAX code vmaps a single-env function, every field here carries the env axis
(B, ...) explicitly.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import ClassVar, Optional

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
    """Per-env ESDF maps (neoplanner_tpu/core/types.py ``ESDFMap``) in one
    of the reference's two profiles. The full profile (esdf.build with
    lite=False, the gt+grid path) holds the f32 distance field and the f32
    occupancy and gradient planes. The lite profile (lite=True, the depth
    path) holds the field in bf16 and no planes (None): its consumers read
    distances only."""

    esdf: torch.Tensor      # (B, H, W) distance to the nearest occupied cell [m]
    origin: torch.Tensor    # (2,) f32 (x, y) world coordinates of the grid corner [m]
    resolution: float       # m per cell
    occupancy: Optional[torch.Tensor] = None  # (B, H, W) f32 {0, 1}
    grad_x: Optional[torch.Tensor] = None     # (B, H, W) f32 d esdf / dx
    grad_y: Optional[torch.Tensor] = None     # (B, H, W) f32 d esdf / dy
    # the tensor fields without the env axis (parallel/mesh.py replicates
    # them where it shards the others)
    unbatched: ClassVar[tuple] = ("origin",)

    @property
    def lite(self) -> bool:
        return self.grad_x is None

    def index(self, idx) -> "ESDFMap":
        """The maps of the envs ``idx`` (an index tensor over B)."""
        def pick(t):
            return None if t is None else t[idx]
        return ESDFMap(self.esdf[idx], self.origin, self.resolution,
                       pick(self.occupancy), pick(self.grad_x),
                       pick(self.grad_y))
