"""Obstacle scenes to 2-D occupancy grids: the ground-truth map of the
gt+grid path.

The port of neoplanner_tpu/world/voxelize.py (``_cell_centers_2d`` :22,
``_footprint_hit`` :28, ``occupancy_2d`` :42), batched over envs: a cell is
occupied when its centre lies inside the xy footprint of an active
primitive (an axis-aligned box, or a vertical cylinder of radius
half_sizes[..., 0]) whose z-extent meets the occupancy slice
[z_min, z_max]. The same f32 comparisons as the reference, so the grids
agree exactly. Plain PyTorch on every device: no TPU kernel computes it.
"""

from __future__ import annotations

import torch

from neoplanner_tpu_torch.config import MapParams
from neoplanner_tpu_torch.core.types import SHAPE_CYLINDER, BoxWorld

_CHUNK_ELEMS = 1 << 26    # (envs, K, H, W) elements per footprint chunk


def _cell_centers_2d(mp: MapParams, device=None):
    xs = mp.origin_x + (torch.arange(mp.width, dtype=torch.float32,
                                     device=device) + 0.5) * mp.resolution
    ys = mp.origin_y + (torch.arange(mp.height, dtype=torch.float32,
                                     device=device) + 0.5) * mp.resolution
    return xs, ys


def _footprint_hit(world: BoxWorld, xs: torch.Tensor,
                   ys: torch.Tensor) -> torch.Tensor:
    """(B, K, H, W) bool: cell centre inside each primitive's footprint."""
    cx = world.centers[..., 0, None, None]
    cy = world.centers[..., 1, None, None]
    hx = world.half_sizes[..., 0, None, None]
    hy = world.half_sizes[..., 1, None, None]
    dx = xs - cx                                               # (B, K, 1, W)
    dy = ys[:, None] - cy                                      # (B, K, H, 1)
    box_hit = (torch.abs(dx) <= hx) & (torch.abs(dy) <= hy)
    cyl_hit = dx * dx + dy * dy <= hx * hx
    is_cyl = (world.shape == SHAPE_CYLINDER)[..., None, None]
    return torch.where(is_cyl, cyl_hit, box_hit)


def occupancy_2d(world: BoxWorld, mp: MapParams) -> torch.Tensor:
    """(B, H, W) float32 {0, 1} ground-truth occupancy of each env's world
    (the octomap_server projection semantics), computed a chunk of envs at a
    time so that the (envs, K, H, W) footprint test stays near 2^26
    elements."""
    B, K = world.active.shape
    dev = world.centers.device
    xs, ys = _cell_centers_2d(mp, dev)
    z_lo = world.centers[..., 2] - world.half_sizes[..., 2]
    z_hi = world.centers[..., 2] + world.half_sizes[..., 2]
    in_slice = (z_hi > mp.z_min) & (z_lo < mp.z_max) & world.active
    step = max(1, _CHUNK_ELEMS // max(K * mp.height * mp.width, 1))
    out = []
    for b0 in range(0, B, step):
        part = world.replace(**{f: getattr(world, f)[b0:b0 + step] for f in
                                ("centers", "half_sizes", "active", "shape")})
        hit = _footprint_hit(part, xs, ys) & in_slice[b0:b0 + step, :,
                                                      None, None]
        out.append(hit.any(dim=1))
    return torch.cat(out).to(torch.float32)
