"""2-D log-odds occupancy from depth frames: the grid, the per-column polar
reduction of a frame, the scatter fusions and the binarization.

The port of neoplanner_tpu/mapping/occupancy.py (``logodds_init`` :31,
``_l`` :35, ``_cell_idx`` :39, ``insert_depth`` :46, ``polar_columns``
:87, ``insert_depth_2d`` :145, ``to_occupancy`` :198), batched over envs.
Log-odds parameters are octomap's defaults (hit 0.7, miss 0.4, clamp
[0.12, 0.97]). The '2d' (:func:`insert_depth_2d`) and '3d'
(:func:`insert_depth`) fusions are scatter-adds in both forms, on every
device: no TPU kernel computes them. The adds to one cell are summed in
another order than the reference's sequential scatter (the CPU sums
duplicate indices first, the GPU adds atomically in any order), so the
grids agree to f32 roundoff. The dense fusion (kernels B8 v1, v2, v3) is in
mapping/fusion.py.
"""

from __future__ import annotations

import math

import torch

from .config import CameraParams, MapParams
from . import frames
from . import raycast

BIG = 1e9


def logodds_init(mp: MapParams, batch: int, device=None) -> torch.Tensor:
    """(B, H, W) unknown grid (log-odds 0)."""
    return torch.zeros((batch, mp.height, mp.width), device=device)


def _l(p: float) -> float:
    return math.log(p / (1.0 - p))


def _cell_idx(x: torch.Tensor, y: torch.Tensor, mp: MapParams):
    """World (x, y) -> (row, col) int64 cell indices and the in-map mask."""
    col = torch.floor((x - mp.origin_x) / mp.resolution).long()
    row = torch.floor((y - mp.origin_y) / mp.resolution).long()
    inb = (row >= 0) & (row < mp.height) & (col >= 0) & (col < mp.width)
    return row, col, inb


def _scatter_add(grid: torch.Tensor, row, col, w) -> torch.Tensor:
    """grid (B, H, W) with w (B, ...) added at the clipped cells (row, col)
    (B, ...) of each env (the reference's ``.at[...].add``)."""
    B, H, W = grid.shape
    envs = torch.arange(B, device=grid.device).reshape(
        (B,) + (1,) * (row.dim() - 1)).expand_as(row)
    return grid.index_put((envs, row.clamp(0, H - 1), col.clamp(0, W - 1)),
                          w.to(grid.dtype), accumulate=True)


def polar_columns(depth: torch.Tensor, pos: torch.Tensor, quat: torch.Tensor,
                  cam: CameraParams, mp: MapParams, row_stride: int = 1):
    """Collapse depth frames (B, h, w) to the projected plane, per image
    column: (r_hit (B, w), r_carve (B, w), u_dir (B, w, 2)). row_stride is
    the stride the frames were rendered at (raycast.ray_dirs_camera); the
    column reductions run over those rows.

    r_hit is the nearest in-slice hit range, r_carve how far the column's
    rays traverse the z-slice [z_min, z_max] before the nearest obstacle,
    u_dir the column's horizontal world direction (mid-row azimuth). Only the
    world z component of each ray is formed (dz = R(q)[2, :] . d_body, the
    dz-only form): the rays are unit, so the horizontal magnitude is
    sqrt(1 - dz^2)."""
    dirs_body = raycast.ray_dirs_camera(cam, row_stride,
                                        depth.device)      # (h, w, 3)
    zrow = frames.quat_rotate_inv(
        quat, quat.new_tensor([0.0, 0.0, 1.0]))                  # (B, 3)
    t_end = depth / torch.clamp(dirs_body[..., 0], min=1e-6)
    dz = (dirs_body[None, ..., 0] * zrow[:, None, None, 0]
          + dirs_body[None, ..., 1] * zrow[:, None, None, 1]
          + dirs_body[None, ..., 2] * zrow[:, None, None, 2])   # (B, h, w)
    hnorm = torch.sqrt(torch.clamp(1.0 - dz * dz, min=0.0))

    # slab-clip each ray against the occupancy slice
    dz_safe = torch.where(dz.abs() < 1e-6, torch.full_like(dz, 1e-6), dz)
    pz = pos[:, 2, None, None]
    tz1 = (mp.z_min - pz) / dz_safe
    tz2 = (mp.z_max - pz) / dz_safe
    t_lo = torch.minimum(tz1, tz2)
    t_hi = torch.maximum(tz1, tz2)
    level = dz.abs() < 1e-6
    inside = (pz >= mp.z_min) & (pz <= mp.z_max)
    t_hi = torch.where(level, torch.where(inside, BIG, -1.0), t_hi)
    t_lo = torch.where(level, torch.zeros_like(t_lo), t_lo)
    can_carve = t_lo <= 1e-3      # rays entering the slice right away

    hit = depth < cam.max_range - 1e-4
    end_z = pz + t_end * dz
    end_in_slice = (end_z >= mp.z_min) & (end_z <= mp.z_max)

    r_end = t_end * hnorm
    r_hit_px = torch.where(hit & end_in_slice, r_end, BIG)
    r_hit_col = r_hit_px.amin(1)                                  # (B, w)
    r_free_px = torch.where(can_carve, torch.minimum(t_end, t_hi) * hnorm,
                            torch.zeros_like(t_end))
    r_carve_col = torch.minimum(r_free_px.amax(1), r_hit_col)

    mid_body = dirs_body[dirs_body.shape[0] // 2]                 # (w, 3)
    mid = frames.quat_rotate(quat[:, None, :], mid_body)[..., :2]
    u_dir = mid / torch.clamp(torch.linalg.vector_norm(mid, dim=-1,
                                                       keepdim=True),
                              min=1e-9)
    return r_hit_col, r_carve_col, u_dir


def occ_threshold(mp: MapParams) -> float:
    """The binarization threshold of to_occupancy (:198): a cell is occupied
    where its log-odds exceed it; unknown (0) is free. As the f32 value the
    ESDF rebuild compares against."""
    return float(torch.tensor(_l(mp.occ_threshold) + 1e-6,
                              dtype=torch.float32))


def insert_depth_2d(logodds: torch.Tensor, depth: torch.Tensor,
                    pos: torch.Tensor, quat: torch.Tensor, cam: CameraParams,
                    mp: MapParams, carve_samples: int = 48,
                    row_stride: int = 1) -> torch.Tensor:
    """The '2d' fusion: one polar ray per image column of frames (B, h, w)
    rendered at row_stride. carve_samples samples up to one cell short of
    each column's carve range add l_miss to their cells, then each column's
    nearest in-slice hit adds l_hit to its cell, then one clip."""
    r_hit, r_carve, u_dir = polar_columns(depth, pos, quat, cam, mp,
                                          row_stride)            # (B, w)
    fr = (torch.arange(carve_samples, dtype=torch.float32,
                       device=depth.device) + 0.5) / carve_samples
    r_s = fr[None, :, None] * torch.clamp(r_carve - mp.resolution,
                                          min=0.0)[:, None, :]   # (B, S, w)
    cx = pos[:, 0, None, None] + r_s * u_dir[:, None, :, 0]
    cy = pos[:, 1, None, None] + r_s * u_dir[:, None, :, 1]
    row, col, inb = _cell_idx(cx, cy, mp)
    logodds = _scatter_add(logodds, row, col, (inb & (r_s > 0)).to(
        logodds.dtype) * _l(mp.prob_miss))
    hx = pos[:, 0:1] + r_hit * u_dir[..., 0]
    hy = pos[:, 1:2] + r_hit * u_dir[..., 1]
    hrow, hcol, hinb = _cell_idx(hx, hy, mp)
    logodds = _scatter_add(logodds, hrow, hcol, (hinb & (r_hit < BIG)).to(
        logodds.dtype) * _l(mp.prob_hit))
    return torch.clamp(logodds, _l(mp.clamp_min), _l(mp.clamp_max))


def to_occupancy(logodds: torch.Tensor, mp: MapParams) -> torch.Tensor:
    """Binarized occupancy (B, H, W) float32 {0, 1} of log-odds grids:
    occupied above the threshold, unknown (0) free (:198)."""
    return (logodds > occ_threshold(mp)).to(torch.float32)
