"""Obstacle scenes to occupancy grids and voxel volumes, and their exact
signed distance.

The port of neoplanner_tpu/world/voxelize.py (``_cell_centers_2d`` :22,
``_footprint_hit`` :28, ``occupancy_2d`` :42, ``occupancy_3d`` :53,
``fill_unknown_3d`` :66, ``sdf`` :117). A cell is occupied when its centre
lies inside the xy footprint of an active primitive (an axis-aligned box,
or a vertical cylinder of radius half_sizes[..., 0]) whose z-extent meets
the occupancy slice [z_min, z_max] (:func:`occupancy_2d`, the ground-truth
map of the gt+grid path, batched over envs) or, for a voxel, contains the
voxel's centre height (:func:`occupancy_3d`, the .bt/.pcd map's
equivalent). :func:`fill_unknown_3d` is the octomap plugin's unknown-space
pass and :func:`sdf` the analytic signed distance in 3-D. The same f32
comparisons as the reference, so grids and volumes agree exactly. Plain
PyTorch on every device: no TPU kernel computes any of them.
"""

from __future__ import annotations

import torch

from neoplanner_tpu_torch.config import MapParams
from neoplanner_tpu_torch.core.types import SHAPE_CYLINDER, BoxWorld

_CHUNK_ELEMS = 1 << 26    # (envs, K, H, W) elements per footprint chunk
FILL_CHECK_EVERY = 16     # fill_unknown_3d's dilation steps between checks


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


def occupancy_3d(world: BoxWorld, mp: MapParams, z_cells: int,
                 z_origin: float = 0.0) -> torch.Tensor:
    """(..., Z, H, W) float32 {0, 1} voxel volume of worlds whose fields
    are (..., K, 3) and (..., K) (one world, or a leading env axis): a
    voxel is occupied when its centre lies inside an active primitive, the
    .bt/.pcd ground-truth map's equivalent. Voxel z centres are z_origin +
    (k + 0.5) * resolution. The volume is the OR over primitives of an
    outer product of each primitive's z test (K, Z) and footprint test
    (K, H, W): a 0/1 matrix product whose integer counts are exact in f32,
    taken a chunk of primitives at a time so that the footprint test stays
    near 2^26 elements."""
    dev = world.centers.device
    xs, ys = _cell_centers_2d(mp, dev)
    zs = z_origin + (torch.arange(z_cells, dtype=torch.float32, device=dev)
                     + 0.5) * mp.resolution
    in_z = (torch.abs(zs - world.centers[..., 2:3])
            <= world.half_sizes[..., 2:3]) & world.active[..., None]
    K = world.active.shape[-1]
    lead = world.active.shape[:-1]
    cells = mp.height * mp.width
    counts = torch.zeros(lead + (z_cells, cells), device=dev)
    step = max(1, _CHUNK_ELEMS // max(cells * max(lead.numel(), 1), 1))
    for k0 in range(0, K, step):
        part = world.replace(**{f: getattr(world, f)[..., k0:k0 + step, :]
                                for f in ("centers", "half_sizes")},
                             **{f: getattr(world, f)[..., k0:k0 + step]
                                for f in ("active", "shape")})
        fp = _footprint_hit(part, xs, ys).flatten(-2).to(torch.float32)
        counts += in_z[..., k0:k0 + step, :].transpose(-1, -2).to(
            torch.float32) @ fp
    return (counts > 0.5).to(torch.float32).reshape(
        lead + (z_cells, mp.height, mp.width))


def _dilate(free: torch.Tensor, passable: torch.Tensor) -> torch.Tensor:
    """One 6-neighbour dilation of free over the last three axes, kept to
    passable voxels."""
    grown = free.clone()
    for d in (-3, -2, -1):
        n = free.shape[d]
        grown.narrow(d, 1, n - 1).logical_or_(free.narrow(d, 0, n - 1))
        grown.narrow(d, 0, n - 1).logical_or_(free.narrow(d, 1, n - 1))
    return grown.logical_and_(passable)


def flood_free(occ: torch.Tensor, seeds: tuple = None):
    """The free space of :func:`fill_unknown_3d` and the dilation steps it
    took: (free (..., Z, H, W) bool, steps). The fixed point is checked
    every FILL_CHECK_EVERY steps (one host sync each); steps past it change
    nothing, so the result does not depend on that interval."""
    occ_b = occ > 0.5
    Z, H, W = occ_b.shape[-3:]
    if seeds is None:
        seeds = ((Z - 1, H // 2, W // 2), (0, H // 2, W // 2))
    free = torch.zeros_like(occ_b)
    for z, r, c in seeds:
        free[..., z, r, c] = True
    passable = ~occ_b
    free &= passable
    steps = 0
    while True:
        before = free
        for _ in range(FILL_CHECK_EVERY):
            free = _dilate(free, passable)
        steps += FILL_CHECK_EVERY
        if torch.equal(before, free):
            return free, steps


def fill_unknown_3d(occ: torch.Tensor, seeds: tuple = None) -> torch.Tensor:
    """The reference octomap's unknown-space semantics for (..., Z, H, W)
    volumes (plugin_build_octomap.cpp:317-357): flood-fill free space
    6-connected from the seed voxels (z, row, col), by default the
    bounding box's centre column at the top and the bottom z layer, then
    mark every voxel the fill never reached as occupied. float32 {0, 1}.

    The analytic rasterizer (occupancy_3d) is exact for primitive scenes,
    so this changes the volume only where the scene encloses a cavity: the
    reference marks those occupied, and so does this pass. The JAX package
    runs the dilation to its fixed point in a lax.while_loop; here
    :func:`flood_free` checks for the fixed point every
    FILL_CHECK_EVERY steps, with the same result bit for bit."""
    free, _ = flood_free(occ, seeds)
    return ((occ > 0.5) | ~free).to(torch.float32)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1))


def sdf(world: BoxWorld, points: torch.Tensor) -> torch.Tensor:
    """Exact signed distance from points to the union of a world's
    primitives, negative inside: one world (fields (K, ...)) and points
    (..., 3) give (...); worlds with an env axis ((B, K, ...)) and points
    (B, ..., 3) give (B, ...), each env against its own world. Boxes are
    axis-aligned, cylinders vertical and capped (radius half_sizes[..., 0]);
    an inactive primitive is at +inf."""
    if world.centers.dim() == 2:
        one = world.replace(**{f: getattr(world, f)[None] for f in
                               ("centers", "half_sizes", "active", "shape")})
        return sdf(one, points[None])[0]
    B = points.shape[0]
    mid = points.shape[1:-1]
    p = points.reshape(B, -1, 1, 3)                             # (B, P, 1, 3)
    c = world.centers[:, None]                                  # (B, 1, K, 3)
    h = world.half_sizes[:, None]
    q = torch.abs(p - c) - h
    d_box = _norm(torch.clamp(q, min=0.0)) + torch.clamp(
        q.amax(-1), max=0.0)
    d_xy = _norm(p[..., :2] - c[..., :2]) - h[..., 0]
    d_z = torch.abs(p[..., 2] - c[..., 2]) - h[..., 2]
    w = torch.stack([d_xy, d_z], -1)
    d_cyl = _norm(torch.clamp(w, min=0.0)) + torch.clamp(w.amax(-1), max=0.0)
    d = torch.where((world.shape == SHAPE_CYLINDER)[:, None], d_cyl, d_box)
    d = torch.where(world.active[:, None], d, torch.full_like(d, torch.inf))
    return d.amin(-1).reshape((B,) + mid)
