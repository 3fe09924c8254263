"""Analytic depth camera over primitive scenes: kernel B4 and its plain form.

The port of neoplanner_tpu/sense/raycast.py (``ray_dirs_camera`` :27,
``render_depth`` :157, ``render_depth_auto`` :173-182). The camera looks
along body +x in the optical convention and returns z-depth (range times the
ray's body-x component), max_range where nothing is hit in range.
``row_stride`` > 1 keeps every stride-th image row (rows s//2, s//2 + s,
...) at the same vertical field of view: the cheap frames of sensor-rate
fusion, whose consumers reduce each column to one range.

:func:`render_depth_auto` launches ``csrc/raycast.cu`` for CUDA tensors and
runs :func:`render_depth`, the plain version, for CPU tensors. Both take one
pose per env (pos (B, 3)) or F poses per env (pos (B, F, 3)): the sensor-rate
loop renders every mid-segment frame of every env in one launch, each pose
against its own env's primitives.

Replaces: neoplanner_tpu/sense/raycast_pallas.py ``_make_kernel`` (:72) with
``_pack_prims`` (:179) and ``_base_dirs`` (:249). Bound on the H100:
operations — ~30 flops per pixel and primitive against 4 bytes written per
pixel. Design: one thread per pixel, one block per TILE_W x TILE_H tile of
the output images of up to eight poses. A warp per pose first culls its
env's primitives against the cone of the tile's corner rays
(:func:`tile_cull` is that predicate's plain form, for the tests) and
keeps the survivors' pixel-free terms in shared memory; each pixel then
tests only those, with the dense test's arithmetic, so the image is the
same bit for bit.
"""

from __future__ import annotations

import torch

from .config import CameraParams
from . import frames
from .types import SHAPE_CYLINDER, BoxWorld

_INF = 1e9
TILE_W, TILE_H = 8, 32   # a block's tile of output pixels (csrc/raycast.cu)
# the cull's roundoff margin: CULL_REL of the coordinates' scale L, plus
# CULL_TANGENT L^2 / r for a cylinder (csrc/raycast.cu kCullRel, kCullTangent)
CULL_REL, CULL_TANGENT = 1e-4, 1e-5
# B4 keeps up to 32 B of survivors per primitive in a block's shared memory
# (an H100's 232,448 B, less 1 KB for the tile's own offsets)
MAX_PRIMS = (232448 - 1024) // 32


def ray_dirs_camera(cam: CameraParams, row_stride: int = 1,
                    device=None) -> torch.Tensor:
    """(h, W, 3) unit ray directions in the body frame (x fwd, y left, z up),
    h = len(range(row_stride // 2, H, row_stride)) rows at the full FOV."""
    u = torch.arange(cam.width, device=device) + 0.5
    v = torch.arange(row_stride // 2, cam.height, row_stride,
                     device=device) + 0.5
    x_opt = (u[None, :] - cam.width / 2) / cam.fx
    y_opt = (v[:, None] - cam.height / 2) / cam.fy
    ones = torch.ones((v.shape[0], cam.width), device=device)
    d_body = torch.stack([ones, -x_opt * ones, -y_opt * ones], dim=-1)
    return d_body / torch.linalg.vector_norm(d_body, dim=-1, keepdim=True)


def _ray_box(o, d, c, h):
    """Entry distance of rays (B, R, 3) into one box per env (B, 1, 3)."""
    inv = 1.0 / torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
    lo = (c - h - o) * inv
    hi = (c + h - o) * inv
    tmin = torch.minimum(lo, hi).amax(-1)
    tmax = torch.maximum(lo, hi).amin(-1)
    hit = (tmax >= torch.clamp(tmin, min=0.0)) & (tmin > 0)
    return torch.where(hit, tmin, torch.full_like(tmin, _INF))


def _ray_cylinder(o, d, c, h):
    """Entry distance into one capped vertical cylinder per env (radius
    h[..., 0], half height h[..., 2])."""
    ox = o[..., 0] - c[..., 0]
    oy = o[..., 1] - c[..., 1]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    r = h[..., 0]
    a = dx * dx + dy * dy
    b = 2 * (ox * dx + oy * dy)
    cc = ox * ox + oy * oy - r * r
    disc = b * b - 4 * a * cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    a_safe = torch.where(a < 1e-12, torch.full_like(a, 1e-12), a)
    t_side = (-b - sq) / (2 * a_safe)
    z_at = o[..., 2] + t_side * dz
    z_ok = (z_at - c[..., 2]).abs() <= h[..., 2]
    inf = torch.full_like(t_side, _INF)
    t = torch.where((disc > 0) & (t_side > 0) & z_ok, t_side, inf)
    dz_safe = torch.where(dz.abs() < 1e-9, torch.full_like(dz, 1e-9), dz)
    oz = o[..., 2] - c[..., 2]
    for sgn in (-1.0, 1.0):
        tc = (sgn * h[..., 2] - oz) / dz_safe
        xc = ox + tc * dx
        yc = oy + tc * dy
        ok = (tc > 0) & (xc * xc + yc * yc <= r * r)
        t = torch.minimum(t, torch.where(ok, tc, inf))
    return t


def out_rows(cam: CameraParams, row_stride: int) -> int:
    """Rows of a frame rendered at row_stride."""
    return len(range(row_stride // 2, cam.height, row_stride))


def render_depth(world: BoxWorld, pos: torch.Tensor, quat: torch.Tensor,
                 cam: CameraParams, row_stride: int = 1) -> torch.Tensor:
    """Plain form: (B, h, W) z-depth images from cameras at pos (B, 3) with
    body attitudes quat (B, 4), or (B, F, h, W) from pos (B, F, 3), quat
    (B, F, 4), every pose of env b against world b. Primitives are tested
    one at a time against every ray, keeping the running nearest hit."""
    multi = pos.dim() == 3
    if not multi:
        pos, quat = pos[:, None], quat[:, None]
    dirs_body = ray_dirs_camera(cam, row_stride, pos.device)     # (h, W, 3)
    H, W = dirs_body.shape[:2]
    B, F = pos.shape[:2]
    dirs = frames.quat_rotate(quat[:, :, None, :],
                              dirs_body.reshape(1, 1, -1, 3)
                              ).reshape(B, F * H * W, 3)         # (B, R, 3)
    o = pos[:, :, None, :].expand(B, F, H * W, 3).reshape(B, F * H * W, 3)
    t = torch.full(dirs.shape[:2], _INF, device=pos.device)
    for k in range(world.centers.shape[1]):
        c = world.centers[:, k:k + 1]
        h = world.half_sizes[:, k:k + 1]
        t_k = torch.where((world.shape[:, k] == SHAPE_CYLINDER)[:, None],
                          _ray_cylinder(o, dirs, c, h),
                          _ray_box(o, dirs, c, h))
        t_k = torch.where(world.active[:, k][:, None], t_k,
                          torch.full_like(t_k, _INF))
        t = torch.minimum(t, t_k)
    dz = dirs[..., 2]
    down = dz < -1e-6
    t_ground = torch.where(down, -o[..., 2] / torch.where(
        down, dz, torch.full_like(dz, -1.0)), torch.full_like(dz, _INF))
    t = torch.minimum(t, t_ground)
    x_body = frames.quat_rotate(quat, quat.new_tensor([1.0, 0.0, 0.0]))
    x_body = x_body[:, :, None, :].expand(B, F, H * W, 3).reshape(
        B, F * H * W, 3)
    z = t * (dirs * x_body).sum(-1)
    valid = (t < _INF) & (z >= cam.min_range) & (z <= cam.max_range)
    z = torch.where(valid, z, torch.full_like(z, cam.max_range))
    return z.reshape((B, F, H, W) if multi else (B, H, W))


def _tile_offsets(cam: CameraParams, row_stride: int):
    """Optical-frame offsets (x of the first and last column, y of the first
    and last output row) of every tile: four (TY, TX) float32 tensors."""
    rows = out_rows(cam, row_stride)
    c0 = torch.arange(0, cam.width, TILE_W)
    r0 = torch.arange(0, rows, TILE_H)
    c1 = torch.clamp(c0 + TILE_W, max=cam.width) - 1
    r1 = torch.clamp(r0 + TILE_H, max=rows) - 1

    def col_x(c):
        return ((c.float() + 0.5) - cam.width / 2) / cam.fx

    def row_y(r):
        return ((row_stride // 2 + r * row_stride).float() + 0.5
                - cam.height / 2) / cam.fy
    ty, tx = r0.shape[0], c0.shape[0]
    return (col_x(c0).expand(ty, tx), col_x(c1).expand(ty, tx),
            row_y(r0)[:, None].expand(ty, tx),
            row_y(r1)[:, None].expand(ty, tx))


def tile_cull(world: BoxWorld, pos: torch.Tensor, quat: torch.Tensor,
              cam: CameraParams, row_stride: int = 1) -> torch.Tensor:
    """Plain form of B4's per-tile cull: (B, TY, TX, K), or (B, F, TY, TX,
    K) for pos (B, F, 3), True where primitive k of the pose's env is live
    and may be hit by a ray of the TILE_H x TILE_W tile (ty, tx). Every ray
    of a tile is a positive combination of its four corner rays D_i (the
    unnormalised body rays (1, -x, -y) rotated by the pose), so a primitive
    wholly outside one face of their cone, by more than a roundoff margin,
    is hit by none of them. The faces are the corner pairs' cross products,
    each turned toward the other two corners (dropped where those straddle
    it), and the corner rays' sum where every corner lies in front of it.
    A tile whose cone may hold the vertical culls no cylinder (their
    quadratic takes a_safe there). The kernel computes this predicate; only
    the tests call this form."""
    multi = pos.dim() == 3
    if not multi:
        pos, quat = pos[:, None], quat[:, None]
    xa, xb, ya, yb = _tile_offsets(cam, row_stride)             # (TY, TX)
    xs = torch.stack([xa, xb, xb, xa], -1)                       # (TY, TX, 4)
    ys = torch.stack([ya, ya, yb, yb], -1)
    body = torch.stack([torch.ones_like(xs), -xs, -ys], -1).to(pos.device)
    D = frames.quat_rotate(quat[:, :, None, None, None, :],
                           body)                          # (B, F, TY, TX, 4, 3)
    faces = []
    for i in range(4):
        n = torch.linalg.cross(D[..., i, :], D[..., (i + 1) % 4, :], dim=-1)
        s1 = (n * D[..., (i + 2) % 4, :]).sum(-1)
        s2 = (n * D[..., (i + 3) % 4, :]).sum(-1)
        sgn = torch.where((s1 >= 0) & (s2 >= 0), 1.0,
                          torch.where((s1 <= 0) & (s2 <= 0), -1.0, 0.0))
        faces.append(sgn[..., None] * n)
    front = D.sum(-2)
    ok = ((front[..., None, :] * D).sum(-1) >= 0).all(-1)
    faces.append(front * ok[..., None])
    N = torch.stack(faces, -2)                            # (B, F, TY, TX, 5, 3)
    l1 = N.abs().sum(-1)
    up = (N[..., 2] >= -1e-3 * l1).all(-1)
    down = (-N[..., 2] >= -1e-3 * l1).all(-1)
    cyl_ok = ~up & ~down                                    # (B, F, TY, TX)

    c = world.centers.to(pos.dtype)[:, None]                    # (B, 1, K, 3)
    h = world.half_sizes.to(pos.dtype).abs()[:, None]
    is_cyl = (world.shape == SHAPE_CYLINDER)[:, None]            # (B, 1, K)
    rel = c - pos[:, :, None]                                    # (B, F, K, 3)
    L = (rel.abs().sum(-1) + c.abs().sum(-1) + pos.abs().sum(-1)[..., None]
         + h.sum(-1))
    margin = CULL_REL * L + torch.where(is_cyl, CULL_TANGENT * L * L
                                       / h[..., 0], 0.0)
    Nk = N[..., None, :]                               # (B, F, TY, TX, 5, 1, 3)
    hk = h[:, :, None, None, None]                     # (B, 1, 1, 1, 1, K, 3)
    sup = torch.where(
        is_cyl[:, :, None, None, None],
        hk[..., 0] * torch.sqrt(Nk[..., 0] ** 2 + Nk[..., 1] ** 2)
        + Nk[..., 2].abs() * hk[..., 2],
        (Nk.abs() * hk).sum(-1))
    s = (Nk * rel[:, :, None, None, None]).sum(-1) + sup
    outside = (s < -margin[:, :, None, None, None] * l1[..., None]).any(-2)
    can = ~is_cyl[:, :, None, None] | cyl_ok[..., None]
    keep = world.active[:, None, None, None] & ~(outside & can)
    return keep if multi else keep[:, 0]

