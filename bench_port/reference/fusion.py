"""Dense polar depth fusion: one frame per env on a window (kernel B8 v1)
or on the whole grid (kernel B8 v2), and F frames per env in one pass
(kernel B8 v3), each with its plain version.

:func:`insert_depth_2d_dense` is the port of
neoplanner_tpu/mapping/occupancy_pallas.py ``insert_depth_2d_dense`` (:478)
with ``_fuse_flat`` (:608) and ``_scatter_hits`` (:494). Each frame
collapses to a per-column carve table (occupancy.polar_columns); every grid
cell then tests itself against the table (r_cell < r_carve(u) - res:
+ l_miss, then clip), and each column's nearest in-slice hit adds l_hit to
the cell that holds it, then the grid is clipped again. On maps with
W % 128 == 0 and H % 8 == 0 the reference's v2 branch (:611-652) covers the
whole grid: ``csrc/fusion.cu`` for CUDA tensors, :func:`_fuse_plain` for CPU
tensors. On other maps its v1 branch (:653-676) updates a (ch, cw) window
around each camera (:func:`window_fits` says when that window covers the
sensor's reach; otherwise the call raises, as the reference's does):
``csrc/fusion_window.cu`` in place on a copy of the grid for CUDA tensors,
:func:`_fuse_window_plain` for CPU tensors. v1 takes the cells' positions
from the window's origin and rounds the column index half to even, so it
is not v2 restricted to a window; its hits are added wherever they fall,
inside the window or not.

:func:`insert_depth_2d_dense_multi` is the port of
``insert_depth_2d_dense_multi`` (:512, ``_fuse_flat_multi`` :532): the
sensor-rate loop's F mid-segment frames, applied in order with ONE clip per
frame over carve and hits together, cell = clip((cell + carve_f) + k_f *
l_hit) with k_f the number of frame f's columns whose hit falls in the
cell. That is not F chained v2 updates (v2 clips after the carve and again
after the hits), so neither the kernel nor :func:`_fuse_multi_plain` is a
loop over v2. For CUDA tensors it runs in ``csrc/fusion_multi.cu``. Like
the reference's, it takes v2-eligible maps only.

Replaces: occupancy_pallas.py ``_make_kernel`` (:51) via ``_fuse_call``
(:121), ``_make_kernel_v2`` (:176) via ``_fuse_call_v2`` (:263), and
``_make_kernel_v3`` (:299) via ``_fuse_call_v3`` (:419). Bound on the H100:
device memory (the grid, or v1's windows, read and written once per call,
~25 flops per cell and frame). Design: one template for all three,
``csrc/fusion_tile.cuh``, a block per env and eight TILE_H x TILE_W tiles
of cells (v1: all of the env's window, up to WINDOW_MAX x WINDOW_MAX
cells), each held in registers across the frames, carving only the
WARP_H x WARP_W strips that a frame's camera reaches (:func:`tile_reach`
is that test's plain form; on v1's window, :func:`window_reach`) and
adding the tile's hits in the same pass; one launch each. Limits: F frames
and an image width w whose staging fits a block's shared memory
(:func:`tile_smem_bytes`; F <= 68 at w = 160; v1
:func:`window_smem_bytes`, w <= 28,523), any H and W, v1's windows at most
WINDOW_MAX cells a side.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .config import CameraParams, MapParams
from . import frames
from . import occupancy

TILE_W, TILE_H = 32, 32    # B8 v2/v3's tile of cells (csrc/fusion_tile.cuh)
WARP_W, WARP_H = 16, 8     # a warp's strip of it, the reach test's unit
REACH_REL = 1e-4           # the reach test's margin (kReachRel there)
_FRAME_WORDS = 7           # a frame's record in shared memory (kFrameWords)
_TILES_PER_BLOCK = 8       # a block's tiles (kTilesPerBlock)
_SMEM_MAX = 232448         # a block's shared memory on the H100, 227 KB
WINDOW_MAX = 128           # B8 v1's window side in cells (kWindowMax)
_WINDOW_TILES = (WINDOW_MAX // TILE_H) * (WINDOW_MAX // TILE_W)


def _v2_map(mp: MapParams) -> bool:
    """The whole-grid kernels (v2, v3) take maps with W % 128 == 0 and
    H % 8 == 0."""
    return mp.width % 128 == 0 and mp.height % 8 == 0


def _reach_cells(cam: CameraParams, mp: MapParams) -> int:
    """Worst-case horizontal reach of a pixel's projected update in cells
    (occupancy_pallas.py :150): a corner ray at z-depth max_range travels
    max_range * sqrt(1 + tan^2(beta_max)) horizontally."""
    tanb = (cam.width / 2.0) / cam.fx
    r = cam.max_range * math.sqrt(1.0 + tanb * tanb)
    return int(math.ceil(r / mp.resolution + 0.5))


def _window_cells(cam: CameraParams, mp: MapParams):
    """v1's window (ch, cw) around the camera, capped at 128 cells per axis
    (occupancy_pallas.py :455)."""
    c = 2 * _reach_cells(cam, mp) + 2
    return min(c, mp.height, 128), min(c, mp.width, 128)


def window_fits(cam: CameraParams, mp: MapParams) -> bool:
    """Whether the dense fusion covers the sensor's whole reach
    (occupancy_pallas.py :464): always on a v2 map; on another map when
    v1's 128-cell window holds the reach or the whole map."""
    if _v2_map(mp):
        return True
    c = 2 * _reach_cells(cam, mp) + 2
    return c <= 128 or (mp.height <= 128 and mp.width <= 128)


def tile_reach(tabs: torch.Tensor, sc: torch.Tensor, cam: CameraParams,
               mp: MapParams, tile=(TILE_H, TILE_W)) -> torch.Tensor:
    """The reach test of B8 v2/v3 in its plain form: (B, [F,] TY, TX), True
    where frame (tabs (B, [F,] w), sc (B, [F,] 8), as :func:`_inputs` and
    :func:`_multi_inputs` give them) may carve a cell of tile (ty, tx) of
    the (H, W) grid, in tiles of tile = (rows, columns) cells (the kernel
    tests strips of (WARP_H, WARP_W)). By csrc/fusion_tile.cuh's rule a
    frame cannot where T = max(table) - res is not positive, the tile's
    cell centres all lie farther than T from the camera, its four corners
    all lie behind it, or all four lie outside one of the two half-planes
    that bound the image columns; each with a margin of REACH_REL of the
    coordinates' scale. The kernel computes this test itself; only the
    tests and chip_smoke.py call this form."""
    th, tw = tile
    dev, f32 = tabs.device, torch.float32

    def c(v):
        return torch.tensor(v, dtype=f32, device=dev)
    fx, res, half_w = (c(v) for v in _params(cam, mp)[:3])
    rel, one, eps6 = c(REACH_REL), c(1.0), c(1e-6)
    r_lo = torch.arange(0, mp.height, th, device=dev)
    r_hi = torch.clamp(r_lo + th, max=mp.height) - 1
    c_lo = torch.arange(0, mp.width, tw, device=dev)
    c_hi = torch.clamp(c_lo + tw, max=mp.width) - 1
    s = sc[..., None, None, :]
    x0, y0, cx, cy, cp, sp = (s[..., i] for i in range(6))     # (..., 1, 1)
    mx = torch.where(torch.isnan(tabs), -math.inf, tabs).amax(-1)
    t_max = (mx - res)[..., None, None]
    xa, xb = x0 + c_lo.to(f32) * res, x0 + c_hi.to(f32) * res   # (..., 1, TX)
    ya = (y0 + r_lo.to(f32)[:, None] * res)                     # (..., TY, 1)
    yb = (y0 + r_hi.to(f32)[:, None] * res)
    L = (((one + x0.abs()) + (y0.abs() + cx.abs()))
         + (cy.abs() + (c_hi[None, :] + r_hi[:, None]).to(f32) * res.abs()))
    m = rel * L
    zero = torch.zeros((), dtype=f32, device=dev)
    ddx = torch.maximum(torch.maximum(torch.minimum(xa, xb) - cx,
                                      cx - torch.maximum(xa, xb)), zero)
    ddy = torch.maximum(torch.maximum(torch.minimum(ya, yb) - cy,
                                      cy - torch.maximum(ya, yb)), zero)
    r_far = (t_max + m) + rel * t_max
    far = (ddx * ddx + ddy * ddy) > r_far * r_far
    mc = m * (cp.abs() + sp.abs())
    A = half_w + 0.5
    Bq = (c(float(cam.width)) - 0.5) - half_w
    mA, mB = mc * (fx.abs() + A.abs()), mc * (fx.abs() + Bq.abs())
    behind = left = right = True
    for i in range(4):
        dx = (xb if i & 1 else xa) - cx
        dy = (yb if i & 2 else ya) - cy
        dcx = cp * dx + sp * dy
        fy = fx * ((-sp) * dx + cp * dy)
        behind = behind & (dcx <= eps6 - mc)
        left = left & ((fy - A * dcx) > mA)
        right = right & ((fy + Bq * dcx) < -mB)
    return ~(~(t_max > 0.0) | far | behind | left | right)


def window_reach(tabs: torch.Tensor, sc: torch.Tensor, cam: CameraParams,
                 mp: MapParams, tile=(TILE_H, TILE_W)) -> torch.Tensor:
    """B8 v1's reach test in its plain form: :func:`tile_reach` on the
    (ch, cw) window's own tiles, (B, TY, TX), for sc (B, 8) as
    :func:`_window_inputs` gives it (the window's cell (0, 0) at sc[:, 0:2]).
    The kernel tests strips of (WARP_H, WARP_W) of each window."""
    ch, cw = _window_cells(cam, mp)
    return tile_reach(tabs, sc, cam, dataclasses.replace(mp, height=ch,
                                                         width=cw), tile)


def _frame_inputs(depth, pos, quat, cam: CameraParams, mp: MapParams,
                  row_stride: int):
    """Per frame (N frames, each with its own pose): carve table (N, w),
    kernel scalars sc (N, 8) and the cell index row * W + col of each
    column's hit in its env's grid (N, w) int64 (-1: no hit or out of
    map)."""
    r_hit, r_carve, u_dir = occupancy.polar_columns(depth, pos, quat, cam, mp,
                                                    row_stride)
    fwd = frames.quat_rotate(quat, quat.new_tensor([1.0, 0.0, 0.0]))
    psi = torch.atan2(fwd[:, 1], fwd[:, 0])
    zeros = torch.zeros_like(psi)
    sc = torch.stack([torch.full_like(psi, mp.origin_x + 0.5 * mp.resolution),
                      torch.full_like(psi, mp.origin_y + 0.5 * mp.resolution),
                      pos[:, 0], pos[:, 1], torch.cos(psi), torch.sin(psi),
                      zeros, zeros], dim=1)
    hx = pos[:, 0:1] + r_hit * u_dir[..., 0]
    hy = pos[:, 1:2] + r_hit * u_dir[..., 1]
    hrow, hcol, hinb = occupancy._cell_idx(hx, hy, mp)
    cell = hrow * mp.width + hcol
    cell = torch.where(hinb & (r_hit < occupancy.BIG), cell,
                       torch.full_like(cell, -1))
    return r_carve, sc, cell


def _inputs(depth, pos, quat, cam: CameraParams, mp: MapParams,
            row_stride: int = 1):
    """B8 v2's inputs for one frame per env: carve table (B, w), scalars
    sc (B, 8) and the flat grid index of each column's hit cell (B, w)
    int64 (-1: none)."""
    tabs, sc, cell = _frame_inputs(depth, pos, quat, cam, mp, row_stride)
    envs = torch.arange(depth.shape[0], device=depth.device)[:, None]
    hit = torch.where(cell >= 0, envs * (mp.height * mp.width) + cell, cell)
    return tabs.contiguous(), sc.contiguous(), hit.contiguous()


def _multi_inputs(depths, pos, quat, cam: CameraParams, mp: MapParams,
                  row_stride: int):
    """B8 v3's inputs for F frames per env: tabs (B, F, w), sc (B, F, 8)
    float32 and each column's hit cell in its env's grid (B, F, w) int32."""
    B, F = depths.shape[:2]
    tabs, sc, cell = _frame_inputs(depths.reshape((B * F,) + depths.shape[2:]),
                                   pos.reshape(B * F, 3),
                                   quat.reshape(B * F, 4), cam, mp, row_stride)
    return (tabs.reshape(B, F, -1).contiguous(),
            sc.reshape(B, F, 8).contiguous(),
            cell.reshape(B, F, -1).to(torch.int32).contiguous())


def _params(cam: CameraParams, mp: MapParams):
    return (cam.fx, mp.resolution, cam.width / 2.0 - 0.5,
            occupancy._l(mp.prob_hit), occupancy._l(mp.prob_miss),
            occupancy._l(mp.clamp_min), occupancy._l(mp.clamp_max))


def _param_tensors(cam: CameraParams, mp: MapParams, dev):
    return tuple(torch.tensor(v, dtype=torch.float32, device=dev)
                 for v in _params(cam, mp))


def insert_depth_2d_dense(logodds: torch.Tensor, depth: torch.Tensor,
                          pos: torch.Tensor, quat: torch.Tensor,
                          cam: CameraParams, mp: MapParams,
                          row_stride: int = 1) -> torch.Tensor:
    """Fuse one frame per env: logodds (B, H, W), depth (B, h, w) rendered
    at row_stride, pos (B, 3), quat (B, 4). Returns the new (B, H, W)
    grid. Raises, as the reference does, where v1's window does not cover
    the sensor's reach (:func:`window_fits`)."""
    if not window_fits(cam, mp):
        raise ValueError(
            f"dense fusion window (128-cell cap) does not cover "
            f"cam.max_range={cam.max_range} at resolution={mp.resolution}; "
            f"use occupancy.insert_depth_2d (fusion='2d') for this config")
    tabs, sc, hit = _inputs(depth, pos, quat, cam, mp, row_stride)
    if not _v2_map(mp):
        sc, org = _window_inputs(sc, pos, cam, mp)
        return _fuse_window_plain(logodds, tabs, sc, org, hit, cam, mp)
    return _fuse_plain(logodds, tabs, sc, hit, cam, mp)


def _window_inputs(sc, pos, cam: CameraParams, mp: MapParams):
    """v1's window per env (_fuse_flat :657-665): the scalars sc (B, 8)
    with the world centre of the window's cell (0, 0) in place of the map's,
    and org (B, 2) int32 [r0, c0], the window's corner in the grid (rounded
    half to even around the camera, clamped inside the map)."""
    ch, cw = _window_cells(cam, mp)
    row_d = (pos[:, 1] - mp.origin_y) / mp.resolution
    col_d = (pos[:, 0] - mp.origin_x) / mp.resolution
    r0 = torch.clamp(torch.round(row_d - ch / 2), 0, mp.height - ch)
    c0 = torch.clamp(torch.round(col_d - cw / 2), 0, mp.width - cw)
    sc = sc.clone()
    sc[:, 0] = mp.origin_x + (c0 + 0.5) * mp.resolution
    sc[:, 1] = mp.origin_y + (r0 + 0.5) * mp.resolution
    org = torch.stack([r0, c0], 1).to(torch.int32)
    return sc.contiguous(), org.contiguous()


def _carve_update(shape, tabs, sc, cam: CameraParams, mp: MapParams,
                  half_even: bool = False):
    """(B, H, W) carve update of one frame per env on an (H, W) block of
    cells whose cell (0, 0) lies at (sc[:, 0], sc[:, 1]): l_miss on the
    cells that the frame's carve table frees, 0 elsewhere, in the kernels'
    operation order. The column index rounds as v2 does (floor(u + 0.5)),
    or half to even as v1 does."""
    B, H, W = shape
    dev = tabs.device
    fx, res, half_w, _, l_miss, _, _ = _param_tensors(cam, mp, dev)
    colf = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    rowf = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    s = sc[:, :, None, None]
    cp, sp = s[:, 4], s[:, 5]
    dx = (s[:, 0] + colf * res) - s[:, 2]
    dy = (s[:, 1] + rowf * res) - s[:, 3]
    dcx = cp * dx + sp * dy
    dcy = (-sp) * dx + cp * dy
    r_cell = torch.sqrt(dx * dx + dy * dy)
    u = half_w - (fx * dcy) / torch.clamp(dcx, min=1e-6)
    uf = torch.round(u) if half_even else torch.floor(u + 0.5)
    valid = (dcx > 1e-6) & (uf >= 0.0) & (uf <= cam.width - 1)
    uidx = torch.where(valid, uf, torch.zeros_like(uf)).long()
    rcarve = torch.gather(tabs[:, None, :].expand(B, H, -1), 2, uidx)
    carve = valid & (r_cell > 0.0) & (r_cell < rcarve - res)
    return torch.where(carve, l_miss, 0.0)


def _hits_plain(out, hit, cam: CameraParams, mp: MapParams):
    """The hit scatter (_scatter_hits :494) in place on out: a cell hit k
    times gets k adds of l_hit in sequence, as the reference's scatter and
    the kernels' atomic adds give it (a summed k * l_hit would round
    differently), then the grid is clipped."""
    _, _, _, l_hit, _, l_min, l_max = _param_tensors(cam, mp, out.device)
    flat = out.reshape(-1)
    cells, counts = torch.unique(hit[hit >= 0], return_counts=True)
    for k in range(int(counts.max()) if counts.numel() else 0):
        sel = cells[counts > k]
        flat[sel] = flat[sel] + l_hit
    return torch.clamp(out, l_min, l_max)


def _fuse_plain(logodds, tabs, sc, hit, cam: CameraParams, mp: MapParams):
    """B8 v2's plain version: the carve and the hits in PyTorch, in the
    kernel's operation order."""
    _, _, _, _, _, l_min, l_max = _param_tensors(cam, mp, logodds.device)
    out = torch.clamp(logodds + _carve_update(logodds.shape, tabs, sc, cam,
                                              mp), l_min, l_max)
    return _hits_plain(out, hit, cam, mp)


def _fuse_window_plain(logodds, tabs, sc, org, hit, cam: CameraParams,
                       mp: MapParams):
    """B8 v1's plain version: each env's (ch, cw) window at org updated and
    clipped on a copy of the grid, in the kernel's operation order, then
    the hits."""
    B = logodds.shape[0]
    ch, cw = _window_cells(cam, mp)
    _, _, _, _, _, l_min, l_max = _param_tensors(cam, mp, logodds.device)
    dev = logodds.device
    rows = (org[:, 0:1].long() + torch.arange(ch, device=dev))[:, :, None]
    cols = (org[:, 1:2].long() + torch.arange(cw, device=dev))[:, None, :]
    envs = torch.arange(B, device=dev)[:, None, None]
    out = logodds.to(torch.float32).clone()
    upd = _carve_update((B, ch, cw), tabs, sc, cam, mp, half_even=True)
    out[envs, rows, cols] = torch.clamp(out[envs, rows, cols] + upd, l_min,
                                        l_max)
    return _hits_plain(out, hit, cam, mp)


def insert_depth_2d_dense_multi(logodds: torch.Tensor, depths: torch.Tensor,
                                pos: torch.Tensor, quat: torch.Tensor,
                                cam: CameraParams, mp: MapParams,
                                row_stride: int = 1) -> torch.Tensor:
    """Fuse F frames per env in order, one clip per frame: logodds
    (B, H, W), depths (B, F, h, w) rendered at row_stride, pos (B, F, 3),
    quat (B, F, 4). Returns the new (B, H, W) grid. Takes maps with
    W % 128 == 0 and H % 8 == 0 only, as the reference's."""
    if not _v2_map(mp):
        raise ValueError(
            f"multi-frame dense fusion needs a map with width % 128 == 0 "
            f"and height % 8 == 0 (got {mp.width} x {mp.height}): the "
            f"reference's whole-grid v3 kernel")
    tabs, sc, hit = _multi_inputs(depths, pos, quat, cam, mp, row_stride)
    return _fuse_multi_plain(logodds, tabs, sc, hit, cam, mp)


def _fuse_multi_plain(logodds, tabs, sc, hit, cam: CameraParams,
                      mp: MapParams):
    """B8 v3's plain version: per frame, the carve update and the per-cell
    hit count k, then clip((cell + carve) + k * l_hit) once."""
    B, H, W = logodds.shape
    _, _, _, l_hit, _, l_min, l_max = _param_tensors(cam, mp, logodds.device)
    out = logodds
    for f in range(tabs.shape[1]):
        upd = _carve_update(logodds.shape, tabs[:, f], sc[:, f], cam, mp)
        h = hit[:, f].long()
        counts = torch.zeros((B, H * W), dtype=torch.int32,
                             device=logodds.device)
        counts.scatter_add_(1, h.clamp(min=0), (h >= 0).to(torch.int32))
        hits = counts.reshape(B, H, W).to(torch.float32) * l_hit
        out = torch.clamp((out + upd) + hits, l_min, l_max)
    return out

