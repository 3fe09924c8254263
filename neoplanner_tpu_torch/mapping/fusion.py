"""Dense polar depth fusion of one frame per env: kernel B8 v2 and its plain
version.

:func:`insert_depth_2d_dense` is the port of
neoplanner_tpu/mapping/occupancy_pallas.py ``insert_depth_2d_dense`` (:478)
on its v2 branch (``_fuse_flat`` :611-652) with ``_scatter_hits`` (:494).
Each frame collapses to a per-column carve table (occupancy.polar_columns);
every grid cell then tests itself against the table (r_cell < r_carve(u) -
res: + l_miss, then clip), and each column's nearest in-slice hit adds
l_hit to the cell that holds it, then the grid is clipped again. For CUDA
tensors the carve and the hits run in ``csrc/fusion.cu``; for CPU tensors
:func:`_fuse_plain` runs the same arithmetic in PyTorch.

Replaces: occupancy_pallas.py ``_make_kernel_v2`` (:176) via
``_fuse_call_v2`` (:263). Bound on the H100: device memory (the grid is
read and written once, ~25 flops per cell). Design: one thread per cell of
the whole grid, the carve table in shared memory; the hits are one atomic
clip-add per column in a second launch.
"""

from __future__ import annotations

import torch

from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import CameraParams, MapParams
from neoplanner_tpu_torch.core import frames
from neoplanner_tpu_torch.mapping import occupancy


def _check_v2(mp: MapParams) -> None:
    """The port has the reference's v2 dense fusion only, which covers the
    whole sensor reach on any map with W % 128 == 0 and H % 8 == 0: raise
    where the reference would take its v1 windowed kernel instead."""
    if not (mp.width % 128 == 0 and mp.height % 8 == 0):
        raise ValueError(
            f"dense fusion needs a map with width % 128 == 0 and height % 8 "
            f"== 0 (got {mp.width} x {mp.height}); the reference's v1 "
            f"windowed kernel for other maps is not ported")


def _inputs(depth, pos, quat, cam: CameraParams, mp: MapParams):
    """Per-env carve table (B, w), kernel scalars sc (B, 8) and the flat
    grid index of each column's hit cell (B, w) int64 (-1: none)."""
    B = depth.shape[0]
    r_hit, r_carve, u_dir = occupancy.polar_columns(depth, pos, quat, cam, mp)
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
    envs = torch.arange(B, device=depth.device)[:, None]
    flat = (envs * mp.height + hrow) * mp.width + hcol
    hit = torch.where(hinb & (r_hit < occupancy.BIG), flat,
                      torch.full_like(flat, -1))
    return r_carve.contiguous(), sc.contiguous(), hit.contiguous()


def _params(cam: CameraParams, mp: MapParams):
    return (cam.fx, mp.resolution, cam.width / 2.0 - 0.5,
            occupancy._l(mp.prob_hit), occupancy._l(mp.prob_miss),
            occupancy._l(mp.clamp_min), occupancy._l(mp.clamp_max))


def insert_depth_2d_dense(logodds: torch.Tensor, depth: torch.Tensor,
                          pos: torch.Tensor, quat: torch.Tensor,
                          cam: CameraParams, mp: MapParams) -> torch.Tensor:
    """Fuse one frame per env: logodds (B, H, W), depth (B, h, w) full
    resolution, pos (B, 3), quat (B, 4). Returns the new (B, H, W) grid."""
    _check_v2(mp)
    tabs, sc, hit = _inputs(depth, pos, quat, cam, mp)
    if not logodds.is_cuda:
        return _fuse_plain(logodds, tabs, sc, hit, cam, mp)
    out = torch.empty_like(logodds)
    launch_fuse(logodds.contiguous(), tabs, sc, hit, out, cam, mp)
    return out


def _fuse_plain(logodds, tabs, sc, hit, cam: CameraParams, mp: MapParams):
    """The carve and the hits in PyTorch, in the kernel's operation order."""
    B, H, W = logodds.shape
    dev = logodds.device
    fx, res, half_w, l_hit, l_miss, l_min, l_max = (
        torch.tensor(v, dtype=torch.float32, device=dev)
        for v in _params(cam, mp))
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
    uf = torch.floor(u + 0.5)
    valid = (dcx > 1e-6) & (uf >= 0.0) & (uf <= cam.width - 1)
    uidx = torch.where(valid, uf, torch.zeros_like(uf)).long()
    rcarve = torch.gather(tabs[:, None, :].expand(B, H, -1), 2, uidx)
    carve = valid & (r_cell > 0.0) & (r_cell < rcarve - res)
    out = torch.clamp(logodds + torch.where(carve, l_miss, 0.0), l_min, l_max)
    # hits: a cell hit k times gets k adds of l_hit in sequence, as the
    # reference's scatter and the kernel's atomic adds give it (a summed
    # k * l_hit would round differently)
    flat = out.reshape(-1)
    cells, counts = torch.unique(hit[hit >= 0], return_counts=True)
    for k in range(int(counts.max()) if counts.numel() else 0):
        sel = cells[counts > k]
        flat[sel] = flat[sel] + l_hit
    return torch.clamp(out, l_min, l_max)


def launch_fuse(logodds, tabs, sc, hit, out, cam: CameraParams,
                mp: MapParams) -> None:
    """Launch B8 v2 on prepared tensors: logodds (B, H, W), tabs (B, w),
    sc (B, 8) float32, hit (B, w) int64 (:func:`_inputs`); writes out."""
    dev = logodds.device
    B, H, W = logodds.shape
    w = cam.width
    for t, name, shape in ((logodds, "logodds", (B, H, W)),
                           (out, "out", (B, H, W)), (tabs, "tabs", (B, w)),
                           (sc, "sc", (B, 8))):
        _cuda.require(t, name, shape, torch.float32, dev)
    _cuda.require(hit, "hit", (B, w), torch.int64, dev)
    if B == 0:
        return
    lib = _cuda.load()
    err = lib.neo_fuse_depth_dense(
        _cuda.ptr(logodds), _cuda.ptr(tabs), _cuda.ptr(sc), _cuda.ptr(hit),
        _cuda.ptr(out), B, H, W, w, _cuda.host_floats(_params(cam, mp)),
        _cuda.stream_ptr(dev))
    _cuda.check(err, "fuse_depth_dense")
    _cuda.launches["fuse_depth_dense"] += 1
