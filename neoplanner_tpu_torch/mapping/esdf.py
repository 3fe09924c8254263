"""The lite ESDF of the vision loop: construction and sampling.

The port of neoplanner_tpu/mapping/esdf.py in its lite profile (a bf16
truncated distance field per env, no occupancy or gradient planes):
``build`` (:29) with max_dist, ``_cell_index`` (:66), ``sample_nearest``
(:85, distance only), ``sample_bilinear`` (:112), ``sample`` (:222, "mxu"
sampling as bilinear) and ``make_window`` (:193),
batched over envs (``has_collision`` :234 is mapping/query.has_collision). :class:`GridWindow` and
:func:`sample_window` are the per-env ESDF windows of the grid solver and
the tap semantics of its kernel (plan/solve_pallas_grid.py ``sample``
:60-130): the plain version of kernel B6's distance query.

Out-of-map queries read 1e4 m (free) with a zero gradient (esdf.py:66, 80).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from neoplanner_tpu_torch.core.types import ESDFMap, _Replace
from neoplanner_tpu_torch.ops import edt

FAR = 1e4


def build(occupancy: torch.Tensor, origin, resolution: float,
          max_dist: float) -> ESDFMap:
    """Lite ESDFMap of occupancy grids (B, H, W) {0, 1}: the truncated field
    (exact below max_dist > 0, clamped above) in bf16, computed by kernel
    B9 for CUDA tensors (cells > 0.5 are occupied)."""
    if max_dist <= 0.0:
        raise ValueError("the port builds truncated lite maps only "
                         "(max_dist > 0)")
    field = edt.rebuild_truncated_lite(occupancy.to(torch.float32), 0.5,
                                       resolution, max_dist)
    return ESDFMap(esdf=field, origin=_origin(origin, occupancy.device),
                   resolution=float(resolution))


def _origin(origin, device) -> torch.Tensor:
    return torch.as_tensor(origin, dtype=torch.float32, device=device)


def _cell_index(emap: ESDFMap, pos: torch.Tensor):
    """World (x, y) -> (row, col) float cell coordinates (row = y)."""
    col = (pos[..., 0] - emap.origin[0]) / emap.resolution
    row = (pos[..., 1] - emap.origin[1]) / emap.resolution
    return row, col


def _flat(pos: torch.Tensor):
    """(B, ..., 2) -> (B, N, 2) and the middle shape."""
    return pos.reshape(pos.shape[0], -1, 2), pos.shape[1:-1]


def sample_nearest(emap: ESDFMap, pos: torch.Tensor) -> torch.Tensor:
    """Nearest-cell distance at points pos (B, ..., 2) of each env's map:
    (B, ...). The lite map has no gradient planes; its consumers (metric,
    local-target escape, acceptance) read distances only."""
    p, mid = _flat(pos)
    B = p.shape[0]
    H, W = emap.esdf.shape[-2:]
    rowf, colf = _cell_index(emap, p)
    row = torch.floor(rowf).long()
    col = torch.floor(colf).long()
    inb = (row >= 0) & (row < H) & (col >= 0) & (col < W)
    flat = row.clamp(0, H - 1) * W + col.clamp(0, W - 1)
    d0 = torch.gather(emap.esdf.reshape(B, H * W), 1, flat).to(torch.float32)
    return torch.where(inb, d0, FAR).reshape((B,) + mid)


def _bilinear(field: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Bilinear value of field (B, Hf, Wf) float32 at clipped center
    coordinates u (rows) and v (cols), each (B, N); differentiable in u, v."""
    B, Hf, Wf = field.shape
    r0 = torch.floor(u).detach()
    c0 = torch.floor(v).detach()
    fr = u - r0
    fc = v - c0
    base = r0.long() * Wf + c0.long()
    flat = field.reshape(B, Hf * Wf)

    def tap(off):
        return torch.gather(flat, 1, base + off)

    d00, d01, d10, d11 = tap(0), tap(1), tap(Wf), tap(Wf + 1)
    top = d00 * (1 - fc) + d01 * fc
    bot = d10 * (1 - fc) + d11 * fc
    return top * (1 - fr) + bot * fr


def sample_bilinear(emap: ESDFMap, pos: torch.Tensor) -> torch.Tensor:
    """Bilinearly interpolated distance between cell centers at pos
    (B, ..., 2): (B, ...), differentiable in pos (autograd gives the
    analytic bilinear gradient)."""
    p, mid = _flat(pos)
    H, W = emap.esdf.shape[-2:]
    rowf, colf = _cell_index(emap, p)
    inb = ((torch.floor(rowf) >= 0) & (torch.floor(rowf) < H)
           & (torch.floor(colf) >= 0) & (torch.floor(colf) < W))
    u = torch.clamp(rowf - 0.5, 0.0, H - 1.001)
    v = torch.clamp(colf - 0.5, 0.0, W - 1.001)
    dis = _bilinear(emap.esdf.to(torch.float32), u, v)
    return torch.where(inb, dis, FAR).reshape((p.shape[0],) + mid)


def sample(emap: ESDFMap, pos: torch.Tensor, mode: str = "bilinear"):
    """Distance at pos by pp.esdf_interp: "nearest", "bilinear", or "mxu".
    The reference's "mxu" (esdf.py ``sample_bilinear_mxu`` :148) is the
    bilinear interpolation phrased as one-hot matrix products in bf16,
    because the TPU has no gather; here the same taps are indexed loads in
    f32 (:func:`sample_bilinear`), within the reference's bf16 error of it."""
    if mode == "nearest":
        return sample_nearest(emap, pos)
    if mode in ("bilinear", "mxu"):
        return sample_bilinear(emap, pos)
    raise ValueError(f"unsupported esdf interpolation mode: {mode}")


@dataclass
class GridWindow(_Replace):
    """Per-env crops of the distance field for the grid solver."""

    win: torch.Tensor    # (E, Hw, Ww) float32
    worg: torch.Tensor   # (E, 7) [x0, y0, res, map_x0, map_y0, map_x1, map_y1]

    def index(self, idx) -> "GridWindow":
        return GridWindow(self.win[idx], self.worg[idx])


def make_window(emap: ESDFMap, center: torch.Tensor,
                cells: int) -> GridWindow:
    """min(cells, H) x min(cells, W) crop of each env's field around
    center (B, 2), clamped inside the map (a window near an edge slides
    inward), as float32; the map bounds ride along so that samples outside
    the map read FAR (the random-mission goals lie beyond the map edge)."""
    B, H, W = emap.esdf.shape
    hw, ww = int(min(cells, H)), int(min(cells, W))
    rowf, colf = _cell_index(emap, center)
    r0 = torch.clamp(torch.round(rowf - hw / 2), 0, H - hw).long()
    c0 = torch.clamp(torch.round(colf - ww / 2), 0, W - ww).long()
    dev = emap.esdf.device
    rows = r0[:, None] + torch.arange(hw, device=dev)            # (B, hw)
    cols = c0[:, None] + torch.arange(ww, device=dev)            # (B, ww)
    envs = torch.arange(B, device=dev)[:, None, None]
    win = emap.esdf[envs, rows[:, :, None], cols[:, None, :]].to(
        torch.float32)
    res = torch.tensor(emap.resolution, dtype=torch.float32, device=dev)
    origin = emap.origin + torch.stack([c0, r0], 1).to(torch.float32) * res
    map_lo = emap.origin.expand(B, 2)
    map_hi = map_lo + torch.tensor([W, H], dtype=torch.float32,
                                   device=dev) * res
    worg = torch.cat([origin, res.expand(B, 1), map_lo, map_hi], 1)
    return GridWindow(win=win.contiguous(), worg=worg.contiguous())


def sample_window(window: GridWindow, pos: torch.Tensor) -> torch.Tensor:
    """Distance at pos (E, ..., 2) from each row's window, with the grid
    solver kernel's semantics: bilinear taps at (world - window origin) / res
    - 0.5 clipped to [0, Hw - 1.001] (the derivative is zero where the clip
    bites), FAR outside the map. Differentiable in pos."""
    p, mid = _flat(pos)
    _, Hw, Ww = window.win.shape
    o = window.worg[:, None, :]
    px, py = p[..., 0], p[..., 1]
    uraw = (py - o[..., 1]) / o[..., 2] - 0.5
    vraw = (px - o[..., 0]) / o[..., 2] - 0.5
    u = torch.clamp(uraw, 0.0, Hw - 1.001)
    v = torch.clamp(vraw, 0.0, Ww - 1.001)
    dis = _bilinear(window.win, u, v)
    out_map = ((px < o[..., 3]) | (py < o[..., 4]) | (px >= o[..., 5])
               | (py >= o[..., 6]))
    return torch.where(out_map, FAR, dis).reshape((p.shape[0],) + mid)
