"""ESDF maps in both of the reference's profiles: construction and
sampling.

The port of neoplanner_tpu/mapping/esdf.py: ``build`` (:29; the exact
field for max_dist = 0, the truncated one for max_dist > 0, the full
profile with occupancy and gradient planes or the lite bf16 one),
``_cell_index`` (:66), ``sample_nearest`` (:85), ``sample_bilinear``
(:112), ``sample`` (:222, "mxu" sampling as bilinear), ``make_window``
(:193), ``has_collision`` (:234) and ``is_occupied`` (:240), batched over
envs. :class:`GridWindow` and :func:`sample_window` are the per-env ESDF
windows of the grid solver and the tap semantics of its kernel
(plan/solve_pallas_grid.py ``sample`` :60-130): the plain version of
kernel B6's distance query.

Out-of-map queries read 1e4 m (free) with a zero gradient (esdf.py:66, 80).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .types import ESDFMap, _Replace
from . import edt

FAR = 1e4


def build(occupancy: torch.Tensor, origin, resolution: float,
          max_dist: float = 0.0, lite: bool = False) -> ESDFMap:
    """ESDFMap of occupancy grids (B, H, W) {0, 1} (cells > 0.5 are
    occupied). max_dist = 0: the exact field (kernel B9 exact for CUDA
    tensors), FAR on a grid with no occupied cell; max_dist > 0: exact below
    max_dist and clamped above (kernel B9 banded). lite=True keeps the field
    in bf16 and no planes (an exact lite field reads 9984, bf16's FAR, on an
    empty grid); else the f32 field with its occupancy and its
    central-difference gradient planes (per meter)."""
    occupancy = occupancy.to(torch.float32)
    if max_dist > 0.0:
        dist = edt.edt_truncated(occupancy, resolution, max_dist)
    else:
        dist = edt.edt(occupancy, resolution)
    org = _origin(origin, occupancy.device)
    if lite:
        return ESDFMap(esdf=dist.to(torch.bfloat16), origin=org,
                       resolution=float(resolution))
    gy, gx = edt.central_gradient(dist, resolution)
    return ESDFMap(esdf=dist, origin=org, resolution=float(resolution),
                   occupancy=occupancy, grad_x=gx, grad_y=gy)


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


def _nearest(emap: ESDFMap, p: torch.Tensor):
    """Flat cell index (B, N) of the nearest cell of points p (B, N, 2)
    (clamped into the map) and whether the point lies in the map."""
    H, W = emap.esdf.shape[-2:]
    rowf, colf = _cell_index(emap, p)
    row = torch.floor(rowf).long()
    col = torch.floor(colf).long()
    inb = (row >= 0) & (row < H) & (col >= 0) & (col < W)
    return row.clamp(0, H - 1) * W + col.clamp(0, W - 1), inb


def _gather(field: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    return torch.gather(field.reshape(field.shape[0], -1), 1, flat)


def _nearest_sample(emap: ESDFMap, pos: torch.Tensor):
    """Nearest-cell distance (B, ...) at pos (B, ..., 2) and, on a full
    map, the looked-up gradient (B, ..., 2) (None on a lite map). On a full
    map the distance is differentiable in pos with that gradient as its
    derivative: the reference's straight-through linearization, whose value
    is (d0 - lin) + lin."""
    p, mid = _flat(pos)
    B = p.shape[0]
    flat, inb = _nearest(emap, p)
    d0 = torch.where(inb, _gather(emap.esdf, flat).to(torch.float32), FAR)
    if emap.lite:
        return d0.reshape((B,) + mid), None
    gx = torch.where(inb, _gather(emap.grad_x, flat), 0.0)
    gy = torch.where(inb, _gather(emap.grad_y, flat), 0.0)
    grad = torch.stack([gx, gy], dim=-1)
    lin = (grad.detach() * p).sum(-1)
    dis = (d0 - lin).detach() + lin
    return dis.reshape((B,) + mid), grad.reshape((B,) + mid + (2,))


def sample_nearest(emap: ESDFMap, pos: torch.Tensor):
    """Nearest-cell lookup at points pos (B, ..., 2) of each env's map, the
    reference's semantics: on a full map (distance (B, ...), gradient
    (B, ..., 2)), the distance differentiable with the gradient as its
    derivative; on a lite map, which has no gradient planes, the distance
    alone."""
    dis, grad = _nearest_sample(emap, pos)
    return dis if grad is None else (dis, grad)


def nearest_distance(emap: ESDFMap, pos: torch.Tensor) -> torch.Tensor:
    """The nearest-cell distance (B, ...) at pos (B, ..., 2) on either
    profile (the distance of :func:`sample_nearest`)."""
    return _nearest_sample(emap, pos)[0]


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
    (B, ..., 2) of a bf16 (lite) or f32 (full) field, in f32: (B, ...),
    differentiable in pos (autograd gives the analytic bilinear
    gradient)."""
    p, mid = _flat(pos)
    H, W = emap.esdf.shape[-2:]
    rowf, colf = _cell_index(emap, p)
    inb = ((torch.floor(rowf) >= 0) & (torch.floor(rowf) < H)
           & (torch.floor(colf) >= 0) & (torch.floor(colf) < W))
    u = torch.clamp(rowf - 0.5, 0.0, H - 1.001)
    v = torch.clamp(colf - 0.5, 0.0, W - 1.001)
    dis = _bilinear(emap.esdf.to(torch.float32), u, v)
    return torch.where(inb, dis, FAR).reshape((p.shape[0],) + mid)


def sample_bilinear_mxu(emap: ESDFMap, pos: torch.Tensor) -> torch.Tensor:
    """The reference's esdf.py ``sample_bilinear_mxu`` (:148): the same
    function as :func:`sample_bilinear`. The reference phrases the four
    taps as one-hot matrix products in bf16 because the TPU has no gather,
    a TPU workaround that the port does not copy: on the GPU (and the
    CPU) a tap is an indexed load in f32."""
    return sample_bilinear(emap, pos)


def sample(emap: ESDFMap, pos: torch.Tensor, mode: str = "bilinear"):
    """Distance at pos by pp.esdf_interp: "nearest", "bilinear", or "mxu".
    The reference's "mxu" (esdf.py ``sample_bilinear_mxu`` :148) is the
    bilinear interpolation phrased as one-hot matrix products in bf16,
    because the TPU has no gather; here the same taps are indexed loads in
    f32 (:func:`sample_bilinear`), within the reference's bf16 error of it."""
    if mode == "nearest":
        return nearest_distance(emap, pos)
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


def has_collision(emap: ESDFMap, pos: torch.Tensor,
                  safe_dis: float) -> torch.Tensor:
    """Point-in-collision predicate at pos (B, ..., 2): nearest-cell
    distance below safe_dis (esdf.py:50-51)."""
    return nearest_distance(emap, pos) < safe_dis


def is_occupied(emap: ESDFMap, pos: torch.Tensor) -> torch.Tensor:
    """Occupancy at pos (B, ..., 2) (esdf.py:35-48): the nearest cell's
    occupancy plane, or on a lite map a zero distance (the EDT is exactly
    zero on an occupied cell); out of the map is free."""
    p, mid = _flat(pos)
    flat, inb = _nearest(emap, p)
    if emap.lite:
        occ = _gather(emap.esdf, flat) <= 0.0
    else:
        occ = _gather(emap.occupancy, flat) > 0.5
    return (occ & inb).reshape((p.shape[0],) + mid)
