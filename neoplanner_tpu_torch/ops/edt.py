"""Truncated 2-D Euclidean distance transform: kernel B9 (fused) and its
plain version.

The port of neoplanner_tpu/ops/edt.py (``_row_distance_sq`` :28,
``_pass2_banded`` :75, ``edt_truncated`` :91) and of
neoplanner_tpu/ops/edt_pallas.py ``rebuild_truncated_lite`` (:203). With
truncation radius R = ceil(max_dist / res) cells:

  pass 1 (rows):    g2[i,j] = min(squared distance to the nearest occupied
                    cell of row i, (R+1)^2)
  pass 2 (columns): d2[i,j] = min(R^2, min_{|d|<=R} d^2 + g2[i+d,j])
  field = min(sqrt(d2) * res, max_dist)

Exact below max_dist, clamped above. :func:`rebuild_truncated_lite` goes
from log-odds straight to the bf16 field: for CUDA tensors in one launch of
``csrc/edt_trunc.cu`` per call, for CPU tensors through the pass chain
below. Every step is integer arithmetic held exactly in f32 until one
sqrt, so both agree bit for bit.

Replaces: edt_pallas.py ``_make_fused_trunc_kernel`` (:153) via
``_fused_trunc_flat`` (:187). Bound on the H100: device memory, 6 B per
cell against ~4(2R+1) integer operations. Design: row tiles with an R-row
halo in shared memory (binarized bytes, then uint16 pass-1 results).
"""

from __future__ import annotations

import math

import torch

from neoplanner_tpu_torch import _cuda

_BIG = 1e9
_TILE = 16                    # output rows per block (csrc/edt_trunc.cu)
_SMEM_MAX = 227 * 1024        # shared memory a block can use on the H100


def radius_cells(max_dist: float, resolution: float) -> int:
    return max(1, int(math.ceil(max_dist / float(resolution))))


def _row_distance_sq(occ: torch.Tensor) -> torch.Tensor:
    """Per-row squared distance in cells to the nearest occupied cell of
    occ (..., W) bool; _BIG where a row has none."""
    W = occ.shape[-1]
    idx = torch.arange(W, dtype=torch.float32, device=occ.device)
    big = torch.tensor(-_BIG, dtype=torch.float32, device=occ.device)
    left = torch.cummax(torch.where(occ, idx, big), dim=-1).values
    right = -torch.flip(torch.cummax(torch.flip(
        torch.where(occ, -idx, big), [-1]), dim=-1).values, [-1])
    dist = torch.minimum(idx - left, right - idx)
    return torch.clamp(dist * dist, max=_BIG)


def _pass2_banded(g2: torch.Tensor, radius: int) -> torch.Tensor:
    """out[..., i, j] = min_{|d|<=radius} d^2 + g2[..., i+d, j], clamped at
    radius^2 (rows outside the grid never win)."""
    H = g2.shape[-2]
    r2 = float(radius * radius)
    out = torch.clamp(g2, max=r2)
    for d in range(1, min(radius, H - 1) + 1):
        dd = float(d * d)
        down = torch.full_like(g2, _BIG)
        up = torch.full_like(g2, _BIG)
        down[..., :H - d, :] = g2[..., d:, :]
        up[..., d:, :] = g2[..., :H - d, :]
        out = torch.minimum(out, torch.minimum(down, up) + dd)
    return torch.clamp(out, max=r2)


def edt_truncated(occ: torch.Tensor, resolution: float,
                  max_dist: float) -> torch.Tensor:
    """EDT in meters of occ (..., H, W) bool, exact below max_dist and
    clamped to it above (float32)."""
    radius = radius_cells(max_dist, resolution)
    g2 = torch.clamp(_row_distance_sq(occ), max=float((radius + 1) ** 2))
    d = torch.sqrt(_pass2_banded(g2, radius)) * torch.tensor(
        resolution, dtype=torch.float32, device=occ.device)
    return torch.clamp(d, max=max_dist)


def rebuild_truncated_lite(logodds: torch.Tensor, thr: float,
                           resolution: float,
                           max_dist: float) -> torch.Tensor:
    """The bf16 truncated field (B, H, W) of log-odds grids (B, H, W):
    occupied where logodds > thr (a float32 value)."""
    if not logodds.is_cuda:
        return edt_truncated(logodds > thr, resolution,
                             max_dist).to(torch.bfloat16)
    out = torch.empty(logodds.shape, dtype=torch.bfloat16,
                      device=logodds.device)
    launch_edt(logodds.to(torch.float32).contiguous(), out, thr, resolution,
               max_dist)
    return out


def launch_edt(logodds, out, thr: float, resolution: float,
               max_dist: float) -> None:
    """Launch B9 on prepared tensors: logodds (B, H, W) float32; writes out
    (B, H, W) bfloat16."""
    dev = logodds.device
    B, H, W = logodds.shape
    _cuda.require(logodds, "logodds", (B, H, W), torch.float32, dev)
    _cuda.require(out, "out", (B, H, W), torch.bfloat16, dev)
    radius = radius_cells(max_dist, resolution)
    if (_TILE + 2 * radius) * W * 3 + 1 > _SMEM_MAX:
        raise ValueError(f"a {W}-cell row tile with a {radius}-row halo "
                         f"exceeds the kernel's shared memory")
    if B == 0:
        return
    lib = _cuda.load()
    err = lib.neo_edt_trunc_lite(
        _cuda.ptr(logodds), _cuda.ptr(out), B, H, W, radius,
        _cuda.host_floats([thr, resolution, max_dist]), _cuda.stream_ptr(dev))
    _cuda.check(err, "edt_trunc_lite")
    _cuda.launches["edt_trunc_lite"] += 1
