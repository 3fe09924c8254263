"""2-D Euclidean distance transforms: the exact transform (kernel B9
exact), the truncated one (kernel B9 banded) and the fused truncated
rebuild of the vision loop (kernel B9 fused), each with its plain version.

The port of neoplanner_tpu/ops/edt.py (``_row_distance_sq`` :28, ``_pass2``
:44, ``edt_sq_cells`` :64, ``_pass2_banded`` :75, ``edt_truncated`` :91,
``edt`` :116, ``central_gradient`` :125) and of
neoplanner_tpu/ops/edt_pallas.py (``pass2`` :114, ``pass2_banded`` :85,
``rebuild_truncated_lite`` :203):

  pass 1 (rows):    g2[i,j] = squared distance in cells to the nearest
                    occupied cell of row i (1e9 where the row has none)
  pass 2 (columns): d2[i,j] = min_k (i-k)^2 + g2[k,j]

:func:`edt` is the exact field in meters, sqrt(d2) * res, and 1e4 (FAR)
where a column pass finds no occupied cell at all. With truncation radius
R = ceil(max_dist / res) cells, g2 is clamped at (R+1)^2, pass 2 runs over
|i-k| <= R and is clamped at R^2, and the field is min(sqrt(d2) * res,
max_dist) (:func:`edt_truncated`, and :func:`rebuild_truncated_lite`, which
goes from log-odds straight to the bf16 field). Every step is integer
arithmetic held exactly in f32 (or int32 in the kernels) until one
correctly rounded sqrt, so kernels and plain versions agree bit for bit.

For CUDA tensors each entry point launches its kernel: ``csrc/edt_exact.cu``
(B9 exact), the f32 entry of ``csrc/edt_trunc.cu`` (B9 banded) and its bf16
entry (B9 fused), three instances of one template (``csrc/edt.cuh``); for
CPU tensors it runs the pass chain below.

Replaces: edt_pallas.py ``_pass2_kernel`` (:32) via ``pass2`` (:119),
``_make_banded_kernel`` (:56) via ``pass2_banded`` (:98), and
``_make_fused_trunc_kernel`` (:153) via ``_fused_trunc_flat`` (:187).
Bounds and designs: see the kernel sources.
"""

from __future__ import annotations

import math

import torch


_BIG = 1e9
FAR = 1e4                     # empty-map distance in meters (esdf.py:66)
# the kernels' shape limits (csrc/edt.cuh)
_EXACT_MAX = 1024             # B9 exact: H and W
_TRUNC_MAX_W = 8192           # B9 fused / banded: W, and R below
_TRUNC_MAX_R = 4095           # R^2 + d^2 stays exact in f32
_TILE_ROWS = 256              # output rows of a truncated tile
_SMEM_MAX = 232448            # shared memory a block can use on the H100


def radius_cells(max_dist: float, resolution: float) -> int:
    return max(1, int(math.ceil(max_dist / float(resolution))))


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root of x (f32), as the reference
    and the kernels (__fsqrt_rn) take it: PyTorch's vectorized CPU sqrt is
    not always correctly rounded, the f64 sqrt rounded to f32 is."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


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


def _pass2(g2: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = min_k (i-k)^2 + g2[..., k, j] over all rows, in
    f32 as the reference's ``_pass2``, blocked over output rows so that the
    (..., rows, H, W) broadcast stays near 2^26 elements; any H."""
    H = g2.shape[-2]
    ks = torch.arange(H, dtype=torch.float32, device=g2.device)
    block = max(1, min(H, (1 << 26) // max(g2.numel(), 1)))
    out = []
    for i0 in range(0, H, block):
        i = ks[i0:i0 + block]
        d2 = (i[:, None] - ks[None, :]) ** 2                       # (b, H)
        out.append(torch.amin(d2[:, :, None] + g2[..., None, :, :], dim=-2))
    return torch.cat(out, dim=-2)


def _edt_sq_cells(occupancy: torch.Tensor) -> torch.Tensor:
    """Exact squared EDT in cells of grids (..., H, W) (cells > 0.5 are
    occupied): the reference's ``edt_sq_cells``, the plain pass chain of
    kernel B9 exact; _BIG where no cell is occupied."""
    return _pass2(_row_distance_sq(occupancy > 0.5))


def edt_sq_cells(occupancy: torch.Tensor) -> torch.Tensor:
    """Exact squared EDT in cells of grids (B, H, W) (cells > 0.5 are
    occupied), float32; _BIG (1e9) throughout a grid with no occupied
    cell (edt.py:64). Kernel B9 exact for CUDA tensors: it computes
    sqrt(d2) correctly rounded in f32 (at resolution 1), and since d2 is an
    integer below 2^21 for the kernel's grids of up to 1024 x 1024 cells,
    the square of that root taken in f64 lies within 0.25 of d2, so
    rounding it recovers d2 exactly."""
    return _edt_sq_cells(occupancy)


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


def _truncated_plain(occ: torch.Tensor, resolution: float,
                     max_dist: float) -> torch.Tensor:
    """The truncated field in meters of occ (..., H, W) bool: the plain
    version of kernels B9 banded and B9 fused (before its bf16 store)."""
    radius = radius_cells(max_dist, resolution)
    g2 = torch.clamp(_row_distance_sq(occ), max=float((radius + 1) ** 2))
    d = _sqrt_rn(_pass2_banded(g2, radius)) * torch.tensor(
        resolution, dtype=torch.float32, device=occ.device)
    return torch.clamp(d, max=max_dist)


def edt_truncated(occupancy: torch.Tensor, resolution: float,
                  max_dist: float) -> torch.Tensor:
    """EDT in meters of grids (B, H, W) (cells > 0.5 are occupied), exact
    below max_dist and clamped to it above (float32): kernel B9 banded for
    CUDA tensors."""
    return _truncated_plain(occupancy > 0.5, resolution, max_dist)


def _edt_plain(occupancy: torch.Tensor, resolution: float) -> torch.Tensor:
    """The exact field in meters of grids (..., H, W) (cells > 0.5 are
    occupied): the plain version of kernel B9 exact."""
    d2 = _edt_sq_cells(occupancy)
    d = _sqrt_rn(d2) * torch.tensor(resolution, dtype=torch.float32,
                                    device=d2.device)
    return torch.where(d2 >= _BIG, FAR, torch.clamp(d, max=FAR))


def edt(occupancy: torch.Tensor, resolution: float) -> torch.Tensor:
    """Exact EDT in meters of grids (B, H, W) (cells > 0.5 are occupied),
    float32, as scipy's distance_transform_edt(1 - occ) * res; FAR (1e4)
    throughout a grid with no occupied cell. Kernel B9 exact for CUDA
    tensors."""
    return _edt_plain(occupancy, resolution)


def central_gradient(field: torch.Tensor, spacing: float):
    """np.gradient's central differences of fields (..., H, W), one-sided
    at the borders, divided by spacing: (d/drow, d/dcol) = (grad_y,
    grad_x) per meter (the reference's ``central_gradient`` :125). Plain
    PyTorch on every device: no TPU kernel computes it."""
    gy = torch.empty_like(field)
    gx = torch.empty_like(field)
    gy[..., 1:-1, :] = (field[..., 2:, :] - field[..., :-2, :]) * 0.5
    gy[..., 0, :] = field[..., 1, :] - field[..., 0, :]
    gy[..., -1, :] = field[..., -1, :] - field[..., -2, :]
    gx[..., :, 1:-1] = (field[..., :, 2:] - field[..., :, :-2]) * 0.5
    gx[..., :, 0] = field[..., :, 1] - field[..., :, 0]
    gx[..., :, -1] = field[..., :, -1] - field[..., :, -2]
    # a tensor divisor: a true division on every device, as the reference's
    s = torch.tensor(spacing, dtype=field.dtype, device=field.device)
    return gy / s, gx / s


def rebuild_truncated_lite(logodds: torch.Tensor, thr: float,
                           resolution: float,
                           max_dist: float) -> torch.Tensor:
    """The bf16 truncated field (B, H, W) of log-odds grids (B, H, W):
    occupied where logodds > thr (a float32 value); kernel B9 fused for
    CUDA tensors."""
    return _truncated_plain(logodds > thr, resolution,
                            max_dist).to(torch.bfloat16)

