"""Analytic 2-D scene map: exact signed distance to the obstacle footprints.

The port of neoplanner_tpu/mapping/scene.py (``build`` :39, ``sample`` :59).
Every field carries the env axis: a SceneMap holds B scenes of K primitives,
and :func:`sample` queries points (B, ..., 2) each against its own env's
scene. The distance is negative inside a footprint; with no active primitive
it is the far value 1e4 and the gradient is 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .config import MapParams
from .types import SHAPE_CYLINDER, BoxWorld, _Replace

FAR = 1e4


@dataclass
class SceneMap(_Replace):
    centers: torch.Tensor   # (B, K, 2) footprint centers
    half: torch.Tensor      # (B, K, 2) half extents (cylinders: radius in [..., 0])
    is_cyl: torch.Tensor    # (B, K) bool
    active: torch.Tensor    # (B, K) bool (inactive or out-of-slice prims masked)

    def index(self, idx) -> "SceneMap":
        """The scenes of the envs ``idx`` (an index tensor over B)."""
        return SceneMap(self.centers[idx], self.half[idx], self.is_cyl[idx],
                        self.active[idx])


def build(world: BoxWorld, mp: MapParams) -> SceneMap:
    """Project the scenes onto the occupancy slice [z_min, z_max]."""
    z_lo = world.centers[..., 2] - world.half_sizes[..., 2]
    z_hi = world.centers[..., 2] + world.half_sizes[..., 2]
    in_slice = (z_hi > mp.z_min) & (z_lo < mp.z_max)
    return SceneMap(centers=world.centers[..., :2].contiguous(),
                    half=world.half_sizes[..., :2].contiguous(),
                    is_cyl=world.shape == SHAPE_CYLINDER,
                    active=world.active & in_slice)


def pack_prims(scene: SceneMap) -> torch.Tensor:
    """(B, K, 6) float32 table [cx, cy, hx, hy, is_cyl, active] — the
    primitive layout the solver and tracker kernels read."""
    return torch.cat([scene.centers, scene.half,
                      scene.is_cyl[..., None].to(scene.centers.dtype),
                      scene.active[..., None].to(scene.centers.dtype)],
                     dim=-1).to(torch.float32).contiguous()


def _safe_norm(v: torch.Tensor) -> torch.Tensor:
    """L2 norm over the last axis with a zero gradient at the origin."""
    sq = (v * v).sum(-1)
    safe = sq > 0
    return torch.where(safe, torch.sqrt(torch.where(safe, sq,
                                                    torch.ones_like(sq))),
                       torch.zeros_like(sq))


def sample(scene: SceneMap, pos: torch.Tensor):
    """Signed distance and gradient at points pos (B, ..., 2) of each env:
    returns (dis (B, ...), grad (B, ..., 2))."""
    B = pos.shape[0]
    mid = pos.shape[1:-1]
    p = pos.reshape(B, -1, 1, 2)                                # (B, P, 1, 2)
    d = p - scene.centers[:, None]                              # (B, P, K, 2)
    half = scene.half[:, None]
    q = d.abs() - half
    box_out = _safe_norm(torch.clamp(q, min=0.0))
    box_in = torch.clamp(torch.maximum(q[..., 0], q[..., 1]), max=0.0)
    d_box = box_out + box_in
    d_cyl = _safe_norm(d) - half[..., 0]
    dist_k = torch.where(scene.is_cyl[:, None], d_cyl, d_box)
    dist_k = torch.where(scene.active[:, None], dist_k,
                         torch.full_like(dist_k, FAR))
    dis, k = torch.min(dist_k, dim=-1)                          # (B, P)

    # gradient of the min via the argmin primitive's analytic gradient
    dk = torch.gather(d, 2, k[..., None, None].expand(B, k.shape[1], 1, 2)
                      ).squeeze(2)                              # (B, P, 2)
    halfk = torch.gather(scene.half, 1, k[..., None].expand(B, k.shape[1], 2))
    cylk = torch.gather(scene.is_cyl, 1, k)
    qk = dk.abs() - halfk
    outside = torch.clamp(qk, min=0.0)
    nrm = torch.linalg.vector_norm(outside, dim=-1, keepdim=True)
    g_out = torch.sign(dk) * outside / torch.clamp(nrm, min=1e-9)
    ax = (qk[..., 1] > qk[..., 0]).to(pos.dtype)
    g_in = torch.sign(dk) * torch.stack([1.0 - ax, ax], dim=-1)
    g_box = torch.where(nrm > 1e-9, g_out, g_in)
    g_cyl = dk / torch.clamp(torch.linalg.vector_norm(dk, dim=-1, keepdim=True),
                             min=1e-9)
    grad = torch.where(cylk[..., None], g_cyl, g_box)
    no_active = ~scene.active.any(-1)
    grad = torch.where(no_active[:, None, None], torch.zeros_like(grad), grad)
    return dis.reshape((B,) + mid), grad.reshape((B,) + mid + (2,))
