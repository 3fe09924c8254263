"""Procedural random box worlds, batched, from a ``torch.Generator``.

The port of neoplanner_tpu/world/scenegen.py (``generate`` :53,
``generate_batch`` :79): K
boxes with uniform sizes and positions; boxes that violate the clearance
rule against an earlier active box are redrawn for a fixed number of
rounds, and those still in conflict are deactivated. The draws differ from
JAX's threefry stream for the same seed; the distribution is the same.
"""

from __future__ import annotations

import torch

from neoplanner_tpu_torch.config import WorldParams
from neoplanner_tpu_torch.core.types import BoxWorld


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _sample_xy(gen, B, wp: WorldParams, device):
    K = wp.max_boxes
    x = _uniform(gen, (B, K), wp.pose_x_min, wp.pose_x_max, device)
    y = _uniform(gen, (B, K), wp.pose_y_min, wp.pose_y_max, device)
    return torch.stack([x, y], dim=-1)


def _conflicts(xy, sizes, active, wp: WorldParams):
    """Box i conflicts with an earlier active box j < i when both clearance
    inequalities hold (generate_worlds.py:129-134)."""
    K = xy.shape[1]
    dx = (xy[:, :, None, 0] - xy[:, None, :, 0]).abs()
    dy = (xy[:, :, None, 1] - xy[:, None, :, 1]).abs()
    lim_x = (sizes[:, :, None, 0] + sizes[:, None, :, 0]) / 2 + wp.x_clearance
    lim_y = (sizes[:, :, None, 1] + sizes[:, None, :, 1]) / 2 + wp.y_clearance
    earlier = torch.ones((K, K), dtype=torch.bool, device=xy.device).tril(-1)
    pair = (dx < lim_x) & (dy < lim_y) & earlier & active[:, None, :]
    return pair.any(-1)


def generate_batch(gen: torch.Generator, batch: int,
                   wp: WorldParams) -> BoxWorld:
    """(batch,) independent worlds on the generator's device."""
    device = gen.device
    K = wp.max_boxes
    sizes = torch.stack([
        _uniform(gen, (batch, K), wp.size_x_min, wp.size_x_max, device),
        _uniform(gen, (batch, K), wp.size_y_min, wp.size_y_max, device),
        _uniform(gen, (batch, K), wp.size_z_min, wp.size_z_max, device)],
        dim=-1)
    xy = _sample_xy(gen, batch, wp, device)
    active = (torch.arange(K, device=device) < min(wp.num_boxes, K)
              ).expand(batch, K)
    for _ in range(wp.rejection_rounds):
        bad = _conflicts(xy, sizes, active, wp)
        xy = torch.where(bad[..., None], _sample_xy(gen, batch, wp, device),
                         xy)
    active = active & ~_conflicts(xy, sizes, active, wp)
    centers = torch.cat([xy, sizes[..., 2:3] / 2], dim=-1)
    return BoxWorld(centers=centers, half_sizes=sizes / 2, active=active,
                    shape=torch.zeros((batch, K), dtype=torch.int32,
                                      device=device))


def generate(gen: torch.Generator, wp: WorldParams) -> BoxWorld:
    """One world, its fields without the env axis ((K, 3), (K,)), on the
    generator's device: generate_batch of one env."""
    world = generate_batch(gen, 1, wp)
    return BoxWorld(centers=world.centers[0], half_sizes=world.half_sizes[0],
                    active=world.active[0], shape=world.shape[0])
