"""Map queries of the closed loop on the analytic scene SDF — the scene
branch of neoplanner_tpu/mapping/query.py (the grid ESDF is not ported)."""

from __future__ import annotations

import torch

from neoplanner_tpu_torch.mapping import scene as scene_map


def distance(scene: scene_map.SceneMap, pos: torch.Tensor):
    """(dis, grad) at points pos (B, ..., 2) of each env's scene."""
    return scene_map.sample(scene, pos)


def has_collision(scene: scene_map.SceneMap, pos: torch.Tensor,
                  safe_dis) -> torch.Tensor:
    """Point-in-collision predicate (esdf.py:50-51 semantics)."""
    dis, _ = distance(scene, pos)
    return dis < safe_dis
