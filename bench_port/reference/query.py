"""Map queries of the closed loop on either map backend: the analytic scene
SDF (SceneMap) or a grid ESDF (ESDFMap, lite or full) — the port of
neoplanner_tpu/mapping/query.py. Grid queries take the nearest cell, the
reference's semantics (esdf.py:53-82)."""

from __future__ import annotations

import torch

from . import esdf as esdf_map
from . import scene as scene_map


def distance(map_obj, pos: torch.Tensor) -> torch.Tensor:
    """Distance at points pos (B, ..., 2) of each env's map: (B, ...)."""
    if isinstance(map_obj, scene_map.SceneMap):
        return scene_map.sample(map_obj, pos)[0]
    return esdf_map.nearest_distance(map_obj, pos)


def has_collision(map_obj, pos: torch.Tensor, safe_dis) -> torch.Tensor:
    """Point-in-collision predicate (esdf.py:50-51 semantics)."""
    return distance(map_obj, pos) < safe_dis
