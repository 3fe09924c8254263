"""Geometric-initialization planner: grid search -> pruned waypoints ->
refine, the paper's geometric baseline (GeoPlanner + AstarPlanner).

The port of neoplanner_tpu/plan/geo.py. Two front ends produce the path:

- the host planner (numpy and heapq, one env): ``astar`` (:42), the
  reference's 8-connected A* on a map virtually expanded by 10 m with the
  ESDF collision predicate; ``seg_feasible`` (:105) and ``prune_path``
  (:124), the reference's pruning to start + 2 interior waypoints + goal;
  ``geo_plan`` (:160), which refines them with the expert's warm start;
- the device planner, batched over B envs, that step_segment's 'geo'
  branch runs: ``wavefront_field`` (:183), a cost-to-go field by iterated
  8-neighbour min-plus relaxation; ``descend_path`` (:221), the greedy
  descent of it; ``prune_path_device`` (:254), the same pruning rule as a
  masked walk with a fixed sample count; ``geo_plan_device`` (:331).

The device planner's sums of 1 and sqrt(2) f32 and its cell indices are
exact, so its field, descent points and key indices are the JAX
package's bit for bit: out-of-grid neighbours read INF = 1e9 (INF plus a
step cost rounds back to INF in f32, as the JAX package's masked rolls
give), argmin and argmax take the first index of ties, and the descent's
points are cell centres (+0.5) where astar's are cell corners.
"""

from __future__ import annotations

import heapq
import math
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from neoplanner_tpu_torch.config import PlannerParams
from neoplanner_tpu_torch.core.types import ESDFMap, Trajectory
from neoplanner_tpu_torch.mapping import esdf as esdf_map
from neoplanner_tpu_torch.plan import expert
from neoplanner_tpu_torch.utils.profiling import stage

_SQRT2 = math.sqrt(2.0)
# 8-connected motion model (astar_planner.py:105-116)
_MOVES = [(1, 0, 1.0), (0, 1, 1.0), (-1, 0, 1.0), (0, -1, 1.0),
          (-1, -1, _SQRT2), (-1, 1, _SQRT2), (1, -1, _SQRT2), (1, 1, _SQRT2)]
_EXPAND_M = 10.0  # map expansion radius (astar_planner.py:38)
INF = 1e9


# ---------------------------------------------------------------------------
# host planner (one env)
# ---------------------------------------------------------------------------

def astar(esdf_grid: np.ndarray, origin, resolution: float, start, goal,
          safe_dis: float = 0.5) -> List[List[float]]:
    """Host A* over one ESDF grid (H, W). Returns [[x, y], ...] world
    coordinates (cell corners) from start to goal, both included; an empty
    list when the goal is unreachable. The grid is virtually expanded by
    10 m (outside the expansion is invalid; outside the data, free, as the
    reference's ESDF lookup returns 10000 there, esdf.py:66); a cell
    collides where its distance is below safe_dis."""
    h, w = esdf_grid.shape
    pad = int(_EXPAND_M / resolution)
    ox = origin[0] - _EXPAND_M / 2
    oy = origin[1] - _EXPAND_M / 2
    W = w + pad
    H = h + pad

    def to_idx(p):
        return int((p[0] - ox) / resolution), int((p[1] - oy) / resolution)

    def to_world(ix, iy):
        return [ox + ix * resolution, oy + iy * resolution]

    def blocked(ix, iy):
        col = ix - pad // 2
        row = iy - pad // 2
        if row < 0 or row >= h or col < 0 or col >= w:
            return False
        return esdf_grid[row, col] < safe_dis

    sx, sy = to_idx(start)
    gx, gy = to_idx(goal)
    open_heap = [(0.0, 0.0, (sx, sy))]
    g_cost = {(sx, sy): 0.0}
    parent = {}
    found = False
    while open_heap:
        _, g, (cx, cy) = heapq.heappop(open_heap)
        if g > g_cost.get((cx, cy), np.inf):
            continue
        if (cx, cy) == (gx, gy):
            found = True
            break
        for dx, dy, cost in _MOVES:
            nx, ny = cx + dx, cy + dy
            if nx < 0 or nx >= W or ny < 0 or ny >= H or blocked(nx, ny):
                continue
            ng = g + cost
            if ng < g_cost.get((nx, ny), np.inf):
                g_cost[(nx, ny)] = ng
                parent[(nx, ny)] = (cx, cy)
                heapq.heappush(open_heap,
                               (ng + math.hypot(nx - gx, ny - gy), ng,
                                (nx, ny)))
    if not found:
        return []
    path = [to_world(gx, gy)]
    node = (gx, gy)
    while node in parent:
        node = parent[node]
        path.append(to_world(*node))
    return path[::-1]


def seg_feasible(esdf_grid, origin, resolution, head, tail,
                 clearance: float = 0.4) -> bool:
    """Whether the straight segment head -> tail keeps clearance, checked
    every 0.1 m (geo_planner.py:37-53); outside the grid is free."""
    steps = int(math.ceil(max(abs(tail[0] - head[0]),
                              abs(tail[1] - head[1])) / 0.1)) + 1
    h, w = esdf_grid.shape
    for i in range(steps):
        t = i / max(steps - 1, 1)
        x = head[0] + t * (tail[0] - head[0])
        y = head[1] + t * (tail[1] - head[1])
        col = int((x - origin[0]) / resolution)
        row = int((y - origin[1]) / resolution)
        d = esdf_grid[row, col] if 0 <= row < h and 0 <= col < w else 1e4
        if d < clearance:
            return False
    return True


def _final_keys(key_index: List[int]) -> List[int]:
    """The reference's choice of 4 key nodes from the recorded ones
    (geo_planner.py:78-99)."""
    n = len(key_index)
    if n == 2:
        return np.linspace(key_index[0], key_index[-1], 4).astype(int).tolist()
    if n == 3:
        if key_index[1] - key_index[0] > key_index[2] - key_index[1]:
            return [key_index[0], (key_index[0] + key_index[1]) // 2,
                    key_index[1], key_index[2]]
        return [key_index[0], key_index[1],
                (key_index[1] + key_index[2]) // 2, key_index[2]]
    if n == 4:
        return key_index
    anchor_l = key_index[-1] / 3
    anchor_r = 2 * key_index[-1] / 3
    left = min(key_index, key=lambda x: abs(x - anchor_l))
    right = min(key_index, key=lambda x: abs(x - anchor_r))
    return [key_index[0], left, right, key_index[-1]]


def prune_path(esdf_grid, origin, resolution, path: Sequence[Sequence[float]]
               ) -> List[Sequence[float]]:
    """The path reduced to 4 key nodes, start + 2 interior + end
    (geo_planner.py:55-101): a greedy feasible-segment walk records its
    break points, and _final_keys picks among them."""
    key_index = [0]
    head_i, tail_i = 0, 1
    while tail_i < len(path):
        while (seg_feasible(esdf_grid, origin, resolution, path[head_i],
                            path[tail_i]) or tail_i - head_i == 1):
            tail_i += 1
            if tail_i == len(path):
                break
        key_index.append(tail_i - 1)
        head_i = tail_i - 1
    return [path[i] for i in _final_keys(key_index)]


def geo_plan(emap: ESDFMap, head: torch.Tensor, tail: torch.Tensor,
             noise: torch.Tensor, pp: PlannerParams,
             solver: str = "fused") -> Trajectory:
    """Host A* and pruning per env, then the expert's warm-started refine
    of B envs (geo_traj_plan, geo_planner.py:19-35); head/tail (B, 3, 2),
    noise (B, retry_num, D, 2). An env without an A* path takes the expert
    plan (expert.plan), as the JAX package's geo_plan does. M = 3."""
    B = head.shape[0]
    origin = emap.origin.cpu().numpy()
    res = float(emap.resolution)
    seeds = expert.straight_line_wpts(head[:, 0], tail[:, 0], pp).clone()
    found = torch.zeros(B, dtype=torch.bool)
    for b in range(B):
        grid = emap.esdf[b].to(torch.float32).cpu().numpy()
        start = head[b, 0].cpu().numpy()
        goal = tail[b, 0].cpu().numpy()
        path = astar(grid, origin, res, start, goal, safe_dis=pp.safe_dis)
        if len(path) >= 2:
            pruned = prune_path(grid, origin, res, path)
            seeds[b] = torch.as_tensor(
                np.array(pruned[1:1 + pp.num_wpts], np.float32).T,
                device=head.device)
            found[b] = True
    ts0 = expert.init_ts(pp, head.device).expand(B, -1)
    traj = expert.warm_start_plan(emap, head, tail, seeds, ts0, noise, pp,
                                  solver=solver)
    lost = torch.nonzero(~found).flatten().to(head.device)
    if len(lost):
        cold = expert.plan(emap.index(lost), head[lost], tail[lost],
                           noise[lost], pp, solver=solver)
        for f in ("int_wpts", "ts", "coeffs", "costs", "ok", "iters"):
            getattr(traj, f)[lost] = getattr(cold, f)
    return traj


# ---------------------------------------------------------------------------
# device planner (B envs)
# ---------------------------------------------------------------------------

def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded as f32 division, as the JAX package divides (PyTorch
    on CUDA would multiply by a rounded reciprocal of a host scalar)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of f32 tensors rounded once to f32, as the JAX package's
    XLA program contracts it on the CPU: the product of two f32 values is
    exact in f64, and so is its sum here (operands within a few binades
    of each other)."""
    return (a.double() * b.double() + c.double()).float()


def _cell(emap: ESDFMap, p: torch.Tensor):
    """(row, col) int64 cells of points p (B, 2), truncated toward zero
    and clamped into the grid."""
    H, W = emap.esdf.shape[-2:]
    col = _div(p[:, 0] - emap.origin[0], emap.resolution).to(torch.int32)
    row = _div(p[:, 1] - emap.origin[1], emap.resolution).to(torch.int32)
    return row.clamp(0, H - 1).long(), col.clamp(0, W - 1).long()


def wavefront_field(emap: ESDFMap, goal: torch.Tensor, safe_dis: float,
                    num_iters: int) -> torch.Tensor:
    """Cost-to-go (in cells) to each env's goal (B, 2) by num_iters
    8-neighbour min-plus relaxations of (B, H, W): exact once num_iters
    reaches the longest shortest path. Blocked cells (distance below
    safe_dis) and cells out of reach hold INF. min(a, b) + c equals
    min(a + c, b + c) in f32 (rounding is monotonic), so each sweep takes
    the axis and the diagonal neighbours' minima first."""
    B, H, W = emap.esdf.shape
    blocked = emap.esdf < safe_dis
    row, col = _cell(emap, goal)
    d = torch.full((B, H, W), INF, device=emap.esdf.device)
    d[torch.arange(B, device=d.device), row, col] = 0.0
    d = torch.where(blocked, INF, d)
    inf = torch.full((), INF, device=d.device)
    for _ in range(num_iters):
        p = F.pad(d, (1, 1, 1, 1), value=INF)
        axis = torch.minimum(torch.minimum(p[:, :-2, 1:-1], p[:, 2:, 1:-1]),
                             torch.minimum(p[:, 1:-1, :-2], p[:, 1:-1, 2:]))
        diag = torch.minimum(torch.minimum(p[:, :-2, :-2], p[:, :-2, 2:]),
                             torch.minimum(p[:, 2:, :-2], p[:, 2:, 2:]))
        best = torch.minimum(d, torch.minimum(axis + 1.0, diag + _SQRT2))
        d = torch.where(blocked, inf, best)
    return d


# descent moves, in the JAX package's order (argmin takes the first tie)
_NEIGH = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (1, -1), (-1, 1),
          (-1, -1))


def descend_path(emap: ESDFMap, field: torch.Tensor, start: torch.Tensor,
                 num_steps: int) -> torch.Tensor:
    """Greedy 8-neighbour descent of each env's field from start (B, 2):
    (B, num_steps, 2) world points at cell centres; a path holds its
    position once it reaches the field's minimum."""
    B, H, W = field.shape
    dev = field.device
    r, c = _cell(emap, start)
    neigh = torch.tensor(_NEIGH, device=dev)
    flat = field.reshape(B, -1)
    res = torch.full((), emap.resolution, device=dev)
    cells = []
    for _ in range(num_steps):
        rr = (r[:, None] + neigh[:, 0]).clamp(0, H - 1)
        cc = (c[:, None] + neigh[:, 1]).clamp(0, W - 1)
        k = torch.argmin(torch.gather(flat, 1, rr * W + cc), dim=1,
                         keepdim=True)
        r, c = rr.gather(1, k)[:, 0], cc.gather(1, k)[:, 0]
        cells.append(torch.stack([c, r], -1))
    # origin + (cell + 0.5) * resolution, contracted as the JAX package's
    return _fma(torch.stack(cells, 1).float() + 0.5, res, emap.origin)


_PRUNE_CLEARANCE = 0.4   # geo_planner.py:41 OBS_CLEARANCE
_MAX_KEYS = 8            # capacity of recorded key nodes
_FEAS_SAMPLES = 96       # fixed-count sampling of the 0.1 m feasibility walk
# jnp.linspace(0, 1, 96) as JAX computes it: i / 95 in f32, the last 1
_FRACS = np.append(np.arange(_FEAS_SAMPLES - 1, dtype=np.float32)
                   / np.float32(_FEAS_SAMPLES - 1), np.float32(1.0))


def _nearest(emap: ESDFMap, pts: torch.Tensor) -> torch.Tensor:
    """esdf.sample_nearest's distance (B, N) at pts (B, N, 2), its cells
    found by f32 division on every device: the looked-up distance (FAR off
    the grid) and, on a full map, its straight-through form (d0 - lin) +
    lin, which the JAX package's value carries."""
    H, W = emap.esdf.shape[-2:]
    col = torch.floor(_div(pts[..., 0] - emap.origin[0], emap.resolution))
    row = torch.floor(_div(pts[..., 1] - emap.origin[1], emap.resolution))
    inb = (row >= 0) & (row < H) & (col >= 0) & (col < W)
    flat = row.long().clamp(0, H - 1) * W + col.long().clamp(0, W - 1)
    d0 = torch.where(inb, esdf_map._gather(emap.esdf, flat).float(),
                     esdf_map.FAR)
    if emap.lite:
        return d0
    lin = (torch.where(inb, esdf_map._gather(emap.grad_x, flat), 0.0)
           * pts[..., 0]
           + torch.where(inb, esdf_map._gather(emap.grad_y, flat), 0.0)
           * pts[..., 1])
    return (d0 - lin) + lin


def _seg_feasible_device(emap: ESDFMap, a: torch.Tensor, b: torch.Tensor,
                         clearance: float) -> torch.Tensor:
    """Whether each env's segment a -> b (B, 2) keeps clearance at 96
    evenly spaced points, nearest-cell distances (geo_planner.py:37-53
    with a static sample count)."""
    fr = torch.from_numpy(_FRACS).to(a.device)
    pts = _fma(fr[None, :, None], (b - a)[:, None, :], a[:, None, :])
    return (_nearest(emap, pts) >= clearance).all(1)


def prune_path_device(emap: ESDFMap, pts: torch.Tensor, end: torch.Tensor):
    """The reference's pruning rule (geo_planner.py:55-101) as a masked
    walk over each env's descent path pts (B, N, 2), whose points past
    end (B,) repeat the held minimum and take no part. Returns (i1, i2),
    (B,) indices into pts of the 2 interior key waypoints."""
    B, N, _ = pts.shape
    dev = pts.device
    envs = torch.arange(B, device=dev)
    head = torch.zeros(B, dtype=torch.long, device=dev)
    keys = torch.zeros((B, _MAX_KEYS), dtype=torch.long, device=dev)
    nk = torch.zeros(B, dtype=torch.long, device=dev)
    for i in range(1, N):
        live = i <= end
        feas = _seg_feasible_device(emap, pts[envs, head], pts[:, i],
                                    _PRUNE_CLEARANCE) | (i - head == 1)
        record = ~feas & live
        store = record & (nk < _MAX_KEYS)
        slot = nk.clamp(max=_MAX_KEYS - 1)
        keys[envs, slot] = torch.where(store, i - 1, keys[envs, slot])
        nk = nk + store.long()
        head = torch.where(record, i - 1, head)
    # the full key list is [0, recorded..., end]: n = nk + 2 entries
    n = nk + 2
    end = end.long()
    endf = end.float()
    k1, k2 = keys[:, 0], keys[:, 1]
    i1_2 = torch.round(_div(endf, 3.0)).long()
    i2_2 = torch.round(_div(2.0 * endf, 3.0)).long()
    left_longer = k1 > end - k1
    i1_3 = torch.where(left_longer, k1 // 2, k1)
    i2_3 = torch.where(left_longer, k1, (k1 + end) // 2)
    cand = torch.cat([torch.zeros((B, 1), dtype=torch.long, device=dev),
                      keys, end[:, None]], 1)
    valid = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                       torch.arange(_MAX_KEYS, device=dev) < nk[:, None],
                       torch.ones((B, 1), dtype=torch.bool, device=dev)], 1)
    candf = cand.float()
    gap_l = torch.where(valid, (candf - _div(endf, 3.0)[:, None]).abs(),
                        float("inf"))
    gap_r = torch.where(valid, (candf - _div(2.0 * endf, 3.0)[:, None]).abs(),
                        float("inf"))
    i1_m = cand.gather(1, gap_l.argmin(1, keepdim=True))[:, 0]
    i2_m = cand.gather(1, gap_r.argmin(1, keepdim=True))[:, 0]
    i1 = torch.where(n == 2, i1_2, torch.where(
        n == 3, i1_3, torch.where(n == 4, k1, i1_m)))
    i2 = torch.where(n == 2, i2_2, torch.where(
        n == 3, i2_3, torch.where(n == 4, k2, i2_m)))
    return i1, i2


def path_end(pts: torch.Tensor) -> torch.Tensor:
    """(B,) index of each descent path's first point at its held minimum
    (the last point), 0 when the path starts there."""
    at_min = (pts == pts[:, -1:]).all(-1)
    return torch.argmax(at_min.to(torch.uint8), dim=1)


def front_end(emap: ESDFMap, head: torch.Tensor, tail: torch.Tensor,
              safe_dis: float, num_iters: int = 256, num_steps: int = 192):
    """The device front end of B envs: (field (B, H, W), descent points
    (B, num_steps, 2), end (B,), key indices i1, i2 (B,)), for boundary
    states head/tail (B, 3, 2)."""
    field = wavefront_field(emap, tail[:, 0], safe_dis, num_iters)
    pts = descend_path(emap, field, head[:, 0], num_steps)
    end = path_end(pts)
    i1, i2 = prune_path_device(emap, pts, end)
    return field, pts, end, i1, i2


def geo_plan_device(emap: ESDFMap, head: torch.Tensor, tail: torch.Tensor,
                    noise: torch.Tensor, pp: PlannerParams,
                    num_iters: int = 256, num_steps: int = 192,
                    solver: str = "fused", timer=None) -> Trajectory:
    """The batched geo plan of B envs: wavefront field -> greedy descent
    -> the reference's pruning -> the expert's warm-started refine with
    the two key points as waypoints (noise (B, retry_num, D, 2)). On a
    grid the refine solves on each env's window (kernel B6 with 'fused',
    B7 with 'per_eval'; acceptance through B5). A StageTimer records the
    front end as 'geo' and the refine as 'plan'."""
    if pp.num_pieces != 3:
        raise ValueError(f"the geo planner plans M=3 pieces (two key "
                         f"waypoints); got num_pieces={pp.num_pieces}")
    with stage(timer, "geo"):
        _, pts, _, i1, i2 = front_end(emap, head, tail, pp.safe_dis,
                                      num_iters, num_steps)
        envs = torch.arange(pts.shape[0], device=pts.device)
        q0 = torch.stack([pts[envs, i1], pts[envs, i2]], -1)
    with stage(timer, "plan"):
        ts0 = expert.init_ts(pp, head.device).expand(head.shape[0], -1)
        return expert.warm_start_plan(emap, head, tail, q0, ts0, noise, pp,
                                      solver=solver)
