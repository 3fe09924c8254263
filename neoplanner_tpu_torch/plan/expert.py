"""Expert minimum-jerk planner pieces used by NEO: the seed bank, one batch
of L-BFGS solves with acceptance, and the lazy warm-start bank.

The port of neoplanner_tpu/plan/expert.py (``seed_bank`` :49,
``make_plan_window`` :101, ``solve_one`` :121, ``warm_start_plan`` :316,
``pad_boundary_state`` :389), batched: a problem axis P with ``env_of``
naming each problem's env replaces the JAX package's nested vmaps over envs
and bank lanes. The retry noise is an argument (standard normals), so any
generator can supply it.

On the analytic scene map the solve and the acceptance both use the scene
SDF. On a sensed grid (an ESDFMap) the solve runs on one
kernel_window_cells window per env (kernel B6), and acceptance re-evaluates
the solution on the FULL map with nearest-cell distances (solve_one
:165-191), so a window can never accept what the map rejects.
"""

from __future__ import annotations

import torch

import dataclasses

from neoplanner_tpu_torch.config import PlannerParams
from neoplanner_tpu_torch.core.types import ESDFMap, Trajectory
from neoplanner_tpu_torch.mapping import esdf as esdf_map
from neoplanner_tpu_torch.ops import minco
from neoplanner_tpu_torch.plan import costs, solve


def init_ts(pp: PlannerParams, device=None) -> torch.Tensor:
    """init_T per piece, first/last scaled 1.5x (expert_planner.py:97-99)."""
    ts = torch.full((pp.num_pieces,), pp.init_t, device=device)
    ts[0] *= 1.5
    ts[-1] *= 1.5
    return ts


def straight_line_wpts(start_pos: torch.Tensor, target_pos: torch.Tensor,
                       pp: PlannerParams) -> torch.Tensor:
    """(B, D, M-1) evenly spaced interior waypoints (expert_planner.py:91-92)."""
    n = pp.num_wpts
    fracs = (torch.arange(1, n + 1, device=start_pos.device) / (n + 1))
    wpts = start_pos[:, None, :] + fracs[None, :, None] \
        * (target_pos - start_pos)[:, None, :]
    return wpts.transpose(1, 2)


def seed_bank(start_pos, target_pos, noise: torch.Tensor,
              pp: PlannerParams) -> torch.Tensor:
    """All multi-start and retry seeds, (B, S, D, M-1): [straight,
    +lateral, -lateral, wide laterals, straight + retry_noise_std * noise
    for each of the retry_num draws noise (B, retry_num, D, M-1)]."""
    straight = straight_line_wpts(start_pos, target_pos, pp)
    diff = target_pos - start_pos
    longi = diff / (torch.linalg.vector_norm(diff, dim=-1, keepdim=True)
                    + 1e-9)
    lat = torch.stack([longi[:, 1], -longi[:, 0]], dim=-1)[..., None]
    seeds = [straight]
    sign = 1.0
    for _ in range(pp.batch_num - 1):
        seeds.append(straight + sign * pp.lateral_move_dis * lat)
        sign = -sign
    for scale in pp.extra_lateral_scales:
        seeds.append(straight + scale * pp.lateral_move_dis * lat)
    scaled = pp.retry_noise_std * noise
    for r in range(pp.retry_num):
        seeds.append(straight + scaled[:, r])
    return torch.stack(seeds, dim=1)


def pad_boundary_state(state_2rows: torch.Tensor,
                       pp: PlannerParams) -> torch.Tensor:
    """(B, 2, >=D) [pos; vel] -> (B, s, D) boundary states with zero acc."""
    out = state_2rows.new_zeros((state_2rows.shape[0], pp.s, pp.dims))
    out[:, :2] = state_2rows[:, :, :pp.dims]
    return out


def make_plan_window(emap: ESDFMap, head: torch.Tensor, tail: torch.Tensor,
                     pp: PlannerParams) -> esdf_map.GridWindow:
    """One kernel_window_cells window per env, centered between the plan's
    start and target (B, 3, 2): the receding-horizon target lies at most
    ~longitu_step_dis + escape away, so it covers every lane of the bank."""
    center = (head[:, 0] + tail[:, 0]) / 2
    return esdf_map.make_window(emap, center, pp.kernel_window_cells)


def solve_one(pmap, head: torch.Tensor, tail: torch.Tensor,
              int_wpts0: torch.Tensor, ts0: torch.Tensor,
              env_of: torch.Tensor, pp: PlannerParams, skip=None,
              window=None) -> Trajectory:
    """P L-BFGS solves from P initializations (plan_once,
    expert_planner.py:205-237), each accepted when its weighted collision
    cost is within collision_cost_tol. pmap is the scene map or, with its
    per-env ``window`` (make_plan_window), the sensed grid. A skipped
    problem returns its seed unsolved with iters 0."""
    x0 = costs.pack(int_wpts0, minco.T_to_tau(ts0, pp.t_min, pp.t_max), pp)
    cost_pp = pp
    if isinstance(pmap, ESDFMap):
        x, _, iters = solve.solve_grid(x0, head, tail, window, env_of, pp,
                                       skip=skip)
        cost_pp = dataclasses.replace(pp, esdf_interp="nearest")
    else:
        x, _, iters = solve.solve_scene(x0, head, tail, pmap, env_of, pp,
                                        skip=skip)
    q, tau = costs.unpack(x, pp)
    ts = minco.tau_to_T(tau, pp.t_min, pp.t_max)
    with torch.no_grad():
        cvec, coeffs = costs.traj_costs(head, tail, q, ts,
                                        pmap.index(env_of), cost_pp)
    ok = cvec[:, 3] * pp.w_collision <= pp.collision_cost_tol
    return Trajectory(int_wpts=q, ts=ts, coeffs=coeffs, costs=cvec, ok=ok,
                      iters=iters)


def warm_start_plan(pmap, head: torch.Tensor, tail: torch.Tensor,
                    int_wpts0: torch.Tensor, ts0: torch.Tensor,
                    noise: torch.Tensor, pp: PlannerParams) -> Trajectory:
    """Warm-started plan of B envs (expert_planner.py:186-203) on the scene
    map or a sensed grid: the given initialization first, then the noisy
    straight-line retries — solved only for envs whose first lane was
    rejected (the lazy bank: two launches, the retries with a skip mask;
    both share the grid's windows). The first lane wins when it is
    accepted, else the cheapest accepted retry, else the least colliding."""
    B = head.shape[0]
    dev = head.device
    envs = torch.arange(B, device=dev)
    window = (make_plan_window(pmap, head, tail, pp)
              if isinstance(pmap, ESDFMap) else None)
    retries = seed_bank(head[:, 0], tail[:, 0], noise, pp)[:, pp.batch_num:]
    R = retries.shape[1]
    first = solve_one(pmap, head, tail, int_wpts0, ts0, envs, pp,
                      window=window)
    rest = solve_one(
        pmap, head.repeat_interleave(R, 0), tail.repeat_interleave(R, 0),
        retries.reshape((B * R,) + retries.shape[2:]),
        init_ts(pp, dev).expand(B * R, -1), envs.repeat_interleave(R), pp,
        skip=first.ok.repeat_interleave(R), window=window)

    def bank(a, b):
        return torch.cat([a[:, None], b.reshape((B, R) + b.shape[1:])], 1)

    ok = bank(first.ok, rest.ok)                                # (B, 1+R)
    cvec = bank(first.costs, rest.costs)                        # (B, 1+R, 4)
    total = cvec @ costs.weights(pp, dev).to(cvec.dtype)
    any_ok = ok.any(1)
    best_ok = torch.argmin(torch.where(ok, total, torch.full_like(
        total, float("inf"))), dim=1)
    least_coll = torch.argmin(cvec[..., 3], dim=1)
    idx = torch.where(ok[:, 0], torch.zeros_like(best_ok),
                      torch.where(any_ok, best_ok, least_coll))

    def pick(a, b):
        return bank(a, b)[envs, idx]

    return Trajectory(
        int_wpts=pick(first.int_wpts, rest.int_wpts),
        ts=pick(first.ts, rest.ts), coeffs=pick(first.coeffs, rest.coeffs),
        costs=cvec[envs, idx], ok=any_ok,
        iters=bank(first.iters, rest.iters).sum(1, dtype=torch.int32))
