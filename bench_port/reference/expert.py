"""Expert minimum-jerk planner: the seed bank, batches of L-BFGS solves
with acceptance, and the three banks built from them: the multi-start
expert plan, its warm-started form with the carried solution, and the lazy
warm-start bank of NEO.

The port of neoplanner_tpu/plan/expert.py (``seed_bank`` :49,
``make_plan_window`` :101, ``solve_one`` :121, ``_select`` :216, ``plan``
:242, ``plan_with_carry`` :273, ``warm_start_plan`` :316,
``adaptive_num_pieces`` :359, ``plan_adaptive`` :373,
``pad_boundary_state`` :389), batched: a problem axis P with ``env_of``
naming each problem's env replaces the JAX package's nested vmaps over envs
and bank lanes. The retry noise is an argument (standard normals), so any
generator can supply it. Every bank is lazy: the lanes that the selection
can only read after a failure are solved with a skip flag per env.

On the analytic scene map the solve and the acceptance both use the scene
SDF. On a sensed grid (an ESDFMap) the solve runs on one
kernel_window_cells window per env, and acceptance re-evaluates the
solution on the FULL map with nearest-cell distances (solve_one
:165-191), so a window can never accept what the map rejects. ``solver``
chooses how a batch is solved: 'fused', the whole solve in one kernel (B1
on the scene, B6 on windows), or 'per_eval', the L-BFGS loop in PyTorch
with one objective kernel launch per evaluation (B2s, B7), the JAX
package's ``NEO_SOLVER=xla`` branch.

Absolute sampling (``pp.sampling='absolute'``) is a branch of its own, as
in the JAX package, which runs no kernel there (make_plan_window returns
None, expert.py:111; ls_fun stays None, :148): every solve is
ops/lbfgs.minimize over costs.objective with autograd gradients, ftol 1e-10
and gtol 1e-8, on each env's whole map (no window), on whatever device the
tensors are on, and acceptance reads the map as pp.esdf_interp says. Both
``solver`` values take that branch; a skipped lane keeps its seed with
iters 0, as the JAX package's "solve, then keep x0" (:196-200).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .config import PlannerParams
from .types import ESDFMap, Trajectory
from . import esdf as esdf_map
from . import lbfgs, minco
from . import costs, solve


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


def _plan_window(pmap, head, tail, pp: PlannerParams):
    """The bank's windows on a sensed grid under relative sampling, else
    None (the scene map; absolute sampling solves on the whole map)."""
    if not isinstance(pmap, ESDFMap) or pp.sampling == "absolute":
        return None
    return make_plan_window(pmap, head, tail, pp)


SOLVERS = ("fused", "per_eval")


def solve_one(pmap, head: torch.Tensor, tail: torch.Tensor,
              int_wpts0: torch.Tensor, ts0: torch.Tensor,
              env_of: torch.Tensor, pp: PlannerParams, skip=None,
              window=None, solver: str = "fused") -> Trajectory:
    """P L-BFGS solves from P initializations (plan_once,
    expert_planner.py:205-237), each accepted when its weighted collision
    cost is within collision_cost_tol. pmap is the scene map or, with its
    per-env ``window`` (make_plan_window), the sensed grid. A skipped
    problem returns its seed unsolved with iters 0. ``solver`` is 'fused'
    or 'per_eval' (see the module docstring)."""
    x0 = costs.pack(int_wpts0, minco.T_to_tau(ts0, pp.t_min, pp.t_max), pp)
    grid = isinstance(pmap, ESDFMap)
    cost_pp = pp
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; the port runs "
                         f"{SOLVERS}")
    rows = pmap.index(env_of)
    absolute = pp.sampling == "absolute"
    if absolute:
        res = lbfgs.minimize(
            lambda x: costs.objective(x, head, tail, rows, pp), x0,
            max_iters=pp.max_iters, history=pp.history, max_ls=pp.max_ls,
            ftol=1e-10, gtol=1e-8, skip=skip)
        x, iters = res.x, res.iters
    else:
        x, _, iters = solve.solve_plain(x0, head, tail,
                                        window if grid else pmap, env_of,
                                        pp, skip=skip)
    if grid and not absolute:
        cost_pp = dataclasses.replace(pp, esdf_interp="nearest")
    q, tau = costs.unpack(x, pp)
    ts = minco.tau_to_T(tau, pp.t_min, pp.t_max)
    with torch.no_grad():
        cvec, coeffs = costs.traj_costs(head, tail, q, ts, rows, cost_pp)
    ok = cvec[:, 3] * pp.w_collision <= pp.collision_cost_tol
    return Trajectory(int_wpts=q, ts=ts, coeffs=coeffs, costs=cvec, ok=ok,
                      iters=iters)


def _solve_lanes(pmap, head, tail, seeds, ts_bank, pp, window, solver,
                 skip=None) -> Trajectory:
    """solve_one on every lane of every env: seeds (B, S, D, M-1), ts_bank
    (B, S, M), skip (B,) bool per env; fields (B, S, ...)."""
    B, S = seeds.shape[:2]
    envs = torch.arange(B, device=head.device).repeat_interleave(S)
    traj = solve_one(
        pmap, head.repeat_interleave(S, 0), tail.repeat_interleave(S, 0),
        seeds.reshape((B * S,) + seeds.shape[2:]),
        ts_bank.reshape(B * S, -1), envs, pp,
        skip=None if skip is None else skip.repeat_interleave(S),
        window=window, solver=solver)
    return Trajectory(*(t.reshape((B, S) + t.shape[1:]) for t in
                        _fields(traj)))


def _fields(traj: Trajectory):
    return tuple(getattr(traj, f.name) for f in dataclasses.fields(traj))


def _lazy_bank(pmap, head, tail, seeds, ts_bank, n_first, skip_of, pp,
               window, solver) -> Trajectory:
    """The lazy bank: lanes [0, n_first) of every env first, then the
    others with skip = skip_of(first lanes) per env (two launches that
    share the grid's windows); fields (B, S, ...)."""
    first = _solve_lanes(pmap, head, tail, seeds[:, :n_first],
                         ts_bank[:, :n_first], pp, window, solver)
    rest = _solve_lanes(pmap, head, tail, seeds[:, n_first:],
                        ts_bank[:, n_first:], pp, window, solver,
                        skip=skip_of(first))
    return Trajectory(*(torch.cat([a, b], 1) for a, b in
                        zip(_fields(first), _fields(rest))))


def _pick(bank: Trajectory, idx: torch.Tensor) -> Trajectory:
    envs = torch.arange(idx.shape[0], device=idx.device)
    return Trajectory(*(t[envs, idx] for t in _fields(bank)))


def _select(bank: Trajectory, pp: PlannerParams) -> Trajectory:
    """Per env, the lane the reference's priority picks from a bank with
    fields (B, S, ...): the cheapest accepted of the first batch_num lanes
    (expert_planner.py:161-165), else the cheapest accepted retry
    (:166-168), else the least colliding, with ok = any lane accepted and
    the bank's iterations summed."""
    ok = bank.ok
    total = bank.costs @ costs.weights(pp, ok.device).to(bank.costs.dtype)
    primary = torch.arange(ok.shape[1], device=ok.device) < pp.batch_num
    inf = torch.full_like(total, float("inf"))
    score_primary = torch.where(ok & primary, total, inf)
    score_retry = torch.where(ok, total, inf)
    any_primary = (ok & primary).any(1)
    any_ok = ok.any(1)
    idx = torch.where(any_primary, torch.argmin(score_primary, 1),
                      torch.where(any_ok, torch.argmin(score_retry, 1),
                                  torch.argmin(bank.costs[..., 3], 1)))
    return _pick(bank, idx).replace(
        ok=any_ok, iters=bank.iters.sum(1, dtype=torch.int32))


def plan(pmap, head: torch.Tensor, tail: torch.Tensor, noise: torch.Tensor,
         pp: PlannerParams, solver: str = "fused") -> Trajectory:
    """The expert plan of B envs (MinJerkPlanner.plan -> batch_plan ->
    warm_start_plan, expert_planner.py:62-80, 142-168, 186-203) as one
    bank: the batch_num multi-start seeds first, then the wide laterals and
    the noisy retries (noise (B, retry_num, D, M-1)) only for envs whose
    primaries were all rejected; :func:`_select` picks."""
    B = head.shape[0]
    seeds = seed_bank(head[:, 0], tail[:, 0], noise, pp)     # (B, S, D, n)
    ts_bank = init_ts(pp, head.device).expand(B, seeds.shape[1], -1)
    window = _plan_window(pmap, head, tail, pp)
    if seeds.shape[1] > pp.batch_num:
        bank = _lazy_bank(pmap, head, tail, seeds, ts_bank, pp.batch_num,
                          lambda prim: prim.ok.any(1), pp, window, solver)
    else:
        bank = _solve_lanes(pmap, head, tail, seeds, ts_bank, pp, window,
                            solver)
    return _select(bank, pp)


def warm_start_plan(pmap, head: torch.Tensor, tail: torch.Tensor,
                    int_wpts0: torch.Tensor, ts0: torch.Tensor,
                    noise: torch.Tensor, pp: PlannerParams,
                    solver: str = "fused") -> Trajectory:
    """Warm-started plan of B envs (expert_planner.py:186-203) on the scene
    map or a sensed grid: the given initialization first, then the noisy
    straight-line retries, solved only for envs whose first lane was
    rejected. The first lane wins when it is accepted, else the cheapest
    accepted retry, else the least colliding."""
    B = head.shape[0]
    dev = head.device
    window = _plan_window(pmap, head, tail, pp)
    retries = seed_bank(head[:, 0], tail[:, 0], noise, pp)[:, pp.batch_num:]
    R = retries.shape[1]
    seeds = torch.cat([int_wpts0[:, None], retries], 1)
    ts_bank = torch.cat([ts0[:, None], init_ts(pp, dev).expand(B, R, -1)], 1)
    bank = _lazy_bank(pmap, head, tail, seeds, ts_bank, 1,
                      lambda first: first.ok[:, 0], pp, window, solver)
    ok, cvec = bank.ok, bank.costs                  # (B, 1+R), (B, 1+R, 4)
    total = cvec @ costs.weights(pp, dev).to(cvec.dtype)
    any_ok = ok.any(1)
    best_ok = torch.argmin(torch.where(ok, total, torch.full_like(
        total, float("inf"))), dim=1)
    least_coll = torch.argmin(cvec[..., 3], dim=1)
    idx = torch.where(ok[:, 0], torch.zeros_like(best_ok),
                      torch.where(any_ok, best_ok, least_coll))
    return _pick(bank, idx).replace(
        ok=any_ok, iters=bank.iters.sum(1, dtype=torch.int32))
