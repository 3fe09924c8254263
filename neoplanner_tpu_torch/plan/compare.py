"""Instrumented planning harnesses: every lane of an expert plan, and the
network's trajectory against its refinement.

The port of neoplanner_tpu/plan/compare.py (the reference's shadow demo
instrumentation: expert_planner_demo.py:29-37 ``PlanAttempt`` records of
every multi-start attempt, all_planner_demo.py:10-83 ``PlanningResult``
comparing the NN-only trajectory with the NN + refinement one). Every
attempt is a lane of one batched solve, so the record is the bank itself.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from neoplanner_tpu_torch.config import PlannerParams
from neoplanner_tpu_torch.core.types import DroneState, Trajectory, _Replace
from neoplanner_tpu_torch.plan import costs, expert, nn_init


@dataclass
class PlanAttempts(_Replace):
    """Every multi-start lane of B plans (expert_planner_demo.PlanAttempt)."""

    seed_wpts: torch.Tensor  # (B, L, D, M-1) initial waypoints per lane
    int_wpts: torch.Tensor   # (B, L, D, M-1) solved waypoints
    ts: torch.Tensor         # (B, L, M)
    costs: torch.Tensor      # (B, L, 4) unweighted cost vectors
    total: torch.Tensor      # (B, L) weighted totals
    ok: torch.Tensor         # (B, L) accepted
    iters: torch.Tensor      # (B, L) L-BFGS iterations
    picked: torch.Tensor     # (B,) index of the selected lane


def plan_with_attempts(pmap, head: torch.Tensor, tail: torch.Tensor,
                       noise: torch.Tensor, pp: PlannerParams,
                       solver: str = "fused") -> PlanAttempts:
    """expert.plan returning the whole bank of B envs: all L = 3 +
    len(extra_lateral_scales) + retry_num lanes (noise (B, retry_num, D,
    M-1)) solved in one batch, none skipped, and the lane that the
    expert's priority picks (compare.py:55-61): the cheapest accepted
    primary lane, else the cheapest accepted lane, else the least
    colliding."""
    B = head.shape[0]
    seeds = expert.seed_bank(head[:, 0], tail[:, 0], noise, pp)
    ts0 = expert.init_ts(pp, head.device).expand(B, seeds.shape[1], -1)
    bank = expert._solve_lanes(pmap, head, tail, seeds, ts0, pp,
                               expert._plan_window(pmap, head, tail, pp),
                               solver)
    total = bank.costs @ costs.weights(pp, head.device).to(bank.costs.dtype)
    L = total.shape[1]
    primary = torch.arange(L, device=head.device) < pp.batch_num
    inf = torch.full_like(total, float("inf"))
    any_primary = (bank.ok & primary).any(1)
    picked = torch.where(
        any_primary, torch.where(bank.ok & primary, total, inf).argmin(1),
        torch.where(bank.ok.any(1), torch.where(bank.ok, total, inf)
                    .argmin(1), bank.costs[..., 3].argmin(1)))
    return PlanAttempts(seed_wpts=seeds, int_wpts=bank.int_wpts, ts=bank.ts,
                        costs=bank.costs, total=total, ok=bank.ok,
                        iters=bank.iters, picked=picked)


@dataclass
class NNComparison(_Replace):
    """all_planner_demo.PlanningResult: NN-only against NN + refinement,
    for B envs."""

    nn_wpts: torch.Tensor     # (B, D, M-1) network prediction (world frame)
    nn_ts: torch.Tensor       # (B, M)
    nn_costs: torch.Tensor    # (B, 4) cost vector of the raw prediction
    refined: Trajectory       # the NEO (refined) solution
    output_mse: torch.Tensor  # (B,) MSE between the NN output and the
    #                           refined solution in (q, T) space


def compare_nn_vs_refined(pmap, net, depth: torch.Tensor, drone: DroneState,
                          des_pos_z: float, plan_init_state: torch.Tensor,
                          target_state: torch.Tensor, noise: torch.Tensor,
                          pp: PlannerParams,
                          solver: str = "fused") -> NNComparison:
    """The raw network trajectory and its refinement side by side, B envs
    (compare.py:75-93): the prediction's costs on each env's map, the
    warm-started refine of it (expert.warm_start_plan), and their mean
    squared difference in waypoints plus that in durations."""
    head = expert.pad_boundary_state(plan_init_state, pp)
    tail = expert.pad_boundary_state(target_state, pp)
    nn_wpts, nn_ts = nn_init.predict(net, depth, drone, des_pos_z,
                                     plan_init_state, target_state, pp)
    with torch.no_grad():
        nn_costs, _ = costs.traj_costs(head, tail, nn_wpts, nn_ts, pmap, pp)
    refined = expert.warm_start_plan(pmap, head, tail, nn_wpts, nn_ts, noise,
                                     pp, solver=solver)
    mse = (((nn_wpts - refined.int_wpts) ** 2).mean((1, 2))
           + ((nn_ts - refined.ts) ** 2).mean(1))
    return NNComparison(nn_wpts=nn_wpts, nn_ts=nn_ts, nn_costs=nn_costs,
                        refined=refined, output_mse=mse)
