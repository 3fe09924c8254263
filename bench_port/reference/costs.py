"""Trajectory-optimization cost terms.

The port of neoplanner_tpu/plan/costs.py, both discretizations of the
penalty integrals: 'relative' (the optimization default, samples at
t = T·j/(K-1), trapezoid weights T/(K-1)) and 'absolute' (the reference's,
samples at t = j·Δt for j < floor(T/Δt), trapezoid endpoints, weight Δt;
the sample count carries no gradient):

  cost = w · [ energy ∫|jerk|²,  time ΣT,
               feasibility ∫max(|v|²-v_max², 0)³,
               collision  ∫max(safe_dis - SDF(p), 0)³ ]

Every function takes a leading problem axis N; the map holds one row per
problem: the analytic scene SDF (SceneMap), a grid ESDF (ESDFMap, lite or
full, sampled as pp.esdf_interp says) or the grid solver's windows
(GridWindow).
Gradients come from autograd through the banded solve's implicit adjoint
(ops/minco.solve_banded).
"""

from __future__ import annotations

import torch

from .config import PlannerParams
from .types import ESDFMap
from . import esdf as esdf_map
from . import scene as scene_map
from . import minco


def map_distance(pmap, pos: torch.Tensor, pp: PlannerParams) -> torch.Tensor:
    """Collision distance at points pos (N, ..., 2) of each problem's map
    (costs.py:39-48, plus the grid solver's windows)."""
    if isinstance(pmap, scene_map.SceneMap):
        return scene_map.sample(pmap, pos)[0]
    if isinstance(pmap, ESDFMap):
        return esdf_map.sample(pmap, pos, mode=pp.esdf_interp)
    if isinstance(pmap, esdf_map.GridWindow):
        return esdf_map.sample_window(pmap, pos)
    raise TypeError(f"not a map: {type(pmap).__name__}")


def _cubic_hinge(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0.0) ** 3


def piece_samples(ts: torch.Tensor, pp: PlannerParams):
    """Sample times and weights of each piece by pp.sampling: (t, w), each
    (N, M, K) (_piece_samples, costs.py:55-79). 'absolute' has K =
    pp.max_abs_samples slots, of which the first n = floor(T/Δt + 1e-4)
    are live (the 1e-4 keeps f32 truncation with the reference's f64
    int(T/Δt) when T lies on a sample boundary) and weighted Δt, halved at
    both ends; the others weigh 0."""
    if pp.sampling == "absolute":
        K = pp.max_abs_samples
        j = torch.arange(K, device=ts.device)
        t = (pp.delta_t * j.to(ts.dtype)).expand(ts.shape + (K,))
        n = torch.floor(ts.detach() / pp.delta_t + 1e-4).to(torch.int32)
        active = j < n[..., None]
        endpoint = (j == 0) | (j == n[..., None] - 1)
        omg = torch.where(endpoint, 0.5, 1.0).to(ts.dtype)
        return t, torch.where(active, omg * pp.delta_t, 0.0).to(ts.dtype)
    if pp.sampling != "relative":
        raise ValueError(f"unknown sampling mode: {pp.sampling}")
    K = pp.samples_per_piece
    frac = torch.arange(K, dtype=ts.dtype, device=ts.device) / (K - 1)
    omg = torch.ones(K, dtype=ts.dtype, device=ts.device)
    omg[0] = 0.5
    omg[-1] = 0.5
    t = ts[..., None] * frac
    w = omg * (ts[..., None] / (K - 1))
    return t, w


def sampled_costs(coeffs: torch.Tensor, ts: torch.Tensor, pmap,
                  pp: PlannerParams):
    """(feasibility, collision) penalty integrals, each (N,)."""
    N, M = ts.shape
    t, w = piece_samples(ts, pp)                     # (N, M, K)
    c = coeffs.reshape(N, M, 6, -1)
    pos = torch.einsum("nmkj,nmjd->nmkd", minco.beta(t, 0), c)
    vel = torch.einsum("nmkj,nmjd->nmkd", minco.beta(t, 1), c)
    violate_vel = (vel * vel).sum(-1) - pp.v_max ** 2
    feas = (w * _cubic_hinge(violate_vel)).sum((1, 2))
    dis = map_distance(pmap, pos[..., :2], pp)
    coll = (w * _cubic_hinge(pp.safe_dis - dis)).sum((1, 2))
    return feas, coll


def traj_costs(head_state, tail_state, int_wpts, ts, pmap, pp):
    """Unweighted costs (N, 4) [energy, time, feas, collision] and coeffs."""
    coeffs = minco.solve_coeffs(head_state, tail_state, int_wpts, ts)
    e = minco.energy(coeffs, ts)
    feas, coll = sampled_costs(coeffs, ts, pmap, pp)
    return torch.stack([e, ts.sum(1), feas, coll], dim=1), coeffs


def weights(pp: PlannerParams, device=None) -> torch.Tensor:
    return torch.tensor([pp.w_energy, pp.w_time, pp.w_feas, pp.w_collision],
                        device=device)


def pack(int_wpts: torch.Tensor, tau: torch.Tensor,
         pp: PlannerParams) -> torch.Tensor:
    """(N, D, M-1) waypoints, (N, M) tau -> (N, nv) decision vectors."""
    return torch.cat([int_wpts.reshape(-1, pp.dims * pp.num_wpts), tau], 1)


def unpack(x: torch.Tensor, pp: PlannerParams):
    nq = pp.dims * pp.num_wpts
    return x[:, :nq].reshape(-1, pp.dims, pp.num_wpts), x[:, nq:]


def objective(x, head_state, tail_state, pmap, pp: PlannerParams):
    """Weighted cost (N,) of packed decision vectors (expert_planner.py:539-558);
    durations live in tau space, T = T_min + (T_max-T_min)·σ(tau)."""
    q, tau = unpack(x, pp)
    ts = minco.tau_to_T(tau, pp.t_min, pp.t_max)
    costs, _ = traj_costs(head_state, tail_state, q, ts, pmap, pp)
    return costs @ weights(pp, x.device).to(costs.dtype)

