"""The port's 'adaptive' expert plan (plan/expert.adaptive_num_pieces and
plan_adaptive) on tests/test_expert.py's golden problem
(test_adaptive_piece_count): a 24 m goal across that test's 16 x 12 m map
with one occupied cell, M = 12 pieces, max_iters 96, two retries, no wide
laterals; the retry draws are JAX's (jax.random.normal of the golden's
PRNGKey(0)), passed to the port as standard normals. The port plans on a
160-cell window, which its window clamp makes the whole map, as the JAX
planner's CPU path plans on the map itself.

Tolerances: the golden's own for the plan (ok, int_wpts (2, 11), the end
point within 0.05 m of the goal); the port's costs re-evaluated by JAX's
traj_costs on the port's plan within 1e-4 relative (the same f32
formulas); the plan's weighted cost within 1e-3 relative of JAX's
plan_adaptive (the cost basin of a 96-iteration solve; 1.6e-5 measured).
JAX's plan takes 2-3 minutes on a CPU, as its golden does (marked slow
there), so that comparison is marked slow here too; the rest runs in
tier-1.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import PlannerParams as JPlannerParams
from neoplanner_tpu.mapping import esdf as jesdf
from neoplanner_tpu.plan import costs as jcosts
from neoplanner_tpu.plan import expert as jexpert
from neoplanner_tpu_torch.config import PlannerParams
from neoplanner_tpu_torch.mapping import esdf
from neoplanner_tpu_torch.ops import minco
from neoplanner_tpu_torch.plan import costs, expert
from tests.test_torch_imports import one_torch_thread  # noqa: F401

KW = dict(max_iters=96, retry_num=2, extra_lateral_scales=())
GOAL = 24.0


def test_adaptive_num_pieces():
    """The golden's three distances, and the same from other starts."""
    assert expert.adaptive_num_pieces([0.0, 0.0], [3.0, 0.0]) == 2
    assert expert.adaptive_num_pieces([0.0, 0.0], [10.0, 0.0]) == 5
    assert expert.adaptive_num_pieces([0.0, 0.0], [24.0, 0.0]) == 12
    assert expert.adaptive_num_pieces(torch.tensor([1.0, 2.0]),
                                      torch.tensor([1.0, 26.0])) == 12
    for d in (0.5, 3.9, 4.1, 7.0, 31.0):
        assert expert.adaptive_num_pieces([0.0, 0.0], [d, 0.0]) == \
            jexpert.adaptive_num_pieces([0.0, 0.0], [d, 0.0])


def _golden():
    occ = np.zeros((1, 120, 160), np.float32)
    occ[0, 60, 80] = 1.0
    emap = esdf.build(torch.from_numpy(occ), (-2.0, -6.0), 0.1)
    head = torch.zeros((1, 3, 2))
    head[0, 1, 0] = 0.5
    tail = torch.zeros((1, 3, 2))
    tail[0, 0, 0] = GOAL
    M = expert.adaptive_num_pieces(head[0, 0], tail[0, 0])
    noise = np.array(jax.random.normal(jax.random.PRNGKey(0),
                                         (KW["retry_num"], 2, M - 1)))
    return emap, head, tail, torch.from_numpy(noise)[None].float(), occ


@pytest.fixture(scope="module")
def planned():
    emap, head, tail, noise, occ = _golden()
    pp = PlannerParams(**KW, kernel_window_cells=160)
    return expert.plan_adaptive(emap, head, tail, noise, pp), occ


def test_plan_adaptive_golden(planned):
    traj, occ = planned
    assert traj.int_wpts.shape == (1, 2, 11)
    assert traj.ts.shape == (1, 12)
    assert bool(traj.ok[0])
    end = minco.eval_at(traj.coeffs, traj.ts, traj.ts.sum(1, keepdim=True),
                        0)[0, 0]
    np.testing.assert_allclose(end.numpy(), [GOAL, 0.0], atol=0.05)
    # the port's costs, re-evaluated by JAX on the JAX map
    jpp = dataclasses.replace(JPlannerParams(**KW), num_pieces=12,
                              esdf_interp="nearest")
    jmap = jesdf.build(jnp.asarray(occ[0]), jnp.array([-2.0, -6.0]), 0.1)
    with jax.disable_jit():
        jc, _ = jcosts.traj_costs(
            jnp.zeros((3, 2)).at[1, 0].set(0.5),
            jnp.zeros((3, 2)).at[0, 0].set(GOAL),
            jnp.asarray(traj.int_wpts[0].numpy()),
            jnp.asarray(traj.ts[0].numpy()), jmap, jpp)
    np.testing.assert_allclose(traj.costs[0].numpy(), np.asarray(jc),
                               rtol=1e-4, atol=1e-6)


def test_plan_adaptive_refuses_mixed_counts():
    emap, head, tail, noise, _ = _golden()
    head2 = head.expand(2, -1, -1).clone()
    tail2 = tail.expand(2, -1, -1).clone()
    tail2[1, 0, 0] = 10.0
    with pytest.raises(ValueError, match="piece counts differ"):
        expert.plan_adaptive(emap, head2, tail2, noise.expand(2, -1, -1, -1),
                             PlannerParams(**KW))
    with pytest.raises(ValueError, match="M=12 pieces"):
        expert.plan_adaptive(emap, head, tail, noise[..., :4],
                             PlannerParams(**KW))


@pytest.mark.slow
def test_plan_adaptive_cost_matches_jax(planned):
    """The weighted cost of the port's plan within 1e-3 relative of JAX
    plan_adaptive's on the golden problem (2-3 minutes of JAX on a CPU)."""
    traj, occ = planned
    jpp = JPlannerParams(**KW)
    jmap = jesdf.build(jnp.asarray(occ[0]), jnp.array([-2.0, -6.0]), 0.1)
    jt = jexpert.plan_adaptive(jmap, jnp.zeros((3, 2)).at[1, 0].set(0.5),
                               jnp.zeros((3, 2)).at[0, 0].set(GOAL),
                               jax.random.PRNGKey(0), jpp)
    assert bool(jt.ok)
    w = np.asarray(jcosts.weights(jpp))
    np.testing.assert_allclose(float(traj.costs[0].numpy() @ w),
                               float(np.asarray(jt.costs) @ w), rtol=1e-3)
