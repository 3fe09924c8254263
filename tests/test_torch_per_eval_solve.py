"""The per-evaluation solve (plan/solve.solve_per_eval) against the JAX
package's per-evaluation branch of plan/expert.solve_one, and the wide line
search of ops/lbfgs.minimize.

On the CPU, JAX's solve_one runs ops/lbfgs.minimize on plan/costs.objective
with autodiff (its XLA path; on a grid over the whole map with bilinear
sampling), and the port's solve_per_eval the same loop over the plain
versions of kernels B2s and B7 (plan/objective.py). Scene problems as
test_torch_costs_solver.py; grid problems on tests/test_expert.py's golden
map (a 16 x 12 m corridor with a box across the straight line), solved by
the port on a window that covers the whole map.

Tolerances as test_torch_costs_solver.py: one iteration 1e-4 (both take
the same step from the same gradient up to roundoff); max_iters iterations
the same cost basin, the JAX objective of both solutions within 5e-3
(tests/test_solve_pallas.py), since roundoff may move the iteration at
which a solve stops. The wide line search evaluates the same candidates as
the per-candidate loop, so its results are bit-equal.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import MapParams as JMapParams
from neoplanner_tpu.config import PlannerParams as JPlannerParams
from neoplanner_tpu.mapping import scene as jscene
from neoplanner_tpu.ops import minco as jminco
from neoplanner_tpu.plan import costs as jcosts
from neoplanner_tpu.plan import expert as jexpert
from neoplanner_tpu_torch.config import MapParams, PlannerParams
from neoplanner_tpu_torch.core.types import ESDFMap
from neoplanner_tpu_torch.mapping import esdf, scene
from neoplanner_tpu_torch.ops import lbfgs
from neoplanner_tpu_torch.plan import costs, solve
from tests.test_expert import make_world
from tests.test_torch_costs_solver import MAPP, _env, _problems, _t, _worlds
from tests.test_torch_imports import one_torch_thread  # noqa: F401

KW = dict(samples_per_piece=8, max_ls=4)
N = 6


def _scene_case(jpp):
    jw, tw = _worlds(2)
    x0, head, tail = _problems(jpp, N)
    env_of = np.arange(N) % 2
    jmaps = jax.vmap(lambda w: jscene.build(w, JMapParams(**MAPP)))(
        _env(jw, jnp.asarray(env_of)))
    return x0, head, tail, env_of, jmaps, scene.build(tw, MapParams(**MAPP))


def _grid_case(jpp):
    """Four problems across the golden map's box, every one on the same
    map; the port's window covers the whole map."""
    jmap = make_world()
    head = np.zeros((4, 3, 2), np.float32)
    tail = np.zeros((4, 3, 2), np.float32)
    head[:, 0] = [[0.0, 0.0], [1.0, 0.5], [0.0, -1.0], [2.0, 1.0]]
    head[:, 1] = [[0.5, 0.0], [0.3, 0.0], [0.5, 0.2], [0.0, 0.0]]
    tail[:, 0] = [[10.0, 0.0], [9.0, -0.5], [8.0, 1.0], [11.0, 0.0]]
    rng = np.random.default_rng(3)
    x0 = np.stack([np.asarray(jcosts.pack(
        jexpert.straight_line_wpts(jnp.asarray(head[i, 0]),
                                   jnp.asarray(tail[i, 0]), jpp),
        jminco.T_to_tau(jexpert.init_ts(jpp), jpp.t_min, jpp.t_max), jpp))
        for i in range(4)])
    x0 = (x0 + rng.normal(scale=0.2, size=x0.shape)).astype(np.float32)
    env_of = np.zeros(4, np.int64)
    jmaps = jax.tree_util.tree_map(lambda a: jnp.stack([a] * 4), jmap)
    tmap = ESDFMap(esdf=_t(jmap.esdf)[None], origin=_t(jmap.origin),
                   resolution=float(jmap.resolution))
    H, W = jmap.esdf.shape
    window = esdf.make_window(tmap, torch.tensor([[6.0, 0.0]]), max(H, W))
    assert window.win.shape == (1, H, W)
    return x0, head, tail, env_of, jmaps, window


CASES = {"scene": _scene_case, "grid": _grid_case}


def _solve_both(case, max_iters):
    pp = PlannerParams(**KW, max_iters=max_iters)
    jpp = JPlannerParams(**KW, max_iters=max_iters)
    x0, head, tail, env_of, jmaps, pmap = CASES[case](jpp)
    x, f, it = solve.solve_per_eval(_t(x0), _t(head), _t(tail), pmap,
                                    torch.from_numpy(env_of), pp)
    q0, tau0 = jax.vmap(lambda x: jcosts.unpack(x, jpp))(jnp.asarray(x0))
    want = jax.jit(jax.vmap(partial(jexpert.solve_one, pp=jpp)))(
        jmaps, jnp.asarray(head), jnp.asarray(tail), q0,
        jminco.tau_to_T(tau0, jpp.t_min, jpp.t_max))
    return (x, f, it), want, (head, tail, jmaps, pp, jpp)


def _jax_objective(jmaps, head, tail, q, ts, jpp):
    def one(m, h, t, qi, ti):
        x = jcosts.pack(qi, jminco.T_to_tau(ti, jpp.t_min, jpp.t_max), jpp)
        return jcosts.objective(x, h, t, m, jpp)
    return np.asarray(jax.vmap(one)(jmaps, jnp.asarray(head),
                                    jnp.asarray(tail), jnp.asarray(q),
                                    jnp.asarray(ts)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_iteration_matches_solve_one(case):
    (x, _, it), want, (_, _, _, pp, _) = _solve_both(case, 1)
    q, tau = costs.unpack(x, pp)
    np.testing.assert_allclose(q.numpy(), np.asarray(want.int_wpts),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        torch.sigmoid(tau).numpy() * (pp.t_max - pp.t_min) + pp.t_min,
        np.asarray(want.ts), rtol=1e-4, atol=1e-4)
    assert it.tolist() == np.asarray(want.iters).tolist()


@pytest.mark.parametrize("case", sorted(CASES))
def test_max_iters_in_the_cost_basin_of_solve_one(case):
    (x, f, it), want, (head, tail, jmaps, pp, jpp) = _solve_both(case, 12)
    q, tau = costs.unpack(x, pp)
    ts = pp.t_min + (pp.t_max - pp.t_min) * torch.sigmoid(tau)
    f_port = _jax_objective(jmaps, head, tail, q.numpy(), ts.numpy(), jpp)
    f_jax = _jax_objective(jmaps, head, tail, want.int_wpts, want.ts, jpp)
    np.testing.assert_allclose(f_port, f_jax, rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(f.numpy(), f_port, rtol=5e-3, atol=5e-3)
    assert int(it.min()) >= 1 and int(it.max()) <= pp.max_iters


def test_wide_line_search_is_bit_equal_to_the_candidate_loop():
    pp = PlannerParams(**KW, max_iters=12)
    x0, head, tail, env_of, _, sc = _scene_case(JPlannerParams(**KW))
    env_of = torch.from_numpy(env_of)
    L = pp.max_ls
    fun = partial(costs.objective, head_state=_t(head), tail_state=_t(tail),
                  pmap=sc.index(env_of), pp=pp)
    wide_map = sc.index(env_of.repeat_interleave(L))

    def ls_fun(cand):
        n = cand.shape[-1]
        return costs.objective(cand.reshape(-1, n),
                               _t(head).repeat_interleave(L, 0),
                               _t(tail).repeat_interleave(L, 0), wide_map,
                               pp).reshape(cand.shape[:2])

    kw = dict(max_iters=pp.max_iters, max_ls=L, ftol=solve.FTOL,
              gtol=solve.GTOL, c1=solve.C1,
              skip=torch.tensor([False, False, True, False, False, True]))
    loop = lbfgs.minimize(fun, _t(x0), **kw)
    wide = lbfgs.minimize(fun, _t(x0), ls_fun=ls_fun, **kw)
    for a, b in zip(loop, wide):
        assert torch.equal(a, b)
    assert int(loop.iters.max()) > 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_skipped_problems_return_their_seed(case):
    pp = PlannerParams(**KW, max_iters=6)
    x0, head, tail, env_of, _, pmap = CASES[case](JPlannerParams(**KW))
    n = x0.shape[0]
    skip = torch.arange(n) % 2 == 1
    args = (_t(x0), _t(head), _t(tail), pmap, torch.from_numpy(env_of), pp)
    base = solve.solve_per_eval(*args)
    lazy = solve.solve_per_eval(*args, skip=skip)
    np.testing.assert_array_equal(lazy[0][skip].numpy(), x0[skip.numpy()])
    assert lazy[2][skip].tolist() == [0] * int(skip.sum())
    np.testing.assert_array_equal(lazy[0][~skip].numpy(),
                                  base[0][~skip].numpy())
    assert lazy[2][~skip].tolist() == base[2][~skip].tolist()
    assert int(base[2][skip].min()) >= 1
