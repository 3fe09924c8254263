"""The grid planner on the slice's 96-cell solver windows against the JAX
window kernels: the port's costs.objective on a GridWindow (kernel B6's
plain objective) against costs_pallas_grid.objective_valgrad_grid, and one
plain solve.solve_grid iteration against solve_pallas_grid.solve_grid, both
JAX kernels in interpret mode, each called once for all problems.

Maps as test_torch_grid_solver.py (scenegen worlds rasterized by the JAX
voxelizer, lite ESDFs truncated at 2 m, bit-identical on both sides). Four
problems, each on its own 96 x 96 window: two inside the window among the
obstacles, one whose tail lies beyond the window's edge inside the map (its
samples there read the window's clamped edge), and one whose tail lies
beyond the map (its samples there read FAR). So the clip of the taps to
[0, Hw - 1.001], the zero derivative where the clip bites and FAR outside
the map are all exercised.

Tolerances are the golden tests' (tests/test_costs_pallas_grid.py, values
5e-4 and gradients scaled by max(|g|, 1) 2e-3; tests/test_solve_pallas_grid
.py, one iteration 1e-4).
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import MapParams as JMapParams
from neoplanner_tpu.config import PlannerParams as JPlannerParams
from neoplanner_tpu.config import WorldParams as JWorldParams
from neoplanner_tpu.mapping import esdf as jesdf
from neoplanner_tpu.ops import minco as jminco
from neoplanner_tpu.plan import costs as jcosts
from neoplanner_tpu.plan import costs_pallas_grid as jcpg
from neoplanner_tpu.plan import expert as jexpert
from neoplanner_tpu.plan import solve_pallas_grid as jspg
from neoplanner_tpu.world import scenegen as jscenegen
from neoplanner_tpu.world import voxelize as jvoxelize
from neoplanner_tpu_torch.config import PlannerParams
from neoplanner_tpu_torch.core.types import ESDFMap
from neoplanner_tpu_torch.mapping import esdf
from neoplanner_tpu_torch.ops import minco
from neoplanner_tpu_torch.ops.lbfgs import value_and_grad
from neoplanner_tpu_torch.plan import costs, solve
from tests.test_torch_imports import one_torch_thread  # noqa: F401

MAPP = dict(width=256, height=192, origin_x=-4.0, origin_y=-9.6)
ORIGIN = (MAPP["origin_x"], MAPP["origin_y"])
KW = dict(samples_per_piece=8, max_iters=1, max_ls=4)
CELLS = 96


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def problems():
    """Per problem: its env's JAX lite map, its window on both sides, and
    the decision vector and boundary states."""
    w = jscenegen.generate_batch(jax.random.PRNGKey(7), 2,
                                 JWorldParams(num_boxes=10))
    occ = jax.vmap(lambda x: jvoxelize.occupancy_2d(
        x, JMapParams(**MAPP)))(w)
    jmaps = jax.vmap(lambda o: jesdf.build(
        o, jnp.array(ORIGIN), 0.1, max_dist=2.0, lite=True))(occ)
    env_of = np.array([0, 1, 0, 1])
    head = np.zeros((4, 3, 2), np.float32)
    tail = np.zeros((4, 3, 2), np.float32)
    head[:, 0] = [[3.0, 0.0], [4.0, -1.0], [2.0, 0.5], [6.0, 6.0]]
    head[:, 1] = [[0.5, 0.0], [0.3, 0.2], [0.6, 0.0], [0.2, 0.5]]
    tail[:, 0] = [[8.0, 0.5], [8.5, 1.0], [12.0, 1.0], [9.0, 12.0]]
    centers = np.float32([[5.5, 0.25], [6.2, 0.0], [4.0, 0.5], [7.0, 7.0]])
    jpp = JPlannerParams(**KW)
    rng = np.random.default_rng(11)
    x0 = np.stack([np.asarray(jcosts.pack(
        jexpert.straight_line_wpts(jnp.asarray(head[i, 0]),
                                   jnp.asarray(tail[i, 0]), jpp),
        jminco.T_to_tau(jexpert.init_ts(jpp), jpp.t_min, jpp.t_max), jpp))
        for i in range(4)])
    x0 = (x0 + rng.normal(scale=0.2, size=x0.shape)).astype(np.float32)
    wins, worgs = [], []
    for i in range(4):
        em = jax.tree_util.tree_map(lambda a: a[env_of[i]], jmaps)
        jw, jo = jesdf.make_window(em, jnp.asarray(centers[i]), CELLS)
        wins.append(np.asarray(jw))
        worgs.append(np.asarray(jo))
    field = _t(jmaps.esdf.astype(jnp.float32)).to(torch.bfloat16)
    tmap = ESDFMap(esdf=field[env_of], origin=torch.tensor(ORIGIN),
                   resolution=0.1)
    window = esdf.make_window(tmap, _t(centers), CELLS)
    np.testing.assert_array_equal(window.win.numpy(), np.stack(wins))
    np.testing.assert_allclose(window.worg.numpy(), np.stack(worgs),
                               rtol=1e-6, atol=1e-6)
    return dict(x0=x0, head=head, tail=tail, window=window,
                wins=np.stack(wins), worgs=np.stack(worgs))


def test_problems_cross_the_window_edge_and_leave_the_map(problems):
    """The geometry the module docstring promises."""
    o = problems["worgs"]
    tail = problems["tail"][:, 0]
    lo, hi = o[:, :2], o[:, :2] + CELLS * o[:, 2:3]
    inside_win = ((tail >= lo) & (tail < hi)).all(1)
    inside_map = ((tail >= o[:, 3:5]) & (tail < o[:, 5:7])).all(1)
    assert inside_win[:2].all()
    assert not inside_win[2] and inside_map[2]
    assert not inside_map[3]


def test_window_objective_matches_valgrad_kernel(problems):
    p = problems
    pp = PlannerParams(**KW)
    fun = partial(costs.objective, head_state=_t(p["head"]),
                  tail_state=_t(p["tail"]), pmap=p["window"], pp=pp)
    f, g = value_and_grad(fun, _t(p["x0"]))
    jpp = JPlannerParams(**KW)
    jf, jg = jax.vmap(lambda x, h, t, w, o: jcpg.objective_valgrad_grid(
        x, h, t, w, o, jpp, interpret=True))(
        jnp.asarray(p["x0"]), jnp.asarray(p["head"]), jnp.asarray(p["tail"]),
        jnp.asarray(p["wins"]), jnp.asarray(p["worgs"]))
    jf, jg = np.asarray(jf), np.asarray(jg)
    np.testing.assert_allclose(f.numpy(), jf, rtol=5e-4, atol=5e-4)
    scale = np.maximum(np.abs(jg), 1.0)
    np.testing.assert_allclose(g.numpy() / scale, jg / scale, atol=2e-3)
    q, tau = costs.unpack(_t(p["x0"]), pp)
    cv, _ = costs.traj_costs(_t(p["head"]), _t(p["tail"]), q, minco.tau_to_T(
        tau, pp.t_min, pp.t_max), p["window"], pp)
    assert float(cv[:, 3].max()) > 0.0     # a collision hinge is live


def test_window_solve_one_iteration_matches_kernel(problems):
    p = problems
    pp = PlannerParams(**KW)
    x, f, it = solve.solve_grid(_t(p["x0"]), _t(p["head"]), _t(p["tail"]),
                                p["window"], torch.arange(4), pp)
    jpp = JPlannerParams(**KW)
    jx, jf, jit_ = jax.vmap(lambda x, h, t, w, o: jspg.solve_grid(
        x, h, t, w, o, jpp, interpret=True))(
        jnp.asarray(p["x0"]), jnp.asarray(p["head"]), jnp.asarray(p["tail"]),
        jnp.asarray(p["wins"]), jnp.asarray(p["worgs"]))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-4,
                               atol=1e-4)
    assert it.tolist() == np.asarray(jit_).tolist()
    assert float(np.abs(np.asarray(jx) - p["x0"]).max()) > 1e-3
