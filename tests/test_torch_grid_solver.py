"""The grid planner of the PyTorch port (mapping/esdf.py windows and
samplers, plan/costs over an ESDF, plan/solve.solve_grid: kernel B6's plain
version) against the JAX package.

Maps: scenegen worlds rasterized by the JAX voxelizer and built as the
vision loop's lite maps (truncated at 2 m, bf16) on both sides; the two
fields are bit-identical (test_torch_edt.py). The JAX solver reference is
ops/lbfgs.minimize on costs.objective over the FULL ESDFMap with bilinear
sampling, the XLA form its own tests hold the grid kernels against. The
port's solve runs on per-env windows; with kernel_window_cells >= the map
(256 x 192) the window is the whole map and the two semantics coincide.
The window sampler at the slice's 96 cells is checked on its own.

Tolerances: windows and samples 1e-5 (the same f32 formulas; the windows
themselves are copies, exact); objective values 1e-5 relative and
gradients 1e-4 of their scale (autograd on both sides, reassociated); one
L-BFGS iteration 1e-4 (both take the same step from the same gradient);
max_iters iterations the same cost basin, 5e-3 (roundoff moves where a
solve stops), as test_torch_costs_solver.py.
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
from neoplanner_tpu.core.types import ESDFMap as JESDFMap
from neoplanner_tpu.mapping import esdf as jesdf
from neoplanner_tpu.ops import lbfgs as jlbfgs
from neoplanner_tpu.ops import minco as jminco
from neoplanner_tpu.plan import costs as jcosts
from neoplanner_tpu.plan import expert as jexpert
from neoplanner_tpu.world import scenegen as jscenegen
from neoplanner_tpu.world import voxelize as jvoxelize
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import PlannerParams
from neoplanner_tpu_torch.mapping import esdf, query
from neoplanner_tpu_torch.ops.lbfgs import value_and_grad
from neoplanner_tpu_torch.plan import costs, expert, solve
from tests.test_torch_imports import one_torch_thread  # noqa: F401

MAPP = dict(width=256, height=192, origin_x=-4.0, origin_y=-9.6)
ORIGIN = (MAPP["origin_x"], MAPP["origin_y"])
RES = 0.1
E = 2


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def maps():
    """E lite maps: (JAX ESDFMaps stacked, the port's ESDFMap)."""
    w = jscenegen.generate_batch(jax.random.PRNGKey(7), E,
                                 JWorldParams(num_boxes=10))
    occ = jax.vmap(lambda x: jvoxelize.occupancy_2d(
        x, JMapParams(**MAPP)))(w)
    jmaps = jax.vmap(lambda o: jesdf.build(
        o, jnp.array(ORIGIN), RES, max_dist=2.0, lite=True))(occ)
    tmap = esdf.build(_t(occ), ORIGIN, RES, 2.0)
    np.testing.assert_array_equal(tmap.esdf.float().numpy(),
                                  np.asarray(jmaps.esdf.astype(jnp.float32)))
    return jmaps, tmap


def _env(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def _problems(pp, n, seed=1):
    """n problems crossing the obstacle field: (x0, head, tail, env_of)."""
    rng = np.random.default_rng(seed)
    head = np.zeros((n, 3, 2), np.float32)
    tail = np.zeros((n, 3, 2), np.float32)
    head[:, 0] = rng.normal(size=(n, 2)) * [1.0, 0.5] + [3.0, 0.0]
    head[:, 1] = rng.normal(scale=0.3, size=(n, 2))
    tail[:, 0] = head[:, 0] + [5.0, 0.0] + rng.normal(size=(n, 2))
    x0 = np.stack([np.asarray(jcosts.pack(
        jexpert.straight_line_wpts(jnp.asarray(head[i, 0]),
                                   jnp.asarray(tail[i, 0]), pp),
        jminco.T_to_tau(jexpert.init_ts(pp), pp.t_min, pp.t_max), pp))
        for i in range(n)])
    x0 = x0 + rng.normal(scale=0.2, size=x0.shape)
    return x0.astype(np.float32), head, tail, np.arange(n) % E


def test_make_window_matches(maps):
    jmaps, tmap = maps
    centers = np.float32([[3.0, 0.5], [-3.9, 9.0]])   # interior, corner
    win = esdf.make_window(tmap, _t(centers), 96)
    for e in range(E):
        jw, jo = jesdf.make_window(_env(jmaps, e), jnp.asarray(centers[e]),
                                   96)
        np.testing.assert_array_equal(win.win[e].numpy(), np.asarray(jw))
        np.testing.assert_allclose(win.worg[e].numpy(), np.asarray(jo),
                                   rtol=1e-6, atol=1e-6)


def test_window_sampler_matches_bilinear_and_far(maps):
    """sample_window at 96 cells: inside the window it is
    esdf.sample_bilinear on the window as a map; outside the map it reads
    FAR; inside the map but outside the window it reads the clamped edge."""
    jmaps, tmap = maps
    rng = np.random.default_rng(2)
    centers = np.float32([[3.0, 0.5], [10.0, -2.0]])
    win = esdf.make_window(tmap, _t(centers), 96)
    inside = centers[:, None] + rng.uniform(-4.7, 4.7, (E, 300, 2))
    got = esdf.sample_window(win, _t(inside.astype(np.float32)))
    for e in range(E):
        jw, jo = jesdf.make_window(_env(jmaps, e), jnp.asarray(centers[e]),
                                   96)
        wmap = JESDFMap(occupancy=jnp.zeros((1, 1)), esdf=jw,
                        grad_x=jnp.zeros((1, 1)), grad_y=jnp.zeros((1, 1)),
                        origin=jo[:2], resolution=jo[2])
        want, _ = jesdf.sample_bilinear(wmap, jnp.asarray(
            inside[e].astype(np.float32)))
        np.testing.assert_allclose(got[e].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    out_map = np.float32([[[-4.5, 0.0], [26.0, 0.0], [3.0, 9.7]]] * E)
    far = esdf.sample_window(win, _t(out_map))
    assert bool((far == esdf.FAR).all())
    edge = esdf.sample_window(win, _t(np.float32([[[9.0, 0.5]], [[3.0,
                                                                   -2.0]]])))
    assert bool((edge < esdf.FAR).all())


def test_full_map_samplers_match(maps):
    jmaps, tmap = maps
    rng = np.random.default_rng(3)
    pts = rng.uniform([-4.5, -10.0], [22.0, 10.0], (E, 400, 2)).astype(
        np.float32)
    near = esdf.sample_nearest(tmap, _t(pts))
    bil = esdf.sample_bilinear(tmap, _t(pts))
    for e in range(E):
        jn, _ = jesdf.sample_nearest(_env(jmaps, e), jnp.asarray(pts[e]))
        jb, _ = jesdf.sample_bilinear(_env(jmaps, e), jnp.asarray(pts[e]))
        np.testing.assert_array_equal(near[e].numpy(), np.asarray(jn))
        np.testing.assert_allclose(bil[e].numpy(), np.asarray(jb),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(
            query.has_collision(tmap, _t(pts), 0.7)[e].numpy(),
            np.asarray(jesdf.has_collision(_env(jmaps, e),
                                           jnp.asarray(pts[e]), 0.7)))


def _full_window(tmap, head, tail, pp):
    """The solver's windows; at kernel_window_cells=256 each is the map."""
    return expert.make_plan_window(tmap, _t(head[:E]), _t(tail[:E]), pp)


def test_objective_value_and_gradient_match(maps):
    jmaps, tmap = maps
    pp = PlannerParams(samples_per_piece=8, kernel_window_cells=256)
    jpp = JPlannerParams(samples_per_piece=8)
    x0, head, tail, env_of = _problems(jpp, 6)
    window = _full_window(tmap, head, tail, pp)
    assert window.win.shape == (E, 192, 256)
    env_t = torch.from_numpy(env_of)
    fun = partial(costs.objective, head_state=_t(head), tail_state=_t(tail),
                  pmap=window.index(env_t), pp=pp)
    f, g = value_and_grad(fun, _t(x0))
    for i in range(6):
        jf, jg = jax.value_and_grad(jcosts.objective)(
            jnp.asarray(x0[i]), jnp.asarray(head[i]), jnp.asarray(tail[i]),
            _env(jmaps, int(env_of[i])), jpp)
        np.testing.assert_allclose(float(f[i]), float(jf), rtol=1e-5)
        scale = max(float(np.abs(jg).max()), 1.0)
        np.testing.assert_allclose(g[i].numpy() / scale,
                                   np.asarray(jg) / scale, atol=1e-4)
    assert float(f.max()) > 1e3        # some seeds cross obstacles


def _solve_both(maps, max_iters, n=6):
    jmaps, tmap = maps
    kw = dict(samples_per_piece=8, max_iters=max_iters, max_ls=4)
    pp = PlannerParams(kernel_window_cells=256, **kw)
    jpp = JPlannerParams(**kw)
    x0, head, tail, env_of = _problems(jpp, n)
    window = _full_window(tmap, head, tail, pp)
    x, f, it = solve.solve_grid(_t(x0), _t(head), _t(tail), window,
                                torch.from_numpy(env_of), pp)

    def one(em, x0_, h, t):
        fun = partial(jcosts.objective, head_state=h, tail_state=t,
                      emap=em, pp=jpp)
        return jlbfgs.minimize(fun, x0_, max_iters=jpp.max_iters,
                               history=jpp.history, max_ls=jpp.max_ls,
                               ftol=1e-10, gtol=1e-8)
    res = jax.jit(jax.vmap(one))(_env(jmaps, jnp.asarray(env_of)),
                                 jnp.asarray(x0), jnp.asarray(head),
                                 jnp.asarray(tail))
    return (x, f, it), res


def test_single_iteration_matches(maps):
    (x, f, it), res = _solve_both(maps, max_iters=1)
    np.testing.assert_allclose(x.numpy(), np.asarray(res.x), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(f.numpy(), np.asarray(res.f), rtol=1e-4)
    assert it.tolist() == np.asarray(res.iters).tolist()


def test_multi_iteration_same_cost_basin(maps):
    (x, f, it), res = _solve_both(maps, max_iters=12)
    np.testing.assert_allclose(f.numpy(), np.asarray(res.f), rtol=5e-3,
                               atol=5e-3)
    assert int(it.max()) >= 2


def test_skip_returns_seed(maps):
    _, tmap = maps
    pp = PlannerParams(samples_per_piece=8, max_iters=4, max_ls=4,
                       kernel_window_cells=96)
    x0, head, tail, env_of = _problems(JPlannerParams(), 4)
    window = expert.make_plan_window(tmap, _t(head[:E]), _t(tail[:E]), pp)
    skip = torch.tensor([False, True, False, True])
    x, _, it = solve.solve_grid(_t(x0), _t(head), _t(tail), window,
                                torch.from_numpy(env_of), pp, skip=skip)
    np.testing.assert_array_equal(x[skip].numpy(), x0[skip.numpy()])
    assert it[skip].tolist() == [0, 0] and bool((it[~skip] > 0).all())


def test_cpu_tensor_takes_plain_version(maps):
    before = _cuda.launches["lbfgs_grid_solve"]
    _solve_both(maps, max_iters=1, n=2)
    assert _cuda.launches["lbfgs_grid_solve"] == before
