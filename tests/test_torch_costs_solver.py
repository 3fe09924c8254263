"""Scene SDF, MINCO objective, L-BFGS solver and the lazy warm-start bank of
the PyTorch port against the JAX package.

The JAX side runs on the CPU in its XLA forms (plan/costs.objective with
autodiff, ops/lbfgs.minimize), which its own slow-tier tests hold against
the Pallas kernels in interpret mode. Tolerances:
- SDF and objective values: 1e-5 relative (the same f32 formulas);
- objective gradients: 1e-4 of the gradient's scale (a transposed solve and
  reverse-mode reassociation on both sides);
- one L-BFGS iteration: 1e-4 (as tests/test_solve_pallas.py), since both
  take the same step from the same gradient up to roundoff;
- max_iters iterations: the same cost basin, 5e-3 (as test_solve_pallas.py),
  since roundoff may move the iteration at which a solve stops.
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
from neoplanner_tpu.core.types import BoxWorld as JBoxWorld
from neoplanner_tpu.mapping import scene as jscene
from neoplanner_tpu.ops import lbfgs as jlbfgs
from neoplanner_tpu.ops import minco as jminco
from neoplanner_tpu.plan import costs as jcosts
from neoplanner_tpu.plan import expert as jexpert
from neoplanner_tpu.world import scenegen as jscenegen
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import MapParams, PlannerParams
from neoplanner_tpu_torch.core.types import BoxWorld
from neoplanner_tpu_torch.mapping import scene
from neoplanner_tpu_torch.plan import costs, expert, solve

MAPP = dict(width=256, height=192, origin_x=-4.0, origin_y=-9.6)


def _worlds(n, seed=7, cylinders=True):
    """n JAX worlds (a third of the prims made cylinders) and the same
    worlds as a batched torch BoxWorld."""
    w = jscenegen.generate_batch(jax.random.PRNGKey(seed), n,
                                 JWorldParams(num_boxes=8))
    shape = np.zeros(w.shape.shape, np.int32)
    if cylinders:
        shape[:, ::3] = 1
    w = JBoxWorld(centers=w.centers, half_sizes=w.half_sizes,
                  active=w.active, shape=jnp.asarray(shape))
    tw = BoxWorld(centers=_t(w.centers), half_sizes=_t(w.half_sizes),
                  active=_t(w.active), shape=_t(shape))
    return w, tw


def _env(w, i):
    return jax.tree_util.tree_map(lambda a: a[i], w)


def _problems(pp, n, seed=1):
    """n boundary problems with straight-line seeds: (x0, head, tail)."""
    rng = np.random.default_rng(seed)
    head = np.zeros((n, 3, 2), np.float32)
    tail = np.zeros((n, 3, 2), np.float32)
    head[:, 0] = rng.normal(size=(n, 2)) + [4.0, 0.0]
    tail[:, 0] = head[:, 0] + [5.0, 0.0] + rng.normal(size=(n, 2))
    x0 = np.stack([np.asarray(jcosts.pack(
        jexpert.straight_line_wpts(jnp.asarray(head[i, 0]),
                                   jnp.asarray(tail[i, 0]), pp),
        jminco.T_to_tau(jexpert.init_ts(pp), pp.t_min, pp.t_max), pp))
        for i in range(n)])
    return x0.astype(np.float32), head, tail


def _t(a):
    return torch.from_numpy(np.array(a))


def test_scene_sample_matches():
    jw, tw = _worlds(3)
    sc = scene.build(tw, MapParams(**MAPP))
    rng = np.random.default_rng(0)
    pts = rng.uniform([2.0, -6.0], [28.0, 6.0], size=(3, 200, 2))
    pts[:, :8] = np.asarray(jw.centers[:, :8, :2])       # on prim centers
    pts = pts.astype(np.float32)
    dis, grad = scene.sample(sc, _t(pts))
    for i in range(3):
        jsc = jscene.build(_env(jw, i), JMapParams(**MAPP))
        jd, jg = jscene.sample(jsc, jnp.asarray(pts[i]))
        np.testing.assert_allclose(dis[i].numpy(), np.asarray(jd),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(grad[i].numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-5)


def test_objective_value_and_gradient_match():
    pp = PlannerParams(samples_per_piece=8)
    jpp = JPlannerParams(samples_per_piece=8)
    jw, tw = _worlds(1)
    x0, head, tail = _problems(jpp, 6)
    rng = np.random.default_rng(3)
    x0 = x0 + rng.normal(scale=0.3, size=x0.shape).astype(np.float32)
    sc = scene.build(tw, MapParams(**MAPP))
    env_of = torch.zeros(6, dtype=torch.long)
    fun = partial(costs.objective, head_state=_t(head), tail_state=_t(tail),
                  scene=sc.index(env_of), pp=pp)
    from neoplanner_tpu_torch.ops.lbfgs import value_and_grad
    f, g = value_and_grad(fun, _t(x0))
    jsc = jscene.build(_env(jw, 0), JMapParams(**MAPP))
    for i in range(6):
        jf, jg = jax.value_and_grad(jcosts.objective)(
            jnp.asarray(x0[i]), jnp.asarray(head[i]), jnp.asarray(tail[i]),
            jsc, jpp)
        np.testing.assert_allclose(float(f[i]), float(jf), rtol=1e-5)
        scale = max(float(np.abs(jg).max()), 1.0)
        np.testing.assert_allclose(g[i].numpy() / scale,
                                   np.asarray(jg) / scale, atol=1e-4)


def _jax_solve(jsc, x0, head, tail, jpp):
    fun = partial(jcosts.objective, head_state=head, tail_state=tail,
                  emap=jsc, pp=jpp)
    return jlbfgs.minimize(fun, x0, max_iters=jpp.max_iters,
                           history=jpp.history, max_ls=jpp.max_ls,
                           ftol=1e-10, gtol=1e-8)


def _solve_both(max_iters, n=6):
    pp = PlannerParams(samples_per_piece=8, max_iters=max_iters, max_ls=4)
    jpp = JPlannerParams(samples_per_piece=8, max_iters=max_iters, max_ls=4)
    jw, tw = _worlds(2)
    x0, head, tail = _problems(jpp, n)
    env_of = np.arange(n) % 2
    sc = scene.build(tw, MapParams(**MAPP))
    x, f, it = solve.solve_scene(_t(x0), _t(head), _t(tail), sc,
                                 torch.from_numpy(env_of), pp)
    jscs = jax.vmap(lambda w: jscene.build(w, JMapParams(**MAPP)))(
        _env(jw, jnp.asarray(env_of)))
    res = jax.jit(jax.vmap(partial(_jax_solve, jpp=jpp)))(
        jscs, jnp.asarray(x0), jnp.asarray(head), jnp.asarray(tail))
    want = [jax.tree_util.tree_map(lambda a: a[i], res) for i in range(n)]
    return (x, f, it), want, (x0, head, tail, env_of, sc, pp)


def test_single_iteration_matches():
    (x, _, it), want, _ = _solve_both(max_iters=1)
    np.testing.assert_allclose(x.numpy(), np.stack([np.asarray(r.x)
                                                    for r in want]),
                               rtol=1e-4, atol=1e-4)
    assert it.tolist() == [int(r.iters) for r in want]


def test_multi_iteration_same_cost_basin():
    (x, f, it), want, (x0, head, tail, env_of, sc, pp) = _solve_both(
        max_iters=12)
    f_jax = np.array([float(r.f) for r in want])
    np.testing.assert_allclose(f.numpy(), f_jax, rtol=5e-3, atol=5e-3)
    assert int(it.min()) >= 1 and int(it.max()) <= pp.max_iters
    f0 = costs.objective(_t(x0), _t(head), _t(tail),
                         sc.index(torch.from_numpy(env_of)), pp)
    assert bool((f <= f0 + 1e-6).all())


def test_skip_returns_seed_and_leaves_others_unchanged():
    pp = PlannerParams(samples_per_piece=8, max_iters=6, max_ls=4)
    _, tw = _worlds(1)
    x0, head, tail = _problems(JPlannerParams(samples_per_piece=8), 4)
    sc = scene.build(tw, MapParams(**MAPP))
    env_of = torch.zeros(4, dtype=torch.long)
    skip = torch.tensor([False, True, False, True])
    base = solve.solve_scene(_t(x0), _t(head), _t(tail), sc, env_of, pp)
    lazy = solve.solve_scene(_t(x0), _t(head), _t(tail), sc, env_of, pp,
                             skip=skip)
    np.testing.assert_array_equal(lazy[0][skip].numpy(), x0[skip.numpy()])
    assert lazy[2][skip].tolist() == [0, 0]
    np.testing.assert_array_equal(lazy[0][~skip].numpy(),
                                  base[0][~skip].numpy())
    assert lazy[2][~skip].tolist() == base[2][~skip].tolist()


def test_seed_bank_matches():
    jpp = JPlannerParams(retry_num=2, extra_lateral_scales=(2.5,))
    pp = PlannerParams(retry_num=2, extra_lateral_scales=(2.5,))
    start, target = jnp.array([0.5, -1.0]), jnp.array([5.0, 1.5])
    key = jax.random.PRNGKey(4)
    want = jexpert.seed_bank(start, target, key, jpp)
    noise = jax.random.normal(key, (2, 2, 2))
    got = expert.seed_bank(_t(start)[None], _t(target)[None],
                           _t(noise)[None], pp)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_warm_start_plan_matches():
    """The lazy warm-start bank of NEO: first lane, then the retries with a
    skip mask. Accepted flags and the selected trajectory agree."""
    kw = dict(samples_per_piece=8, max_iters=12, max_ls=4, retry_num=2,
              extra_lateral_scales=())
    pp, jpp = PlannerParams(**kw), JPlannerParams(**kw)
    jw, tw = _worlds(3, seed=11)
    n = 3
    x0, head, tail = _problems(jpp, n, seed=5)
    rng = np.random.default_rng(6)
    q0 = (np.asarray(x0[:, :4]).reshape(n, 2, 2)
          + rng.normal(scale=0.8, size=(n, 2, 2))).astype(np.float32)
    ts0 = np.full((n, 3), 2.5, np.float32)
    keys = jax.random.split(jax.random.PRNGKey(8), n)
    sc = scene.build(tw, MapParams(**MAPP))
    noise = np.stack([np.asarray(jax.random.normal(k, (2, 2, 2)))
                      for k in keys])
    got = expert.warm_start_plan(sc, _t(head), _t(tail), _t(q0), _t(ts0),
                                 _t(noise), pp)
    jscs = jax.vmap(lambda w: jscene.build(w, JMapParams(**MAPP)))(jw)
    res = jax.jit(jax.vmap(partial(jexpert.warm_start_plan, pp=jpp)))(
        jscs, jnp.asarray(head), jnp.asarray(tail), jnp.asarray(q0),
        jnp.asarray(ts0), keys)
    for i in range(n):
        want = jax.tree_util.tree_map(lambda a: a[i], res)
        assert bool(got.ok[i]) == bool(want.ok)
        np.testing.assert_allclose(got.ts[i].numpy(), np.asarray(want.ts),
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(got.int_wpts[i].numpy(),
                                   np.asarray(want.int_wpts),
                                   rtol=5e-3, atol=5e-3)
        np.testing.assert_allclose(got.coeffs[i].numpy(),
                                   np.asarray(want.coeffs),
                                   rtol=1e-2, atol=1e-2)


def test_cpu_tensor_takes_plain_version():
    pp = PlannerParams(samples_per_piece=8, max_iters=2, max_ls=2)
    _, tw = _worlds(1)
    x0, head, tail = _problems(JPlannerParams(samples_per_piece=8), 2)
    before = dict(_cuda.launches)
    solve.solve_scene(_t(x0), _t(head), _t(tail),
                      scene.build(tw, MapParams(**MAPP)),
                      torch.zeros(2, dtype=torch.long), pp)
    assert _cuda.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_solver_kernel_matches_plain(cuda_device):
    """Accepted problems reach the same cost basin (5e-3, as above); the
    kernel's hand adjoint and the plain autograd gradient differ by
    roundoff, so raw x is not compared."""
    pp = PlannerParams(samples_per_piece=24, max_iters=24, max_ls=4)
    _, tw = _worlds(2)
    x0, head, tail = _problems(JPlannerParams(samples_per_piece=24), 64)
    sc = scene.build(tw, MapParams(**MAPP))
    env_of = torch.arange(64) % 2
    want = solve.solve_scene(_t(x0), _t(head), _t(tail), sc, env_of, pp)
    dev = cuda_device
    sc_d = scene.SceneMap(*(getattr(sc, f).to(dev) for f in
                            ("centers", "half", "is_cyl", "active")))
    got = solve.solve_scene(_t(x0).to(dev), _t(head).to(dev),
                            _t(tail).to(dev), sc_d, env_of.to(dev), pp)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].numpy(),
                               rtol=5e-3, atol=5e-3)
