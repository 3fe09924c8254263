"""The port at piece counts M other than 3, against the JAX package: the
plain versions of kernels B2s/B7 (plan/costs.objective), B5
(ops/minco._givens_solve) and B1/B6 (ops/lbfgs.minimize), which the CUDA
kernels are held to on the card (tests/test_torch_kernels_cuda.py), and one
segment of the port's expert loop at M = 5.

Inputs are made from numpy seeds and handed to both sides. Tolerances:
- the objective at M = 5 against the Pallas kernels in interpret mode
  (costs_pallas.objective_fwd / objective_valgrad): the golden test's
  (tests/test_costs_pallas.py test_kernel_generic_piece_count), values
  rtol = atol = 5e-4, gradients 2e-3 of max(|g|, 1);
- the objective at M = 12 on the scene against JAX costs.objective in XLA:
  the same bounds (the window objective at M = 5 and 12 is in
  test_torch_piece_count_window.py);
- the banded solve: 1e-5 of each system's largest solution component (the
  same rotation sequence in f32 on both sides) at n = 12 and 30; at n = 72
  and 96 the f32 solve against itself in f64, 1e-4 as B5 on the card;
- one L-BFGS iteration: 1e-4, as tests/test_torch_costs_solver.py (the same
  step from the same gradient up to roundoff); eight iterations of a
  history of 2 or 3 on a Rosenbrock batch: 1e-4 on x and f.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import MapParams as JMapParams
from neoplanner_tpu.config import PlannerParams as JPlannerParams
from neoplanner_tpu.mapping import scene as jscene
from neoplanner_tpu.ops import lbfgs as jlbfgs
from neoplanner_tpu.ops import minco as jminco
from neoplanner_tpu.plan import costs as jcosts
from neoplanner_tpu.plan import costs_pallas as jcp
from neoplanner_tpu.plan import expert as jexpert
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, PlannerParams,
                                         SimParams, WorldParams)
from neoplanner_tpu_torch.mapping import scene
from neoplanner_tpu_torch.ops import lbfgs, minco
from neoplanner_tpu_torch.plan import costs, objective, solve
from neoplanner_tpu_torch.sim import env
from neoplanner_tpu_torch.world import scenegen
from tests.test_torch_costs_solver import MAPP, _env, _t, _worlds
from tests.test_torch_imports import one_torch_thread  # noqa: F401

KW = dict(samples_per_piece=8)


def _problems(M, n, seed, length=None):
    """n problems of M pieces through the obstacle field ahead of x = 2:
    boundary states and perturbed straight-line seeds (x0, head, tail)."""
    jpp = JPlannerParams(num_pieces=M, **KW)
    rng = np.random.default_rng(seed)
    head = np.zeros((n, 3, 2), np.float32)
    tail = np.zeros((n, 3, 2), np.float32)
    head[:, 0] = rng.normal(size=(n, 2)) + [2.0, 0.0]
    head[:, 1] = rng.normal(scale=0.3, size=(n, 2))
    tail[:, 0] = head[:, 0] + [length or 2.0 * M, 0.0] \
        + rng.normal(size=(n, 2))
    x0 = np.stack([np.asarray(jcosts.pack(
        jexpert.straight_line_wpts(jnp.asarray(head[i, 0]),
                                   jnp.asarray(tail[i, 0]), jpp),
        jminco.T_to_tau(jexpert.init_ts(jpp), jpp.t_min, jpp.t_max), jpp))
        for i in range(n)])
    x0 = x0 + rng.normal(scale=0.3, size=x0.shape)
    return x0.astype(np.float32), head, tail


def _check(f, g, jf, jg):
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=5e-4,
                               atol=5e-4)
    scale = np.maximum(np.abs(np.asarray(jg)), 1.0)
    np.testing.assert_allclose(g.numpy() / scale, np.asarray(jg) / scale,
                               atol=2e-3)


def _scene_case(M, n=4):
    jw, tw = _worlds(2, seed=21)
    x0, head, tail = _problems(M, n, seed=M)
    env_of = np.arange(n) % 2
    jscs = jax.vmap(lambda w: jscene.build(w, JMapParams(**MAPP)))(
        _env(jw, jnp.asarray(env_of)))
    return x0, head, tail, env_of, jscs, scene.build(tw, MapParams(**MAPP))


def _port_valgrad(M, x0, head, tail, pmap, env_of, **kw):
    return objective.objective_valgrad(
        _t(x0), _t(head), _t(tail), pmap, torch.from_numpy(env_of),
        PlannerParams(num_pieces=M, **KW, **kw))


def test_scene_objective_m5_matches_kernels():
    x0, head, tail, env_of, jscs, sc = _scene_case(5)
    jpp = JPlannerParams(num_pieces=5, **KW)
    args = (jnp.asarray(x0), jnp.asarray(head), jnp.asarray(tail), jscs)
    jf = jax.vmap(lambda x, h, t, s: jcp.objective_fwd(
        x, h, t, s, jpp, interpret=True))(*args)
    _, jg = jax.vmap(lambda x, h, t, s: jcp.objective_valgrad(
        x, h, t, s, jpp, interpret=True))(*args)
    f, g = _port_valgrad(5, x0, head, tail, sc, env_of)
    _check(f, g, jf, jg)
    assert float(f.max()) > 100.0           # a collision term is live


def _jax_valgrad(x0, head, tail, emaps, jpp):
    return jax.vmap(jax.value_and_grad(
        lambda x, h, t, m: jcosts.objective(x, h, t, m, jpp)))(
            jnp.asarray(x0), jnp.asarray(head), jnp.asarray(tail), emaps)


def test_scene_objective_m12_matches():
    x0, head, tail, env_of, jscs, sc = _scene_case(12)
    jf, jg = _jax_valgrad(x0, head, tail, jscs,
                          JPlannerParams(num_pieces=12, **KW))
    f, g = _port_valgrad(12, x0, head, tail, sc, env_of)
    _check(f, g, jf, jg)


def _minco_systems(n):
    """The MINCO systems of 3 problems of M = n / 6 pieces, A (3, n, n) and
    b (3, n, 2)."""
    M = n // 6
    x0, head, tail = _problems(M, 3, seed=n)
    pp = PlannerParams(num_pieces=M)
    q, tau = costs.unpack(_t(x0), pp)
    return minco.build_system(_t(head), _t(tail), q,
                              minco.tau_to_T(tau, pp.t_min, pp.t_max))


@pytest.mark.parametrize("n", [12, 30, 72, 96])
def test_banded_solve_matches(n):
    """ops/minco's plain Givens solve of the MINCO system at n = 6M and of
    its transpose: against JAX minco._givens_solve at n = 12 and 30; at
    n = 72 and 96 (M = 12 and 16), where JAX's unrolled solve takes ~40 s
    a size to trace here, in f32 against itself in f64, to the 1e-4 that
    B5 is held to on the card (the small sizes tie the solve to JAX's)."""
    A, b = _minco_systems(n)
    for lo, AA in ((4, A), (2, A.transpose(1, 2))):
        got = minco._givens_solve(AA, b, lo, 6 - lo).numpy()
        if n <= 30:
            want, tol = np.stack([np.asarray(jminco._givens_solve(
                jnp.asarray(AA[i].numpy()), jnp.asarray(b[i].numpy()), lo,
                6 - lo)) for i in range(3)]), 1e-5
        else:
            want, tol = minco._givens_solve(AA.double(), b.double(), lo,
                                            6 - lo).numpy(), 1e-4
        scale = np.abs(want).max(axis=(1, 2), keepdims=True)
        np.testing.assert_allclose(got / scale, want / scale, atol=tol)


@pytest.mark.parametrize("H", [2, 3])
def test_lbfgs_history_wraps_matches_jax(H):
    """ops/lbfgs.minimize, the plain version the solver kernels are held to
    past one iteration, against JAX lbfgs.minimize on a batch of extended
    Rosenbrock functions of 10 variables: 8 iterations of a history of 2
    or 3, so that the ring wraps; x and f within 1e-4 (the same f32 steps
    up to roundoff), the iteration counts equal."""
    rng = np.random.default_rng(H)
    x0 = (rng.normal(scale=0.5, size=(4, 10)) - 1.0).astype(np.float32)
    kw = dict(max_iters=8, history=H, max_ls=8, ftol=1e-10, gtol=1e-8)

    def rosen(x, xp):
        return (100.0 * (x[..., 1::2] - x[..., ::2] ** 2) ** 2
                + (1.0 - x[..., ::2]) ** 2).sum(-1)
    res = jax.vmap(lambda x_: jlbfgs.minimize(
        lambda xx: rosen(xx, jnp), x_, **kw))(jnp.asarray(x0))
    got = lbfgs.minimize(lambda xx: rosen(xx, torch), _t(x0), **kw)
    assert (np.asarray(res.iters) == 8).all()
    np.testing.assert_allclose(got.x.numpy(), np.asarray(res.x), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.f.numpy(), np.asarray(res.f), rtol=1e-4,
                               atol=1e-4)
    assert got.iters.tolist() == np.asarray(res.iters).tolist()


def test_one_lbfgs_iteration_m5():
    """solve.solve_scene's plain version (the one B1 is held to on the
    card) at M = 5, one iteration at histories 5 and 20, against JAX
    lbfgs.minimize(max_iters=1) on JAX's objective. The first iteration
    reads no pair from the ring (none is stored before it), so JAX's
    result is the same at every history: it is traced once, at H = 5
    (a trace and compile of the M = 5 objective take ~30 s)."""
    x0, head, tail, env_of, jscs, sc = _scene_case(5)
    kw = dict(num_pieces=5, max_iters=1, max_ls=4, **KW)
    jpp = JPlannerParams(history=5, **kw)
    res = jax.vmap(lambda x_, h, t, m: jlbfgs.minimize(
        lambda xx: jcosts.objective(xx, h, t, m, jpp), x_, max_iters=1,
        history=5, max_ls=4, ftol=1e-10, gtol=1e-8))(
            jnp.asarray(x0), jnp.asarray(head), jnp.asarray(tail), jscs)
    for H in (5, 20):
        x, f, it = solve.solve_scene(_t(x0), _t(head), _t(tail), sc,
                                     torch.from_numpy(env_of),
                                     PlannerParams(history=H, **kw))
        np.testing.assert_allclose(x.numpy(), np.asarray(res.x), rtol=1e-4,
                                   atol=1e-4)
        assert it.tolist() == np.asarray(res.iters).tolist()


@pytest.mark.parametrize("planner", ["expert", "warmstart"])
def test_expert_segment_m5_scene(planner):
    """One segment of the expert loops at M = 5 (init_wpts_num 4 in the
    reference's YAML) on the scene path, B = 4, port only: the setpoint
    buffer and the carried plan follow M and the replans are accepted; a
    net planner refuses M = 5."""
    B, M = 4, 5
    pp = PlannerParams(num_pieces=M, samples_per_piece=8, max_iters=12,
                       max_ls=4, retry_num=2, extra_lateral_scales=())
    mp = MissionParams()
    worlds = scenegen.generate_batch(_cuda.make_generator(3, "cpu"), B,
                                     WorldParams(num_boxes=6))
    goal = torch.tensor([[20.0, 0.0], [18.0, 2.0], [20.0, -2.0],
                         [15.0, 1.0]])
    st = env.reset(worlds, pp, mp, MapParams(**MAPP),
                   _cuda.make_generator(4, "cpu"), goal=goal)
    assert st.buffer.shape[1] == env.n_buffer(pp, mp)
    assert st.carry_wpts.shape == (B, 2, M - 1)
    st, info = env.step_segment(st, pp, mp, SimParams(), CameraParams(),
                                planner=planner)
    assert info.int_wpts.shape == (B, 2, M - 1)
    assert info.ts.shape == (B, M)
    assert bool(info.ok.all())
    assert torch.isfinite(st.buffer).all()
    assert torch.isfinite(st.drone.pos).all()
    assert bool(st.has_carry.all())
    with pytest.raises(ValueError, match="M=3"):
        env.step_segment(st, pp, mp, SimParams(), CameraParams(),
                         planner="neo")
