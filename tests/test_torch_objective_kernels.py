"""The per-evaluation objective (plan/objective.py, the plain versions of
kernels B2s and B7) against the JAX package's objective kernels in
interpret mode: costs_pallas.objective_fwd / objective_valgrad on the scene
SDF, costs_pallas_grid.objective_fwd_grid / objective_valgrad_grid on ESDF
windows, each called once for all problems.

Scene problems as test_torch_costs_solver.py (scenegen worlds, a third of
the primitives cylinders, perturbed straight-line seeds through the
obstacle field), several problems per scene through env_of. Window problems
are test_torch_grid_window.py's four, one with its tail beyond the window's
edge inside the map and one beyond the map, plus two more on the same
windows (env_of picks a window for each), so that the clip of the taps,
the zero derivative where it bites and FAR outside the map are all
exercised.

Tolerances are the golden tests' (tests/test_costs_pallas.py and
tests/test_costs_pallas_grid.py): values 5e-4, gradients scaled by
max(|g|, 1) 2e-3. The autograd form's gradient is the value-and-gradient
output times grad_out, exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import MapParams as JMapParams
from neoplanner_tpu.config import PlannerParams as JPlannerParams
from neoplanner_tpu.mapping import scene as jscene
from neoplanner_tpu.plan import costs_pallas as jcp
from neoplanner_tpu.plan import costs_pallas_grid as jcpg
from neoplanner_tpu.plan import expert as jexpert
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import MapParams, PlannerParams
from neoplanner_tpu_torch.mapping import scene
from neoplanner_tpu_torch.ops import minco
from neoplanner_tpu_torch.plan import costs, objective
from tests.test_torch_costs_solver import MAPP, _env, _problems, _t, _worlds
from tests.test_torch_grid_window import problems  # noqa: F401
from tests.test_torch_imports import one_torch_thread  # noqa: F401

KW = dict(samples_per_piece=8)
N_SCENE = 6


def _check(f, g, jf, jg):
    np.testing.assert_allclose(f.numpy(), jf, rtol=5e-4, atol=5e-4)
    if g is not None:
        scale = np.maximum(np.abs(jg), 1.0)
        np.testing.assert_allclose(g.numpy() / scale, jg / scale, atol=2e-3)


@pytest.fixture(scope="module")
def scene_problems():
    jpp = JPlannerParams(**KW)
    jw, tw = _worlds(3, seed=13)
    x0, head, tail = _problems(jpp, N_SCENE, seed=4)
    env_of = np.arange(N_SCENE) % 3
    # the first four problems fly straight through a primitive of their
    # scene
    centers = np.asarray(jw.centers)[env_of[:4], np.arange(4), :2]
    head[:4, 0] = centers - [2.5, 0.3]
    tail[:4, 0] = centers + [2.5, 0.3]
    x0[:4, :4] = np.stack([np.asarray(jexpert.straight_line_wpts(
        jnp.asarray(head[i, 0]), jnp.asarray(tail[i, 0]), jpp)).reshape(4)
        for i in range(4)])
    rng = np.random.default_rng(5)
    x0 = (x0 + rng.normal(scale=0.3, size=x0.shape)).astype(np.float32)
    jscs = jax.vmap(lambda w: jscene.build(w, JMapParams(**MAPP)))(
        _env(jw, jnp.asarray(env_of)))
    return dict(x0=x0, head=head, tail=tail, env_of=env_of, jscs=jscs,
                sc=scene.build(tw, MapParams(**MAPP)))


def _port(fn, p, pmap):
    return fn(_t(p["x0"]), _t(p["head"]), _t(p["tail"]), pmap,
              torch.from_numpy(p["env_of"]), PlannerParams(**KW))


def _jax_scene(fn, p):
    jpp = JPlannerParams(**KW)
    return jax.vmap(lambda x, h, t, s: fn(x, h, t, s, jpp, interpret=True))(
        jnp.asarray(p["x0"]), jnp.asarray(p["head"]), jnp.asarray(p["tail"]),
        p["jscs"])


def test_scene_forward_matches_kernel(scene_problems):
    p = scene_problems
    f = _port(objective.objective_fwd, p, p["sc"])
    _check(f, None, np.asarray(_jax_scene(jcp.objective_fwd, p)), None)


def test_scene_value_and_gradient_match_kernel(scene_problems):
    p = scene_problems
    f, g = _port(objective.objective_valgrad, p, p["sc"])
    jf, jg = _jax_scene(jcp.objective_valgrad, p)
    _check(f, g, np.asarray(jf), np.asarray(jg))
    # the problems cross obstacles: the collision term is live
    pp = PlannerParams(**KW)
    q, tau = costs.unpack(_t(p["x0"]), pp)
    cv, _ = costs.traj_costs(_t(p["head"]), _t(p["tail"]), q, minco.tau_to_T(
        tau, pp.t_min, pp.t_max), p["sc"].index(torch.from_numpy(
            p["env_of"])), pp)
    assert int((cv[:, 3] > 0).sum()) >= 2


@pytest.fixture(scope="module")
def window_problems(problems):  # noqa: F811
    """test_torch_grid_window.py's four problems, one per window, and two
    more: problem 0's and problem 3's boundary states with other seeds, on
    windows 0 and 3."""
    p = problems
    rng = np.random.default_rng(12)
    pick = np.array([0, 1, 2, 3, 0, 3])
    x0 = p["x0"][pick].copy()
    x0[4:] += rng.normal(scale=0.3, size=x0[4:].shape).astype(np.float32)
    return dict(x0=x0, head=p["head"][pick], tail=p["tail"][pick],
                env_of=pick, window=p["window"], wins=p["wins"][pick],
                worgs=p["worgs"][pick])


def _jax_grid(fn, p):
    jpp = JPlannerParams(**KW)
    return jax.vmap(lambda x, h, t, w, o: fn(x, h, t, w, o, jpp,
                                             interpret=True))(
        jnp.asarray(p["x0"]), jnp.asarray(p["head"]), jnp.asarray(p["tail"]),
        jnp.asarray(p["wins"]), jnp.asarray(p["worgs"]))


def test_window_forward_matches_kernel(window_problems):
    p = window_problems
    f = _port(objective.objective_fwd, p, p["window"])
    _check(f, None, np.asarray(_jax_grid(jcpg.objective_fwd_grid, p)), None)


def test_window_value_and_gradient_match_kernel(window_problems):
    p = window_problems
    f, g = _port(objective.objective_valgrad, p, p["window"])
    jf, jg = _jax_grid(jcpg.objective_valgrad_grid, p)
    _check(f, g, np.asarray(jf), np.asarray(jg))


def test_window_problems_leave_the_window_and_the_map(window_problems):
    """Samples of the problems' initial trajectories lie beyond their
    window's edge and beyond the map."""
    p = window_problems
    pp = PlannerParams(**KW)
    q, tau = costs.unpack(_t(p["x0"]), pp)
    ts = minco.tau_to_T(tau, pp.t_min, pp.t_max)
    c = minco.solve_coeffs(_t(p["head"]), _t(p["tail"]), q, ts)
    t, _ = costs.piece_samples(ts, pp)
    pos = torch.einsum("nmkj,nmjd->nmkd", minco.beta(t, 0),
                       c.reshape(6, 3, 6, 2)).reshape(6, -1, 2).numpy()
    o = p["worgs"][:, None]
    lo, hi = o[..., :2], o[..., :2] + 96 * o[..., 2:3]
    out_win = ~((pos >= lo) & (pos < hi)).all(-1)
    out_map = ~((pos >= o[..., 3:5]) & (pos < o[..., 5:7])).all(-1)
    assert (out_win & ~out_map).any()
    assert out_map.any()


@pytest.mark.parametrize("which", ["scene", "window"])
def test_autograd_form_scales_the_kernel_gradient(which, scene_problems,
                                                  window_problems):
    """objective_vjp's gradient is objective_valgrad's times grad_out; the
    boundary states get none."""
    p = scene_problems if which == "scene" else window_problems
    pmap = p["sc"] if which == "scene" else p["window"]
    pp = PlannerParams(**KW)
    x = _t(p["x0"]).requires_grad_(True)
    head = _t(p["head"]).requires_grad_(True)
    env_of = torch.from_numpy(p["env_of"])
    f = objective.objective_vjp(x, head, _t(p["tail"]), pmap, env_of, pp)
    w = torch.linspace(0.5, 2.0, x.shape[0])
    gx, gh = torch.autograd.grad(f, (x, head), w, allow_unused=True)
    f_ref, g_ref = objective.objective_valgrad(_t(p["x0"]), _t(p["head"]),
                                               _t(p["tail"]), pmap, env_of,
                                               pp)
    assert torch.equal(f.detach(), f_ref)
    assert torch.equal(gx, w[:, None] * g_ref)
    assert gh is None


def test_cpu_tensors_take_the_plain_version(scene_problems, window_problems):
    before = dict(_cuda.launches)
    for p, pmap in ((scene_problems, scene_problems["sc"]),
                    (window_problems, window_problems["window"])):
        _port(objective.objective_fwd, p, pmap)
        _port(objective.objective_valgrad, p, pmap)
    assert _cuda.launches == before


def test_cuda_objective_rejects_other_settings():
    with pytest.raises(ValueError, match="M in 2..16"):
        objective._check_params(PlannerParams(num_pieces=17))
    for kw in (dict(sampling="absolute"), dict(samples_per_piece=1)):
        with pytest.raises(ValueError, match="relative sampling"):
            objective._check_params(PlannerParams(**kw))
    for m in (2, 3, 5, 12, 16):
        objective._check_params(PlannerParams(num_pieces=m))
