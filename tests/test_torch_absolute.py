"""Absolute sampling (the reference's discretization of the penalty
integrals) and costs.reference_eval in the port against the JAX package on
the CPU, and the expert planners under it.

Tolerances. The sample times and weights are JAX's exactly, durations on
sample boundaries included (the +1e-4 of floor(T/dt + 1e-4)). Costs
within 1e-5 relative, gradients within 1e-4 of each problem's largest
component (f32 sums of collision terms up to 1e6 in another order; the
sample count carries no gradient on either side). The plans come out of
full L-BFGS runs (max_iters 256), so they are held as the golden holds
JAX's: tests/test_expert.py::test_matches_scipy_unobstructed mirrored, the
reference_eval cost within 5e-3 of scipy's L-BFGS-B (the absolute
discretization's plateau), and the acceptance flags against JAX's plan.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import PlannerParams as JPlannerParams
from neoplanner_tpu.plan import costs as jcosts
from neoplanner_tpu.plan import expert as jexpert
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, PlannerParams,
                                         SimParams, WorldParams)
from neoplanner_tpu_torch.core.types import ESDFMap
from neoplanner_tpu_torch.ops import minco
from neoplanner_tpu_torch.plan import costs, expert, objective, solve
from neoplanner_tpu_torch.sim import env
from neoplanner_tpu_torch.world import scenegen
from tests.test_expert import make_world, mission, scipy_reference_cost
from tests.test_torch_imports import one_torch_thread  # noqa: F401

ABS = dict(sampling="absolute", esdf_interp="nearest")


def _t(a):
    return torch.from_numpy(np.array(a))


def _tmap(jmap, B):
    planes = {f: _t(getattr(jmap, f))[None].expand(B, -1, -1).contiguous()
              for f in ("esdf", "occupancy", "grad_x", "grad_y")}
    return ESDFMap(origin=_t(jmap.origin), resolution=float(jmap.resolution),
                   **planes)


def _problems(n, seed):
    """n trajectories from (0, 0) toward (8, 0) across the golden map's
    box: waypoints, durations (some exactly on sample boundaries)."""
    rng = np.random.default_rng(seed)
    jpp = JPlannerParams(**ABS)
    head = np.zeros((n, 3, 2), np.float32)
    tail = np.zeros((n, 3, 2), np.float32)
    head[:, 1] = rng.uniform(-0.5, 0.5, (n, 2))
    tail[:, 0] = [8.0, 0.0] + rng.uniform(-1, 1, (n, 2))
    q = np.stack([np.linspace(2, 6, 2)[None].repeat(n, 0)
                  + rng.uniform(-0.5, 0.5, (n, 2)),
                  rng.uniform(-1.5, 1.5, (n, 2))], 1).astype(np.float32)
    ts = rng.uniform(jpp.t_min, 4.9, (n, 3)).astype(np.float32)
    ts[0] = [1.0, 2.3, 0.5]
    ts[1] = [3.0, 1.7, 4.2]
    return head, tail, q, ts


def test_piece_samples_match_jax():
    """t and w of absolute sampling are JAX's exactly (K = max_abs_samples
    slots, the first floor(T/dt + 1e-4) live, endpoints weighted 0.5)."""
    pp, jpp = PlannerParams(**ABS), JPlannerParams(**ABS)
    _, _, _, ts = _problems(64, 0)
    t, w = costs.piece_samples(_t(ts), pp)
    assert t.shape == (64, 3, pp.max_abs_samples)
    for i in range(64):
        jt, jw = jcosts._piece_samples(jnp.asarray(ts[i]), jpp)
        np.testing.assert_array_equal(t[i].numpy(), np.asarray(jt))
        np.testing.assert_array_equal(w[i].numpy(), np.asarray(jw))


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_costs_and_gradient_match_jax(interp):
    """traj_costs, the objective and its gradient under absolute sampling
    on the golden map, and reference_eval of relative-mode parameters,
    against JAX's."""
    kw = dict(sampling="absolute", esdf_interp=interp)
    pp, jpp = PlannerParams(**kw), JPlannerParams(**kw)
    jmap = make_world(blocking=True)
    n = 16
    head, tail, q, ts = _problems(n, 1)
    tmap = _tmap(jmap, n)
    got, _ = costs.traj_costs(_t(head), _t(tail), _t(q), _t(ts), tmap, pp)
    want = np.stack([np.asarray(jcosts.traj_costs(
        head[i], tail[i], q[i], ts[i], jmap, jpp)[0]) for i in range(n)])
    assert (want[:, 3] > 0).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    ref = costs.reference_eval(_t(head), _t(tail), _t(q), _t(ts), tmap,
                               PlannerParams(esdf_interp=interp))
    jref = np.stack([np.asarray(jcosts.reference_eval(
        head[i], tail[i], q[i], ts[i], jmap, JPlannerParams(
            esdf_interp=interp))) for i in range(n)])
    np.testing.assert_allclose(ref.numpy(), jref, rtol=1e-5, atol=1e-6)
    x = costs.pack(_t(q), minco.T_to_tau(_t(ts), pp.t_min, pp.t_max), pp)
    with torch.enable_grad():
        xr = x.clone().requires_grad_(True)
        f = costs.objective(xr, _t(head), _t(tail), tmap, pp)
        (g,) = torch.autograd.grad(f.sum(), xr)
    for i in range(n):
        jf, jg = jax.value_and_grad(lambda xi: jcosts.objective(
            xi, head[i], tail[i], jmap, jpp))(jnp.asarray(x[i].numpy()))
        assert abs(float(f[i]) - float(jf)) <= 1e-5 * max(abs(float(jf)),
                                                          1.0)
        np.testing.assert_allclose(g[i].numpy(), np.asarray(jg), rtol=0,
                                   atol=1e-4 * float(np.abs(jg).max()))


def test_matches_scipy_unobstructed():
    """tests/test_expert.py::test_matches_scipy_unobstructed[absolute-
    nearest] on the port: the expert plan with absolute sampling is
    accepted and its reference_eval cost is within 5e-3 of scipy's
    L-BFGS-B over the same seeds, or below it; its acceptance is JAX's."""
    jpp = JPlannerParams(**ABS)
    pp = PlannerParams(**ABS)
    jmap = make_world(blocking=False)
    jhead, jtail = mission(jpp)
    key = jax.random.PRNGKey(1)
    noise = jax.random.normal(key, (jpp.retry_num, jpp.dims, jpp.num_wpts))
    head, tail = _t(jhead)[None], _t(jtail)[None]
    traj = expert.plan(_tmap(jmap, 1), head, tail, _t(noise)[None], pp)
    assert bool(traj.ok[0])
    cvec = costs.reference_eval(head, tail, traj.int_wpts, traj.ts,
                                _tmap(jmap, 1), pp)
    ours = float(cvec[0] @ costs.weights(pp))
    ref = scipy_reference_cost(jmap, jhead, jtail, jpp)
    assert ref < np.inf
    assert ours <= ref + 5e-3 * max(1.0, abs(ref)), (ours, ref)
    want = jax.jit(jexpert.plan, static_argnames="pp")(jmap, jhead, jtail,
                                                      key, jpp)
    assert bool(want.ok) == bool(traj.ok[0])


def test_solve_one_absolute_branch():
    """solve_one under absolute sampling: autograd L-BFGS on each env's
    whole map (no window) for either solver value, skipped lanes keeping
    their seed with 0 iterations, acceptance as pp.esdf_interp says; the
    CUDA solver's and objective's launch checks still refuse it."""
    pp = PlannerParams(**ABS, max_iters=8)
    jmap = make_world(blocking=True)
    n = 4
    head, tail, q, ts = _problems(n, 2)
    tmap = _tmap(jmap, n)
    env_of = torch.arange(n)
    skip = torch.tensor([False, True, False, True])
    runs = [expert.solve_one(tmap, _t(head), _t(tail), _t(q), _t(ts), env_of,
                             pp, skip=skip, solver=s)
            for s in expert.SOLVERS]
    for a in runs[1:]:
        for f in ("int_wpts", "ts", "costs", "ok", "iters"):
            assert torch.equal(getattr(a, f), getattr(runs[0], f)), f
    traj = runs[0]
    assert traj.iters[skip].eq(0).all() and traj.iters[~skip].gt(0).all()
    np.testing.assert_array_equal(traj.int_wpts[skip].numpy(), q[skip.numpy()])
    cvec, _ = costs.traj_costs(_t(head), _t(tail), traj.int_wpts, traj.ts,
                               tmap, pp)
    torch.testing.assert_close(traj.costs, cvec, rtol=0, atol=0)
    with pytest.raises(ValueError, match="relative sampling"):
        solve._check_kernel_params(pp)
    with pytest.raises(ValueError, match="relative sampling"):
        objective._check_params(pp)


@pytest.mark.parametrize("planner", ["expert", "warmstart", "neo"])
def test_step_segment_absolute(planner):
    """step_segment accepts absolute sampling for the expert, warmstart and
    neo planners on the scene path: two segments at B = 3 plan, and the
    state stays finite."""
    pp = PlannerParams(**ABS, max_iters=6, retry_num=2,
                       extra_lateral_scales=(), max_ls=4)
    mp, sp = MissionParams(), SimParams()
    mapp = MapParams(width=256, height=192, origin_x=-4.0, origin_y=-9.6)
    cam = CameraParams(width=32, height=24)
    gen = _cuda.make_generator(4, "cpu")
    world = scenegen.generate_batch(gen, 3, WorldParams(num_boxes=6))
    state = env.reset(world, pp, mp, mapp, gen, goal=torch.tensor(
        [[6.0, 0.0], [5.0, 1.0], [7.0, -1.0]]))
    net = None
    if planner == "neo":
        from neoplanner_tpu_torch.config import NetParams
        from neoplanner_tpu_torch.learn import train
        from neoplanner_tpu_torch.models.planner_net import PlannerNet
        npc = NetParams(img_width=32, img_height=24, backbone="smallconv")
        net = PlannerNet(npc)
        net.load_state_dict(train.init_params(torch.Generator().manual_seed(
            0), npc))
        net.eval()
    planned = 0
    for _ in range(2):
        state, info = env.step_segment(state, pp, mp, sp, cam, net,
                                       planner=planner)
        planned += int(info.planned.sum())
    assert planned > 0 and int(state.iter_sum.sum()) > 0
    assert bool(torch.isfinite(state.buffer).all())
