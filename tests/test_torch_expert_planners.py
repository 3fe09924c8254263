"""The expert planners of the PyTorch port against the JAX package:
expert.plan (the multi-start bank), expert._select and
nn_init.nn_trajectory (the 'nn' planner); expert.plan_with_carry is in
test_torch_warmstart_planner.py, on the same maps.

Maps: tests/test_expert.py's golden map (a 16 x 12 m corridor with a box
across the straight line and a second one off it; the port plans on a
window covering the whole map, as the JAX planner's CPU path plans on the
map itself) and scenegen scenes. On the golden map the JAX side accepts by
the nearest-cell rule that its planner applies when its grid windows are
engaged, the port's rule (test_torch_vision_env._nearest_acceptance). The
retry draws are JAX's, passed to the port as standard normals.

Tolerances: the bank's plans come out of 12-iteration L-BFGS solves, so
they are held to the JAX plans by the acceptance flags exactly and the
selected plan's JAX objective within 5e-3 (the cost basin, as
test_torch_costs_solver.py); _select is exact on the same bank; the 'nn'
trajectory, with no solve, within 1e-4 (test_torch_net.py's tolerance of
the net).
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import MapParams as JMapParams
from neoplanner_tpu.config import NetParams as JNetParams
from neoplanner_tpu.config import PlannerParams as JPlannerParams
from neoplanner_tpu.core.types import DroneState as JDroneState
from neoplanner_tpu.core.types import Trajectory as JTrajectory
from neoplanner_tpu.mapping import scene as jscene
from neoplanner_tpu.plan import expert as jexpert
from neoplanner_tpu.plan import nn_init as jnn_init
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import MapParams, NetParams, PlannerParams
from neoplanner_tpu_torch.core.types import DroneState, ESDFMap, Trajectory
from neoplanner_tpu_torch.learn import weights
from neoplanner_tpu_torch.mapping import scene
from neoplanner_tpu_torch.models import planner_net
from neoplanner_tpu_torch.plan import expert, nn_init
from tests.test_expert import make_world
from tests.test_torch_costs_solver import MAPP, _t, _worlds
from tests.test_torch_env import plan_costs
from tests.test_torch_imports import one_torch_thread  # noqa: F401
from tests.test_torch_net import SMALL, _flax_vars
from tests.test_torch_vision_env import _nearest_acceptance

KW = dict(samples_per_piece=8, max_iters=12, max_ls=4, retry_num=2,
          extra_lateral_scales=(2.5,))
B = 4


def _boundaries():
    head = np.zeros((B, 2, 2), np.float32)
    tail = np.zeros((B, 2, 2), np.float32)
    head[:, 0] = [[0.0, 0.0], [1.0, 0.5], [0.0, -1.0], [2.0, 1.0]]
    head[:, 1] = [[0.5, 0.0], [0.3, 0.0], [0.5, 0.2], [0.0, 0.0]]
    tail[:, 0] = [[10.0, 0.0], [9.0, -0.5], [8.0, 1.0], [11.0, 0.0]]
    return head, tail


def _golden():
    """The golden map for B envs on both sides."""
    jmap = make_world()
    jmaps = jax.tree_util.tree_map(lambda a: jnp.stack([a] * B), jmap)
    planes = {f: _t(getattr(jmap, f))[None].expand(B, -1, -1).contiguous()
              for f in ("esdf", "occupancy", "grad_x", "grad_y")}
    tmap = ESDFMap(origin=_t(jmap.origin), resolution=float(jmap.resolution),
                   **planes)
    return jmaps, tmap, PlannerParams(**KW, kernel_window_cells=160)


def _scenes():
    jw, tw = _worlds(B, seed=17)
    jmaps = jax.vmap(lambda w: jscene.build(w, JMapParams(**MAPP)))(jw)
    return jmaps, scene.build(tw, MapParams(**MAPP)), PlannerParams(**KW)


MAPS = {"golden": _golden, "scene": _scenes}


def _case(which):
    jmaps, tmap, pp = MAPS[which]()
    jpp = JPlannerParams(**KW)
    head, tail = _boundaries()
    if which == "scene":      # through the scenes' obstacle field
        head[:, 0] += [4.0, 0.0]
        tail[:, 0] += [4.0, 0.0]
    jhead = jax.vmap(lambda s: jexpert.pad_boundary_state(s, jpp))(
        jnp.asarray(head))
    jtail = jax.vmap(lambda s: jexpert.pad_boundary_state(s, jpp))(
        jnp.asarray(tail))
    keys = jax.random.split(jax.random.PRNGKey(21), B)
    noise = jax.vmap(lambda k: jax.random.normal(
        k, (jpp.retry_num, jpp.dims, jpp.num_wpts)))(keys)
    return dict(jmaps=jmaps, tmap=tmap, pp=pp, jpp=jpp, jhead=jhead,
                jtail=jtail, keys=keys, head=_t(jhead), tail=_t(jtail),
                noise=_t(noise))


def _jax_call(fn, which, *args):
    with pytest.MonkeyPatch.context() as patch:
        if which == "golden":
            patch.setattr(jexpert, "costs_mod", _nearest_acceptance())
        return jax.jit(jax.vmap(fn))(*args)


def _check_plans(c, got, want):
    """Acceptance exactly; the selected plans in the cost basin."""
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    info = type("Info", (), dict(plan_init=c["jhead"][:, :2],
                                 target=c["jtail"][:, :2]))
    f_port = plan_costs(c["jmaps"], info, got.int_wpts.numpy(),
                        got.ts.numpy(), c["jpp"])
    f_jax = plan_costs(c["jmaps"], info, want.int_wpts, want.ts, c["jpp"])
    np.testing.assert_allclose(f_port, f_jax, rtol=5e-3, atol=5e-3)


@pytest.fixture(scope="module", params=sorted(MAPS))
def planned(request):
    """expert.plan on both sides."""
    c = _case(request.param)
    got = expert.plan(c["tmap"], c["head"], c["tail"], c["noise"], c["pp"])
    want = _jax_call(partial(jexpert.plan, pp=c["jpp"]), request.param,
                     c["jmaps"], c["jhead"], c["jtail"], c["keys"])
    return request.param, c, got, want


def test_plan_matches(planned):
    which, c, got, want = planned
    _check_plans(c, got, want)
    assert bool(got.ok.any())
    if which == "golden":       # the box blocks the straight line
        assert float(got.int_wpts[:, 1].abs().max()) > 0.5


def _bank(rng, S):
    """A bank of S lanes for 5 envs: no lane accepted; a primary and a
    retry; only retries; every lane; ties on the total."""
    ok = np.array([[0] * S, [0, 1] + [0] * (S - 3) + [1],
                   [0] * 3 + [1] * (S - 3), [1] * S,
                   [1, 1] + [0] * (S - 2)], bool)
    costs = rng.uniform(0.0, 2.0, (5, S, 4)).astype(np.float32)
    costs[4, 1] = costs[4, 0]
    return dict(int_wpts=rng.normal(size=(5, S, 2, 2)),
                ts=rng.uniform(1.0, 3.0, (5, S, 3)),
                coeffs=rng.normal(size=(5, S, 18, 2)), costs=costs, ok=ok,
                iters=rng.integers(0, 12, (5, S)).astype(np.int32))


def test_select_matches():
    rng = np.random.default_rng(4)
    jpp = JPlannerParams(**KW)
    bank = _bank(rng, 6)
    for k in ("int_wpts", "ts", "coeffs"):
        bank[k] = bank[k].astype(np.float32)
    got = expert._select(Trajectory(**{k: _t(v) for k, v in bank.items()}),
                         PlannerParams(**KW))
    want = jax.vmap(partial(jexpert._select, pp=jpp))(
        JTrajectory(**{k: jnp.asarray(v) for k, v in bank.items()}))
    for f in ("int_wpts", "ts", "coeffs", "costs", "ok", "iters"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_nn_trajectory_matches():
    jcfg, cfg = JNetParams(**SMALL), NetParams(**SMALL)
    _, variables = _flax_vars(jcfg)
    net = planner_net.PlannerNet(cfg)
    net.load_state_dict(weights.from_flax(
        jax.tree_util.tree_map(np.asarray, variables)))
    rng = np.random.default_rng(8)
    jpp, pp = JPlannerParams(), PlannerParams()
    depth = rng.uniform(0.3, 6.0, (B, 30, 40)).astype(np.float32)
    pos = rng.normal(size=(B, 3)).astype(np.float32)
    vel = rng.normal(size=(B, 3)).astype(np.float32)
    q = rng.normal(size=(B, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    yaw = rng.normal(size=B).astype(np.float32)
    init = rng.normal(size=(B, 2, 2)).astype(np.float32)
    target = init + rng.uniform(2.0, 5.0, (B, 2, 2)).astype(np.float32)
    head = np.stack([np.asarray(jexpert.pad_boundary_state(s, jpp))
                     for s in init])
    tail = np.stack([np.asarray(jexpert.pad_boundary_state(s, jpp))
                     for s in target])
    drone = DroneState(*(torch.from_numpy(a) for a in (pos, vel, q, yaw)))
    before = dict(_cuda.launches)
    got = nn_init.nn_trajectory(net, torch.from_numpy(depth), drone, 2.0,
                                _t(init), _t(target), _t(head), _t(tail), pp)
    assert _cuda.launches == before
    assert got.ok.all() and not got.costs.any() and not got.iters.any()
    for i in range(B):
        jd = JDroneState(pos=pos[i], vel=vel[i], quat=q[i], yaw=yaw[i])
        want = jnn_init.nn_trajectory(variables, jcfg, depth[i], jd, 2.0,
                                      init[i], target[i], head[i], tail[i],
                                      jpp)
        for f in ("int_wpts", "ts"):
            np.testing.assert_allclose(getattr(got, f)[i].numpy(),
                                       np.asarray(getattr(want, f)),
                                       rtol=1e-4, atol=1e-4, err_msg=f)
        scale = max(float(np.abs(want.coeffs).max()), 1.0)
        np.testing.assert_allclose(got.coeffs[i].numpy() / scale,
                                   np.asarray(want.coeffs) / scale,
                                   atol=1e-4)
        assert bool(want.ok) and not np.asarray(want.costs).any()
