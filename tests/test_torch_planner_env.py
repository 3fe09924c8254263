"""The closed loop with the expert planners against the JAX package: 3
segments of sim/env.step_segment at B=8 with planner='expert' on the scene
path (ground-truth sensing, the scene SDF), against JAX step_segment with
the same planner. The loop helpers here also serve the other planner
loops: test_torch_planner_env_grid.py ('expert' on the gt+grid path),
test_torch_planner_warmstart_env.py and
test_torch_planner_warmstart_grid.py ('warmstart'),
test_torch_planner_nn_env.py ('nn'); one pair of JAX loops per file, since
each compiles a whole step_segment.

Built as test_torch_env.py and test_torch_gt_grid_env.py: both sides start
from the same JAX reset state (half the envs fly toward x = 20 through the
obstacle field) and get the JAX draws of every segment (the retry-bank
noise of the expert bank is the same draw as NEO's). The expert planners
need no net and, on the ground-truth paths, render no frame. On the gt+grid
path the port solves on windows that cover the whole map and accepts by
the nearest-cell rule, which the JAX side is given as in
test_torch_gt_grid_env.py.

Tolerances follow test_torch_env.py: the 12-iteration loop by plan flags,
goals, mission flags and counts exactly, and each accepted plan's JAX
objective within 5e-3 of the JAX plan's (the cost basin); its
one-iteration twin (max_iters=1) also by the drone state, the setpoint
buffer, the metrics and the carried solution elementwise within 1e-4.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from neoplanner_tpu.config import CameraParams as JCameraParams
from neoplanner_tpu.config import MapParams as JMapParams
from neoplanner_tpu.config import MissionParams as JMissionParams
from neoplanner_tpu.config import NetParams as JNetParams
from neoplanner_tpu.config import PlannerParams as JPlannerParams
from neoplanner_tpu.config import SimParams as JSimParams
from neoplanner_tpu.config import WorldParams as JWorldParams
from neoplanner_tpu.plan import expert as jexpert
from neoplanner_tpu.sim import env as jenv
from neoplanner_tpu.world import scenegen as jscenegen
from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, NetParams,
                                         PlannerParams, SimParams)
from neoplanner_tpu_torch.learn import weights
from neoplanner_tpu_torch.models import planner_net
from neoplanner_tpu_torch.sim import env
from tests import test_torch_gt_grid_env as gt_grid
from tests.test_torch_env import (CAM, MAPP, NET, ONNX, PP, _check_flags,
                                  _flax_variables, _jax_draws, plan_costs)
from tests.test_torch_imports import one_torch_thread  # noqa: F401
from tests.test_torch_track import to_port_state
from tests.test_torch_vision_env import _nearest_acceptance

B = 8
SEGMENTS = 3


def _reset_scene(jpp, jmp):
    worlds = jscenegen.generate_batch(jax.random.PRNGKey(0), B,
                                      JWorldParams(num_boxes=10))
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    rng = np.random.default_rng(2)
    goals = np.stack([np.array([20.0] * 4 + [0.0] * 2 + [0.7] * 2),
                      rng.uniform(-1.5, 1.5, B)], -1).astype(np.float32)
    goals[4:6, 1] = 0.1
    return jax.vmap(lambda k, w, g: jenv.reset(
        k, w, g, jpp, jmp, JMapParams(**MAPP), plan_map="scene"))(
            keys, worlds, jnp.asarray(goals))


def run_loop(planner, path, max_iters, solver="fused"):
    """SEGMENTS segments of the JAX loop and of the port with ``planner``
    on the 'scene' or the gt+grid ('grid') path; returns per segment (JAX
    state, JAX info, port state, port info, the JAX planning maps)."""
    grid = path == "grid"
    pp_kw = dict(PP, max_iters=max_iters)
    jpp = JPlannerParams(**pp_kw)
    pp = PlannerParams(**pp_kw, **(dict(kernel_window_cells=256) if grid
                                   else {}))
    jmp, jsp, jmapp = JMissionParams(), JSimParams(), JMapParams(**MAPP)
    seg_kw = dict(mission_mode="random", cam=JCameraParams(**CAM),
                  planner=planner, sensing="gt", plan_map=path,
                  mapp=jmapp if grid else None)
    net = None
    if planner in ("nn", "neo"):
        sd = weights.from_onnx(ONNX)
        seg_kw.update(net_vars=_flax_variables(sd), np_cfg=JNetParams(**NET))
        net = planner_net.PlannerNet(NetParams(**NET))
        net.load_state_dict(sd)
        net.eval()
    if grid:
        js = gt_grid._reset_jax(jpp, jmp, jmapp)
        _, st = gt_grid.to_port_state(js, pp, MapParams(**MAPP))
    else:
        js = _reset_scene(jpp, jmp)
        st = to_port_state(js, pp, MapParams(**MAPP))
    step = jax.jit(jax.vmap(partial(jenv.step_segment, pp=jpp, mp=jmp,
                                    sp=jsp, **seg_kw)))
    out = []
    with pytest.MonkeyPatch.context() as patch:
        if grid:
            patch.setattr(jexpert, "costs_mod", _nearest_acceptance())
        for _ in range(SEGMENTS):
            draws = _jax_draws(js.key, jpp)
            pmaps = js.emap if grid else js.scene
            js, jinfo = step(js)
            st, info = env.step_segment(
                st, pp, MissionParams(), SimParams(), CameraParams(**CAM),
                net, draws=draws, planner=planner, solver=solver)
            out.append((js, jinfo, st, info, pmaps))
    return out


def check_basin(run):
    """Exact flags and counts; accepted plans in the cost basin (5e-3)."""
    js, jinfo, st, info, pmaps = run
    _check_flags(js, jinfo, st, info)
    np.testing.assert_array_equal(st.has_carry.numpy(),
                                  np.asarray(js.has_carry))
    jpp = JPlannerParams(**PP)
    ok = np.asarray(jinfo.ok)
    f_port = plan_costs(pmaps, jinfo, info.int_wpts.numpy(), info.ts.numpy(),
                        jpp)
    f_jax = plan_costs(pmaps, jinfo, jinfo.int_wpts, jinfo.ts, jpp)
    np.testing.assert_allclose(f_port[ok], f_jax[ok], rtol=5e-3, atol=5e-3)


def check_elementwise(run):
    """Exact flags and counts; the drone state, the setpoint buffer, the
    metrics, the plans and the carried solution within 1e-4."""
    js, jinfo, st, info, _ = run
    _check_flags(js, jinfo, st, info)
    for f in ("pos", "vel", "quat"):
        np.testing.assert_allclose(getattr(st.drone, f).numpy(),
                                   np.asarray(getattr(js.drone, f)),
                                   atol=1e-4, err_msg=f)
    for f in ("buffer", "metrics", "carry_wpts", "carry_ts"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-4,
                                   atol=1e-4, err_msg=f)
    np.testing.assert_array_equal(st.has_carry.numpy(),
                                  np.asarray(js.has_carry))
    for f in ("int_wpts", "ts"):
        np.testing.assert_allclose(getattr(info, f).numpy(),
                                   np.asarray(getattr(jinfo, f)), atol=1e-4,
                                   err_msg=f)


def check_moves(loop):
    """Not a vacuous match: drones moved (an expert plan from hover covers
    ~0.5 m in three segments), plans were accepted in every segment and
    missions ended."""
    _, _, st, _, _ = loop[-1]
    assert float(np.abs(st.drone.pos[:, :2].numpy()).max()) > 0.1
    assert int(st.plan_count.sum()) > B
    assert all(bool(r[3].ok.any()) for r in loop)
    assert int(st.missions_done.sum()) >= 1


@pytest.fixture(scope="module")
def runs():
    return run_loop("expert", "scene", PP["max_iters"])


@pytest.fixture(scope="module")
def runs_one_iter():
    return run_loop("expert", "scene", 1)


@pytest.mark.parametrize("seg", range(SEGMENTS))
def test_segment_state_matches(runs, seg):
    check_basin(runs[seg])


@pytest.mark.parametrize("seg", range(SEGMENTS))
def test_segment_one_iteration_matches(runs_one_iter, seg):
    check_elementwise(runs_one_iter[seg])


def test_loop_plans_and_moves(runs, runs_one_iter):
    check_moves(runs)
    check_moves(runs_one_iter)
