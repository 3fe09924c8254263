"""The ground-truth grid loop of the PyTorch port against the JAX package: 3
segments of sim/env.step_segment with sensing='gt', plan_map='grid' (the
JAX package's defaults: each world rasterized at reset into a full-profile
exact ESDF, the NEO planner on that grid, grid tracking) at B=8 on
tests/test_env.py's 256 x 192 map.

Built like test_torch_vision_env.py: both sides start from the same JAX
reset state (its full-profile map carried over plane by plane) and get the
JAX draws of every segment; the net is artifacts/planner_net_smallconv.onnx
on both sides. The JAX planner solves on the full map with bilinear
sampling; the port solves on kernel_window_cells windows, set to 256 so
that each window is the whole map, and accepts a plan by its nearest-cell
collision cost on the full map, the rule the JAX planner applies when its
grid windows are engaged, which the JAX side is given the same way as in
test_torch_vision_env.py. The port's own reset is held to the JAX one
(the same ESDF planes, bit for bit).

Tolerances follow test_torch_vision_env.py. The 12-iteration loop: plan
flags, goals, mission flags and counts exactly, and each accepted plan's
JAX objective on the map within 5e-3 of the JAX plan's. Its one-iteration
twin is test_torch_gt_grid_twin.py (one JAX loop per file: each compiles a
whole step_segment).
"""

import os
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

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
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, NetParams,
                                         PlannerParams, SimParams,
                                         WorldParams)
from neoplanner_tpu_torch.core.types import BoxWorld, DroneState
from neoplanner_tpu_torch.learn import weights
from neoplanner_tpu_torch.models import planner_net
from neoplanner_tpu_torch.sim import env
from neoplanner_tpu_torch.world import scenegen
from tests.test_torch_env import _flax_variables, _jax_draws, plan_costs
from tests.test_torch_imports import one_torch_thread  # noqa: F401
from tests.test_torch_vision_env import _check_flags, _nearest_acceptance

B = 8
SEGMENTS = 3
PP = dict(max_iters=12, samples_per_piece=8, retry_num=2,
          extra_lateral_scales=(), max_ls=4)
MAPP = dict(width=256, height=192, origin_x=-4.0, origin_y=-9.6)
CAM = dict(width=160, height=120)
NET = dict(img_width=160, img_height=120, backbone="smallconv")
ONNX = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                    "planner_net_smallconv.onnx")
GT_GRID = dict(sensing="gt", plan_map="grid")


def _t(a):
    return torch.from_numpy(np.array(a))


def to_port_state(js, pp: PlannerParams, mapp: MapParams):
    """A batched JAX gt+grid EnvState as the port's EnvState (the port's
    reset, then every field, the map's planes included, from JAX)."""
    w = js.world
    world = BoxWorld(centers=_t(w.centers), half_sizes=_t(w.half_sizes),
                     active=_t(w.active), shape=_t(w.shape))
    st = env.reset(world, pp, MissionParams(), mapp, torch.Generator(),
                   goal=_t(js.goal), **GT_GRID)
    d = js.drone
    fields = dict(
        drone=DroneState(pos=_t(d.pos), vel=_t(d.vel), quat=_t(d.quat),
                         yaw=_t(d.yaw)),
        emap=st.emap.replace(**{f: _t(getattr(js.emap, f)) for f in
                                ("esdf", "occupancy", "grad_x",
                                 "grad_y")}))
    for name in ("buffer", "goal", "phase", "near_goal", "reached", "failed",
                 "fail_count", "steps", "flap", "metric_pos", "metrics",
                 "carry_wpts", "carry_ts", "has_carry", "plan_count",
                 "iter_sum", "missions_done", "missions_ok",
                 "metric_ok_sum"):
        fields[name] = _t(getattr(js, name))
    return st, st.replace(**fields)


def _reset_jax(jpp, jmp, jmapp):
    worlds = jscenegen.generate_batch(jax.random.PRNGKey(0), B,
                                      JWorldParams(num_boxes=10))
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    rng = np.random.default_rng(2)
    goals = np.stack([np.array([20.0] * 4 + [0.0] * 2 + [0.7] * 2),
                      rng.uniform(-1.5, 1.5, B)], -1).astype(np.float32)
    goals[4:6, 1] = 0.1
    return jax.vmap(lambda k, w, g: jenv.reset(
        k, w, g, jpp, jmp, jmapp, **GT_GRID))(keys, worlds,
                                              jnp.asarray(goals))


def _run_loop(max_iters):
    jpp = JPlannerParams(**dict(PP, max_iters=max_iters))
    pp = PlannerParams(**dict(PP, max_iters=max_iters),
                       kernel_window_cells=256)
    jmp, jsp, jmapp = JMissionParams(), JSimParams(), JMapParams(**MAPP)
    mapp = MapParams(**MAPP)
    sd = weights.from_onnx(ONNX)
    js = _reset_jax(jpp, jmp, jmapp)
    seg = partial(jenv.step_segment, pp=jpp, mp=jmp, sp=jsp,
                  mission_mode="random", mapp=jmapp, cam=JCameraParams(**CAM),
                  planner="neo", net_vars=_flax_variables(sd),
                  np_cfg=JNetParams(**NET), **GT_GRID)
    step = jax.jit(jax.vmap(seg))
    net = planner_net.PlannerNet(NetParams(**NET))
    net.load_state_dict(sd)
    net.eval()
    reset, st = to_port_state(js, pp, mapp)
    out = [(js, reset)]
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jexpert, "costs_mod", _nearest_acceptance())
        for _ in range(SEGMENTS):
            draws = _jax_draws(js.key, jpp)
            js, jinfo = step(js)
            st, info = env.step_segment(
                st, pp, MissionParams(), SimParams(), CameraParams(**CAM),
                net, draws=draws)
            out.append((js, jinfo, st, info))
    return out


@pytest.fixture(scope="module")
def runs():
    return _run_loop(PP["max_iters"])


def test_reset_builds_the_reference_map(runs):
    """The port's reset rasterizes each world and builds the same exact
    full-profile ESDF as the JAX reset; no log-odds grid."""
    js, reset = runs[0]
    assert reset.logodds is None and reset.mapp is None
    assert not reset.emap.lite and reset.emap.esdf.dtype == torch.float32
    for f in ("esdf", "occupancy", "grad_x", "grad_y"):
        np.testing.assert_array_equal(getattr(reset.emap, f).numpy(),
                                      np.asarray(getattr(js.emap, f)),
                                      err_msg=f)
    assert float(reset.emap.esdf.min()) == 0.0


@pytest.mark.parametrize("seg", range(SEGMENTS))
def test_segment_state_matches(runs, seg):
    """The 12-iteration loop: exact flags and counts, accepted plans in the
    solver's cost basin (5e-3) on the ground-truth map."""
    js, jinfo, st, info = runs[seg + 1]
    _check_flags(js, jinfo, st, info)
    jpp = JPlannerParams(**PP)
    ok = np.asarray(jinfo.ok)
    f_port = plan_costs(js.emap, jinfo, info.int_wpts.numpy(),
                        info.ts.numpy(), jpp)
    f_jax = plan_costs(js.emap, jinfo, jinfo.int_wpts, jinfo.ts, jpp)
    np.testing.assert_allclose(f_port[ok], f_jax[ok], rtol=5e-3, atol=5e-3)


def check_moves(loop):
    """Not a vacuous match: drones moved, plans were accepted in every
    segment and missions ended."""
    _, _, st, _ = loop[-1]
    assert float(np.abs(st.drone.pos[:, :2].numpy()).max()) > 0.5
    assert int(st.plan_count.sum()) > B
    assert all(bool(r[3].ok.any()) for r in loop[1:])
    assert int(st.missions_done.sum()) >= 1


def test_loop_plans_and_moves(runs):
    check_moves(runs)


def test_rollout_from_generator_on_cpu():
    """The port's own entry points end to end on the CPU: worlds and draws
    from a seeded torch.Generator, a gt+grid reset and two segments."""
    pp = PlannerParams(max_iters=4, samples_per_piece=6, retry_num=2,
                       extra_lateral_scales=(), max_ls=2)
    mapp = MapParams(**MAPP)
    gen = _cuda.make_generator(0, "cpu")
    worlds = scenegen.generate_batch(gen, 3, WorldParams(num_boxes=10))
    net = planner_net.load(ONNX, NetParams(**NET), "cpu")
    st = env.reset(worlds, pp, MissionParams(), mapp, gen, **GT_GRID)
    assert st.emap.esdf.shape == (3, 192, 256) and st.logodds is None
    st = env.rollout(st, 2, pp, MissionParams(), SimParams(),
                     CameraParams(**CAM), net)
    assert int(st.plan_count.min()) >= 1
    for t in (st.drone.pos, st.drone.quat, st.buffer, st.metrics):
        assert bool(torch.isfinite(t).all())
