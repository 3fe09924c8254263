"""The env's mission and replan modes and the takeoff phase of the PyTorch
port against the JAX package: reset with start positions, takeoff and a
goal tour, and two one-iteration twins of sim/env.step_segment on the scene
path with the expert planner at B = 8 (max_iters=1, where both frameworks
take the same step from the same gradient):

1. predefined missions with online replans, half of the envs taking off
   from z = 0 (7 segments: they reach hover height and start their tours);
2. manual missions with global replans (4 segments).

Both sides start from the same JAX reset state; the JAX draws of every
segment are passed to the port (tests/test_torch_env.py). Flags, counters,
phases, goals and tour cursors are held exactly, the drone state and the
segment's target within 1e-4.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import MapParams as JMapParams
from neoplanner_tpu.config import MissionParams as JMissionParams
from neoplanner_tpu.config import PlannerParams as JPlannerParams
from neoplanner_tpu.config import SimParams as JSimParams
from neoplanner_tpu.config import WorldParams as JWorldParams
from neoplanner_tpu.sim import env as jenv
from neoplanner_tpu.world import scenegen as jscenegen
from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, PlannerParams,
                                         SimParams)
from neoplanner_tpu_torch.core.types import BoxWorld
from neoplanner_tpu_torch.sim import env, missions
from tests.test_torch_env import _jax_draws
from tests.test_torch_track import to_port_state
from tests.test_torch_imports import one_torch_thread  # noqa: F401

B = 8
PP = dict(max_iters=1, samples_per_piece=8, retry_num=2,
          extra_lateral_scales=(), max_ls=4)
MAPP = dict(width=256, height=192, origin_x=-4.0, origin_y=-9.6)
# goal tours (B, 3, 2): tours within reach of the start complete in a few
# segments and park the env; the others fly toward goals metres away
TOURS = np.array([[[0.1, 0.0], [0.3, 0.1], [0.5, 0.0]],
                  [[3.0, 0.0], [6.0, 0.5], [8.0, 0.0]],
                  [[0.05, 0.0], [0.1, 0.05], [0.0, 0.1]],
                  [[1.5, -0.5], [2.0, 0.0], [0.0, 0.0]]] * 2, np.float32)
# manual missions: two goals reached at once, the rest metres away
GOALS = np.array([[0.1, 0.0], [0.0, 0.12], [3.0, 0.0], [6.0, 0.0],
                  [8.0, 1.0], [12.0, -1.0], [4.0, 2.0], [20.0, 0.0]],
                 np.float32)
FIELDS = ("phase", "goal", "goal_idx", "near_goal", "reached", "failed",
          "fail_count", "steps", "plan_count", "missions_done",
          "missions_ok")


def _t(a):
    return torch.from_numpy(np.array(a))


def _worlds():
    return jscenegen.generate_batch(jax.random.PRNGKey(0), B,
                                    JWorldParams(num_boxes=10))


def _concat(a, b):
    return jax.tree_util.tree_map(lambda x, y: jnp.concatenate([x, y]), a, b)


def _twin(mission_mode, replan_mode, states, segments):
    jpp, pp = JPlannerParams(**PP), PlannerParams(**PP)
    step = jax.jit(jax.vmap(partial(
        jenv.step_segment, pp=jpp, mp=JMissionParams(), sp=JSimParams(),
        mission_mode=mission_mode, planner="expert", plan_map="scene",
        replan_mode=replan_mode)))
    js = states
    st = to_port_state(js, pp, MapParams(**MAPP)).replace(
        goal_list=_t(js.goal_list), goal_idx=_t(js.goal_idx))
    out = []
    for _ in range(segments):
        draws = _jax_draws(js.key, jpp)
        js, jinfo = step(js)
        st, info = env.step_segment(
            st, pp, MissionParams(), SimParams(), CameraParams(),
            draws=draws, planner="expert", mission_mode=mission_mode,
            replan_mode=replan_mode)
        out.append((js, jinfo, st, info))
    return out


@pytest.fixture(scope="module")
def predefined_online():
    """Tours, online replans; envs 4-7 take off from the ground."""
    jpp, jmp, jmapp = JPlannerParams(**PP), JMissionParams(), \
        JMapParams(**MAPP)
    worlds = _worlds()
    keys = jax.random.split(jax.random.PRNGKey(1), B)

    def reset(skip):
        return jax.vmap(lambda k, w, gl: jenv.reset(
            k, w, None, jpp, jmp, jmapp, skip_takeoff=skip,
            plan_map="scene", goal_list=gl))
    half = B // 2
    sl = jax.tree_util.tree_map(lambda x: x[:half], worlds)
    sh = jax.tree_util.tree_map(lambda x: x[half:], worlds)
    js = _concat(reset(True)(keys[:half], sl, TOURS[:half]),
                 reset(False)(keys[half:], sh, TOURS[half:]))
    return _twin("predefined", "online", js, 7)


@pytest.fixture(scope="module")
def manual_global():
    jpp, jmp, jmapp = JPlannerParams(**PP), JMissionParams(), \
        JMapParams(**MAPP)
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    js = jax.vmap(lambda k, w, g: jenv.reset(
        k, w, g, jpp, jmp, jmapp, plan_map="scene"))(
            keys, _worlds(), jnp.asarray(GOALS))
    return _twin("manual", "global", js, 4)


def _check(js, jinfo, st, info):
    np.testing.assert_array_equal(info.planned.numpy(),
                                  np.asarray(jinfo.planned))
    np.testing.assert_array_equal(info.ok.numpy(), np.asarray(jinfo.ok))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    for f in ("pos", "vel", "quat"):
        np.testing.assert_allclose(getattr(st.drone, f).numpy(),
                                   np.asarray(getattr(js.drone, f)),
                                   atol=1e-4, err_msg=f)
    np.testing.assert_allclose(info.target.numpy(), np.asarray(jinfo.target),
                               atol=1e-4)
    np.testing.assert_allclose(info.plan_init.numpy(),
                               np.asarray(jinfo.plan_init), atol=1e-4)


@pytest.mark.parametrize("seg", range(7))
def test_predefined_online_twin(predefined_online, seg):
    _check(*predefined_online[seg])


@pytest.mark.parametrize("seg", range(4))
def test_manual_global_twin(manual_global, seg):
    _check(*manual_global[seg])


def test_twins_exercise_the_modes(predefined_online, manual_global):
    """Not vacuous: takeoffs end, tours advance and park, online replans
    continue near the goal, global targets are the goals, manual parks."""
    phases = [r[2].phase.numpy() for r in predefined_online]
    assert (phases[0][B // 2:] == missions.PHASE_TAKEOFF).all()
    assert (phases[-1][B // 2:] != missions.PHASE_TAKEOFF).all()
    st = predefined_online[-1][2]
    assert int(st.goal_idx.max()) == 3 and int(st.goal_idx.min()) == 1
    assert (st.phase.numpy() == missions.PHASE_DONE).any()
    assert int(st.missions_done.max()) == 3     # a parked tour counts once
    near_planned = [bool((r[3].planned & r[2].near_goal).any())
                    for r in predefined_online]
    assert any(near_planned)
    first = manual_global[0]
    np.testing.assert_allclose(first[3].target[:, 0].numpy(), GOALS)
    st = manual_global[-1][2]
    assert (st.phase.numpy() == missions.PHASE_DONE).sum() >= 2
    assert int(st.plan_count.min()) >= 1


def test_reset_matches_jax():
    """reset with start positions, takeoff and a goal tour: the drone on
    the ground at its start, the takeoff phase, entry 0 as the goal and the
    cursor at 1, the buffer holding the start."""
    jpp, jmp, jmapp = JPlannerParams(**PP), JMissionParams(), \
        JMapParams(**MAPP)
    worlds = _worlds()
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    start = np.random.default_rng(4).uniform(-1, 1, (B, 2)).astype(
        np.float32)
    js = jax.vmap(lambda k, w, s, gl: jenv.reset(
        k, w, None, jpp, jmp, jmapp, start_pos=s, skip_takeoff=False,
        plan_map="scene", goal_list=gl))(keys, worlds, start, TOURS)
    w = BoxWorld(centers=_t(worlds.centers), half_sizes=_t(worlds.half_sizes),
                 active=_t(worlds.active), shape=_t(worlds.shape))
    st = env.reset(w, PlannerParams(**PP), MissionParams(),
                   MapParams(**MAPP), torch.Generator(), start_pos=_t(start),
                   skip_takeoff=False, goal_list=_t(TOURS))
    for f in FIELDS + ("goal_list", "buffer", "metric_pos", "flap"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    for f in ("pos", "vel", "quat", "yaw"):
        np.testing.assert_array_equal(getattr(st.drone, f).numpy(),
                                      np.asarray(getattr(js.drone, f)),
                                      err_msg=f)


def test_unknown_modes_raise():
    st = env.reset(BoxWorld(torch.zeros(1, 2, 3), torch.ones(1, 2, 3),
                            torch.zeros(1, 2, dtype=torch.bool),
                            torch.zeros(1, 2, dtype=torch.int32)),
                   PlannerParams(**PP), MissionParams(), MapParams(**MAPP),
                   torch.Generator(), goal=torch.tensor([[1.0, 0.0]]))
    for kw, name in ((dict(mission_mode="tour"), "mission_mode"),
                     (dict(replan_mode="sometimes"), "replan_mode")):
        with pytest.raises(ValueError, match=name):
            env.step_segment(st, PlannerParams(**PP), MissionParams(),
                             SimParams(), CameraParams(), planner="expert",
                             **kw)
