"""The port's takeoff phase and mission and replan modes, run on the CPU
plain forms: mirrors of tests/test_env.py::test_takeoff_phase and
::test_predefined_mission_mode and of tests/test_replan_modes.py's five
tests, on their world (scenegen.generate(PRNGKey(7)), 10 boxes, converted
from the JAX package) and their path (the ground-truth grid, the JAX
reset's default), with the expert planner. The planner is leaner than the
goldens' (12 iterations, 8 samples a piece): each segment plans on the CPU
in plain PyTorch; the modes' logic under test is the same.
"""

import numpy as np
import jax
import pytest
import torch

from neoplanner_tpu.config import WorldParams as JWorldParams
from neoplanner_tpu.world import scenegen as jscenegen
from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, PlannerParams,
                                         SimParams)
from neoplanner_tpu_torch.core.types import BoxWorld
from neoplanner_tpu_torch.sim import env, missions
from tests.test_torch_imports import one_torch_thread  # noqa: F401

PP = PlannerParams(max_iters=12, samples_per_piece=8, retry_num=2,
                   extra_lateral_scales=(), max_ls=4)
MP, SP, CAM = MissionParams(), SimParams(), CameraParams()
MAPP = MapParams(width=256, height=192, origin_x=-4.0, origin_y=-9.6)


@pytest.fixture(scope="module")
def world():
    w = jscenegen.generate(jax.random.PRNGKey(7), JWorldParams(num_boxes=10))

    def t(a):
        return torch.from_numpy(np.array(a))[None]
    return BoxWorld(centers=t(w.centers), half_sizes=t(w.half_sizes),
                    active=t(w.active), shape=t(w.shape))


def _reset(world, goals=None, **kw):
    n = 1 if goals is None else len(goals)
    w = BoxWorld(*(getattr(world, f).expand((n,) + getattr(world, f).shape[1:])
                   .contiguous() for f in ("centers", "half_sizes", "active",
                                           "shape")))
    return env.reset(w, PP, MP, MAPP, torch.Generator().manual_seed(0),
                     goal=None if goals is None else torch.tensor(goals),
                     plan_map="grid", **kw)


def _step(state, mission_mode="manual", **kw):
    return env.step_segment(state, PP, MP, SP, CAM, planner="expert",
                            mission_mode=mission_mode, **kw)


def test_takeoff_phase(world):
    state = _reset(world, [[6.0, 0.0]], skip_takeoff=False)
    assert int(state.phase[0]) == missions.PHASE_TAKEOFF
    assert float(state.drone.pos[0, 2]) == 0.0
    for _ in range(20):
        state, _ = _step(state)
        if bool(state.reached[0]):
            break
    assert float(state.drone.pos[0, 2]) > MP.hover_height - 0.3
    assert bool(state.reached[0])


def test_predefined_mission_mode(world):
    tour = torch.tensor([[[6.0, 0.0], [10.0, 0.0], [5.0, -3.0]]])
    state = _reset(world, goal_list=tour)
    np.testing.assert_array_equal(state.goal.numpy(), tour[:, 0].numpy())
    assert int(state.goal_idx[0]) == 1
    for _ in range(60):
        state, _ = _step(state, "predefined")
        if int(state.phase[0]) == missions.PHASE_DONE:
            break
    assert int(state.phase[0]) == missions.PHASE_DONE
    assert int(state.missions_done[0]) == 3
    assert int(state.missions_ok[0]) == 3
    np.testing.assert_array_equal(state.goal.numpy(), tour[:, -1].numpy())
    state, _ = _step(state, "predefined")
    assert int(state.missions_done[0]) == 3


def test_global_plans_exactly_once(world):
    """global: one plan, at the goal itself with zero velocity, and the
    mission completes on it."""
    state = _reset(world, [[8.0, 0.0]])
    infos = []
    for _ in range(12):
        state, info = _step(state, replan_mode="global")
        infos.append(info)
    assert int(state.plan_count[0]) == 1
    np.testing.assert_allclose(infos[0].target[0].numpy(),
                               [[8.0, 0.0], [0.0, 0.0]])
    assert bool(state.reached[0])


def test_online_replans_until_reached(world):
    """online replans every segment, also once the local target is the
    goal (goal 4.5 m, inside longitu_step_dis: 3 plans in 3 segments),
    and stops once the goal is reached (goal 3 m, within 10 segments)."""
    state = _reset(world, [[4.5, 0.0], [3.0, 0.0]])
    for seg in range(10):
        state, _ = _step(state, replan_mode="online")
        if seg == 2:
            assert not bool(state.reached[0])
            assert int(state.plan_count[0]) == 3
    assert bool(state.reached[1])
    assert int(state.plan_count[1]) < 10


@pytest.mark.parametrize("replan_mode", ["periodic", None])
def test_periodic_stops_near_goal(world, replan_mode):
    """periodic (also the default): the near-goal gate stops replanning
    after the first plan."""
    kw = {} if replan_mode is None else dict(replan_mode=replan_mode)
    state = _reset(world, [[4.5, 0.0]])
    for _ in range(3):
        state, _ = _step(state, **kw)
    assert not bool(state.reached[0])
    assert int(state.plan_count[0]) == 1
