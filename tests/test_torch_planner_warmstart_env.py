"""The closed loop with planner='warmstart' on the scene path (ground-truth
sensing, the scene SDF) against the JAX package: 3 segments of
sim/env.step_segment at B=8 against JAX step_segment, with the loop and the
tolerances of test_torch_planner_env.py: the 12-iteration loop by exact
flags and the cost basin (5e-3), its one-iteration twin elementwise (1e-4).
Lane 0 of each bank holds the solution carried from the last accepted plan.
"""

import pytest

from tests.test_torch_imports import one_torch_thread  # noqa: F401
from tests.test_torch_env import PP
from tests.test_torch_planner_env import (SEGMENTS, check_basin,
                                          check_elementwise, check_moves,
                                          run_loop)


@pytest.fixture(scope="module")
def runs():
    return run_loop("warmstart", "scene", PP["max_iters"])


@pytest.fixture(scope="module")
def runs_one_iter():
    return run_loop("warmstart", "scene", 1)


@pytest.mark.parametrize("seg", range(SEGMENTS))
def test_segment_state_matches(runs, seg):
    check_basin(runs[seg])


@pytest.mark.parametrize("seg", range(SEGMENTS))
def test_segment_one_iteration_matches(runs_one_iter, seg):
    check_elementwise(runs_one_iter[seg])


def test_loop_plans_and_moves(runs, runs_one_iter):
    check_moves(runs)
    check_moves(runs_one_iter)
