"""The one-iteration twin of the ground-truth grid loop of
test_torch_gt_grid_env.py: the same 3 segments at B=8 with one L-BFGS
iteration per solve, against the JAX package.

One iteration takes the same step on both sides, so besides the exact
flags, goals, mission flags and counts, the drone state, the setpoint
buffer and the metrics are held elementwise within 1e-4 (as
test_torch_vision_env.py's twin).
"""

import numpy as np
import pytest

from tests.test_torch_gt_grid_env import SEGMENTS, _run_loop, check_moves
from tests.test_torch_imports import one_torch_thread  # noqa: F401
from tests.test_torch_vision_env import _check_flags


@pytest.fixture(scope="module")
def runs_one_iter():
    return _run_loop(1)


@pytest.mark.parametrize("seg", range(SEGMENTS))
def test_segment_one_iteration_matches(runs_one_iter, seg):
    js, jinfo, st, info = runs_one_iter[seg + 1]
    _check_flags(js, jinfo, st, info)
    for f in ("pos", "vel", "quat"):
        np.testing.assert_allclose(getattr(st.drone, f).numpy(),
                                   np.asarray(getattr(js.drone, f)),
                                   atol=1e-4, err_msg=f)
    np.testing.assert_allclose(st.buffer.numpy(), np.asarray(js.buffer),
                               atol=1e-4)
    np.testing.assert_allclose(st.metrics.numpy(), np.asarray(js.metrics),
                               rtol=1e-4, atol=1e-4)


def test_twin_plans_and_moves(runs_one_iter):
    check_moves(runs_one_iter)
