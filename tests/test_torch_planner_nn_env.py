"""The closed loop with planner='nn' on the scene path against the JAX
package: 3 segments of sim/env.step_segment at B=8 against JAX
step_segment, with the loop of test_torch_planner_env.py and the net of
test_torch_env.py (artifacts/planner_net_smallconv.onnx on both sides).

The 'nn' planner runs no solver: the net's prediction is the plan, its
coefficients solved between the boundary states, always accepted. So the
whole loop is held elementwise within 1e-4 (test_torch_net.py's tolerance
of the net) besides the exact flags and counts.
"""

import numpy as np
import pytest

from tests.test_torch_imports import one_torch_thread  # noqa: F401
from tests.test_torch_planner_env import (B, SEGMENTS, check_elementwise,
                                          run_loop)


@pytest.fixture(scope="module")
def runs():
    return run_loop("nn", "scene", 1)


@pytest.mark.parametrize("seg", range(SEGMENTS))
def test_segment_matches(runs, seg):
    check_elementwise(runs[seg])
    _, jinfo, _, info, _ = runs[seg]
    np.testing.assert_array_equal(info.ok.numpy(), info.planned.numpy())
    assert not info.iters.any() and not np.asarray(jinfo.iters).any()


def test_loop_plans_and_moves(runs):
    _, _, st, _, _ = runs[-1]
    assert float(np.abs(st.drone.pos[:, :2].numpy()).max()) > 0.1
    assert int(st.plan_count.sum()) > B
