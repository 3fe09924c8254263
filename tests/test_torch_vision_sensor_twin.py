"""The one-iteration twin of the sensor-rate vision loop
(test_torch_vision_sensor_rate.py): 3 segments of sim/env.step_segment at
B=8 with fuse_frames=3, frames fused at row stride 4 in one multi-frame
pass, one solver iteration, against the JAX package.

Setup, draws, the net and the acceptance rule are those of
test_torch_vision_env.py, and so are the tolerances: exact plan flags,
goals, mission flags and counts; drone state, buffer and metrics within
1e-4 (one iteration takes the same step on both sides); each log-odds cell
equal or off by exactly one l_miss or l_hit quantum on at most 1e-3 of the
updated cells; the ESDF equal wherever the occupancies agree within the
truncation radius.
"""

import numpy as np
import pytest

from neoplanner_tpu_torch.config import MapParams
from tests.test_torch_imports import one_torch_thread  # noqa: F401
from tests.test_torch_vision_env import MAPP, _run_loop, check_twin

SEGMENTS = 3
MAPP_SR = dict(MAPP, fusion_row_stride=4)


@pytest.fixture(scope="module")
def runs_one_iter():
    return _run_loop(1, MAPP_SR, SEGMENTS, fuse_frames=3)


@pytest.mark.parametrize("seg", range(SEGMENTS))
def test_sensor_rate_one_iteration_matches(runs_one_iter, seg):
    check_twin(*runs_one_iter[seg], MapParams(**MAPP_SR))


def test_sensor_rate_loop_fuses_more(runs_one_iter):
    """Not a vacuous match: the mid-segment frames carve and hit cells the
    replan-time frames alone would not, plans are accepted, drones move."""
    _, _, st, info = runs_one_iter[-1]
    assert info.trace.shape[1] == 60
    assert int((st.logodds < 0).sum()) > 1000
    assert float(st.emap.esdf.float().min()) == 0.0
    assert all(bool(r[3].ok.any()) for r in runs_one_iter)
    assert float(np.abs(st.drone.pos[:, :2].numpy()).max()) > 0.5
