"""The sensor-rate vision loop's per-frame chain against the JAX package:
esdf_rate=3, as a one-iteration twin of 2 segments at B=8 with
fuse_frames=3 and frames fused at row stride 4. Each of the first two
tracking chunks ends with a frame rendered and fused on its own (kernel B8
v2's plain version, the v2 TPU kernel in interpret mode on the JAX side)
and an ESDF rebuild, so the grid metric and the next chunk read a
sensor-rate field. (test_torch_vision_sensor_rate.py holds the batched
branch, test_torch_vision_goal_stream.py the goal stream.)

Both sides get the JAX draws; the tolerances are the one-iteration twin's
of test_torch_vision_env.py (exact flags and counts, state, buffer and
metrics within 1e-4, log-odds within one update quantum on at most 1e-3 of
the updated cells, the ESDF equal where the occupancies agree).
"""

import pytest

from neoplanner_tpu_torch.config import MapParams
from tests.test_torch_imports import one_torch_thread  # noqa: F401
from tests.test_torch_vision_env import MAPP, _run_loop, check_twin

SEGMENTS = 2
MAPP_SR = dict(MAPP, fusion_row_stride=4)


@pytest.fixture(scope="module")
def chain_runs():
    return _run_loop(1, MAPP_SR, SEGMENTS, fuse_frames=3, esdf_rate=3)


@pytest.mark.parametrize("seg", range(SEGMENTS))
def test_per_frame_chain_matches(chain_runs, seg):
    check_twin(*chain_runs[seg], MapParams(**MAPP_SR))
