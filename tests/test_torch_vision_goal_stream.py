"""The sensor-rate vision loop with a goal stream against the JAX package,
as a one-iteration twin of 2 segments at B=8 with fuse_frames=3 and frames
fused at row stride 4 in one multi-frame pass: each env's goal is replaced
at the start of every tracking chunk (the goal topic of the reference's
tracker). The stream brings half the envs' goals within reach in the last
chunk.

Both sides get the JAX draws; the tolerances are the one-iteration twin's
of test_torch_vision_env.py (exact flags and counts, state, buffer and
metrics within 1e-4, log-odds within one update quantum on at most 1e-3 of
the updated cells, the ESDF equal where the occupancies agree). The port's
own rollout with fuse_frames and the chunking errors are checked on the
CPU without the JAX package.
"""

import numpy as np
import pytest
import torch

from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, NetParams,
                                         PlannerParams, SimParams,
                                         WorldParams)
from neoplanner_tpu_torch.models import planner_net
from neoplanner_tpu_torch.sim import env
from neoplanner_tpu_torch.world import scenegen
from tests.test_torch_imports import one_torch_thread  # noqa: F401
from tests.test_torch_vision_env import (B, CAM, MAPP, NET, ONNX, VISION,
                                         _run_loop, check_twin)

SEGMENTS = 2
MAPP_SR = dict(MAPP, fusion_row_stride=4)


def _goal_streams():
    """(B, 3, 2) per segment: envs 0-3 keep flying to x = 20 on a swaying
    line; envs 4-7 get goals that come toward the start, within reach in
    the last chunk."""
    out = []
    for s in range(SEGMENTS):
        c = np.arange(3)[None, :]
        x = np.where(np.arange(B)[:, None] < 4, 20.0,
                     np.array([[0.6, 0.4, 0.1]]))
        y = np.broadcast_to(0.3 * c - 0.3 + 0.1 * s, (B, 3))
        y = np.where(np.arange(B)[:, None] < 4, y, 0.05)
        out.append(np.stack([x, y], -1).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def stream_runs():
    return _run_loop(1, MAPP_SR, SEGMENTS, goal_streams=_goal_streams(),
                     fuse_frames=3)


@pytest.mark.parametrize("seg", range(SEGMENTS))
def test_goal_stream_matches(stream_runs, seg):
    check_twin(*stream_runs[seg], MapParams(**MAPP_SR))


def test_goal_stream_moves_goals_and_ends_missions(stream_runs):
    """Not a vacuous match: the envs still flying to x = 20 hold the last
    chunk's streamed goal, and streamed goals within reach end missions."""
    _, _, st, _ = stream_runs[-1]
    last = _goal_streams()[-1][:, -1]
    np.testing.assert_allclose(st.goal.numpy()[:4], last[:4], atol=1e-6)
    assert int(st.missions_done[4:].sum()) >= 1


def test_rollout_and_chunking_errors_on_cpu():
    """rollout(fuse_frames=...) on the port's own entry points, and the
    reference's errors (sim/env.py step_segment :574-585) before any work:
    a goal stream of another length than fuse_frames, esdf_rate without
    chunks, chunks that do not divide the segment."""
    pp = PlannerParams(max_iters=2, samples_per_piece=6, retry_num=2,
                       extra_lateral_scales=(), max_ls=2)
    mp, sp, cam = MissionParams(), SimParams(), CameraParams(**CAM)
    gen = _cuda.make_generator(0, "cpu")
    worlds = scenegen.generate_batch(gen, 2, WorldParams(num_boxes=10))
    net = planner_net.load(ONNX, NetParams(**NET), "cpu")
    st = env.reset(worlds, pp, mp, MapParams(**MAPP_SR), gen, **VISION)
    one = env.rollout(st, 1, pp, mp, sp, cam, net)
    three = env.rollout(st, 1, pp, mp, sp, cam, net, fuse_frames=3)
    # the hovering drones' two more frames carve and hit the same cells
    # again
    assert int((three.logodds < one.logodds).sum()) > 1000
    assert int((three.logodds > one.logodds).sum()) > 10
    assert bool(torch.isfinite(three.drone.pos).all())
    cases = ((dict(fuse_frames=3, goal_stream=torch.zeros(2, 2, 2)),
              "goal_stream length 2 must equal fuse_frames=3"),
             (dict(esdf_rate=2), "esdf_rate > 1 requires fuse_frames"),
             (dict(fuse_frames=7), "7 chunks must divide"))
    for kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            env.step_segment(st, pp, mp, sp, cam, net, **kw)
