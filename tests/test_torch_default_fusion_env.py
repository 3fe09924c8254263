"""The vision loop of the PyTorch port with the reference's default map
settings, against the JAX package: the '2d' scatter fusion and an exact
lite ESDF (MapParams' fusion='2d', edt_truncation=0), 3 segments of
sim/env.step_segment at B=8 with one L-BFGS iteration per solve (the
one-iteration twin of test_torch_vision_env.py's loop, on its 256 x 192
map and with its construction and acceptance rule), and the choice between
the batched and the per-frame sensor-rate fusion.

Tolerances: exact plan flags, goals, mission flags and counts; drone
state, buffer and metrics within 1e-4; the log-odds within 1e-5 where the
'2d' fusion's cells agree (the scatter sums the same adds in another
order), with at most 1e-3 of the updated cells off, each by whole
l_miss/l_hit quanta (a carve sample or a hit on a cell edge can fall
either way under the polar reduction's roundoff); the exact lite ESDF equal
to JAX's (bf16, 9984 where nothing is occupied) wherever no occupancy
differs within the field's own distance of the cell.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, NetParams,
                                         PlannerParams, SimParams,
                                         WorldParams)
from neoplanner_tpu_torch.mapping import occupancy
from neoplanner_tpu_torch.models import planner_net
from neoplanner_tpu_torch.sim import env
from neoplanner_tpu_torch.world import scenegen
from tests import test_torch_vision_env as vision
from tests.test_torch_imports import one_torch_thread  # noqa: F401

MAPP = dict(vision.MAPP, edt_truncation=0.0, fusion="2d")


@pytest.fixture(scope="module")
def runs_one_iter():
    return vision._run_loop(1, mapp_kw=MAPP)


@pytest.mark.parametrize("seg", range(vision.SEGMENTS))
def test_segment_one_iteration_matches(runs_one_iter, seg):
    js, jinfo, st, info = runs_one_iter[seg]
    vision._check_flags(js, jinfo, st, info)
    for f in ("pos", "vel", "quat"):
        np.testing.assert_allclose(getattr(st.drone, f).numpy(),
                                   np.asarray(getattr(js.drone, f)),
                                   atol=1e-4, err_msg=f)
    np.testing.assert_allclose(st.buffer.numpy(), np.asarray(js.buffer),
                               atol=1e-4)
    np.testing.assert_allclose(st.metrics.numpy(), np.asarray(js.metrics),
                               rtol=1e-4, atol=1e-4)
    mp = MapParams(**MAPP)
    got, want = st.logodds.numpy(), np.asarray(js.logodds)
    diff = np.abs(got - want)
    off = diff > 1e-5
    quanta = np.abs(np.float32([occupancy._l(mp.prob_miss),
                                occupancy._l(mp.prob_hit)]))
    # whole quanta: k l_miss + m l_hit for small k, m (a cell's carve
    # samples can fall on either side of its edge more than once)
    combos = np.array([a * quanta[0] + b * quanta[1] for a in range(4)
                       for b in range(2)][1:], np.float32)
    assert np.isclose(diff[off][:, None], combos[None], atol=1e-4).any(
        1).all()
    assert int(off.sum()) <= 1e-3 * int((want != 0).sum())
    field = st.emap.esdf.float().numpy()
    jfield = np.asarray(js.emap.esdf.astype(jnp.float32))
    assert st.emap.esdf.dtype == torch.bfloat16 and st.emap.lite
    thr = occupancy.occ_threshold(mp)
    occ_off = np.argwhere((got > thr) != (want > thr))
    rows, cols = np.mgrid[:mp.height, :mp.width]
    near = np.zeros_like(field, dtype=bool)
    for e, r, c in occ_off:    # cells whose nearest obstacle may differ
        reach = np.maximum(field[e], jfield[e]) + 0.2
        near[e] |= np.hypot(rows - r, cols - c) * mp.resolution <= reach
    np.testing.assert_array_equal(field[~near], jfield[~near])


def test_loop_senses_exactly(runs_one_iter):
    """Not a vacuous match: obstacles sensed, space carved, the exact
    field finite near obstacles and bf16's FAR where a map is empty."""
    js, _, st, _ = runs_one_iter[-1]
    assert int((st.logodds < 0).sum()) > 1000
    assert float(st.emap.esdf.float().min()) == 0.0
    assert float(st.emap.esdf.float().max()) <= 9984.0
    assert float(np.abs(st.drone.pos[:, :2].numpy()).max()) > 0.5
    assert int(st.plan_count.sum()) > vision.B


@pytest.mark.parametrize("mapp_kw, batched", [
    (dict(width=120, height=96, origin_x=-2.0, origin_y=-4.8), False),
    (dict(width=128, height=96, origin_x=-2.0, origin_y=-4.8), True)])
def test_sensor_rate_fusion_batches_only_whole_grid_maps(monkeypatch,
                                                         mapp_kw, batched):
    """With fuse_frames=3 and one rebuild per segment, the mid-segment
    frames are fused in one batched pass only where the reference batches
    them (a '2d_dense' map with W % 128 == 0 and H % 8 == 0 whose window
    fits); a 120 x 96 map takes the per-frame chain (B8 v1 frame by frame),
    as the reference's batch_fuse condition (env.py :596-601) says."""
    calls = {"frame": 0, "multi": 0}
    fuse_frame, fuse_multi = env.fuse_frame, env.fuse_frames_multi

    def frame(*a, **k):
        calls["frame"] += 1
        return fuse_frame(*a, **k)

    def multi(*a, **k):
        calls["multi"] += 1
        return fuse_multi(*a, **k)

    monkeypatch.setattr(env, "fuse_frame", frame)
    monkeypatch.setattr(env, "fuse_frames_multi", multi)
    pp = PlannerParams(max_iters=1, samples_per_piece=6, retry_num=1,
                       extra_lateral_scales=(), max_ls=2)
    mapp = MapParams(**mapp_kw, fusion="2d_dense")
    gen = _cuda.make_generator(1, "cpu")
    worlds = scenegen.generate_batch(gen, 2, WorldParams(num_boxes=8))
    worlds = worlds.replace(centers=worlds.centers - torch.tensor(
        [3.0, 0.0, 0.0]))
    net = planner_net.load(vision.ONNX, NetParams(**vision.NET), "cpu")
    st = env.reset(worlds, pp, MissionParams(), mapp, gen,
                   goal=torch.tensor([[6.0, 0.0], [6.0, 1.0]]),
                   **vision.VISION)
    st, _ = env.step_segment(st, pp, MissionParams(), SimParams(),
                             CameraParams(**vision.CAM), net, fuse_frames=3)
    # the replan-time frame, then two mid-segment frames
    assert calls == ({"frame": 1, "multi": 1} if batched
                     else {"frame": 3, "multi": 0})
    assert int((st.logodds < 0).sum()) > 500
