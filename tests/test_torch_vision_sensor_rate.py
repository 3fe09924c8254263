"""The sensor-rate vision loop of the PyTorch port against the JAX package:
3 segments of sim/env.step_segment at B=8 with fuse_frames=3 and frames
fused at mapp.fusion_row_stride=4, as examples/profile_vision.py runs it
(there with 6 frames), with 12 solver iterations; its one-iteration twin
is test_torch_vision_sensor_twin.py. The replan-time frame is fused at
full resolution; the segment is tracked in 3 chunks of 20 substeps from
their offsets, and the frames from the poses after the first two chunks
are rendered in one call and fused in one multi-frame pass (kernel B8
v3's plain version on the port's side, the v3 TPU kernel in interpret mode
on the JAX side).

Setup, draws, the net and the acceptance rule are those of
test_torch_vision_env.py, and so are the tolerances: the 12-iteration loop
by exact plan flags, goals, mission flags and counts and each accepted
plan in the solver's cost basin (5e-3). The grid tracker is also held
from substep 30 against the JAX scan tracker, and in six chunks of 10
against one unchunked segment: the drone exactly, the metrics to 1e-6 relative (the
grid collision term is summed per chunk, then across chunks).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import MissionParams as JMissionParams
from neoplanner_tpu.config import PlannerParams as JPlannerParams
from neoplanner_tpu.config import SimParams as JSimParams
from neoplanner_tpu.mapping import esdf as jesdf
from neoplanner_tpu.sim import env as jenv
from neoplanner_tpu_torch.config import (MapParams, MissionParams,
                                         PlannerParams, SimParams)
from neoplanner_tpu_torch.sim import track
from tests.test_torch_env import plan_costs
from tests.test_torch_imports import one_torch_thread  # noqa: F401
from tests.test_torch_vision_env import (MAPP, PP, _check_flags, _run_loop,
                                         _t, _vision_states, to_port_state)

SEGMENTS = 3
MAPP_SR = dict(MAPP, fusion_row_stride=4)
SENSOR_RATE = dict(fuse_frames=3)


@pytest.fixture(scope="module")
def runs():
    return _run_loop(PP["max_iters"], MAPP_SR, SEGMENTS, **SENSOR_RATE)


@pytest.mark.parametrize("seg", range(SEGMENTS))
def test_sensor_rate_segment_matches(runs, seg):
    js, jinfo, st, info = runs[seg]
    _check_flags(js, jinfo, st, info)
    jpp = JPlannerParams(**PP)
    ok = np.asarray(jinfo.ok)
    f_port = plan_costs(js.emap, jinfo, info.int_wpts.numpy(),
                        info.ts.numpy(), jpp)
    f_jax = plan_costs(js.emap, jinfo, jinfo.int_wpts, jinfo.ts, jpp)
    np.testing.assert_allclose(f_port[ok], f_jax[ok], rtol=5e-3, atol=5e-3)


def _grid_tracking_inputs(n=4):
    js = _vision_states(n, (20.0, 0.0))
    occ = np.zeros((n, 192, 256), np.float32)
    occ[:, 96:103, 77:84] = 1.0
    js = js.replace(emap=jax.vmap(lambda o: jesdf.build(
        o, jnp.array([MAPP["origin_x"], MAPP["origin_y"]]), 0.1,
        max_dist=2.0, lite=True))(jnp.asarray(occ)))
    t = np.arange(60) / 60.0
    cmds = np.stack([np.stack([
        np.stack([3.0 + v * t, 0.5 * np.sin(3 * t)], -1),
        np.stack([np.full_like(t, v), 1.5 * np.cos(3 * t)], -1),
        np.stack([np.zeros_like(t), -4.5 * np.sin(3 * t)], -1)], 1)
        for v in (0.8, 1.0, 1.2, 1.4)]).astype(np.float32)
    js = js.replace(drone=js.drone.replace(pos=js.drone.pos.at[:, 0].set(
        3.0)))
    return js, cmds


def test_grid_tracking_from_substep_30_matches_scan():
    """B10's plain version plus the grid metric from substep 30 against the
    JAX scan tracker with i0=30 (tolerances of test_torch_vision_env.py's
    grid tracking test); the collision metric is live."""
    js, cmds = _grid_tracking_inputs()
    cmds = cmds[:, :30]
    jpp, jmp, jsp = JPlannerParams(), JMissionParams(), JSimParams()
    want = jax.jit(jax.vmap(lambda s, c: jenv._track_segment(
        s, c, jpp, jmp, jsp, plan_map="grid", i0=30)))(js, jnp.asarray(cmds))
    st = to_port_state(js, PlannerParams(), MapParams(**MAPP))
    got = track.track_segment_grid(st, _t(cmds), PlannerParams(),
                                   MissionParams(), SimParams(), i0=30)
    for g, w in ((got[0].pos, want[0].pos), (got[0].vel, want[0].vel),
                 (got[0].quat, want[0].quat), (got[3], want[3]),
                 (got[4], want[4]), (got[5], want[5])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert float(np.asarray(want[3])[:, 2].min()) > 0.0


def test_grid_tracking_six_chunks_equal_one_segment():
    js, cmds = _grid_tracking_inputs()
    st = to_port_state(js, PlannerParams(), MapParams(**MAPP))
    args = (PlannerParams(), MissionParams(), SimParams())
    whole = track.track_segment_grid(st, _t(cmds), *args)
    for c in range(6):
        drone, reached, steps, metrics, metric_pos, _ = \
            track.track_segment_grid(st, _t(cmds[:, 10 * c:10 * c + 10]),
                                     *args, i0=10 * c)
        st = st.replace(drone=drone, reached=reached, steps=steps,
                        metrics=metrics, metric_pos=metric_pos)
    np.testing.assert_array_equal(st.drone.pos.numpy(), whole[0].pos.numpy())
    np.testing.assert_array_equal(st.steps.numpy(), whole[2].numpy())
    # the grid collision term is summed per chunk, then over chunks
    np.testing.assert_allclose(st.metrics.numpy(), whole[3].numpy(),
                               rtol=1e-6, atol=0)
    assert float(whole[3][:, 2].min()) > 0.0
