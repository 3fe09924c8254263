"""sim/track (one tracking segment) of the PyTorch port against the JAX
package's sim/env._track_segment scan, which tests/test_track_pallas.py
holds against the Pallas tracker.

Both sides run the same per-substep f32 arithmetic (controller, drag,
semi-implicit integration, flatness attitude, 10 Hz metric), so states,
metrics and trace agree to 1e-5 (metrics 1e-4 relative, sums of cubes), and
the reached flags and step counts exactly. A segment started at substep
i0 (the chunks of the sensor-rate loop) is held the same way, and six
chunks of 10 substeps give exactly the unchunked segment.
"""

import re
from pathlib import Path

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
from neoplanner_tpu.sim import missions as jmissions
from neoplanner_tpu.world import scenegen as jscenegen
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import (MapParams, MissionParams,
                                         PlannerParams, SimParams)
from neoplanner_tpu_torch.core.types import BoxWorld, DroneState
from neoplanner_tpu_torch.mapping import scene
from neoplanner_tpu_torch.sim import env, track
from tests.test_torch_imports import one_torch_thread  # noqa: F401

MAPP = dict(width=256, height=192, origin_x=-4.0, origin_y=-9.6)


def _t(a):
    return torch.from_numpy(np.array(a))


def to_port_state(js, pp: PlannerParams, mapp: MapParams, device="cpu"):
    """A batched JAX EnvState (scene-lite) as the port's EnvState."""
    w = js.world
    world = BoxWorld(centers=_t(w.centers), half_sizes=_t(w.half_sizes),
                     active=_t(w.active), shape=_t(w.shape))
    gen = torch.Generator(device=device)
    st = env.reset(world, pp, MissionParams(), mapp, gen, goal=_t(js.goal))
    d = js.drone
    fields = dict(
        drone=DroneState(pos=_t(d.pos), vel=_t(d.vel), quat=_t(d.quat),
                         yaw=_t(d.yaw)),
        scene=scene.build(world, mapp))
    for name in ("buffer", "goal", "phase", "near_goal", "reached", "failed",
                 "fail_count", "steps", "flap", "metric_pos", "metrics",
                 "carry_wpts", "carry_ts", "has_carry", "plan_count",
                 "iter_sum", "missions_done", "missions_ok",
                 "metric_ok_sum"):
        fields[name] = _t(getattr(js, name))
    st = st.replace(**fields)
    return st


def _states(n=4, goal=(20.0, 0.0)):
    worlds = jscenegen.generate_batch(jax.random.PRNGKey(0), n,
                                      JWorldParams(num_boxes=8))
    keys = jax.random.split(jax.random.PRNGKey(1), n)
    return jax.vmap(lambda k, w: jenv.reset(
        k, w, jnp.array(goal), JPlannerParams(), JMissionParams(),
        JMapParams(**MAPP), plan_map="scene"))(keys, worlds)


def _cmds(n, spr=60):
    """Smooth setpoints: a straight-ish path with lateral sway."""
    t = np.arange(spr) / 60.0
    out = []
    for i in range(n):
        v, a, w = 0.8 + 0.05 * i, 0.4, 2.0 + 0.3 * i
        pos = np.stack([v * t, a * np.sin(w * t)], -1)
        vel = np.stack([np.full_like(t, v), a * w * np.cos(w * t)], -1)
        acc = np.stack([np.zeros_like(t), -a * w * w * np.sin(w * t)], -1)
        out.append(np.stack([pos, vel, acc], axis=1))
    return np.stack(out).astype(np.float32)               # (n, spr, 3, 2)


def _run_both(js, cmds, i0=0):
    want = jax.vmap(lambda s, c: jenv._track_segment(
        s, c, JPlannerParams(), JMissionParams(), JSimParams(),
        "scene", i0=i0))(js, jnp.asarray(cmds))
    st = to_port_state(js, PlannerParams(), MapParams(**MAPP))
    got = track.track_segment(st, _t(cmds), PlannerParams(), MissionParams(),
                              SimParams(), i0=i0)
    return want, got


def _assert_match(want, got):
    wd, wreach, wsteps, wmet, wmpos, wtrace = want
    gd, greach, gsteps, gmet, gmpos, gtrace = got
    for f in ("pos", "vel", "quat", "yaw"):
        np.testing.assert_allclose(getattr(gd, f).numpy(),
                                   np.asarray(getattr(wd, f)), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(greach.numpy(), np.asarray(wreach))
    np.testing.assert_array_equal(gsteps.numpy(), np.asarray(wsteps))
    np.testing.assert_allclose(gmet.numpy(), np.asarray(wmet), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(gmpos.numpy(), np.asarray(wmpos), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gtrace.numpy(), np.asarray(wtrace), rtol=1e-5,
                               atol=1e-5)


def test_tracking_segment_matches():
    _assert_match(*_run_both(_states(), _cmds(4)))


def test_metric_offset_and_reached_freeze():
    """The 10 Hz metric ticks on substeps 0, 6, ... and stops, with the
    drone, once the goal is reached inside the segment."""
    js = _states(goal=(0.55, 0.0))
    want, got = _run_both(js, _cmds(4))
    _assert_match(want, got)
    assert bool(np.asarray(want[1]).any()), "test should exercise reach"


@pytest.mark.parametrize("i0", [30, 3])
def test_segment_from_substep_i0_matches(i0):
    """Tracking from substep i0: the metric ticks where (t + i0) % 6 == 0
    (off the chunk's first substep when i0 = 3), on both sides."""
    want, got = _run_both(_states(goal=(0.3, 0.0)), _cmds(4)[:, :30], i0)
    _assert_match(want, got)
    assert bool(np.asarray(want[1]).any()), "test should exercise reach"
    assert float(np.asarray(want[3])[:, 0].min()) > 0.0


def test_six_chunks_equal_one_segment():
    """Six chunks of 10 substeps, each from its offset and the previous
    chunk's state, end exactly where one 60-substep segment ends."""
    js = _states()
    cmds = _cmds(4)
    st = to_port_state(js, PlannerParams(), MapParams(**MAPP))
    args = (PlannerParams(), MissionParams(), SimParams())
    whole = track.track_segment(st, _t(cmds), *args)
    traces = []
    for c in range(6):
        drone, reached, steps, metrics, metric_pos, trace = \
            track.track_segment(st, _t(cmds[:, 10 * c:10 * c + 10]), *args,
                                i0=10 * c)
        st = st.replace(drone=drone, reached=reached, steps=steps,
                        metrics=metrics, metric_pos=metric_pos)
        traces.append(trace)
    for g, w in ((st.drone.pos, whole[0].pos), (st.drone.quat, whole[0].quat),
                 (st.metrics, whole[3]), (st.metric_pos, whole[4]),
                 (st.steps, whole[2]), (torch.cat(traces, 1), whole[5])):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert float(whole[3][:, 0].min()) > 0.0


def test_non_mission_phase_holds():
    js = _states()
    js = js.replace(phase=jnp.full_like(js.phase, jmissions.PHASE_DONE))
    want, got = _run_both(js, _cmds(4))
    _assert_match(want, got)
    np.testing.assert_allclose(got[0].pos.numpy(), np.asarray(js.drone.pos),
                               atol=1e-6)


def test_collision_metric_fires_and_matches():
    """Parked beside its first obstacle, each drone's 10 Hz collision term
    is non-zero on both sides and agrees."""
    js = _states()
    near = js.world.centers[:, 0, :2] + js.world.half_sizes[:, 0, :2] + 0.15
    js = js.replace(drone=js.drone.replace(
        pos=jnp.concatenate([near, js.drone.pos[:, 2:]], axis=1)))
    cmds = np.broadcast_to(np.stack(
        [near, np.zeros_like(near), np.zeros_like(near)], axis=1)[:, None],
        (4, 60, 3, 2)).astype(np.float32)
    want, got = _run_both(js, cmds)
    _assert_match(want, got)
    assert float(np.asarray(want[3])[:, 2].max()) > 0.0


def test_cpu_tensor_takes_plain_version():
    before = _cuda.launches["track_segment"]
    _run_both(_states(n=2), _cmds(2))
    assert _cuda.launches["track_segment"] == before


def test_primitive_cap_matches_kernel():
    """track.MAX_PRIMS counts csrc/track.cu's layout: its warps a block and
    each warp's Stage (whose size the .cu pins with a static_assert)."""
    src = (Path(track.__file__).parent.parent / "csrc" /
           "track.cu").read_text()
    warps = int(re.search(r"constexpr int kWarps = (\d+);", src).group(1))
    stage = int(re.search(r"static_assert\(sizeof\(Stage\) == (\d+)",
                          src).group(1))
    assert (warps, stage) == (track._WARPS, track._STAGE_BYTES)
    tables = track.MAX_PRIMS * 6 * 4 * warps
    assert tables + stage * warps <= track._SMEM_LIMIT
    assert tables + 6 * 4 * warps + stage * warps > track._SMEM_LIMIT
