"""The vision loop of the PyTorch port against the JAX package: 3 segments
of sim/env.step_segment with sensing='depth', plan_map='grid' (the frame
rendered once, fused into the log-odds grid, the truncated ESDF rebuilt,
the NEO planner on the sensed grid, grid tracking) at B=8, and the grid
pieces of the loop on their own (grid tracking, local targets).

Both sides start from the same JAX reset state and get the JAX draws of
every segment (made from the JAX keys as jax's step_segment splits them);
the net is artifacts/planner_net_smallconv.onnx on both sides, as in
test_torch_env.py. The JAX loop runs as on the CPU, with its fusion kernel
in interpret mode and its XLA ESDF chain. Its planner there solves on the
full map with bilinear sampling; the port solves on kernel_window_cells
windows, set to 256 here so that each window is the whole 256 x 192 map and
the two solves coincide. The port accepts a plan by its nearest-cell
collision cost on the full map, as the JAX planner does when its grid
windows are engaged (expert.solve_one's cost_pp); the JAX side is given
that acceptance rule by substituting, for its planner module only, a costs
module whose traj_costs samples the nearest cell.

Tolerances follow test_torch_env.py. The 12-iteration loop: plan flags,
goals, mission flags and counts exactly, and each accepted plan in the
solver's cost basin (its JAX objective on the segment's map within 5e-3 of
the JAX plan's). Its one-iteration twin: the same exact checks, and the
drone state, buffer and metrics within 1e-4 (one iteration takes the same
step on both sides). The sensed maps of the twin: each log-odds cell equal
or off by exactly one l_miss or l_hit quantum, at most 1e-3 of the updated
cells off (a cell on a carve radius or a hit on a cell edge can fall either
way under the renderers' roundoff); the ESDF equal wherever the
occupancies agree within the truncation radius.
"""

import dataclasses
import os
from functools import partial
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import CameraParams as JCameraParams
from neoplanner_tpu.config import MapParams as JMapParams
from neoplanner_tpu.config import MissionParams as JMissionParams
from neoplanner_tpu.config import NetParams as JNetParams
from neoplanner_tpu.config import PlannerParams as JPlannerParams
from neoplanner_tpu.config import SimParams as JSimParams
from neoplanner_tpu.config import WorldParams as JWorldParams
from neoplanner_tpu.mapping import esdf as jesdf
from neoplanner_tpu.plan import costs as jcosts
from neoplanner_tpu.plan import expert as jexpert
from neoplanner_tpu.sim import env as jenv
from neoplanner_tpu.sim import missions as jmissions
from neoplanner_tpu.world import scenegen as jscenegen
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, NetParams,
                                         PlannerParams, SimParams,
                                         WorldParams)
from neoplanner_tpu_torch.core.types import BoxWorld, DroneState, ESDFMap
from neoplanner_tpu_torch.learn import weights
from neoplanner_tpu_torch.mapping import occupancy
from neoplanner_tpu_torch.models import planner_net
from neoplanner_tpu_torch.sim import env, missions, track
from neoplanner_tpu_torch.world import scenegen
from tests.test_torch_env import _flax_variables, _jax_draws, plan_costs
from tests.test_torch_imports import one_torch_thread  # noqa: F401

B = 8
SEGMENTS = 3
PP = dict(max_iters=12, samples_per_piece=8, retry_num=2,
          extra_lateral_scales=(), max_ls=4)
MAPP = dict(width=256, height=192, origin_x=-4.0, origin_y=-9.6,
            edt_truncation=2.0, fusion="2d_dense")
CAM = dict(width=160, height=120)
NET = dict(img_width=160, img_height=120, backbone="smallconv")
ONNX = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                    "planner_net_smallconv.onnx")
VISION = dict(sensing="depth", plan_map="grid")


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16(a):
    return _t(jnp.asarray(a).astype(jnp.float32)).to(torch.bfloat16)


def to_port_state(js, pp: PlannerParams, mapp: MapParams):
    """A batched JAX vision-loop EnvState as the port's EnvState."""
    w = js.world
    world = BoxWorld(centers=_t(w.centers), half_sizes=_t(w.half_sizes),
                     active=_t(w.active), shape=_t(w.shape))
    st = env.reset(world, pp, MissionParams(), mapp,
                   torch.Generator(), goal=_t(js.goal), **VISION)
    d = js.drone
    fields = dict(
        drone=DroneState(pos=_t(d.pos), vel=_t(d.vel), quat=_t(d.quat),
                         yaw=_t(d.yaw)),
        emap=st.emap.replace(esdf=_bf16(js.emap.esdf)),
        logodds=_t(js.logodds))
    for name in ("buffer", "goal", "phase", "near_goal", "reached", "failed",
                 "fail_count", "steps", "flap", "metric_pos", "metrics",
                 "carry_wpts", "carry_ts", "has_carry", "plan_count",
                 "iter_sum", "missions_done", "missions_ok",
                 "metric_ok_sum"):
        fields[name] = _t(getattr(js, name))
    return st.replace(**fields)


def _nearest_acceptance():
    """plan/costs as the JAX planner's solve_one reads it when its grid
    windows are engaged: traj_costs, used there only for acceptance, with
    nearest-cell sampling; everything else the module itself."""
    def traj_costs(head, tail, q, ts, emap, pp):
        return jcosts.traj_costs(head, tail, q, ts, emap, dataclasses.replace(
            pp, esdf_interp="nearest"))
    module = {k: getattr(jcosts, k) for k in dir(jcosts)
              if not k.startswith("__")}
    return SimpleNamespace(**dict(module, traj_costs=traj_costs))


def _reset_jax(jpp, jmp, jmapp):
    worlds = jscenegen.generate_batch(jax.random.PRNGKey(0), B,
                                      JWorldParams(num_boxes=10))
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    # half the envs fly toward x = 20 through the obstacle field; two start
    # within reach of their goal, two have it 0.7 m ahead
    rng = np.random.default_rng(2)
    goals = np.stack([np.array([20.0] * 4 + [0.0] * 2 + [0.7] * 2),
                      rng.uniform(-1.5, 1.5, B)], -1).astype(np.float32)
    goals[4:6, 1] = 0.1
    return jax.vmap(lambda k, w, g: jenv.reset(
        k, w, g, jpp, jmp, jmapp, **VISION))(keys, worlds, jnp.asarray(goals))


def _run_loop(max_iters):
    """SEGMENTS segments of the JAX vision loop and of the port."""
    jpp = JPlannerParams(**dict(PP, max_iters=max_iters))
    pp = PlannerParams(**dict(PP, max_iters=max_iters),
                       kernel_window_cells=256)
    jmp, jsp, jmapp = JMissionParams(), JSimParams(), JMapParams(**MAPP)
    mapp = MapParams(**MAPP)
    sd = weights.from_onnx(ONNX)
    js = _reset_jax(jpp, jmp, jmapp)
    step = jax.jit(jax.vmap(partial(
        jenv.step_segment, pp=jpp, mp=jmp, sp=jsp, mission_mode="random",
        mapp=jmapp, cam=JCameraParams(**CAM), planner="neo",
        net_vars=_flax_variables(sd), np_cfg=JNetParams(**NET),
        fuse_frames=1, **VISION)))
    net = planner_net.PlannerNet(NetParams(**NET))
    net.load_state_dict(sd)
    net.eval()
    st = to_port_state(js, pp, mapp)
    out = []
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jexpert, "costs_mod", _nearest_acceptance())
        for _ in range(SEGMENTS):
            draws = _jax_draws(js.key, jpp)
            js, jinfo = step(js)
            st, info = env.step_segment(st, pp, MissionParams(), SimParams(),
                                        CameraParams(**CAM), net, draws=draws)
            out.append((js, jinfo, st, info))
    return out


@pytest.fixture(scope="module")
def runs():
    return _run_loop(PP["max_iters"])


@pytest.fixture(scope="module")
def runs_one_iter():
    return _run_loop(1)


def _check_flags(js, jinfo, st, info):
    np.testing.assert_array_equal(info.planned.numpy(),
                                  np.asarray(jinfo.planned))
    np.testing.assert_array_equal(info.ok.numpy(), np.asarray(jinfo.ok))
    np.testing.assert_allclose(st.goal.numpy(), np.asarray(js.goal),
                               atol=1e-5)
    for f in ("near_goal", "reached", "failed", "fail_count", "steps",
              "flap", "plan_count", "missions_done", "missions_ok"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)


@pytest.mark.parametrize("seg", range(SEGMENTS))
def test_segment_state_matches(runs, seg):
    """The 12-iteration loop: exact flags and counts, accepted plans in the
    solver's cost basin (5e-3) on the segment's sensed map."""
    js, jinfo, st, info = runs[seg]
    _check_flags(js, jinfo, st, info)
    jpp = JPlannerParams(**PP)
    ok = np.asarray(jinfo.ok)
    f_port = plan_costs(js.emap, jinfo, info.int_wpts.numpy(),
                        info.ts.numpy(), jpp)
    f_jax = plan_costs(js.emap, jinfo, jinfo.int_wpts, jinfo.ts, jpp)
    np.testing.assert_allclose(f_port[ok], f_jax[ok], rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("seg", range(SEGMENTS))
def test_segment_one_iteration_matches(runs_one_iter, seg):
    """The one-iteration twin: exact flags, state within 1e-4, maps as the
    module docstring says."""
    js, jinfo, st, info = runs_one_iter[seg]
    _check_flags(js, jinfo, st, info)
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
    off = got != want
    quanta = np.abs(np.float32([occupancy._l(mp.prob_miss),
                                occupancy._l(mp.prob_hit)]))
    assert np.isclose(np.abs(got - want)[off][:, None], quanta[None],
                      rtol=1e-5).any(1).all()
    assert int(off.sum()) <= 1e-3 * int((want != 0).sum())
    thr = occupancy.occ_threshold(mp)
    occ_off = torch.from_numpy(((got > thr) != (want > thr)).astype(
        np.float32))
    near_off = torch.nn.functional.max_pool2d(occ_off[:, None], 41, 1,
                                              20)[:, 0].numpy() > 0
    np.testing.assert_array_equal(
        st.emap.esdf.float().numpy()[~near_off],
        np.asarray(js.emap.esdf.astype(jnp.float32))[~near_off])


def test_loop_senses_plans_and_moves(runs, runs_one_iter):
    """Not a vacuous match: obstacles were sensed, drones moved, plans were
    accepted in every segment and missions ended."""
    for loop in (runs, runs_one_iter):
        _, _, st, _ = loop[-1]
        assert float(np.abs(st.drone.pos[:, :2].numpy()).max()) > 0.5
        assert int(st.plan_count.sum()) > B
        assert all(bool(r[3].ok.any()) for r in loop)
        assert int(st.missions_done.sum()) >= 1
        assert float(st.emap.esdf.float().min()) == 0.0   # occupied cells
        assert int((st.logodds < 0).sum()) > 1000          # carved free space


def _vision_states(n, goal):
    jpp, jmp = JPlannerParams(), JMissionParams()
    worlds = jscenegen.generate_batch(jax.random.PRNGKey(6), n,
                                      JWorldParams(num_boxes=10))
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    return jax.vmap(lambda k, w: jenv.reset(
        k, w, jnp.array(goal), jpp, jmp, JMapParams(**MAPP), **VISION))(
            keys, worlds)


def _sensed(js):
    """A JAX state with a sensed map: one fused frame and rebuild."""
    sense = jax.jit(jax.vmap(partial(
        jenv.sense_and_map, mapp=JMapParams(**MAPP),
        cam=JCameraParams(**CAM))))
    return sense(js.replace(drone=js.drone.replace(
        pos=js.drone.pos + jnp.array([3.0, 0.0, 0.0]))))


def test_grid_tracking_matches_scan():
    """B10's plain version plus the grid metric against the JAX scan
    tracker on an ESDFMap (what _track_segment runs on the CPU): state and
    trace within 1e-4 (the same f32 substep arithmetic; the collision
    metric summed in another order). The paths pass a block of occupied
    cells at (4.0, 0.3), so the collision metric is live."""
    n = 4
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
    jpp, jmp, jsp = JPlannerParams(), JMissionParams(), JSimParams()
    want = jax.jit(jax.vmap(lambda s, c: jenv._track_segment(
        s, c, jpp, jmp, jsp, plan_map="grid")))(js, jnp.asarray(cmds))
    st = to_port_state(js, PlannerParams(), MapParams(**MAPP))
    got = track.track_segment_grid(st, _t(cmds), PlannerParams(),
                                   MissionParams(), SimParams())
    for g, w in ((got[0].pos, want[0].pos), (got[0].vel, want[0].vel),
                 (got[0].quat, want[0].quat), (got[3], want[3]),
                 (got[4], want[4]), (got[5], want[5])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert float(np.asarray(want[3])[:, 2].min()) > 0.0


def test_set_local_target_on_grid_matches():
    """Local targets with the lateral escape against the sensed grid
    (nearest-cell collision queries): the same draws give the same targets."""
    n = 8
    js = _sensed(_vision_states(n, (20.0, 0.0)))
    st = to_port_state(js, PlannerParams(), MapParams(**MAPP))
    rng = np.random.default_rng(9)
    pos = np.stack([rng.uniform(2.0, 6.0, n), rng.uniform(-2.0, 2.0, n)],
                   -1).astype(np.float32)
    goal = (pos + [[12.0, 0.0]]).astype(np.float32)
    fails = (np.arange(n) % 2).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(5), n)
    noise = jax.vmap(lambda k: jax.random.normal(k, (2,)))(keys)
    jmp, jpp = JMissionParams(), JPlannerParams()
    want_t, want_n = jax.vmap(
        lambda em, p, g, k, f: jmissions.set_local_target(
            em, p, g, k, f, jmp, jpp))(js.emap, pos, goal, keys, fails)
    got_t, got_n = missions.set_local_target(
        st.emap, _t(pos), _t(goal), _t(noise), _t(fails), MissionParams(),
        PlannerParams())
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


def test_rollout_from_generator_on_cpu():
    """The port's own entry points end to end on the CPU: worlds and draws
    from a seeded torch.Generator, reset and two vision segments."""
    pp = PlannerParams(max_iters=4, samples_per_piece=6, retry_num=2,
                       extra_lateral_scales=(), max_ls=2)
    mapp = MapParams(**MAPP)
    gen = _cuda.make_generator(0, "cpu")
    worlds = scenegen.generate_batch(gen, 3, WorldParams(num_boxes=10))
    net = planner_net.load(ONNX, NetParams(**NET), "cpu")
    st = env.reset(worlds, pp, MissionParams(), mapp, gen, **VISION)
    assert isinstance(st.emap, ESDFMap) and st.logodds.shape == (3, 192, 256)
    assert st.mapp == mapp
    st = env.rollout(st, 2, pp, MissionParams(), SimParams(),
                     CameraParams(**CAM), net)
    assert int(st.plan_count.min()) >= 1
    assert int((st.logodds != 0).sum()) > 0
    for t in (st.drone.pos, st.drone.quat, st.buffer, st.metrics):
        assert bool(torch.isfinite(t).all())
    scene_state = env.reset(worlds, pp, MissionParams(), mapp, gen)
    assert scene_state.emap is None and scene_state.logodds is None
    assert scene_state.mapp is None
    with pytest.raises(ValueError, match="unsupported sensing/plan_map"):
        env.reset(worlds, pp, MissionParams(), mapp, gen, sensing="depth")
