"""The port's tracker (sim/tracker.py), planning harnesses (plan/compare.py),
config.load_yaml and scenegen.generate against the JAX package on the CPU.

Tolerances. load_yaml's fields are JAX's exactly. circular_target_path
within 1e-6 (cos and sin in another library). The banks come out of
12-iteration L-BFGS solves, held as tests/test_torch_expert_planners.py
holds them: acceptance exactly, the accepted lanes' JAX objective within
5e-3 of JAX's (the cost basin), and the picked lane by its rule; the
network's raw prediction within 1e-4 (tests/test_torch_net.py's tolerance
of the net) and its costs within 1e-4 relative. The port's random worlds
draw differently from JAX's threefry stream, so scenegen.generate is held
to the golden's properties. The tracker's loops are the port's alone
(tests/test_tracker.py, marked slow, flies 30 segments): a few segments
that hold its contract.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu import config as jconfig
from neoplanner_tpu.config import NetParams as JNetParams
from neoplanner_tpu.config import PlannerParams as JPlannerParams
from neoplanner_tpu.core import frames as jframes
from neoplanner_tpu.core.types import DroneState as JDroneState
from neoplanner_tpu.plan import compare as jcompare
from neoplanner_tpu.plan import expert as jexpert
from neoplanner_tpu.sim import tracker as jtracker
from neoplanner_tpu_torch import _cuda, config
from neoplanner_tpu_torch.config import (MapParams, MissionParams,
                                         NetParams, PlannerParams,
                                         SimParams, WorldParams)
from neoplanner_tpu_torch.core import frames
from neoplanner_tpu_torch.core.types import DroneState, ESDFMap
from neoplanner_tpu_torch.learn import weights
from neoplanner_tpu_torch.models.planner_net import PlannerNet
from neoplanner_tpu_torch.plan import compare
from neoplanner_tpu_torch.sim import env, tracker
from neoplanner_tpu_torch.world import scenegen
from tests.test_expert import make_world, mission
from tests.test_torch_env import plan_costs
from tests.test_torch_imports import one_torch_thread  # noqa: F401
from tests.test_torch_vision_env import _nearest_acceptance

KW = dict(samples_per_piece=8, max_iters=12, max_ls=4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _golden(B):
    jmap = make_world(blocking=True)
    planes = {f: _t(getattr(jmap, f))[None].expand(B, -1, -1).contiguous()
              for f in ("esdf", "occupancy", "grad_x", "grad_y")}
    tmap = ESDFMap(origin=_t(jmap.origin), resolution=float(jmap.resolution),
                   **planes)
    return jmap, tmap


def _jax_call(fn, *args):
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jexpert, "costs_mod", _nearest_acceptance())
        return jax.jit(fn)(*args)


def test_plan_with_attempts_matches_jax():
    """tests/test_compare_config.py::test_plan_with_attempts on the port
    and against JAX's bank: all L = 3 + len(extra_lateral_scales) +
    retry_num lanes solved, their seeds exactly, acceptance exactly, the
    accepted lanes in the cost basin, and the picked lane the cheapest
    accepted primary where one exists."""
    jpp = JPlannerParams(**KW)
    pp = PlannerParams(**KW, kernel_window_cells=160)
    jmap, tmap = _golden(1)
    jhead, jtail = mission(jpp)
    key = jax.random.PRNGKey(1)
    noise = jax.random.normal(key, (jpp.retry_num, jpp.dims, jpp.num_wpts))
    want = _jax_call(lambda k: jcompare.plan_with_attempts(
        jmap, jhead, jtail, k, jpp), key)
    att = compare.plan_with_attempts(tmap, _t(jhead)[None], _t(jtail)[None],
                                     _t(noise)[None], pp)
    L = 3 + len(pp.extra_lateral_scales) + pp.retry_num
    assert att.int_wpts.shape == (1, L, 2, 2)
    np.testing.assert_allclose(att.seed_wpts[0].numpy(),
                               np.asarray(want.seed_wpts), atol=1e-6)
    ok = np.asarray(want.ok)
    np.testing.assert_array_equal(att.ok[0].numpy(), ok)
    assert ok.any() and bool(att.ok[0, att.picked[0]])
    assert bool((att.iters[0] > 0).all())
    L_ = np.arange(L)
    info = type("Info", (), dict(plan_init=jnp.stack([jhead[:2]] * L),
                                 target=jnp.stack([jtail[:2]] * L)))
    jmaps = jax.tree_util.tree_map(lambda a: jnp.stack([a] * L), jmap)
    f_port = plan_costs(jmaps, info, att.int_wpts[0].numpy(),
                        att.ts[0].numpy(), jpp)
    f_jax = plan_costs(jmaps, info, want.int_wpts, want.ts, jpp)
    np.testing.assert_allclose(f_port[ok], f_jax[ok], rtol=5e-3, atol=5e-3)
    ok_p = att.ok[0, :pp.batch_num].numpy()
    if ok_p.any():
        totals = att.total[0, :pp.batch_num].numpy()
        assert int(att.picked[0]) == int(np.argmin(np.where(ok_p, totals,
                                                            np.inf)))
    assert int(att.picked[0]) in L_[ok]


def test_compare_nn_vs_refined_matches_jax():
    """tests/test_compare_config.py::test_compare_nn_vs_refined on the port
    and against JAX's: the untrained smallconv net's prediction and its
    costs, the refined plan accepted and no costlier than the raw one,
    output_mse >= 0 and JAX's within the cost basin."""
    netp = dict(img_width=64, img_height=48, backbone="smallconv")
    jnetp = JNetParams(**netp)
    from neoplanner_tpu.learn import train as jtrain
    jvars = jtrain.init_params(jax.random.PRNGKey(0), jnetp)
    net = PlannerNet(NetParams(**netp))
    net.load_state_dict(weights.from_flax(jax.tree_util.tree_map(
        np.asarray, jvars)))
    net.eval()
    jpp = JPlannerParams(**KW)
    pp = PlannerParams(**KW, kernel_window_cells=160)
    jmap, tmap = _golden(1)
    depth = np.random.default_rng(0).uniform(0.5, 6.0, (48, 64)).astype(
        np.float32)
    jdrone = JDroneState(pos=jnp.array([0.0, 0.0, 2.0]), vel=jnp.zeros(3),
                         quat=jframes.quat_identity(), yaw=jnp.zeros(()))
    drone = DroneState(pos=torch.tensor([[0.0, 0.0, 2.0]]),
                       vel=torch.zeros((1, 3)),
                       quat=frames.quat_identity()[None].clone(),
                       yaw=torch.zeros(1))
    plan_init = np.array([[0.0, 0.0], [0.5, 0.0]], np.float32)
    target = np.array([[8.0, 0.0], [0.8, 0.0]], np.float32)
    key = jax.random.PRNGKey(2)
    noise = jax.random.normal(key, (jpp.retry_num, jpp.dims, jpp.num_wpts))
    want = _jax_call(lambda k: jcompare.compare_nn_vs_refined(
        jmap, jvars, jnetp, depth, jdrone, 2.0, plan_init, target, k, jpp),
        key)
    got = compare.compare_nn_vs_refined(
        tmap, net, _t(depth)[None], drone, 2.0, _t(plan_init)[None],
        _t(target)[None], _t(noise)[None], pp)
    np.testing.assert_allclose(got.nn_wpts[0].numpy(),
                               np.asarray(want.nn_wpts), atol=1e-4)
    np.testing.assert_allclose(got.nn_ts[0].numpy(), np.asarray(want.nn_ts),
                               atol=1e-4)
    np.testing.assert_allclose(got.nn_costs[0].numpy(),
                               np.asarray(want.nn_costs), rtol=1e-4,
                               atol=1e-4)
    assert bool(got.refined.ok[0]) == bool(want.refined.ok)
    assert bool(got.refined.ok[0])
    assert float(got.output_mse[0]) >= 0
    w = np.array([pp.w_energy, pp.w_time, pp.w_feas, pp.w_collision])
    assert float(got.refined.costs[0].numpy() @ w) \
        <= float(got.nn_costs[0].numpy() @ w) + 1e-3
    head = jexpert.pad_boundary_state(jnp.asarray(plan_init), jpp)
    tail = jexpert.pad_boundary_state(jnp.asarray(target), jpp)
    info = type("Info", (), dict(plan_init=head[None, :2],
                                 target=tail[None, :2]))
    jmaps = jax.tree_util.tree_map(lambda a: a[None], jmap)
    f_port = plan_costs(jmaps, info, got.refined.int_wpts.numpy(),
                        got.refined.ts.numpy(), jpp)
    f_jax = plan_costs(jmaps, info, want.refined.int_wpts[None],
                       want.refined.ts[None], jpp)
    np.testing.assert_allclose(f_port, f_jax, rtol=5e-3, atol=5e-3)


def test_load_yaml_matches_jax(tmp_path):
    """A planner_config.yaml in the reference's layout (every mapped key,
    weights, init_wpts_num and an unmapped key) loads into the same
    dataclasses in both packages."""
    path = tmp_path / "planner_config.yaml"
    path.write_text(
        "v_max: 1.5\nT_min: 0.4\nT_max: 6\nsafe_dis: 0.8\ndelta_t: 0.05\n"
        "init_T: 2.0\ncollision_cost_tol: 4\nopt_tol: 0.02\n"
        "weights: [2, 0.5, 3, 20000]\ninit_wpts_num: 4\n"
        "planning_time_ahead: 0.8\ndes_pos_z: 1.5\nlongitu_step_dis: 4.0\n"
        "lateral_step_length: 0.7\ntarget_reach_threshold: 0.3\n"
        "cmd_hz: 50\nreplan_period: 0.5\nhover_height: 1.8\n"
        "selected_planner: neo\n")
    pp, mp = config.load_yaml(str(path))
    jpp, jmp = jconfig.load_yaml(str(path))
    assert dataclasses.asdict(pp) == dataclasses.asdict(jpp)
    assert dataclasses.asdict(mp) == dataclasses.asdict(jmp)
    assert pp.num_pieces == 5 and pp.w_collision == 20000.0
    assert isinstance(mp.cmd_hz, int) and mp.cmd_hz == 50


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generate_respects_bounds_and_clearance(seed):
    """tests/test_world.py::test_generate_respects_bounds_and_clearance on
    the port's scenegen.generate (one world, no env axis)."""
    wp = WorldParams()
    world = scenegen.generate(_cuda.make_generator(seed, "cpu"), wp)
    c, h, a = (world.centers.numpy(), world.half_sizes.numpy(),
               world.active.numpy())
    assert c.shape == (wp.max_boxes, 3) and a.shape == (wp.max_boxes,)
    assert a.sum() >= wp.num_boxes - 3
    assert np.all(c[a, 0] >= wp.pose_x_min) and np.all(
        c[a, 0] <= wp.pose_x_max)
    assert np.all(2 * h[a, 2] >= wp.size_z_min - 1e-5)
    idx = np.where(a)[0]
    for ii, i in enumerate(idx):
        for j in idx[:ii]:
            dx = abs(c[i, 0] - c[j, 0])
            dy = abs(c[i, 1] - c[j, 1])
            assert not (dx < h[i, 0] + h[j, 0] + wp.x_clearance
                        and dy < h[i, 1] + h[j, 1] + wp.y_clearance), (i, j)
    again = scenegen.generate(_cuda.make_generator(seed, "cpu"), wp)
    assert torch.equal(again.centers, world.centers)


def test_circular_target_path_matches_jax():
    want = jtracker.circular_target_path(30, jnp.array([9.0, 5.5]), 2.5,
                                         0.35, 1.0 / 6)
    got = tracker.circular_target_path(30, [9.0, 5.5], 2.5, 0.35, 1.0 / 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


PP = PlannerParams(max_iters=16, samples_per_piece=16, retry_num=2,
                   extra_lateral_scales=(), max_ls=4)
MP, SP = MissionParams(), SimParams()
MAPP = MapParams(width=256, height=192, origin_x=-4.0, origin_y=-9.6)


def _tracking_state(B=2, seed=7):
    gen = _cuda.make_generator(seed, "cpu")
    world = scenegen.generate_batch(gen, B, WorldParams(num_boxes=8))
    # the targets circle (2, 0) in the free space before the boxes
    start = torch.tensor([[2.0, 0.0]]).expand(B, 2)
    return env.reset(world, PP, MP, MAPP, gen, goal=start.clone(),
                     start_pos=start)


def test_track_rollout_keeps_replanning():
    """track_rollout on the scene path: every segment replans (plan_count
    equals the segments, the mission never ends), the positions (S, B, 3)
    follow the circle, no collision, the fail count carried."""
    S = 4
    targets = tracker.circular_target_path(S, [2.0, 0.0], 1.0, 0.5,
                                           MP.replan_period)
    final, path = tracker.track_rollout(_tracking_state(), targets, PP, MP,
                                        SP)
    assert path.shape == (S, 2, 3)
    assert bool((final.plan_count == S).all())
    assert bool((final.phase == env.missions.PHASE_MISSION).all()
                or (final.phase == env.missions.PHASE_DONE).any())
    assert float(final.metrics[:, 2].max()) < 1e-3
    err = (path[-1, :, :2] - targets[-1]).norm(dim=-1)
    assert float(err.max()) < 2.0, err
    # a per-env path (S, B, 2) steps the same as a shared one
    again, path2 = tracker.track_rollout(
        _tracking_state(), targets[:, None].expand(S, 2, 2), PP, MP, SP)
    assert torch.equal(path2, path)


def test_track_segment_clears_the_mission_flags(monkeypatch):
    """track_segment hands step_segment the target as the goal with
    reached, near, failed, steps and phase cleared, fail_count kept, the
    'manual' mission mode and the 'expert' planner; track_segment_stream
    leaves the goal and passes the targets as the goal stream, and its
    stored goal ends as the last target (the freshest observation)."""
    state = _tracking_state()
    state = state.replace(
        reached=torch.tensor([True, False]),
        failed=torch.tensor([False, True]),
        near_goal=torch.tensor([True, True]),
        steps=torch.tensor([40, 7], dtype=torch.int32),
        fail_count=torch.tensor([2, 1], dtype=torch.int32),
        phase=torch.full((2,), env.missions.PHASE_DONE, dtype=torch.int32))
    seen = []
    step = env.step_segment

    def spy(s, *args, **kw):
        seen.append((s, kw))
        return step(s, *args, **kw)
    monkeypatch.setattr(env, "step_segment", spy)
    s1, info = tracker.track_segment(state, torch.tensor([3.0, 0.5]), PP, MP,
                                     SP)
    got, kw = seen[-1]
    assert torch.equal(got.goal, torch.tensor([[3.0, 0.5], [3.0, 0.5]]))
    for f in ("reached", "near_goal", "failed"):
        assert not getattr(got, f).any(), f
    assert not got.steps.any()
    assert bool((got.phase == env.missions.PHASE_MISSION).all())
    assert torch.equal(got.fail_count, state.fail_count)
    assert kw["mission_mode"] == "manual" and kw["planner"] == "expert"
    assert bool(info.planned.all())
    stream = torch.tensor([[3.0, 0.5], [3.2, 0.6], [3.4, 0.7]])[None] \
        .expand(2, 3, 2)
    s2, info2 = tracker.track_segment_stream(s1, stream, PP, MP, SP)
    got, kw = seen[-1]
    assert torch.equal(got.goal, s1.goal)
    assert kw["goal_stream"] is stream and kw["mission_mode"] == "manual"
    assert bool(info2.planned.all())
    assert torch.equal(s2.goal, stream[:, -1])
