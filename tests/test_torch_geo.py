"""The port's geo planner (plan/geo.py) against the JAX package on the CPU,
on tests/test_geo.py's maps: a 16 x 12 m corridor with a wall that has a
gap, and a free map.

Tolerances. The host functions are numpy copies: their paths and key
nodes are JAX's exactly. The device front end sums 1 and sqrt(2) in f32
and indexes cells: its field, descent points, path ends and key indices
are JAX's bit for bit. The refine is the expert's warm start (a lazy bank
of L-BFGS solves), held as tests/test_torch_expert_planners.py holds the
banks: at one iteration the plans elementwise within 1e-4 and the flags
exactly; at 12 iterations the flags exactly and the plans' JAX objective
within 5e-3 (the cost basin). The port solves on a window that covers the
whole map and accepts by the nearest-cell rule, so the JAX side accepts by
that rule too (test_torch_vision_env._nearest_acceptance).

The golden tests of tests/test_geo.py are mirrored on the port (the
six), and a few segments of the 'geo' closed loop on the gt+grid path
stand in for tests/test_planner_modes.py::test_geo_mode (marked slow
there).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import PlannerParams as JPlannerParams
from neoplanner_tpu.mapping import esdf as jesdf
from neoplanner_tpu.plan import expert as jexpert
from neoplanner_tpu.plan import geo as jgeo
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, PlannerParams,
                                         SimParams, WorldParams)
from neoplanner_tpu_torch.mapping import esdf
from neoplanner_tpu_torch.ops import minco
from neoplanner_tpu_torch.plan import geo
from neoplanner_tpu_torch.sim import env
from neoplanner_tpu_torch.world import scenegen
from tests.test_torch_env import plan_costs
from tests.test_torch_imports import one_torch_thread  # noqa: F401
from tests.test_torch_vision_env import _nearest_acceptance

ORIGIN = (-2.0, -6.0)


def _wall():
    occ = np.zeros((120, 160), dtype=np.float32)
    occ[40:80, 70:80] = 1.0   # wall with a gap at the top
    return occ


def _free():
    occ = np.zeros((120, 160), dtype=np.float32)
    occ[10, 10] = 1.0
    return occ


def _maps(occ, B, lite=False):
    jm = jesdf.build(jnp.array(occ), jnp.array(ORIGIN), 0.1, lite=lite)
    tm = esdf.build(torch.from_numpy(occ)[None].repeat(B, 1, 1), ORIGIN, 0.1,
                    lite=lite)
    return jm, tm


# starts and goals: around the wall, a short goal, one off the axis, one
# starting next to the wall
STARTS = np.array([[0.0, 0.0], [0.0, 0.0], [0.5, -1.0], [4.5, 1.0]],
                  np.float32)
GOALS = np.array([[10.0, 0.0], [2.4, 0.0], [9.0, 3.0], [8.0, -2.0]],
                 np.float32)


def test_host_functions_match_jax():
    """astar, seg_feasible and prune_path are JAX's exactly: the paths and
    the pruned key nodes, also on a map whose wall spans the grid
    (tests/test_geo.py::test_astar_unreachable's)."""
    sealed = np.zeros((60, 60), dtype=np.float32)
    sealed[:, 28:32] = 1.0
    sealed[0:2, :] = 1.0
    sealed[-2:, :] = 1.0
    cases = [(_wall(), ORIGIN, s, g, sd) for s, g in zip(STARTS, GOALS)
             for sd in (0.5, 0.7)]
    cases += [(sealed, (0.0, 0.0), [1.0, 3.0], [5.0, 3.0], 0.3),
              (_free(), ORIGIN, [0.0, 0.0], [9.0, 0.0], 0.5)]
    for occ, origin, start, goal, safe in cases:
        grid = np.asarray(jesdf.build(jnp.array(occ), jnp.array(origin),
                                      0.1).esdf)
        want = jgeo.astar(grid, origin, 0.1, start, goal, safe_dis=safe)
        got = geo.astar(grid, origin, 0.1, start, goal, safe_dis=safe)
        assert got == want
        if len(got) >= 2:
            assert geo.prune_path(grid, origin, 0.1, got) \
                == jgeo.prune_path(grid, origin, 0.1, want)
        for a, b in zip(got[:-1:7], got[5::7]):
            assert geo.seg_feasible(grid, origin, 0.1, a, b) \
                == jgeo.seg_feasible(grid, origin, 0.1, a, b)


@pytest.mark.parametrize("which", ["wall", "free", "wall lite"])
def test_device_front_end_bit_for_bit(which):
    """wavefront_field, descend_path, the path end and prune_path_device
    of B = 4 envs against JAX's per env, exactly; also on the vision
    path's lite map (a bf16 field without gradient planes)."""
    occ = _free() if which == "free" else _wall()
    jm, tm = _maps(occ, len(STARTS), lite=which.endswith("lite"))
    head = torch.zeros((len(STARTS), 3, 2))
    tail = torch.zeros((len(STARTS), 3, 2))
    head[:, 0], tail[:, 0] = torch.from_numpy(STARTS), torch.from_numpy(GOALS)
    field, pts, end, i1, i2 = geo.front_end(tm, head, tail, 0.7)
    for b in range(len(STARTS)):
        jf = jgeo.wavefront_field(jm, jnp.asarray(GOALS[b]), 0.7, 256)
        jp = jgeo.descend_path(jm, jf, jnp.asarray(STARTS[b]), 192)
        at_min = jnp.all(jp == jp[-1], axis=1)
        je = jnp.where(at_min[0], 0, jnp.argmax(at_min)).astype(jnp.int32)
        ji1, ji2 = jax.jit(jgeo.prune_path_device)(jm, jp, je)
        np.testing.assert_array_equal(field[b].numpy(), np.asarray(jf))
        np.testing.assert_array_equal(pts[b].numpy(), np.asarray(jp))
        assert (int(end[b]), int(i1[b]), int(i2[b])) \
            == (int(je), int(ji1), int(ji2))


def _plan_case(max_iters):
    kw = dict(max_iters=max_iters, samples_per_piece=8, max_ls=4,
              retry_num=2, extra_lateral_scales=(2.5,))
    pp = PlannerParams(**kw, kernel_window_cells=160)
    jpp = JPlannerParams(**kw)
    B = len(STARTS)
    jm, tm = _maps(_wall(), B)
    jmaps = jax.tree_util.tree_map(lambda a: jnp.stack([a] * B), jm)
    heads = np.zeros((B, 2, 2), np.float32)
    tails = np.zeros((B, 2, 2), np.float32)
    heads[:, 0], tails[:, 0] = STARTS, GOALS
    heads[:, 1] = [0.5, 0.0]
    jhead = jax.vmap(lambda s: jexpert.pad_boundary_state(s, jpp))(
        jnp.asarray(heads))
    jtail = jax.vmap(lambda s: jexpert.pad_boundary_state(s, jpp))(
        jnp.asarray(tails))
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    noise = jax.vmap(lambda k: jax.random.normal(
        k, (jpp.retry_num, jpp.dims, jpp.num_wpts)))(keys)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jexpert, "costs_mod", _nearest_acceptance())
        want = jax.jit(jax.vmap(lambda m, h, t, k: jgeo.geo_plan_device(
            m, h, t, k, jpp)))(jmaps, jhead, jtail, keys)
    got = geo.geo_plan_device(tm, torch.from_numpy(np.asarray(jhead)),
                              torch.from_numpy(np.asarray(jtail)),
                              torch.from_numpy(np.asarray(noise)), pp)
    return got, want, jmaps, jhead, jtail, jpp


def test_geo_plan_device_one_iteration():
    """The batched geo plan at one L-BFGS iteration: acceptance exactly,
    waypoints and durations within 1e-4."""
    got, want, *_ = _plan_case(1)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    np.testing.assert_allclose(got.int_wpts.numpy(), np.asarray(want.int_wpts),
                               atol=1e-4)
    np.testing.assert_allclose(got.ts.numpy(), np.asarray(want.ts), atol=1e-4)


def test_geo_plan_device_cost_basin():
    """The batched geo plan at 12 iterations: acceptance exactly, the
    accepted plans' JAX objective within 5e-3 of the JAX plans'."""
    got, want, jmaps, jhead, jtail, jpp = _plan_case(12)
    ok = np.asarray(want.ok)
    np.testing.assert_array_equal(got.ok.numpy(), ok)
    assert ok.any()
    info = type("Info", (), dict(plan_init=jhead[:, :2], target=jtail[:, :2]))
    f_port = plan_costs(jmaps, info, got.int_wpts.numpy(), got.ts.numpy(),
                        jpp)
    f_jax = plan_costs(jmaps, info, want.int_wpts, want.ts, jpp)
    np.testing.assert_allclose(f_port[ok], f_jax[ok], rtol=5e-3, atol=5e-3)


# ---- tests/test_geo.py's goldens on the port


def _one(start, goal, occ=None, B=1):
    _, tm = _maps(_wall() if occ is None else occ, B)
    head = torch.zeros((B, 3, 2))
    tail = torch.zeros((B, 3, 2))
    head[:, 0] = torch.tensor(start)
    tail[:, 0] = torch.tensor(goal)
    return tm, head, tail


def test_astar_finds_route_around_wall():
    occ = _wall()
    tm, *_ = _one([0.0, 0.0], [10.0, 0.0])
    path = geo.astar(tm.esdf[0].numpy(), ORIGIN, 0.1, [0.0, 0.0],
                     [10.0, 0.0], safe_dis=0.5)
    assert len(path) > 10
    np.testing.assert_allclose(path[0], [0.0, 0.0], atol=0.2)
    np.testing.assert_allclose(path[-1], [10.0, 0.0], atol=0.2)
    for x, y in path:
        col, row = int((x + 2.0) / 0.1), int((y + 6.0) / 0.1)
        if 0 <= row < 120 and 0 <= col < 160:
            assert occ[row, col] == 0.0


def test_astar_unreachable():
    occ = np.zeros((60, 60), dtype=np.float32)
    occ[:, 28:32] = 1.0
    occ[0:2, :] = 1.0
    occ[-2:, :] = 1.0
    tm = esdf.build(torch.from_numpy(occ)[None], (0.0, 0.0), 0.1)
    path = geo.astar(tm.esdf[0].numpy(), (0.0, 0.0), 0.1, [1.0, 3.0],
                     [5.0, 3.0], safe_dis=0.3)
    assert isinstance(path, list)


def test_geo_plan_end_to_end():
    """The host front end and the warm-started refine: accepted, and the
    trajectory keeps 0.2 m from the wall."""
    pp = PlannerParams(max_iters=96, kernel_window_cells=160)
    tm, head, tail = _one([0.0, 0.0], [10.0, 0.0])
    noise = torch.randn((1, pp.retry_num, 2, 2),
                        generator=torch.Generator().manual_seed(0))
    traj = geo.geo_plan(tm, head, tail, noise, pp)
    assert bool(traj.ok[0])
    t = torch.linspace(0.0, float(traj.ts.sum()), 300)[None]
    pos = minco.eval_at(traj.coeffs, traj.ts, t, 0)
    assert float(esdf.nearest_distance(tm, pos).min()) > 0.2


def test_wavefront_device_variant():
    pp = PlannerParams(max_iters=96, kernel_window_cells=160)
    tm, head, tail = _one([0.0, 0.0], [10.0, 0.0])
    field = geo.wavefront_field(tm, tail[:, 0], pp.safe_dis, 220)
    pts = geo.descend_path(tm, field, head[:, 0], 192)
    np.testing.assert_allclose(pts[0, -1].numpy(), [10.0, 0.0], atol=0.3)
    noise = torch.randn((1, pp.retry_num, 2, 2),
                        generator=torch.Generator().manual_seed(0))
    assert bool(geo.geo_plan_device(tm, head, tail, noise, pp).ok[0])


def _keys(start, goal, iters=220, safe=0.5, occ=None):
    tm, head, tail = _one(start, goal, occ)
    field = geo.wavefront_field(tm, tail[:, 0], safe, iters)
    pts = geo.descend_path(tm, field, head[:, 0], 192)
    i1, i2 = geo.prune_path_device(tm, pts, geo.path_end(pts))
    return tm, pts[0, i1[0]].numpy(), pts[0, i2[0]].numpy()


def test_device_pruning_matches_host_on_free_straight():
    tm, w1, w2 = _keys([0.0, 0.0], [9.0, 0.0], occ=_free())
    np.testing.assert_allclose(w1, [3.0, 0.0], atol=0.35)
    np.testing.assert_allclose(w2, [6.0, 0.0], atol=0.35)
    grid = tm.esdf[0].numpy()
    path = geo.astar(grid, ORIGIN, 0.1, [0.0, 0.0], [9.0, 0.0], safe_dis=0.5)
    pruned = geo.prune_path(grid, ORIGIN, 0.1, path)
    np.testing.assert_allclose(pruned[1], w1, atol=0.45)
    np.testing.assert_allclose(pruned[2], w2, atol=0.45)


def test_device_pruning_short_goal_no_pileup():
    _, w1, w2 = _keys([0.0, 0.0], [2.4, 0.0], occ=_free())
    np.testing.assert_allclose(w1, [0.8, 0.0], atol=0.3)
    np.testing.assert_allclose(w2, [1.6, 0.0], atol=0.3)
    assert np.linalg.norm(w1 - w2) > 0.3


def test_device_pruning_matches_host_around_wall():
    pp = PlannerParams(max_iters=96)
    tm, w1, w2 = _keys([0.0, 0.0], [10.0, 0.0], iters=256, safe=pp.safe_dis)
    grid = tm.esdf[0].numpy()
    path = geo.astar(grid, ORIGIN, 0.1, [0.0, 0.0], [10.0, 0.0],
                     safe_dis=pp.safe_dis)
    pruned = np.array(geo.prune_path(grid, ORIGIN, 0.1, path)[1:3])
    assert np.abs(np.stack([w1, w2]) - pruned).max() < 1.0


# ---- the closed loop


MAPP = MapParams(width=256, height=192, origin_x=-4.0, origin_y=-9.6)


def test_geo_mode_loop():
    """A few segments of the 'geo' planner on the gt+grid path (the JAX
    golden flies 10 m with the 'manual' mission mode, marked slow): two
    envs fly to a goal 6 m ahead through a scenegen world and reach it
    without collision; the planner raises on the scene path."""
    pp = PlannerParams(max_iters=32, kernel_window_cells=160)
    mp, sp = MissionParams(), SimParams()
    gen = _cuda.make_generator(7, "cpu")
    world = scenegen.generate_batch(gen, 2, WorldParams(num_boxes=6))
    goal = torch.tensor([[6.0, 0.0], [6.0, 1.0]])
    state = env.reset(world, pp, mp, MAPP, gen, goal=goal, sensing="gt",
                      plan_map="grid")
    for _ in range(14):
        state, info = env.step_segment(state, pp, mp, sp, CameraParams(),
                                       planner="geo", mission_mode="manual")
        if bool((state.reached | state.failed).all()):
            break
    assert bool(state.reached.all()), state.failed
    assert float(state.metrics[:, 2].max()) < 1e-3
    scene_state = env.reset(world, pp, mp, MAPP, gen, goal=goal)
    with pytest.raises(ValueError, match="rasterized grid"):
        env.step_segment(scene_state, pp, mp, sp, CameraParams(),
                         planner="geo")
    # the vision path: its sensed lite map, one segment
    vision = env.reset(world, pp, mp, MAPP, gen, goal=goal, sensing="depth",
                       plan_map="grid")
    vision, info = env.step_segment(vision, pp, mp, sp,
                                    CameraParams(width=64, height=48),
                                    planner="geo", mission_mode="manual")
    assert bool(info.planned.all()) and int(vision.iter_sum.sum()) > 0
    assert bool(torch.isfinite(vision.buffer).all())
