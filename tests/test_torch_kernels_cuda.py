"""Every hand-written CUDA kernel of the PyTorch port against its plain
PyTorch version, on the card.

This module imports neither JAX nor the JAX package, so that it runs on a
GPU host that has only PyTorch; its inputs come from numpy seeds and the
port's own generators. Each test is marked ``cuda`` and skips where
torch.cuda.is_available() is false. On a GPU host without JAX (whose
tests/conftest.py imports it), run

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest \
        -o addopts="" -p no:cacheprovider -q

The plain version runs on the CPU and the kernel on the card, from the
same inputs. Tolerances are stated per test.
"""

import dataclasses

import numpy as np
import pytest
import torch

from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, PlannerParams,
                                         SimParams, WorldParams)
from neoplanner_tpu_torch.core import frames
from neoplanner_tpu_torch.mapping import esdf, fusion, occupancy, scene
from neoplanner_tpu_torch.ops import edt, minco
from neoplanner_tpu_torch.plan import costs, expert, solve
from neoplanner_tpu_torch.sense import raycast
from neoplanner_tpu_torch.sim import env, track
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.world import scenegen
from tests.test_torch_imports import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.cuda

MAPP = dict(width=256, height=192, origin_x=-4.0, origin_y=-9.6)
ORIGIN = (MAPP["origin_x"], MAPP["origin_y"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _to(obj, dev):
    """A state or map dataclass with every tensor (also one level down, in
    its map and world fields) on dev."""
    moved = {}
    for name, val in vars(obj).items():
        if isinstance(val, torch.Tensor):
            moved[name] = val.to(dev)
        elif dataclasses.is_dataclass(val) and hasattr(val, "replace"):
            moved[name] = val.replace(**{
                k: v.to(dev) for k, v in vars(val).items()
                if isinstance(v, torch.Tensor)})
    return obj.replace(**moved)


def _worlds(n, seed=3):
    return scenegen.generate_batch(_cuda.make_generator(seed, "cpu"), n,
                                   WorldParams(num_boxes=10))


def _poses(n, seed, x=(-1.0, 4.0)):
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(np.stack([
        rng.uniform(*x, n), rng.uniform(-2.0, 2.0, n),
        rng.uniform(1.5, 2.5, n)], -1).astype(np.float32))
    acc = torch.from_numpy(rng.normal(scale=2.0, size=(n, 3)).astype(
        np.float32))
    yaw = torch.from_numpy(rng.uniform(-0.6, 0.6, n).astype(np.float32))
    return pos, frames.quat_from_accel_yaw(acc, yaw)


def _boundary(n, seed, start=(0.0, 0.0)):
    """n planning problems ~5 m long from around start: (x0, head, tail)."""
    rng = np.random.default_rng(seed)
    head = np.zeros((n, 3, 2), np.float32)
    tail = np.zeros((n, 3, 2), np.float32)
    head[:, 0] = rng.normal(size=(n, 2)) * [1.0, 0.5] + start
    head[:, 1] = rng.normal(scale=0.3, size=(n, 2))
    tail[:, 0] = head[:, 0] + [5.0, 0.0] + rng.normal(size=(n, 2))
    tail[:, 1] = rng.normal(scale=0.3, size=(n, 2))
    pp = PlannerParams()
    head, tail = _t(head), _t(tail)
    x0 = costs.pack(expert.straight_line_wpts(head[:, 0], tail[:, 0], pp),
                    minco.T_to_tau(expert.init_ts(pp).expand(n, -1),
                                   pp.t_min, pp.t_max), pp)
    x0 = x0 + _t(rng.normal(scale=0.2, size=tuple(x0.shape))).float()
    return x0.contiguous(), head, tail


def _cmds(n, spr=60, x0=0.0):
    """Smooth setpoints: a straight-ish path with lateral sway."""
    t = np.arange(spr) / 60.0
    out = []
    for i in range(n):
        v, a, w = 0.8 + 0.05 * i, 0.4, 2.0 + 0.3 * i
        pos = np.stack([x0 + v * t, a * np.sin(w * t)], -1)
        vel = np.stack([np.full_like(t, v), a * w * np.cos(w * t)], -1)
        acc = np.stack([np.zeros_like(t), -a * w * w * np.sin(w * t)], -1)
        out.append(np.stack([pos, vel, acc], axis=1))
    return _t(np.stack(out).astype(np.float32))           # (n, spr, 3, 2)


def _assert_track_match(want, got):
    """Tracker outputs: state, reached and steps exact or to 1e-5 (the same
    f32 substep arithmetic), the metric to 1e-4 (sums of cubes)."""
    wd, wreach, wsteps, wmet, wmpos, wtrace = want
    gd, greach, gsteps, gmet, gmpos, gtrace = got
    for f in ("pos", "vel", "quat", "yaw"):
        np.testing.assert_allclose(getattr(gd, f).cpu().numpy(),
                                   getattr(wd, f).numpy(), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(greach.cpu().numpy(), wreach.numpy())
    np.testing.assert_array_equal(gsteps.cpu().numpy(), wsteps.numpy())
    np.testing.assert_allclose(gmet.cpu().numpy(), wmet.numpy(), rtol=1e-4,
                               atol=1e-5)
    for g, w in ((gmpos, wmpos), (gtrace, wtrace)):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)


# ---- B5: banded MINCO solve


@pytest.mark.parametrize("transposed", [False, True])
def test_minco_kernel_matches_plain(cuda_device, transposed):
    """1e-4: the same Givens rotations, reassociated by FMA contraction."""
    n = 1000
    _, head, tail = _boundary(n, seed=5)
    rng = np.random.default_rng(5)
    wpts = expert.straight_line_wpts(head[:, 0], tail[:, 0], PlannerParams()) \
        + _t(rng.normal(scale=0.3, size=(n, 2, 2))).float()
    ts = _t(rng.uniform(0.8, 4.0, size=(n, 3)).astype(np.float32))
    A, b = minco.build_system(head, tail, wpts, ts)
    lo, up = (2, 4) if transposed else (4, 2)
    if transposed:
        A = A.transpose(1, 2).contiguous()
    want = minco._givens_solve(A, b, lo, up)
    got = minco.banded_solve(A.to(cuda_device), b.to(cuda_device), lo, up)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


# ---- B4: depth render


def test_render_kernel_matches_plain(cuda_device):
    """At most 1e-3 of the pixels off by more than 1e-4 m: a ray grazing a
    box edge can flip between hit and miss under roundoff."""
    worlds = _worlds(64)
    shape = worlds.shape.clone()
    shape[:, 1::3] = 1                                  # some cylinders
    worlds = worlds.replace(shape=shape)
    pos, quat = _poses(64, seed=3)
    cam = CameraParams()
    want = raycast.render_depth(worlds, pos, quat, cam)
    got = raycast.render_depth_auto(_to(worlds, cuda_device),
                                    pos.to(cuda_device), quat.to(cuda_device),
                                    cam)
    diff = (got.cpu() - want).abs()
    assert float((diff > 1e-4).float().mean()) <= 1e-3


# ---- B3 and B10: tracking


def test_track_kernel_matches_plain(cuda_device):
    pp, mp, sp = PlannerParams(), MissionParams(), SimParams()
    st = env.reset(_worlds(4, seed=8), pp, mp, MapParams(**MAPP),
                   _cuda.make_generator(1, "cpu"),
                   goal=torch.tensor([[0.55, 0.0]]).expand(4, 2))
    cmds = _cmds(4)
    want = track.track_segment(st, cmds, pp, mp, sp)
    got = track.track_segment(_to(st, cuda_device), cmds.to(cuda_device),
                              pp, mp, sp)
    _assert_track_match(want, got)


def test_track_grid_kernel_matches_plain(cuda_device):
    """B10 plus the nearest-cell grid metric; the paths pass a block of
    occupied cells at (4.0, 0.3), so the collision metric is live."""
    pp, mp, sp = PlannerParams(), MissionParams(), SimParams()
    mapp = MapParams(**MAPP, edt_truncation=2.0, fusion="2d_dense")
    st = env.reset(_worlds(4, seed=8), pp, mp, mapp,
                   _cuda.make_generator(1, "cpu"),
                   goal=torch.tensor([[20.0, 0.0]]).expand(4, 2),
                   sensing="depth", plan_map="grid")
    occ = torch.zeros((4, 192, 256))
    occ[:, 96:103, 77:84] = 1.0
    st = st.replace(emap=esdf.build(occ, ORIGIN, 0.1, 2.0),
                    drone=st.drone.replace(pos=st.drone.pos + torch.tensor(
                        [3.0, 0.0, 0.0])))
    cmds = _cmds(4, x0=3.0)
    want = track.track_segment_grid(st, cmds, pp, mp, sp)
    assert float(want[3][:, 2].max()) > 0.0
    got = track.track_segment_grid(_to(st, cuda_device), cmds.to(cuda_device),
                                   pp, mp, sp)
    _assert_track_match(want, got)


# ---- B1 (+B2): L-BFGS on the scene SDF


def test_solver_kernel_matches_plain(cuda_device):
    """One iteration: f within 1e-3 relative (the same step from the same
    gradient; the kernel's hand adjoint and the plain autograd gradient
    differ by roundoff). 24 iterations: roundoff steers single solves onto
    other iterate paths, so the solves are held to the plain version's cost
    basin as chip_smoke.py holds them: the median relative f difference
    <= 1e-4 and the mean f within 1%."""
    worlds = _worlds(2, seed=7)
    sc = scene.build(worlds, MapParams(**MAPP))
    sc_d = scene.SceneMap(*(getattr(sc, f).to(cuda_device) for f in
                            ("centers", "half", "is_cyl", "active")))
    x0, head, tail = _boundary(64, seed=1)
    env_of = torch.arange(64) % 2
    args = [a.to(cuda_device) for a in (x0, head, tail)]
    pp1 = PlannerParams(samples_per_piece=24, max_iters=1, max_ls=4)
    want = solve.solve_scene(x0, head, tail, sc, env_of, pp1)
    got = solve.solve_scene(*args, sc_d, env_of.to(cuda_device), pp1)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].numpy(),
                               rtol=1e-3)
    pp = dataclasses.replace(pp1, max_iters=24)
    want = solve.solve_scene(x0, head, tail, sc, env_of, pp)
    got = solve.solve_scene(*args, sc_d, env_of.to(cuda_device), pp)
    f_k, f_p = got[1].cpu(), want[1]
    rel = (f_k - f_p).abs() / f_p.abs().clamp(min=1.0)
    assert float(rel.median()) <= 1e-4, rel
    assert abs(float(f_k.mean()) / float(f_p.mean()) - 1.0) <= 1e-2


# ---- B8 v2: dense depth fusion


def test_fusion_kernel_matches_plain(cuda_device):
    """Three frames fused in sequence: at most 1e-4 of the updated cells
    may differ, each by exactly one l_miss or l_hit quantum (a cell centre
    on the carve radius can fall either way under FMA contraction)."""
    cam = CameraParams()
    mp = MapParams(width=128, height=192, origin_x=-2.0, origin_y=-9.6,
                   fusion="2d_dense")
    worlds = _worlds(2)
    worlds = worlds.replace(centers=worlds.centers - torch.tensor(
        [3.0, 0.0, 0.0]))
    lo = occupancy.logodds_init(mp, 2)
    lo_g = lo.to(cuda_device)
    quanta = torch.tensor([occupancy._l(mp.prob_miss),
                           occupancy._l(mp.prob_hit)]).abs()
    for seed in (4, 5, 6):
        pos, quat = _poses(2, seed, x=(0.0, 3.0))
        depth = raycast.render_depth(worlds, pos, quat, cam)
        lo = fusion.insert_depth_2d_dense(lo, depth, pos, quat, cam, mp)
        lo_g = fusion.insert_depth_2d_dense(
            lo_g, depth.to(cuda_device), pos.to(cuda_device),
            quat.to(cuda_device), cam, mp)
    diff = (lo_g.cpu() - lo).abs()
    off = diff > 0
    assert int(off.sum()) <= 1e-4 * int((lo != 0).sum())
    if off.any():
        step = (diff[off][:, None] - quanta[None]).abs().amin(1)
        assert float(step.max()) <= 1e-5


# ---- B9 fused: log-odds -> truncated lite ESDF


@pytest.mark.parametrize("shape, max_dist, sparse",
                         [((4, 192, 256), 2.0, False),
                          ((3, 48, 128), 0.7, True)])
def test_edt_kernel_matches_plain(cuda_device, shape, max_dist, sparse):
    """Bit for bit: integer squared distances in f32, then the same sqrt,
    scale, clamp and bf16 rounding."""
    rng = np.random.default_rng(5)
    if sparse:
        lo = ((rng.uniform(0, 1, size=shape) < 0.01) * 3.0 - 1.0)
    else:
        lo = rng.uniform(-2.0, 2.0, size=shape)
    lo = _t(lo.astype(np.float32))
    mp = MapParams()
    thr = occupancy.occ_threshold(mp)
    want = edt.rebuild_truncated_lite(lo, thr, mp.resolution, max_dist)
    got = edt.rebuild_truncated_lite(lo.to(cuda_device), thr, mp.resolution,
                                     max_dist)
    assert torch.equal(got.cpu(), want)


# ---- B6 (+B2): L-BFGS on ESDF windows


def test_grid_solver_kernel_matches_plain(cuda_device):
    """One iteration on 96-cell windows of two lite maps: f within 1e-3
    relative, as B1."""
    occ = torch.zeros((2, 192, 256))
    rng = np.random.default_rng(9)
    for e in range(2):
        for _ in range(8):                     # 0.4-1.2 m boxes ahead
            r, c = rng.integers(60, 130), rng.integers(60, 140)
            h, w = rng.integers(4, 12, size=2)
            occ[e, r:r + h, c:c + w] = 1.0
    emap = esdf.build(occ, ORIGIN, 0.1, 2.0)
    pp = PlannerParams(samples_per_piece=24, max_iters=1, max_ls=4)
    x0, head, tail = _boundary(8, seed=1, start=(3.0, 0.0))
    env_of = torch.arange(8) % 2
    window = expert.make_plan_window(emap, head[:2], tail[:2], pp)
    want = solve.solve_grid(x0, head, tail, window, env_of, pp)
    win_d = esdf.GridWindow(window.win.to(cuda_device),
                            window.worg.to(cuda_device))
    got = solve.solve_grid(*(a.to(cuda_device) for a in (x0, head, tail)),
                           win_d, env_of.to(cuda_device), pp)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].numpy(),
                               rtol=1e-3)

