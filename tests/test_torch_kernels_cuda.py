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
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, PlannerParams,
                                         SimParams, WorldParams)
from neoplanner_tpu_torch.core import frames
from neoplanner_tpu_torch.core.types import BoxWorld
from neoplanner_tpu_torch.mapping import esdf, fusion, occupancy, scene
from neoplanner_tpu_torch.ops import edt, minco
from neoplanner_tpu_torch.plan import costs, expert, parity, solve
from neoplanner_tpu_torch.sense import raycast
from neoplanner_tpu_torch.sim import env, missions, track
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


def _boundary(n, seed, start=(0.0, 0.0), pp=None):
    """n planning problems ~5 m long from around start: (x0, head, tail),
    x0 of pp's piece count (PlannerParams()'s M = 3 by default)."""
    rng = np.random.default_rng(seed)
    head = np.zeros((n, 3, 2), np.float32)
    tail = np.zeros((n, 3, 2), np.float32)
    head[:, 0] = rng.normal(size=(n, 2)) * [1.0, 0.5] + start
    head[:, 1] = rng.normal(scale=0.3, size=(n, 2))
    tail[:, 0] = head[:, 0] + [5.0, 0.0] + rng.normal(size=(n, 2))
    tail[:, 1] = rng.normal(scale=0.3, size=(n, 2))
    pp = pp or PlannerParams()
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


def _band_systems(n, lower_bw, seed, size=18):
    """n random size x size systems (18 = 6M at M = 3) with lower_bw
    sub-diagonals and 6 - lower_bw super-diagonals (the bands of A and
    A^T), diagonally dominant, two right-hand sides; band entries below the
    pivot exactly 0 in columns 0 and 9 and in a quarter of the others' (A
    (n, size, size), b (n, size, 2))."""
    rng = np.random.default_rng(seed)
    i, j = np.indices((size, size))
    band = (i - j <= lower_bw) & (j - i <= 6 - lower_bw)
    A = rng.normal(size=(n, size, size)) * band
    A[:, i == j] += 6.0 * np.sign(A[:, i == j] + 1e-3)
    below = band & (i > j)
    A[:, below & ((j == 0) | (j == 9))] = 0.0
    A[(rng.random((n, size, size)) < 0.25) & below] = 0.0
    b = rng.normal(size=(n, size, 2))
    return _t(A.astype(np.float32)), _t(b.astype(np.float32))


@pytest.mark.parametrize("lower_bw", [4, 2])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 1023])
def test_minco_kernel_batch_sizes_and_zero_pivots(cuda_device, n, lower_bw):
    """B5 on a block's problems (two warps) and one either side of it, on
    1023 problems (a last block with one warp idle), at both bands, with
    band entries exactly 0 below the pivot: within the 1e-4 of
    test_minco_kernel_matches_plain of the plain version; one launch a call;
    the same input twice gives the same bits."""
    A, b = _band_systems(n, lower_bw, 40 + n)
    want = minco._givens_solve(A, b, lower_bw, 6 - lower_bw)
    Ad, bd = A.to(cuda_device), b.to(cuda_device)
    before = _cuda.launches["minco_banded_solve"]
    got = minco.banded_solve(Ad, bd, lower_bw, 6 - lower_bw)
    again = minco.banded_solve(Ad, bd, lower_bw, 6 - lower_bw)
    torch.cuda.synchronize()
    assert _cuda.launches["minco_banded_solve"] == before + 2
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_minco_kernel_unaligned_aug(cuda_device):
    """aug whose data starts 4 bytes past a 16-byte boundary (the scalar
    staging path): the same bits as from an aligned copy."""
    A, b = _band_systems(77, 4, 3)
    aug = torch.cat([A, b], dim=2).to(cuda_device).contiguous()
    buf = torch.empty(aug.numel() + 1, device=cuda_device)
    view = buf[1:].view(aug.shape)
    view.copy_(aug)
    outs = [torch.empty((77, 18, 2), device=cuda_device) for _ in range(2)]
    minco.launch_banded_solve(aug, outs[0], 4)
    minco.launch_banded_solve(view, outs[1], 4)
    torch.cuda.synchronize()
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
    want = minco._givens_solve(A, b, 4, 2)
    np.testing.assert_allclose(outs[0].cpu().numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-4)


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


def test_render_kernel_strided_poses_match_plain(cuda_device):
    """Row stride 4 and three poses per env in one launch, each pose
    against its own env's scene: the same pixel rule as above."""
    worlds = _worlds(16)
    pos, quat = _poses(48, seed=4)
    pos, quat = pos.reshape(16, 3, 3), quat.reshape(16, 3, 4)
    cam = CameraParams()
    want = raycast.render_depth(worlds, pos, quat, cam, row_stride=4)
    got = raycast.render_depth_auto(_to(worlds, cuda_device),
                                    pos.to(cuda_device), quat.to(cuda_device),
                                    cam, row_stride=4)
    assert got.shape == want.shape == (16, 3, 30, cam.width)
    diff = (got.cpu() - want).abs()
    assert float((diff > 1e-4).float().mean()) <= 1e-3


def _render_pair(worlds, pos, quat, cam, row_stride, dev):
    """The plain render on the CPU and B4 on the card, from the same
    inputs."""
    want = raycast.render_depth(worlds, pos, quat, cam, row_stride)
    got = raycast.render_depth_auto(_to(worlds, dev), pos.to(dev),
                                    quat.to(dev), cam, row_stride).cpu()
    return got, want


@pytest.mark.parametrize("row_stride, frames_per_env", [(1, 1), (4, 3),
                                                        (1, 2)])
def test_render_kernel_ragged_tiles(cuda_device, row_stride, frames_per_env):
    """Frames whose width and height are no multiple of the kernel's tile
    (raycast.TILE_W x TILE_H): partial tiles at both edges, at row stride
    1 and 4 and with several poses per env; the pixel rule above."""
    worlds = _worlds(8, seed=5)
    shape = worlds.shape.clone()
    shape[:, 1::3] = 1
    worlds = worlds.replace(shape=shape)
    pos, quat = _poses(8 * frames_per_env, seed=6)
    if frames_per_env > 1:
        pos = pos.reshape(8, frames_per_env, 3)
        quat = quat.reshape(8, frames_per_env, 4)
    cam = CameraParams(width=3 * raycast.TILE_W + 5,
                       height=2 * raycast.TILE_H * row_stride + 3)
    got, want = _render_pair(worlds, pos, quat, cam, row_stride, cuda_device)
    assert got.shape == want.shape
    assert got.shape[-2:] == (raycast.out_rows(cam, row_stride), cam.width)
    diff = (got - want).abs()
    assert float((diff > 1e-4).float().mean()) <= 1e-3
    assert float((want < cam.max_range).float().mean()) > 0.05


def _edge_scenes():
    """Six one-pose scenes at the identity attitude from (0, 0, 2), three
    primitive slots each [centers, half sizes, shape, active]: (0) a box
    across several tiles' edges; (1) a box 1 mm across the top-left corner
    ray of the tile (1, 10) at 5 m, and a copy 1.5 m to its left; (2) a box
    and a cylinder behind the camera; (3) no live primitive; (4) a box that
    holds the camera, and one ahead; (5) cylinders ahead, one straddling
    tile edges."""
    cam = CameraParams()
    col0, row0 = 10 * raycast.TILE_W, raycast.TILE_H
    d = raycast.ray_dirs_camera(cam)[row0, col0].numpy().astype(np.float64)
    p = np.array([0.0, 0.0, 2.0]) + 5.0 * d
    far = [50.0, 50.0, 1.0]
    scenes = [
        ([[4.0, 0.3, 1.8], far, far], [[0.5, 1.1, 0.9]] + [[0.5] * 3] * 2,
         [0, 0, 0], [1, 0, 0]),
        ([[p[0], p[1] + 0.5 - 1e-3, p[2] + 0.5 - 1e-3],
          [p[0], p[1] + 2.0 - 1e-3, p[2] + 0.5 - 1e-3], far],
         [[0.5] * 3] * 3, [0, 0, 0], [1, 1, 0]),
        ([[-3.0, 0.0, 2.0], [-2.0, 1.0, 1.0], far],
         [[0.5, 0.5, 1.0], [0.3, 0.3, 1.0], [0.5] * 3], [0, 1, 0], [1, 1, 0]),
        ([[3.0, 0.0, 2.0], [4.0, 1.0, 1.0], far], [[0.5] * 3] * 3,
         [0, 1, 0], [0, 0, 0]),
        ([[0.1, 0.0, 2.1], [3.0, 0.5, 1.5], far],
         [[1.0, 1.0, 1.0], [0.5, 0.5, 1.5], [0.5] * 3], [0, 0, 0], [1, 1, 0]),
        ([[3.5, 0.0, 1.5], [5.0, -1.5, 2.0], [4.0, 1.2, 2.5]],
         [[0.6, 0.6, 1.5], [0.4, 0.4, 2.0], [0.3, 0.3, 0.4]], [1, 1, 1],
         [1, 1, 1]),
    ]
    c, h, sh, act = (np.array([sc[i] for sc in scenes]) for i in range(4))
    worlds = BoxWorld(centers=_t(c.astype(np.float32)),
                      half_sizes=_t(h.astype(np.float32)),
                      active=_t(act.astype(bool)),
                      shape=_t(sh.astype(np.int32)))
    n = len(scenes)
    pos = torch.tensor([[0.0, 0.0, 2.0]]).expand(n, 3).contiguous()
    quat = torch.tensor([[1.0, 0.0, 0.0, 0.0]]).expand(n, 4).contiguous()
    return worlds, pos, quat, (row0, col0)


def test_render_kernel_edge_scenes(cuda_device):
    """The edge scenes (_edge_scenes) against the plain version: the pixel
    rule above over all; the grazed corner pixel to 1e-4 m, on the box; the
    scenes behind the camera and with no live primitive as the ground
    alone (bit for bit between their two kernels' frames)."""
    worlds, pos, quat, (row0, col0) = _edge_scenes()
    cam = CameraParams()
    got, want = _render_pair(worlds, pos, quat, cam, 1, cuda_device)
    diff = (got - want).abs()
    assert float((diff > 1e-4).float().mean()) <= 1e-3
    assert float(diff[1, row0, col0]) <= 1e-4
    assert 4.0 < float(want[1, row0, col0]) < 5.1
    assert torch.equal(got[2], got[3])
    for i in (0, 4, 5):   # each scene sees its primitives, not only ground
        assert float((got[i] < got[3] - 1e-3).float().mean()) > 0.01, i


def test_render_kernel_many_primitives(cuda_device):
    """The scene's primitives scattered over 40, 2000 (a table past a
    block's default 48 KB) and raycast.MAX_PRIMS slots, the other slots
    active 1 km away (behind the camera or far ahead, every hit there past
    max_range): the frames equal the unpadded scene's bit for bit; one slot
    past the cap raises before any launch."""
    worlds, pos, quat, base = _render_many_setup(cuda_device)
    cam = CameraParams()
    for n, seed in ((40, 1), (2000, 2), (raycast.MAX_PRIMS, 3)):
        got = raycast.render_depth_auto(_padded_world(worlds, n, seed), pos,
                                        quat, cam)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), base.view(torch.int32)), n
    before = dict(_cuda.launches)
    with pytest.raises(ValueError, match="primitives exceed"):
        raycast.render_depth_auto(_padded_world(worlds, raycast.MAX_PRIMS + 1,
                                                4), pos, quat, cam)
    assert _cuda.launches == before


def _render_many_setup(dev):
    """Four seeded scenes and poses on dev, and their frames."""
    worlds = _to(_worlds(4, seed=9), dev)
    pos, quat = _poses(4, seed=9)
    pos, quat = pos.to(dev), quat.to(dev)
    return worlds, pos, quat, raycast.render_depth_auto(worlds, pos, quat,
                                                        CameraParams())


def _padded_world(worlds, n, seed):
    """worlds with their primitives scattered over n slots, in a seeded
    order, the other slots active boxes 1 km behind or ahead."""
    dev = worlds.centers.device
    E, K = worlds.active.shape
    perm = torch.from_numpy(
        np.random.default_rng(seed).permutation(n)[:K]).to(dev)
    side = torch.where(torch.arange(n, device=dev) % 2 == 0, -1000.0, 1000.0)
    centers = torch.stack([side, torch.zeros_like(side),
                           torch.full_like(side, 2.0)], -1).expand(
        E, n, 3).clone()
    half = torch.full((E, n, 3), 0.5, device=dev)
    shape = torch.zeros((E, n), dtype=worlds.shape.dtype, device=dev)
    active = torch.ones((E, n), dtype=torch.bool, device=dev)
    centers[:, perm] = worlds.centers
    half[:, perm] = worlds.half_sizes
    shape[:, perm] = worlds.shape
    active[:, perm] = worlds.active
    return BoxWorld(centers=centers, half_sizes=half, active=active,
                    shape=shape)


def _in_a_fresh_process(call):
    """Run tests/test_torch_kernels_cuda.<call>(torch.device("cuda")) in a
    new Python process, whose kernels carry no function attribute that an
    earlier launch of this session set."""
    root = Path(__file__).resolve().parent.parent
    code = ("import torch\nfrom tests import test_torch_kernels_cuda as t\n"
            f"t.{call}(torch.device('cuda'))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]


def _render_smem_window(dev):
    """192 primitives: eight poses' survivors' tables fill the default
    48 KB of dynamic shared memory exactly, and the block's static pose
    terms take it past; the frames equal the unpadded scene's bit for
    bit."""
    worlds, pos, quat, base = _render_many_setup(dev)
    got = raycast.render_depth_auto(_padded_world(worlds, 192, 5), pos, quat,
                                    CameraParams())
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), base.view(torch.int32))


def test_render_kernel_past_48kb_with_static_shared_memory(cuda_device):
    """B4 where its dynamic shared memory alone fits the default 48 KB and
    the static share takes the block past it, as the first launch of the
    kernel in its process."""
    _in_a_fresh_process("_render_smem_window")


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
    st = st.replace(emap=esdf.build(occ, ORIGIN, 0.1, 2.0, lite=True),
                    drone=st.drone.replace(pos=st.drone.pos + torch.tensor(
                        [3.0, 0.0, 0.0])))
    cmds = _cmds(4, x0=3.0)
    want = track.track_segment_grid(st, cmds, pp, mp, sp)
    assert float(want[3][:, 2].max()) > 0.0
    got = track.track_segment_grid(_to(st, cuda_device), cmds.to(cuda_device),
                                   pp, mp, sp)
    _assert_track_match(want, got)


@pytest.mark.parametrize("grid", [False, True])
def test_track_kernels_from_substep_30_match_plain(cuda_device, grid):
    """B3 and B10 on the second half of a segment (i0 = 30), as the
    sensor-rate loop's chunks call them: the tolerances above."""
    pp, mp, sp = PlannerParams(), MissionParams(), SimParams()
    kw = dict(sensing="depth", plan_map="grid") if grid else {}
    mapp = MapParams(**MAPP, edt_truncation=2.0, fusion="2d_dense")
    st = env.reset(_worlds(4, seed=8), pp, mp, mapp,
                   _cuda.make_generator(1, "cpu"),
                   goal=torch.tensor([[0.3, 0.0]]).expand(4, 2), **kw)
    cmds = _cmds(4)[:, :30]
    fn = track.track_segment_grid if grid else track.track_segment
    want = fn(st, cmds, pp, mp, sp, i0=30)
    got = fn(_to(st, cuda_device), cmds.to(cuda_device), pp, mp, sp, i0=30)
    _assert_track_match(want, got)
    assert bool(want[1].any()) and float(want[3][:, 0].min()) > 0.0


def _edge_track_state(n, grid, dev=None):
    """n envs (n not a multiple of the kernel's warps a block), each in one
    of five cases by n % 5: (0) flying to a far goal; (1) a goal 0.3 m
    ahead, reached mid-segment; (2) taking off (moving, no metric); (3)
    hovering and (4) done, frozen out of the mission phase with their
    attitude kept; env 3 enters with reached set."""
    pp, mp = PlannerParams(), MissionParams()
    mapp = MapParams(**MAPP, edt_truncation=2.0, fusion="2d_dense")
    kw = dict(sensing="depth", plan_map="grid") if grid else {}
    rng = np.random.default_rng(n)
    goal = np.where((np.arange(n) % 5 == 1)[:, None], [[0.3, 0.0]],
                    [[20.0, 0.0]]).astype(np.float32)
    st = env.reset(_worlds(n, seed=8), pp, mp, mapp,
                   _cuda.make_generator(1, "cpu"), goal=_t(goal), **kw)
    phase = torch.full((n,), missions.PHASE_MISSION, dtype=torch.int32)
    phase[np.arange(n) % 5 == 2] = missions.PHASE_TAKEOFF
    phase[np.arange(n) % 5 == 3] = missions.PHASE_HOVER
    phase[np.arange(n) % 5 == 4] = missions.PHASE_DONE
    reached = st.reached.clone()
    reached[3] = True
    _, quat = _poses(n, seed=n)
    st = st.replace(phase=phase, reached=reached,
                    drone=st.drone.replace(quat=quat, pos=st.drone.pos + _t(
                        rng.normal(scale=0.05, size=(n, 3)).astype(
                            np.float32))))
    return st, pp, mp, SimParams()


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("n, spr, i0", [(7, 60, 0), (37, 10, 30),
                                        (37, 10, 0), (13, 60, 0)])
def test_track_kernels_edge_envs(cuda_device, grid, n, spr, i0):
    """B3 / B10 on the edge cases of _edge_track_state, from substep i0,
    over spr substeps, against the plain version at the tolerances above;
    the frozen envs keep their attitude bit for bit."""
    st, pp, mp, sp = _edge_track_state(n, grid)
    cmds = _cmds(n, spr=spr)
    fn = track.track_segment_grid if grid else track.track_segment
    want = fn(st, cmds, pp, mp, sp, i0=i0)
    got = fn(_to(st, cuda_device), cmds.to(cuda_device), pp, mp, sp, i0=i0)
    _assert_track_match(want, got)
    frozen = torch.from_numpy(np.isin(np.arange(n) % 5, (3, 4)))
    assert torch.equal(got[0].quat.cpu()[frozen].view(torch.int32),
                       st.drone.quat[frozen].view(torch.int32))
    moving = ~frozen & ~st.reached
    assert not torch.equal(got[0].quat.cpu()[moving], st.drone.quat[moving])
    if spr == 60:
        reached_now = want[1] & ~st.reached
        assert bool(reached_now[np.arange(n) % 5 == 1].any())


def _padded_scene(scene_, n, order_seed):
    """scene_ with its primitives scattered over n slots, in a seeded
    order, the other slots active 1 km away."""
    E, K = scene_.active.shape
    perm = np.random.default_rng(order_seed).permutation(n)[:K]
    centers = torch.full((E, n, 2), 1000.0)
    half = torch.full((E, n, 2), 0.5)
    is_cyl = torch.zeros((E, n), dtype=torch.bool)
    active = torch.ones((E, n), dtype=torch.bool)
    centers[:, perm] = scene_.centers
    half[:, perm] = scene_.half
    is_cyl[:, perm] = scene_.is_cyl
    active[:, perm] = scene_.active
    return scene.SceneMap(centers, half, is_cyl, active)


def test_track_kernel_many_primitives(cuda_device):
    """B3 past the one-thread kernel's 32 primitives: the scene's
    primitives scattered over 40, 100 and track.MAX_PRIMS slots (the rest
    active but 1 km away) give the unpadded scene's outputs bit for bit and
    agree with the plain version; one slot past the cap raises before any
    launch. The goal is the paths' block at x = 4, so the collision metric
    is live."""
    pp, mp, sp = PlannerParams(), MissionParams(), SimParams()
    st, box, cmds, base = _track_many_setup(cuda_device)
    for k, seed in ((40, 1), (100, 2), (track.MAX_PRIMS, 3)):
        st_k = st.replace(scene=_padded_scene(box, k, seed))
        got = track.track_segment(_to(st_k, cuda_device),
                                  cmds.to(cuda_device), pp, mp, sp)
        for g, b in zip(got[1:], base[1:]):
            assert torch.equal(g, b), k
        for f in ("pos", "vel", "quat", "yaw"):
            assert torch.equal(getattr(got[0], f), getattr(base[0], f)), k
        if k == 100:
            _assert_track_match(track.track_segment(st_k, cmds, pp, mp, sp),
                                got)
    before = dict(_cuda.launches)
    st_k = st.replace(scene=_padded_scene(box, track.MAX_PRIMS + 1, 4))
    with pytest.raises(ValueError, match="primitives exceed"):
        track.track_segment(_to(st_k, cuda_device), cmds.to(cuda_device),
                            pp, mp, sp)
    assert _cuda.launches == before


def _track_many_setup(dev):
    """Six seeded envs with a box on their path (the collision metric is
    live), their commands, and their segment tracked on dev."""
    pp, mp, sp = PlannerParams(), MissionParams(), SimParams()
    n = 6
    st = env.reset(_worlds(n, seed=8), pp, mp, MapParams(**MAPP),
                   _cuda.make_generator(1, "cpu"),
                   goal=torch.tensor([[20.0, 0.0]]).expand(n, 2))
    sc = st.scene
    box = scene.SceneMap(
        torch.cat([sc.centers, torch.tensor([[[1.0, 0.25]]]).expand(
            n, 1, 2)], 1),
        torch.cat([sc.half, torch.full((n, 1, 2), 0.3)], 1),
        torch.cat([sc.is_cyl, torch.zeros((n, 1), dtype=torch.bool)], 1),
        torch.cat([sc.active, torch.ones((n, 1), dtype=torch.bool)], 1))
    st = st.replace(scene=box)
    cmds = _cmds(n)
    base = track.track_segment(_to(st, dev), cmds.to(dev), pp, mp, sp)
    assert float(base[3][:, 2].max()) > 0.0
    return st, box, cmds, base


def _track_smem_window(dev):
    """400 primitives: the warps' tables (38,400 B) fit the default 48 KB
    of dynamic shared memory and their stages (15,360 B, static) take the
    block past it; the outputs equal the unpadded scene's bit for bit."""
    pp, mp, sp = PlannerParams(), MissionParams(), SimParams()
    st, box, cmds, base = _track_many_setup(dev)
    got = track.track_segment(
        _to(st.replace(scene=_padded_scene(box, 400, 5)), dev), cmds.to(dev),
        pp, mp, sp)
    for g, b in zip(got[1:], base[1:]):
        assert torch.equal(g, b)
    for f in ("pos", "vel", "quat", "yaw"):
        assert torch.equal(getattr(got[0], f), getattr(base[0], f)), f


def test_track_kernel_past_48kb_with_static_shared_memory(cuda_device):
    """B3 where its dynamic shared memory alone fits the default 48 KB and
    the static share takes the block past it, as the first launch of the
    kernel in its process."""
    _in_a_fresh_process("_track_smem_window")


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


# ---- B8 v1: windowed dense depth fusion


@pytest.mark.parametrize("mapp_kw, cam_kw", [
    (dict(fusion="2d_dense"), dict(max_range=4.0)),
    (dict(width=120, height=96, origin_x=-2.0, origin_y=-4.8,
          fusion="2d_dense"), dict())])
def test_window_fusion_kernel_matches_plain(cuda_device, mapp_kw, cam_kw):
    """Three frames fused in sequence on maps that v2 does not take (the
    448 x 256 default map with a 4 m camera, whose 114-cell windows follow
    the drones and clamp at the map's corner, and a 120 x 96 map with the
    6 m camera): as B8 v2, at most 1e-4 of the updated cells may differ,
    each by exactly one l_miss or l_hit quantum; cells outside the windows
    keep their values but for the hits."""
    cam = CameraParams(**cam_kw)
    mp = MapParams(**mapp_kw)
    small = mp.width < 200
    worlds = _worlds(3)
    if small:
        worlds = worlds.replace(centers=worlds.centers - torch.tensor(
            [3.0, 0.0, 0.0]))
    lo = occupancy.logodds_init(mp, 3)
    lo_g = lo.to(cuda_device)
    quanta = torch.tensor([occupancy._l(mp.prob_miss),
                           occupancy._l(mp.prob_hit)]).abs()
    before = _cuda.launches["fuse_depth_window"]
    for seed in (4, 5, 6):
        pos, quat = _poses(3, seed, x=(0.0, 3.0))
        if not small:          # the third drone by the map's corner
            pos[2, :2] = torch.tensor([-7.0, -11.5])
        depth = raycast.render_depth(worlds, pos, quat, cam)
        lo = fusion.insert_depth_2d_dense(lo, depth, pos, quat, cam, mp)
        lo_g = fusion.insert_depth_2d_dense(
            lo_g, depth.to(cuda_device), pos.to(cuda_device),
            quat.to(cuda_device), cam, mp)
    assert _cuda.launches["fuse_depth_window"] == before + 3
    diff = (lo_g.cpu() - lo).abs()
    off = diff > 0
    assert int((lo < 0).sum()) > 1000
    assert int(off.sum()) <= 1e-4 * int((lo != 0).sum())
    if off.any():
        step = (diff[off][:, None] - quanta[None]).abs().amin(1)
        assert float(step.max()) <= 1e-5


def _window_want(lo, tabs, sc_w, org, hit, cam, mp):
    """B8 v1's contract on any grid: each window cell clip(v + l_miss) where
    the carve frees it and clip(v) elsewhere, then each hit cell, inside the
    window or not, k clipped adds of l_hit for its k hits; every other cell
    as it was. On a grid within the clamp bounds this is
    fusion._fuse_window_plain, which (as the reference) clips the whole
    grid after the hits; past the bounds the kernel keeps the cells that no
    update touches, as the compare-and-swap scatter before it did."""
    B = lo.shape[0]
    dev = lo.device
    ch, cw = fusion._window_cells(cam, mp)
    _, _, _, l_hit, l_miss, l_min, l_max = fusion._param_tensors(cam, mp, dev)
    rows = (org[:, 0:1].long() + torch.arange(ch, device=dev))[:, :, None]
    cols = (org[:, 1:2].long() + torch.arange(cw, device=dev))[:, None, :]
    envs = torch.arange(B, device=dev)[:, None, None]
    out = lo.clone()
    carve = fusion._carve_update((B, ch, cw), tabs, sc_w, cam, mp,
                                 half_even=True) != 0
    v = out[envs, rows, cols]
    out[envs, rows, cols] = torch.clamp(torch.where(carve, v + l_miss, v),
                                        l_min, l_max)
    flat = out.reshape(-1)
    cells, counts = torch.unique(hit[hit >= 0], return_counts=True)
    for k in range(int(counts.max()) if counts.numel() else 0):
        sel = cells[counts > k]
        flat[sel] = torch.clamp(flat[sel] + l_hit, l_min, l_max)
    return out


def _window_case(seed, dev, in_bounds=True, hit_repeats=3):
    """B8 v1's inputs on the default map with the 4 m camera, 16 envs: a
    camera by each of the map's four corners (and past them), so that its
    window clamps there, the others inside, at yaws along each axis and
    yaws that lay an image edge on one; random tables in [0, 4.2] m (a
    fifth of the columns 0); a grid within the clamp bounds (in_bounds) or
    uniform in [-4, 5], with -0.0 on every 7th row and 5th column; hits on
    a third of the columns on random cells of the whole grid (most outside
    the wedge and the window), hit_repeats columns on one cell, one in the
    last cell of the grid. Returns (mp, cam, lo, tabs, sc_w, org, hit) on
    dev, hit the flat index into the (B, H, W) grid (-1: none)."""
    rng = np.random.default_rng(seed)
    mp = MapParams(fusion="2d_dense")
    cam = CameraParams(max_range=4.0)
    B, H, W = 16, mp.height, mp.width
    half = cam.hfov / 2.0
    yaws = np.array([0.0, np.pi / 2, -np.pi / 2, np.pi, half, -half,
                     np.pi / 2 + half, np.pi - half])
    x_lo, y_lo = mp.origin_x, mp.origin_y
    x_hi, y_hi = x_lo + W * mp.resolution, y_lo + H * mp.resolution
    xy = np.stack([rng.uniform(x_lo + 6, x_hi - 6, B),
                   rng.uniform(y_lo + 6, y_hi - 6, B)], -1)
    xy[:4] = [(x_lo + 0.3, y_lo + 0.3), (x_hi + 0.5, y_lo + 1.0),
              (x_lo - 1.0, y_hi - 0.2), (x_hi - 0.4, y_hi + 0.4)]
    yaw = yaws[rng.integers(0, len(yaws), B)]
    yaw[:4] = [np.pi / 4, 3 * np.pi / 4, -np.pi / 4, -3 * np.pi / 4]
    z = np.zeros(B)
    sc = np.stack([np.full(B, x_lo + 0.5 * mp.resolution),
                   np.full(B, y_lo + 0.5 * mp.resolution), xy[:, 0], xy[:, 1],
                   np.cos(yaw), np.sin(yaw), z, z], 1).astype(np.float32)
    pos = np.concatenate([xy, np.full((B, 1), 2.0)], 1).astype(np.float32)
    sc_w, org = fusion._window_inputs(_t(sc), _t(pos), cam, mp)
    tabs = rng.uniform(0.0, 4.2, (B, cam.width)).astype(np.float32)
    tabs[rng.random((B, cam.width)) < 0.2] = 0.0
    cell = np.where(rng.random((B, cam.width)) < 1 / 3,
                    rng.integers(0, H * W, (B, cam.width)), -1)
    cell[:, :hit_repeats] = rng.integers(0, H * W, (B, 1))
    cell[:, -1] = H * W - 1
    hit = np.where(cell >= 0, cell + np.arange(B)[:, None] * (H * W), -1)
    l_min, l_max = occupancy._l(mp.clamp_min), occupancy._l(mp.clamp_max)
    lo = (rng.uniform(l_min, l_max, (B, H, W)) if in_bounds
          else rng.uniform(-4.0, 5.0, (B, H, W))).astype(np.float32)
    lo[:, ::7, ::5] = -0.0
    return (mp, cam, _t(lo).to(dev), _t(tabs).to(dev), sc_w.to(dev),
            org.to(dev), _t(hit).to(dev))


def _window_kernel(mp, cam, lo, tabs, sc_w, org, hit):
    """B8 v1 in place on a copy of lo: (the grid, its launches)."""
    out = lo.clone()
    before = _cuda.launches["fuse_depth_window"]
    fusion.launch_fuse_window(out, tabs, sc_w, org, hit, cam, mp)
    torch.cuda.synchronize()
    return out, _cuda.launches["fuse_depth_window"] - before


@pytest.mark.parametrize("seed", [50, 51])
def test_window_kernel_corners_and_axis_yaws(cuda_device, seed):
    """B8 v1 on windows clamped at each of the map's corners and cameras at
    axis and image-edge yaws, hits outside the wedge and the window and
    three on one cell, a grid within the clamp bounds holding -0.0: 0 cells
    differ from the plain version run on the card, in one launch; the
    carve touched cells, the reach test keeps a minority of the strips,
    and -0.0 stays -0.0 in window cells the carve leaves."""
    mp, cam, lo, tabs, sc_w, org, hit = _window_case(seed, cuda_device)
    ch, cw = fusion._window_cells(cam, mp)
    assert {0, mp.height - ch} <= set(org[:, 0].tolist())
    assert {0, mp.width - cw} <= set(org[:, 1].tolist())
    out, runs = _window_kernel(mp, cam, lo, tabs, sc_w, org, hit)
    want = fusion._fuse_window_plain(lo, tabs, sc_w, org, hit, cam, mp)
    assert runs == 1
    assert int((out != want).sum()) == 0
    assert int((_window_want(lo, tabs, sc_w, org, hit, cam, mp) != out)
               .sum()) == 0
    l_miss = occupancy._l(mp.prob_miss)
    assert int((want - lo <= l_miss / 2).sum()) > 1000
    keep = fusion.window_reach(tabs, sc_w, cam, mp,
                               (fusion.WARP_H, fusion.WARP_W))
    assert 0.0 < float(keep.float().mean()) < 0.6
    neg0 = (lo == 0) & torch.signbit(lo) & (want == 0)
    assert int(neg0.sum()) > 0
    assert bool(torch.signbit(out[neg0]).all())


def test_window_kernel_grid_past_clamp_bounds(cuda_device):
    """A grid uniform in [-4, 5], past both clamp bounds, holding -0.0: the
    window cells are clipped, every hit cell takes its k clipped adds, and
    every other cell keeps its bits (_window_want); 0 cells differ."""
    mp, cam, lo, tabs, sc_w, org, hit = _window_case(52, cuda_device,
                                                     in_bounds=False)
    out, _ = _window_kernel(mp, cam, lo, tabs, sc_w, org, hit)
    want = _window_want(lo, tabs, sc_w, org, hit, cam, mp)
    assert int((out != want).sum()) == 0
    untouched = want.view(torch.int32) == lo.view(torch.int32)
    assert torch.equal(out.view(torch.int32)[untouched],
                       lo.view(torch.int32)[untouched])
    assert float(lo.max()) > occupancy._l(mp.clamp_max)
    assert float(out.max()) > occupancy._l(mp.clamp_max)   # outside: kept


def test_window_kernel_hits_outside_the_wedge_and_the_window(cuda_device):
    """Tables of all res (nothing carves): seven hits on one cell outside
    the window, five on one inside it, the rest on random cells of the
    whole grid; and a rendered frame whose hits fall outside the window
    (the pitched drone of test_torch_fusion_cull's room). Every hit is
    added, as k clipped adds, in the one launch."""
    mp, cam, lo, tabs, sc_w, org, hit = _window_case(53, cuda_device,
                                                     hit_repeats=0)
    tabs = torch.full_like(tabs, mp.resolution)
    H, W = mp.height, mp.width
    r0, c0 = org[4].tolist()
    far = 4 * H * W + ((r0 + 120) % H) * W + (c0 + 120) % W
    near = 4 * H * W + (r0 + 60) * W + c0 + 60
    hit[4, :7] = far
    hit[4, 7:12] = near
    out, runs = _window_kernel(mp, cam, lo, tabs, sc_w, org, hit)
    want = fusion._fuse_window_plain(lo, tabs, sc_w, org, hit, cam, mp)
    assert runs == 1 and int((out != want).sum()) == 0
    l_hit, l_max = occupancy._l(mp.prob_hit), occupancy._l(mp.clamp_max)
    v = float(lo.reshape(-1)[far])
    assert float(out.reshape(-1)[far]) == pytest.approx(
        min(v + 7 * l_hit, l_max), abs=1e-5)
    # a rendered frame: the pitched drone in a room 5.9 m wide sees past
    # its window
    from tests.test_torch_fusion_cull import _room
    cam4 = CameraParams(max_range=4.0)
    world, pos, quat = _room()
    depth = raycast.render_depth(world, pos, quat, cam4)
    tabs, sc, hit = fusion._inputs(depth, pos, quat, cam4, mp)
    sc_w, org = fusion._window_inputs(sc, pos, cam4, mp)
    lo = occupancy.logodds_init(mp, 1)
    args = [t.to(cuda_device) for t in (lo, tabs, sc_w, org, hit)]
    out, _ = _window_kernel(mp, cam4, *args)
    want = fusion._fuse_window_plain(*args, cam4, mp)
    assert int((out != want).sum()) == 0
    ch, cw = fusion._window_cells(cam4, mp)
    r, c = hit // W, hit % W
    inside = ((r >= org[:, :1]) & (r < org[:, :1] + ch)
              & (c >= org[:, 1:]) & (c < org[:, 1:] + cw))
    outside = hit[(hit >= 0) & ~inside]
    assert outside.numel() >= 5
    assert bool((out.cpu().reshape(-1)[outside] > 0).all())


def test_window_kernel_rounds_half_to_even(cuda_device):
    """An image 158 columns wide has half_w = 78.5: a camera at yaw 0 on a
    row of window cell centres gives the cells ahead of it on that row
    u = 78.5 exactly, which v1 rounds to column 78 (half to even) and v2's
    floor(u + 0.5) to 79. With tables of 1.5 m at column 78 and 3.5 m at 79
    the two roundings carve different cells; the kernel carves v1's, 0
    cells differing from the plain version."""
    mp = MapParams(fusion="2d_dense")
    cam = CameraParams(width=158, max_range=4.0)
    assert fusion.window_fits(cam, mp)
    B = 2
    xy = torch.tensor([[10.0, 0.0], [-5.0, 7.3]])
    z = torch.zeros(B)
    sc = torch.stack([torch.full((B,), mp.origin_x + 0.5 * mp.resolution),
                      torch.full((B,), mp.origin_y + 0.5 * mp.resolution),
                      xy[:, 0], xy[:, 1], torch.ones(B), z, z, z], 1)
    pos = torch.cat([xy, torch.full((B, 1), 2.0)], 1)
    sc_w, org = fusion._window_inputs(sc, pos, cam, mp)
    sc_w[:, 3] = sc_w[:, 1] + torch.tensor(50.0) * torch.tensor(
        mp.resolution, dtype=torch.float32)
    tabs = torch.full((B, cam.width), 2.0)
    tabs[:, 78], tabs[:, 79] = 1.5, 3.5
    hit = torch.full((B, cam.width), -1, dtype=torch.int64)
    lo = occupancy.logodds_init(mp, B)
    ch, cw = fusion._window_cells(cam, mp)
    even = fusion._carve_update((B, ch, cw), tabs, sc_w, cam, mp,
                                half_even=True)
    up = fusion._carve_update((B, ch, cw), tabs, sc_w, cam, mp)
    assert int((even != up).sum()) >= 2 * 15
    args = [t.to(cuda_device) for t in (lo, tabs, sc_w, org, hit)]
    out, runs = _window_kernel(mp, cam, *args)
    want = fusion._fuse_window_plain(*args, cam, mp)
    assert runs == 1 and int((out != want).sum()) == 0


def test_window_kernel_repeats_bits(cuda_device):
    """The same input twice gives the same bits (the hit counts in shared
    memory and the outside list take atomics in any order)."""
    mp, cam, lo, tabs, sc_w, org, hit = _window_case(54, cuda_device,
                                                     in_bounds=False,
                                                     hit_repeats=9)
    a, _ = _window_kernel(mp, cam, lo, tabs, sc_w, org, hit)
    b, _ = _window_kernel(mp, cam, lo, tabs, sc_w, org, hit)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_window_kernel_refuses_past_limits(cuda_device):
    """An image width of 28,524 is past a v1 block's shared memory: the
    wrapper raises before any launch. The C entry refuses it too, and a
    window past 128 cells a side or larger than the grid
    (cudaErrorInvalidValue)."""
    mp, cam, lo, tabs, sc_w, org, hit = _window_case(55, cuda_device)
    B, H, W = lo.shape
    before = dict(_cuda.launches)
    wide = CameraParams(width=28524, max_range=4.0)
    with pytest.raises(ValueError, match="image width"):
        fusion.launch_fuse_window(
            lo, torch.zeros((B, 28524), device=cuda_device), sc_w, org,
            torch.full((B, 28524), -1, dtype=torch.int64,
                       device=cuda_device), wide, mp)
    assert _cuda.launches == before
    lib = _cuda.load()
    params = _cuda.host_floats(fusion._params(cam, mp))
    for ch, cw, w in ((129, 114, 160), (114, 129, 160), (114, 114, 28524),
                      (H + 1, 114, 160)):
        err = lib.neo_fuse_depth_window(
            _cuda.ptr(lo), _cuda.ptr(tabs), _cuda.ptr(sc_w), _cuda.ptr(org),
            _cuda.ptr(hit), B, H, W, ch, cw, w, params,
            _cuda.stream_ptr(cuda_device))
        assert err != 0


# ---- B8 v3: multi-frame dense depth fusion


def test_multi_fusion_kernel_matches_plain(cuda_device):
    """Three segments of three frames each, rendered at row stride 4 and
    fused with one call per segment, so the clamp bounds engage: the rule
    of the v2 test above (the same carve arithmetic; hit counts exact)."""
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
        pos, quat = _poses(6, seed, x=(0.0, 1.5))
        pos, quat = pos.reshape(2, 3, 3), quat.reshape(2, 3, 4)
        depth = raycast.render_depth(worlds, pos, quat, cam, row_stride=4)
        lo = fusion.insert_depth_2d_dense_multi(lo, depth, pos, quat, cam, mp,
                                                row_stride=4)
        lo_g = fusion.insert_depth_2d_dense_multi(
            lo_g, depth.to(cuda_device), pos.to(cuda_device),
            quat.to(cuda_device), cam, mp, row_stride=4)
    assert int((lo == occupancy._l(mp.clamp_min)).sum()) > 0
    diff = (lo_g.cpu() - lo).abs()
    off = diff > 0
    assert int(off.sum()) <= 1e-4 * int((lo != 0).sum())
    if off.any():
        step = (diff[off][:, None] - quanta[None]).abs().amin(1)
        assert float(step.max()) <= 1e-5


# ---- B8 v2 and v3 on their tiles (csrc/fusion_tile.cuh)


def _tile_case(B, F, H, W, seed, dev, hit_repeats=3):
    """Random fusion inputs on an (H, W) map of 0.1 m cells: cameras on
    tile corners (the first cell centre of a 32 x 32 tile, half a cell
    off it, or a tile edge's midpoint) at yaws along the axes and the yaws
    that lay a field-of-view edge on one, random tables in [0, 8.2] m
    (a fifth of the columns 0), a grid uniform in [-4, 5] (past both clamp
    bounds) with -0.0 on every 7th row and 5th column, and hits: a third
    of the columns on random cells of the whole grid (most of them in
    tiles the wedge misses), hit_repeats columns on one cell, one in the
    last cell of the grid. Returns (mp, cam, lo, tabs, sc, cell) on dev,
    cell (B, F, w) the hit cell in the env's grid (-1: none)."""
    rng = np.random.default_rng(seed)
    mp = MapParams(width=W, height=H, origin_x=-4.0, origin_y=-9.6,
                   fusion="2d_dense")
    cam = CameraParams()
    half_fov = np.arctan((cam.width / 2.0) / cam.fx)
    yaws = np.array([0.0, np.pi / 2, -np.pi / 2, np.pi, half_fov,
                     -half_fov, np.pi / 2 + half_fov, np.pi - half_fov])
    n = B * F
    ty = rng.integers(0, -(-H // fusion.TILE_H), n)
    tx = rng.integers(0, -(-W // fusion.TILE_W), n)
    off = rng.choice([0.0, -0.5, 15.5], size=(n, 2)) * mp.resolution
    cx = mp.origin_x + (tx * fusion.TILE_W + 0.5) * mp.resolution + off[:, 0]
    cy = mp.origin_y + (ty * fusion.TILE_H + 0.5) * mp.resolution + off[:, 1]
    yaw = yaws[rng.integers(0, len(yaws), n)]
    z = np.zeros(n)
    sc = np.stack([np.full(n, mp.origin_x + 0.5 * mp.resolution),
                   np.full(n, mp.origin_y + 0.5 * mp.resolution), cx, cy,
                   np.cos(yaw), np.sin(yaw), z, z], 1).astype(np.float32)
    tabs = rng.uniform(0.0, 8.2, (n, cam.width)).astype(np.float32)
    tabs[rng.random((n, cam.width)) < 0.2] = 0.0
    cell = np.where(rng.random((n, cam.width)) < 1 / 3,
                    rng.integers(0, H * W, (n, cam.width)), -1)
    cell[:, :hit_repeats] = rng.integers(0, H * W, (n, 1))
    cell[:, -1] = H * W - 1
    lo = rng.uniform(-4.0, 5.0, (B, H, W)).astype(np.float32)
    lo[:, ::7, ::5] = -0.0
    return (mp, cam, _t(lo).to(dev),
            _t(tabs.reshape(B, F, -1)).to(dev),
            _t(sc.reshape(B, F, 8)).to(dev),
            _t(cell.reshape(B, F, -1)).to(dev))


def _tile_kernels_off(mp, cam, lo, tabs, sc, cell):
    """B8 v3 on all F frames and B8 v2 on the first, each against its plain
    version on the card (the same f32 operations, each rounded once):
    the cells whose values differ, and each kernel's launches."""
    B, F = tabs.shape[:2]
    H, W = lo.shape[1:]
    before = dict(_cuda.launches)
    out3 = torch.empty_like(lo)
    fusion.launch_fuse_multi(lo, tabs, sc, cell.to(torch.int32).contiguous(),
                             out3, cam, mp)
    want3 = fusion._fuse_multi_plain(lo, tabs, sc, cell.to(torch.int32), cam,
                                     mp)
    envs = torch.arange(B, device=lo.device)[:, None] * (H * W)
    hit2 = torch.where(cell[:, 0] >= 0, cell[:, 0] + envs, -1).contiguous()
    t2, s2 = tabs[:, 0].contiguous(), sc[:, 0].contiguous()
    out2 = torch.empty_like(lo)
    fusion.launch_fuse(lo, t2, s2, hit2, out2, cam, mp)
    want2 = fusion._fuse_plain(lo, t2, s2, hit2, cam, mp)
    torch.cuda.synchronize()
    runs = {k: _cuda.launches[k] - before[k]
            for k in ("fuse_depth_multi", "fuse_depth_dense")}
    return (int((out3 != want3).sum()), int((out2 != want2).sum()), runs,
            want3, want2)


@pytest.mark.parametrize("F, H, W", [(1, 200, 384), (5, 192, 256),
                                     (68, 200, 128)])
def test_fusion_tile_kernels_at_reach_edges(cuda_device, F, H, W):
    """B8 v2 and v3 on cameras at tile corners and edges with axis yaws,
    hits in tiles the wedge misses, a grid past the clamp bounds holding
    -0.0; F = 1, 5 and 68 (the launcher's limit at w = 160) on maps whose
    H is not a multiple of the tile height (200 rows: a last tile of 8).
    0 cells may differ from the plain versions; v2 is one launch. The
    carve must have touched cells, and the kept share of tile-frames must
    be a minority."""
    mp, cam, lo, tabs, sc, cell = _tile_case(4, F, H, W, 30 + F, cuda_device)
    off3, off2, runs, want3, want2 = _tile_kernels_off(mp, cam, lo, tabs, sc,
                                                       cell)
    assert (off3, off2) == (0, 0)
    assert runs == {"fuse_depth_multi": 1, "fuse_depth_dense": 1}
    l_miss = occupancy._l(mp.prob_miss)
    clipped = torch.clamp(lo, occupancy._l(mp.clamp_min),
                          occupancy._l(mp.clamp_max))
    assert int((want2 - clipped <= l_miss / 2).sum()) > 100
    keep = fusion.tile_reach(tabs, sc, cam, mp)
    assert 0.0 < float(keep.float().mean()) < 0.6


def test_fusion_tile_kernels_count_hits_outside_the_wedge(cuda_device):
    """Hits on cells of tiles that no frame reaches (the tables all res,
    so nothing carves), seven on one cell of the last partial tile: both
    kernels add every hit, v3 as k * l_hit in one clip, v2 as k clipped
    adds."""
    mp, cam, lo, tabs, sc, cell = _tile_case(3, 4, 200, 256, 7, cuda_device,
                                             hit_repeats=7)
    tabs = torch.full_like(tabs, mp.resolution)
    assert not bool(fusion.tile_reach(tabs, sc, cam, mp).any())
    cell[:, :, :7] = 199 * 256 + 250
    off3, off2, _, want3, want2 = _tile_kernels_off(mp, cam, lo, tabs, sc,
                                                    cell)
    assert (off3, off2) == (0, 0)
    k = int((cell[0, 0] == 199 * 256 + 250).sum())
    v = min(max(float(lo[0, 199, 250]), occupancy._l(mp.clamp_min)),
            occupancy._l(mp.clamp_max))
    assert k >= 7 and float(want2[0, 199, 250]) == pytest.approx(
        min(v + k * occupancy._l(mp.prob_hit), occupancy._l(mp.clamp_max)),
        abs=1e-5)


def test_fusion_tile_kernels_unaligned_and_ragged(cuda_device):
    """Scalar loads and stores: a grid whose data starts 4 bytes past a
    16-byte boundary, and a 37 x 70 map (W % 4 != 0, both tile dimensions
    ragged); bit for bit against the aligned copy and the plain version."""
    mp, cam, lo, tabs, sc, cell = _tile_case(2, 3, 96, 128, 9, cuda_device)
    buf = torch.empty(lo.numel() + 1, device=cuda_device)
    view = buf[1:].view(lo.shape)
    view.copy_(lo)
    cell32 = cell.to(torch.int32).contiguous()
    outs = []
    for grid in (lo, view):
        o = torch.empty(lo.numel() + 1, device=cuda_device)[1:].view(lo.shape)
        fusion.launch_fuse_multi(grid, tabs, sc, cell32, o, cam, mp)
        outs.append(o)
    torch.cuda.synchronize()
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
    mp, cam, lo, tabs, sc, cell = _tile_case(2, 3, 37, 70, 10, cuda_device)
    off3, off2, runs, _, _ = _tile_kernels_off(mp, cam, lo, tabs, sc, cell)
    assert (off3, off2) == (0, 0)


def test_fusion_tile_kernels_refuse_past_limits(cuda_device):
    """69 frames of width 160 (v3) and one frame of width 28,533 (v2) are
    past a block's shared memory: the wrappers raise before any launch,
    and the C entry refuses too (cudaErrorInvalidValue)."""
    mp, cam, lo, tabs, sc, cell = _tile_case(2, 69, 64, 128, 12, cuda_device)
    before = dict(_cuda.launches)
    out = torch.empty_like(lo)
    with pytest.raises(ValueError, match="frames"):
        fusion.launch_fuse_multi(lo, tabs, sc, cell.to(torch.int32), out,
                                 cam, mp)
    wide = CameraParams(width=28533)
    with pytest.raises(ValueError, match="frames"):
        fusion.launch_fuse(lo, torch.zeros((2, 28533), device=cuda_device),
                           sc[:, 0].contiguous(),
                           torch.full((2, 28533), -1, dtype=torch.int64,
                                      device=cuda_device), out, wide, mp)
    assert _cuda.launches == before
    err = _cuda.load().neo_fuse_depth_multi(
        _cuda.ptr(lo), _cuda.ptr(tabs), _cuda.ptr(sc),
        _cuda.ptr(cell.to(torch.int32).contiguous()), _cuda.ptr(out), 2, 69,
        64, 128, 160, _cuda.host_floats(fusion._params(cam, mp)),
        _cuda.stream_ptr(cuda_device))
    assert err != 0


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


# ---- B9 exact and B9 banded: occupancy -> f32 ESDF


def _occupancy_grids():
    rng = np.random.default_rng(6)
    out = [(rng.uniform(0, 1, size=(3, 256, 448)) < d).astype(np.float32)
           for d in (0.002, 0.05)]
    out.append((rng.uniform(0, 1, size=(2, 37, 53)) < 0.1).astype(
        np.float32))
    one = np.zeros((2, 40, 40), np.float32)
    one[0, 10, 25] = 1.0
    out += [one, np.ones((1, 16, 24), np.float32),
            np.zeros((1, 16, 24), np.float32)]
    return [_t(g) for g in out]


def test_edt_exact_kernel_matches_plain(cuda_device):
    """Bit for bit on sparse and dense 256 x 448 grids, H = 37 and W = 53
    (neither a multiple of the tiling), one obstacle, a full grid and an
    empty one (FAR): integer min-plus, one correctly rounded sqrt."""
    before = _cuda.launches["edt_exact"]
    for occ in _occupancy_grids():
        want = edt.edt(occ, 0.1)
        got = edt.edt(occ.to(cuda_device), 0.1)
        assert torch.equal(got.cpu(), want)
    assert _cuda.launches["edt_exact"] == before + 6
    assert float(want.min()) == 1e4


@pytest.mark.parametrize("max_dist", [0.7, 2.0])
def test_edt_banded_kernel_matches_plain(cuda_device, max_dist):
    """Bit for bit, the f32 truncated field (as B9 fused before its bf16
    store)."""
    before = _cuda.launches["edt_banded"]
    for occ in _occupancy_grids():
        want = edt.edt_truncated(occ, 0.1, max_dist)
        got = edt.edt_truncated(occ.to(cuda_device), 0.1, max_dist)
        assert torch.equal(got.cpu(), want)
    assert _cuda.launches["edt_banded"] == before + 6


def _edge_grids(H, W, seed):
    """(B, H, W) f32 occupancy at the design's edges: sparse and dense
    random envs, one occupied cell at each corner, a full row and a full
    column, an all-occupied env and an empty one."""
    rng = np.random.default_rng(seed)
    envs = [rng.uniform(0, 1, size=(H, W)) < d for d in (0.003, 0.05, 0.4)]
    for i, j in ((0, 0), (0, W - 1), (H - 1, 0), (H - 1, W - 1)):
        g = np.zeros((H, W), bool)
        g[i, j] = True
        envs.append(g)
    row = np.zeros((H, W), bool)
    row[H // 2] = True
    col = np.zeros((H, W), bool)
    col[:, W // 3] = True
    envs += [row, col, np.ones((H, W), bool), np.zeros((H, W), bool)]
    return _t(np.stack(envs).astype(np.float32))


def _b9_kernels(occ, dev, res, max_dist):
    """B9 exact, banded and fused on occ (B, H, W) against their plain
    versions on the CPU, bit for bit (fused on log-odds +-1 of occ)."""
    assert torch.equal(edt.edt(occ.to(dev), res).cpu(), edt.edt(occ, res))
    assert torch.equal(edt.edt_truncated(occ.to(dev), res, max_dist).cpu(),
                       edt.edt_truncated(occ, res, max_dist))
    lo = occ * 2.0 - 1.0
    assert torch.equal(
        edt.rebuild_truncated_lite(lo.to(dev), 0.0, res, max_dist).cpu(),
        edt.rebuild_truncated_lite(lo, 0.0, res, max_dist))


@pytest.mark.parametrize("H, W", [(1, 1), (1, 31), (1, 32), (1, 33),
                                  (1, 1024), (908, 1), (908, 31), (908, 33),
                                  (37, 1024), (908, 1024), (1024, 1024)])
def test_edt_exact_kernel_edge_shapes(cuda_device, H, W):
    """B9 exact bit for bit at widths around a word (1, 31, 32, 33), the
    widest rows (1024), one row, 908 and 1024 rows, on the edge grids."""
    occ = _edge_grids(H, W, seed=H * 7 + W)
    if H * W > 100_000:     # the plain version's min-plus is O(H^2 W)
        occ = occ[[1, 6]]
    assert torch.equal(edt.edt(occ.to(cuda_device), 0.1).cpu(),
                       edt.edt(occ, 0.1))


@pytest.mark.parametrize("R", [1, 31, 32, 33, 40])
@pytest.mark.parametrize("H, W", [(64, 100), (300, 101)])
def test_edt_truncated_kernels_radius_at_word_edges(cuda_device, R, H, W):
    """B9 banded and B9 fused bit for bit at radii around a word boundary,
    on 16-byte-aligned rows (W = 100) and unaligned ones (W = 101), and on
    300 rows (two tiles with an R-row halo); res 0.25 so that max_dist / res
    is R exactly. B9 exact on the same grids too."""
    res = 0.25
    assert edt.radius_cells(R * res, res) == R
    _b9_kernels(_edge_grids(H, W, seed=R), cuda_device, res, R * res)


@pytest.mark.parametrize("H, W", [(1, 1), (7, 33), (192, 256), (256, 448)])
def test_edt_kernels_edge_grids(cuda_device, H, W):
    """All three B9 kernels on the edge grids: corners, a full row and
    column, all-occupied, and empty (FAR for exact, max_dist truncated)."""
    occ = _edge_grids(H, W, seed=11)
    _b9_kernels(occ, cuda_device, 0.1, 2.0)
    empty = edt.edt(occ[-1:].to(cuda_device), 0.1)
    assert bool((empty == edt.FAR).all())
    assert bool((edt.edt_truncated(occ[-1:].to(cuda_device), 0.1, 2.0)
                 == 2.0).all())


def test_edt_kernels_one_env_inside_a_batch(cuda_device):
    """Each env of a batch of 67 equals the same env launched alone (B = 1),
    bit for bit, for all three B9 kernels."""
    rng = np.random.default_rng(21)
    occ = _t((rng.uniform(0, 1, size=(67, 96, 136)) < 0.02).astype(
        np.float32)).to(cuda_device)
    runs = (lambda g: edt.edt(g, 0.1),
            lambda g: edt.edt_truncated(g, 0.1, 2.0),
            lambda g: edt.rebuild_truncated_lite(g * 2.0 - 1.0, 0.0, 0.1,
                                                 2.0))
    for run in runs:
        full = run(occ)
        for k in (0, 33, 66):
            assert torch.equal(run(occ[k:k + 1].contiguous()), full[k:k + 1])


def test_edt_kernels_unaligned_rows(cuda_device):
    """A grid whose data starts 4 bytes past a 16-byte boundary (W = 64:
    every row unaligned) reads as its aligned copy, bit for bit."""
    rng = np.random.default_rng(22)
    H, W = 50, 64
    flat = torch.from_numpy((rng.uniform(0, 1, size=3 * H * W + 1) < 0.05)
                            .astype(np.float32)).to(cuda_device)
    view = flat[1:].view(3, H, W)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    copy = view.clone()
    assert torch.equal(edt.edt(view, 0.1), edt.edt(copy, 0.1))
    assert torch.equal(edt.edt_truncated(view, 0.1, 2.0),
                       edt.edt_truncated(copy, 0.1, 2.0))
    assert torch.equal(edt.edt(view, 0.1).cpu(), edt.edt(view.cpu(), 0.1))


def test_edt_kernels_refuse_past_limits(cuda_device):
    """Past the stated limits each wrapper raises before any launch; B = 0
    launches nothing and returns an empty field."""
    before = dict(_cuda.launches)
    for shape in ((1, 1025, 8), (1, 8, 1025)):
        with pytest.raises(ValueError):
            edt.edt(torch.zeros(shape, device=cuda_device), 0.1)
    with pytest.raises(ValueError):       # W past 8192
        edt.edt_truncated(torch.zeros((1, 4, 8193), device=cuda_device),
                          0.1, 0.5)
    with pytest.raises(ValueError):       # R past 4095
        edt.edt_truncated(torch.zeros((1, 4, 8), device=cuda_device),
                          0.1, 409.7)
    with pytest.raises(ValueError):       # a tile past the shared memory
        edt.rebuild_truncated_lite(
            torch.zeros((1, 2256, 4096), device=cuda_device), 0.0, 0.1, 100.0)
    assert _cuda.launches == before
    for fn in (lambda g: edt.edt(g, 0.1),
               lambda g: edt.edt_truncated(g, 0.1, 2.0),
               lambda g: edt.rebuild_truncated_lite(g, 0.0, 0.1, 2.0)):
        assert fn(torch.zeros((0, 40, 40), device=cuda_device)).shape == (
            0, 40, 40)
    assert _cuda.launches == before


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
    emap = esdf.build(occ, ORIGIN, 0.1, 2.0, lite=True)
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



def _solver_case(which, n):
    """n problems on two envs for B1 (the scene of _worlds(2, seed=7)) or
    B6 (96-cell windows of two lite maps with boxes ahead): (x0, head,
    tail, the map, env_of, the fused solver)."""
    if which == "scene":
        x0, head, tail = _boundary(n, seed=1)
        return x0, head, tail, scene.build(_worlds(2, seed=7),
                                           MapParams(**MAPP)), \
            torch.arange(n) % 2, solve.solve_scene
    occ = torch.zeros((2, 192, 256))
    rng = np.random.default_rng(9)
    for e in range(2):
        for _ in range(8):                     # 0.4-1.2 m boxes ahead
            r, c = rng.integers(60, 130), rng.integers(60, 140)
            h, w = rng.integers(4, 12, size=2)
            occ[e, r:r + h, c:c + w] = 1.0
    emap = esdf.build(occ, ORIGIN, 0.1, 2.0, lite=True)
    x0, head, tail = _boundary(n, seed=1, start=(3.0, 0.0))
    window = expert.make_plan_window(emap, head[:2], tail[:2],
                                     PlannerParams())
    return x0, head, tail, window, torch.arange(n) % 2, solve.solve_grid


def _assert_basin(got, want):
    """The cost basin of chip_smoke.py: median relative f difference <=
    1e-4, mean f within 1%."""
    f_k, f_p = got[1].cpu(), want[1]
    rel = (f_k - f_p).abs() / f_p.abs().clamp(min=1.0)
    assert float(rel.median()) <= 1e-4, rel
    assert abs(float(f_k.mean()) / float(f_p.mean()) - 1.0) <= 1e-2


@pytest.mark.parametrize("which", ["scene", "grid"])
def test_solver_kernel_skips_and_is_order_free(cuda_device, which):
    """One warp per problem, no atomics: a skipped problem returns x0, f =
    0 and iters 0; each live problem's (x, f, iters) is the same bit for
    bit whether or not its neighbours are skipped, and after a permutation
    of the problems (24 iterations)."""
    x0, head, tail, pmap, env_of, fused = (
        a.to(cuda_device) if isinstance(a, torch.Tensor)
        else _map_to(a, cuda_device) if dataclasses.is_dataclass(a) else a
        for a in _solver_case(which, 64))
    pp = PlannerParams(samples_per_piece=24, max_iters=24, max_ls=4)
    base = fused(x0, head, tail, pmap, env_of, pp)
    assert int(base[2].min()) > 0
    skip = torch.arange(64, device=cuda_device) % 3 == 1
    got = fused(x0, head, tail, pmap, env_of, pp, skip=skip)
    assert torch.equal(got[0][skip], x0[skip])
    assert torch.equal(got[1][skip], torch.zeros_like(got[1][skip]))
    assert torch.equal(got[2][skip], torch.zeros_like(got[2][skip]))
    for g, b in zip(got, base):
        assert torch.equal(g[~skip], b[~skip])
    perm = torch.from_numpy(np.random.default_rng(5).permutation(64)).to(
        cuda_device)
    got = fused(x0[perm], head[perm], tail[perm], pmap, env_of[perm], pp)
    for g, b in zip(got, base):
        assert torch.equal(g, b[perm])


@pytest.mark.parametrize("which", ["scene", "grid"])
@pytest.mark.parametrize("K", [32, 11])
def test_solver_kernel_planner_defaults_and_odd_k(cuda_device, which, K):
    """PlannerParams()'s K = 32 and max_ls = 8, and K = 11 (M*K = 33, not
    a multiple of the warp's 32 lanes): one iteration within 1e-3 relative
    on f of the plain version. (At 24 iterations 64 problems are too few
    for the cost basin's mean-f rule: roundoff sends single solves to
    other basins, and one of them moves the mean of 64 by 1%.)"""
    x0, head, tail, pmap, env_of, fused = _solver_case(which, 64)
    dev_args = [a.to(cuda_device) for a in (x0, head, tail)]
    pmap_d, env_d = _map_to(pmap, cuda_device), env_of.to(cuda_device)
    pp1 = dataclasses.replace(PlannerParams(), samples_per_piece=K,
                              max_iters=1)
    assert pp1.max_ls == 8
    want = fused(x0, head, tail, pmap, env_of, pp1)
    got = fused(*dev_args, pmap_d, env_d, pp1)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].numpy(),
                               rtol=1e-3)


@pytest.mark.parametrize("which", ["scene", "grid"])
def test_solver_kernel_start_value_matches_objective_kernel(cuda_device,
                                                            which):
    """The solver kernels (B1 / B6) and the objective kernels (B2s / B7)
    run the same warp form of the objective, with the same roundings: at
    max_iters = 0 the solver returns its start point's value, the
    objective kernel's value bit for bit."""
    from neoplanner_tpu_torch.plan import objective
    x0, head, tail, pmap, env_of, fused = (
        a.to(cuda_device) if isinstance(a, torch.Tensor)
        else _map_to(a, cuda_device) if dataclasses.is_dataclass(a) else a
        for a in _solver_case(which, 64))
    for K in (24, 32, 11, 40):
        pp = PlannerParams(samples_per_piece=K, max_iters=0)
        got = fused(x0, head, tail, pmap, env_of, pp)
        assert torch.equal(got[0], x0) and int(got[2].max()) == 0
        f, _ = objective.objective_valgrad(x0, head, tail, pmap, env_of, pp)
        assert torch.equal(got[1], f), (got[1] - f).abs().max()


def test_grid_solver_kernel_cost_basin(cuda_device):
    """24 iterations of B6 on 64 problems over the windows of two lite
    maps, held to the plain version's cost basin as B1 is."""
    x0, head, tail, window, env_of, _ = _solver_case("grid", 64)
    pp = PlannerParams(samples_per_piece=24, max_iters=24, max_ls=4)
    want = solve.solve_grid(x0, head, tail, window, env_of, pp)
    got = solve.solve_grid(*(a.to(cuda_device) for a in (x0, head, tail)),
                           _map_to(window, cuda_device),
                           env_of.to(cuda_device), pp)
    _assert_basin(got, want)


# ---- B2s and B7: one objective evaluation per problem


def _grid_windows():
    """96-cell windows of two lite maps with boxes ahead of the drones, and
    ten problems on them: six among the boxes, two whose tails lie beyond
    the window's edge inside the map and two beyond the map (x > 21.6)."""
    occ = torch.zeros((2, 192, 256))
    rng = np.random.default_rng(9)
    for e in range(2):
        for _ in range(8):
            r, c = rng.integers(60, 130), rng.integers(60, 140)
            h, w = rng.integers(4, 12, size=2)
            occ[e, r:r + h, c:c + w] = 1.0
    emap = esdf.build(occ, ORIGIN, 0.1, 2.0, lite=True)
    x0, head, tail = _boundary(10, seed=4, start=(3.0, 0.0))
    head[6:8, 0, 0] = 8.0
    tail[6:8, 0, 0] = 17.0
    head[8:, 0, 0] = 17.0
    tail[8:, 0, 0] = 24.0
    pp = PlannerParams()
    x0[6:, :4] = expert.straight_line_wpts(head[6:, 0], tail[6:, 0],
                                           pp).reshape(4, 4)
    env_of = torch.arange(10) % 2
    window = esdf.make_window(emap, torch.tensor([[5.5, 0.0]] * 2), 96)
    return x0, head, tail, window, env_of


def _objective_case(which):
    if which == "scene":
        worlds = _worlds(2, seed=7)
        x0, head, tail = _boundary(64, seed=2, start=(4.0, 0.0))
        return x0, head, tail, scene.build(worlds, MapParams(**MAPP)), \
            torch.arange(64) % 2
    return _grid_windows()


def _map_to(pmap, dev):
    return type(pmap)(*(getattr(pmap, f.name).to(dev)
                        for f in dataclasses.fields(pmap)))


@pytest.mark.parametrize("which", ["scene", "grid"])
@pytest.mark.parametrize("grad", [False, True])
def test_objective_kernel_matches_plain(cuda_device, which, grad):
    """Values within 5e-4 of the plain version (the golden tests' bound,
    tests/test_costs_pallas*.py), gradients within 2e-3 (their bound) of
    each problem's largest component (or 1), as chip_smoke.py holds them:
    on the scene against the plain version in f64 (the f32 plain version
    itself sits 2e-3 off it on a component of ~8 of a gradient of ~6000,
    the roundoff of the large terms that cancel there, which the golden
    tests' elementwise scale would count), on windows against the f32
    plain version (it takes the kernel's bilinear cells; f64 may take the
    next cell at a cell edge). One launch of the named kernel."""
    from neoplanner_tpu_torch.plan import objective
    x0, head, tail, pmap, env_of = _objective_case(which)
    pp = PlannerParams(samples_per_piece=24)
    fn = objective.objective_valgrad if grad else objective.objective_fwd
    want = fn(x0, head, tail, pmap, env_of, pp)
    name = f"objective_{which}_{'valgrad' if grad else 'fwd'}"
    before = _cuda.launches[name]
    got = fn(*(a.to(cuda_device) for a in (x0, head, tail)),
             _map_to(pmap, cuda_device), env_of.to(cuda_device), pp)
    torch.cuda.synchronize()
    assert _cuda.launches[name] == before + 1
    f_k, f_p = (got[0], want[0]) if grad else (got, want)
    np.testing.assert_allclose(f_k.cpu().numpy(), f_p.numpy(), rtol=5e-4,
                               atol=5e-4)
    assert float(f_p.max()) > 100.0            # a collision term is live
    if grad:
        g_ref = want[1].double()
        if which == "scene":
            g_ref = objective.objective_valgrad(
                *(a.double() for a in (x0, head, tail)),
                scene.SceneMap(pmap.centers.double(), pmap.half.double(),
                               pmap.is_cyl, pmap.active), env_of, pp)[1]
        scale = g_ref.abs().amax(1, keepdim=True).clamp(min=1.0)
        np.testing.assert_allclose((got[1].cpu().double() / scale).numpy(),
                                   (g_ref / scale).numpy(), atol=2e-3)


@pytest.mark.parametrize("which", ["scene", "grid"])
def test_per_eval_solve_matches_fused_kernel(cuda_device, which):
    """One iteration of the per-evaluation solve (B2s / B7 under the
    PyTorch loop) against the fused solver kernel (B1 / B6) on the card:
    the same step from the same gradient, x within 1e-4, the same
    iteration counts; the autograd form's gradient is the kernel's times
    grad_out."""
    from neoplanner_tpu_torch.plan import objective
    x0, head, tail, pmap, env_of = (a.to(cuda_device) if isinstance(
        a, torch.Tensor) else _map_to(a, cuda_device)
        for a in _objective_case(which))
    pp = PlannerParams(samples_per_piece=24, max_iters=1, max_ls=4)
    fused = solve.solve_scene if which == "scene" else solve.solve_grid
    want = fused(x0, head, tail, pmap, env_of, pp)
    got = solve.solve_per_eval(x0, head, tail, pmap, env_of, pp)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    assert got[2].tolist() == want[2].tolist()
    x = x0.clone().requires_grad_(True)
    f = objective.objective_vjp(x, head, tail, pmap, env_of, pp)
    w = torch.linspace(0.5, 2.0, x.shape[0], device=cuda_device)
    (gx,) = torch.autograd.grad(f, x, w)
    _, g = objective.objective_valgrad(x0, head, tail, pmap, env_of, pp)
    assert torch.equal(gx, w[:, None] * g)


def _objective_on(which, dev, idx=None):
    """_objective_case's problems (those of idx, if given) on dev."""
    x0, head, tail, pmap, env_of = _objective_case(which)
    if idx is not None:
        x0, head, tail, env_of = x0[idx], head[idx], tail[idx], env_of[idx]
    return ([a.contiguous().to(dev) for a in (x0, head, tail)]
            + [_map_to(pmap, dev), env_of.to(dev)])


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("which", ["scene", "grid"])
@pytest.mark.parametrize("P", [1, 5, 4 * 16 + 3])
def test_objective_kernel_ragged_batch(cuda_device, which, P):
    """P problems, a block with one warp busy, one not full, and a last
    block of 3 of its 4 warps: each problem's f and g equal, bit for bit,
    those of the same problem in a launch of the whole case (a warp reads
    and writes only its own problem), and the values agree with the plain
    version within 5e-4 (test_objective_kernel_matches_plain's bound)."""
    from neoplanner_tpu_torch.plan import objective
    assert P % objective.WARPS != 0
    pp = PlannerParams(samples_per_piece=24)
    full = _objective_on(which, cuda_device)
    n = full[0].shape[0]
    idx = torch.arange(P) % n
    part = _objective_on(which, cuda_device, idx)
    f_all, g_all = objective.objective_valgrad(*full, pp)
    f, g = objective.objective_valgrad(*part, pp)
    f_v = objective.objective_fwd(*part, pp)
    torch.cuda.synchronize()
    on = idx.to(cuda_device)
    assert torch.equal(_bits(f), _bits(f_all[on]))
    assert torch.equal(_bits(g), _bits(g_all[on]))
    assert torch.equal(_bits(f_v), _bits(f_all[on]))
    want = objective.objective_fwd(*_objective_on(which, "cpu", idx), pp)
    np.testing.assert_allclose(f.cpu().numpy(), want.numpy(), rtol=5e-4,
                               atol=5e-4)


@pytest.mark.parametrize("which", ["scene", "grid"])
def test_objective_kernel_empty_batch(cuda_device, which):
    """P = 0 returns empty outputs and launches nothing."""
    from neoplanner_tpu_torch.plan import objective
    pp = PlannerParams(samples_per_piece=24)
    args = _objective_on(which, cuda_device, torch.arange(0))
    before = dict(_cuda.launches)
    f = objective.objective_fwd(*args, pp)
    f_g, g = objective.objective_valgrad(*args, pp)
    torch.cuda.synchronize()
    assert f.shape == (0,) and f_g.shape == (0,) and g.shape == (0, 7)
    assert _cuda.launches == before


@pytest.mark.parametrize("which", ["scene", "grid"])
def test_objective_kernel_repeats_bits(cuda_device, which):
    """No sum takes atomics: a repeat launch of either kernel gives the
    same bits, and at the same x the value kernel's f is the value and
    gradient kernel's f, bit for bit (the line search's value of a point
    is the one its accepted evaluation returns)."""
    from neoplanner_tpu_torch.plan import objective
    pp = PlannerParams(samples_per_piece=24)
    args = _objective_on(which, cuda_device)
    f1, g1 = objective.objective_valgrad(*args, pp)
    f2, g2 = objective.objective_valgrad(*args, pp)
    v1 = objective.objective_fwd(*args, pp)
    v2 = objective.objective_fwd(*args, pp)
    torch.cuda.synchronize()
    assert torch.equal(_bits(f1), _bits(f2))
    assert torch.equal(_bits(g1), _bits(g2))
    assert torch.equal(_bits(v1), _bits(v2))
    assert torch.equal(_bits(v1), _bits(f1))


def test_objective_scene_kernel_primitive_cap(cuda_device):
    """The scene kernel stages each warp's primitive table in shared
    memory: at 32 primitives (the one-thread kernel's cap) and at the cap
    itself (past 48 KB a block, so the launch raises the kernel's shared
    memory limit) it runs, and the extra primitives, active but 1 km away,
    leave every f and g bit for bit as on the unpadded scene; one past the
    cap raises before a launch."""
    from neoplanner_tpu_torch.plan import objective
    pp = PlannerParams(samples_per_piece=24)
    x0, head, tail, pmap, env_of = _objective_on("scene", cuda_device)
    f0, g0 = objective.objective_valgrad(x0, head, tail, pmap, env_of, pp)
    E, K = pmap.active.shape
    assert K < 32

    def padded(n):
        extra = n - K
        far = torch.full((E, extra, 2), 1000.0, device=cuda_device)
        return scene.SceneMap(
            torch.cat([pmap.centers, far], 1),
            torch.cat([pmap.half, torch.full_like(far, 0.5)], 1),
            torch.cat([pmap.is_cyl, torch.zeros((E, extra), dtype=torch.bool,
                                                device=cuda_device)], 1),
            torch.cat([pmap.active, torch.ones((E, extra), dtype=torch.bool,
                                               device=cuda_device)], 1))
    cap = objective.max_prims(pp.num_pieces)
    for n in (32, cap):
        f, g = objective.objective_valgrad(x0, head, tail, padded(n), env_of,
                                           pp)
        v = objective.objective_fwd(x0, head, tail, padded(n), env_of, pp)
        torch.cuda.synchronize()
        assert torch.equal(_bits(f), _bits(f0)), n
        assert torch.equal(_bits(g), _bits(g0)), n
        assert torch.equal(_bits(v), _bits(f0)), n
    before = dict(_cuda.launches)
    with pytest.raises(ValueError, match="primitives exceed"):
        objective.objective_fwd(x0, head, tail,
                                padded(cap + 1), env_of, pp)
    assert _cuda.launches == before


# ---- the piece count M and the L-BFGS history H: B5, B2s, B7, B1, B6


PIECE_COUNTS = (2, 5, 12, 16)


@pytest.mark.parametrize("lower_bw", [4, 2])
@pytest.mark.parametrize("M", PIECE_COUNTS)
def test_minco_kernel_piece_counts(cuda_device, M, lower_bw):
    """B5 at n = 6M on 257 random band systems (a last block with one
    warp idle) and on the MINCO systems of 64 problems of M pieces (and
    their transposes): within the 1e-4 of test_minco_kernel_matches_plain
    of the plain version, of each system's largest solution component
    (the MINCO coefficients of the last pieces grow with T^5); one launch
    a call."""
    n = 6 * M
    A, b = _band_systems(257, lower_bw, 60 + M, size=n)
    pp = PlannerParams(num_pieces=M)
    _, head, tail = _boundary(64, seed=M, pp=pp)
    rng = np.random.default_rng(M)
    wpts = expert.straight_line_wpts(head[:, 0], tail[:, 0], pp) \
        + _t(rng.normal(scale=0.3, size=(64, 2, M - 1))).float()
    ts = _t(rng.uniform(0.8, 4.0, size=(64, M)).astype(np.float32))
    Am, bm = minco.build_system(head, tail, wpts, ts)
    if lower_bw == 2:
        Am = Am.transpose(1, 2).contiguous()
    for A_, b_ in ((A, b), (Am, bm)):
        want = minco._givens_solve(A_.double(), b_.double(), lower_bw,
                                   6 - lower_bw)
        before = _cuda.launches["minco_banded_solve"]
        got = minco.banded_solve(A_.to(cuda_device), b_.to(cuda_device),
                                 lower_bw, 6 - lower_bw)
        torch.cuda.synchronize()
        assert _cuda.launches["minco_banded_solve"] == before + 1
        scale = want.abs().amax((1, 2), keepdim=True).clamp(min=1.0)
        np.testing.assert_allclose((got.cpu().double() / scale).numpy(),
                                   (want / scale).numpy(), rtol=1e-4,
                                   atol=1e-4)


def _objective_case_m(which, M):
    """_objective_case's maps with problems of M pieces."""
    pp = PlannerParams(num_pieces=M, samples_per_piece=24)
    if which == "scene":
        x0, head, tail = _boundary(64, seed=2, start=(4.0, 0.0), pp=pp)
        return x0, head, tail, scene.build(_worlds(2, seed=7),
                                           MapParams(**MAPP)), \
            torch.arange(64) % 2, pp
    _, _, _, window, _ = _grid_windows()
    x0, head, tail = _boundary(64, seed=4, start=(3.0, 0.0), pp=pp)
    return x0, head, tail, window, torch.arange(64) % 2, pp


@pytest.mark.parametrize("which", ["scene", "grid"])
@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("M", PIECE_COUNTS)
def test_objective_kernel_piece_counts(cuda_device, which, grad, M):
    """B2s and B7 at M pieces, held as test_objective_kernel_matches_plain
    holds them at M = 3: values within 5e-4, gradients within 2e-3 of
    each problem's largest component, against the f64 plain version on the
    scene and the f32 one on windows; one launch. On windows a sample that
    sits on a cell edge takes one cell or the next as its last bits fall,
    and its bilinear gradient jumps between them: a problem whose gradient
    misses the f32 plain version's is held to the f64 one's, the other
    side of such an edge (at M = 12, 2 of 2,176 components on an H100)."""
    from neoplanner_tpu_torch.plan import objective
    x0, head, tail, pmap, env_of, pp = _objective_case_m(which, M)
    fn = objective.objective_valgrad if grad else objective.objective_fwd
    want = fn(x0, head, tail, pmap, env_of, pp)
    name = f"objective_{which}_{'valgrad' if grad else 'fwd'}"
    before = _cuda.launches[name]
    got = fn(*(a.to(cuda_device) for a in (x0, head, tail)),
             _map_to(pmap, cuda_device), env_of.to(cuda_device), pp)
    torch.cuda.synchronize()
    assert _cuda.launches[name] == before + 1
    f_k, f_p = (got[0], want[0]) if grad else (got, want)
    np.testing.assert_allclose(f_k.cpu().numpy(), f_p.numpy(), rtol=5e-4,
                               atol=5e-4)
    if not grad:
        return
    g_k = got[1].cpu().double()
    if which == "scene":
        g_ref = objective.objective_valgrad(
            *(a.double() for a in (x0, head, tail)),
            scene.SceneMap(pmap.centers.double(), pmap.half.double(),
                           pmap.is_cyl, pmap.active), env_of, pp)[1]
    else:
        g_ref = want[1].double()
        miss = ((g_k - g_ref).abs() / g_ref.abs().amax(1, keepdim=True)
                .clamp(min=1.0) > 2e-3).any(1)
        if bool(miss.any()):
            g64 = objective.objective_valgrad(
                *(a.double() for a in (x0, head, tail)),
                type(pmap)(pmap.win.double(), pmap.worg.double()), env_of,
                pp)[1]
            g_ref[miss] = g64[miss]
    scale = g_ref.abs().amax(1, keepdim=True).clamp(min=1.0)
    np.testing.assert_allclose((g_k / scale).numpy(),
                               (g_ref / scale).numpy(), atol=2e-3)


@pytest.mark.parametrize("which", ["scene", "grid"])
@pytest.mark.parametrize("H", [5, 10, 20])
@pytest.mark.parametrize("M", PIECE_COUNTS)
def test_solver_kernel_piece_counts(cuda_device, which, M, H):
    """B1 and B6 at M pieces and history H: one iteration held to the plain
    version as parity.one_iteration says (1e-3 relative on f, or another
    backtracking step of the same direction); at max_iters = 0 the start
    value of the objective kernel bit for bit; one launch a call."""
    from neoplanner_tpu_torch.plan import objective
    x0, head, tail, pmap, env_of, pp = _objective_case_m(which, M)
    fused = solve.solve_scene if which == "scene" else solve.solve_grid
    pp1 = dataclasses.replace(pp, history=H, max_iters=1, max_ls=4)
    want = fused(x0, head, tail, pmap, env_of, pp1)
    args = [a.to(cuda_device) for a in (x0, head, tail)]
    pmap_d, env_d = _map_to(pmap, cuda_device), env_of.to(cuda_device)
    name = "lbfgs_scene_solve" if which == "scene" else "lbfgs_grid_solve"
    before = _cuda.launches[name]
    got = fused(*args, pmap_d, env_d, pp1)
    torch.cuda.synchronize()
    assert _cuda.launches[name] == before + 1
    parity.one_iteration(x0, head, tail, pmap, env_of, pp1, got, want)
    pp0 = dataclasses.replace(pp1, max_iters=0)
    got = fused(*args, pmap_d, env_d, pp0)
    f, _ = objective.objective_valgrad(*args, pmap_d, env_d, pp0)
    assert torch.equal(got[1], f)


@pytest.mark.parametrize("which", ["scene", "grid"])
@pytest.mark.parametrize("H", [2, 3])
@pytest.mark.parametrize("M", PIECE_COUNTS)
def test_solver_kernel_history_wraps(cuda_device, which, M, H):
    """B1 and B6 at M pieces, 6 iterations of a history of 2 or 3, so that
    the ring wraps on most problems: f and x of each problem within 1e-3
    of the plain solver on the CPU, as parity.few_iterations says, with
    the plain solver on the card as its control."""
    x0, head, tail, pmap, env_of, pp = _objective_case_m(which, M)
    fused = solve.solve_scene if which == "scene" else solve.solve_grid
    pp6 = dataclasses.replace(pp, history=H, max_iters=6, max_ls=4)
    want = fused(x0, head, tail, pmap, env_of, pp6)
    args = [a.to(cuda_device) for a in (x0, head, tail)]
    pmap_d, env_d = _map_to(pmap, cuda_device), env_of.to(cuda_device)
    got = fused(*args, pmap_d, env_d, pp6)
    control = solve._solve_plain(*args, pmap_d, env_d, pp6)
    assert int((want[2] > H).sum()) >= want[2].numel() // 2
    parity.few_iterations(got, want, control)


def test_kernels_refuse_piece_count_and_history(cuda_device):
    """M = 17 (n = 102) and a history of 33 or 0 raise ValueError naming
    the range, before any launch."""
    from neoplanner_tpu_torch.plan import objective
    x0, head, tail, pmap, env_of, pp = _objective_case_m("scene", 3)
    x0, head, tail, env_of = (a.to(cuda_device)
                              for a in (x0, head, tail, env_of))
    pmap = _map_to(pmap, cuda_device)
    before = dict(_cuda.launches)
    A, b = _band_systems(4, 4, 1, size=102)
    with pytest.raises(ValueError, match="M in 2..16"):
        minco.banded_solve(A.to(cuda_device), b.to(cuda_device), 4, 2)
    p17 = dataclasses.replace(pp, num_pieces=17)
    x17 = torch.zeros((x0.shape[0], p17.num_vars), device=cuda_device)
    with pytest.raises(ValueError, match="M in 2..16"):
        objective.objective_fwd(x17, head, tail, pmap, env_of, p17)
    with pytest.raises(ValueError, match="M in 2..16"):
        solve.solve_scene(x17, head, tail, pmap, env_of, p17)
    for H in (33, 0):
        with pytest.raises(ValueError, match="1..32"):
            solve.solve_scene(x0, head, tail, pmap, env_of,
                              dataclasses.replace(pp, history=H))
    assert _cuda.launches == before


# ---- the record rollout (B4, B1, B5, B3) on the card against the CPU


def test_record_rollout_card_matches_cpu(cuda_device):
    """learn/datagen.record_rollout at B = 16, 2 segments, one solver
    iteration, from the same worlds, goals and draws: the valid flags
    equal, motions and labels within 1e-4 on the valid samples, and at most
    1e-3 of the frames' pixels off by more than 1e-3 m (B4's rule, on the
    normalized frames scaled back by the largest peak, max_range)."""
    from neoplanner_tpu_torch.learn import datagen
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n, segs = 16, 2
    pp = PlannerParams(max_iters=1)
    mp, sp = MissionParams(), SimParams()
    cam = CameraParams(width=160, height=120)
    mapp = MapParams(**MAPP)
    gen_c = _cuda.make_generator(7, "cpu")
    w_c = scenegen.generate_batch(gen_c, n, WorldParams(num_boxes=12))
    s_c = env.reset(w_c, pp, mp, mapp, gen_c)
    w_g = _to(w_c, cuda_device)
    s_g = env.reset(w_g, pp, mp, mapp, _cuda.make_generator(7),
                    goal=s_c.goal.to(cuda_device))
    d_c = [env.draw(gen_c, n, pp) for _ in range(segs)]
    d_g = [_to(d, cuda_device) for d in d_c]
    _cuda.reset_launches()
    _, *out_g = datagen.record_rollout(s_g, segs, pp, mp, sp, cam,
                                       mp.des_pos_z, draws=d_g)
    counts = dict(_cuda.launches)
    _, *out_c = datagen.record_rollout(s_c, segs, pp, mp, sp, cam,
                                       mp.des_pos_z, draws=d_c)
    for k, per in (("render_depth", 1), ("lbfgs_scene_solve", 2),
                   ("minco_banded_solve", 2), ("track_segment", 1)):
        assert counts[k] == per * segs, (k, counts[k])
    (dg, mg, lg, vg), (dc, mc, lc, vc) = ([t.cpu() for t in o]
                                          for o in (out_g, out_c))
    assert torch.equal(vg, vc) and bool(vc.any())
    for g, c in ((mg, mc), (lg, lc)):
        np.testing.assert_allclose(g[vc].numpy(), c[vc].numpy(), atol=1e-4)
    off = ((dg - dc).abs() * cam.max_range / 255.0 > 1e-3).float().mean()
    assert float(off) <= 1e-3


def test_render_kernel_640x480_matches_plain(cuda_device):
    """B4 at the paper's 640 x 480 (the ResNet-18 net's frames): at most
    1e-3 of the pixels off by more than 1e-4 m, as at 160 x 120."""
    worlds = _worlds(8, seed=11)
    pos, quat = _poses(8, seed=11)
    cam = CameraParams(width=640, height=480)
    want = raycast.render_depth(worlds, pos, quat, cam)
    got = raycast.render_depth_auto(_to(worlds, cuda_device),
                                    pos.to(cuda_device), quat.to(cuda_device),
                                    cam)
    assert got.shape == (8, 480, 640)
    diff = (got.cpu() - want).abs()
    assert float((diff > 1e-4).float().mean()) <= 1e-3


def test_geo_front_end_matches_cpu(cuda_device):
    """The 'geo' planner's front end (plan/geo.py: wavefront field,
    descent, path end, pruned key indices) on the card equals the CPU's
    bit for bit on ground-truth grids of 8 worlds: its sums of 1 and
    sqrt(2) and its cell indices are exact in f32."""
    from neoplanner_tpu_torch.plan import geo
    from neoplanner_tpu_torch.world import voxelize
    mapp = MapParams(**MAPP)
    worlds = _worlds(8, seed=12)
    emap = esdf.build(voxelize.occupancy_2d(worlds, mapp), ORIGIN,
                      mapp.resolution)
    rng = np.random.default_rng(12)
    head = torch.zeros((8, 3, 2))
    tail = torch.zeros((8, 3, 2))
    head[:, 0] = _t(rng.uniform([-1.0, -2.0], [2.0, 2.0], (8, 2))).float()
    tail[:, 0] = head[:, 0] + _t(rng.uniform([3.0, -2.0], [12.0, 2.0],
                                             (8, 2))).float()
    want = geo.front_end(emap, head, tail, 0.7)
    got = geo.front_end(_to(emap, cuda_device), head.to(cuda_device),
                        tail.to(cuda_device), 0.7)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# ---- parsed worlds (world/worldio.py) and 3-D voxelization


def _forest_world(path, seed=0):
    """worldio.forest_world_xml's forest (150 model://pine_tree meshes: a
    trunk and a canopy cylinder each, 300 primitives, capacity 304 parsed)
    written to path and parsed on the CPU."""
    from neoplanner_tpu_torch.world import worldio
    path.write_text(worldio.forest_world_xml(seed))
    world = worldio.parse_world(str(path), max_boxes=None, device="cpu")
    assert int(world.active.sum()) == 300 and world.active.shape == (304,)
    return world


def _batch(world, n):
    return BoxWorld(*(getattr(world, f).expand(n, *getattr(world, f).shape)
                      .contiguous() for f in ("centers", "half_sizes",
                                              "active", "shape")))


def test_solver_kernel_on_parsed_forest_world(cuda_device, tmp_path):
    """B1 on a parsed 300-primitive world, past the flagship's capacity of
    24: one iteration within 1e-3 relative on f, 24 iterations in the
    plain version's cost basin (test_solver_kernel_matches_plain's
    rules)."""
    worlds = _batch(_forest_world(tmp_path / "forest.world"), 2)
    sc = scene.build(worlds, MapParams())
    sc_d = scene.SceneMap(*(getattr(sc, f).to(cuda_device) for f in
                            ("centers", "half", "is_cyl", "active")))
    x0, head, tail = _boundary(64, seed=2, start=(2.0, 0.0))
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


def test_track_kernel_on_parsed_forest_world(cuda_device, tmp_path):
    """B3 on a parsed 300-primitive world, the commands along the
    corridor and across the first trees (the collision metric live):
    _assert_track_match's rules."""
    pp, mp, sp = PlannerParams(), MissionParams(), SimParams()
    worlds = _batch(_forest_world(tmp_path / "forest.world", seed=1), 6)
    cmds = _cmds(6, x0=2.5)
    cmds[3:, :, 0, 1] += 2.0            # three envs sway into the trees
    st = env.reset(worlds, pp, mp, MapParams(), _cuda.make_generator(1,
                                                                    "cpu"),
                   goal=torch.tensor([[20.0, 0.0]]).expand(6, 2).clone(),
                   start_pos=cmds[:, 0, 0])
    want = track.track_segment(st, cmds, pp, mp, sp)
    got = track.track_segment(_to(st, cuda_device), cmds.to(cuda_device),
                              pp, mp, sp)
    _assert_track_match(want, got)
    assert float(want[3][:, 2].max()) > 0.0


def test_voxelize_3d_on_card_equals_cpu(cuda_device, tmp_path):
    """occupancy_3d and fill_unknown_3d (plain PyTorch on every device) on
    the card equal the CPU voxel for voxel on a parsed 300-primitive world
    (the flagship's 256 x 192 map, 60 z cells) and the enclosed shell of
    tests/test_world.py::test_fill_unknown_3d_cavity; the fill takes the
    same steps."""
    from neoplanner_tpu_torch.world import voxelize
    world = _forest_world(tmp_path / "forest.world", seed=2)
    mapp = MapParams(**MAPP)
    want = voxelize.occupancy_3d(world, mapp, 60)
    got = voxelize.occupancy_3d(_to(world, cuda_device), mapp, 60)
    assert float(want.sum()) > 1e5 and torch.equal(got.cpu(), want)
    shell = torch.zeros((8, 16, 16))
    shell[2:7, 4:10, 4:10] = 1.0
    shell[3:6, 5:9, 5:9] = 0.0
    for vol in (want, shell):
        free_c, steps_c = voxelize.flood_free(vol)
        free_g, steps_g = voxelize.flood_free(vol.to(cuda_device))
        assert steps_c == steps_g and torch.equal(free_g.cpu(), free_c)
        assert torch.equal(voxelize.fill_unknown_3d(vol.to(cuda_device))
                           .cpu(), voxelize.fill_unknown_3d(vol))


def test_edt_sq_cells_kernel_matches_plain(cuda_device):
    """edt_sq_cells through B9 exact (the squared distance recovered from
    the kernel's correctly rounded root at resolution 1) equals the plain
    pass chain exactly, the empty grid's 1e9 included."""
    before = _cuda.launches["edt_exact"]
    for occ in _occupancy_grids():
        want = edt.edt_sq_cells(occ)
        got = edt.edt_sq_cells(occ.to(cuda_device))
        assert torch.equal(got.cpu(), want)
    assert _cuda.launches["edt_exact"] == before + 6
    assert float(want.max()) == 1e9
