"""The reach test of the dense fusion kernels B8 v2 and v3
(mapping/fusion.tile_reach, the predicate csrc/fusion_tile.cuh computes per
frame and tile) against the carve itself (fusion._carve_update).

B8 v2 and v3 run the carve test only on the tiles of TILE_H x TILE_W cells
that a frame's camera may reach. That is exact if every cell the carve
frees lies in a tile, and in a warp's WARP_H x WARP_W strip of it (the
kernel's unit), that the test keeps. These tests check that on frames
rendered from seeded worlds (the port's scene generator; poses as
examples/profile_vision.py flies them, at row strides 1 and 4, one frame
and five frames per env), on random cameras at tile corners with random
tables, and on hand-made edges: the camera on a tile's corner or edge,
yaws of 0, +-pi/2 and pi and yaws that put a field-of-view edge along an
axis, cameras outside the map, a table of all res (nothing to carve),
cell centres at dcx = 1e-6 and on a carve radius. No tolerance: the
carved set must lie inside the kept tiles exactly. They also tie the
Python tile shape, margin and shared-memory rule to the kernel's
constants, and check that the launchers refuse, before any launch, the
frames a block cannot stage.

B8 v1 runs the same template on each env's (ch, cw) window of the grid,
its cells placed from the window's origin and its column index rounded
half to even (fusion.window_reach is its reach test): the same checks hold
it to every cell that v1's carve frees, on frames rendered on the default
map with the 4 m camera (windows clamped at the map's corners among them)
and on cameras whose image edge u = -0.5 or u = w - 0.5 runs through a row
of cell centres. A hit can fall outside its window (a pitched camera sees
past the reach the window is sized for): the last test shows one, which
the kernel applies in the same launch.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import CameraParams, MapParams, WorldParams
from neoplanner_tpu_torch.core import frames
from neoplanner_tpu_torch.core.types import BoxWorld
from neoplanner_tpu_torch.mapping import fusion, occupancy
from neoplanner_tpu_torch.sense import raycast
from neoplanner_tpu_torch.world import scenegen
from tests.test_torch_imports import one_torch_thread  # noqa: F401

# examples/profile_vision.py's map
MP = MapParams(width=256, height=192, origin_x=-4.0, origin_y=-9.6,
               edt_truncation=2.0, fusion="2d_dense")
CAM = CameraParams()


def _carved_outside(tabs, sc, mp=MP, cam=CAM):
    """(cells carved in a tile or in a warp's strip that the reach test
    drops, the kept share of tiles, the number of carved cells) for tabs
    (N, w), sc (N, 8)."""
    carve = fusion._carve_update((tabs.shape[0], mp.height, mp.width), tabs,
                                 sc, cam, mp) != 0
    lost = 0
    for th, tw in ((fusion.TILE_H, fusion.TILE_W),
                   (fusion.WARP_H, fusion.WARP_W)):
        keep = fusion.tile_reach(tabs, sc, cam, mp, (th, tw))
        ty = torch.arange(mp.height) // th
        tx = torch.arange(mp.width) // tw
        lost += int((carve & ~keep[:, ty][:, :, tx]).sum())
    keep = fusion.tile_reach(tabs, sc, cam, mp)
    return lost, float(keep.float().mean()), int(carve.sum())


def _rendered(n, seed, row_stride, per_env=1):
    """Frames rendered from n seeded worlds at n x per_env poses:
    B8 v3's (tabs, sc) flattened to (n * per_env, w) and (n * per_env, 8)."""
    worlds = scenegen.generate_batch(_cuda.make_generator(seed, "cpu"), n,
                                     WorldParams(num_boxes=10))
    rng = np.random.default_rng(seed)
    m = n * per_env
    pos = torch.from_numpy(np.stack([
        rng.uniform(-1.0, 4.0, m), rng.uniform(-2.0, 2.0, m),
        rng.uniform(1.5, 2.5, m)], -1).astype(np.float32))
    acc = torch.from_numpy(rng.normal(scale=2.0, size=(m, 3)).astype(
        np.float32))
    yaw = torch.from_numpy(rng.uniform(-1.2, 1.2, m).astype(np.float32))
    quat = frames.quat_from_accel_yaw(acc, yaw)
    pos, quat = pos.reshape(n, per_env, 3), quat.reshape(n, per_env, 4)
    depth = raycast.render_depth(worlds, pos, quat, CAM, row_stride)
    tabs, sc, _ = fusion._multi_inputs(depth, pos, quat, CAM, MP, row_stride)
    return tabs, sc


def test_tile_shape_matches_kernel():
    """TILE_W, TILE_H, WARP_W, WARP_H, REACH_REL, the frame record's words,
    the tiles a block and the shared memory cap are csrc/fusion_tile.cuh's
    constants, and tile_smem_bytes is its fuse_tile_smem_bytes."""
    src = (Path(fusion.__file__).parent.parent / "csrc" /
           "fusion_tile.cuh").read_text()

    def const(name):
        return float(re.search(rf"constexpr \w+ {name} = ([0-9.e-]+)f?;",
                               src).group(1))
    assert const("kTileW") == fusion.TILE_W
    assert const("kTileH") == fusion.TILE_H
    assert const("kWarpW") == fusion.WARP_W
    assert const("kWarpH") == fusion.WARP_H
    assert const("kReachRel") == fusion.REACH_REL
    assert const("kFrameWords") == fusion._FRAME_WORDS
    assert const("kTilesPerBlock") == fusion._TILES_PER_BLOCK
    assert const("kFuseSmemMax") == fusion._SMEM_MAX
    body = re.search(r"fuse_tile_smem_bytes\(int F, int Wcam\) \{(.*?)\}",
                     src, re.S).group(1)
    assert "(F + 1) / 2) * kTileCells" in body
    assert "2 * static_cast<size_t>(F) * Wcam" in body
    assert "(F) * (kFrameWords + kTilesPerBlock)" in body
    assert "kTilesPerBlock + 1" in body


def test_frame_limit_and_refusals():
    """68 frames of width 160 fit a block's 227 KB, 69 do not; v2 takes
    one frame up to width 28,532. The launchers raise before any launch
    (here on CPU tensors, which never reach the kernel library)."""
    assert fusion.tile_smem_bytes(68, 160) <= fusion._SMEM_MAX
    assert fusion.tile_smem_bytes(69, 160) > fusion._SMEM_MAX
    assert fusion.tile_smem_bytes(1, 28532) <= fusion._SMEM_MAX
    assert fusion.tile_smem_bytes(1, 28533) > fusion._SMEM_MAX
    B, H, W = 2, 16, 128
    lo = torch.zeros((B, H, W))
    with pytest.raises(ValueError, match="frames"):
        fusion.launch_fuse_multi(lo, torch.zeros((B, 69, 160)),
                                 torch.zeros((B, 69, 8)),
                                 torch.zeros((B, 69, 160), dtype=torch.int32),
                                 torch.empty_like(lo), CAM, MP)
    cam_w = CameraParams(width=28533)
    with pytest.raises(ValueError, match="frames"):
        fusion.launch_fuse(lo, torch.zeros((B, 28533)), torch.zeros((B, 8)),
                           torch.zeros((B, 28533), dtype=torch.int64),
                           torch.empty_like(lo), cam_w, MP)


@pytest.mark.parametrize("row_stride", [1, 4])
@pytest.mark.parametrize("seed", [2, 5])
def test_every_carved_cell_lies_in_a_reached_tile(row_stride, seed):
    """Rendered frames, one per env and five per env: every carved cell's
    tile is kept, and the test drops most tile-frames."""
    for n, per_env in ((6, 1), (2, 5)):
        tabs, sc = _rendered(n, seed, row_stride, per_env)
        lost, kept, n_carved = _carved_outside(tabs.reshape(n * per_env, -1),
                                               sc.reshape(n * per_env, 8))
        assert lost == 0
        assert n_carved > 1000
        assert kept < 0.5
        keep = fusion.tile_reach(tabs, sc, CAM, MP)
        assert keep.shape == (n, per_env, MP.height // fusion.TILE_H,
                              MP.width // fusion.TILE_W)


def _sc(cx, cy, yaw, mp=MP):
    """(N, 8) scalars of cameras at (cx, cy) with yaw, as _frame_inputs
    gives them."""
    cx, cy, yaw = (torch.as_tensor(np.asarray(a, np.float32))
                   for a in (cx, cy, yaw))
    yaw64 = yaw.double()
    z = torch.zeros_like(cx)
    return torch.stack([torch.full_like(cx, mp.origin_x + 0.5 * mp.resolution),
                        torch.full_like(cx, mp.origin_y + 0.5 * mp.resolution),
                        cx, cy, torch.cos(yaw64).float(),
                        torch.sin(yaw64).float(), z, z], 1)


def _corner(ty, tx, mp=MP):
    """The world position of tile (ty, tx)'s first cell centre."""
    return (mp.origin_x + (tx * fusion.TILE_W + 0.5) * mp.resolution,
            mp.origin_y + (ty * fusion.TILE_H + 0.5) * mp.resolution)


def test_cameras_on_tile_corners_and_edges_with_axis_yaws():
    """Cameras on tile corners (the first cell centre of a tile, and half a
    cell off it), on the midpoints of tile edges and at a tile's far
    corner, at yaws 0, +-pi/2, pi and the yaws that lay an edge of the
    field of view along an axis, with full tables of 6 m and of 8.2 m."""
    half_fov = math.atan((CAM.width / 2.0) / CAM.fx)
    yaws = [0.0, math.pi / 2, -math.pi / 2, math.pi]
    yaws += [s * half_fov + k * math.pi / 2 for s in (1, -1)
             for k in range(4)]
    pts = []
    for ty, tx in ((2, 3), (3, 4), (0, 0), (5, 7)):
        x, y = _corner(ty, tx)
        step = MP.resolution
        pts += [(x, y), (x - 0.5 * step, y - 0.5 * step),
                (x + 15.5 * step, y), (x, y + 15.5 * step),
                (x + 31 * step, y + 31 * step)]
    cx = [p[0] for p in pts for _ in yaws]
    cy = [p[1] for p in pts for _ in yaws]
    yw = [a for _ in pts for a in yaws]
    sc = _sc(cx, cy, yw)
    for r in (6.0, 8.2):
        tabs = torch.full((sc.shape[0], CAM.width), r)
        lost, kept, n_carved = _carved_outside(tabs, sc)
        assert lost == 0 and n_carved > 0
        assert kept < 0.6


def test_random_cameras_near_tile_corners():
    """400 cameras within 1e-4 m of tile corners and of cell centres, random
    yaws and random tables in [0, 9] m (some columns 0)."""
    rng = np.random.default_rng(11)
    n = 400
    ty = rng.integers(0, MP.height // fusion.TILE_H, n)
    tx = rng.integers(0, MP.width // fusion.TILE_W, n)
    x, y = _corner(ty, tx)
    off = rng.integers(-3, 4, (n, 2)) * MP.resolution
    jit = rng.uniform(-1e-4, 1e-4, (n, 2)) * (rng.random((n, 1)) < 0.5)
    sc = _sc(x + off[:, 0] + jit[:, 0], y + off[:, 1] + jit[:, 1],
             rng.uniform(-math.pi, math.pi, n))
    tabs = torch.from_numpy(rng.uniform(0.0, 9.0, (n, CAM.width)).astype(
        np.float32))
    tabs[torch.from_numpy(rng.random((n, CAM.width)) < 0.2)] = 0.0
    lost, kept, n_carved = _carved_outside(tabs, sc)
    assert lost == 0 and n_carved > 10000
    assert kept < 0.5


def test_cameras_outside_the_map():
    """Cameras beyond each edge of the map, looking in and looking away."""
    x_lo, y_lo = MP.origin_x - 2.0, MP.origin_y - 2.0
    x_hi = MP.origin_x + MP.width * MP.resolution + 2.0
    y_hi = MP.origin_y + MP.height * MP.resolution + 2.0
    ym = MP.origin_y + 0.5 * MP.height * MP.resolution
    xm = MP.origin_x + 0.5 * MP.width * MP.resolution
    cx = [x_lo, x_lo, x_hi, x_hi, xm, xm, xm, xm, x_lo]
    cy = [ym, ym, ym, ym, y_lo, y_lo, y_hi, y_hi, y_lo]
    yaw = [0.0, math.pi, math.pi, 0.0, math.pi / 2, -math.pi / 2,
           -math.pi / 2, math.pi / 2, math.pi / 4]
    sc = _sc(cx, cy, yaw)
    tabs = torch.full((sc.shape[0], CAM.width), 8.2)
    lost, kept, n_carved = _carved_outside(tabs, sc)
    keep = fusion.tile_reach(tabs, sc, CAM, MP)
    assert lost == 0 and n_carved > 0
    # looking away from the map: no tile is kept
    for i in (1, 3, 5, 7):
        assert not bool(keep[i].any())


def test_nothing_to_carve():
    """A table of all res (T = 0) and one of NaN: nothing carves and the
    reach test keeps no tile."""
    sc = _sc([0.0, 1.0], [0.0, -1.0], [0.0, 0.7])
    for value in (MP.resolution, float("nan")):
        tabs = torch.full((2, CAM.width), value)
        lost, kept, n_carved = _carved_outside(tabs, sc)
        assert lost == 0 and n_carved == 0 and kept == 0.0


def test_cells_at_the_behind_limit_and_on_a_carve_radius():
    """Yaw 0 and a camera 1e-6 m (and 0, and 2e-6 m) left of a column of
    cell centres that is a tile's first column, so that dcx of those cells
    is at the 1e-6 limit; and tables whose carve radius, less res, equals
    the distance of a cell centre in a tile's first row or column (that
    cell stays uncarved, its neighbours nearer the camera carve): the tile
    is kept, and dropped at half that table."""
    x, y = _corner(2, 4)
    cx, cy, yaw = [], [], []
    for d in (0.0, 1e-6, 2e-6, -1e-6):
        cx.append(float(np.float32(x) - np.float32(d)))
        cy.append(y + 0.35)
        yaw.append(0.0)
    sc = _sc(cx, cy, yaw)
    tabs = torch.full((sc.shape[0], CAM.width), 8.2)
    lost, _, n_carved = _carved_outside(tabs, sc)
    assert lost == 0 and n_carved > 0
    # carve radii through cell centres of tile (3, 6) seen from (2, 4)
    cxy = _corner(2, 4)
    targets = [_corner(3, 6), (_corner(3, 6)[0] + 0.1 * 31, _corner(3, 6)[1]),
               (_corner(3, 6)[0], _corner(3, 6)[1] + 0.1 * 31)]
    rs = [math.hypot(tx - cxy[0], ty - cxy[1]) for tx, ty in targets]
    sc = _sc([cxy[0]] * len(rs), [cxy[1]] * len(rs),
             [math.atan2(ty - cxy[1], tx - cxy[0]) for tx, ty in targets])
    r32 = torch.tensor(rs, dtype=torch.float32)
    tabs = (r32 + torch.tensor(MP.resolution, dtype=torch.float32))[:, None] \
        .expand(-1, CAM.width).contiguous()
    lost, _, n_carved = _carved_outside(tabs, sc)
    assert lost == 0 and n_carved > 0
    keep = fusion.tile_reach(tabs, sc, CAM, MP)
    assert bool(keep[0, 3, 6])
    far = fusion.tile_reach(tabs * 0.5, sc, CAM, MP)
    assert not bool(far[0, 3, 6])


def test_plain_fusion_unchanged_outside_reached_tiles():
    """The plain one-frame fusion without hits (the kernel's carve and
    clip) leaves every cell of an unreached tile at clip(cell): the skip is
    a no-op on the carve, on a grid holding values past the clamp bounds
    and -0.0."""
    tabs, sc = _rendered(3, 7, 1)
    tabs, sc = tabs[:, 0].contiguous(), sc[:, 0].contiguous()
    rng = np.random.default_rng(3)
    lo = torch.from_numpy(rng.uniform(-4.0, 5.0, (3, MP.height, MP.width))
                          .astype(np.float32))
    lo[:, ::7, ::5] = -0.0
    no_hit = torch.full((3, CAM.width), -1, dtype=torch.int64)
    out = fusion._fuse_plain(lo, tabs, sc, no_hit, CAM, MP)
    keep = fusion.tile_reach(tabs, sc, CAM, MP)
    ty = torch.arange(MP.height) // fusion.TILE_H
    tx = torch.arange(MP.width) // fusion.TILE_W
    skip = ~keep[:, ty][:, :, tx]
    l_min, l_max = (occupancy._l(MP.clamp_min), occupancy._l(MP.clamp_max))
    want = torch.clamp(lo, l_min, l_max)
    assert torch.equal(out[skip], want[skip])
    assert bool((out[~skip] != want[~skip]).any())


# ---- B8 v1: the same reach test on each env's window of the default map

MP1 = MapParams(fusion="2d_dense")           # the reference's default map
CAM4 = CameraParams(max_range=4.0)           # whose window fits it


def _window_carved_outside(tabs, sc_w, mp=MP1, cam=CAM4):
    """As _carved_outside, on the windows: (cells that v1's carve frees in a
    window tile or strip that fusion.window_reach drops, the kept share of
    the windows' strips, the carved cells)."""
    ch, cw = fusion._window_cells(cam, mp)
    carve = fusion._carve_update((tabs.shape[0], ch, cw), tabs, sc_w, cam,
                                 mp, half_even=True) != 0
    lost = 0
    for th, tw in ((fusion.TILE_H, fusion.TILE_W),
                   (fusion.WARP_H, fusion.WARP_W)):
        keep = fusion.window_reach(tabs, sc_w, cam, mp, (th, tw))
        lost += int((carve & ~keep[:, torch.arange(ch) // th]
                     [:, :, torch.arange(cw) // tw]).sum())
    keep = fusion.window_reach(tabs, sc_w, cam, mp,
                               (fusion.WARP_H, fusion.WARP_W))
    return lost, float(keep.float().mean()), int(carve.sum())


def test_window_shape_matches_kernel():
    """WINDOW_MAX and the window's tiles a block are csrc/fusion_tile.cuh's
    kWindowMax and kWindowTiles, window_smem_bytes is its
    fuse_window_smem_bytes, and the v1 instance rounds the column index
    half to even (rintf) where v2 and v3 take floor(u + 0.5)."""
    src = (Path(fusion.__file__).parent.parent / "csrc" /
           "fusion_tile.cuh").read_text()
    assert int(re.search(r"constexpr int kWindowMax = (\d+);", src)
               .group(1)) == fusion.WINDOW_MAX
    assert ("kWindowTiles = (kWindowMax / kTileH) * (kWindowMax / kTileW)"
            in src)
    assert fusion._WINDOW_TILES == (fusion.WINDOW_MAX // fusion.TILE_H) * (
        fusion.WINDOW_MAX // fusion.TILE_W)
    body = re.search(r"fuse_window_smem_bytes\(int Wcam\) \{(.*?)\}", src,
                     re.S).group(1)
    assert "static_cast<size_t>(kTileCells) + 2 * static_cast<size_t>(Wcam)" \
        in body
    assert "(kFrameWords + kWindowTiles) + kWindowTiles + 2" in body
    assert "kWindow ? rintf(u) : floorf(__fadd_rn(u, 0.5f))" in src


def test_window_limits_and_refusals():
    """An image width of 28,523 fits a v1 block's 227 KB, 28,524 does not;
    the launcher raises before any launch (CPU tensors never reach the
    kernel library), and the check refuses windows past WINDOW_MAX cells a
    side or larger than the grid."""
    assert fusion.window_smem_bytes(28523) <= fusion._SMEM_MAX
    assert fusion.window_smem_bytes(28524) > fusion._SMEM_MAX
    B, H, W = 2, 96, 120
    mp = MapParams(width=W, height=H, fusion="2d_dense")
    cam = CameraParams(width=28524)
    with pytest.raises(ValueError, match="image width"):
        fusion.launch_fuse_window(torch.zeros((B, H, W)),
                                  torch.zeros((B, 28524)), torch.zeros((B, 8)),
                                  torch.zeros((B, 2), dtype=torch.int32),
                                  torch.full((B, 28524), -1,
                                             dtype=torch.int64), cam, mp)
    for ch, cw, h, w in ((129, 64, 256, 448), (64, 129, 256, 448),
                         (97, 64, 96, 120), (0, 64, 96, 120)):
        with pytest.raises(ValueError, match="windows"):
            fusion._check_window(ch, cw, h, w, 160)
    fusion._check_window(128, 128, 256, 448, 160)


def _rendered_windows(n, seed, corner_every=3):
    """Frames of the 4 m camera rendered from n seeded worlds on the default
    map, every corner_every-th camera by one of the map's corners (or past
    it), so that its window clamps there: (tabs, sc_w, org, hit) as
    insert_depth_2d_dense hands them to B8 v1."""
    worlds = scenegen.generate_batch(_cuda.make_generator(seed, "cpu"), n,
                                     WorldParams(num_boxes=10))
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(-1.0, 12.0, n), rng.uniform(-4.0, 4.0, n),
                    rng.uniform(1.5, 2.5, n)], -1)
    x_lo, y_lo = MP1.origin_x, MP1.origin_y
    x_hi = x_lo + MP1.width * MP1.resolution
    y_hi = y_lo + MP1.height * MP1.resolution
    corners = [(x_lo + 1.0, y_lo + 1.3), (x_hi - 0.2, y_hi + 0.5),
               (x_lo - 0.5, y_hi - 2.0), (x_hi + 1.0, y_lo - 1.0)]
    for k, i in enumerate(range(0, n, corner_every)):
        pos[i, :2] = corners[k % 4]
    pos = torch.from_numpy(pos.astype(np.float32))
    acc = torch.from_numpy(rng.normal(scale=2.0, size=(n, 3)).astype(
        np.float32))
    yaw = torch.from_numpy(rng.uniform(-math.pi, math.pi, n).astype(
        np.float32))
    quat = frames.quat_from_accel_yaw(acc, yaw)
    depth = raycast.render_depth(worlds, pos, quat, CAM4)
    tabs, sc, hit = fusion._inputs(depth, pos, quat, CAM4, MP1)
    sc_w, org = fusion._window_inputs(sc, pos, CAM4, MP1)
    return tabs, sc_w, org, hit


@pytest.mark.parametrize("seed", [2, 5])
def test_every_window_carve_lies_in_a_reached_strip(seed):
    """Rendered frames on the default map, windows clamped at its corners
    among them: every cell that v1's carve frees lies in a kept tile and
    strip of its window, and the test drops most strips."""
    tabs, sc_w, org, _ = _rendered_windows(9, seed)
    ch, cw = fusion._window_cells(CAM4, MP1)
    assert (ch, cw) == (114, 114)
    assert bool((org[:, 0] == 0).any()) and bool((org[:, 0] == MP1.height
                                                  - ch).any())
    assert bool((org[:, 1] == 0).any()) and bool((org[:, 1] == MP1.width
                                                  - cw).any())
    lost, kept, n_carved = _window_carved_outside(tabs, sc_w)
    assert lost == 0
    assert n_carved > 1000
    assert kept < 0.5


def test_window_cameras_on_the_image_edges():
    """Yaws of +-hfov / 2 lay an edge of the image, u = -0.5 or u = w - 0.5
    (a column kept by half-to-even rounding at -0.5, not at w - 0.5 with
    w even), along the +x axis; with the camera on the row of a window's
    cell centres those cells sit on the edge. At yaws a quarter turn on,
    the edge runs along a column. Full tables of 4 m and random ones: every
    carved cell's strip is kept, and cells of the camera's row carve."""
    half = CAM4.hfov / 2.0
    yaws = [s * half + k * math.pi / 2 for s in (1, -1) for k in range(4)]
    pts = [(10.0, 0.0), (-7.0, -11.5), (35.9, 12.0), (3.05, 0.0)]
    cx = [p[0] for p in pts for _ in yaws]
    cy = [p[1] for p in pts for _ in yaws]
    yw = [a for _ in pts for a in yaws]
    sc = _sc(cx, cy, yw, MP1)
    pos = torch.stack([sc[:, 2], sc[:, 3], torch.full_like(sc[:, 2], 2.0)], 1)
    sc_w, _ = fusion._window_inputs(sc, pos, CAM4, MP1)
    # each camera onto its window's cell-centre row (or column) 57 exactly
    k57 = torch.tensor(57.0) * torch.tensor(MP1.resolution,
                                            dtype=torch.float32)
    along_x = torch.tensor([abs(math.sin(a - s * half)) < 0.5
                            for a, s in zip(yw, [1, 1, 1, 1, -1, -1, -1, -1]
                                            * len(pts))])
    sc_w[along_x, 3] = sc_w[along_x, 1] + k57
    sc_w[~along_x, 2] = sc_w[~along_x, 0] + k57
    rng = np.random.default_rng(4)
    for tabs in (torch.full((sc_w.shape[0], CAM4.width), 4.0),
                 torch.from_numpy(rng.uniform(0.0, 6.0, (sc_w.shape[0],
                                                         CAM4.width))
                                  .astype(np.float32))):
        lost, kept, n_carved = _window_carved_outside(tabs, sc_w)
        assert lost == 0 and n_carved > 0
        assert kept < 0.6
    ch, cw = fusion._window_cells(CAM4, MP1)
    carve = fusion._carve_update((sc_w.shape[0], ch, cw), tabs, sc_w, CAM4,
                                 MP1, half_even=True) != 0
    assert bool(carve[along_x][:, 57].any())
    assert bool(carve[~along_x][:, :, 57].any())


def _room(d=5.9, tilt=0.6, yaw=math.pi / 4):
    """One drone in the middle of the default map, pitched forward by tilt
    at yaw, inside a room of four walls d metres away: the level top rows
    of its image see the walls past the reach v1's window is sized for.
    Returns (world, pos, quat)."""
    yaw_t = torch.tensor([yaw], dtype=torch.float32)
    a = 9.81 * math.tan(tilt)
    acc = torch.stack([a * torch.cos(yaw_t), a * torch.sin(yaw_t),
                       torch.zeros(1)], -1)
    quat = frames.quat_from_accel_yaw(acc, yaw_t)
    pos = torch.tensor([[10.0, 0.0, 2.5]])
    c = torch.tensor([[[10.0 + d + 1.0, 0.0, 5.0], [10.0 - d - 1.0, 0.0, 5.0],
                       [10.0, d + 1.0, 5.0], [10.0, -d - 1.0, 5.0]]])
    h = torch.tensor([[[1.0, 20.0, 5.0], [1.0, 20.0, 5.0],
                       [20.0, 1.0, 5.0], [20.0, 1.0, 5.0]]])
    world = BoxWorld(centers=c, half_sizes=h,
                     active=torch.ones((1, 4), dtype=torch.bool),
                     shape=torch.zeros((1, 4), dtype=torch.int32))
    return world, pos, quat


def test_hits_outside_the_window_occur():
    """Hits can fall outside v1's window: the pitched drone in the room
    sees the walls 5.9 m away, past the window's 5.7 m half-width. The
    plain version adds them all the same (as the reference's
    _scatter_hits, which never clips hits to the window), so the kernel
    must too, in its one launch."""
    world, pos, quat = _room()
    depth = raycast.render_depth(world, pos, quat, CAM4)
    tabs, sc, hit = fusion._inputs(depth, pos, quat, CAM4, MP1)
    sc_w, org = fusion._window_inputs(sc, pos, CAM4, MP1)
    ch, cw = fusion._window_cells(CAM4, MP1)
    r, c = hit // MP1.width, hit % MP1.width
    inside = ((r >= org[:, :1]) & (r < org[:, :1] + ch)
              & (c >= org[:, 1:]) & (c < org[:, 1:] + cw))
    outside = (hit >= 0) & ~inside
    assert int(outside.sum()) >= 5
    lo = torch.zeros((1, MP1.height, MP1.width))
    out = fusion._fuse_window_plain(lo, tabs, sc_w, org, hit, CAM4, MP1)
    l_hit = occupancy._l(MP1.prob_hit)
    for h in hit[outside].tolist():
        assert float(out.reshape(-1)[h]) >= l_hit - 1e-6
