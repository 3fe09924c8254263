"""The depth kernel B4's tile cull (sense/raycast.tile_cull, the predicate
csrc/raycast.cu computes per tile) against the dense per-primitive tests.

B4 traces, per TILE_H x TILE_W tile of a pose's output image, only the
primitives that survive the cull. That is exact if every (pixel, primitive)
pair whose hit (_ray_box / _ray_cylinder) is finite lies in its tile's
survivors: a missed primitive reads 1e9 and leaves the running minimum
alone. These tests check that on seeded worlds and poses (the JAX
package's scene generator, some primitives made cylinders), at row strides
1 and 4 and with several poses per env, on hand-made grazes, on
primitives behind the camera and on a camera inside a box; then that a
render restricted to the survivors matches the JAX package's render_depth
at tests/test_torch_raycast.py's tolerance (1e-4 m, but for at most 0.1%
of the pixels, where a graze flips under roundoff).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neoplanner_tpu.config import CameraParams as JCameraParams
from neoplanner_tpu.config import WorldParams as JWorldParams
from neoplanner_tpu.core import frames as jframes
from neoplanner_tpu.core.types import BoxWorld as JBoxWorld
from neoplanner_tpu.sense import raycast as jraycast
from neoplanner_tpu.world import scenegen as jscenegen
from neoplanner_tpu_torch.config import CameraParams
from neoplanner_tpu_torch.core import frames
from neoplanner_tpu_torch.core.types import SHAPE_CYLINDER, BoxWorld
from neoplanner_tpu_torch.sense import raycast
from tests.test_torch_imports import one_torch_thread  # noqa: F401

_INF = 1e9


def _t(a):
    return torch.from_numpy(np.array(a))


def _setup(n, seed, frames_per_env=None):
    """n JAX worlds (every third primitive a cylinder) and n poses (or n x
    frames_per_env) looking along +x from the worlds' entry."""
    w = jscenegen.generate_batch(jax.random.PRNGKey(seed), n,
                                 JWorldParams(num_boxes=10))
    shape = np.zeros(w.shape.shape, np.int32)
    shape[:, 1::3] = 1
    w = JBoxWorld(centers=w.centers, half_sizes=w.half_sizes,
                  active=w.active, shape=jnp.asarray(shape))
    rng = np.random.default_rng(seed)
    m = n * (frames_per_env or 1)
    pos = np.stack([rng.uniform(-1.0, 8.0, m), rng.uniform(-3.0, 3.0, m),
                    rng.uniform(0.5, 3.0, m)], -1).astype(np.float32)
    acc = rng.normal(scale=3.0, size=(m, 3)).astype(np.float32)
    yaw = rng.uniform(-1.5, 1.5, m).astype(np.float32)
    quat = np.asarray(jframes.quat_from_accel_yaw(jnp.asarray(acc),
                                                  jnp.asarray(yaw)))
    if frames_per_env:
        pos = pos.reshape(n, frames_per_env, 3)
        quat = quat.reshape(n, frames_per_env, 4)
    tw = BoxWorld(centers=_t(w.centers), half_sizes=_t(w.half_sizes),
                  active=_t(w.active), shape=_t(shape))
    return w, tw, _t(pos), _t(quat)


def _hits(world, pos, quat, cam, row_stride):
    """Per-primitive entry distances (B, F, h, W, K) of every pixel ray, as
    render_depth tests them (inactive primitives read 1e9), and the rays."""
    dirs_body = raycast.ray_dirs_camera(cam, row_stride)          # (h, W, 3)
    H, W = dirs_body.shape[:2]
    B, F = pos.shape[:2]
    dirs = frames.quat_rotate(quat[:, :, None, :],
                              dirs_body.reshape(1, 1, -1, 3)
                              ).reshape(B, F * H * W, 3)
    o = pos[:, :, None, :].expand(B, F, H * W, 3).reshape(B, F * H * W, 3)
    ts = []
    for k in range(world.centers.shape[1]):
        c = world.centers[:, k:k + 1]
        h = world.half_sizes[:, k:k + 1]
        t_k = torch.where((world.shape[:, k] == SHAPE_CYLINDER)[:, None],
                          raycast._ray_cylinder(o, dirs, c, h),
                          raycast._ray_box(o, dirs, c, h))
        ts.append(torch.where(world.active[:, k][:, None], t_k,
                              torch.full_like(t_k, _INF)))
    return torch.stack(ts, -1).reshape(B, F, H, W, -1), dirs, o


def _survivors_per_pixel(keep, H, W):
    """(B, F, TY, TX, K) tile survivors spread to (B, F, H, W, K)."""
    ty = torch.arange(H) // raycast.TILE_H
    tx = torch.arange(W) // raycast.TILE_W
    return keep[:, :, ty][:, :, :, tx]


def _check_hits_survive(world, pos, quat, cam, row_stride):
    keep = raycast.tile_cull(world, pos, quat, cam, row_stride)
    t, _, _ = _hits(world, pos, quat, cam, row_stride)
    H, W = t.shape[2:4]
    assert keep.shape == (pos.shape[0], pos.shape[1],
                          -(-H // raycast.TILE_H), -(-W // raycast.TILE_W),
                          world.centers.shape[1])
    surv = _survivors_per_pixel(keep, H, W)
    lost = (t < _INF) & ~surv
    assert not bool(lost.any()), torch.nonzero(lost)[:8].tolist()
    return keep, t


def test_tile_shape_matches_kernel():
    """TILE_W, TILE_H, CULL_REL and CULL_TANGENT are csrc/raycast.cu's
    constants, and MAX_PRIMS is the primitives whose survivors' tables (two
    float4s each) fit its kTableBytes."""
    src = (Path(raycast.__file__).parent.parent / "csrc" /
           "raycast.cu").read_text()

    def const(name):
        return float(re.search(rf"constexpr \w+ {name} = ([0-9.e-]+)f?;",
                               src).group(1))
    assert const("kTileW") == raycast.TILE_W
    assert const("kTileH") == raycast.TILE_H
    assert const("kCullRel") == raycast.CULL_REL
    assert const("kCullTangent") == raycast.CULL_TANGENT
    table = re.search(r"constexpr size_t kTableBytes = (\d+) - (\d+);", src)
    assert raycast.MAX_PRIMS == (int(table.group(1))
                                 - int(table.group(2))) // 32


@pytest.mark.parametrize("row_stride", [1, 4])
@pytest.mark.parametrize("seed", [2, 5])
def test_every_hit_lies_in_its_tiles_survivors(row_stride, seed):
    """On seeded scenes every finite per-primitive hit survives its tile's
    cull, and the cull still drops most live (tile, primitive) pairs."""
    _, tw, pos, quat = _setup(4, seed, frames_per_env=2)
    cam = CameraParams()
    keep, t = _check_hits_survive(tw, pos, quat, cam, row_stride)
    live = tw.active[:, None, None, None].expand_as(keep)
    assert float(keep.sum()) < 0.6 * float(live.sum())
    assert bool((t < _INF).any())


@pytest.mark.parametrize("row_stride", [1, 4])
def test_cull_on_ragged_tiles(row_stride):
    """Frames whose width and height are no multiple of the tile (last
    tiles one column and a few rows wide), one pose per env."""
    _, tw, pos, quat = _setup(3, 7)
    cam = CameraParams(width=41, height=70)
    keep = raycast.tile_cull(tw, pos, quat, cam, row_stride)
    assert keep.dim() == 4
    _check_hits_survive(tw, pos[:, None], quat[:, None], cam, row_stride)


def _one_world(centers, half_sizes, shape):
    k = len(centers)
    return BoxWorld(centers=_t(np.array(centers, np.float32))[None],
                    half_sizes=_t(np.array(half_sizes, np.float32))[None],
                    active=torch.ones((1, k), dtype=torch.bool),
                    shape=_t(np.array(shape, np.int32))[None])


@pytest.mark.parametrize("cyl", [False, True])
def test_a_corner_ray_graze_survives(cyl):
    """A box or a cylinder 1 mm across one tile's top-left corner ray at
    5 m: the corner pixel hits it, so the tile keeps it; a copy 1.5 m
    further left is culled from that tile."""
    cam = CameraParams()
    col0, row0 = 10 * raycast.TILE_W, raycast.TILE_H
    d = raycast.ray_dirs_camera(cam)[row0, col0].numpy().astype(np.float64)
    o = np.array([0.0, 0.0, 2.0])
    p = o + 5.0 * d
    # the tile's other rays lie right of (body -y) and below the corner ray
    if cyl:
        r = 0.4
        c_in = [p[0], p[1] + r - 1e-3, p[2] + 0.5 - 1e-3]
        hs = [r, r, 0.5]
    else:
        c_in = [p[0], p[1] + 0.5 - 1e-3, p[2] + 0.5 - 1e-3]
        hs = [0.5, 0.5, 0.5]
    c_out = [c_in[0], c_in[1] + 1.5, c_in[2]]
    world = _one_world([c_in, c_out], [hs, hs], [int(cyl)] * 2)
    pos = _t(o.astype(np.float32))[None]
    quat = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    keep = raycast.tile_cull(world, pos, quat, cam)
    t, _, _ = _hits(world, pos[:, None], quat[:, None], cam, 1)
    assert float(t[0, 0, row0, col0, 0]) < 6.0
    ty, tx = row0 // raycast.TILE_H, col0 // raycast.TILE_W
    assert bool(keep[0, ty, tx, 0]) and not bool(keep[0, ty, tx, 1])
    _check_hits_survive(world, pos[:, None], quat[:, None], cam, 1)


def test_behind_the_camera_and_inside_a_box():
    """Primitives behind the camera survive no tile; a box that holds the
    camera survives every tile (its slab test reads no hit, tmin < 0)."""
    world = _one_world([[-3.0, 0.0, 2.0], [-2.0, 1.0, 1.0], [0.0, 0.0, 2.0],
                        [4.0, 0.5, 1.5]],
                       [[0.5, 0.5, 1.0], [0.3, 0.3, 1.0], [1.0, 1.0, 1.0],
                        [0.5, 0.5, 1.5]], [0, 1, 0, 0])
    pos = torch.tensor([[0.2, 0.1, 2.1]])
    quat = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    keep = raycast.tile_cull(world, pos, quat, CameraParams())
    assert not bool(keep[..., :2].any())
    assert bool(keep[..., 2].all())
    _check_hits_survive(world, pos[:, None], quat[:, None], CameraParams(), 1)


def test_no_cylinder_cull_for_a_vertical_cone():
    """A camera pitched straight down on an odd frame, whose centre pixel's
    ray is vertical: the centre tile keeps a cylinder out of view (a
    vertical ray takes the quadratic's a_safe), while the boxes out of view
    are culled."""
    world = _one_world([[-30.0, 0.0, 2.0], [-30.0, 0.0, 2.0]],
                       [[0.5, 0.5, 1.0]] * 2, [0, 1])
    pos = torch.tensor([[0.0, 0.0, 5.0]])
    cam = CameraParams(width=41, height=71)
    s = float(np.sqrt(0.5))
    down = torch.tensor([[s, 0.0, s, 0.0]])          # body x to world -z
    keep = raycast.tile_cull(world, pos, down, cam)
    assert not bool(keep[..., 0].any())
    assert bool(keep[0, 35 // raycast.TILE_H, 20 // raycast.TILE_W, 1])
    _check_hits_survive(world, pos[:, None], down[:, None], cam, 1)


def _render_restricted(world, pos, quat, cam, row_stride):
    """render_depth over each tile's survivors only."""
    keep = raycast.tile_cull(world, pos[:, None], quat[:, None], cam,
                             row_stride)
    t_k, dirs, o = _hits(world, pos[:, None], quat[:, None], cam, row_stride)
    B, _, H, W, _ = t_k.shape
    surv = _survivors_per_pixel(keep, H, W)
    t = torch.where(surv, t_k, torch.full_like(t_k, _INF)).amin(-1)
    t = t.reshape(B, H * W)
    dz = dirs[..., 2]
    down = dz < -1e-6
    t_ground = torch.where(down, -o[..., 2] / torch.where(
        down, dz, torch.full_like(dz, -1.0)), torch.full_like(dz, _INF))
    t = torch.minimum(t, t_ground)
    x_body = frames.quat_rotate(quat, quat.new_tensor([1.0, 0.0, 0.0]))
    z = t * (dirs * x_body[:, None, :]).sum(-1)
    valid = (t < _INF) & (z >= cam.min_range) & (z <= cam.max_range)
    z = torch.where(valid, z, torch.full_like(z, cam.max_range))
    return z.reshape(B, H, W)


@pytest.mark.parametrize("row_stride", [1, 4])
def test_restricted_render_matches_jax(row_stride):
    jw, tw, pos, quat = _setup(3, 11)
    cam, jcam = CameraParams(), JCameraParams()
    got = _render_restricted(tw, pos, quat, cam, row_stride).numpy()
    want = np.asarray(jax.vmap(lambda w, p, q: jraycast.render_depth(
        w, p, q, jcam, row_stride=row_stride))(
            jw, jnp.asarray(pos.numpy()), jnp.asarray(quat.numpy())))
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert np.mean(diff > 1e-4) <= 1e-3, np.sort(diff.ravel())[-20:]
    assert float(np.mean(got < cam.max_range)) > 0.05
    # the restriction changes no pixel of the port's own dense render
    dense = raycast.render_depth(tw, pos, quat, cam, row_stride).numpy()
    np.testing.assert_array_equal(got, dense)
