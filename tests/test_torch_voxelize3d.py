"""The port's 3-D voxelization and analytic SDF (world/voxelize.py
``occupancy_3d``, ``fill_unknown_3d``, ``sdf``) against the JAX package.

Tolerances: the volumes are exactly equal (the same f32 comparisons; the
fill is a fixed point, checked every few steps, with the same result bit
for bit); sdf within 1e-6 (the norms' sums in another order). The two
golden tests mirrored at the end run on the port's own worlds (its random
worlds draw differently from JAX's threefry stream).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import MapParams as JMapParams
from neoplanner_tpu.config import WorldParams as JWorldParams
from neoplanner_tpu.world import scenegen as jscenegen
from neoplanner_tpu.world import voxelize as jvoxelize
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import MapParams, WorldParams
from neoplanner_tpu_torch.core.types import BoxWorld
from neoplanner_tpu_torch.world import scenegen, voxelize
from tests.test_torch_imports import one_torch_thread  # noqa: F401

FIELDS = ("centers", "half_sizes", "active", "shape")
SMALL = dict(width=64, height=48, origin_x=-1.0, origin_y=-2.4)
# worlds that fit the small map: boxes 0.3-1.5 m tall at x 0..5, y -2..2
WP = JWorldParams(num_boxes=6, max_boxes=8, pose_x_min=0.0, pose_x_max=5.0,
                  pose_y_min=-2.0, pose_y_max=2.0, size_z_min=0.3,
                  size_z_max=1.5, rejection_rounds=3)


def _jax_worlds(n, seed):
    """n JAX worlds, every other primitive a cylinder, and the port's
    copies (fields with the env axis)."""
    jw = jscenegen.generate_batch(jax.random.PRNGKey(seed), n, WP)
    shape = np.array(jw.shape)
    shape[:, ::2] = 1
    jw = jw.replace(shape=jnp.asarray(shape))
    tw = BoxWorld(**{f: torch.from_numpy(np.array(getattr(jw, f)))
                     for f in FIELDS})
    return jw, tw


def _one(world, i):
    return type(world)(**{f: getattr(world, f)[i] for f in FIELDS})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_occupancy_3d_and_fill_equal_jax(seed):
    mp = MapParams(**SMALL)
    jmp = JMapParams(**SMALL)
    jw, tw = _jax_worlds(3, seed)
    batched = voxelize.occupancy_3d(tw, mp, 20, z_origin=-0.05)
    for i in range(3):
        want = np.asarray(jvoxelize.occupancy_3d(_one(jw, i), jmp, 20,
                                                 z_origin=-0.05))
        got = voxelize.occupancy_3d(_one(tw, i), mp, 20, z_origin=-0.05)
        assert got.dtype == torch.float32 and want.sum() > 100
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(batched[i].numpy(), want)
        filled = voxelize.fill_unknown_3d(got)
        np.testing.assert_array_equal(
            filled.numpy(), np.asarray(jvoxelize.fill_unknown_3d(
                jnp.asarray(want))))


def test_occupancy_3d_chunks_over_primitives(monkeypatch):
    """A chunk of one primitive at a time gives the same volume."""
    mp = MapParams(**SMALL)
    _, tw = _jax_worlds(2, 7)
    whole = voxelize.occupancy_3d(tw, mp, 20)
    monkeypatch.setattr(voxelize, "_CHUNK_ELEMS", 1)
    np.testing.assert_array_equal(voxelize.occupancy_3d(tw, mp, 20).numpy(),
                                  whole.numpy())


def _shell():
    occ = np.zeros((8, 16, 16), np.float32)
    occ[2:7, 4:10, 4:10] = 1.0
    occ[3:6, 5:9, 5:9] = 0.0
    return occ


def _walls():
    """A room with an open door and a closed box inside it."""
    occ = np.zeros((10, 24, 20), np.float32)
    occ[:, 4, 2:18] = occ[:, 20, 2:18] = 1.0
    occ[:, 4:21, 2] = occ[:, 4:21, 17] = 1.0
    occ[0:6, 20, 9:12] = 0.0
    occ[3:8, 8:14, 5:9] = 1.0
    occ[4:7, 9:13, 6:8] = 0.0
    return occ


@pytest.mark.parametrize("case", ["shell", "solid", "walls", "seeds"])
def test_fill_unknown_3d_equals_jax(case, monkeypatch):
    seeds = None
    if case == "shell":
        occ = _shell()
    elif case == "solid":
        occ = np.zeros((4, 8, 8), np.float32)
        occ[1:3, 2:5, 2:5] = 1.0
    elif case == "walls":
        occ = _walls()
    else:
        occ = _walls()
        seeds = ((0, 12, 10), (9, 0, 0), (5, 12, 10))
    want = np.asarray(jvoxelize.fill_unknown_3d(jnp.asarray(occ), seeds))
    got = voxelize.fill_unknown_3d(torch.from_numpy(occ), seeds)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "solid":
        np.testing.assert_array_equal(got.numpy(), occ)
    free16, steps16 = voxelize.flood_free(torch.from_numpy(occ), seeds)
    monkeypatch.setattr(voxelize, "FILL_CHECK_EVERY", 1)
    free1, steps1 = voxelize.flood_free(torch.from_numpy(occ), seeds)
    assert torch.equal(free1, free16) and steps16 % 16 == 0
    assert steps1 <= steps16


def test_fill_unknown_3d_cavity():
    """The mirror of tests/test_world.py::test_fill_unknown_3d_cavity."""
    filled = voxelize.fill_unknown_3d(torch.from_numpy(_shell())).numpy()
    assert filled[4, 6, 6] == 1.0
    assert filled[4, 12, 12] == 0.0
    assert filled[0, 0, 0] == 0.0
    assert filled[2, 6, 6] == 1.0


@pytest.mark.parametrize("seed", [3, 4])
def test_sdf_equals_jax(seed):
    jw, tw = _jax_worlds(2, seed)
    rng = np.random.default_rng(seed)
    for i in range(2):
        c = np.asarray(jw.centers[i])
        a = np.asarray(jw.active[i])
        # random points, and points inside and next to every primitive
        pts = np.concatenate([
            rng.uniform([-1.0, -3.0, -0.5], [6.0, 3.0, 2.5], (400, 3)),
            c[a] + rng.normal(scale=0.2, size=(int(a.sum()), 3)),
            c[a]]).astype(np.float32)
        want = np.asarray(jvoxelize.sdf(_one(jw, i), jnp.asarray(pts)))
        got = voxelize.sdf(_one(tw, i), torch.from_numpy(pts)).numpy()
        assert (want < 0).sum() >= a.sum()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        # the batched form, each env against its own world
        both = voxelize.sdf(tw, torch.from_numpy(np.stack([pts, pts])))
        np.testing.assert_allclose(both[i].numpy(), want, rtol=0, atol=1e-6)
    # inactive primitives are at +inf
    empty = _one(tw, 0).replace(active=torch.zeros(8, dtype=torch.bool))
    assert torch.isinf(voxelize.sdf(empty, torch.zeros(5, 3))).all()


def test_voxelize_occupancy_marks_boxes():
    """The mirror of tests/test_world.py::test_voxelize_occupancy_marks_boxes
    (occupancy_2d of one world, with the env axis)."""
    mp = MapParams(width=128, height=128, origin_x=-2.0, origin_y=-6.4)
    world = scenegen.generate_batch(_cuda.make_generator(2, "cpu"), 1,
                                    WorldParams(num_boxes=8))
    occ = voxelize.occupancy_2d(world, mp)[0].numpy()
    c = world.centers[0].numpy()
    for i in np.where(world.active[0].numpy())[0]:
        col = int((c[i, 0] - mp.origin_x) / mp.resolution)
        row = int((c[i, 1] - mp.origin_y) / mp.resolution)
        if 0 <= row < mp.height and 0 <= col < mp.width:
            assert occ[row, col] == 1.0, i
    assert occ[:, :10].sum() == 0


def test_sdf_sign_and_value():
    """The mirror of tests/test_world.py::test_sdf_sign_and_value."""
    world = scenegen.generate(_cuda.make_generator(3, "cpu"),
                              WorldParams(num_boxes=1, max_boxes=4))
    i = int(np.where(world.active.numpy())[0][0])
    center = world.centers[i]
    assert float(voxelize.sdf(world, center)) < 0
    far = center + torch.tensor([0.0, 0.0, 20.0])
    d_far = float(voxelize.sdf(world, far))
    assert abs(d_far - (20.0 - float(world.half_sizes[i, 2]))) < 1e-3
