"""Depth fusion of the PyTorch port (mapping/occupancy.py and
mapping/fusion.py, kernel B8 v2's plain version) against the JAX package.

The JAX reference is occupancy_pallas.insert_depth_2d_dense in interpret
mode: the v2 TPU kernel itself (an 8-aligned row window around the camera,
128-lane column halves) plus the hit scatter. The scatter form
occupancy.insert_depth_2d is another function and is not used. The map is
192 x 128 cells (v2-eligible, and taller than the kernel's 176-row window,
so the reference updates a window while the port covers the whole grid),
2 envs, 3 frames fused in sequence from poses among the obstacles.

Tolerances: the per-column reduction (polar_columns) to 1e-5 m, a sum of
three products taken in another order; the fused grids cell for cell, where
a cell may differ only by exactly one l_miss or l_hit quantum (a cell
centre on the carve radius, or a hit point on a cell edge, can fall either
way under that roundoff) and at most 1e-3 of the updated cells may.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import CameraParams as JCameraParams
from neoplanner_tpu.config import MapParams as JMapParams
from neoplanner_tpu.mapping import occupancy as joccupancy
from neoplanner_tpu.mapping import occupancy_pallas
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import CameraParams, MapParams, WorldParams
from neoplanner_tpu_torch.core import frames
from neoplanner_tpu_torch.mapping import fusion, occupancy
from neoplanner_tpu_torch.sense import raycast
from neoplanner_tpu_torch.world import scenegen
from tests.test_torch_imports import one_torch_thread  # noqa: F401

MAPP = dict(width=128, height=192, origin_x=-2.0, origin_y=-9.6,
            fusion="2d_dense")
B, FRAMES = 2, 3


def _frames():
    """Worlds, and FRAMES poses per env with their rendered depth."""
    gen = _cuda.make_generator(3, "cpu")
    worlds = scenegen.generate_batch(gen, B, WorldParams(num_boxes=10))
    # pull the obstacles in front of the drones so that frames hit them
    worlds = worlds.replace(centers=worlds.centers - torch.tensor(
        [3.0, 0.0, 0.0]))
    rng = np.random.default_rng(4)
    cam = CameraParams()
    out = []
    for _ in range(FRAMES):
        pos = torch.from_numpy(np.stack([
            rng.uniform(0.0, 3.0, B), rng.uniform(-1.0, 1.0, B),
            rng.uniform(1.9, 2.3, B)], -1).astype(np.float32))
        acc = torch.from_numpy(rng.normal(scale=1.5, size=(B, 3)).astype(
            np.float32))
        yaw = torch.from_numpy(rng.uniform(-0.8, 0.8, B).astype(np.float32))
        quat = frames.quat_from_accel_yaw(acc, yaw)
        depth = raycast.render_depth(worlds, pos, quat, cam)
        out.append((depth, pos, quat))
    return out


@pytest.fixture(scope="module")
def fused():
    """The grids after each frame: (port, JAX) per frame."""
    cam, mp = CameraParams(), MapParams(**MAPP)
    jcam, jmp = JCameraParams(), JMapParams(**MAPP)
    jfuse = jax.jit(jax.vmap(lambda lo, d, p, q: (
        occupancy_pallas.insert_depth_2d_dense(lo, d, p, q, jcam, jmp,
                                               interpret=True))))
    lo_t = occupancy.logodds_init(mp, B)
    lo_j = jnp.zeros((B, mp.height, mp.width))
    out = []
    for depth, pos, quat in _frames():
        lo_t = fusion.insert_depth_2d_dense(lo_t, depth, pos, quat, cam, mp)
        lo_j = jfuse(lo_j, jnp.asarray(depth.numpy()),
                     jnp.asarray(pos.numpy()), jnp.asarray(quat.numpy()))
        out.append((lo_t.numpy(), np.asarray(lo_j)))
    return out


def test_polar_columns_match():
    cam, mp = CameraParams(), MapParams(**MAPP)
    jcam, jmp = JCameraParams(), JMapParams(**MAPP)
    for depth, pos, quat in _frames():
        got = occupancy.polar_columns(depth, pos, quat, cam, mp)
        for e in range(B):
            want = joccupancy.polar_columns(
                jnp.asarray(depth[e].numpy()), jnp.asarray(pos[e].numpy()),
                jnp.asarray(quat[e].numpy()), jcam, jmp)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g[e].numpy(), np.asarray(w),
                                           rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("frame", range(FRAMES))
def test_fused_grid_matches_dense_kernel(fused, frame):
    got, want = fused[frame]
    mp = MapParams(**MAPP)
    quanta = np.float32([occupancy._l(mp.prob_miss),
                         occupancy._l(mp.prob_hit)])
    diff = got - want
    off = diff != 0.0
    assert np.all(np.isin(np.abs(diff[off]), np.abs(quanta))
                  | np.isclose(np.abs(diff[off])[:, None],
                               np.abs(quanta)[None], rtol=1e-5).any(1))
    updated = int((want != 0.0).sum())
    assert updated > 1000             # frames carve and hit real cells
    assert int(off.sum()) <= 1e-3 * updated


def test_fusion_marks_hits_and_free_space(fused):
    """Not a vacuous match: occupied and free cells both appear."""
    got, _ = fused[-1]
    mp = MapParams(**MAPP)
    assert int((got > occupancy.occ_threshold(mp)).sum()) > 20
    assert int((got < 0.0).sum()) > 1000


def test_irregular_map_raises():
    """On a map that the whole-grid v2 kernel does not take (W % 128 != 0),
    the dense fusion runs the reference's v1 window, which the default 6 m
    camera's reach (168 cells) overflows on a 200 x 100 map: the port
    raises the reference's error, as occupancy_pallas.insert_depth_2d_dense
    does."""
    mp = MapParams(width=200, height=100, fusion="2d_dense")
    depth, pos, quat = _frames()[0]
    assert not fusion.window_fits(CameraParams(), mp)
    assert not occupancy_pallas.window_fits(JCameraParams(),
                                            JMapParams(width=200, height=100))
    with pytest.raises(ValueError, match=r"dense fusion window \(128-cell "
                       r"cap\) does not cover cam.max_range=6.0"):
        fusion.insert_depth_2d_dense(occupancy.logodds_init(mp, B), depth,
                                     pos, quat, CameraParams(), mp)
    with pytest.raises(ValueError, match=r"dense fusion window \(128-cell "
                       r"cap\) does not cover cam.max_range=6.0"):
        occupancy_pallas.insert_depth_2d_dense(
            jnp.zeros((100, 200)), jnp.asarray(depth[0].numpy()),
            jnp.asarray(pos[0].numpy()), jnp.asarray(quat[0].numpy()),
            JCameraParams(), JMapParams(width=200, height=100))


def test_cpu_tensor_takes_plain_version():
    cam, mp = CameraParams(), MapParams(**MAPP)
    depth, pos, quat = _frames()[0]
    before = _cuda.launches["fuse_depth_dense"]
    fusion.insert_depth_2d_dense(occupancy.logodds_init(mp, B), depth, pos,
                                 quat, cam, mp)
    assert _cuda.launches["fuse_depth_dense"] == before
