"""Multi-frame depth fusion of the PyTorch port (mapping/fusion.py
insert_depth_2d_dense_multi, kernel B8 v3's plain version) against the JAX
package's occupancy_pallas.insert_depth_2d_dense_multi in interpret mode:
the v3 TPU kernel itself (an 8-aligned row window around each camera, hit
counts from one-hot matrix products).

The map is 192 x 128 cells, as in test_torch_fusion.py (v2-eligible, and
taller than the kernel's 176-row window, so the reference updates a window
while the port covers the whole grid). 2 envs fly slowly among obstacles
for 3 segments; each segment fuses 3 frames rendered at row_stride 4 in one
call, so that cells carved or hit again and again reach the clamp bounds.

Tolerances as test_torch_fusion.py: the grids cell for cell, where a cell
may differ only by exactly one l_miss or l_hit quantum (a cell centre on a
carve radius, or a hit point on a cell edge, can fall either way under the
renderers' and the reductions' roundoff) and at most 1e-3 of the updated
cells may. The clip order is held apart from B8 v2's: the same frames
fused by three chained insert_depth_2d_dense calls differ from the one
multi-frame call on cells at the lower clamp bound.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import CameraParams as JCameraParams
from neoplanner_tpu.config import MapParams as JMapParams
from neoplanner_tpu.mapping import occupancy_pallas
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import CameraParams, MapParams, WorldParams
from neoplanner_tpu_torch.core import frames
from neoplanner_tpu_torch.mapping import fusion, occupancy
from neoplanner_tpu_torch.sense import raycast
from neoplanner_tpu_torch.world import scenegen
from tests.test_torch_imports import one_torch_thread  # noqa: F401

MAPP = dict(width=128, height=192, origin_x=-2.0, origin_y=-9.6,
            fusion="2d_dense", fusion_row_stride=4)
B, F, SEGMENTS = 2, 3, 3


def _segments():
    """Worlds, and per segment the F poses of each env along a slow
    swaying path with the frames rendered there at row_stride 4."""
    gen = _cuda.make_generator(3, "cpu")
    worlds = scenegen.generate_batch(gen, B, WorldParams(num_boxes=10))
    worlds = worlds.replace(centers=worlds.centers - torch.tensor(
        [3.0, 0.0, 0.0]))
    cam = CameraParams()
    out = []
    for seg in range(SEGMENTS):
        k = torch.arange(F * seg, F * seg + F, dtype=torch.float32)
        e = torch.arange(B, dtype=torch.float32)[:, None]
        pos = torch.stack([0.3 + 0.08 * k + 0.5 * e,
                           0.2 * torch.sin(0.7 * k) - 0.4 * e,
                           torch.full_like(k + e, 2.0)], -1)      # (B, F, 3)
        yaw = 0.2 * torch.sin(0.5 * k + e)
        acc = torch.zeros((B, F, 3))
        quat = frames.quat_from_accel_yaw(acc, yaw)
        depth = raycast.render_depth(worlds, pos, quat, cam, row_stride=4)
        out.append((depth, pos, quat))
    return out


@pytest.fixture(scope="module")
def fused():
    """The grids after each segment: (port v3, JAX v3, port chained v2)."""
    cam, mp = CameraParams(), MapParams(**MAPP)
    jcam, jmp = JCameraParams(), JMapParams(**MAPP)
    jfuse = jax.jit(jax.vmap(lambda lo, d, p, q: (
        occupancy_pallas.insert_depth_2d_dense_multi(
            lo, d, p, q, jcam, jmp, row_stride=4, interpret=True))))
    lo_t = lo_v2 = occupancy.logodds_init(mp, B)
    lo_j = jnp.zeros((B, mp.height, mp.width))
    out = []
    for depth, pos, quat in _segments():
        lo_t = fusion.insert_depth_2d_dense_multi(lo_t, depth, pos, quat,
                                                  cam, mp, row_stride=4)
        for f in range(F):
            lo_v2 = fusion.insert_depth_2d_dense(
                lo_v2, depth[:, f], pos[:, f], quat[:, f], cam, mp,
                row_stride=4)
        lo_j = jfuse(lo_j, jnp.asarray(depth.numpy()),
                     jnp.asarray(pos.numpy()), jnp.asarray(quat.numpy()))
        out.append((lo_t.numpy(), np.asarray(lo_j), lo_v2.numpy()))
    return out


@pytest.mark.parametrize("seg", range(SEGMENTS))
def test_multi_frame_grid_matches_v3_kernel(fused, seg):
    got, want, _ = fused[seg]
    mp = MapParams(**MAPP)
    quanta = np.abs(np.float32([occupancy._l(mp.prob_miss),
                                occupancy._l(mp.prob_hit)]))
    diff = np.abs(got - want)
    off = diff != 0.0
    assert np.isclose(diff[off][:, None], quanta[None], rtol=1e-5).any(1).all()
    updated = int((want != 0.0).sum())
    assert updated > 1000             # frames carve and hit real cells
    assert int(off.sum()) <= 1e-3 * updated


def test_clamp_bounds_engage_and_clip_order_differs(fused):
    """Carved and hit cells reach both clamp bounds; chained v2 updates
    differ from the one clip per frame only on cells at the lower bound;
    and on cells at the lower bound that a frame both carves and hits, the
    two orders differ by exactly one l_miss (v2 clips the carve away before
    adding the hit)."""
    got, _, chained = fused[-1]
    mp, cam = MapParams(**MAPP), CameraParams()
    l_min = np.float32(occupancy._l(mp.clamp_min))
    l_max = np.float32(occupancy._l(mp.clamp_max))
    assert int((got == l_min).sum()) > 100
    assert int((got == l_max).sum()) > 10
    differ = got != chained
    assert bool(((got == l_min) | (chained == l_min))[differ].all())

    # one more frame whose hit columns land on cells that it also carves
    # and that sit at the lower bound
    depth, pos, quat = _segments()[-1]
    tabs, sc, hit = fusion._multi_inputs(depth[:, :1], pos[:, :1],
                                         quat[:, :1], cam, mp, 4)
    lo = torch.from_numpy(got)
    carved = fusion._carve_update(lo.shape, tabs[:, 0], sc[:, 0], cam,
                                  mp) != 0
    forced = []
    for e in range(B):
        cells = torch.nonzero((carved[e] & (lo[e] == l_min)).flatten())[:, 0]
        assert cells.numel() >= 20
        hit[e, 0, :20] = cells[:20].to(torch.int32)
        forced.append(cells[:20])
    v3 = fusion._fuse_multi_plain(lo, tabs, sc, hit, cam, mp)
    flat = torch.where(hit[:, 0] >= 0, hit[:, 0].long() + torch.arange(
        B)[:, None] * (mp.height * mp.width), -1)
    v2 = fusion._fuse_plain(lo, tabs[:, 0], sc[:, 0], flat, cam, mp)
    l_miss = np.float32(occupancy._l(mp.prob_miss))
    for e in range(B):
        d = (v2[e].flatten()[forced[e]] - v3[e].flatten()[forced[e]]).numpy()
        np.testing.assert_allclose(d, -l_miss, rtol=1e-5)


def test_strided_polar_columns_match():
    """polar_columns over row-strided frames against the JAX reduction."""
    from neoplanner_tpu.mapping import occupancy as joccupancy
    cam, mp = CameraParams(), MapParams(**MAPP)
    jcam, jmp = JCameraParams(), JMapParams(**MAPP)
    depth, pos, quat = _segments()[0]
    got = occupancy.polar_columns(depth[:, 0], pos[:, 0], quat[:, 0], cam,
                                  mp, row_stride=4)
    for e in range(B):
        want = joccupancy.polar_columns(
            jnp.asarray(depth[e, 0].numpy()), jnp.asarray(pos[e, 0].numpy()),
            jnp.asarray(quat[e, 0].numpy()), jcam, jmp, row_stride=4)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[e].numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-5)


def test_irregular_map_raises():
    """Multi-frame fusion needs a v2-eligible map, as in the reference."""
    mp = MapParams(width=200, height=100, fusion="2d_dense")
    depth, pos, quat = _segments()[0]
    with pytest.raises(ValueError, match="width % 128"):
        fusion.insert_depth_2d_dense_multi(occupancy.logodds_init(mp, B),
                                           depth, pos, quat, CameraParams(),
                                           mp, row_stride=4)


def test_cpu_tensor_takes_plain_version():
    cam, mp = CameraParams(), MapParams(**MAPP)
    depth, pos, quat = _segments()[0]
    before = _cuda.launches["fuse_depth_multi"]
    fusion.insert_depth_2d_dense_multi(occupancy.logodds_init(mp, B), depth,
                                       pos, quat, cam, mp, row_stride=4)
    assert _cuda.launches["fuse_depth_multi"] == before
