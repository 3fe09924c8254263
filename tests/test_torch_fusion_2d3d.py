"""The '2d' and '3d' scatter fusions of the PyTorch port
(mapping/occupancy.insert_depth_2d and insert_depth, with
sense/raycast.depth_to_points) against the JAX package, and the agreement
bounds between the port's three fusions.

A scripted flight of 5 frames per env (after tests/test_sense.py::
test_fusion_map_agreement: a 128 x 96 map, 8 generated boxes, a 64 x 48
camera), 2 envs, each frame rendered by the port and fused on both sides
from the same depth; the '3d' reference runs op by op (see flown()).
Tolerances: log-odds within 1e-5 absolute (both sum the same l_miss and
l_hit adds, the reference in update order, PyTorch's index_put_ summing
repeated cells first), the binarized occupancy equal
wherever the reference's cell is more than 1e-4 from the threshold, and
the back-projected points within 1e-5 m (a sum of three products taken in
another order). The agreement bounds are the golden test's: the dense and
the '2d' occupancy IoU > 0.6, '2d' and '3d' > 0.4, 80% of the '2d'
surface in the '3d' one, the dense carve a superset of 90% of the '2d'
carve.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import CameraParams as JCameraParams
from neoplanner_tpu.config import MapParams as JMapParams
from neoplanner_tpu.config import WorldParams as JWorldParams
from neoplanner_tpu.mapping import occupancy as joccupancy
from neoplanner_tpu.sense import raycast as jraycast
from neoplanner_tpu.world import scenegen as jscenegen
from neoplanner_tpu_torch.config import CameraParams, MapParams
from neoplanner_tpu_torch.core import frames
from neoplanner_tpu_torch.core.types import BoxWorld
from neoplanner_tpu_torch.mapping import fusion, occupancy
from neoplanner_tpu_torch.sense import raycast
from tests.test_torch_imports import one_torch_thread  # noqa: F401

MAPP = dict(width=128, height=96, origin_x=-2.0, origin_y=-4.8)
CAM = dict(width=64, height=48)
B = 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _flight():
    """Worlds and the 5 frames (depth, pos, quat) of each env's flight."""
    jw = jscenegen.generate_batch(jax.random.PRNGKey(2), B,
                                  JWorldParams(num_boxes=8))
    world = BoxWorld(centers=_t(jw.centers), half_sizes=_t(jw.half_sizes),
                     active=_t(jw.active), shape=_t(jw.shape))
    cam = CameraParams(**CAM)
    out = []
    for i, yaw in enumerate((0.0, 0.1, -0.1, 0.2, 0.0)):
        pos = torch.tensor([[0.5 + 0.8 * i, 0.2 * i, 2.0],
                            [0.3 + 0.7 * i, -0.3 * i, 2.3]])
        quat = frames.quat_from_yaw(torch.tensor([yaw, -yaw + 0.05]))
        out.append((raycast.render_depth(world, pos, quat, cam), pos, quat))
    return out


@pytest.fixture(scope="module")
def flown():
    """Per frame: the port's and JAX's '2d' and '3d' grids, and the port's
    dense grid."""
    cam, mp = CameraParams(**CAM), MapParams(**MAPP)
    jcam, jmp = JCameraParams(**CAM), JMapParams(**MAPP)
    j2d = jax.jit(jax.vmap(lambda lo, d, p, q: joccupancy.insert_depth_2d(
        lo, d, p, q, jcam, jmp)))
    # op by op: under jit, XLA fuses the carve samples' divide and products
    # and rounds 16% of the sample coordinates differently from its own
    # eager arithmetic, which the port reproduces exactly
    j3d = jax.vmap(lambda lo, d, p, q: joccupancy.insert_depth(
        lo, d, p, q, jcam, jmp))
    lo = {k: occupancy.logodds_init(mp, B) for k in ("2d", "3d", "dense")}
    jlo = {k: jnp.zeros((B, mp.height, mp.width)) for k in ("2d", "3d")}
    out = []
    for depth, pos, quat in _flight():
        args = (jnp.asarray(depth.numpy()), jnp.asarray(pos.numpy()),
                jnp.asarray(quat.numpy()))
        lo["2d"] = occupancy.insert_depth_2d(lo["2d"], depth, pos, quat, cam,
                                             mp)
        lo["3d"] = occupancy.insert_depth(lo["3d"], depth, pos, quat, cam, mp)
        lo["dense"] = fusion.insert_depth_2d_dense(lo["dense"], depth, pos,
                                                   quat, cam, mp)
        jlo["2d"] = j2d(jlo["2d"], *args)
        jlo["3d"] = j3d(jlo["3d"], *args)
        out.append(({k: v.numpy() for k, v in lo.items()},
                    {k: np.asarray(v) for k, v in jlo.items()}))
    return out


def test_depth_to_points_matches():
    jcam = JCameraParams(**CAM)
    depth, pos, quat = _flight()[3]
    pts, hit = raycast.depth_to_points(depth, pos, quat, CameraParams(**CAM))
    for e in range(B):
        jp, jh = jraycast.depth_to_points(
            jnp.asarray(depth[e].numpy()), jnp.asarray(pos[e].numpy()),
            jnp.asarray(quat[e].numpy()), jcam)
        np.testing.assert_allclose(pts[e].numpy(), np.asarray(jp), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(hit[e].numpy(), np.asarray(jh))
    assert 0 < int(hit.sum()) < hit.numel()


@pytest.mark.parametrize("kind", ["2d", "3d"])
@pytest.mark.parametrize("frame", [0, 2, 4])
def test_scatter_fusion_matches(flown, kind, frame):
    got, want = flown[frame][0][kind], flown[frame][1][kind]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    thr = occupancy.occ_threshold(MapParams(**MAPP))
    away = np.abs(want - thr) > 1e-4
    np.testing.assert_array_equal((got > thr)[away], (want > thr)[away])
    assert int((want < 0).sum()) > 500 and int((want > thr).sum()) > 10


def test_to_occupancy_matches(flown):
    got = flown[-1][0]["2d"]
    want = np.asarray(joccupancy.to_occupancy(jnp.asarray(got),
                                              JMapParams(**MAPP)))
    np.testing.assert_array_equal(
        occupancy.to_occupancy(torch.from_numpy(got),
                               MapParams(**MAPP)).numpy(), want)


def _iou(a, b):
    return (a * b).sum() / max(((a + b) > 0).sum(), 1)


def test_fusion_map_agreement(flown):
    """The golden test's bounds on the port's own three fusions."""
    lo = flown[-1][0]
    thr = occupancy.occ_threshold(MapParams(**MAPP))
    occ = {k: (v > thr).astype(np.float32) for k, v in lo.items()}
    assert _iou(occ["dense"], occ["2d"]) > 0.6
    assert _iou(occ["2d"], occ["3d"]) > 0.4
    assert (occ["2d"] * occ["3d"]).sum() / occ["2d"].sum() > 0.8
    free_2d, free_dense = lo["2d"] < -1e-3, lo["dense"] < -1e-3
    assert (free_2d & free_dense).sum() / max(free_2d.sum(), 1) > 0.9
    assert free_dense.sum() >= free_2d.sum()
