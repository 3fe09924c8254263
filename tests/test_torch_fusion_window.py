"""The windowed dense fusion of the PyTorch port (mapping/fusion.py's v1
branch: kernel B8 v1's plain version with the hit scatter), the window
rules, and the env's choice of fusion, against the JAX package.

The reference is occupancy_pallas.insert_depth_2d_dense in interpret mode
on maps that the v2 kernel does not take, where it runs its v1 kernel on a
(ch, cw) window around each camera. Two cases: the reference's default
448 x 256 map (448 % 128 != 0) with a 4 m camera (a 114 x 114 window that
follows the drone; poses near the map's edges clamp it there), and a
120 x 96 map with the default 6 m camera (the window is the whole map).
3 frames fused in sequence per env, 3 envs. Tolerance, as the other dense
fusion tests: cells equal, or off by exactly one l_miss or l_hit quantum
(a cell centre on a carve radius, or a hit on a cell edge, can fall either
way under the renderer's and the polar reduction's roundoff) on at most
1e-3 of the updated cells.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import CameraParams as JCameraParams
from neoplanner_tpu.config import MapParams as JMapParams
from neoplanner_tpu.config import WorldParams as JWorldParams
from neoplanner_tpu.mapping import occupancy_pallas
from neoplanner_tpu.world import scenegen as jscenegen
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, PlannerParams)
from neoplanner_tpu_torch.core import frames
from neoplanner_tpu_torch.core.types import BoxWorld
from neoplanner_tpu_torch.mapping import fusion, occupancy
from neoplanner_tpu_torch.sense import raycast
from neoplanner_tpu_torch.sim import env
from tests.test_torch_imports import one_torch_thread  # noqa: F401

CASES = {
    "default map, 4 m camera": (dict(fusion="2d_dense"),
                                dict(width=160, height=120, max_range=4.0)),
    "120 x 96 map, 6 m camera": (dict(width=120, height=96, origin_x=-2.0,
                                      origin_y=-4.8, fusion="2d_dense"),
                                 dict(width=160, height=120)),
}
B, FRAMES = 3, 3


def _t(a):
    return torch.from_numpy(np.array(a))


def _world(shift):
    jw = jscenegen.generate_batch(jax.random.PRNGKey(8), B,
                                  JWorldParams(num_boxes=12))
    return BoxWorld(centers=_t(jw.centers) - torch.tensor(shift),
                    half_sizes=_t(jw.half_sizes), active=_t(jw.active),
                    shape=_t(jw.shape))


def _frames(case):
    """Worlds and FRAMES (depth, pos, quat) per env. On the default map the
    third env flies by the map's corner (x near -8, y near -12.8), so its
    window clamps there."""
    mapp, cam = MapParams(**CASES[case][0]), CameraParams(**CASES[case][1])
    small = mapp.width < 200
    world = _world([3.0, 0.0, 0.0] if small else [0.0, 0.0, 0.0])
    rng = np.random.default_rng(12)
    out = []
    for f in range(FRAMES):
        if small:
            x = rng.uniform(0.0, 3.0, B)
            y = rng.uniform(-1.0, 1.0, B)
        else:
            x = np.array([1.0 + 2.0 * f, 15.0 + 2.0 * f, -7.0 + 0.5 * f])
            y = np.array([0.5, 3.0 - f, -11.5 - 0.4 * f])
        pos = torch.from_numpy(np.stack([x, y, rng.uniform(1.9, 2.3, B)],
                                        -1).astype(np.float32))
        acc = torch.from_numpy(rng.normal(scale=1.5, size=(B, 3)).astype(
            np.float32))
        yaw = torch.from_numpy(rng.uniform(-0.8, 0.8, B).astype(np.float32))
        quat = frames.quat_from_accel_yaw(acc, yaw)
        out.append((raycast.render_depth(world, pos, quat, cam), pos, quat))
    return out


@pytest.fixture(scope="module", params=sorted(CASES))
def fused(request):
    case = request.param
    mapp, cam = MapParams(**CASES[case][0]), CameraParams(**CASES[case][1])
    jmp, jcam = JMapParams(**CASES[case][0]), JCameraParams(**CASES[case][1])
    jfuse = jax.jit(jax.vmap(lambda lo, d, p, q: (
        occupancy_pallas.insert_depth_2d_dense(lo, d, p, q, jcam, jmp,
                                               interpret=True))))
    lo_t = occupancy.logodds_init(mapp, B)
    lo_j = jnp.zeros((B, mapp.height, mapp.width))
    out = []
    for depth, pos, quat in _frames(case):
        lo_t = fusion.insert_depth_2d_dense(lo_t, depth, pos, quat, cam, mapp)
        lo_j = jfuse(lo_j, jnp.asarray(depth.numpy()),
                     jnp.asarray(pos.numpy()), jnp.asarray(quat.numpy()))
        out.append((lo_t.numpy(), np.asarray(lo_j)))
    return case, out


def test_window_rules_match():
    for mapp_kw, cam_kw in list(CASES.values()) + [
            (dict(fusion="2d_dense"), dict(width=160, height=120)),
            (dict(width=200, height=100), dict()),
            (dict(width=256, height=192), dict())]:
        mapp, cam = MapParams(**mapp_kw), CameraParams(**cam_kw)
        jmp, jcam = JMapParams(**mapp_kw), JCameraParams(**cam_kw)
        assert fusion._reach_cells(cam, mapp) == \
            occupancy_pallas._reach_cells(jcam, jmp)
        assert fusion._window_cells(cam, mapp) == \
            occupancy_pallas._window_cells(jcam, jmp)
        assert fusion.window_fits(cam, mapp) == \
            occupancy_pallas.window_fits(jcam, jmp)
    assert fusion._window_cells(CameraParams(**CASES[
        "default map, 4 m camera"][1]), MapParams()) == (114, 114)


def test_default_camera_on_default_map_raises():
    mapp = MapParams(fusion="2d_dense")
    depth, pos, quat = _frames("default map, 4 m camera")[0]
    with pytest.raises(ValueError, match=r"dense fusion window \(128-cell "
                       r"cap\) does not cover cam.max_range=6.0"):
        fusion.insert_depth_2d_dense(occupancy.logodds_init(mapp, B), depth,
                                     pos, quat, CameraParams(), mapp)


@pytest.mark.parametrize("frame", range(FRAMES))
def test_window_fusion_matches_v1_kernel(fused, frame):
    case, out = fused
    got, want = out[frame]
    mp = MapParams(**CASES[case][0])
    quanta = np.float32([occupancy._l(mp.prob_miss),
                         occupancy._l(mp.prob_hit)])
    diff = got - want
    off = diff != 0.0
    assert np.isclose(np.abs(diff[off])[:, None], np.abs(quanta)[None],
                      rtol=1e-5).any(1).all()
    updated = int((want != 0.0).sum())
    assert updated > 1000
    assert int(off.sum()) <= 1e-3 * updated
    assert int((want > occupancy.occ_threshold(mp)).sum()) > 10


def test_window_clamps_at_the_map_edge():
    """On the default map, the corner env's window sits at the map's
    corner, and nothing outside it was touched but hit cells."""
    case = "default map, 4 m camera"
    mapp, cam = MapParams(**CASES[case][0]), CameraParams(**CASES[case][1])
    depth, pos, quat = _frames(case)[0]
    _, sc, _ = fusion._inputs(depth, pos, quat, cam, mapp)
    _, org = fusion._window_inputs(sc, pos, cam, mapp)
    assert org[2].tolist() == [0, 0] and org[0].tolist() != [0, 0]
    got = fusion.insert_depth_2d_dense(occupancy.logodds_init(mapp, B), depth,
                                       pos, quat, cam, mapp)
    assert int((got[2, :114, :114] < 0).sum()) > 1000
    assert int((got[2, 114:, :] < 0).sum()) == 0
    assert int((got[2, :, 114:] < 0).sum()) == 0


def test_cpu_tensor_takes_plain_version():
    mapp = MapParams(**CASES["default map, 4 m camera"][0])
    cam = CameraParams(**CASES["default map, 4 m camera"][1])
    depth, pos, quat = _frames("default map, 4 m camera")[0]
    before = dict(_cuda.launches)
    fusion.insert_depth_2d_dense(occupancy.logodds_init(mapp, B), depth, pos,
                                 quat, cam, mapp)
    assert _cuda.launches == before


def test_fuse_frame_takes_the_scatter_fusion_when_the_window_overflows():
    """fuse_frame on a 2d_dense map whose window does not cover the
    camera's reach runs the '2d' scatter fusion, as the reference's
    fuse_frame chooses by configuration; where it fits, the dense one."""
    gen = _cuda.make_generator(0, "cpu")
    world = _world([0.0, 0.0, 0.0])
    depth, pos, quat = _frames("default map, 4 m camera")[1]
    for cam_kw, dense in ((dict(width=160, height=120), False),
                          (CASES["default map, 4 m camera"][1], True)):
        mapp = MapParams(fusion="2d_dense")
        cam = CameraParams(**cam_kw)
        st = env.reset(world, PlannerParams(), MissionParams(), mapp, gen,
                       goal=torch.zeros(B, 2), sensing="depth",
                       plan_map="grid")
        st = st.replace(drone=st.drone.replace(pos=pos, quat=quat))
        got = env.fuse_frame(st, cam, depth).logodds
        want = (fusion.insert_depth_2d_dense if dense
                else occupancy.insert_depth_2d)(
            occupancy.logodds_init(mapp, B), depth, pos, quat, cam, mapp)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        assert int((got != 0).sum()) > 1000
