"""sense/raycast of the PyTorch port against neoplanner_tpu.sense.raycast.

The JAX renderer runs on the CPU in its XLA form (render_depth), which
tests/test_sense.py holds against the Pallas kernel. Same f32 formulas on
both sides: depths agree to 1e-4 m, except where a ray grazes a primitive's
edge and roundoff flips hit against miss — at most 0.1% of the pixels;
ray directions to 1e-6, at row strides 1 and 4. Several poses per env in
one call give each pose's own single-pose frame exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import CameraParams as JCameraParams
from neoplanner_tpu.config import WorldParams as JWorldParams
from neoplanner_tpu.core import frames as jframes
from neoplanner_tpu.core.types import BoxWorld as JBoxWorld
from neoplanner_tpu.sense import raycast as jraycast
from neoplanner_tpu.world import scenegen as jscenegen
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import CameraParams
from neoplanner_tpu_torch.core import frames
from neoplanner_tpu_torch.core.types import BoxWorld
from neoplanner_tpu_torch.sense import raycast
from tests.test_torch_imports import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _setup(n, seed=3):
    w = jscenegen.generate_batch(jax.random.PRNGKey(seed), n,
                                 JWorldParams(num_boxes=10))
    shape = np.zeros(w.shape.shape, np.int32)
    shape[:, 1::3] = 1                                  # some cylinders
    w = JBoxWorld(centers=w.centers, half_sizes=w.half_sizes,
                  active=w.active, shape=jnp.asarray(shape))
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(-1.0, 4.0, n), rng.uniform(-2.0, 2.0, n),
                    rng.uniform(1.0, 2.5, n)], -1).astype(np.float32)
    acc = rng.normal(scale=2.0, size=(n, 3)).astype(np.float32)
    yaw = rng.uniform(-0.6, 0.6, n).astype(np.float32)
    quat = np.asarray(jframes.quat_from_accel_yaw(jnp.asarray(acc),
                                                  jnp.asarray(yaw)))
    tw = BoxWorld(centers=_t(w.centers), half_sizes=_t(w.half_sizes),
                  active=_t(w.active), shape=_t(shape))
    return w, tw, pos, quat, acc, yaw


def _assert_depth_close(got, want):
    diff = np.abs(got - want)
    assert np.mean(diff > 1e-4) <= 1e-3, np.sort(diff.ravel())[-20:]


def test_ray_dirs_match():
    np.testing.assert_allclose(
        raycast.ray_dirs_camera(CameraParams()).numpy(),
        np.asarray(jraycast.ray_dirs_camera(JCameraParams())),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("row_stride", [1, 4])
def test_strided_ray_dirs_match(row_stride):
    got = raycast.ray_dirs_camera(CameraParams(), row_stride)
    want = np.asarray(jraycast.ray_dirs_camera(JCameraParams(), row_stride))
    assert got.shape == want.shape
    assert got.shape[0] == raycast.out_rows(CameraParams(), row_stride)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_render_depth_strided_matches():
    """A row stride of 4 (the sensor-rate fusion frames: 30 x 160)."""
    jw, tw, pos, quat, _, _ = _setup(3, 5)
    cam, jcam = CameraParams(), JCameraParams()
    got = raycast.render_depth_auto(tw, _t(pos), _t(quat), cam, row_stride=4)
    want = jax.vmap(lambda w, p, q: jraycast.render_depth(
        w, p, q, jcam, row_stride=4))(jw, jnp.asarray(pos), jnp.asarray(quat))
    assert got.shape == want.shape == (3, 30, cam.width)
    _assert_depth_close(got.numpy(), np.asarray(want))
    assert float((got < cam.max_range).float().mean()) > 0.05


def test_render_several_poses_per_env():
    """pos (B, F, 3): pose f of env b against env b's scene, as F
    single-pose calls."""
    _, tw, pos, quat, _, _ = _setup(2, 6)
    rng = np.random.default_rng(6)
    pos_f = _t(pos[:, None] + rng.uniform(-0.5, 0.5, (2, 3, 3)).astype(
        np.float32))
    quat_f = _t(quat)[:, None].expand(2, 3, 4).contiguous()
    cam = CameraParams()
    got = raycast.render_depth_auto(tw, pos_f, quat_f, cam, row_stride=4)
    assert got.shape == (2, 3, 30, cam.width)
    for f in range(3):
        want = raycast.render_depth(tw, pos_f[:, f], quat_f[:, f], cam,
                                    row_stride=4)
        np.testing.assert_array_equal(got[:, f].numpy(), want.numpy())


def test_quaternion_helpers_match():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(6, 4)).astype(np.float32)
    b = rng.normal(size=(6, 4)).astype(np.float32)
    v = rng.normal(size=(6, 3)).astype(np.float32)
    yaw = rng.uniform(-3.0, 3.0, 6).astype(np.float32)
    qa = np.asarray(jframes.quat_normalize(jnp.asarray(a)))
    pairs = [
        (frames.quat_multiply(_t(a), _t(b)), jframes.quat_multiply(a, b)),
        (frames.quat_normalize(_t(a)), qa),
        (frames.quat_rotate_inv(_t(qa), _t(v)),
         jframes.quat_rotate_inv(qa, v)),
        (frames.quat_to_matrix(_t(qa)), jframes.quat_to_matrix(qa)),
        (frames.quat_from_yaw(_t(yaw)), jframes.quat_from_yaw(yaw)),
        (frames.yaw_from_quat(_t(qa)), jframes.yaw_from_quat(qa)),
        (frames.quat_identity((2,)), jframes.quat_identity((2,))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def test_flatness_quaternion_matches():
    _, _, _, quat, acc, yaw = _setup(16)
    got = frames.quat_from_accel_yaw(_t(acc), _t(yaw))
    np.testing.assert_allclose(got.numpy(), quat, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [1, 4])
def test_render_depth_matches(seed):
    n = 3
    jw, tw, pos, quat, _, _ = _setup(n, seed)
    cam, jcam = CameraParams(), JCameraParams()
    got = raycast.render_depth_auto(tw, _t(pos), _t(quat), cam)
    want = jax.vmap(lambda w, p, q: jraycast.render_depth(
        w, p, q, jcam))(jw, jnp.asarray(pos), jnp.asarray(quat))
    assert got.shape == want.shape
    _assert_depth_close(got.numpy(), np.asarray(want))
    # the frames see something: obstacles or ground, not all max-range
    assert float((got < cam.max_range).float().mean()) > 0.05


def test_cpu_tensor_takes_plain_version():
    _, tw, pos, quat, _, _ = _setup(1)
    before = _cuda.launches["render_depth"]
    raycast.render_depth_auto(tw, _t(pos), _t(quat), CameraParams())
    assert _cuda.launches["render_depth"] == before
