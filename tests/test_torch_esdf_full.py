"""The ground-truth grid and the full-profile ESDF of the PyTorch port
(world/voxelize.occupancy_2d, mapping/esdf.build with max_dist = 0 in both
profiles and with max_dist > 0, and the samplers and predicates on a full
map) against the JAX package.

Worlds: generated ones (boxes, from JAX's scenegen) and a hand-made one
with vertical cylinders, a box above the occupancy slice and an inactive
box. Tolerances: the grids, fields, occupancy and gradient planes
bit-exact (the same f32 comparisons and the same integer EDT; see
test_torch_edt_exact.py); an exact lite field equal to JAX's own bf16 cast
(9984 on an empty grid, bf16's FAR). Nearest-cell distances, gradients and
the straight-through value (d0 - lin) + lin bit-exact, and autograd's
derivative of the distance equal to the looked-up gradient; bilinear
values within 1e-5 m (the same interpolation, its sums taken in another
order); has_collision and is_occupied exactly (after tests/test_esdf.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import MapParams as JMapParams
from neoplanner_tpu.config import WorldParams as JWorldParams
from neoplanner_tpu.core.types import BoxWorld as JBoxWorld
from neoplanner_tpu.mapping import esdf as jesdf
from neoplanner_tpu.world import scenegen as jscenegen
from neoplanner_tpu.world import voxelize as jvoxelize
from neoplanner_tpu_torch.config import MapParams
from neoplanner_tpu_torch.core.types import BoxWorld
from neoplanner_tpu_torch.mapping import esdf
from neoplanner_tpu_torch.world import voxelize
from tests.test_torch_imports import one_torch_thread  # noqa: F401

MAPP = dict(width=120, height=96, origin_x=-2.0, origin_y=-4.8)
ORIGIN = (MAPP["origin_x"], MAPP["origin_y"])


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_world(jw):
    return BoxWorld(centers=_t(jw.centers), half_sizes=_t(jw.half_sizes),
                    active=_t(jw.active), shape=_t(jw.shape))


def _generated(n=3):
    return jscenegen.generate_batch(jax.random.PRNGKey(4), n,
                                    JWorldParams(num_boxes=10))


def _hand_made():
    """Two cylinders, a box, a box above the slice (z in [10.5, 11.5]) and
    an inactive box, in one env; shape 1 is a cylinder."""
    c = np.float32([[1.0, 0.5, 3.0], [3.3, -1.2, 2.0], [6.0, 2.0, 3.0],
                    [4.0, 0.0, 11.0], [2.0, 2.0, 3.0]])
    h = np.float32([[0.75, 0.75, 3.0], [0.4, 0.4, 1.0], [0.5, 1.2, 3.0],
                    [1.0, 1.0, 0.5], [0.6, 0.6, 3.0]])
    return JBoxWorld(centers=jnp.asarray(c)[None],
                     half_sizes=jnp.asarray(h)[None],
                     active=jnp.asarray([[True, True, True, True, False]]),
                     shape=jnp.asarray([[1, 1, 0, 0, 0]], jnp.int32))


def _jax_occ(jw):
    return np.array(jax.vmap(lambda w: jvoxelize.occupancy_2d(
        w, JMapParams(**MAPP)))(jw))


@pytest.mark.parametrize("which", ["generated", "hand-made"])
def test_occupancy_2d_matches(which):
    jw = _generated() if which == "generated" else _hand_made()
    got = voxelize.occupancy_2d(_port_world(jw), MapParams(**MAPP))
    want = _jax_occ(jw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 100
    if which == "hand-made":    # the cylinders are round, the box above
        occ = want[0]           # the slice and the inactive box absent
        assert occ[int((0.5 + 4.8) / 0.1), int((1.0 + 2.0) / 0.1)] == 1.0
        assert occ[int((1.2 + 4.8) / 0.1), int((1.7 + 2.0) / 0.1)] == 0.0
        assert occ[48, 60] == 0.0 and occ[68, 40] == 0.0


def test_occupancy_2d_chunks_envs(monkeypatch):
    """The env chunking of the footprint test does not change the grids."""
    jw = _generated(5)
    whole = voxelize.occupancy_2d(_port_world(jw), MapParams(**MAPP))
    monkeypatch.setattr(voxelize, "_CHUNK_ELEMS", 1)
    np.testing.assert_array_equal(
        voxelize.occupancy_2d(_port_world(jw), MapParams(**MAPP)).numpy(),
        whole.numpy())


def _maps(max_dist=0.0, lite=False, empty=False):
    occ = _jax_occ(_generated())
    if empty:
        occ = np.zeros_like(occ)
    port = esdf.build(torch.from_numpy(occ), ORIGIN, 0.1, max_dist=max_dist,
                      lite=lite)
    jmaps = jax.vmap(lambda o: jesdf.build(o, jnp.asarray(ORIGIN), 0.1,
                                           max_dist=max_dist, lite=lite))(
        jnp.asarray(occ))
    return port, jmaps


def _env(jmaps, e):
    return jax.tree_util.tree_map(lambda a: a[e], jmaps)


@pytest.mark.parametrize("max_dist", [0.0, 2.0])
def test_full_build_matches(max_dist):
    port, jmaps = _maps(max_dist)
    assert not port.lite and port.esdf.dtype == torch.float32
    for f in ("esdf", "occupancy", "grad_x", "grad_y"):
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(jmaps, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(port.origin.numpy(), np.float32(ORIGIN))
    sub = port.index(torch.tensor([2, 0, 0]))
    np.testing.assert_array_equal(sub.grad_y[0].numpy(),
                                  port.grad_y[2].numpy())


@pytest.mark.parametrize("empty", [False, True])
def test_lite_exact_build_matches(empty):
    port, jmaps = _maps(lite=True, empty=empty)
    assert port.lite and port.esdf.dtype == torch.bfloat16
    assert port.occupancy is None and port.grad_x is None
    want = np.asarray(jmaps.esdf.astype(jnp.float32))
    np.testing.assert_array_equal(port.esdf.float().numpy(), want)
    if empty:
        assert set(np.unique(want)) == {9984.0}


def _points(n=400, seed=5):
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-3.0, -6.0], [11.0, 5.5], size=(3, n, 2))
    return pts.astype(np.float32)       # some beyond the 12 x 9.6 m map


def test_sample_nearest_with_gradient():
    port, jmaps = _maps()
    pts = _points()
    p = torch.from_numpy(pts).requires_grad_(True)
    dis, grad = esdf.sample_nearest(port, p)
    assert dis.shape == (3, 400) and grad.shape == (3, 400, 2)
    (autograd,) = torch.autograd.grad(dis.sum(), p)
    np.testing.assert_array_equal(autograd.numpy(), grad.detach().numpy())
    for e in range(3):
        jd, jg = jesdf.sample_nearest(_env(jmaps, e), jnp.asarray(pts[e]))
        np.testing.assert_array_equal(dis[e].detach().numpy(),
                                      np.asarray(jd))
        np.testing.assert_array_equal(grad[e].numpy(), np.asarray(jg))
    out = (pts[..., 0] < -2.0) | (pts[..., 1] >= 4.8)
    assert out.any() and bool((dis.detach().numpy()[out] == 1e4).all())
    assert bool((grad.numpy()[out] == 0.0).all())
    assert float(np.abs(grad.numpy()).max()) > 0.5


def test_sample_nearest_on_lite_map_returns_distances():
    port, jmaps = _maps(max_dist=2.0, lite=True)
    pts = _points()
    dis = esdf.sample_nearest(port, torch.from_numpy(pts))
    assert isinstance(dis, torch.Tensor) and dis.shape == (3, 400)
    for e in range(3):
        jd, _ = jesdf.sample_nearest(_env(jmaps, e), jnp.asarray(pts[e]))
        np.testing.assert_array_equal(dis[e].numpy(), np.asarray(jd))


def test_bilinear_on_f32_field():
    port, jmaps = _maps()
    pts = _points(seed=6)
    dis = esdf.sample_bilinear(port, torch.from_numpy(pts))
    for e in range(3):
        jd, _ = jesdf.sample_bilinear(_env(jmaps, e), jnp.asarray(pts[e]))
        np.testing.assert_allclose(dis[e].numpy(), np.asarray(jd),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("lite", [False, True])
def test_collision_and_occupancy(lite):
    port, jmaps = _maps(lite=lite)
    pts = _points(seed=7)
    coll = esdf.has_collision(port, torch.from_numpy(pts), 0.5)
    occ = esdf.is_occupied(port, torch.from_numpy(pts))
    for e in range(3):
        jm = _env(jmaps, e)
        np.testing.assert_array_equal(coll[e].numpy(), np.asarray(
            jesdf.has_collision(jm, jnp.asarray(pts[e]), 0.5)))
        np.testing.assert_array_equal(occ[e].numpy(), np.asarray(
            jesdf.is_occupied(jm, jnp.asarray(pts[e]))))
    assert 0 < int(occ.sum()) < int(coll.sum())
