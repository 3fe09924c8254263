"""The truncated ESDF rebuild of the PyTorch port (ops/edt.py, kernel B9's
plain version, and mapping/esdf.build) against the JAX package.

The JAX reference is the XLA pass chain that tests/test_edt.py holds against
the fused TPU kernel: occupancy.to_occupancy, then esdf.build(...,
max_dist, lite=True) (edt_truncated, then bf16). Tolerance: bit-exact. Every
step is integer arithmetic held exactly in f32, followed by one correctly
rounded sqrt, one multiply and a round-to-nearest-even bf16 cast, so the two
frameworks must agree to the last bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import MapParams as JMapParams
from neoplanner_tpu.mapping import esdf as jesdf
from neoplanner_tpu.mapping import occupancy as joccupancy
from neoplanner_tpu.ops import edt as jedt
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import MapParams
from neoplanner_tpu_torch.mapping import esdf, occupancy
from neoplanner_tpu_torch.ops import edt
from tests.test_torch_imports import one_torch_thread  # noqa: F401


def _logodds(shape, seed, sparse=False):
    rng = np.random.default_rng(seed)
    if sparse:
        return ((rng.uniform(0, 1, size=shape) < 0.01) * 3.0
                - 1.0).astype(np.float32)
    return rng.uniform(-2.0, 2.0, size=shape).astype(np.float32)


def _jax_field(lo, max_dist):
    mp = JMapParams()
    occ = joccupancy.to_occupancy(jnp.asarray(lo), mp)
    emap = jesdf.build(occ, jnp.array([mp.origin_x, mp.origin_y]),
                       mp.resolution, max_dist=max_dist, lite=True)
    return np.asarray(emap.esdf.astype(jnp.float32))


@pytest.mark.parametrize("h, w, max_dist, sparse", [
    (48, 128, 2.0, False), (192, 256, 2.0, False), (64, 128, 0.7, False),
    (192, 256, 2.0, True)])
def test_rebuild_matches_xla_chain(h, w, max_dist, sparse):
    mp = MapParams()
    lo = _logodds((3, h, w), seed=h + w, sparse=sparse)
    got = edt.rebuild_truncated_lite(torch.from_numpy(lo),
                                     occupancy.occ_threshold(mp),
                                     mp.resolution, max_dist)
    assert got.dtype == torch.bfloat16 and got.shape == (3, h, w)
    for e in range(3):
        np.testing.assert_array_equal(got[e].float().numpy(),
                                      _jax_field(lo[e], max_dist))


def test_edt_truncated_matches_f32():
    """The f32 field before the bf16 store, and the row pass."""
    lo = _logodds((64, 128), seed=3, sparse=True)
    occ = lo > 0.0
    np.testing.assert_array_equal(
        edt._row_distance_sq(torch.from_numpy(occ)).numpy(),
        np.asarray(jedt._row_distance_sq(jnp.asarray(occ))))
    np.testing.assert_array_equal(
        edt.edt_truncated(torch.from_numpy(occ), 0.1, 2.0).numpy(),
        np.asarray(jedt.edt_truncated(jnp.asarray(occ).astype(jnp.float32),
                                      0.1, 2.0)))


def test_build_at_reset_is_uniform_truncation():
    """esdf.build of an empty grid (the vision loop's reset): max_dist
    everywhere, as the JAX reset's lite map."""
    mp = MapParams(width=256, height=192, origin_x=-4.0, origin_y=-9.6)
    emap = esdf.build(torch.zeros((2, 192, 256)), (mp.origin_x, mp.origin_y),
                      mp.resolution, 2.0, lite=True)
    want = _jax_field(np.zeros((192, 256), np.float32), 2.0)
    np.testing.assert_array_equal(emap.esdf[1].float().numpy(), want)
    assert float(want.min()) == 2.0
    np.testing.assert_array_equal(emap.origin.numpy(),
                                  np.float32([-4.0, -9.6]))


def test_cpu_tensor_takes_plain_version():
    before = _cuda.launches["edt_trunc_lite"]
    edt.rebuild_truncated_lite(torch.zeros((1, 16, 32)), 0.5, 0.1, 0.5)
    assert _cuda.launches["edt_trunc_lite"] == before
