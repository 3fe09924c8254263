"""The truncated field of the PyTorch port is the exact one clamped.

With R = radius_cells(max_dist, res), the port's ``ops/edt._truncated_plain``
(the plain version of kernels B9 banded and B9 fused: g2 clamped at
(R+1)^2, the min-plus over a band of +-R rows, clamped at R^2) equals the
JAX package's exact squared transform clamped at R^2, then rooted, scaled
and clamped at max_dist. The CUDA kernels B9 banded and B9 fused run the
exact column pass and clamp it (csrc/edt.cuh), so this identity is what
lets them.

The exact reference is neoplanner_tpu/ops/edt_pallas.pass2 in interpret
mode (the TPU kernel of ``edt_sq_cells``) over ``_row_distance_sq``; its
rows are padded with 1e9 to a multiple of 8, which changes no real row (a
padded candidate is >= 1e9, and a column of 1e9 rows ends at exactly 1e9).
The grids: those of tests/test_edt.py (as tests/test_torch_edt_exact.py
builds them) and seeded random ones, sparse, dense, empty and full, at
R in {1, 7, 20, 33}. Tolerance: bit-exact (integers exact in f32, one
correctly rounded sqrt, one multiply, one min).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neoplanner_tpu.ops import edt as jedt
from neoplanner_tpu.ops import edt_pallas
from neoplanner_tpu_torch.ops import edt
from tests.test_torch_edt_exact import GRIDS
from tests.test_torch_imports import one_torch_thread  # noqa: F401


def _random_grids():
    rng = np.random.default_rng(12)
    out = {}
    for H, W in ((64, 96), (37, 53)):
        for name, d in (("sparse", 0.01), ("dense", 0.5)):
            out[f"{name} {H}x{W}"] = (rng.random((H, W)) < d).astype(
                np.float32)
    out["empty 64x96"] = np.zeros((64, 96), np.float32)
    out["full 37x53"] = np.ones((37, 53), np.float32)
    return out


ALL = {**GRIDS, **_random_grids()}
# (max_dist, res) -> R in {1, 7, 20, 33}
RADII = {1: (0.1, 0.1), 7: (0.7, 0.1), 20: (2.0, 0.1), 33: (8.25, 0.25)}


@functools.lru_cache(maxsize=None)
def _exact_d2(name):
    occ = ALL[name]
    g2 = np.array(jedt._row_distance_sq(jnp.asarray(occ) > 0.5))
    H = g2.shape[0]
    pad = np.full(((-H) % 8, g2.shape[1]), 1e9, np.float32)
    d2 = edt_pallas.pass2(jnp.asarray(np.concatenate([g2, pad])),
                          interpret=True)
    return np.asarray(d2)[:H]


@pytest.mark.parametrize("R", sorted(RADII))
@pytest.mark.parametrize("name", sorted(ALL))
def test_truncated_is_exact_clamped(name, R):
    max_dist, res = RADII[R]
    assert edt.radius_cells(max_dist, res) == R
    clamped = np.minimum(_exact_d2(name), np.float32(R * R))
    want = np.minimum(
        np.sqrt(clamped.astype(np.float64)).astype(np.float32)
        * np.float32(res), np.float32(max_dist))
    got = edt._truncated_plain(torch.from_numpy(ALL[name]) > 0.5, res,
                               max_dist).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
