"""The exact and the full-profile truncated EDT of the PyTorch port
(ops/edt.py: the plain versions of kernels B9 exact and B9 banded, and
central_gradient) against the JAX package.

The references: ops/edt._pass2 (the XLA min-plus) and the TPU kernels in
interpret mode, edt_pallas.pass2 and edt_pallas.pass2_banded (which pad the
rows outside the map with 1e9 and clamp g2 at R^2 before the band); then
ops/edt.edt and ops/edt.edt_truncated, and ops/edt.central_gradient. The
grids are those of tests/test_edt.py: random grids at three densities, one
obstacle, a full grid, an empty grid (FAR throughout) and one whose H is
not a multiple of 8. Tolerance: bit-exact, for every field. Both sides
compute integers held exactly in f32 (1e9 + d^2 rounds in f32, but a
column with an occupied row never selects such a candidate, and a column of
1e9 rows ends at exactly 1e9), then one correctly rounded sqrt and one
multiply; the gradient is the same f32 differences and one true division.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.ops import edt as jedt
from neoplanner_tpu.ops import edt_pallas
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.ops import edt
from tests.test_torch_imports import one_torch_thread  # noqa: F401


def _grids():
    rng = np.random.default_rng(11)
    out = {f"random {d}": (rng.random((48, 64)) < d).astype(np.float32)
           for d in (0.02, 0.2, 0.7)}
    one = np.zeros((40, 40), np.float32)
    one[10, 25] = 1.0
    out["one obstacle"] = one
    out["full"] = np.ones((16, 24), np.float32)
    out["empty"] = np.zeros((16, 24), np.float32)
    out["H 37"] = (rng.random((37, 53)) < 0.1).astype(np.float32)
    return out


GRIDS = _grids()


def _g2(occ):
    return np.array(jedt._row_distance_sq(jnp.asarray(occ) > 0.5))


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_pass2_matches_xla_and_tpu_kernel(name):
    occ = GRIDS[name]
    g2 = _g2(occ)
    got = edt._pass2(torch.from_numpy(g2)[None])[0].numpy()
    np.testing.assert_array_equal(got, np.asarray(jedt._pass2(
        jnp.asarray(g2))))
    if occ.shape[0] % 8 == 0:
        np.testing.assert_array_equal(got, np.asarray(edt_pallas.pass2(
            jnp.asarray(g2), interpret=True)))
    np.testing.assert_array_equal(
        edt._edt_sq_cells(torch.from_numpy(occ)).numpy(),
        np.asarray(jedt.edt_sq_cells(jnp.asarray(occ))))


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_exact_field_matches(name):
    occ = GRIDS[name]
    batch = torch.from_numpy(np.stack([occ, occ[::-1].copy()]))
    got = edt.edt(batch, 0.1)
    assert got.dtype == torch.float32 and got.shape == batch.shape
    for e in range(2):
        np.testing.assert_array_equal(got[e].numpy(), np.asarray(
            jedt.edt(jnp.asarray(batch[e].numpy()), 0.1)))
    if name == "empty":
        assert bool((got == 1e4).all())


@pytest.mark.parametrize("name", ["random 0.02", "random 0.2", "one obstacle",
                                  "empty", "H 37"])
@pytest.mark.parametrize("max_dist", [0.7, 2.0])
def test_banded_matches_tpu_kernel_and_xla(name, max_dist):
    occ = GRIDS[name]
    radius = edt.radius_cells(max_dist, 0.1)
    g2 = np.minimum(_g2(occ), np.float32((radius + 1) ** 2))
    got = edt._pass2_banded(torch.from_numpy(g2), radius).numpy()
    if occ.shape[0] % 8 == 0:
        np.testing.assert_array_equal(got, np.asarray(edt_pallas.pass2_banded(
            jnp.asarray(g2), radius, interpret=True)))
    field = edt.edt_truncated(torch.from_numpy(occ)[None], 0.1, max_dist)
    assert field.dtype == torch.float32
    np.testing.assert_array_equal(field[0].numpy(), np.asarray(
        jedt.edt_truncated(jnp.asarray(occ), 0.1, max_dist)))


@pytest.mark.parametrize("name", ["random 0.02", "one obstacle", "H 37"])
def test_central_gradient_matches(name):
    field = np.array(jedt.edt(jnp.asarray(GRIDS[name]), 0.1))
    gy, gx = edt.central_gradient(torch.from_numpy(field)[None], 0.1)
    jgy, jgx = jedt.central_gradient(jnp.asarray(field), 0.1)
    np.testing.assert_array_equal(gy[0].numpy(), np.asarray(jgy))
    np.testing.assert_array_equal(gx[0].numpy(), np.asarray(jgx))


def test_cpu_tensor_takes_plain_version():
    before = dict(_cuda.launches)
    occ = torch.from_numpy(GRIDS["random 0.2"])[None]
    edt.edt(occ, 0.1)
    edt.edt_truncated(occ, 0.1, 2.0)
    assert _cuda.launches == before
