"""The port's octomap .bt / PCL .pcd codec (io/octomap.py) against the JAX
package's.

The port builds its own copy of the codec source into
neoplanner_tpu_torch/_build/. The JAX wrappers are run here over that same
library (the JAX module's ``_lib`` monkeypatched), so that no test of the
port runs the JAX package's make into neoplanner_tpu/io/octomap_cc/.

Tolerances: none. The decoded leaves, voxels, grids and points equal
JAX's; the roundtrips are those of tests/test_octomap_io.py (the .pcd
points within its 1e-5); the ESDF built from a generated .bt's occupancy
slice equals JAX's esdf.build cell for cell (the mirror of
test_bt_grid_load_into_planner_map without the reference's poles.bt).
"""

import hashlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.io import octomap as joctomap
from neoplanner_tpu.mapping import esdf as jesdf
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import MapParams, WorldParams
from neoplanner_tpu_torch.io import octomap
from neoplanner_tpu_torch.mapping import esdf
from neoplanner_tpu_torch.world import scenegen, voxelize
from tests.test_torch_imports import one_torch_thread  # noqa: F401


@pytest.fixture
def jax_codec(monkeypatch):
    """The JAX wrappers over the port's library."""
    monkeypatch.setattr(joctomap, "_lib", octomap._load())
    return joctomap


def test_codec_source_is_the_jax_copy():
    mine = octomap._SRC.read_bytes()
    with open(joctomap._CC_DIR + "/octomap_codec.cc", "rb") as f:
        assert hashlib.sha256(mine).digest() == \
            hashlib.sha256(f.read()).digest()
    assert octomap.library_path().parent.name == "_build"
    assert octomap.library_path().parent.parent.name == "neoplanner_tpu_torch"


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(octomap, "_SRC", bad)
    monkeypatch.setattr(octomap, "_BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        octomap.build()
    assert not list((tmp_path / "build").iterdir())


def _grid(seed, shape=(12, 20, 24), p=0.2):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < p).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_bt_matches_jax(tmp_path, jax_codec, seed):
    grid = _grid(seed)
    origin = (-1.2, -1.0, 0.0)
    mine, theirs = str(tmp_path / "port.bt"), str(tmp_path / "jax.bt")
    octomap.write_bt(mine, grid, 0.1, origin)
    jax_codec.write_bt(theirs, grid, 0.1, origin)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for got, want in zip(octomap.read_bt(mine), jax_codec.read_bt(mine)):
        np.testing.assert_array_equal(got, want)
    vox, res = octomap.bt_to_voxels(mine)
    jvox, jres = jax_codec.bt_to_voxels(mine)
    np.testing.assert_array_equal(vox, jvox)
    assert res == jres == pytest.approx(0.1)
    # the roundtrip (tests/test_octomap_io.py::test_bt_roundtrip)
    back, res = octomap.bt_to_grid(mine, origin, grid.shape)
    np.testing.assert_array_equal(back, grid)
    # res_override and a shifted, smaller window
    for shape, org, override in (((6, 10, 12), (-1.0, -0.9, 0.2), None),
                                 ((12, 20, 24), origin, 0.2)):
        got, gres = octomap.bt_to_grid(mine, org, shape, res_override=override)
        want, wres = jax_codec.bt_to_grid(mine, org, shape,
                                          res_override=override)
        np.testing.assert_array_equal(got, want)
        assert gres == wres
    got, _ = octomap.bt_to_grid(mine, origin, grid.shape, res_override=0.2)
    assert 0 < got.sum() < grid.sum()


def test_pcd_matches_jax(tmp_path, jax_codec):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    for ascii_mode in (True, False):
        mine = str(tmp_path / f"port_{ascii_mode}.pcd")
        theirs = str(tmp_path / f"jax_{ascii_mode}.pcd")
        octomap.write_pcd(mine, pts, ascii_mode=ascii_mode)
        jax_codec.write_pcd(theirs, pts, ascii_mode=ascii_mode)
        with open(mine, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()
        back = octomap.read_pcd(mine)
        np.testing.assert_array_equal(back, jax_codec.read_pcd(mine))
        np.testing.assert_allclose(back, pts, atol=1e-5)
        if not ascii_mode:
            np.testing.assert_array_equal(back, pts)


def test_read_errors(tmp_path):
    missing = str(tmp_path / "missing")
    with pytest.raises(IOError, match="failed to read octomap"):
        octomap.read_bt(missing + ".bt")
    with pytest.raises(IOError, match="failed to read .pcd"):
        octomap.read_pcd(missing + ".pcd")


def test_generated_bt_into_exact_esdf(tmp_path, jax_codec):
    """A world voxelized (occupancy_3d), written as .bt, read back, its
    z in [1.8, 10] slice projected as tests/test_octomap_io.py:46-62 does,
    and built into the exact full-profile ESDF: equal to JAX esdf.build on
    the same slice, and to the JAX decoder's voxels."""
    mp = MapParams(width=96, height=64, origin_x=-1.0, origin_y=-3.2)
    wp = WorldParams(num_boxes=8, max_boxes=8, pose_x_min=0.0,
                     pose_x_max=8.0, pose_y_min=-3.0, pose_y_max=3.0,
                     x_clearance=0.5, y_clearance=0.5)
    world = scenegen.generate(_cuda.make_generator(6, "cpu"), wp)
    world = world.replace(shape=torch.arange(8, dtype=torch.int32) % 2)
    nz = 60
    vol = voxelize.fill_unknown_3d(voxelize.occupancy_3d(world, mp, nz))
    path = str(tmp_path / "world.bt")
    origin3 = (mp.origin_x, mp.origin_y, 0.0)
    octomap.write_bt(path, vol.numpy(), mp.resolution, origin3)
    back, _ = octomap.bt_to_grid(path, origin3, tuple(vol.shape))
    np.testing.assert_array_equal(back, vol.numpy())

    vox, res = octomap.bt_to_voxels(path)
    np.testing.assert_array_equal(vox, jax_codec.bt_to_voxels(path)[0])
    sel = (vox[:, 2] >= 1.8) & (vox[:, 2] <= 10.0)
    xy = vox[sel][:, :2]
    occ = np.zeros((mp.height, mp.width), np.float32)
    cols = ((xy[:, 0] - mp.origin_x) / res).astype(int)
    rows = ((xy[:, 1] - mp.origin_y) / res).astype(int)
    ok = (rows >= 0) & (rows < mp.height) & (cols >= 0) & (cols < mp.width)
    occ[rows[ok], cols[ok]] = 1.0
    assert occ.sum() > 100
    # the slice's projection against the 2-D rasterizer: boundary cells
    # only (voxel centres against the slice's interval overlap)
    occ2 = voxelize.occupancy_2d(world.replace(**{
        f: getattr(world, f)[None] for f in ("centers", "half_sizes",
                                             "active", "shape")}), mp)[0]
    assert (occ != occ2.numpy()).mean() < 0.02

    port = esdf.build(torch.from_numpy(occ)[None], (mp.origin_x,
                                                    mp.origin_y), res)
    want = jesdf.build(jnp.asarray(occ), jnp.array([mp.origin_x,
                                                    mp.origin_y]), res)
    for f in ("esdf", "occupancy", "grad_x", "grad_y"):
        np.testing.assert_array_equal(getattr(port, f)[0].numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert float(port.esdf.min()) == 0.0 and float(port.esdf.max()) > 1.0
