"""The port's .world files (world/worldio.py) against the JAX package's.

Tolerances: none. write_world writes the same bytes as JAX's for the same
arrays; parse_world returns JAX's arrays exactly (float32 centers and half
sizes, bool active, int32 shape), active primitives first, with the same
capacity rule (max_boxes=None: the count rounded up to 8) and the same
error past max_boxes. The roundtrip mirrors
tests/test_world.py::test_world_roundtrip on the port's own worlds (its
random worlds draw differently from JAX's threefry stream).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import WorldParams as JWorldParams
from neoplanner_tpu.core.types import BoxWorld as JBoxWorld
from neoplanner_tpu.world import scenegen as jscenegen
from neoplanner_tpu.world import worldio as jworldio
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import WorldParams
from neoplanner_tpu_torch.core.types import SHAPE_CYLINDER, BoxWorld
from neoplanner_tpu_torch.world import scenegen, worldio
from tests.test_torch_imports import one_torch_thread  # noqa: F401

FIELDS = ("centers", "half_sizes", "active", "shape")

# boxes, cylinders, pine-tree meshes, a ground plane, a model with no
# <state> pose, a model without geometry, and a state entry for a model
# that does not exist
HAND_WORLD = """<?xml version="1.0"?>
<sdf version="1.6">
  <world name="default">
    <model name="ground_plane"><link name="link"><collision name="c">
      <geometry><plane><size>100 100</size></plane></geometry>
    </collision></link></model>
    <model name="box_a"><link name="link"><collision name="c">
      <geometry><box><size>1.0 0.5 3.25</size></box></geometry>
    </collision></link></model>
    <model name="pole"><link name="link"><collision name="c">
      <geometry><cylinder><radius>0.3</radius><length>7.5</length></cylinder>
      </geometry></collision></link></model>
    <model name="tree_1"><link name="link"><visual name="v">
      <geometry><mesh><uri>model://pine_tree/meshes/pine.dae</uri></mesh>
      </geometry></visual></link></model>
    <model name="box_unplaced"><link name="link"><collision name="c">
      <geometry><box><size>2 2 2</size></box></geometry>
    </collision></link></model>
    <model name="empty"><link name="link"/></model>
    <model name="tree_2"><link name="link"><visual name="v">
      <geometry><mesh><uri>model://pine_tree</uri></mesh></geometry>
    </visual></link></model>
    <model name="box_b"><link name="link"><collision name="c">
      <geometry><box><size>0.7 1.3 4.0 0.0 0.0 0.0</size></box></geometry>
    </collision></link></model>
    <state world_name="default">
      <model name="ground_plane"><pose>0 0 0 0 0 0</pose></model>
      <model name="box_a"><pose>4.25 -1.5 1.625 0 0 0.01</pose></model>
      <model name="pole"><pose>7.1 2.2 3.75 0 0 0</pose></model>
      <model name="tree_1"><pose>12.5 -3.3 0 0 0 0</pose></model>
      <model name="ghost"><pose>1 1 1 0 0 0</pose></model>
      <model name="empty"><pose>2 2 2 0 0 0</pose></model>
      <model name="tree_2"><pose>15.0 4.125 0.5 0 0 0</pose></model>
      <model name="box_b"><pose>20.1 0.4 2.0 0 0 0</pose></model>
    </state>
  </world>
</sdf>
"""


def _np(world):
    return {f: np.asarray(getattr(world, f)) if not torch.is_tensor(
        getattr(world, f)) else getattr(world, f).numpy() for f in FIELDS}


def _assert_same(port, jax_world):
    got, want = _np(port), _np(jax_world)
    for f in FIELDS:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def _jax_world(world):
    return JBoxWorld(**{f: jnp.asarray(getattr(world, f).numpy())
                        for f in FIELDS})


def _worlds():
    """Port worlds of WorldParams() from seeds, every third primitive a
    cylinder, and a JAX world."""
    out = []
    for seed in range(3):
        w = scenegen.generate(_cuda.make_generator(seed, "cpu"),
                              WorldParams())
        shape = w.shape.clone()
        shape[seed::3] = SHAPE_CYLINDER
        out.append(w.replace(shape=shape))
    jw = jscenegen.generate(jax.random.PRNGKey(5), JWorldParams())
    out.append(BoxWorld(**{f: torch.from_numpy(np.array(getattr(jw, f)))
                           for f in FIELDS}))
    return out


@pytest.mark.parametrize("index", range(4))
def test_write_world_bytes_equal_jax(tmp_path, index):
    world = _worlds()[index]
    mine, theirs = tmp_path / "port.world", tmp_path / "jax.world"
    worldio.write_world(world, str(mine))
    jworldio.write_world(_jax_world(world), str(theirs))
    assert mine.read_bytes() == theirs.read_bytes()
    # and both packages parse the file into the same arrays
    _assert_same(worldio.parse_world(str(mine), max_boxes=24, device="cpu"),
                 jworldio.parse_world(str(theirs), max_boxes=24))


@pytest.mark.parametrize("max_boxes", [None, 7, 9, 64])
def test_parse_hand_world_equals_jax(tmp_path, max_boxes):
    path = tmp_path / "hand.world"
    path.write_text(HAND_WORLD)
    port = worldio.parse_world(str(path), max_boxes=max_boxes, device="cpu")
    want = jworldio.parse_world(str(path), max_boxes=max_boxes)
    _assert_same(port, want)
    # box_a, pole, two trees of two cylinders each, box_b; active first
    active = port.active.numpy()
    assert active.sum() == 7 and active[:7].all()
    assert port.active.shape[0] == (8 if max_boxes is None else max_boxes)
    assert (port.shape[:7].numpy() == [0, 1, 1, 1, 1, 1, 0]).all()


def test_parse_capacity_rounding_and_overflow(tmp_path):
    for n_boxes in (1, 7, 8, 9, 17):
        world = scenegen.generate(_cuda.make_generator(n_boxes, "cpu"),
                                  WorldParams(num_boxes=n_boxes,
                                              max_boxes=24,
                                              rejection_rounds=0))
        world = world.replace(active=torch.arange(24) < n_boxes)
        path = str(tmp_path / f"w{n_boxes}.world")
        worldio.write_world(world, path)
        port = worldio.parse_world(path, max_boxes=None, device="cpu")
        want = max((n_boxes + 7) // 8 * 8, 8)
        assert port.active.shape == (want,)
        _assert_same(port, jworldio.parse_world(path, max_boxes=None))
        if n_boxes > 1:
            with pytest.raises(ValueError, match="exceed max_boxes"):
                worldio.parse_world(path, max_boxes=n_boxes - 1,
                                    device="cpu")
            with pytest.raises(ValueError, match="exceed max_boxes"):
                jworldio.parse_world(path, max_boxes=n_boxes - 1)
    no_world = tmp_path / "no_world.sdf"
    no_world.write_text('<?xml version="1.0"?><sdf version="1.6"></sdf>')
    with pytest.raises(ValueError, match="no <world>"):
        worldio.parse_world(str(no_world), device="cpu")


def test_world_roundtrip(tmp_path):
    """The mirror of tests/test_world.py::test_world_roundtrip."""
    wp = WorldParams(num_boxes=6)
    world = scenegen.generate(_cuda.make_generator(4, "cpu"), wp)
    path = os.path.join(tmp_path, "test.world")
    worldio.write_world(world, path)
    back = worldio.parse_world(path, max_boxes=wp.max_boxes, device="cpu")
    a = world.active.numpy()
    got_c = back.centers.numpy()[back.active.numpy()]
    want_c = world.centers.numpy()[a]
    np.testing.assert_allclose(np.sort(got_c, axis=0),
                               np.sort(want_c, axis=0), atol=1e-4)
    got_h = back.half_sizes.numpy()[back.active.numpy()]
    np.testing.assert_allclose(np.sort(got_h, axis=0),
                               np.sort(world.half_sizes.numpy()[a], axis=0),
                               atol=1e-4)


@pytest.mark.parametrize("seed", [0, 44])
def test_forest_world_parses_equal_jax(tmp_path, seed):
    """forest_world_xml's 150 pine trees parse into 300 cylinders at
    capacity 304, the same arrays as JAX's parse of the same file; the
    corridor along y = 0 stays clear of every canopy."""
    path = tmp_path / "forest.world"
    path.write_text(worldio.forest_world_xml(seed))
    port = worldio.parse_world(str(path), max_boxes=None, device="cpu")
    _assert_same(port, jworldio.parse_world(str(path), max_boxes=None))
    assert port.active.shape == (304,) and int(port.active.sum()) == 300
    assert (port.shape[:300] == SHAPE_CYLINDER).all()
    edge = (port.centers[:300, 1].abs() - port.half_sizes[:300, 0])
    assert float(edge.min()) > 1.0


def test_parse_world_device_default_raises_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = tmp_path / "hand.world"
    path.write_text(HAND_WORLD)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worldio.parse_world(str(path))
