"""Gazebo ``.world`` (SDF) files: read primitive scenes, write box scenes.

The port of neoplanner_tpu/world/worldio.py (``_find_geometry`` :40,
``parse_world`` :67, the templates :127-156, ``write_world`` :158). The
reference ships its obstacle courses as Gazebo SDF worlds (box sizes on the
``<world>``-level models, poses on the ``<state>``-level models of the same
name, generate_worlds.py:148-185); :func:`parse_world` reads one into a
:class:`BoxWorld` whose fields have no env axis ((K, 3), (K,)), as
``scenegen.generate`` returns one, and :func:`write_world` writes a world
back in the same schema, the same text as the JAX package's for the same
arrays.

Host XML and numpy: file I/O, no kernel. The parsed arrays are float32
(centers, half sizes), bool (active) and int32 (shape), active primitives
first, then moved to the caller's device.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np
import torch

from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.core.types import (SHAPE_BOX, SHAPE_CYLINDER,
                                             BoxWorld)

# A mesh obstacle (forest.world's model://pine_tree) becomes two stacked
# cylinders, a trunk and a canopy, with the dimensions of the standard OSRF
# pine_tree model (about 10 m tall, a 0.3 m trunk, a canopy a few meters
# wide): the occupancy slice z in [1.8, 10] (map_server_onboard.launch:30-32)
# then meets the canopy, not only the trunk.
_TREE_TRUNK_RADIUS = 0.35
_TREE_HEIGHT = 10.0
_TREE_CANOPY_RADIUS = 1.6     # effective footprint of the cone in the slice
_TREE_CANOPY_Z = (1.0, 9.0)   # canopy extent above the model origin


def _find_geometry(model: ET.Element):
    """The (shape, half_sizes, z_offset) primitives of a model's first box,
    cylinder or mesh geometry; z_offset lifts the primitive's center above
    the model pose (SDF tree models are rooted at ground level)."""
    size_el = model.find(".//box/size")
    if size_el is not None and size_el.text is not None:
        vals = [float(v) for v in size_el.text.split()]
        return [(SHAPE_BOX, np.array(vals[:3]) / 2, 0.0)]
    cyl = model.find(".//cylinder")
    if cyl is not None:
        radius = float(cyl.findtext("radius", default="0.5"))
        length = float(cyl.findtext("length", default="1.0"))
        return [(SHAPE_CYLINDER, np.array([radius, radius, length / 2]), 0.0)]
    if model.find(".//mesh") is not None:
        trunk_half = _TREE_HEIGHT / 2
        cz0, cz1 = _TREE_CANOPY_Z
        canopy_half = (cz1 - cz0) / 2
        return [
            (SHAPE_CYLINDER, np.array([_TREE_TRUNK_RADIUS, _TREE_TRUNK_RADIUS,
                                       trunk_half]), trunk_half),
            (SHAPE_CYLINDER, np.array([_TREE_CANOPY_RADIUS,
                                       _TREE_CANOPY_RADIUS, canopy_half]),
             cz0 + canopy_half),
        ]
    return []


def parse_world(path: str, max_boxes: int | None = 64,
                device="cuda") -> BoxWorld:
    """Read a reference-format .world into one BoxWorld on ``device``
    (axis-aligned footprints: the reference's boxes carry negligible yaw
    from physics settling). Models without a ``<state>`` pose and the
    ground plane are skipped.

    ``max_boxes=None`` sizes the capacity to the parsed primitive count,
    rounded up to a multiple of 8 (at least 8); a world with more
    primitives than max_boxes raises ValueError rather than drop geometry."""
    dev = _cuda.resolve_device(device)
    tree = ET.parse(path)
    world = tree.getroot().find("world")
    if world is None:
        raise ValueError(f"{path}: no <world> element")

    prims = {}   # model name -> [(shape, half, z_offset), ...]
    for model in world.findall("model"):
        name = model.attrib.get("name", "")
        if name == "ground_plane":
            continue
        found = _find_geometry(model)
        if found:
            prims[name] = found

    poses = {}
    state = world.find("state")
    if state is not None:
        for model in state.findall("model"):
            name = model.attrib.get("name", "")
            if name == "ground_plane" or name not in prims:
                continue
            pose_el = model.find("pose")
            if pose_el is None or pose_el.text is None:
                continue
            vals = [float(v) for v in pose_el.text.split()]
            poses[name] = np.array(vals[:3])

    names = [n for n in prims if n in poses]
    total = sum(len(prims[n]) for n in names)
    if max_boxes is None:
        max_boxes = max((total + 7) // 8 * 8, 8)
    if total > max_boxes:
        raise ValueError(
            f"{path}: {total} primitives exceed max_boxes={max_boxes}; "
            f"pass max_boxes>={total} (or max_boxes=None to auto-size)")
    K = max_boxes
    centers = np.zeros((K, 3), dtype=np.float32)
    half = np.full((K, 3), 0.01, dtype=np.float32)
    active = np.zeros(K, dtype=bool)
    shape = np.zeros(K, dtype=np.int32)
    i = 0
    for n in names:
        for (sh, hs, z_off) in prims[n]:
            centers[i] = poses[n] + np.array([0.0, 0.0, z_off])
            half[i] = hs
            active[i] = True
            shape[i] = sh
            i += 1
    return BoxWorld(centers=torch.from_numpy(centers).to(dev),
                    half_sizes=torch.from_numpy(half).to(dev),
                    active=torch.from_numpy(active).to(dev),
                    shape=torch.from_numpy(shape).to(dev))


_WORLD_TEMPLATE = """<?xml version="1.0"?>
<sdf version="1.6">
  <world name="default">
    <include><uri>model://ground_plane</uri></include>
    <include><uri>model://sun</uri></include>
{models}
    <state world_name="default">
{states}
    </state>
  </world>
</sdf>
"""

_MODEL_TEMPLATE = """    <model name="{name}">
      <static>true</static>
      <link name="link">
        <collision name="collision">
          <geometry>{geom}</geometry>
        </collision>
        <visual name="visual">
          <geometry>{geom}</geometry>
        </visual>
      </link>
    </model>"""

_STATE_TEMPLATE = """      <model name="{name}">
        <pose>{x} {y} {z} 0 0 0</pose>
        <link name="link"><pose>{x} {y} {z} 0 0 0</pose></link>
      </model>"""


def write_world(world: BoxWorld, path: str) -> None:
    """Write one BoxWorld (fields without the env axis, on any device) as a
    minimal SDF world in the reference's schema: sizes on the world's
    models, poses on the state's models (generate_worlds.py:148-185)."""
    centers = world.centers.detach().cpu().numpy()
    half = world.half_sizes.detach().cpu().numpy()
    active = world.active.detach().cpu().numpy()
    shape = world.shape.detach().cpu().numpy()
    models, states = [], []
    for i in range(len(active)):
        if not active[i]:
            continue
        name = f"model{len(models)}"
        x, y, z = centers[i].tolist()
        if shape[i] == SHAPE_CYLINDER:
            geom = (f"<cylinder><radius>{half[i, 0]}</radius>"
                    f"<length>{half[i, 2] * 2}</length></cylinder>")
        else:
            sx, sy, sz = (half[i] * 2).tolist()
            geom = f"<box><size>{sx} {sy} {sz}</size></box>"
        models.append(_MODEL_TEMPLATE.format(name=name, geom=geom))
        states.append(_STATE_TEMPLATE.format(name=name, x=x, y=y, z=z))
    with open(path, "w") as f:
        f.write(_WORLD_TEMPLATE.format(models="\n".join(models),
                                       states="\n".join(states)))


def forest_world_xml(seed: int, trees: int = 150) -> str:
    """The text of a forest .world in the reference's schema: trees
    model://pine_tree meshes (two cylinders each once parsed: 150 trees
    parse into 300 primitives, capacity 304 with max_boxes=None) on a
    jittered grid, 15 columns 2.2 m apart from x = 4 m and rows 2.3 m apart
    on either side of a corridor along y = 0 (the tree centres from |y| =
    3.2 m), each position jittered by up to 0.3 m from a numpy generator
    seeded seed."""
    rng = np.random.default_rng(seed)
    geom = "<mesh><uri>model://pine_tree</uri></mesh>"
    models, states = [], []
    for i in range(trees):
        x = 4.0 + 2.2 * (i % 15) + rng.uniform(-0.3, 0.3)
        row = i // 15
        y = (3.2 + 2.3 * (row // 2)) * (1 if row % 2 else -1) \
            + rng.uniform(-0.3, 0.3)
        models.append(_MODEL_TEMPLATE.format(name=f"tree_{i}", geom=geom))
        states.append(_STATE_TEMPLATE.format(name=f"tree_{i}", x=x, y=y,
                                             z=0.0))
    return _WORLD_TEMPLATE.format(models="\n".join(models),
                                  states="\n".join(states))
