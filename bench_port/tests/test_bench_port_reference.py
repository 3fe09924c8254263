"""The plain reference: independent of the program, and equal to the
port's PlannerNet on seeded weights at a small size."""

import ast
from pathlib import Path

import pytest
import torch

from harness import inputs, loop
from harness.cells import check_reader

BENCH_DIR = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "neoplanner_tpu"}
PROGRAM = "neoplanner_tpu_torch"
_net_forward = check_reader("net")._forward


def _top_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    (BENCH_DIR / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_neither_program_nor_jax(path):
    tops = set(_top_imports(path))
    assert not tops & (FORBIDDEN | {PROGRAM}), tops


@pytest.mark.parametrize("path", sorted(
    p for p in BENCH_DIR.rglob("*.py") if "reference" not in p.parts),
    ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_harness_imports_no_jax(path):
    assert not set(_top_imports(path)) & FORBIDDEN


def test_plain_resnet_matches_the_port_on_seeded_weights():
    from neoplanner_tpu_torch.config import NetParams
    from neoplanner_tpu_torch.models.planner_net import PlannerNet
    from reference.config import NetParams as RefParams
    from reference.planner_net import PlannerNet as RefNet

    cfg = dict(img_width=64, img_height=48)
    weights = inputs.net_weights(loop.net_shapes(cfg),
                                 inputs.generator(7, 2, "cpu"))
    port = PlannerNet(NetParams(**cfg)).eval()
    port.load_state_dict(weights, strict=True)
    ref = RefNet(RefParams(**cfg)).eval()
    ref.load_state_dict(weights, strict=True)
    g = torch.Generator().manual_seed(3)
    img = 255 * torch.rand((5, 48, 64, 1), generator=g)
    motion = torch.randn((5, 24), generator=g)
    with torch.no_grad():
        want = port(img, motion)
    got = _net_forward(ref, img, motion, tf32=False)
    assert got.shape == (5, 9)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # the seeded weights differ from the defaults and from another seed
    other = inputs.net_weights(loop.net_shapes(cfg),
                               inputs.generator(8, 2, "cpu"))
    assert not torch.equal(other["mlp.0.weight"], weights["mlp.0.weight"])
    bn = weights["img_backbone.bn_0.running_var"]
    assert bool(((bn >= 1.0) & (bn < 1.2)).all())


def test_seeded_net_keeps_a_trained_scale():
    """BatchNorm's statistics set from rendered frames keep the seeded
    net's outputs within a few units."""
    from reference.config import NetParams as RefParams
    from reference.planner_net import PlannerNet as RefNet
    from reference.raycast import render_depth
    from reference.data import normalize_depth
    from reference.types import BoxWorld

    cfg = dict(img_width=64, img_height=48)
    world = inputs.worlds(inputs.generator(5, 1, "cpu"), 4, MIX)
    w = loop.seeded_weights(cfg, dict(width=64, height=48), world, 5, "cpu")
    net = RefNet(RefParams(**cfg)).eval()
    net.load_state_dict(w, strict=True)
    pos = torch.tensor([[0.0, 0.0, 2.0]]).repeat(4, 1)
    quat = torch.tensor([[1.0, 0.0, 0.0, 0.0]]).repeat(4, 1)
    from reference.config import CameraParams
    depth = render_depth(BoxWorld(**world), pos, quat,
                         CameraParams(width=64, height=48))
    out = _net_forward(net, normalize_depth(depth)[..., None],
                       torch.zeros(4, 24), tf32=False)
    assert float(out.abs().max()) < 20.0


MIX = {"max_boxes": 24, "num_boxes": 10, "pose_x_min": 3.0,
       "pose_x_max": 27.0, "pose_y_min": -5.0, "pose_y_max": 5.0,
       "size_x_min": 0.5, "size_x_max": 1.5, "size_y_min": 0.5,
       "size_y_max": 1.5, "size_z_min": 3.0, "size_z_max": 6.0,
       "x_clearance": 1.8, "y_clearance": 1.8, "rejection_rounds": 12}


def test_worlds_repeat_from_the_seed():
    mix = MIX
    seed = 2 ** 31 + 12345
    a = inputs.worlds(inputs.generator(seed, 1, "cpu"), 8, mix)
    b = inputs.worlds(inputs.generator(seed, 1, "cpu"), 8, mix)
    c = inputs.worlds(inputs.generator(seed + 1, 1, "cpu"), 8, mix)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["centers"], c["centers"])
    assert int(a["active"].sum(1).max()) <= 10
