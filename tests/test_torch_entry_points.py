"""The port's single-mission demo (sim/demo.py, examples/demo.py's) and its
B = 1 replan latency (plan/latency.py, examples/latency.py's) on the CPU;
the latency's 12-lane profile is held against the JAX package in
test_torch_latency_profile.py and test_torch_latency_profile_grid.py.

- The demo flies B = 1 for 2 segments from a seeded world and for one
  from a .world file written by worldio.write_world, prints demo.py's
  result line (demo.py:97-102) and the ASCII map; its render is held to
  demo.py:104-117's glyph arithmetic on JAX's occupancy_2d of the same
  world, which equals the port's; nn/neo without --net exit.
- The latency's trim profile runs 2 reps and prints its two lines.
- The net that these entry points call computes in IEEE f32 whatever the
  caller set (planner_net.ieee_f32).
"""

import re

import numpy as np
import jax
import pytest

from neoplanner_tpu.config import MapParams as JMapParams
from neoplanner_tpu.config import WorldParams as JWorldParams
from neoplanner_tpu.world import scenegen as jscenegen
from neoplanner_tpu.world import voxelize as jvoxelize
from neoplanner_tpu_torch.config import MapParams
from neoplanner_tpu_torch.plan import latency
from neoplanner_tpu_torch.sim import demo, sweep
from neoplanner_tpu_torch.world import voxelize, worldio
from tests.test_torch_imports import one_torch_thread  # noqa: F401
from tests.test_torch_latency_profile import port_world

RESULT = re.compile(r"result: (SUCCESS|FAILED) \| flight time \d+\.\d s \| "
                    r"wall \d+\.\d s \| plans \d+ \| avg L-BFGS iters \d+ \| "
                    r"weighted metric -?\d+\.\d\d$")


def _jax_render(occ, path, goal, mapp):
    """demo.py:104-117, as written there."""
    h, w = occ.shape
    grid = [[("#" if occ[r, c] else ".") for c in range(0, w, 4)]
            for r in range(0, h, 8)]
    for p in path:
        c = int((p[0] - mapp.origin_x) / mapp.resolution) // 4
        r = int((p[1] - mapp.origin_y) / mapp.resolution) // 8
        if 0 <= r < len(grid) and 0 <= c < len(grid[0]):
            grid[r][c] = "o"
    gc = int((float(goal[0]) - mapp.origin_x) / mapp.resolution) // 4
    gr = int((float(goal[1]) - mapp.origin_y) / mapp.resolution) // 8
    if 0 <= gr < len(grid) and 0 <= gc < len(grid[0]):
        grid[gr][gc] = "X"
    return "\n".join("".join(row) for row in grid)


# ---- the demo

def test_demo_flies_two_segments(capsys):
    out = demo.main(["--device", "cpu", "--max-segments", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert RESULT.match(lines[0]), lines[0]
    assert out["line"] == lines[0] and out["segments"] == 2
    st = out["state"]
    assert st.buffer.shape[0] == 1 and int(st.plan_count[0]) == 2
    assert float(np.abs(out["path"][-1]).max()) > 0.05     # it moved
    # the render: 256 / 8 rows of 448 / 4 glyphs, the goal drawn
    rows = lines[1:]
    assert "\n".join(rows) == out["map"]
    assert len(rows) == 32 and {len(r) for r in rows} == {112}
    assert out["map"].count("X") == 1 and "o" in out["map"]


def test_demo_flies_a_world_file(tmp_path, capsys):
    jw = jscenegen.generate(jax.random.PRNGKey(5), JWorldParams())
    path = str(tmp_path / "boxes.world")
    worldio.write_world(port_world(jw), path)
    out = demo.main(["--device", "cpu", "--world", path, "--max-segments",
                     "1", "--goal", "20", "1"])
    assert RESULT.match(capsys.readouterr().out.splitlines()[0])
    world = worldio.parse_world(path, max_boxes=None, device="cpu")
    assert int(world.active.sum()) == int(np.asarray(jw.active).sum())
    occ = voxelize.occupancy_2d(sweep.batch_of(world, 1), MapParams())[0]
    assert out["map"] == demo.ascii_map(occ.numpy(), out["path"], [20, 1],
                                        MapParams())


def test_ascii_map_matches_demo_glyphs():
    """occupancy_2d equals JAX's on one world; the render of a path over it
    equals demo.py:104-117's, also with points and a goal off the map."""
    jw = jscenegen.generate(jax.random.PRNGKey(3), JWorldParams())
    jmapp = JMapParams()
    j_occ = np.asarray(jvoxelize.occupancy_2d(jw, jmapp))
    occ = voxelize.occupancy_2d(sweep.batch_of(port_world(jw), 1),
                                MapParams())[0].numpy()
    np.testing.assert_array_equal(occ, j_occ)
    assert occ.any()
    rng = np.random.default_rng(4)
    path = np.concatenate([rng.uniform([-8.0, -12.8], [36.8, 12.8], (40, 2)),
                           [[-9.0, 0.0], [40.0, 13.0], [0.05, -0.05]]]
                          ).astype(np.float32)
    for goal in ([25.0, 0.0], [50.0, 0.0], [-8.0, -12.8]):
        assert demo.ascii_map(occ, path, goal, MapParams()) == \
            _jax_render(j_occ, path, np.asarray(goal), jmapp)


@pytest.mark.parametrize("planner", ["nn", "neo"])
def test_demo_net_planner_needs_net(planner):
    with pytest.raises(SystemExit, match="--net checkpoint required"):
        demo.main(["--device", "cpu", "--planner", planner])


# ---- the latency run

def test_latency_trim_prints_two_lines(capsys):
    out = latency.main(["--device", "cpu", "--reps", "2", "--profile",
                        "trim"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    for line, name in zip(lines, ("scene", "grid")):
        assert re.fullmatch(rf"{name} replan B=1 \(trim\): p50 \d+\.\d ms / "
                            rf"p90 \d+\.\d ms", line), line
        assert len(out[name]["times"]) == 2
        assert out[name]["p50"] <= out[name]["p90"]
        assert out[name]["plan"].int_wpts.shape == (1, 2, 2)


# ---- the net's precision does not depend on its caller

def test_net_computes_in_ieee_f32_whatever_the_caller_set():
    """The marathon, the sweep, the demo and chip_smoke.py call the same
    net: its forward and training backward passes run with TF32 off for
    convolutions and matrix products, and the caller's settings come
    back afterwards."""
    import torch
    from neoplanner_tpu_torch.config import NetParams
    from neoplanner_tpu_torch.learn import train
    from neoplanner_tpu_torch.models import planner_net

    def flags():
        return (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    cfg = NetParams(img_width=32, img_height=24, backbone="smallconv")
    net = planner_net.create(cfg)
    seen = []
    net.img_backbone.register_forward_hook(
        lambda *_: seen.append(("forward", flags())))
    next(net.img_backbone.parameters()).register_hook(
        lambda _: seen.append(("backward", flags())))
    before = flags()
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        g = torch.Generator().manual_seed(0)
        img = torch.rand((2, 24, 32, 1), generator=g) * 255.0
        motion = torch.randn((2, 24), generator=g)
        opt = train.make_optimizer(net, train.TrainConfig())
        train.train_step(net, opt, img, motion, torch.zeros((2, 9)))
        assert flags() == (True, True)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before
    assert seen == [("forward", (False, False)), ("backward", (False, False))]
