"""Single-mission demo: fly one goal in a random world or a Gazebo world.

The port's counterpart of examples/demo.py (the reference's bash/demo.sh:
bring-up and one goal published at x = 30), with an ASCII render for the
RViz view. One env (B = 1) flies a 'manual' mission from --start to --goal
under ``PlannerParams(max_iters=96)`` on the reference's default map
(``MapParams()``: 448 x 256 cells, the '2d' fusion, the exact ESDF) with a
160 x 120 camera, one replan period a segment, until it reaches its goal,
fails, or --max-segments have passed. It prints demo.py's result line and
the map of ``voxelize.occupancy_2d`` (``#`` occupied, ``.`` free, one glyph
per 4 columns x 8 rows) with the flown path (``o``) and the goal (``X``).

    python -m neoplanner_tpu_torch.sim.demo --goal 25 0 --planner expert \\
        --sensing gt
    python -m neoplanner_tpu_torch.sim.demo --world poles.world
    python -m neoplanner_tpu_torch.sim.demo --device cpu --max-segments 2
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, PlannerParams,
                                         SimParams, WorldParams)
from neoplanner_tpu_torch.sim import env, sweep
from neoplanner_tpu_torch.world import scenegen, voxelize, worldio


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--goal", type=float, nargs=2, default=[25.0, 0.0])
    ap.add_argument("--start", type=float, nargs=2, default=[0.0, 0.0])
    ap.add_argument("--planner", default="expert", choices=env.PLANNERS)
    ap.add_argument("--sensing", default="gt", choices=["gt", "depth"])
    ap.add_argument("--plan-map", default="scene", choices=["scene", "grid"])
    ap.add_argument("--world", default=None,
                    help="a Gazebo .world file (default: random boxes)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--net", default=None,
                    help="checkpoint for nn/neo: the JAX package's orbax "
                         "directory or an .onnx file, its NetParams "
                         "beside it as .netcfg.json")
    ap.add_argument("--replan-mode", default="periodic",
                    choices=env.REPLAN_MODES,
                    help="the reference's replan_mode rosparam "
                         "(traj_planner_node.py:233-245)")
    ap.add_argument("--fuse-frames", type=int, default=1,
                    help="depth frames fused per segment (sensor-rate "
                         "fusion; depth sensing only)")
    ap.add_argument("--row-stride", type=int, default=1,
                    help="vertical row stride for fusion-frame rendering "
                         "(MapParams.fusion_row_stride; 1 = reference "
                         "full-res cadence)")
    ap.add_argument("--esdf-rate", type=int, default=1,
                    help="ESDF rebuilds per segment (sensor-rate field, "
                         "needs --fuse-frames > 1)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-segments", type=int, default=60)
    return ap.parse_args(argv)


def ascii_map(occ: np.ndarray, path, goal, mapp: MapParams) -> str:
    """The rows of the render (demo.py:104-117): occ (H, W) 0/1, one glyph
    per 4 columns x 8 rows ('#' where the sampled cell is occupied, else
    '.'), 'o' at each flown position of path (N, 2) and 'X' at goal (2,)."""
    h, w = occ.shape
    grid = [[("#" if occ[r, c] else ".") for c in range(0, w, 4)]
            for r in range(0, h, 8)]

    def cell(p):
        c = int((float(p[0]) - mapp.origin_x) / mapp.resolution) // 4
        r = int((float(p[1]) - mapp.origin_y) / mapp.resolution) // 8
        return r, c

    for p in path:
        r, c = cell(p)
        if 0 <= r < len(grid) and 0 <= c < len(grid[0]):
            grid[r][c] = "o"
    gr, gc = cell(goal)
    if 0 <= gr < len(grid) and 0 <= gc < len(grid[0]):
        grid[gr][gc] = "X"
    return "\n".join("".join(row) for row in grid)


def result_line(state: env.EnvState, mp: MissionParams, wall: float) -> str:
    """demo.py:97-102's line for the env of a one-env state."""
    plans = int(state.plan_count[0])
    return (f"result: {'SUCCESS' if bool(state.reached[0]) else 'FAILED'} | "
            f"flight time {float(state.steps[0]) / mp.cmd_hz:.1f} s | "
            f"wall {wall:.1f} s | plans {plans} | "
            f"avg L-BFGS iters {int(state.iter_sum[0]) / max(plans, 1):.0f} | "
            f"weighted metric {float(env.weighted_metric(state)[0]):.2f}")


def main(argv=None) -> dict:
    """Fly the mission; prints the result line and the map. Returns state
    (the one-env EnvState at the end), path ((N, 2) positions after each
    segment), segments, line (the result line) and map (the render)."""
    args = parse_args(argv)
    dev = _cuda.resolve_device(args.device)
    pp = PlannerParams(max_iters=96)
    mp, sp = MissionParams(), SimParams()
    mapp = MapParams(fusion_row_stride=args.row_stride)
    cam = CameraParams(width=160, height=120)

    if args.world:
        world = worldio.parse_world(args.world, max_boxes=None, device=dev)
    else:
        world = scenegen.generate(_cuda.make_generator(args.seed, dev),
                                  WorldParams())

    net = None
    if args.planner in ("nn", "neo"):
        if not args.net:
            sys.exit("--net checkpoint required for nn/neo planners")
        net, _ = sweep.load_net(args.net, dev)

    goal = torch.tensor([args.goal], dtype=torch.float32, device=dev)
    state = env.reset(sweep.batch_of(world, 1), pp, mp, mapp,
                      _cuda.make_generator(args.seed, dev), goal=goal,
                      start_pos=torch.tensor([args.start], device=dev),
                      sensing=args.sensing, plan_map=args.plan_map)
    t0 = time.perf_counter()
    path = []
    for _ in range(args.max_segments):
        state, _ = env.step_segment(
            state, pp, mp, sp, cam, net, fuse_frames=args.fuse_frames,
            esdf_rate=args.esdf_rate, planner=args.planner,
            mission_mode="manual", replan_mode=args.replan_mode)
        path.append(state.drone.pos[0, :2].cpu().numpy())
        if bool(state.reached[0]) or bool(state.failed[0]):
            break
    _cuda.synchronize(dev)
    line = result_line(state, mp, time.perf_counter() - t0)
    print(line)
    occ = voxelize.occupancy_2d(sweep.batch_of(world, 1), mapp)[0]
    render = ascii_map(occ.cpu().numpy(), path, args.goal, mapp)
    print(render)
    return dict(state=state, path=np.array(path), segments=len(path),
                line=line, map=render)


if __name__ == "__main__":
    main()
