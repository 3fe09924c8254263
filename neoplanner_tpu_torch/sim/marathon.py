"""The quality table: every planner x both sensing modes, one protocol.

The port's counterpart of examples/marathon.py, as sim/sweep.py is
examples/multi_run.py's. Cells: {expert, warmstart, geo, nn, neo} x
{scene, vision}, each B envs of 'random' missions for K replan periods
under one planner envelope (marathon.py:54-57):

- goals vetted against the ground-truth scene
  (``MissionParams.goal_clear_dis = safe_dis + 0.3``);
- the reference's per-mission bar (reached within 45 s and a weighted
  closed-loop metric within 10 x collision_cost_tol);
- 'scene': ground-truth sensing, one frame, the analytic scene SDF ('geo':
  the ground-truth grid, whose wavefront relaxes over cells);
- 'vision': depth sensing, 6 frames fused a segment ('2d_dense' at
  ``--row-stride``), the truncated lite ESDF, grid planning.

Every cell flies the same B worlds (a generator seeded ``--seed``) from
the same reset and draws (a generator seeded ``--seed`` + 1, made anew
for each cell), so cells differ only by planner and mode. A cell's row
follows marathon.py:111-121: missions done and ok, ok%, the ok missions'
mean weighted metric, L-BFGS iterations a plan and wall seconds; the port
adds plans, ms a segment and each kernel's launches over the reset and the
K segments. The JAX script's wall time includes XLA's compilation; here
the kernels are built before the first cell, and wall_s times the K
segments of ``env.step_segment`` up to a ``torch.cuda.synchronize()``
(the reset is not timed, as marathon.py times only its steps).

    python -m neoplanner_tpu_torch.sim.marathon
    python -m neoplanner_tpu_torch.sim.marathon --net \\
        artifacts/planner_net_resnet640 --planners nn,neo --modes scene
    python -m neoplanner_tpu_torch.sim.marathon --device cpu --envs 2 \\
        --segments 1 --max-iters 2
"""

from __future__ import annotations

import argparse
import json
import os
import time

from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, PlannerParams,
                                         SimParams, WorldParams)
from neoplanner_tpu_torch.sim import env, sweep
from neoplanner_tpu_torch.world import scenegen

PLANNERS = ("expert", "warmstart", "geo", "nn", "neo")
MODES = ("scene", "vision")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_NET = os.path.join(_REPO, "artifacts", "planner_net_smallconv")


def _names(text: str, allowed) -> list:
    names = [n for n in text.split(",") if n]
    bad = [n for n in names if n not in allowed]
    if bad:
        raise argparse.ArgumentTypeError(f"{bad}: choose from {allowed}")
    return names


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=256, help="B (MAR_B)")
    ap.add_argument("--segments", type=int, default=90,
                    help="K replan periods a cell (MAR_SEGMENTS)")
    ap.add_argument("--planners", default=",".join(PLANNERS),
                    type=lambda s: _names(s, PLANNERS),
                    help="comma-separated (MAR_PLANNERS)")
    ap.add_argument("--modes", default=",".join(MODES),
                    type=lambda s: _names(s, MODES),
                    help="comma-separated (MAR_MODES)")
    ap.add_argument("--net", default=DEFAULT_NET,
                    help="the PlannerNet: the JAX package's orbax "
                         "checkpoint directory (or an .onnx file), its "
                         "NetParams beside it as .netcfg.json; the camera "
                         "takes the net's image size (MAR_NET)")
    ap.add_argument("--row-stride", type=int, default=1,
                    help="MapParams.fusion_row_stride of the vision cells "
                         "(MAR_ROW_STRIDE)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the worlds' generator seed; the resets' is "
                         "seed + 1")
    ap.add_argument("--max-iters", type=int, default=32,
                    help="the L-BFGS iterations (marathon.py: 32)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def params(max_iters: int = 32):
    """(PlannerParams, MissionParams, SimParams, WorldParams) of every cell
    (marathon.py:54-57)."""
    pp = PlannerParams(max_iters=max_iters, samples_per_piece=24,
                       retry_num=2, extra_lateral_scales=(2.5, -2.5),
                       max_ls=4)
    mp = MissionParams(goal_clear_dis=pp.safe_dis + 0.3)
    return pp, mp, SimParams(), WorldParams(num_boxes=10)


def cell_settings(mode: str, planner: str, row_stride: int = 1):
    """(sensing, fuse_frames, MapParams, plan_map) of a cell
    (marathon.py:72-86)."""
    if mode == "scene":
        mapp = MapParams(width=256, height=192, origin_x=-4.0, origin_y=-9.6)
        # geo's wavefront needs the rasterized grid
        return ("gt", 1, mapp, "grid" if planner == "geo" else "scene")
    if mode == "vision":
        mapp = MapParams(width=256, height=192, origin_x=-4.0, origin_y=-9.6,
                         edt_truncation=2.0, fusion="2d_dense",
                         fusion_row_stride=row_stride)
        return "depth", 6, mapp, "grid"
    raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")


def row(mode: str, planner: str, state: env.EnvState, wall: float) -> dict:
    """A cell's row from its final state, marathon.py:111-121's formulas on
    the state's arrays."""
    def a(t):
        return t.cpu().numpy()
    done = int(a(state.missions_done).sum())
    ok = int(a(state.missions_ok).sum())
    wm = float(a(state.metric_ok_sum).sum()) / max(ok, 1)
    iters = (float(a(state.iter_sum).sum())
             / max(float(a(state.plan_count).sum()), 1.0))
    return {"mode": mode, "planner": planner, "missions": done, "ok": ok,
            "ok_pct": round(100.0 * ok / max(done, 1), 1),
            "avg_weighted_metric": round(wm, 2),
            "avg_iters_per_plan": round(iters, 1),
            "wall_s": round(wall, 1)}


def table(rows) -> str:
    """The markdown table of marathon.py:124-131."""
    lines = ["| mode | planner | missions | ok | ok% | avg metric | "
             "iters/plan |", "|---|---|---|---|---|---|---|"]
    lines += [f"| {r['mode']} | {r['planner']} | {r['missions']} | "
              f"{r['ok']} | {r['ok_pct']} | {r['avg_weighted_metric']} | "
              f"{r['avg_iters_per_plan']} |" for r in rows]
    return "\n".join(lines)


def main(argv=None) -> dict:
    """Run the marathon; prints each row as a JSON line, then the table.
    Returns rows (one dict per cell: marathon.py's fields, then plans,
    segments, ms_segment and launches), starts (per (mode, planner) the
    reset's goals, drone positions and generator state) and states (per
    (mode, planner) the final EnvState)."""
    args = parse_args(argv)
    dev = _cuda.resolve_device(args.device)
    pp, mp, sp, wp = params(args.max_iters)
    net, np_cfg = sweep.load_net(args.net, dev)
    cam = CameraParams(width=np_cfg.img_width, height=np_cfg.img_height)
    if dev.type == "cuda":
        _cuda.prebuild((pp.num_pieces,))

    B, K = args.envs, args.segments
    worlds = scenegen.generate_batch(_cuda.make_generator(args.seed, dev), B,
                                     wp)
    rows, starts, states = [], {}, {}
    for mode in args.modes:
        for planner in args.planners:
            sensing, fuse, mapp, plan_map = cell_settings(mode, planner,
                                                          args.row_stride)
            before = dict(_cuda.launches)
            state = env.reset(worlds, pp, mp, mapp,
                              _cuda.make_generator(args.seed + 1, dev),
                              sensing=sensing, plan_map=plan_map)
            starts[mode, planner] = dict(
                goal=state.goal.cpu(), pos=state.drone.pos.cpu(),
                generator=state.generator.get_state())
            _cuda.synchronize(dev)
            t0 = time.perf_counter()
            state = env.rollout(state, K, pp, mp, sp, cam, net,
                                fuse_frames=fuse, planner=planner,
                                mission_mode="random")
            _cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            r = row(mode, planner, state, wall)
            r.update(plans=int(state.plan_count.sum()), segments=K,
                     ms_segment=round(wall * 1e3 / K, 3),
                     launches=_cuda.launches_since(before))
            rows.append(r)
            states[mode, planner] = state
            print(json.dumps(r), flush=True)
    print("\n" + table(rows), flush=True)
    return dict(rows=rows, starts=starts, states=states)


if __name__ == "__main__":
    main()
