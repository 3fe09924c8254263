"""The benchmark sweep: planners x worlds x repeats, aggregated like the
reference.

The port's counterpart of examples/multi_run.py (the reference's
bash/multi_run.sh, sequential Gazebo runs of planners x worlds x repeats,
and bash/analyze_data.py), as learn/pipeline.py is examples/train.py's. A
world is an integer seed (a random world of ``WorldParams()`` from a
generator seeded 1000 + seed) or a ``.world`` path (read by
``worldio.parse_world(max_boxes=None)``: the reference's poles, bricks,
forest and rand_world_N load as they are). Every world is padded to one
common primitive capacity, the largest active count rounded up to 8
(multi_run.py:64-83). The goal is nudged to the first clear spot near
(25, 0) on the world's scene SDF (multi_run.py:89-105). Each (world,
planner) cell then runs B = repeats envs of that world, from a generator
seeded world_index * 97 + 13, on the scene path ('geo': the ground-truth
grid), 'manual' missions: one untimed rollout, then the timed one from
the same start; its records go through ``utils/metrics``
(``from_env_states``, ``write_metrics_file``, ``analyze``).

    python -m neoplanner_tpu_torch.sim.sweep --planners expert neo \\
        --net artifacts/planner_net_smallconv --worlds 0 1 poles.world
    python -m neoplanner_tpu_torch.sim.sweep --device cpu --repeats 2 \\
        --segments 2 --max-iters 4
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, NetParams,
                                         PlannerParams, SimParams,
                                         WorldParams)
from neoplanner_tpu_torch.core.types import BoxWorld
from neoplanner_tpu_torch.mapping import scene as scene_map
from neoplanner_tpu_torch.models import planner_net
from neoplanner_tpu_torch.sim import env
from neoplanner_tpu_torch.utils import metrics
from neoplanner_tpu_torch.world import scenegen, worldio

PLANNERS = ("expert", "warmstart", "geo", "nn", "neo")
BASE_GOAL = (25.0, 0.0)
_FIELDS = ("centers", "half_sizes", "active", "shape")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--planners", nargs="+", default=["expert", "warmstart"],
                    choices=PLANNERS)
    ap.add_argument("--worlds", nargs="+", default=["0", "1", "2", "3"],
                    help="integer seeds for random worlds and/or .world "
                         "paths")
    ap.add_argument("--repeats", type=int, default=16)
    ap.add_argument("--segments", type=int, default=45)
    ap.add_argument("--max-iters", type=int, default=64,
                    help="the L-BFGS iterations (multi_run.py: 64)")
    ap.add_argument("--net", default=None,
                    help="the PlannerNet ('nn', 'neo'): an .onnx file or "
                         "the JAX package's orbax checkpoint directory, "
                         "its NetParams beside it as .netcfg.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="planning_metrics.txt path")
    return ap.parse_args(argv)


def load_worlds(names, wp: WorldParams, device):
    """[(world, label)] of the seeds and .world paths in names, each one
    world without the env axis on device."""
    loaded = []
    for name in names:
        name = str(name)
        if name.isdigit():
            gen = _cuda.make_generator(1000 + int(name), device)
            loaded.append((scenegen.generate(gen, wp),
                           f"rand_world_{int(name)}"))
        else:
            loaded.append((worldio.parse_world(name, max_boxes=None,
                                               device=device),
                           os.path.splitext(os.path.basename(name))[0]))
    return loaded


def common_capacity(worlds) -> int:
    """The largest active primitive count, at least 8, rounded up to 8."""
    cap = max(max(int(w.active.sum()) for w in worlds), 8)
    return (cap + 7) // 8 * 8


def with_capacity(world: BoxWorld, cap: int) -> BoxWorld:
    """world cut or zero-padded to cap primitives (active ones come first,
    so a cut keeps all real geometry)."""
    if int(world.active[cap:].sum()):
        raise ValueError(f"the world has active primitives past {cap}")

    def fit(t):
        if t.shape[0] >= cap:
            return t[:cap]
        return torch.cat([t, t.new_zeros((cap - t.shape[0],)
                                          + t.shape[1:])])
    return BoxWorld(*(fit(getattr(world, f)) for f in _FIELDS))


def batch_of(world: BoxWorld, n: int) -> BoxWorld:
    """n envs of one world."""
    return BoxWorld(*(getattr(world, f).expand(n, *getattr(world, f).shape)
                      .contiguous() for f in _FIELDS))


def clear_goal(world: BoxWorld, mapp: MapParams,
               clearance: float) -> torch.Tensor:
    """(2,) float32: the first candidate around BASE_GOAL, rings of radius
    0, 0.5, ... 4 m at 8 angles each, whose scene distance exceeds
    clearance (multi_run.py:89-105)."""
    base = np.array(BASE_GOAL)
    cands = np.array([base + r * np.array([np.cos(a), np.sin(a)])
                      for r in np.arange(0.0, 4.1, 0.5)
                      for a in np.linspace(0, 2 * np.pi, 8, endpoint=False)])
    sc = scene_map.build(batch_of(world, 1), mapp)
    dev = world.centers.device
    pts = torch.as_tensor(cands, dtype=torch.float32, device=dev)
    dis, _ = scene_map.sample(sc, pts[None])
    clear = np.nonzero(dis[0].double().cpu().numpy() > clearance)[0]
    if not len(clear):
        raise ValueError(f"no clear goal near {BASE_GOAL}")
    return pts[int(clear[0])]


def load_net(path: str, device):
    """(PlannerNet in eval mode on device, its NetParams) of --net: an
    exported .onnx file or the JAX package's orbax checkpoint directory
    (multi_run.py:55), its NetParams from the .netcfg.json beside it."""
    path = os.path.normpath(path)
    base = path if os.path.isdir(path) else os.path.splitext(path)[0]
    with open(base + ".netcfg.json") as f:
        np_cfg = NetParams(**json.load(f))
    return planner_net.load(path, np_cfg, device), np_cfg


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> dict:
    """Run the sweep; returns records (the MissionRecords), analysis
    (metrics.analyze's table) and cells, one dict per (world, planner):
    world, planner, prims (active primitives), envs, segments, wall_s,
    ms_segment, steps_per_s, reached (missions ok by the records' rule),
    plans, launches (each kernel's launches in the timed rollout)."""
    args = parse_args(argv)
    dev = _cuda.resolve_device(args.device)
    pp = PlannerParams(max_iters=args.max_iters)
    mp, sp = MissionParams(), SimParams()
    mapp = MapParams()
    cam = CameraParams(width=160, height=120)
    wp = WorldParams()

    net = None
    if any(p in ("nn", "neo") for p in args.planners):
        if args.net is None:
            raise ValueError("the 'nn' and 'neo' planners need --net")
        net, np_cfg = load_net(args.net, dev)
        cam = CameraParams(width=np_cfg.img_width, height=np_cfg.img_height)

    loaded = load_worlds(args.worlds, wp, dev)
    cap = common_capacity([w for w, _ in loaded])
    B = args.repeats
    records, cells = [], []
    for wi, (world, label) in enumerate(loaded):
        world = with_capacity(world, cap)
        goal = clear_goal(world, mapp, pp.safe_dis + 0.3)
        worlds_b = batch_of(world, B)
        n_prims = int(world.active.sum())
        for planner in args.planners:
            plan_map = "grid" if planner == "geo" else "scene"

            def start():
                return env.reset(worlds_b, pp, mp, mapp,
                                 _cuda.make_generator(wi * 97 + 13, dev),
                                 goal=goal.expand(B, 2).clone(),
                                 plan_map=plan_map)

            def roll(state):
                return env.rollout(state, args.segments, pp, mp, sp, cam,
                                   net, planner=planner,
                                   mission_mode="manual")
            # the planning duration records steady-state solves: the first
            # rollout builds and loads the kernels and warms the caches
            roll(start())
            state = start()
            before = dict(_cuda.launches)
            _sync(dev)
            t0 = time.perf_counter()
            out = roll(state)
            _sync(dev)
            wall = time.perf_counter() - t0
            launches = {k: v - before[k] for k, v in _cuda.launches.items()}
            plans = int(out.plan_count.sum())
            recs = metrics.from_env_states(
                out, world_name=label, num_models=wp.num_boxes,
                planner=planner, wall_time_per_plan=wall / max(plans, 1),
                pp=pp)
            records.extend(recs)
            reached = sum(r.reached for r in recs)
            cells.append(dict(
                world=label, planner=planner, prims=n_prims, envs=B,
                segments=args.segments, wall_s=wall,
                ms_segment=wall * 1e3 / args.segments,
                steps_per_s=B * mp.steps_per_replan * args.segments / wall,
                reached=reached, plans=plans, launches=launches))
            print(f"world {label} ({n_prims} primitives, capacity {cap}) "
                  f"planner {planner}: {reached}/{B} success, wall "
                  f"{wall:.2f} s ({wall * 1e3 / args.segments:.1f} "
                  f"ms/segment)", flush=True)

    if args.out:
        metrics.write_metrics_file(args.out, records)
    analysis = metrics.analyze(records)
    print(json.dumps(analysis, indent=2))
    return dict(records=records, analysis=analysis, cells=cells)


if __name__ == "__main__":
    main()
