"""Single-replan latency at B = 1: what a drone planning on board feels.

The port's counterpart of examples/latency.py (the reference prints each
solve's time, traj_planner_node.py:492-509). One world of
``WorldParams(num_boxes=10)``, one env reset on the 256 x 192 map with its
goal at (12, 0); one expert plan from the hovering drone to that goal
(head: position, velocity, zero acceleration; tail: the goal at rest),
timed on the scene SDF (kernels B1, B5) and on the exact ESDF of the
world's ground-truth grid (built once: B9 exact; the plan: B6, B5). Each
map gets one call to warm up, then --reps calls, each timed up to a
``torch.cuda.synchronize()`` (the counterpart of latency.py's fetch); the
p50 and p90 print in latency.py's two lines.

Profiles (latency.py:53-60): 'full' is the reference's deployed 12-lane
bank (``retry_num=5``, four extra laterals, 32 samples a piece,
``max_ls=8``: 3 primaries, 4 laterals, 5 retries), 'trim' the flagship's
5-lane bank (3 primaries, 2 retries; 24 samples, ``max_ls=4``).

    python -m neoplanner_tpu_torch.plan.latency --profile full
    python -m neoplanner_tpu_torch.plan.latency --device cpu --reps 2 \\
        --profile trim
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import (MapParams, MissionParams,
                                         PlannerParams, WorldParams)
from neoplanner_tpu_torch.mapping import esdf
from neoplanner_tpu_torch.plan import expert
from neoplanner_tpu_torch.sim import env, sweep
from neoplanner_tpu_torch.world import scenegen, voxelize

PROFILES = {
    "full": dict(max_iters=32, samples_per_piece=32, retry_num=5,
                 extra_lateral_scales=(1.8, -1.8, 2.5, -2.5), max_ls=8),
    "trim": dict(max_iters=24, samples_per_piece=24, retry_num=2,
                 extra_lateral_scales=(), max_ls=4),
}
GOAL = (12.0, 0.0)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50, help="(LAT_REPS)")
    ap.add_argument("--profile", default="full", choices=sorted(PROFILES),
                    help="(LAT_PROFILE)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def problem(profile: str, device, world=None, noise=None):
    """(PlannerParams, MapParams, one-env world, scene map, exact ESDF map,
    head (1, 3, 2), tail (1, 3, 2), retry noise (1, retry_num, D, M-1))
    of latency.py:52-75 on device. world (a BoxWorld without the env axis)
    and noise (standard normals) replace the seeded ones when given."""
    dev = torch.device(device)
    pp = PlannerParams(**PROFILES[profile])
    mapp = MapParams(width=256, height=192, origin_x=-4.0, origin_y=-9.6)
    if world is None:
        world = scenegen.generate(_cuda.make_generator(0, dev),
                                  WorldParams(num_boxes=10))
    world = sweep.batch_of(world, 1)
    goal = torch.tensor([GOAL], device=dev)
    state = env.reset(world, pp, MissionParams(), mapp,
                      _cuda.make_generator(1, dev), goal=goal,
                      plan_map="scene")
    zeros = torch.zeros((1, 2), device=dev)
    head = torch.stack([state.drone.pos[:, :2], state.drone.vel[:, :2],
                        zeros], 1)
    tail = torch.stack([goal, zeros, zeros], 1)
    if noise is None:
        noise = torch.randn((1, pp.retry_num, pp.dims, pp.num_wpts),
                            generator=_cuda.make_generator(2, dev),
                            device=dev)
    emap = esdf.build(voxelize.occupancy_2d(world, mapp),
                      (mapp.origin_x, mapp.origin_y), mapp.resolution)
    return pp, mapp, world, state.scene, emap, head, tail, noise


def percentiles(fn, reps: int, dev: torch.device):
    """(p50, p90, sorted times in ms) of reps calls of fn after one call to
    warm up, each timed up to a synchronize (latency.py:38-49)."""
    def call():
        fn()
        _cuda.synchronize(dev)
    call()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        ts.append((time.perf_counter() - t0) * 1e3)
    ts = np.sort(np.array(ts))
    return ts[len(ts) // 2], ts[int(len(ts) * 0.9)], ts


def main(argv=None) -> dict:
    """Time both replans; prints latency.py's two lines. Returns, per map
    ('scene', 'grid'), p50, p90 (ms), times (ms, sorted), the last plan
    (a Trajectory of one env) and launches (each kernel's over the
    warm-up and the reps); and esdf_launches (the ESDF build's)."""
    args = parse_args(argv)
    dev = _cuda.resolve_device(args.device)
    before = dict(_cuda.launches)
    pp, _, _, scene, emap, head, tail, noise = problem(args.profile, dev)
    out = dict(esdf_launches=_cuda.launches_since(before))
    for name, pmap in (("scene", scene), ("grid", emap)):
        last = []
        before = dict(_cuda.launches)
        p50, p90, ts = percentiles(lambda pmap=pmap: last.append(
            expert.plan(pmap, head, tail, noise, pp)), args.reps, dev)
        out[name] = dict(p50=p50, p90=p90, times=ts, plan=last[-1],
                         launches=_cuda.launches_since(before))
        print(f"{name} replan B=1 ({args.profile}): p50 {p50:.1f} ms / "
              f"p90 {p90:.1f} ms", flush=True)
    return out


if __name__ == "__main__":
    main()
