"""The traced run's readings: the device's busy time and idle gaps from
``torch.profiler``'s events (read in memory, no trace file), each kernel's
time, and the work the window's inputs needed, counted by ``counts/``.

Busy time is the union of the kernels' and copies' intervals on the
device's timeline, clipped to the window: overlapping kernels count once.
An idle gap is labelled by the innermost ``bench.*`` span that the harness
had open on the host at the gap's middle (:mod:`harness.capture`), or
"step" where the host was in the loop's own code between them.
"""

from __future__ import annotations

import bisect

import torch

from counts import kernels as kcounts
from counts.peaks import bound_s
from counts.resnet import planner_net_flops
from reference import raycast as rraycast
from reference import types as rtypes

# the kernels' symbols, by the name the metrics give them
KERNELS = {"render_depth": "render_depth_kernel",
           "lbfgs_scene_solve": "lbfgs_scene_kernel",
           "lbfgs_grid_solve": "lbfgs_grid_kernel"}


def _device_events(kineto, t0: int, t1: int):
    """(name, start_ns, end_ns) of the device's kernels and copies,
    clipped to [t0, t1] (the ranges that user annotations span on the
    device left out)."""
    out = []
    for e in kineto.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA \
                or e.is_user_annotation():
            continue
        s, f = e.start_ns(), e.end_ns()
        s, f = max(s, t0), min(f, t1)
        if f > s:
            out.append((e.name(), s, f))
    return out


def _host_spans(kineto):
    """(start_ns, end_ns, name) of the harness's host spans."""
    spans = []
    for e in kineto.events():
        if e.device_type() == torch.autograd.DeviceType.CPU \
                and e.name().startswith("bench."):
            spans.append((e.start_ns(), e.end_ns(), e.name()[6:]))
    return sorted(spans)


def _union(intervals):
    merged = []
    for s, f in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], f)
        else:
            merged.append([s, f])
    return merged


def _label(spans, starts, t: int) -> str:
    """The innermost span open at host time t."""
    best = None
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        s, f, name = spans[i]
        if f >= t:
            best = name
            break
        if t - s > 60e9:
            break
    return best or "step"


def device_readings(prof, t0: int, t1: int) -> dict:
    """busy_s, per-kernel seconds and launches, and the breakdown."""
    kineto = prof.profiler.kineto_results
    dev = _device_events(kineto, t0, t1)
    merged = _union([(s, f) for _, s, f in dev])
    busy = sum(f - s for s, f in merged) / 1e9
    by_name, launches = {}, {}
    for name, s, f in dev:
        by_name[name] = by_name.get(name, 0.0) + (f - s) / 1e9
        launches[name] = launches.get(name, 0) + 1
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    spans = _host_spans(kineto)
    starts = [s for s, _, _ in spans]
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[_label(spans, starts, (a + b) // 2), (b - a) / 1e9]
            for a, b in gaps[:10]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy, kernel_s=by_name, kernel_launches=launches,
                breakdown={"device_ops": [[n[:120], s] for n, s in top],
                           "idle_gaps": idle})


def kernel_seconds(readings: dict, metric_kernel: str) -> float:
    sym = KERNELS[metric_kernel]
    return sum(s for n, s in readings["kernel_s"].items() if sym in n)


def _render_work(rec, block_bytes: float = 1.5e9):
    """B4's counted (flops, bytes) of one render call."""
    world, pos, quat, cam = rec["world"], rec["pos"], rec["quat"], rec["cam"]
    rs = rec["row_stride"]
    rows = rraycast.out_rows(cam, rs)
    K = world.centers.shape[1]
    per_env = max(1, pos[0].numel() // 3) * ((rows + rraycast.TILE_H - 1)
                                            // rraycast.TILE_H) \
        * ((cam.width + rraycast.TILE_W - 1) // rraycast.TILE_W) \
        * K * 5 * 3 * 4
    step = max(1, int(block_bytes // per_env))
    flops = nbytes = 0.0
    for a in range(0, pos.shape[0], step):
        s = slice(a, a + step)
        w = rtypes.BoxWorld(world.centers[s], world.half_sizes[s],
                            world.active[s], world.shape[s])
        kept = rraycast.tile_cull(w, pos[s], quat[s], cam, rs)
        f, b = kcounts.render_work(kept, rows, cam.width, K,
                                   (rraycast.TILE_H, rraycast.TILE_W))
        flops += f
        nbytes += b
    return flops, nbytes


def _solve_work(name, rec):
    """B1's or B6's counted (flops, bytes) of one launch: solve_flops at
    each solved problem's iterations (a skipped problem's warp exits at
    once), and each solved problem's inputs and outputs (and each window
    or primitive table once) as bytes."""
    env_of, pp, skip = rec["env_of"], rec["pp"], rec["skip"]
    solved = (torch.ones_like(env_of, dtype=torch.bool) if skip is None
              else ~skip.to(torch.bool))
    iters = rec["iters"][solved].to(torch.int64)
    env_of = env_of[solved]
    M, K = pp.num_pieces, pp.samples_per_piece
    if name == "solve_scene":
        scene = rec["scene"]
        live = scene.active.sum(1)[env_of.long()].to(torch.int64)
        flops = 0.0
        for n_live in torch.unique(live).tolist():
            flops += kcounts.solve_flops(K, 20 * n_live,
                                         iters[live == n_live].cpu().numpy(),
                                         M)
        extra = scene.centers.shape[0] * scene.centers.shape[1] * 6 * 4
    else:
        flops = kcounts.solve_flops(K, 25, iters.cpu().numpy(), M)
        extra = rec["window_cells"] * 4
    nbytes = int(solved.sum()) * (2 * rec["n_vars"] + 12 + 4) * 4 + extra
    return flops, nbytes


def window_work(capture, config: dict, segments: int, envs: int) -> dict:
    """The window's counted work: {metric kernel: (flops, bytes)} and the
    net's operations."""
    work = {}
    for name, rec in capture.counted:
        if name == "render_depth_auto":
            key, (f, b) = "render_depth", _render_work(rec)
        else:
            key = "lbfgs_scene_solve" if name == "solve_scene" \
                else "lbfgs_grid_solve"
            f, b = _solve_work(name, rec)
        pf, pb = work.get(key, (0.0, 0.0))
        work[key] = (pf + f, pb + b)
    net = (planner_net_flops(config["net"]) * envs * segments
           if config.get("net") else 0.0)
    return dict(work=work, net_flops=float(net))


def roofline_pct(work, kernel_s: float):
    """100 x the least time over the kernel's time, or None where the
    kernel did not run."""
    if kernel_s <= 0 or work is None:
        return None
    return 100.0 * bound_s(*work) / kernel_s

