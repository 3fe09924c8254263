#!/usr/bin/env python3
"""Drive the PyTorch port of NEO-Planner on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one short line each:
1. the card (name and power limit from nvidia-smi) and the kernels' build
   (one nvcc call over neoplanner_tpu_torch/csrc/*.cu, loaded with ctypes);
2. each hand-written kernel of the scene path against its plain PyTorch
   version on the card, at that path's shapes (B = 1024 envs), inputs from a
   numpy seed, TF32 off: max abs/rel error beside the stated tolerance,
   kernel and plain times (CUDA events, medians), the bound from bytes and
   operations;
3. the lazy bank (expert.warm_start_plan: B1 on the first lanes, then on
   the retries with a skip mask) at B = 1024 on the card against its plain
   version on the CPU;
4. a small scene loop (B = 32, 2 segments) on the card against the same
   loop on the CPU, where every kernel wrapper takes its plain version;
5. the scene path: the NEO closed loop of bench.py's flagship configuration
   at B = 1024 (scene SDF, ground-truth sensing, the smallconv PlannerNet
   from artifacts/planner_net_smallconv.onnx, random missions): one warm-up
   segment and 3 timed segments of env.step_segment, with every kernel's
   launch count, which must be above 0 for the path's kernels;
6. each kernel of the vision path against its plain version on the card at
   B = 512 (examples/profile_vision.py's map, one fused frame per segment):
   B8 v2 on rendered frames, B9 on the fused grids, B6 on windows of the
   rebuilt maps (one iteration, 24 iterations against the cost basin with a
   plain GPU-vs-CPU control, and the lazy bank with rejected first lanes on
   the card against the CPU), B10 on the sensed maps;
7. a small vision loop (B = 16, 2 segments) on the card against the CPU;
8. the vision path: the same NEO loop with depth sensing, fusion, the
   truncated ESDF, grid planning and grid tracking at B = 512, goals at
   x = 20 so that every timed segment replans: one warm-up and 3 timed
   segments, per-stage times, launch counts above 0 for the path's kernels.

The last lines are every kernel's launches over both paths, the kernels'
JSON record, the card's name and power limit, and
{"ok": true, "device": {...}}. Any failure exits non-zero before them.
The script needs one GPU and exits non-zero without a result when there is
none or when the package is missing.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

B = 1024                      # envs on the scene path
BV = 512                      # envs on the vision path
SEGMENTS = 3                  # timed segments after one warm-up
PEAK_F32 = 67e12              # H100 SXM f32 (non-tensor) FLOP/s, data sheet
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bytes/s, data sheet
# The least operations per cell of a truncated EDT of a binarized grid: the
# threshold, a two-sweep pass 1 (a compare, a select and an add per sweep),
# a linear-time lower-envelope pass 2 (~10), then sqrt, scale, clamp and
# the bf16 store. O(1) per cell: the banded kernel's loop trips over +-R
# are its own choice and are not counted.
EDT_CELL_OPS = 20
REPO = os.path.dirname(os.path.abspath(__file__))

KERNELS = {
    "lbfgs_scene_solve": dict(
        source="neoplanner_tpu_torch/csrc/lbfgs_scene.cu",
        replaces="neoplanner_tpu/plan/solve_pallas.py:223"),
    "minco_banded_solve": dict(
        source="neoplanner_tpu_torch/csrc/minco_solve.cu",
        replaces="neoplanner_tpu/ops/minco_pallas.py:37"),
    "track_segment": dict(
        source="neoplanner_tpu_torch/csrc/track.cu",
        replaces="neoplanner_tpu/sim/track_pallas.py:94"),
    "render_depth": dict(
        source="neoplanner_tpu_torch/csrc/raycast.cu",
        replaces="neoplanner_tpu/sense/raycast_pallas.py:72"),
    "lbfgs_grid_solve": dict(
        source="neoplanner_tpu_torch/csrc/lbfgs_grid.cu",
        replaces="neoplanner_tpu/plan/solve_pallas_grid.py:46"),
    "fuse_depth_dense": dict(
        source="neoplanner_tpu_torch/csrc/fusion.cu",
        replaces="neoplanner_tpu/mapping/occupancy_pallas.py:176"),
    "edt_trunc_lite": dict(
        source="neoplanner_tpu_torch/csrc/edt_trunc.cu",
        replaces="neoplanner_tpu/ops/edt_pallas.py:153"),
    "track_segment_grid": dict(
        source="neoplanner_tpu_torch/csrc/track.cu",
        replaces="neoplanner_tpu/sim/track_pallas.py:94"),
}
SCENE_PATH = ("lbfgs_scene_solve", "minco_banded_solve", "track_segment",
              "render_depth")
VISION_PATH = ("render_depth", "fuse_depth_dense", "edt_trunc_lite",
               "lbfgs_grid_solve", "minco_banded_solve", "track_segment_grid")


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def median_ms(torch, fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def givens_flops(lbw: int, n: int = 18, d: int = 2, fill: int = 6) -> int:
    """Floating-point operations of one band-restricted Givens solve."""
    f = 0
    for c in range(n):
        for _ in range(c + 1, min(c + lbw + 1, n)):
            f += 7 + 6 * ((min(c + fill + 1, n) - c) + d)
        f += d * (2 * (min(c + fill + 1, n) - c - 1) + 1)
    return f


def objective_flops(K: int, dist_flops, grad: bool):
    """Operations of one objective evaluation per problem (M = 3 pieces,
    K samples each): the system build and solve, the energy quadrature, and
    per sample the polynomial, the hinges and dist_flops for the distance
    query (~20 per live primitive of the scene SDF, ~25 for four window
    taps); with the gradient also the per-sample adjoint, the transposed
    solve and the duration chain."""
    per_sample = 50 + dist_flops + (60 if grad else 0)
    fixed = 120 + givens_flops(4) + 9 * 30
    if grad:
        fixed += givens_flops(2) + 9 * 30 + 150
    return fixed + 3 * K * per_sample


def solve_flops(K: int, dist_flops, iters: np.ndarray) -> float:
    """A solve spending iters iterations: one value-and-gradient per
    iteration plus the first, and at least one line-search value each."""
    return float(np.sum(objective_flops(K, dist_flops, True) * (1 + iters)
                        + objective_flops(K, dist_flops, False) * iters))


def err_line(got, want):
    g = got.double().cpu().numpy()
    w = want.double().cpu().numpy()
    d = np.abs(g - w)
    return float(d.max()), float((d / np.maximum(np.abs(w), 1e-6)).max())


def rel(a, b):
    return ((a - b).abs() / b.abs().clamp(min=1.0)).cpu().numpy()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from neoplanner_tpu_torch import _cuda
    except ImportError as exc:
        print(f"chip_smoke: the port is missing ({exc})", file=sys.stderr)
        return 2
    from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                             MissionParams, NetParams,
                                             PlannerParams, SimParams,
                                             WorldParams)
    from neoplanner_tpu_torch.core import frames
    from neoplanner_tpu_torch.mapping import esdf, fusion, occupancy, scene
    from neoplanner_tpu_torch.models import planner_net
    from neoplanner_tpu_torch.ops import edt, minco
    from neoplanner_tpu_torch.plan import costs, expert, solve
    from neoplanner_tpu_torch.sense import raycast
    from neoplanner_tpu_torch.sim import env, track
    from neoplanner_tpu_torch.utils.profiling import StageTimer
    from neoplanner_tpu_torch.world import scenegen

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    say(f"card: {card} ({torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda})")
    t_start = time.perf_counter()
    _cuda.load()
    nvcc_s = _cuda.build_seconds or 0.0
    say(f"build: nvcc {nvcc_s:.1f} s (0: library already built), load "
        f"{time.perf_counter() - t_start:.1f} s")

    # the flagship configuration (bench.py:101-142)
    pp = PlannerParams(max_iters=24, samples_per_piece=24, retry_num=2,
                       extra_lateral_scales=(), max_ls=4)
    mp, sp = MissionParams(), SimParams()
    mapp = MapParams(width=256, height=192, origin_x=-4.0, origin_y=-9.6)
    # the vision configuration (examples/profile_vision.py:33-71)
    mapp_v = dataclasses.replace(mapp, edt_truncation=2.0, fusion="2d_dense")
    vision = dict(sensing="depth", plan_map="grid")
    wp = WorldParams(num_boxes=10)
    npc = NetParams(img_width=160, img_height=120, motion_input_size=24,
                    output_size=9, img_feature_size=24,
                    motion_feature_size=24, backbone="smallconv",
                    fusion_arch="mlp")
    cam = CameraParams(width=npc.img_width, height=npc.img_height)
    onnx = os.path.join(REPO, "artifacts", "planner_net_smallconv.onnx")
    rng = np.random.default_rng(0)
    worlds = scenegen.generate_batch(_cuda.make_generator(0), B, wp)
    sc = scene.build(worlds, mapp)
    n_active = sc.active.sum(1).cpu().numpy()
    record = {}

    def report(name, err, tol, ms, plain_ms, flops, nbytes, library_ms=None,
               on="abs"):
        """Record a kernel; err = (max abs, a relative measure), held to
        tol on the first (on="abs") or the second (on="rel")."""
        b_ms, b_by = bound(flops, nbytes)
        record[name] = dict(name=name, route="cuda", **KERNELS[name],
                            launches=0, max_abs_err=err[0], ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=library_ms)
        ok = err[0 if on == "abs" else 1] <= tol
        say(f"{name}: max abs {err[0]:.3g}, rel {err[1]:.3g}; tol {tol:g} "
            f"({on}) {'ok' if ok else 'MISS'}; {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")

    def boundary_problems(n, start=None):
        """n planning problems from start (n, 2), by default standard normal
        around the origin, to ~5 m ahead: (head, tail, q0, ts0) on the
        card."""
        head = torch.zeros((n, 3, 2))
        tail = torch.zeros((n, 3, 2))
        head[:, 0] = (torch.from_numpy(rng.normal(size=(n, 2))).float()
                      if start is None else start.cpu())
        head[:, 1] = torch.from_numpy(rng.normal(scale=0.5,
                                                 size=(n, 2))).float()
        tail[:, 0] = head[:, 0] + torch.tensor([5.0, 0.0]) + \
            torch.from_numpy(rng.normal(size=(n, 2))).float()
        tail[:, 1] = torch.from_numpy(rng.normal(scale=0.5,
                                                 size=(n, 2))).float()
        head, tail = head.to(dev), tail.to(dev)
        q0 = expert.straight_line_wpts(head[:, 0], tail[:, 0], pp) \
            + torch.from_numpy(rng.normal(scale=0.4, size=(n, 2, 2))).float(
            ).to(dev)
        ts0 = torch.from_numpy(rng.uniform(1.0, 4.0, (n, 3))).float().to(dev)
        return head, tail, q0, ts0

    def accepted(x, head, tail, pmap, cost_pp):
        q, tau = costs.unpack(x, pp)
        cv, _ = costs.traj_costs(head, tail, q, minco.tau_to_T(
            tau, pp.t_min, pp.t_max), pmap, cost_pp)
        return cv[:, 3] * pp.w_collision <= pp.collision_cost_tol

    def window_cells_read(window, xs, head, tail):
        """Distinct window cells that the bilinear taps of one solve per
        problem read at the iterates xs (each (P, 7); problem p on window p),
        summed over problems: the least a solve that passes through those
        iterates must load. Samples outside the map read FAR, not the
        window."""
        P, Hw, Ww = window.win.shape
        taps = []
        for x in xs:
            q, tau = costs.unpack(x, pp)
            ts = minco.tau_to_T(tau, pp.t_min, pp.t_max)
            c = minco.solve_coeffs(head, tail, q, ts).reshape(
                P, ts.shape[1], 6, -1)
            t, _ = costs.piece_samples(ts, pp)
            pos = torch.einsum("nmkj,nmjd->nmkd", minco.beta(t, 0),
                               c)[..., :2].reshape(P, -1, 2)
            o = window.worg[:, None]
            u = torch.floor(torch.clamp((pos[..., 1] - o[..., 1]) / o[..., 2]
                                        - 0.5, 0.0, Hw - 1.001)).long()
            v = torch.floor(torch.clamp((pos[..., 0] - o[..., 0]) / o[..., 2]
                                        - 0.5, 0.0, Ww - 1.001)).long()
            in_map = ((pos[..., 0] >= o[..., 3]) & (pos[..., 1] >= o[..., 4])
                      & (pos[..., 0] < o[..., 5]) & (pos[..., 1] < o[..., 6]))
            for du in (0, 1):
                for dv in (0, 1):
                    taps.append(torch.where(in_map, (u + du) * Ww + v + dv,
                                            -1))
        cells = torch.sort(torch.cat(taps, 1), 1).values
        new = torch.ones_like(cells, dtype=torch.bool)
        new[:, 1:] = cells[:, 1:] != cells[:, :-1]
        return int((new & (cells >= 0)).sum())

    def basin(name, ok_k, ok_p, f_k, f_p, iters, f1_ctrl, f_ctrl, n_c):
        """Hold a 24-iteration solve to its plain version's cost basin:
        acceptance flags agree on >= 95% of problems, the median relative f
        difference is <= 1e-4 and the mean f agrees to 1%; print the plain
        GPU-vs-CPU control beside it."""
        n = ok_k.shape[0]
        agree = float((ok_k == ok_p).float().mean())
        rel_f = rel(f_k, f_p)
        mean_gap = abs(float(f_k.mean()) / float(f_p.mean()) - 1.0)
        say(f"{name} 24 iters: accepted {int(ok_k.sum())}/{n} kernel, "
            f"{int(ok_p.sum())}/{n} plain, flags agree {agree:.3f} (tol "
            f"0.95); f rel diff median {np.median(rel_f):.2e} (tol 1e-4) p99 "
            f"{np.percentile(rel_f, 99):.2e} max {rel_f.max():.2e}, mean f "
            f"gap {mean_gap:.2e} (tol 1e-2); iters mean "
            f"{float(iters.float().mean()):.1f}")
        say(f"{name} plain GPU vs CPU ({n_c} problems): f rel diff max "
            f"{f1_ctrl.max():.2e} at 1 iter; at 24 iters median "
            f"{np.median(f_ctrl):.2e} p99 {np.percentile(f_ctrl, 99):.2e} "
            f"max {f_ctrl.max():.2e}")
        if agree < 0.95 or np.median(rel_f) > 1e-4 or mean_gap > 1e-2:
            raise AssertionError(f"{name} leaves the plain version's cost "
                                 f"basin")

    def lazy_bank(name, pmap, pmap_cpu, head, tail, q0, ts0, it_first,
                  first_ok):
        """warm_start_plan on the card (the first lanes, then the retries
        with the accepted envs skipped, B5 for acceptance and coefficients)
        against its plain version on the CPU, from the solver check's
        inputs. Skip mask: the kernel is deterministic and the first launch
        repeats the solver check's 24-iteration run, so an env whose first
        lane was accepted spends exactly that run's iterations (its retries
        skipped) and a rejected env spends more (its retries live). The
        selection is held to the solver's cost basin: ok flags agree on >=
        95% of envs, the median relative cost difference of the selected
        trajectories is <= 1e-4, and the median env's waypoints and
        durations agree to 1e-2 m and 1e-2 s."""
        n = head.shape[0]
        noise = torch.from_numpy(rng.normal(size=(n, pp.retry_num, pp.dims,
                                                  pp.num_wpts))).float()
        tg = expert.warm_start_plan(pmap, head, tail, q0, ts0, noise.to(dev),
                                    pp)
        t0 = time.perf_counter()
        tc = expert.warm_start_plan(pmap_cpu, head.cpu(), tail.cpu(),
                                    q0.cpu(), ts0.cpu(), noise, pp)
        cpu_s = time.perf_counter() - t0
        extra = (tg.iters - it_first).cpu()
        first_ok = first_ok.cpu()
        skip_ok = bool((extra[first_ok] == 0).all())
        live_ok = bool((extra[~first_ok] > 0).all())
        agree_b = float((tg.ok.cpu() == tc.ok).float().mean())
        wts = costs.weights(pp, "cpu")
        rel_b = rel((tg.costs.cpu() @ wts), tc.costs @ wts)
        d_w = (tg.int_wpts.cpu() - tc.int_wpts).abs().flatten(1).amax(1)
        d_t = (tg.ts.cpu() - tc.ts).abs().amax(1)
        say(f"{name} lazy bank B={n}: {int((~first_ok).sum())} envs retried "
            f"(iters > first lane: {live_ok}), {int(first_ok.sum())} skipped "
            f"(iters = first lane: {skip_ok}); ok {int(tg.ok.sum())} card, "
            f"{int(tc.ok.sum())} CPU, agree {agree_b:.3f} (tol 0.95); cost "
            f"rel diff median {np.median(rel_b):.2e} (tol 1e-4) max "
            f"{rel_b.max():.2e}; wpts diff median {float(d_w.median()):.2e} "
            f"m max {float(d_w.max()):.3g}, ts diff median "
            f"{float(d_t.median()):.2e} s max {float(d_t.max()):.3g} (tol "
            f"1e-2 on medians); CPU {cpu_s:.1f} s")
        if int((~first_ok).sum()) == 0 or not (skip_ok and live_ok) \
                or agree_b < 0.95 or np.median(rel_b) > 1e-4 \
                or float(d_w.median()) > 1e-2 or float(d_t.median()) > 1e-2:
            raise AssertionError(f"the {name} lazy bank on the card "
                                 f"disagrees with its plain version")

    # ---- B5: banded MINCO solve, N = B systems (acceptance of lane 0)
    head, tail, q0, ts0 = boundary_problems(B)
    A, b = minco.build_system(head, tail, q0, ts0)
    aug = torch.cat([A, b], dim=2).contiguous()
    out = torch.empty((B, 18, 2), device=dev)
    minco.launch_banded_solve(aug, out, 4)
    want = minco._givens_solve(A, b, 4, 2)
    nbytes = B * (18 * 20 + 18 * 2) * 4
    report("minco_banded_solve", err_line(out, want), 1e-3,
           median_ms(torch, lambda: minco.launch_banded_solve(aug, out, 4),
                     20),
           median_ms(torch, lambda: minco._givens_solve(A, b, 4, 2), 10),
           B * givens_flops(4), nbytes,
           library_ms=median_ms(torch, lambda: torch.linalg.solve(A, b), 10))

    # ---- B4: depth frames of B drones, 160x120
    def poses(n):
        pos = torch.from_numpy(np.stack([
            rng.uniform(-1.0, 4.0, n), rng.uniform(-2.0, 2.0, n),
            rng.uniform(1.5, 2.5, n)], -1)).float().to(dev)
        acc = torch.from_numpy(rng.normal(scale=2.0, size=(n, 3))).float(
            ).to(dev)
        yaw = torch.from_numpy(rng.uniform(-0.6, 0.6, n)).float().to(dev)
        return pos, frames.quat_from_accel_yaw(acc, yaw).contiguous()

    pos, quat = poses(B)
    prims8 = raycast.pack_prims(worlds)
    depth = torch.empty((B, cam.height, cam.width), device=dev)
    raycast.launch_render(pos, quat, prims8, depth, cam)
    want = raycast.render_depth(worlds, pos, quat, cam)
    diff = (depth - want).abs()
    frac_off = float((diff > 1e-3).float().mean())
    say(f"render_depth: {frac_off:.2e} of pixels off by > 1e-3 m "
        f"(tol 1e-3: edge grazes)")
    if frac_off > 1e-3:
        raise AssertionError("render_depth disagrees with its plain version")
    pix = B * cam.height * cam.width
    flops = pix * (60 + 35 * float(worlds.active.sum()) / B)
    # held above to the share of pixels off (an edge graze flips a ray from
    # hit to miss); the largest difference is recorded as it is
    report("render_depth", (float(diff.max()), frac_off), 1e-3,
           median_ms(torch, lambda: raycast.launch_render(
               pos, quat, prims8, depth, cam), 20),
           median_ms(torch, lambda: raycast.render_depth(
               worlds, pos, quat, cam), 5),
           flops, B * (3 + 4 + 24 * 8) * 4 + pix * 4, on="rel")

    # ---- B3: one tracking segment of B envs
    def track_inputs(n, state):
        goals = torch.from_numpy(np.stack([rng.uniform(0.3, 1.0, n),
                                           rng.uniform(-0.3, 0.3, n)], -1))
        state = state.replace(goal=goals.float().to(dev))
        t = torch.arange(60, device=dev) / 60.0
        v = torch.from_numpy(rng.uniform(0.5, 1.0, n)).float().to(dev)[:, None]
        w = torch.from_numpy(rng.uniform(1.5, 3.0, n)).float().to(dev)[:, None]
        cmds = torch.stack([
            torch.stack([v * t, 0.4 * torch.sin(w * t)], -1),
            torch.stack([v.expand(n, 60), 0.4 * w * torch.cos(w * t)], -1),
            torch.stack([torch.zeros(n, 60, device=dev),
                         -0.4 * w * w * torch.sin(w * t)], -1)], dim=2)
        return state, cmds.contiguous()

    st, cmds = track_inputs(B, env.reset(worlds, pp, mp, mapp,
                                         _cuda.make_generator(1)))
    st_packed = track.pack_state(st)
    prims6 = scene.pack_prims(sc)
    tout = torch.empty((B, 18), device=dev)
    trace = torch.empty((B, 60, 5, 3), device=dev)
    track.launch_tracker(cmds, st_packed, prims6, tout, trace, pp, mp, sp)
    wd, wreach, wsteps, wmet, wmpos, wtrace = track._track_plain(
        st, cmds, pp, mp, sp)
    want = torch.cat([wd.pos, wd.vel, wd.yaw[:, None], wd.quat, wmpos, wmet,
                      wreach[:, None].float(), wsteps[:, None].float()], 1)
    err = max(err_line(tout, want), err_line(trace, wtrace))
    report("track_segment", err, 1e-3,
           median_ms(torch, lambda: track.launch_tracker(
               cmds, st_packed, prims6, tout, trace, pp, mp, sp), 20),
           median_ms(torch, lambda: track._track_plain(
               st, cmds, pp, mp, sp), 5),
           B * 60 * 200 + B * 10 * 20 * float(n_active.mean()),
           B * (60 * 6 + 22 + 24 * 6 + 18 + 60 * 15) * 4)

    # ---- B1 (+B2): the first-lane L-BFGS solve of B problems. One
    # iteration must agree to roundoff (1e-3 relative on f). Over 24
    # iterations roundoff steers individual solves onto other iterate paths
    # — the plain version on the GPU and on the CPU spread the same way — so
    # the full solve is held to the same cost basin (see basin()).
    x0 = costs.pack(q0, minco.T_to_tau(ts0, pp.t_min, pp.t_max), pp)
    x0 = x0.contiguous()
    env_of = torch.arange(B, device=dev, dtype=torch.int32)
    skip = torch.zeros(B, dtype=torch.int32, device=dev)
    sol = (torch.empty_like(x0), torch.empty(B, device=dev),
           torch.empty(B, dtype=torch.int32, device=dev))

    def plain(p):
        return solve._solve_plain(x0, head, tail, sc, env_of.long(), p)

    pp1 = dataclasses.replace(pp, max_iters=1)
    solve.launch_solver(x0, head, tail, prims6, env_of, skip, sol, pp1)
    f1 = sol[1].clone()
    _, pf1, _ = plain(pp1)
    err1 = err_line(f1, pf1)
    solve.launch_solver(x0, head, tail, prims6, env_of, skip, sol, pp)
    it24 = sol[2].clone()
    px, pf, _ = plain(pp)
    ok_k = accepted(sol[0], head, tail, sc, pp)
    ok_p = accepted(px, head, tail, sc, pp)
    # the control: the same plain solver on the CPU, first 256 problems
    n_c = min(256, B)
    sc_cpu = scene.SceneMap(*(getattr(sc, f).cpu() for f in
                              ("centers", "half", "is_cyl", "active")))

    def plain_cpu(p):
        return solve._solve_plain(x0[:n_c].cpu(), head[:n_c].cpu(),
                                  tail[:n_c].cpu(), sc_cpu,
                                  torch.arange(n_c), p)[1]

    basin("lbfgs_scene_solve", ok_k, ok_p, sol[1], pf, sol[2],
          rel(pf1[:n_c].cpu(), plain_cpu(pp1)),
          rel(pf[:n_c].cpu(), plain_cpu(pp)), n_c)
    iters = sol[2].cpu().numpy().astype(np.float64)
    report("lbfgs_scene_solve", err1, 1e-3,
           median_ms(torch, lambda: solve.launch_solver(
               x0, head, tail, prims6, env_of, skip, sol, pp), 10),
           median_ms(torch, lambda: plain(pp), 3),
           solve_flops(pp.samples_per_piece, 20 * n_active, iters),
           B * (7 * 4 + 12 * 4 + 2 * 4 + 7 * 4 + 8) + B * 24 * 6 * 4,
           on="rel")

    lazy_bank("scene", sc, sc_cpu, head, tail, q0, ts0, it24, ok_k)

    net = planner_net.load(onnx, npc, dev)
    net_cpu = planner_net.load(onnx, npc, "cpu")

    def small_loop(name, n, seed, gen_world, map_params, path):
        """n envs, 2 segments, on the card and on the CPU from the same
        worlds, goals and draws; path holds reset's sensing and plan_map.
        Segment 1 plans every env while the drones hover on the reset
        buffer; segment 2 flies those plans. Gate: the plan flags of
        segment 1 agree on >= 90% of envs (and all plan), and every drone's
        position after segment 2 is within 1e-3 m of the CPU loop's."""
        gen_c = _cuda.make_generator(seed, "cpu")
        w_c = gen_world(gen_c, n)
        w_g = type(w_c)(*(getattr(w_c, f).to(dev) for f in
                          ("centers", "half_sizes", "active", "shape")))
        s_c = env.reset(w_c, pp, mp, map_params, gen_c, **path)
        s_g = env.reset(w_g, pp, mp, map_params, _cuda.make_generator(seed),
                        goal=s_c.goal.to(dev), **path)
        s_g = s_g.replace(flap=s_c.flap.to(dev))
        for seg in range(2):
            d_c = env.draw(gen_c, n, pp)
            d_g = env.Draws(*(x.to(dev) for x in (d_c.target_noise,
                                                  d_c.bank_noise,
                                                  d_c.goal_u)))
            s_c, i_c = env.step_segment(s_c, pp, mp, sp, cam, net_cpu,
                                        draws=d_c)
            s_g, i_g = env.step_segment(s_g, pp, mp, sp, cam, net,
                                        draws=d_g)
            if seg == 0:
                n_plan = int(i_c.planned.sum())
                flags = float((i_g.ok.cpu() == i_c.ok).float().mean())
        diff = (s_g.drone.pos.cpu() - s_c.drone.pos).abs().amax(1)
        say(f"small {name} loop B={n}: segment 1 planned {n_plan}, plan flags "
            f"agree {flags:.3f} (tol 0.9); after segment 2 drone pos diff "
            f"max {float(diff.max()):.3g} m (tol 1e-3), moved "
            f"{float(s_c.drone.pos[:, :2].norm(dim=1).median()):.3g} m "
            f"(median)")
        if n_plan != n or flags < 0.9 or float(diff.max()) > 1e-3:
            raise AssertionError(f"the {name} loop on the card disagrees "
                                 f"with the plain path")

    def run_path(name, path_kernels, n, state, n_seg=SEGMENTS):
        """The loop of the path that reset chose for state: counts set to
        0, one warm-up and n_seg timed segments, counts read; returns
        (state, planned replans in the timed segments)."""
        _cuda.reset_launches()
        state, info = env.step_segment(state, pp, mp, sp, cam, net)
        warm = (int(info.planned.sum()), int(info.ok.sum()))
        planned, accepted_plans = 0, 0
        torch.cuda.synchronize()
        timer = StageTimer()
        t0 = time.perf_counter()
        for _ in range(n_seg):
            state, info = env.step_segment(state, pp, mp, sp, cam, net,
                                           timer=timer)
            planned = planned + info.planned.sum()
            accepted_plans = accepted_plans + info.ok.sum()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(_cuda.launches)
        stages = timer.ms()
        say(f"{name} loop B={n}: "
            f"{n * mp.steps_per_replan * n_seg / secs:.0f} steps/s "
            f"({secs * 1e3 / n_seg:.1f} ms/segment), missions done "
            f"{int(state.missions_done.sum())} ok "
            f"{int(state.missions_ok.sum())}, live replans ok "
            f"{int(accepted_plans)}/{int(planned)} in the timed segments, "
            f"{warm[1]}/{warm[0]} in the warm-up")
        say(f"{name} stages ms/segment: " + ", ".join(
            f"{k} {v / n_seg:.2f}" for k, v in stages.items()))
        say(f"{name} kernels: " + ", ".join(
            f"{k} {counts[k]}" for k in path_kernels))
        for k in path_kernels:
            if counts[k] <= 0:
                raise AssertionError(f"the {name} path never launched {k}")
            record[k]["launches"] += counts[k]
        finite = all(bool(torch.isfinite(t).all()) for t in (
            state.drone.pos, state.drone.vel, state.drone.quat, state.buffer,
            state.metrics))
        if not finite or state.buffer.shape != (n, env.n_buffer(pp, mp), 3,
                                                2):
            raise AssertionError(f"the {name} loop produced non-finite state")
        return state, int(planned)

    small_loop("scene", 32, 5, lambda g, n: scenegen.generate_batch(g, n, wp),
               mapp, {})
    run_path("scene", SCENE_PATH, B,
             env.reset(worlds, pp, mp, mapp, _cuda.make_generator(2)))

    # ================= the vision path: its kernels at B = BV =============
    worlds_v = scenegen.generate_batch(_cuda.make_generator(10), BV, wp)
    thr = occupancy.occ_threshold(mapp_v)
    l_quanta = torch.tensor([occupancy._l(mapp_v.prob_miss),
                             occupancy._l(mapp_v.prob_hit)])

    # ---- B8 v2: two frames per env fused into an unknown grid
    prims8_v = raycast.pack_prims(worlds_v)
    lo = occupancy.logodds_init(mapp_v, BV, dev)
    frames_v = []
    for _ in range(2):
        pos_v, quat_v = poses(BV)
        depth_v = raycast.render_depth_auto(worlds_v, pos_v, quat_v, cam)
        frames_v.append((depth_v, pos_v, quat_v))
    worst, n_off, n_upd, n_carve_off = 0.0, 0, 0, 0
    for depth_v, pos_v, quat_v in frames_v:
        tabs, sc8, hit = fusion._inputs(depth_v, pos_v, quat_v, cam, mapp_v)
        out_k = torch.empty_like(lo)
        # the carve alone (no hit cells), then carve and hits
        no_hit = torch.full_like(hit, -1)
        fusion.launch_fuse(lo, tabs, sc8, no_hit, out_k, cam, mapp_v)
        n_carve_off += int((out_k != fusion._fuse_plain(
            lo, tabs, sc8, no_hit, cam, mapp_v)).sum())
        fusion.launch_fuse(lo, tabs, sc8, hit, out_k, cam, mapp_v)
        want = fusion._fuse_plain(lo, tabs, sc8, hit, cam, mapp_v)
        d = (out_k - want).abs()
        off = d > 0
        if off.any():
            q = (d[off].cpu()[:, None] - l_quanta.abs()[None]).abs().amin(1)
            if float(q.max()) > 1e-5:
                idx = torch.nonzero(off.flatten())[:8, 0]
                is_hit = torch.isin(idx, hit.flatten())
                say("fuse_depth_dense: cells (flat index, before, kernel, "
                    "plain, hit cell): " + "; ".join(
                        f"{int(i)} {float(lo.flatten()[i]):.6g} "
                        f"{float(out_k.flatten()[i]):.6g} "
                        f"{float(want.flatten()[i]):.6g} {bool(h)}"
                        for i, h in zip(idx, is_hit)))
                raise AssertionError("fuse_depth_dense: a cell differs by "
                                     "more than one update quantum")
        worst = max(worst, float(d.max()))
        n_off += int(off.sum())
        n_upd += int((want != lo).sum())
        lo = out_k
    say(f"fuse_depth_dense: {n_off} of {n_upd} updated cells differ, each "
        f"by one l_miss/l_hit quantum (tol 1e-4 of the updated cells); the "
        f"carve alone: {n_carve_off} cells differ")
    tabs, sc8, hit = fusion._inputs(*frames_v[1], cam, mapp_v)
    lo_in = lo.clone()
    H, W = mapp_v.height, mapp_v.width
    report("fuse_depth_dense", (worst, n_off / max(n_upd, 1)), 1e-4,
           median_ms(torch, lambda: fusion.launch_fuse(
               lo_in, tabs, sc8, hit, out_k, cam, mapp_v), 20),
           median_ms(torch, lambda: fusion._fuse_plain(
               lo_in, tabs, sc8, hit, cam, mapp_v), 5),
           BV * H * W * 25 + BV * cam.width * 3,
           BV * (2 * H * W * 4 + cam.width * (4 + 8) + 8 * 4), on="rel")

    # ---- B9: the truncated ESDF of the fused grids, and of random ones
    lo_rand = torch.from_numpy(rng.uniform(-2.0, 2.0, (64, H, W))).float(
        ).to(dev)
    n_diff = 0
    for grid in (lo, lo_rand):
        field = torch.empty(grid.shape, dtype=torch.bfloat16, device=dev)
        edt.launch_edt(grid, field, thr, mapp_v.resolution,
                       mapp_v.edt_truncation)
        want = edt.edt_truncated(grid > thr, mapp_v.resolution,
                                 mapp_v.edt_truncation).to(torch.bfloat16)
        n_diff += int((field != want).sum())
    field = torch.empty(lo.shape, dtype=torch.bfloat16, device=dev)
    report("edt_trunc_lite", (float(n_diff), float(n_diff)), 0.0,
           median_ms(torch, lambda: edt.launch_edt(
               lo, field, thr, mapp_v.resolution, mapp_v.edt_truncation), 20),
           median_ms(torch, lambda: edt.edt_truncated(
               lo > thr, mapp_v.resolution, mapp_v.edt_truncation).to(
               torch.bfloat16), 5),
           lo.numel() * EDT_CELL_OPS, lo.numel() * (4 + 2))
    say(f"edt_trunc_lite: {n_diff} cells differ over {BV + 64} grids "
        f"(tol 0: bit-exact)")

    # ---- B6 (+B2): first-lane solves on windows of the rebuilt maps
    emap = esdf.ESDFMap(esdf=field, origin=torch.tensor(
        [mapp_v.origin_x, mapp_v.origin_y], device=dev),
        resolution=mapp_v.resolution)
    emap_cpu = emap.replace(esdf=emap.esdf.cpu(), origin=emap.origin.cpu())
    # problems start at the fused frames' first poses and run 5 m ahead,
    # across what those frames sensed
    head_v, tail_v, q0_v, ts0_v = boundary_problems(BV,
                                                    frames_v[0][1][:, :2])
    window = expert.make_plan_window(emap, head_v, tail_v, pp)
    x0_v = costs.pack(q0_v, minco.T_to_tau(ts0_v, pp.t_min, pp.t_max),
                      pp).contiguous()
    envs_v = torch.arange(BV, device=dev, dtype=torch.int32)
    skip_v = torch.zeros(BV, dtype=torch.int32, device=dev)
    sol_v = (torch.empty_like(x0_v), torch.empty(BV, device=dev),
             torch.empty(BV, dtype=torch.int32, device=dev))
    grid_args = (x0_v, head_v, tail_v, window.win, window.worg, envs_v,
                 skip_v, sol_v)

    def plain_grid(p, n=BV, on=dev):
        w = esdf.GridWindow(window.win[:n].to(on), window.worg[:n].to(on))
        return solve._solve_plain(x0_v[:n].to(on), head_v[:n].to(on),
                                  tail_v[:n].to(on), w,
                                  torch.arange(n, device=on), p)

    solve.launch_grid_solver(*grid_args, pp=pp1)
    f1_v = sol_v[1].clone()
    _, pf1_v, _ = plain_grid(pp1)
    err1_v = err_line(f1_v, pf1_v)
    solve.launch_grid_solver(*grid_args, pp=pp)
    it24_v = sol_v[2].clone()
    px_v, pf_v, _ = plain_grid(pp)
    near_pp = dataclasses.replace(pp, esdf_interp="nearest")
    ok_kv = accepted(sol_v[0], head_v, tail_v, emap, near_pp)
    ok_pv = accepted(px_v, head_v, tail_v, emap, near_pp)
    n_cv = min(256, BV)
    basin("lbfgs_grid_solve", ok_kv, ok_pv, sol_v[1], pf_v, sol_v[2],
          rel(pf1_v[:n_cv].cpu(), plain_grid(pp1, n_cv, "cpu")[1]),
          rel(pf_v[:n_cv].cpu(), plain_grid(pp, n_cv, "cpu")[1]), n_cv)
    iters_v = sol_v[2].cpu().numpy().astype(np.float64)
    report("lbfgs_grid_solve", err1_v, 1e-3,
           median_ms(torch, lambda: solve.launch_grid_solver(
               *grid_args, pp=pp), 10),
           median_ms(torch, lambda: plain_grid(pp), 3),
           solve_flops(pp.samples_per_piece, 25, iters_v),
           BV * (7 * 4 + 12 * 4 + 2 * 4 + 7 * 4 + 8)
           + window.worg.numel() * 4
           + 4 * window_cells_read(window, (x0_v, sol_v[0]), head_v,
                                 tail_v),
           on="rel")
    lazy_bank("grid", emap, emap_cpu, head_v, tail_v, q0_v, ts0_v, it24_v,
              ok_kv)

    # ---- B10: one grid tracking segment of BV envs on the sensed maps
    st_v = env.reset(worlds_v, pp, mp, mapp_v, _cuda.make_generator(11),
                     **vision)
    st_v, cmds_v = track_inputs(BV, st_v.replace(emap=emap))
    stv_packed = track.pack_state(st_v)
    gout = torch.empty((BV, 18), device=dev)
    gtrace = torch.empty((BV, 60, 5, 3), device=dev)
    gticks = torch.empty((BV, 60), device=dev)
    track.launch_tracker_grid(cmds_v, stv_packed, gout, gtrace, gticks, pp,
                              mp, sp)
    wd, wreach, wsteps, wmet, wmpos, wtrace, wticks = \
        track._track_grid_plain(st_v, cmds_v, pp, mp, sp)
    want = torch.cat([wd.pos, wd.vel, wd.yaw[:, None], wd.quat, wmpos, wmet,
                      wreach[:, None].float(), wsteps[:, None].float()], 1)
    err = max(err_line(gout, want), err_line(gtrace, wtrace),
              err_line(gticks, wticks))
    report("track_segment_grid", err, 1e-3,
           median_ms(torch, lambda: track.launch_tracker_grid(
               cmds_v, stv_packed, gout, gtrace, gticks, pp, mp, sp), 20),
           median_ms(torch, lambda: track._track_grid_plain(
               st_v, cmds_v, pp, mp, sp), 5),
           BV * 60 * 200, BV * (60 * 6 + 22 + 18 + 60 * 15 + 60) * 4)

    # ---- the vision loops
    small_loop("vision", 16, 6, lambda g, n: scenegen.generate_batch(g, n, wp),
               mapp_v, vision)
    goals_v = torch.stack([torch.full((BV,), 20.0), torch.from_numpy(
        rng.uniform(-1.5, 1.5, BV)).float()], 1).to(dev)
    state_v = env.reset(worlds_v, pp, mp, mapp_v, _cuda.make_generator(12),
                        goal=goals_v, **vision)
    state_v, planned_v = run_path("vision", VISION_PATH, BV, state_v)
    if planned_v <= 0:
        raise AssertionError("the vision path's timed segments replanned "
                             "no env")
    say(f"vision map: {int((state_v.logodds > thr).sum()) / BV:.0f} occupied "
        f"and {int((state_v.logodds < 0).sum()) / BV:.0f} free cells per env "
        f"(mean); total {time.perf_counter() - t_start:.1f} s")

    say("kernels: " + ", ".join(f"{k} {record[k]['launches']}"
                                for k in KERNELS))
    print(json.dumps({"kernels": [record[k] for k in KERNELS]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
