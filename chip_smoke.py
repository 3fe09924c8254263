#!/usr/bin/env python3
"""Drive the PyTorch port of NEO-Planner on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one short line each:
1. the card (name and power limit from nvidia-smi) and the kernels' build
   (one nvcc call over neoplanner_tpu_torch/csrc/*.cu, loaded with ctypes);
2. each hand-written kernel against its plain PyTorch version on the card,
   at the shapes of the main path (B = 1024 envs), inputs from a numpy seed,
   TF32 off: max abs/rel error beside the stated tolerance, kernel and plain
   times (CUDA events, medians), the bound from bytes and operations;
3. the lazy bank (expert.warm_start_plan: B1 on the first lanes, then on
   the retries with a skip mask) at B = 1024 on the card against its plain
   version on the CPU;
4. a small closed loop (B = 32, 2 segments) on the card against the same
   loop on the CPU, where every kernel wrapper takes its plain version;
5. the main path: the NEO closed loop of bench.py's flagship configuration
   at B = 1024 (scene SDF, ground-truth sensing, the smallconv PlannerNet
   from artifacts/planner_net_smallconv.onnx, random missions): one warm-up
   segment and 3 timed segments of env.step_segment, with every kernel's
   launch count, which must be above 0.

The last lines are the kernels' JSON record, the card's name and power limit,
and {"ok": true, "device": {...}}. Any failure exits non-zero before them.
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

B = 1024                      # envs on the main path
SEGMENTS = 3                  # timed segments after one warm-up
PEAK_F32 = 67e12              # H100 SXM f32 (non-tensor) FLOP/s, data sheet
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bytes/s, data sheet
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
}


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


def objective_flops(K: int, n_active: np.ndarray, grad: bool) -> np.ndarray:
    """Operations of one objective evaluation per problem (M = 3 pieces,
    K samples each, n_active live primitives): the system build and solve,
    the energy quadrature, and per sample the polynomial, the hinges and
    ~20 per primitive of the SDF; with the gradient also the per-sample
    adjoint, the transposed solve and the duration chain."""
    per_sample = 50 + 20 * n_active + (60 if grad else 0)
    fixed = 120 + givens_flops(4) + 9 * 30
    if grad:
        fixed += givens_flops(2) + 9 * 30 + 150
    return fixed + 3 * K * per_sample


def err_line(got, want):
    g = got.double().cpu().numpy()
    w = want.double().cpu().numpy()
    d = np.abs(g - w)
    return float(d.max()), float((d / np.maximum(np.abs(w), 1e-6)).max())


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
    from neoplanner_tpu_torch.mapping import scene
    from neoplanner_tpu_torch.models import planner_net
    from neoplanner_tpu_torch.ops import minco
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
    t0 = time.perf_counter()
    _cuda.load()
    nvcc_s = _cuda.build_seconds or 0.0
    say(f"build: nvcc {nvcc_s:.1f} s (0: library already built), load "
        f"{time.perf_counter() - t0:.1f} s")

    # the flagship configuration (bench.py:101-142)
    pp = PlannerParams(max_iters=24, samples_per_piece=24, retry_num=2,
                       extra_lateral_scales=(), max_ls=4)
    mp, sp = MissionParams(), SimParams()
    mapp = MapParams(width=256, height=192, origin_x=-4.0, origin_y=-9.6)
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

    # ---- B5: banded MINCO solve, N = B systems (acceptance of lane 0)
    head = torch.zeros((B, 3, 2))
    tail = torch.zeros((B, 3, 2))
    head[:, 0] = torch.from_numpy(rng.normal(size=(B, 2))).float()
    head[:, 1] = torch.from_numpy(rng.normal(scale=0.5, size=(B, 2))).float()
    tail[:, 0] = head[:, 0] + torch.tensor([5.0, 0.0]) + torch.from_numpy(
        rng.normal(size=(B, 2))).float()
    tail[:, 1] = torch.from_numpy(rng.normal(scale=0.5, size=(B, 2))).float()
    head, tail = head.to(dev), tail.to(dev)
    q0 = expert.straight_line_wpts(head[:, 0], tail[:, 0], pp) \
        + torch.from_numpy(rng.normal(scale=0.4, size=(B, 2, 2))).float().to(dev)
    ts0 = torch.from_numpy(rng.uniform(1.0, 4.0, (B, 3))).float().to(dev)
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
    pos = torch.from_numpy(np.stack([
        rng.uniform(-1.0, 4.0, B), rng.uniform(-2.0, 2.0, B),
        rng.uniform(1.5, 2.5, B)], -1)).float().to(dev)
    acc = torch.from_numpy(rng.normal(scale=2.0, size=(B, 3))).float().to(dev)
    yaw = torch.from_numpy(rng.uniform(-0.6, 0.6, B)).float().to(dev)
    quat = frames.quat_from_accel_yaw(acc, yaw).contiguous()
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
    st = env.reset(worlds, pp, mp, mapp, _cuda.make_generator(1))
    goals = torch.from_numpy(np.stack([rng.uniform(0.3, 1.0, B),
                                       rng.uniform(-0.3, 0.3, B)], -1))
    st = st.replace(goal=goals.float().to(dev))
    t = torch.arange(60, device=dev) / 60.0
    v = torch.from_numpy(rng.uniform(0.5, 1.0, B)).float().to(dev)[:, None]
    w = torch.from_numpy(rng.uniform(1.5, 3.0, B)).float().to(dev)[:, None]
    cmds = torch.stack([
        torch.stack([v * t, 0.4 * torch.sin(w * t)], -1),
        torch.stack([v.expand(B, 60), 0.4 * w * torch.cos(w * t)], -1),
        torch.stack([torch.zeros(B, 60, device=dev),
                     -0.4 * w * w * torch.sin(w * t)], -1)], dim=2)
    cmds = cmds.contiguous()
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
    # the full solve is held to the same cost basin: acceptance flags agree
    # on >= 95% of problems, the median relative f difference is <= 1e-4 and
    # the mean f agrees to 1%.
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

    def accepted(x):
        q, tau = costs.unpack(x, pp)
        cv, _ = costs.traj_costs(head, tail, q, minco.tau_to_T(
            tau, pp.t_min, pp.t_max), sc, pp)
        return cv[:, 3] * pp.w_collision <= pp.collision_cost_tol

    ok_k, ok_p = accepted(sol[0]), accepted(px)
    agree = float((ok_k == ok_p).float().mean())

    def rel(a, b):
        return ((a - b).abs() / b.abs().clamp(min=1.0)).cpu().numpy()

    rel_f = rel(sol[1], pf)
    mean_gap = abs(float(sol[1].mean()) / float(pf.mean()) - 1.0)
    # the control: the same plain solver on the CPU, first 256 problems,
    # at 1 and at 24 iterations
    n_c = min(256, B)
    sc_cpu = scene.SceneMap(*(getattr(sc, f).cpu() for f in
                              ("centers", "half", "is_cyl", "active")))

    def plain_cpu(p):
        return solve._solve_plain(x0[:n_c].cpu(), head[:n_c].cpu(),
                                  tail[:n_c].cpu(), sc_cpu,
                                  torch.arange(n_c), p)[1]

    rel_c1 = rel(pf1[:n_c].cpu(), plain_cpu(pp1))
    rel_c = rel(pf[:n_c].cpu(), plain_cpu(pp))
    say(f"lbfgs_scene_solve 24 iters: accepted {int(ok_k.sum())}/{B} kernel, "
        f"{int(ok_p.sum())}/{B} plain, flags agree {agree:.3f} (tol 0.95); "
        f"f rel diff median {np.median(rel_f):.2e} (tol 1e-4) p99 "
        f"{np.percentile(rel_f, 99):.2e} max {rel_f.max():.2e}, mean f gap "
        f"{mean_gap:.2e} (tol 1e-2); iters mean "
        f"{float(sol[2].float().mean()):.1f}")
    say(f"lbfgs plain GPU vs CPU ({n_c} problems): f rel diff max "
        f"{rel_c1.max():.2e} at 1 iter; at 24 iters median "
        f"{np.median(rel_c):.2e} p99 {np.percentile(rel_c, 99):.2e} max "
        f"{rel_c.max():.2e}")
    if agree < 0.95 or np.median(rel_f) > 1e-4 or mean_gap > 1e-2:
        raise AssertionError("lbfgs_scene_solve leaves the plain version's "
                             "cost basin")
    iters = sol[2].cpu().numpy().astype(np.float64)
    flops = float(np.sum(objective_flops(pp.samples_per_piece, n_active,
                                         True) * (1 + iters)
                         + objective_flops(pp.samples_per_piece, n_active,
                                           False) * iters))
    report("lbfgs_scene_solve", err1, 1e-3,
           median_ms(torch, lambda: solve.launch_solver(
               x0, head, tail, prims6, env_of, skip, sol, pp), 10),
           median_ms(torch, lambda: plain(pp), 3),
           flops, B * (7 * 4 + 12 * 4 + 2 * 4 + 7 * 4 + 8) + B * 24 * 6 * 4,
           on="rel")

    # ---- the lazy bank: warm_start_plan on the card (B1 on the first
    # lanes, then B1 on the retries with the accepted envs skipped, B5 for
    # acceptance and coefficients) against its plain version on the CPU,
    # from B1's inputs. Skip mask: the kernel is deterministic and the first
    # launch repeats B1's 24-iteration run, so an env whose first lane was
    # accepted spends exactly that run's iterations (its retries skipped)
    # and a rejected env spends more (its retries live). The selection is
    # held to the solver's cost basin as B1 is: ok flags agree on >= 95% of
    # envs, the median relative cost difference of the selected
    # trajectories is <= 1e-4, and the median env's waypoints and durations
    # agree to 1e-2 m and 1e-2 s.
    noise = torch.from_numpy(rng.normal(size=(B, pp.retry_num, pp.dims,
                                              pp.num_wpts))).float()
    tg = expert.warm_start_plan(sc, head, tail, q0, ts0, noise.to(dev), pp)
    t0 = time.perf_counter()
    tc = expert.warm_start_plan(sc_cpu, head.cpu(), tail.cpu(), q0.cpu(),
                                ts0.cpu(), noise, pp)
    cpu_s = time.perf_counter() - t0
    extra = (tg.iters - it24).cpu()
    first_ok = ok_k.cpu()
    skip_ok = bool((extra[first_ok] == 0).all())
    live_ok = bool((extra[~first_ok] > 0).all())
    agree_b = float((tg.ok.cpu() == tc.ok).float().mean())
    wts = costs.weights(pp, "cpu")
    rel_b = rel((tg.costs.cpu() @ wts), tc.costs @ wts)
    d_w = (tg.int_wpts.cpu() - tc.int_wpts).abs().flatten(1).amax(1)
    d_t = (tg.ts.cpu() - tc.ts).abs().amax(1)
    say(f"lazy bank B={B}: {int((~first_ok).sum())} envs retried (iters "
        f"> first lane: {live_ok}), {int(first_ok.sum())} skipped (iters = "
        f"first lane: {skip_ok}); ok {int(tg.ok.sum())} card, "
        f"{int(tc.ok.sum())} CPU, agree {agree_b:.3f} (tol 0.95); cost rel "
        f"diff median {np.median(rel_b):.2e} (tol 1e-4) max "
        f"{rel_b.max():.2e}; wpts diff median {float(d_w.median()):.2e} m "
        f"max {float(d_w.max()):.3g}, ts diff median "
        f"{float(d_t.median()):.2e} s max {float(d_t.max()):.3g} (tol 1e-2 "
        f"on medians); CPU {cpu_s:.1f} s")
    if not (skip_ok and live_ok) or agree_b < 0.95 \
            or np.median(rel_b) > 1e-4 or float(d_w.median()) > 1e-2 \
            or float(d_t.median()) > 1e-2:
        raise AssertionError("the lazy bank on the card disagrees with its "
                             "plain version")

    net = planner_net.load(onnx, npc, dev)
    net_cpu = planner_net.load(onnx, npc, "cpu")

    # ---- a small closed loop on the card against the CPU (plain versions)
    Bs = 32
    gen_c = _cuda.make_generator(5, "cpu")
    w_c = scenegen.generate_batch(gen_c, Bs, wp)
    w_g = type(w_c)(*(getattr(w_c, f).to(dev) for f in
                      ("centers", "half_sizes", "active", "shape")))
    s_c = env.reset(w_c, pp, mp, mapp, gen_c)
    s_g = env.reset(w_g, pp, mp, mapp, _cuda.make_generator(5),
                    goal=s_c.goal.to(dev))
    s_g = s_g.replace(flap=s_c.flap.to(dev))
    # segment 1 plans every env while the drones hover on the reset buffer;
    # segment 2 flies those plans. Gate: the plan flags of segment 1 agree
    # on >= 90% of envs, and every drone's position after segment 2 is
    # within 1e-3 m of the CPU loop's
    for seg in range(2):
        d_c = env.draw(gen_c, Bs, pp)
        d_g = env.Draws(*(x.to(dev) for x in (d_c.target_noise,
                                              d_c.bank_noise, d_c.goal_u)))
        s_c, i_c = env.step_segment(s_c, pp, mp, sp, cam, net_cpu, draws=d_c)
        s_g, i_g = env.step_segment(s_g, pp, mp, sp, cam, net, draws=d_g)
        if seg == 0:
            n_plan = int(i_c.planned.sum())
            flags = float((i_g.ok.cpu() == i_c.ok).float().mean())
    diff = (s_g.drone.pos.cpu() - s_c.drone.pos).abs().amax(1)
    say(f"small loop B={Bs}: segment 1 planned {n_plan}, plan flags agree "
        f"{flags:.3f} (tol 0.9); after segment 2 drone pos diff max "
        f"{float(diff.max()):.3g} m (tol 1e-3), moved "
        f"{float(s_c.drone.pos[:, :2].norm(dim=1).median()):.3g} m (median)")
    if n_plan != Bs or flags < 0.9 or float(diff.max()) > 1e-3:
        raise AssertionError("the closed loop on the card disagrees with the "
                             "plain path")

    # ---- the main path: B envs, one warm-up and SEGMENTS timed segments
    state = env.reset(worlds, pp, mp, mapp, _cuda.make_generator(2))
    _cuda.reset_launches()
    state, info = env.step_segment(state, pp, mp, sp, cam, net)
    warm = (int(info.planned.sum()), int(info.ok.sum()))
    planned, accepted_plans = 0, 0
    torch.cuda.synchronize()
    timer = StageTimer()
    t0 = time.perf_counter()
    for _ in range(SEGMENTS):
        state, info = env.step_segment(state, pp, mp, sp, cam, net,
                                       timer=timer)
        planned = planned + info.planned.sum()
        accepted_plans = accepted_plans + info.ok.sum()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(_cuda.launches)
    stages = timer.ms()
    say(f"closed loop B={B}: {B * mp.steps_per_replan * SEGMENTS / secs:.0f} "
        f"steps/s ({secs * 1e3 / SEGMENTS:.1f} ms/segment), missions done "
        f"{int(state.missions_done.sum())} ok {int(state.missions_ok.sum())}, "
        f"live replans ok {int(accepted_plans)}/{int(planned)} in the timed "
        f"segments, {warm[1]}/{warm[0]} in the warm-up")
    say("stages ms/segment: " + ", ".join(
        f"{k} {stages.get(k, 0.0) / SEGMENTS:.2f}"
        for k in ("render", "net", "plan", "track")))
    say("kernels: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    for name in KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"the main path never launched {name}")
        record[name]["launches"] = counts[name]
    finite = all(bool(torch.isfinite(t).all()) for t in (
        state.drone.pos, state.drone.vel, state.drone.quat, state.buffer,
        state.metrics))
    if not finite or state.buffer.shape != (B, env.n_buffer(pp, mp), 3, 2):
        raise AssertionError("the closed loop produced non-finite state")

    print(json.dumps({"kernels": [record[k] for k in KERNELS]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
