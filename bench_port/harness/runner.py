"""One run of one cell: set-up, the window, the traced readings and the
check, as the result line's fields."""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from harness import check, inputs, loop, trace
from harness.capture import Capture
from harness.cells import metric_reader

# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "neoplanner_tpu")


class ForbiddenImport(RuntimeError):
    """JAX or the JAX package was loaded in the run."""


def forbidden_modules() -> list:
    """The forbidden top-level names in sys.modules, compared whole
    (``neoplanner_tpu_torch`` is not ``neoplanner_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _arm_fraction(seed: int) -> float:
    """Where in the window the checked segment starts: 0.2 to 0.8 of it,
    drawn from the seed."""
    return 0.2 + 0.6 * (inputs.sub_seed(seed, 5) / float(1 << 63))


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _p90(values):
    return float(np.percentile(values, 90)) if values else None


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             marks: list, control: bool = False,
             witness: bool = False) -> dict:
    """Run ``cell`` once; returns the result line's fields (without
    printing). ``marks`` holds (name, host clock) pairs of the set-up so
    far, the process's start first. ``control`` adds the control's
    readings of the same segment (the reference in the precision below in
    the program's place), ``witness`` the bank's reference on the CPU
    against the same on the device; neither changes ``correct``."""
    marks = list(marks)
    t_start = marks[0][1]
    cuda = device.type == "cuda"
    from neoplanner_tpu_torch import _cuda
    from neoplanner_tpu_torch.utils.profiling import StageTimer
    marks.append(("port", time.perf_counter()))
    if cuda:
        torch.zeros(1, device=device)
    marks.append(("cuda_context", time.perf_counter()))

    cfg, mix = cell.config, cell.traffic
    if cuda:
        _cuda.prebuild((int(cfg["planner_params"].get("num_pieces", 3)),))
    marks.append(("build", time.perf_counter()))
    system = loop.build(cell, seed, device)
    marks.append(("inputs_reset", time.perf_counter()))
    layers = cfg["check"]["layers"]
    capture = Capture()
    capture.install(system.net, check.hooks(layers))
    try:
        loop.warm_up(system, int(mix["warmup_segments"]), device)
        marks.append(("warm_up", time.perf_counter()))
        setup_s = time.perf_counter() - t_start
        timer = StageTimer() if traced and cuda else None
        prof = None
        if traced:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            capture.trace = True
        t0_ns = time.time_ns()
        win = loop.run_window(system, seconds, device, capture,
                              _arm_fraction(seed), timer)
        t1_ns = time.time_ns()
        capture.trace = False
        if prof is not None:
            prof.__exit__(None, None, None)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        bad = forbidden_modules()
        if bad:
            raise ForbiddenImport(f"loaded in the run: {bad}")
        system.state = None
        if cuda:
            torch.cuda.empty_cache()

        per_layer, breakdown, dev_extra = {}, None, {}
        if traced:
            readings = (trace.device_readings(prof, t0_ns, t1_ns) if cuda
                        else dict(busy_s=0.0, kernel_s={},
                                  kernel_launches={}, breakdown=None))
            work = trace.window_work(capture, cfg, win.segments, system.envs)
            window_s = (t1_ns - t0_ns) / 1e9
            ctx = dict(segments=win.segments, window_s=window_s,
                       stage_ms=timer.ms() if timer else {},
                       busy_s=readings["busy_s"], device=readings,
                       iters=win.iters, plans=win.plans, **work)
            prof = None
            for m in cell.per_layer:
                v = metric_reader(m["name"])(ctx)
                if v is not None:
                    per_layer[m["name"]] = {"value": float(v),
                                            "unit": m["unit"]}
            breakdown = readings["breakdown"]
            dev_extra = dict(busy_s=readings["busy_s"], window_s=window_s)

        t_check = time.perf_counter()
        idx = check.sample(system.envs, int(cfg["check"]["envs"]), seed)
        values, missing, extra = {}, list(layers), {}
        if win.captured:
            values, missing = check.readings(capture, system, idx, layers)
        check_s = time.perf_counter() - t_check
        if control and win.captured:
            extra["control"] = check.readings(capture, system, idx, layers,
                                              control=True)[0]
        if witness and win.captured:
            extra["witness"] = check.witness(capture, system, idx)
    finally:
        capture.close()
    correct, rows = check.judge(values, cfg["check"]["limits"])
    correct = correct and not missing

    spr = system.steps_per_segment
    e2e = {"sim_steps_per_s": system.envs * spr * win.segments / win.wall_s,
           "segment_ms_p90": _p90(win.segment_ms),
           "setup_s": setup_s}
    if traced:
        metrics = per_layer
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if e2e.get(m["name"]) is not None}
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": int(peak), **dev_extra}
    if cuda:
        device_info["power_limit_w"] = _power_limit()
    out = {"correct": bool(correct),
           "attempted": int(win.missions_done),
           "failed": int(win.missions_broken),
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["segments"] = win.segments
    out["missions"] = {"ended": int(win.missions_done),
                       "missed_bar": int(win.missions_done - win.missions_ok)}
    out["setup_parts_s"] = {b[0]: b[1] - a[1] for a, b in zip(marks[:-1],
                                                              marks[1:])}
    out["check_s"] = check_s
    out["readings"] = {k: v for k, v in values.items()
                       if k not in cfg["check"]["limits"]}
    out["layers_missing"] = missing
    out.update(extra)
    out["check"] = {name: {"value": v, "limit": lim}
                    for name, v, lim in rows}
    return out


def check_lines(result: dict) -> list:
    """The layers whose reader found no call of its entries, then the
    numbers compared, each beside its limit, one line each."""
    return ([f"check layer {layer}: the captured segment made no call of "
             f"its entries" for layer in result["layers_missing"]]
            + [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
               for name, c in result["check"].items()])

