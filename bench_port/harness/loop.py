"""The system under test, built from a cell's files and driven through
its window.

Everything the port is asked to do is here: its parameter objects from the
configuration's JSON, the worlds and weights of :mod:`harness.inputs`
handed to it, ``env.reset``, the warm-up segments and the measured window
of ``env.step_segment``. The configuration and the mix are data: no cell,
mix or metric is known here by name.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from functools import partial

import torch

from harness import inputs


@dataclass
class System:
    """One cell's program objects: its net and weights, state and step."""

    net: object
    weights: dict
    state: object
    step: object              # step(state, timer=None) -> (state, info)
    envs: int
    steps_per_segment: int


def _params(cls, values: dict):
    """cls(**values) with JSON lists turned into the tuples the frozen
    dataclasses hold."""
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in values.items()}
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(kw) - names
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    return cls(**kw)


def net_shapes(net_cfg: dict) -> dict:
    """{name: shape} of the plain reference net's state dict, built on the
    meta device (no memory, no compute)."""
    from reference.config import NetParams
    from reference.planner_net import PlannerNet
    with torch.device("meta"):
        ref = PlannerNet(_params(NetParams, net_cfg))
    return {k: tuple(v.shape) for k, v in ref.state_dict().items()}


def seeded_weights(net_cfg: dict, cam_cfg: dict, world: dict, seed: int,
                   device, adjust: dict = None) -> dict:
    """The net's weights from the seed (inputs.net_weights), with each
    BatchNorm's running statistics set to those of its input on depth
    frames that the plain reference renders in the first 16 worlds from
    poses drawn from the seed, as training would leave them: so the
    seeded net's activations keep a trained net's scale (unnormalized, a
    640 x 480 frame in [0, 255] drives a ResNet-18's outputs to hundreds of
    meters). ``adjust`` (the configuration's ``seeded_net``) then scales
    tensors ({"scale": {name: factor}}) and adds offsets ({"offset":
    {name: values}}): the configurations center the head's outputs on the
    expert's seed, so that the seeded net predicts what a trained one
    would on average."""
    from reference import config as rconfig, data as rdata, frames, raycast
    from reference.planner_net import PlannerNet as RefNet
    from reference.resnet import BatchNorm
    from reference.types import BoxWorld as RefWorld

    gen = inputs.generator(seed, 2, device)
    weights = inputs.net_weights(net_shapes(net_cfg), gen)
    n = min(16, world["centers"].shape[0])

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=device)
    pos = torch.stack([u(-1.0, 10.0), u(-3.0, 3.0),
                       torch.full((n,), 2.0, device=device)], -1)
    quat = frames.quat_from_yaw(u(-0.5, 0.5))
    cam = _params(rconfig.CameraParams, cam_cfg)
    depth = raycast.render_depth(
        RefWorld(*(world[k][:n] for k in ("centers", "half_sizes", "active",
                                          "shape"))), pos, quat, cam)
    net = RefNet(_params(rconfig.NetParams, net_cfg))
    net.load_state_dict(weights, strict=True)
    net = net.to(device).eval()

    def calibrate(mod, args):
        var, mean = torch.var_mean(args[0], dim=(0, 2, 3), correction=0)
        mod.running_mean.copy_(mean)
        mod.running_var.copy_(var)
    hooks = [m.register_forward_pre_hook(calibrate) for m in net.modules()
             if isinstance(m, BatchNorm)]
    conv, mm = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            net.img_backbone(rdata.normalize_depth(depth)[:, None])
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm
        for h in hooks:
            h.remove()
    state = net.state_dict()
    for k in weights:
        if k.endswith(("running_mean", "running_var")):
            weights[k] = state[k].detach().clone()
    adjust = adjust or {}
    for k, f in adjust.get("scale", {}).items():
        weights[k] = weights[k] * f
    for k, v in adjust.get("offset", {}).items():
        weights[k] = weights[k] + torch.tensor(v, dtype=weights[k].dtype,
                                               device=device)
    return weights


def build(cell, seed: int, device) -> System:
    """The cell's system on ``device``, reset from the seed's worlds,
    weights and generator."""
    from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                             MissionParams, NetParams,
                                             PlannerParams, SimParams)
    from neoplanner_tpu_torch.core.types import BoxWorld
    from neoplanner_tpu_torch.models.planner_net import PlannerNet
    from neoplanner_tpu_torch.sim import env

    cfg, mix = cell.config, cell.traffic
    pp = _params(PlannerParams, cfg["planner_params"])
    mp = _params(MissionParams, cfg["mission"])
    sp = _params(SimParams, cfg.get("sim", {}))
    mapp = _params(MapParams, cfg["map"])
    cam = _params(CameraParams, cfg["camera"])
    B = int(cfg["envs"])
    world = inputs.worlds(inputs.generator(seed, 1, device), B, mix["world"])
    net, weights = None, {}
    if cfg.get("net"):
        weights = seeded_weights(cfg["net"], cfg["camera"], world, seed,
                                 device, cfg.get("seeded_net"))
        net = PlannerNet(_params(NetParams, cfg["net"]))
        net.load_state_dict(weights, strict=True)
        net = net.to(device).eval()
    state = env.reset(BoxWorld(**world), pp, mp, mapp,
                      inputs.generator(seed, 3, device),
                      sensing=cfg["sensing"], plan_map=cfg["plan_map"])
    step = partial(env.step_segment, pp=pp, mp=mp, sp=sp, cam=cam, net=net,
                   fuse_frames=int(cfg.get("fuse_frames", 1)),
                   planner=cfg["planner"], solver=cfg.get("solver", "fused"),
                   mission_mode=mix["mission_mode"],
                   replan_mode=mix["replan_mode"])
    return System(net, weights, state,
                  lambda s, timer=None: step(s, timer=timer), B,
                  mp.steps_per_replan)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Window:
    segments: int = 0
    wall_s: float = 0.0
    segment_ms: list = field(default_factory=list)
    missions_done: int = 0
    missions_ok: int = 0
    missions_broken: int = 0
    iters: int = 0
    plans: int = 0
    captured: bool = False


def _totals(state):
    return (int(state.missions_done.sum()), int(state.missions_ok.sum()),
            int(state.iter_sum.to(torch.int64).sum()),
            int(state.plan_count.to(torch.int64).sum()))


def _broken(state, done_before) -> int:
    """The missions ended in the window by a drone whose state or mission
    metrics are not finite at its close: flights the program could not
    carry out. (A drone gone non-finite stays so: missions end and goals
    change, the drone is never reset.)"""
    d = state.drone
    flat = torch.cat([d.pos, d.vel, d.quat, d.yaw[:, None],
                      state.metrics], 1)
    bad = ~torch.isfinite(flat).all(1)
    return int((state.missions_done - done_before)[bad].sum())


def run_window(system: System, seconds: float, device, capture,
               arm_fraction: float, timer=None) -> Window:
    """Segments of ``system.step`` until ``seconds`` of wall time have
    passed, the last one ending in a synchronize. The segment that starts
    once ``arm_fraction`` of the window has passed is captured for the
    check. A CUDA event at each segment boundary times each segment on the
    device's clock."""
    cuda = device.type == "cuda"
    state = system.state
    _sync(device)
    before = _totals(state)
    done_before = state.missions_done.clone()
    events = []
    t0 = time.perf_counter()
    if cuda:
        events.append(torch.cuda.Event(enable_timing=True))
        events[0].record()
    arm_at = t0 + arm_fraction * seconds
    win = Window()
    while True:
        arm = not win.captured and time.perf_counter() >= arm_at
        if arm:
            capture.arm()
        state, _ = system.step(state, timer=timer)
        if arm:
            capture.disarm()
            win.captured = True
        if cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        win.segments += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    win.wall_s = time.perf_counter() - t0
    system.state = state
    after = _totals(state)
    win.missions_done = after[0] - before[0]
    win.missions_ok = after[1] - before[1]
    win.missions_broken = _broken(state, done_before)
    win.iters = after[2] - before[2]
    win.plans = after[3] - before[3]
    if cuda:
        win.segment_ms = [a.elapsed_time(b) for a, b in
                          zip(events[:-1], events[1:])]
    return win


def warm_up(system: System, segments: int, device) -> None:
    """``segments`` segments of the cell's own shapes (the kernels' first
    launches, cuDNN's first calls), ending in a synchronize."""
    state = system.state
    for _ in range(segments):
        state, _ = system.step(state)
    _sync(device)
    system.state = state
