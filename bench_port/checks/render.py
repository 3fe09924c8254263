"""Rendered depth frames (B4): ``depth_px_off``, the share of pixels off
by more than 1e-3 m (a ray that grazes an edge may hit on one side and
miss on the other, so the largest gap, ``depth_gap_m``, swings)."""

import torch

from harness.check import arg, blocks, lower
from reference import raycast as rraycast, types as rtypes

HOOKS = (("neoplanner_tpu_torch.sense.raycast", "render_depth_auto"),)


def read(cap, exact, low, control, system) -> dict:
    gap, off, px = None, 0, 0
    for _, args, kw, out in cap.of("render_depth_auto"):
        rs = arg(args, kw, 4, "row_stride", 1)

        def run(c):
            world = c(args[0])
            pos, quat, cam = c(args[1]), c(args[2]), c(args[3])
            return torch.cat([rraycast.render_depth(
                rtypes.BoxWorld(world.centers[s], world.half_sizes[s],
                                world.active[s], world.shape[s]),
                pos[s], quat[s], cam, rs) for s in blocks(pos.shape[0], 4)])
        ref = run(exact)
        got = lower(run(low)) if control else exact.t(out)
        d = (got - ref).abs()
        off += int((d > 1e-3).sum())
        px += d.numel()
        gap = float(d.max()) if gap is None else max(gap, float(d.max()))
    if not px:
        return {}
    return {"depth_px_off": off / px, "depth_gap_m": gap}
