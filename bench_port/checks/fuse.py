"""Fused log-odds (B8 v2/v3): ``fuse_cells_off``, the share of cells that
differ by more than 1e-3, and the largest gap, ``fuse_gap``."""

import torch

from harness.check import arg, blocks, lower
from reference import fusion as rfusion

HOOKS = (("neoplanner_tpu_torch.mapping.fusion", "insert_depth_2d_dense"),
         ("neoplanner_tpu_torch.mapping.fusion",
          "insert_depth_2d_dense_multi"))


def read(cap, exact, low, control, system) -> dict:
    off, cells, gap = 0, 0, None
    for name, args, kw, out in cap.of(*(h[1] for h in HOOKS)):
        fn = getattr(rfusion, name)
        rs = arg(args, kw, 6, "row_stride", 1)

        def run(c):
            grid, depth, pos, quat = (c(args[0]), c(args[1]), c(args[2]),
                                      c(args[3]))
            return torch.cat([fn(grid[s], depth[s], pos[s], quat[s],
                                 c(args[4]), c(args[5]), row_stride=rs)
                              for s in blocks(grid.shape[0], 64)])
        ref = run(exact)
        got = lower(run(low)) if control else exact.t(out)
        d = (got - ref).abs()
        off += int((d > 1e-3).sum())
        cells += d.numel()
        gap = float(d.max()) if gap is None else max(gap, float(d.max()))
    if not cells:
        return {}
    return {"fuse_cells_off": off / cells, "fuse_gap": gap}
