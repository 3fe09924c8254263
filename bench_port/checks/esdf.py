"""The truncated lite ESDF (B9 fused): ``esdf_gap_m``, the largest gap in
m. The control stores it in float8 (e4m3), the precision below the
program's bfloat16."""

import torch

from harness.check import lower
from reference import edt as redt

HOOKS = (("neoplanner_tpu_torch.ops.edt", "rebuild_truncated_lite"),)


def read(cap, exact, low, control, system) -> dict:
    gap = None
    for _, args, kw, out in cap.of("rebuild_truncated_lite"):
        def run(c):
            return redt.rebuild_truncated_lite(c(args[0]), *args[1:4]).float()
        ref = run(exact)
        got = (lower(run(low), torch.float8_e4m3fn) if control
               else exact.t(out).float())
        g = float((got - ref).abs().max())
        gap = g if gap is None else max(gap, g)
    return {} if gap is None else {"esdf_gap_m": gap}
