"""kernels: B1 (lbfgs_scene_kernel)'s share of its roofline: the least time its counted work on
this window's inputs could take on the H100 (counts/) over its device time
in the trace, in %."""

from harness.trace import kernel_seconds, roofline_pct


def read(ctx):
    return roofline_pct(ctx["work"].get("lbfgs_scene_solve"),
                        kernel_seconds(ctx["device"], "lbfgs_scene_solve"))
