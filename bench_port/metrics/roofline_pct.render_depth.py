"""kernels: B4 (render_depth_kernel)'s share of its roofline: the least time its counted work on
this window's inputs could take on the H100 (counts/) over its device time
in the trace, in %."""

from harness.trace import kernel_seconds, roofline_pct


def read(ctx):
    return roofline_pct(ctx["work"].get("render_depth"),
                        kernel_seconds(ctx["device"], "render_depth"))
