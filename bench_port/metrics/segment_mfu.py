"""closed loop: the window's counted operations (the net's convolutions and
dense layers from their shapes, B4's, B1's and B6's on this window's
inputs) over the window's wall time at the H100's f32 peak, in %."""

from counts.peaks import PEAK_F32


def read(ctx):
    flops = ctx["net_flops"] + sum(f for f, _ in ctx["work"].values())
    if flops <= 0:
        return None
    return 100.0 * flops / (ctx["window_s"] * PEAK_F32)
