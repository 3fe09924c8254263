"""net: the net's counted operations over the window (its convolutions and
dense layers from their shapes) over the StageTimer's 'net' device time at
the H100's f32 peak, in %."""

from counts.peaks import PEAK_F32


def read(ctx):
    ms = ctx["stage_ms"].get("net")
    if not ms or ctx["net_flops"] <= 0:
        return None
    return 100.0 * ctx["net_flops"] / (ms / 1e3 * PEAK_F32)
