"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit)."""

PEAK_F32 = 67e12        # FLOP/s, float32 outside the tensor cores
PEAK_BYTES = 3.35e12    # HBM3 bytes/s


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the f32 peak and bytes over the memory bandwidth."""
    return max(flops / PEAK_F32, nbytes / PEAK_BYTES)
