"""device: 1 - the union of the kernels' and copies' intervals over the
traced window, in %."""


def read(ctx):
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
