"""mapping: the StageTimer's device time of the stage 'esdf' (step_segment's
timer=), per segment of the window, in ms."""


def read(ctx):
    ms = [ctx["stage_ms"][s] for s in ("esdf",) if s in ctx["stage_ms"]]
    return sum(ms) / ctx["segments"] if ms else None
