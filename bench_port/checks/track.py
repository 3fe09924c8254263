"""The tracked drone states of every tracking chunk (B3/B10):
``track_gap_m``, the largest gap of the positions and the trace, in m and
m/s."""

from harness.check import arg, lower
from reference import track as rtrack

HOOKS = (("neoplanner_tpu_torch.sim.track", "track_segment"),
         ("neoplanner_tpu_torch.sim.track", "track_segment_grid"))


def read(cap, exact, low, control, system) -> dict:
    gap = None
    for name, args, kw, out in cap.of(*(h[1] for h in HOOKS)):
        fn = getattr(rtrack, name)
        i0 = arg(args, kw, 5, "i0", 0)

        def run(c):
            return fn(*(c(a) for a in args[:5]), i0=i0)
        ref = run(exact)
        if control:
            o = run(low)
            got_pos, got_trace = lower(o[0].pos), lower(o[5])
        else:
            got_pos, got_trace = exact.t(out[0].pos), exact.t(out[5])
        g = max(float((got_trace - ref[5]).abs().max()),
                float((got_pos - ref[0].pos).abs().max()))
        gap = g if gap is None else max(gap, g)
    return {} if gap is None else {"track_gap_m": gap}
