"""The program's counters over the traced window.

The port's ``utils/profiling.StageTimer``, handed to every segment of the
traced window, counts the envs handed to the plan's lazy bank
(``bank.envs``) and those whose remaining lanes were solved after their
first lanes (``bank.retry_envs``).
"""

from __future__ import annotations


def window_counts(ctx):
    """{counter: total} of the timer that traced the window, or None
    where there is none: an untraced or CPU run (``ctx["stage_ms"]``
    empty: the run made no timer), or a port whose tracer keeps no
    counters. The timer is the port's ``profiling.last_timer()``, the
    one the run made last."""
    if not ctx.get("stage_ms"):
        return None
    from neoplanner_tpu_torch.utils import profiling
    last = getattr(profiling, "last_timer", None)
    timer = last() if last is not None else None
    return None if timer is None else timer.counts()
