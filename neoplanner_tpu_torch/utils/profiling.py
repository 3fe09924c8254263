"""Per-stage timing of the closed loop with CUDA events.

A :class:`StageTimer` passed down the loop records a start and an end event
around each named stage on the current stream; :meth:`StageTimer.ms`
synchronizes once and sums each stage's elapsed device time. Without a
timer (``None``) the stages cost nothing.
"""

from __future__ import annotations

from collections import defaultdict
from contextlib import contextmanager, nullcontext

import torch


class StageTimer:
    def __init__(self):
        self._events = defaultdict(list)

    @contextmanager
    def stage(self, name: str):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self._events[name].append((start, end))

    def ms(self) -> dict:
        """{stage: total milliseconds} over every recorded interval."""
        torch.cuda.synchronize()
        return {name: sum(s.elapsed_time(e) for s, e in pairs)
                for name, pairs in self._events.items()}


def stage(timer, name: str):
    """timer.stage(name), or a no-op context when timer is None."""
    return nullcontext() if timer is None else timer.stage(name)
