"""Per-stage timing of the closed loop with CUDA events, device traces and
a finiteness check.

A :class:`StageTimer` passed down the loop records a start and an end event
around each named stage on the current stream; :meth:`StageTimer.ms`
synchronizes once and sums each stage's elapsed device time. Without a
timer (``None``) the stages cost nothing. :func:`device_trace` and
:func:`check_finite` are the port of neoplanner_tpu/utils/profiling.py
(:49, :58).
"""

from __future__ import annotations

import dataclasses
import os
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


@contextmanager
def device_trace(log_dir: str):
    """torch.profiler over the block (the CPU, and the card where there is
    one), written as a Chrome trace to log_dir/trace.json; yields the
    profiler (its key_averages() sum the kernels' times by name)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def tensor_leaves(tree, path: str = ""):
    """(path, tensor) of every tensor of a nested structure (dataclasses,
    dicts, lists, tuples), depth first; paths as ".drone.pos"."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tensor_leaves(getattr(tree, f.name),
                                     f"{path}.{f.name}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from tensor_leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tensor_leaves(v, f"{path}[{i}]")


def check_finite(tree, name: str = "state") -> None:
    """Raise FloatingPointError naming every floating-point tensor of a
    nested structure (dataclasses, dicts, lists, tuples) that holds a NaN
    or an infinity."""
    bad = [path for path, t in tensor_leaves(tree)
           if t.is_floating_point() and not bool(torch.isfinite(t).all())]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")
