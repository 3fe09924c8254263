"""The closed loop's tracer (spans and counters), device traces and a
finiteness check.

A :class:`StageTimer` handed to ``sim/env.step_segment`` records each
named stage of the loop as a span: a ``torch.profiler.record_function``
range ``neo.<name>``, so that the stage sits on the clock of a profiler's
device events, and a record in memory (its parent, its segment, its host
start and end, and on a CUDA device a pair of events on the current
stream). While one of its spans is open the timer is the active one:
code below opens :func:`span` and calls :func:`count` with no timer
argument. :meth:`StageTimer.ms` sums each name's device time, as the
stages' totals; :meth:`StageTimer.counts` reads the counters. On the CPU
the timer keeps host spans and counters, with no device times. Without a
timer (``None``, and no timer active) every span and count does nothing:
no event, no profiler range, no device operation. The timer changes no
setting of the process; a profiler's trace of its ranges holds what it
does not count itself, such as the host's synchronizing CUDA calls.
:func:`device_trace` and :func:`check_finite` are the port of
neoplanner_tpu/utils/profiling.py (:49, :58).
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import Optional

import torch

_OFF = nullcontext()
_active = None          # the timer whose span is open, if any
_last = None            # the timer made last (see last_timer)


@dataclasses.dataclass(frozen=True)
class Span:
    """One span of a :class:`StageTimer`, as :meth:`StageTimer.spans`
    returns it."""

    name: str
    path: str                 # the names from the root down, "/"-joined
    parent: int               # index of the enclosing span, -1 at a root
    segment: int              # index of the enclosing 'segment' span, -1
    start_ns: int             # host clock (time.time_ns(): the profiler's)
    end_ns: int
    device_ms: Optional[float]  # between its CUDA events; None on the CPU


class StageTimer:
    """Spans and counters of the closed loop (see the module docstring).
    A span named 'segment' (one ``step_segment`` call) starts a new
    segment index, shared by the spans inside it."""

    def __init__(self, cuda: Optional[bool] = None):
        global _last
        _last = self
        self.cuda = torch.cuda.is_available() if cuda is None else cuda
        # each span's [name, path, parent, segment, t0, t1, e0, e1] in the
        # order opened (e0, e1: its CUDA events)
        self._recs = []
        self._stack = []         # indices of the open spans, innermost last
        self._segments = 0
        self._host_counts = defaultdict(int)
        self._dev_counts = {}

    @contextmanager
    def stage(self, name: str):
        global _active
        outer, _active = _active, self
        parent = self._stack[-1] if self._stack else -1
        if name == "segment":
            segment = self._segments
            self._segments += 1
        else:
            segment = self._recs[parent][3] if parent >= 0 else -1
        path = name if parent < 0 else f"{self._recs[parent][1]}/{name}"
        rec = [name, path, parent, segment, 0, 0, None, None]
        self._stack.append(len(self._recs))
        self._recs.append(rec)
        with torch.profiler.record_function(f"neo.{name}"):
            if self.cuda:
                rec[6] = torch.cuda.Event(enable_timing=True)
                rec[6].record()
            rec[4] = time.time_ns()
            try:
                yield
            finally:
                rec[5] = time.time_ns()
                if self.cuda:
                    rec[7] = torch.cuda.Event(enable_timing=True)
                    rec[7].record()
                self._stack.pop()
                _active = outer

    def count(self, name: str, value) -> None:
        """Add ``value`` (an int, or a tensor whose elements are summed on
        its device, with no sync) to the counter ``name``."""
        if isinstance(value, torch.Tensor):
            v = value.sum(dtype=torch.int64)
            acc = self._dev_counts.get(name)
            self._dev_counts[name] = v if acc is None else acc + v
        else:
            self._host_counts[name] += int(value)

    def counts(self) -> dict:
        """{counter: total}, the device counters read in one transfer."""
        out = dict(self._host_counts)
        if self._dev_counts:
            names = list(self._dev_counts)
            values = torch.stack([self._dev_counts[n] for n in names])
            for n, v in zip(names, values.tolist()):
                out[n] = out.get(n, 0) + v
        return out

    def spans(self) -> list:
        """Every span closed so far, in the order opened (a :class:`Span`
        each), after one synchronize."""
        if self.cuda:
            torch.cuda.synchronize()
        return [Span(n, p, par, seg, t0, t1,
                     None if e1 is None else e0.elapsed_time(e1))
                for n, p, par, seg, t0, t1, e0, e1 in self._recs if t1]

    def ms(self) -> dict:
        """{span name: total milliseconds} of device time over every
        recorded span of that name; empty on the CPU."""
        out = defaultdict(float)
        for s in self.spans():
            if s.device_ms is not None:
                out[s.name] += s.device_ms
        return dict(out)


def active() -> Optional[StageTimer]:
    """The timer whose span is open, or None."""
    return _active


def last_timer() -> Optional[StageTimer]:
    """The timer made last in this process. It serves only the
    benchmark's counter readers, which hold no handle to the timer that
    traced their window; the loop never reads it."""
    return _last


def stage(timer, name: str):
    """timer.stage(name); without a timer, :func:`span` (a no-op when no
    timer is active)."""
    return span(name) if timer is None else timer.stage(name)


def span(name: str):
    """A span ``name`` of the active timer, a no-op context without one."""
    return _OFF if _active is None else _active.stage(name)


def count(name: str, value) -> None:
    """Add ``value`` to the active timer's counter ``name``; nothing
    without one. A caller that must compute ``value`` checks
    :func:`active` first, so that no work is done untraced."""
    if _active is not None:
        _active.count(name, value)


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
