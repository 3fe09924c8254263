"""The traced window's readings by the program's own spans.

The port's tracer (``utils/profiling.StageTimer``) opens a
``torch.profiler.record_function`` range ``neo.<name>`` around each stage
of ``step_segment``, nested as the stages are. Each instant of the window
at which the device ran nothing (the complement of the union of its
kernels' and copies' intervals, as :func:`harness.trace.device_readings`
counts busy time) goes to the innermost ``neo.*`` span open on the host at
that instant, by overlap; an instant with no span open goes to ``none``.
The parts sum to the window's idle time. Each synchronizing CUDA call of
the host (the runtime's and driver's ``*Synchronize`` calls and the
blocking ``cudaMemcpy``; ``.item()`` or a copy from pageable host memory
is a ``cudaMemcpyAsync`` then a ``cudaStreamSynchronize``) goes to the
innermost span open at its start. Both read the profiler's trace alone,
so the program pays nothing for them at run time.
"""

from __future__ import annotations

import bisect

import torch

from harness.trace import _device_events, _union

PREFIX = "neo."
# the host's CUDA calls that wait for the device
SYNC_CALLS = frozenset({"cudaDeviceSynchronize", "cudaStreamSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy",
                        "cudaMemcpy2D", "cuCtxSynchronize",
                        "cuStreamSynchronize", "cuEventSynchronize"})


def neo_spans(kineto) -> list:
    """(start_ns, end_ns, path) of the host's ``neo.*`` ranges, sorted by
    start, each path the names of its enclosing ranges and its own joined
    by "/" ("segment/plan/bank.first")."""
    ranges = sorted(((e.start_ns(), e.end_ns(), e.name()[len(PREFIX):])
                     for e in kineto.events()
                     if e.device_type() == torch.autograd.DeviceType.CPU
                     and e.name().startswith(PREFIX)),
                    key=lambda r: (r[0], -r[1]))
    out, stack = [], []                     # stack: (end, path) open
    for s, f, name in ranges:
        while stack and stack[-1][0] < f:
            stack.pop()
        path = f"{stack[-1][1]}/{name}" if stack else name
        out.append((s, f, path))
        stack.append((f, path))
    return out


def _labels(spans, t0: int, t1: int) -> list:
    """[t0, t1] cut into (start, end, path) pieces, each labelled by the
    innermost span open there ("none" where none is)."""
    out, stack, cur = [], [], t0

    def upto(t, label):
        nonlocal cur
        t = min(max(t, t0), t1)
        if t > cur:
            out.append((cur, t, label))
            cur = t

    for s, f, path in spans:
        while stack and stack[-1][0] <= s:
            end, inner = stack.pop()
            upto(end, inner)
        upto(s, stack[-1][1] if stack else "none")
        stack.append((f, path))
    while stack:
        end, inner = stack.pop()
        upto(end, inner)
    upto(t1, "none")
    return out


def idle_by_span(busy, spans, t0: int, t1: int) -> dict:
    """{span path or "none": idle seconds} over the window [t0, t1] (ns).
    ``busy`` are the device's merged busy intervals (sorted, disjoint),
    ``spans`` :func:`neo_spans`' ranges; the values sum to the window's
    length less the busy time inside it."""
    out = {}
    i = 0
    for a, b, label in _labels(spans, t0, t1):
        idle = b - a
        while i < len(busy) and busy[i][1] <= a:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < b:
            idle -= min(b, busy[j][1]) - max(a, busy[j][0])
            j += 1
        if idle > 0:
            out[label] = out.get(label, 0.0) + idle / 1e9
    return out


def syncs_by_span(starts, spans, t0: int, t1: int) -> dict:
    """{span path or "none": count} of the calls starting at ``starts``
    (ns) inside the window [t0, t1], each counted in the innermost span
    of ``spans`` (:func:`neo_spans`' ranges) open at its start."""
    pieces = _labels(spans, t0, t1)
    ends = [b for _, b, _ in pieces]
    out = {}
    for t in starts:
        if t0 <= t < t1:
            label = pieces[bisect.bisect_right(ends, t)][2]
            out[label] = out.get(label, 0) + 1
    return out


def sync_starts(kineto) -> list:
    """The start (ns) of each synchronizing CUDA call of the host."""
    return sorted(e.start_ns() for e in kineto.events()
                  if e.device_type() == torch.autograd.DeviceType.CPU
                  and e.name() in SYNC_CALLS)


def window_syncs_by_span(prof, t0: int, t1: int) -> dict:
    """:func:`syncs_by_span` of a traced window, from the CUDA runtime's
    events and the host's ``neo.*`` ranges of ``prof`` (a stopped
    torch.profiler)."""
    kineto = prof.profiler.kineto_results
    return syncs_by_span(sync_starts(kineto), neo_spans(kineto), t0, t1)


def window_idle_by_span(prof, t0: int, t1: int) -> dict:
    """:func:`idle_by_span` of a traced window: the device's intervals and
    the host's ``neo.*`` ranges of ``prof`` (a stopped torch.profiler)."""
    kineto = prof.profiler.kineto_results
    busy = _union([(s, f) for _, s, f in _device_events(kineto, t0, t1)])
    return idle_by_span(busy, neo_spans(kineto), t0, t1)

