"""The readings of the port's own spans and counters: the split of the
device's idle time and of the host's synchronizing CUDA calls over the
``neo.*`` spans (harness/spans.py) on synthetic intervals and on a CPU
profile, and the counter metrics (``bank_retry_pct``,
``bank_useful_pct``) on a small CPU window and without a tracer to read.
One test, marked ``cuda``, counts a deliberate ``.item()`` in a span as
one sync on the card and skips elsewhere."""

import time

import pytest
import torch

from harness import loop, spans as sp
from harness.capture import Capture
from harness.cells import metric_reader
from neoplanner_tpu_torch.utils import profiling
from neoplanner_tpu_torch.utils.profiling import StageTimer
from test_bench_port_check import SEED, small

COUNTERS = ("bank_retry_pct", "bank_useful_pct")

# segment [0, 100) holding plan [10, 60) holding bank [20, 40); track
# [70, 90); a second segment [120, 150); the window [0, 200)
SPANS = [(0, 100, "segment"), (10, 60, "segment/plan"),
         (20, 40, "segment/plan/bank"), (70, 90, "segment/track"),
         (120, 150, "segment")]
# a timer traced the window: the runner's ctx then holds its stage times
TRACED = {"stage_ms": {"plan": 1.0}}


def _ns(d):
    return {k: round(v * 1e9) for k, v in d.items()}


def test_idle_split_by_overlap():
    busy = [(5, 15), (30, 75), (140, 160)]
    got = _ns(sp.idle_by_span(busy, SPANS, 0, 200))
    assert got == {"segment": 5 + 10 + 20,   # [0,5) [90,100) [120,140)
                   "segment/plan": 5,             # [15,20)
                   "segment/plan/bank": 10,       # [20,30)
                   "segment/track": 15,           # [75,90)
                   "none": 20 + 40}               # [100,120) [160,200)
    assert sum(got.values()) == 200 - (10 + 45 + 20)


def test_idle_split_clips_to_the_window_and_counts_none():
    busy = [(0, 50)]
    got = _ns(sp.idle_by_span(busy, SPANS, 30, 130))
    assert got == {"segment/plan": 10, "segment": 10 + 10 + 10,
                   "segment/track": 20, "none": 20}
    assert sum(got.values()) == 100 - 20
    assert _ns(sp.idle_by_span([], [], 0, 50)) == {"none": 50}
    assert sp.idle_by_span([(0, 50)], SPANS, 0, 50) == {}


def test_syncs_split_by_the_innermost_span():
    starts = [-5, 0, 15, 25, 39, 40, 95, 100, 130, 199, 200]
    got = sp.syncs_by_span(starts, SPANS, 0, 200)
    assert got == {"segment": 3,              # 0, 95, 130
                   "segment/plan": 2,         # 15, 40
                   "segment/plan/bank": 2,    # 25, 39
                   "none": 2}                 # 100, 199; -5, 200 outside
    assert sp.syncs_by_span([], SPANS, 0, 200) == {}
    assert sp.syncs_by_span([5], [], 0, 10) == {"none": 1}


def test_neo_spans_nest_as_the_timer_and_cover_the_window():
    timer = StageTimer(cuda=False)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time_ns()
        for _ in range(2):
            with profiling.stage(timer, "segment"):
                with profiling.span("plan"), profiling.span("bank.first"):
                    torch.ones(64).sum()
                with profiling.span("track"):
                    time.sleep(0.002)
        t1 = time.time_ns()
    spans = sp.neo_spans(prof.profiler.kineto_results)
    assert [p for _, _, p in spans] == [s.path for s in timer.spans()]
    by = sp.window_idle_by_span(prof, t0, t1)
    assert set(by) <= {s.path for s in timer.spans()} | {"none"}
    assert by["segment/track"] >= 2 * 0.002 * 0.9
    assert abs(sum(by.values()) - (t1 - t0) / 1e9) < 1e-6   # no device


@pytest.fixture
def no_tracer(monkeypatch):
    monkeypatch.setattr(profiling, "_last", None)


class _Counted:
    def __init__(self, counts):
        self._counts = counts

    def counts(self):
        return dict(self._counts)


@pytest.mark.parametrize("name", COUNTERS)
def test_counter_metrics_read_nothing_without_a_tracer(no_tracer, name,
                                                       monkeypatch):
    ctx = {"segments": 3, "plans": 9, **TRACED}
    assert metric_reader(name)(ctx) is None
    monkeypatch.delattr(profiling, "last_timer")      # a port without one
    assert metric_reader(name)(ctx) is None
    # a run that made no timer reads nothing, whichever timer came before
    monkeypatch.setattr(profiling, "last_timer",
                        lambda: _Counted({"bank.envs": 40}), raising=False)
    assert metric_reader(name)({"segments": 3, "plans": 9,
                                "stage_ms": {}}) is None


@pytest.mark.parametrize("name, want", [("bank_retry_pct", 25.0),
                                        ("bank_useful_pct", 75.0)])
def test_counter_metrics_from_counts(monkeypatch, name, want):
    counts = {"bank.envs": 40, "bank.retry_envs": 10}
    monkeypatch.setattr(profiling, "_last", _Counted(counts))
    ctx = {"segments": 4, "plans": 30, **TRACED}
    assert metric_reader(name)(ctx) == pytest.approx(want)


@pytest.mark.parametrize("workload", ["neo_resnet18_640.rand10",
                                      "expert_vision.rand10"])
def test_window_counts_equal_the_states_deltas(workload, no_tracer):
    """A small traced window on the CPU: the timer counts every env of
    every segment in the bank, and the counter metrics read it."""
    cell = small(workload)
    dev = torch.device("cpu")
    system = loop.build(cell, SEED, dev)
    loop.warm_up(system, 1, dev)
    timer = StageTimer(cuda=False)
    win = loop.run_window(system, 0.0, dev, Capture(), 1.0, timer)
    counts = timer.counts()
    assert counts["bank.envs"] == system.envs * win.segments
    assert 0 <= counts["bank.retry_envs"] <= counts["bank.envs"]
    ctx = {"segments": win.segments, "plans": win.plans, **TRACED}
    assert metric_reader("bank_useful_pct")(ctx) == pytest.approx(
        100.0 * win.plans / counts["bank.envs"])
    assert metric_reader("bank_retry_pct")(ctx) == pytest.approx(
        100.0 * counts["bank.retry_envs"] / counts["bank.envs"])


@pytest.mark.cuda
def test_item_in_a_span_counts_one_sync():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA runtime's calls are "
                    "traced there)")
    x = torch.ones(1024, device="cuda")
    torch.cuda.synchronize()
    timer = StageTimer()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time_ns()
        with timer.stage("segment"):
            y = x * 2
            with profiling.span("probe"):
                y.sum().item()
            z = y + 1
        t1 = time.time_ns()
    assert sp.window_syncs_by_span(prof, t0, t1) == {"segment/probe": 1}
    assert float(z[0]) == 3.0
