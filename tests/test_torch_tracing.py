"""The closed loop's tracer (utils/profiling.StageTimer) on a small CPU
loop: the spans of ``env.step_segment`` on the scene path and their
parents, the bank's counters against the skip masks the bank solved
with, the loop's results with and without a timer, and the ``neo.*``
ranges under ``torch.profiler``. One test, marked ``cuda``, times the
spans on the card and skips elsewhere.

This module imports neither JAX nor the JAX package. On a GPU host
without JAX (whose tests/conftest.py imports it), run

    python -m pytest tests/test_torch_tracing.py --noconftest \
        -o addopts="" -p no:cacheprovider -q
"""

import os

import pytest
import torch

from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, NetParams,
                                         PlannerParams, SimParams,
                                         WorldParams)
from neoplanner_tpu_torch.models import planner_net
from neoplanner_tpu_torch.plan import expert
from neoplanner_tpu_torch.sim import env
from neoplanner_tpu_torch.utils import profiling
from neoplanner_tpu_torch.utils.profiling import StageTimer
from neoplanner_tpu_torch.world import scenegen
from tests.test_torch_imports import one_torch_thread  # noqa: F401

B = 4
SEGMENTS = 2
PP = PlannerParams(max_iters=4, samples_per_piece=6, retry_num=2,
                   extra_lateral_scales=(), max_ls=2)
MAPP = MapParams(width=256, height=192, origin_x=-4.0, origin_y=-9.6)
CAM = CameraParams(width=160, height=120)
ONNX = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                    "planner_net_smallconv.onnx")

# the spans of one segment, as paths, by planner (the scene path)
BANK = ("bank.first", "bank.first/solve", "bank.first/accept", "bank.rest",
        "bank.rest/solve", "bank.rest/accept", "bank.select")
PATHS = {
    "neo": {"segment", "segment/render", "segment/target", "segment/net",
            "segment/plan", "segment/plan/cmd", "segment/track",
            "segment/missions"} | {f"segment/plan/{b}" for b in BANK},
    "expert": {"segment", "segment/target", "segment/plan",
               "segment/plan/cmd", "segment/track", "segment/missions"}
    | {f"segment/plan/{b}" for b in BANK},
}
# a segment's direct children, in order
CHILDREN = {"neo": ["render", "target", "net", "plan", "plan", "track",
                    "missions"],
            "expert": ["target", "plan", "plan", "track", "missions"]}


@pytest.fixture(scope="module")
def net():
    return planner_net.load(ONNX, NetParams(img_width=160, img_height=120,
                                            backbone="smallconv"), "cpu")


def _reset():
    gen = _cuda.make_generator(0, "cpu")
    worlds = scenegen.generate_batch(gen, B, WorldParams(num_boxes=10))
    return env.reset(worlds, PP, MissionParams(), MAPP, gen)


def _loop(planner, net, timer=None):
    """SEGMENTS segments from the same reset; returns (the reset state,
    the last state, the SegmentInfos)."""
    state0 = _reset()
    state, infos = state0, []
    for _ in range(SEGMENTS):
        state, info = env.step_segment(
            state, PP, MissionParams(), SimParams(), CAM,
            net if planner == "neo" else None, timer=timer, planner=planner)
        infos.append(info)
    return state0, state, infos


@pytest.fixture(scope="module", params=["neo", "expert"])
def traced(request, net):
    """(planner, timer, _loop's results, the skip mask of each bank's
    second launch)."""
    skips, solve_lanes = [], expert._solve_lanes

    def recording(*args, skip=None, **kw):
        if skip is not None:
            skips.append(skip.clone())
        return solve_lanes(*args, skip=skip, **kw)

    timer = StageTimer(cuda=False)
    expert._solve_lanes = recording
    try:
        results = _loop(request.param, net, timer)
    finally:
        expert._solve_lanes = solve_lanes
    return request.param, timer, results, skips


def test_spans_and_parents(traced):
    planner, timer, _, _ = traced
    spans = timer.spans()
    roots = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [spans[i].name for i in roots] == ["segment"] * SEGMENTS
    assert [spans[i].segment for i in roots] == list(range(SEGMENTS))
    for seg, r in enumerate(roots):
        mine = [s for s in spans if s.segment == seg]
        assert {s.path for s in mine} == PATHS[planner]
        assert [s.name for s in spans if s.parent == r] == CHILDREN[planner]
    for s in spans:
        assert s.start_ns <= s.end_ns
        assert s.device_ms is None                  # the CPU: host spans
        if s.parent >= 0:
            p = spans[s.parent]
            assert s.path == f"{p.path}/{s.name}"
            assert s.segment == p.segment
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert timer.ms() == {}
    assert profiling.active() is None


def test_counters_match_state_and_info(traced):
    _, timer, (state0, state, infos), skips = traced
    assert timer.counts() == {
        "bank.envs": B * SEGMENTS,
        "bank.retry_envs": sum(int((~s).sum()) for s in skips)}
    assert len(skips) == SEGMENTS
    # the window's replans and iterations, which the benchmark reads from
    # the state, as SegmentInfo reports them
    replans = int((state.plan_count - state0.plan_count).sum())
    iters = int((state.iter_sum - state0.iter_sum).to(torch.int64).sum())
    assert replans == sum(int(i.planned.sum()) for i in infos)
    assert iters == sum(int(torch.where(i.planned, i.iters, 0).sum())
                        for i in infos)


@pytest.mark.parametrize("planner", ["neo", "expert"])
def test_timer_leaves_results_bit_identical(planner, net):
    _, off, off_infos = _loop(planner, net)
    _, on, on_infos = _loop(planner, net, StageTimer(cuda=False))
    for tree_off, tree_on in [(off, on)] + list(zip(off_infos, on_infos)):
        leaves_off = list(profiling.tensor_leaves(tree_off))
        leaves_on = list(profiling.tensor_leaves(tree_on))
        assert [p for p, _ in leaves_off] == [p for p, _ in leaves_on]
        for (path, a), (_, b) in zip(leaves_off, leaves_on):
            assert torch.equal(a, b), path
    assert torch.equal(off.generator.get_state(), on.generator.get_state())


def _neo_events(prof):
    """(start_ns, end_ns, name) of the profiler's neo.* ranges, an
    enclosing range before those it holds."""
    events = [(e.start_ns(), e.end_ns(), e.name()[4:])
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("neo.")]
    return sorted(events, key=lambda e: (e[0], -e[1]))


def _parents(intervals):
    """The index of each interval's innermost enclosing interval (-1 for
    none), intervals sorted by start."""
    out, stack = [], []
    for i, (s, f) in enumerate(intervals):
        while stack and intervals[stack[-1]][1] < f:
            stack.pop()
        out.append(stack[-1] if stack else -1)
        stack.append(i)
    return out


@pytest.mark.parametrize("planner", ["neo", "expert"])
def test_profiler_ranges_only_with_a_timer(planner, net):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        _loop(planner, net)
    assert _neo_events(prof) == []
    timer = StageTimer(cuda=False)
    with torch.profiler.profile(activities=acts) as prof:
        _loop(planner, net, timer)
    events = _neo_events(prof)
    spans = timer.spans()
    assert [n for _, _, n in events] == [s.name for s in spans]
    assert _parents([(s, f) for s, f, _ in events]) == \
        [s.parent for s in spans]
    # the same clock: each span's host times lie in its profiler range
    # (to 1 ms, the profiler's conversion of its own clock)
    for (s, f, _), sp in zip(events, spans):
        assert s - 1e6 <= sp.start_ns <= sp.end_ns <= f + 1e6


def test_spans_and_counts_without_a_loop():
    assert profiling.active() is None
    with profiling.span("idle"):                 # no timer: nothing
        profiling.count("n", 5)
    timer = StageTimer(cuda=False)
    with profiling.stage(timer, "segment"):
        assert profiling.active() is timer
        with profiling.span("a"), profiling.span("b"):
            profiling.count("n", 2)
            profiling.count("n", torch.tensor([True, False, True]))
        profiling.count("m", torch.arange(4, dtype=torch.int32))
    with profiling.stage(timer, "segment"):
        profiling.count("n", 1)
    assert profiling.active() is None
    assert profiling.last_timer() is timer
    assert timer.counts() == {"n": 5, "m": 6}
    assert [(s.path, s.segment, s.parent) for s in timer.spans()] == [
        ("segment", 0, -1), ("segment/a", 0, 0), ("segment/a/b", 0, 1),
        ("segment", 1, -1)]
    newer = StageTimer(cuda=False)                # the last one made
    assert profiling.last_timer() is newer


@pytest.mark.cuda
def test_cuda_spans_time_the_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (spans are timed there)")
    x = torch.ones(1024, device="cuda")
    torch.cuda.synchronize()
    before = torch.cuda.get_sync_debug_mode()
    timer = StageTimer()
    with timer.stage("segment"):
        y = x * 2
        with profiling.span("probe"):
            total = y.sum().item()
            profiling.count("n", y > 1)
        z = y + 1
    assert torch.cuda.get_sync_debug_mode() == before  # no setting changed
    assert timer.counts() == {"n": 1024}
    spans = timer.spans()
    assert [s.path for s in spans] == ["segment", "segment/probe"]
    assert all(s.device_ms is not None and s.device_ms >= 0 for s in spans)
    assert timer.ms().keys() == {"segment", "probe"}
    assert total == 2048.0 and float(z[0]) == 3.0
