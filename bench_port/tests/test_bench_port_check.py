"""The check that decides ``correct``: a sound run passes, the control
(the reference in the precision below) fails, and each fault that a cell
can have, planted in the timed path, turns ``correct`` false.

These drive the whole run but for the look for a chip, on the CPU at a
small size (3 envs, a 64 x 48 net, 4 L-BFGS iterations), where the port
takes its plain versions. The same check runs on the card at the cells'
own sizes in every run of run.py; control.py reads the control there,
through the same run_cell."""

import copy
import time

import pytest
import torch

import control
from harness import check
from harness.capture import Capture
from harness.cells import resolve
from harness.runner import run_cell

CELLS = ("neo_resnet18_640.rand10", "expert_vision.rand10")
SEED = 2 ** 31 + 77


def small(workload: str):
    cell = resolve(workload)
    cfg = copy.deepcopy(cell.config)
    cfg["envs"] = 3
    cfg["check"]["envs"] = 3
    cfg["camera"]["width"], cfg["camera"]["height"] = 64, 48
    if cfg.get("net"):
        cfg["net"]["img_width"], cfg["net"]["img_height"] = 64, 48
    cfg["planner_params"]["max_iters"] = 4
    cell.config = cfg
    cell.traffic = dict(cell.traffic, warmup_segments=1)
    return cell


def run(cell, seed=SEED):
    return run_cell(cell, seed, 0.0, False, torch.device("cpu"),
                    [("start", time.perf_counter())])


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    r = run(small(workload))
    assert r["correct"], r["check"]
    assert set(r["metrics"]) == {"sim_steps_per_s", "segment_ms_p90",
                                 "setup_s"} - {"segment_ms_p90"}
    assert list(r)[-1] == "check"


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload):
    """control.py's readings of one segment: the program's pass the
    limits, the control's (the reference in the precision below) fail."""
    cell = small(workload)
    (row,) = control.rows(cell, [SEED], 0.0, torch.device("cpu"))
    limits = cell.config["check"]["limits"]
    assert row["correct"] and not row["layers_missing"]
    assert check.judge(row["program"], limits)[0]
    assert not check.judge(row["control"], limits)[0], row["control"]


@pytest.mark.parametrize("workload", CELLS)
def test_a_layer_that_captures_nothing_fails_loudly(workload):
    """A layer named in check.layers whose entries the segment never
    calls turns ``correct`` false and is named."""
    cell = small(workload)
    absent = "net" if "fuse" in cell.config["check"]["layers"] else "fuse"
    cell.config["check"]["layers"].append(absent)
    r = run(cell)
    assert not r["correct"]
    assert r["layers_missing"] == [absent]


def test_failed_counts_the_missions_of_non_finite_flights():
    """``failed`` counts the missions ended in the window by a drone gone
    non-finite, and the planner's outcome stays apart under ``missions``:
    a sound run fails none."""
    from types import SimpleNamespace as NS

    from harness import loop
    r = run(small(CELLS[0]))
    assert r["failed"] == 0
    assert r["missions"]["ended"] == r["attempted"]
    assert 0 <= r["missions"]["missed_bar"] <= r["attempted"]
    B = 4
    drone = NS(pos=torch.zeros(B, 3), vel=torch.zeros(B, 3),
               quat=torch.zeros(B, 4), yaw=torch.zeros(B))
    state = NS(drone=drone, metrics=torch.zeros(B, 3),
               missions_done=torch.tensor([3, 2, 5, 1], dtype=torch.int32))
    before = torch.tensor([1, 1, 1, 1], dtype=torch.int32)
    assert loop._broken(state, before) == 0
    drone.vel[1, 2] = float("nan")
    state.metrics[2, 0] = float("inf")
    assert loop._broken(state, before) == 1 + 4


def test_an_entry_the_program_lacks_stops_the_run():
    cap = Capture()
    try:
        with pytest.raises(AttributeError):
            cap.install(None, [("neoplanner_tpu_torch.sim.track",
                                "no_such_entry", "track")])
    finally:
        cap.close()


def _patch(monkeypatch, module, name, fn):
    import importlib
    mod = importlib.import_module(module)
    orig = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: fn(orig, *a, **k))


def fault_state_unchanged(orig, state, cmds, *a, **k):
    """A step that returns its state unchanged: tracking leaves the drone
    where it was."""
    out = orig(state, cmds, *a, **k)
    return (state.drone,) + tuple(out[1:])


def fault_half_batch(orig, x0, *a, **k):
    """Half of the batch left out: the second half of the solver's
    problems come back unsolved."""
    x, f, iters = orig(x0, *a, **k)
    h = x0.shape[0] // 2
    x = torch.cat([x[:h], x0[h:]])
    return x, f, iters


def fault_answer_altered(orig, *a, **k):
    """An answer altered where it is produced: one env's depth frame is
    off by 5 cm."""
    depth = orig(*a, **k).clone()
    depth[0] += 0.05
    return depth


FAULTS = {
    "state_unchanged": [("neoplanner_tpu_torch.sim.track", n,
                         fault_state_unchanged)
                        for n in ("track_segment", "track_segment_grid")],
    "half_batch": [("neoplanner_tpu_torch.plan.solve", n, fault_half_batch)
                   for n in ("solve_scene", "solve_grid")],
    "answer_altered": [("neoplanner_tpu_torch.sense.raycast",
                        "render_depth_auto", fault_answer_altered)],
}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(monkeypatch, workload, fault):
    for module, name, fn in FAULTS[fault]:
        _patch(monkeypatch, module, name, fn)
    r = run(small(workload))
    assert not r["correct"], r["check"]


@pytest.mark.cuda
def test_small_cell_on_the_card(workload="expert_vision.rand10"):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = small(workload)
    cell.config["envs"] = cell.config["check"]["envs"] = 64
    cell.config["planner_params"]["max_iters"] = 32
    r = run_cell(cell, SEED, 1.0, True, torch.device("cuda"),
                 [("start", time.perf_counter())])
    assert r["correct"], r["check"]
    assert r["device"]["busy_s"] > 0
