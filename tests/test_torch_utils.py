"""The port's utilities against the JAX package on the CPU: mission
records and the reference's metric and tracking files (byte for byte),
the ASCII map and the FSM graph (the same text), the figures, the
finiteness check and the device trace, and env snapshots (exact)."""

import datetime
import os
from types import SimpleNamespace

import numpy as np
import jax
import pytest
import torch

from neoplanner_tpu.config import MapParams as JMapParams
from neoplanner_tpu.config import WorldParams as JWorldParams
from neoplanner_tpu.sim import missions as jmissions
from neoplanner_tpu.utils import metrics as jmetrics
from neoplanner_tpu.utils import viz as jviz
from neoplanner_tpu.world import scenegen as jscenegen
from neoplanner_tpu.world import voxelize as jvoxelize
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, PlannerParams,
                                         SimParams, WorldParams)
from neoplanner_tpu_torch.core.types import DroneState
from neoplanner_tpu_torch.sim import env, missions
from neoplanner_tpu_torch.utils import metrics, profiling, snapshot, viz
from neoplanner_tpu_torch.world import scenegen
from tests.test_torch_imports import one_torch_thread  # noqa: F401


class _FixedClock(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 1, 2, 3, 4, 5)


def _states(n=6, seed=0):
    """Terminal mission fields, as numpy (for JAX's from_env_states) and
    as tensors (the port's)."""
    rng = np.random.default_rng(seed)
    fields = dict(
        reached=rng.uniform(size=n) < 0.6,
        steps=rng.integers(0, 2700, n).astype(np.int32),
        metrics=np.stack([rng.uniform(0, 30, n), rng.uniform(0, 0.5, n),
                          rng.uniform(0, 0.6, n)], -1).astype(np.float32),
        plan_count=rng.integers(0, 40, n).astype(np.int32),
        iter_sum=rng.integers(0, 900, n).astype(np.int32),
        goal=rng.uniform(-5, 25, (n, 2)).astype(np.float32))
    fields["plan_count"][0] = 0
    return (SimpleNamespace(**fields),
            SimpleNamespace(**{k: torch.from_numpy(v)
                               for k, v in fields.items()}))


def test_metrics_files_match_jax(tmp_path, monkeypatch):
    """from_env_states gives JAX's records (pp at its default tolerance);
    write_metrics_file writes JAX's bytes; reading and aggregating agree."""
    for mod in (jmetrics, metrics):
        monkeypatch.setattr(mod.datetime, "datetime", _FixedClock)
    js, ts = _states()
    want = jmetrics.from_env_states(js, "poles", 8, "expert", 0.05,
                                    replan_mode="online")
    got = metrics.from_env_states(ts, "poles", 8, "expert", 0.05,
                                  PlannerParams(), replan_mode="online")
    assert [vars(r) for r in got] == [vars(r) for r in want]
    assert any(r.reached for r in got) and not all(r.reached for r in got)
    a, b = str(tmp_path / "jax" / "m.txt"), str(tmp_path / "port" / "m.txt")
    jmetrics.write_metrics_file(a, want)
    metrics.write_metrics_file(b, got)
    metrics.write_metrics_file(b, got[:2])
    jmetrics.write_metrics_file(a, want[:2])
    assert open(a, "rb").read() == open(b, "rb").read()
    back = metrics.read_metrics_file(b)
    assert [vars(r) for r in back] == [vars(r) for r in
                                       jmetrics.read_metrics_file(a)]
    got_agg, want_agg = metrics.analyze(back), jmetrics.analyze(back)
    assert got_agg.keys() == want_agg.keys() == {"expert"}
    np.testing.assert_equal(got_agg, want_agg)
    # the bar follows the tolerance
    strict = metrics.from_env_states(ts, "poles", 8, "expert", 0.05,
                                     PlannerParams(collision_cost_tol=0.0))
    assert not any(r.reached for r in strict)


def test_tracking_csv_matches_jax(tmp_path):
    traces = np.random.default_rng(1).normal(size=(2 * 60, 5, 3)).astype(
        np.float32)
    a = jmetrics.save_tracking_csv(str(tmp_path / "a.csv"), traces)
    b = metrics.save_tracking_csv(str(tmp_path / "b.csv"),
                                  torch.from_numpy(traces))
    assert open(a, "rb").read() == open(b, "rb").read()


def test_fsm_graph_matches_jax(tmp_path):
    a = jmissions.save_fsm_graph(str(tmp_path / "a.dot"))
    b = missions.save_fsm_graph(str(tmp_path / "b.dot"))
    assert open(a).read() == open(b).read()
    assert "TAKINGOFF" in open(b).read()


def test_viz_matches_jax(tmp_path):
    """ascii_map gives JAX's string; the figures are written."""
    mapp = JMapParams(width=128, height=96, origin_x=-2.0, origin_y=-4.8)
    world = jscenegen.generate(jax.random.PRNGKey(0),
                               JWorldParams(num_boxes=6))
    occ = np.asarray(jvoxelize.occupancy_2d(world, mapp))
    kw = dict(paths=[np.array([[0.0, 0.0], [1.0, 0.0], [3.0, 0.5]])],
              origin=(mapp.origin_x, mapp.origin_y),
              resolution=mapp.resolution, markers=[(5.0, 0.0, "X")])
    txt = viz.ascii_map(occ, **kw)
    assert txt == jviz.ascii_map(occ, **kw)
    assert "#" in txt and "o" in txt and "X" in txt
    path = np.stack([np.linspace(0, 8, 50), np.zeros(50)], axis=-1)
    out = viz.plot_mission(occ, (mapp.origin_x, mapp.origin_y),
                           mapp.resolution, flown_path=path,
                           planned_path=path,
                           planned_vel=np.abs(np.sin(np.linspace(0, 3, 50))),
                           wpts=np.array([[2.0, 5.0], [0.5, -0.5]]),
                           goal=np.array([8.0, 0.0]),
                           save_path=str(tmp_path / "mission.png"))
    assert os.path.getsize(out) > 10000
    out2 = viz.esdf_heatmap(np.random.default_rng(2).uniform(0, 3, (96, 128)),
                            (mapp.origin_x, mapp.origin_y), mapp.resolution,
                            save_path=str(tmp_path / "esdf.png"))
    assert os.path.getsize(out2) > 10000


def test_check_finite_and_device_trace(tmp_path):
    tree = {"a": torch.ones(3), "b": [torch.zeros(2, dtype=torch.int32)],
            "c": SimpleNamespace()}
    profiling.check_finite(tree)
    bad = {"ok": torch.ones(2), "nested": {"x": torch.tensor([1.0, np.nan])},
           "drone": DroneState(pos=torch.zeros(1, 3),
                               vel=torch.tensor([[0.0, np.inf, 0.0]]),
                               quat=torch.zeros(1, 4), yaw=torch.zeros(1))}
    with pytest.raises(FloatingPointError) as err:
        profiling.check_finite(bad, "bad")
    assert "['nested']['x']" in str(err.value)
    assert "['drone'].vel" in str(err.value)
    assert "pos" not in str(err.value)
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).square().sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert len(prof.key_averages()) > 0


def test_snapshot_resumes_exactly(tmp_path):
    """A saved state, loaded into a template, holds every tensor and the
    generator's state: its next segment is the uninterrupted run's, bit for
    bit."""
    pp = PlannerParams(max_iters=2, samples_per_piece=6, retry_num=2,
                       extra_lateral_scales=(), max_ls=2)
    mp, sp, cam = MissionParams(), SimParams(), CameraParams()
    mapp = MapParams(width=128, height=96, origin_x=-2.0, origin_y=-4.8)
    gen = _cuda.make_generator(4, "cpu")
    worlds = scenegen.generate_batch(gen, 2, WorldParams(num_boxes=6))
    state = env.reset(worlds, pp, mp, mapp, gen, plan_map="grid")
    state, _ = env.step_segment(state, pp, mp, sp, cam, planner="expert")
    path = snapshot.save(str(tmp_path / "snap.pt"), state)
    template = env.reset(worlds, pp, mp, mapp,
                         _cuda.make_generator(9, "cpu"),
                         goal=torch.zeros(2, 2), plan_map="grid")
    restored = snapshot.load(path, template)
    for (p, a), (_, b) in zip(profiling.tensor_leaves(state),
                              profiling.tensor_leaves(restored)):
        assert torch.equal(a, b), p
    nxt, _ = env.step_segment(state, pp, mp, sp, cam, planner="expert")
    nxt2, _ = env.step_segment(restored, pp, mp, sp, cam, planner="expert")
    for (p, a), (_, b) in zip(profiling.tensor_leaves(nxt),
                              profiling.tensor_leaves(nxt2)):
        assert torch.equal(a, b), p
    with pytest.raises(ValueError, match="snapshot"):
        snapshot.load(path, env.reset(
            scenegen.generate_batch(gen, 3, WorldParams(num_boxes=6)), pp,
            mp, mapp, gen, plan_map="grid"))
