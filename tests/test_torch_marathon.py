"""The port's quality marathon (sim/marathon.py) against examples/marathon.py.

(a) The envelope and every cell's settings equal the JAX script's: its
    statements are read from its source and run with the JAX package's
    config classes (marathon.py:54-58, the planner envelope; :73-86, the
    cell's sensing, frames, map and planning map; :65, the camera from the
    net's NetParams).
(b) A cell's row equals marathon.py:111-120's formulas run on the same
    arrays, and the table marathon.py:124-129's print.
(c) A run at B = 2, one segment and two L-BFGS iterations covers both
    modes and all five planners: every cell plans, and every cell of a
    mode starts from the same reset (goals, positions and the generator's
    state, so the same draws follow).
"""

import ast
import contextlib
import dataclasses
import io
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from neoplanner_tpu.config import CameraParams as JCameraParams
from neoplanner_tpu.config import MapParams as JMapParams
from neoplanner_tpu.config import MissionParams as JMissionParams
from neoplanner_tpu.config import PlannerParams as JPlannerParams
from neoplanner_tpu.config import SimParams as JSimParams
from neoplanner_tpu.config import WorldParams as JWorldParams
from neoplanner_tpu_torch.config import CameraParams
from neoplanner_tpu_torch.mapping import query
from neoplanner_tpu_torch.sim import marathon, sweep
from tests.test_torch_imports import one_torch_thread  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SCRIPT = os.path.join(ROOT, "examples", "marathon.py")
with open(SCRIPT) as _f:
    _MAIN = next(n for n in ast.parse(_f.read()).body
                 if isinstance(n, ast.FunctionDef) and n.name == "main")
_CELL_LOOP = next(n for n in _MAIN.body if isinstance(n, ast.For))  # :71
_PLANNER_LOOP = _CELL_LOOP.body[0]                                  # :72


def _lines(body, first, last):
    """The statements of body that start on lines first..last."""
    return [n for n in body if first <= n.lineno <= last]


def _run(stmts, ns):
    exec(compile(ast.Module(body=stmts, type_ignores=[]), SCRIPT, "exec"),
         ns)
    return ns


def _as_dict(params):
    return dataclasses.asdict(params)


# ---- (a) the settings

def test_envelope_equals_marathon_script():
    ns = _run(_lines(_MAIN.body, 54, 58), dict(
        PlannerParams=JPlannerParams, MissionParams=JMissionParams,
        SimParams=JSimParams, WorldParams=JWorldParams))
    for got, want in zip(marathon.params(), (ns[k] for k in
                                             ("pp", "mp", "sp", "wp"))):
        assert _as_dict(got) == _as_dict(want), type(got).__name__
    pp, mp, _, _ = marathon.params()
    assert mp.goal_clear_dis == pp.safe_dis + 0.3 > 0.0


@pytest.mark.parametrize("row_stride", [1, 4])
@pytest.mark.parametrize("mode", marathon.MODES)
@pytest.mark.parametrize("planner", marathon.PLANNERS)
def test_cell_settings_equal_marathon_script(mode, planner, row_stride):
    (cell_if,) = _lines(_PLANNER_LOOP.body, 73, 86)
    env_os = SimpleNamespace(environ={"MAR_ROW_STRIDE": str(row_stride)})
    ns = _run([cell_if], dict(MapParams=JMapParams, os=env_os, mode=mode,
                              planner=planner))
    sensing, fuse, mapp, plan_map = marathon.cell_settings(mode, planner,
                                                           row_stride)
    assert (sensing, fuse, plan_map) == (ns["sensing"], ns["fuse"],
                                         ns["plan_map"])
    assert _as_dict(mapp) == _as_dict(ns["mapp"])


def test_camera_from_the_net():
    """marathon.py:65: the camera takes the net's image size."""
    (stmt,) = _lines(_MAIN.body, 65, 65)
    for name in ("planner_net_smallconv", "planner_net_resnet640"):
        _, np_cfg = sweep.load_net(os.path.join(ROOT, "artifacts", name),
                                   "cpu")
        ns = _run([stmt], dict(CameraParams=JCameraParams, np_cfg=np_cfg))
        assert _as_dict(CameraParams(width=np_cfg.img_width,
                                     height=np_cfg.img_height)) \
            == _as_dict(ns["cam"])


# ---- (b) the row and the table

def _arrays(rng, B, empty=False):
    n = (lambda: np.zeros(B, np.int32)) if empty else \
        (lambda: rng.integers(0, 7, B).astype(np.int32))
    done = n()
    ok = np.minimum(done, n())
    return dict(missions_done=done, missions_ok=ok,
                metric_ok_sum=(rng.uniform(0.0, 9.0, B) * ok
                               * 10.0 ** rng.integers(-3, 3, B)
                               ).astype(np.float32),
                iter_sum=n() * 37, plan_count=n() * 3)


@pytest.mark.parametrize("case", range(4))
def test_row_equals_marathon_formulas(case):
    rng = np.random.default_rng(case)
    arrays = _arrays(rng, 256, empty=case == 3)
    wall = float(rng.uniform(0.0, 500.0))
    ns = _run(_lines(_PLANNER_LOOP.body, 111, 120), dict(
        np=np, s=SimpleNamespace(**arrays), wall=wall, mode="vision",
        planner="geo"))
    state = SimpleNamespace(**{k: torch.from_numpy(v)
                               for k, v in arrays.items()})
    got = marathon.row("vision", "geo", state, wall)
    assert json.dumps(got) == json.dumps(ns["row"])


def test_table_equals_marathon_print():
    rows = [marathon.row(m, p, SimpleNamespace(**{
        k: torch.from_numpy(v) for k, v in _arrays(
            np.random.default_rng(i), 8).items()}), 1.25 * i)
        for i, (m, p) in enumerate([("scene", "expert"), ("vision", "neo")])]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _run(_lines(_MAIN.body, 124, 129), dict(rows=rows))
    assert "\n" + marathon.table(rows) + "\n" == buf.getvalue()


# ---- (c) a small run of every cell

@pytest.fixture(scope="module")
def small_run():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = marathon.main(["--device", "cpu", "--envs", "2", "--segments",
                             "1", "--max-iters", "2"])
    return out, buf.getvalue()


def test_run_covers_every_cell(small_run):
    out, printed = small_run
    cells = [(r["mode"], r["planner"]) for r in out["rows"]]
    assert cells == [(m, p) for m in marathon.MODES
                     for p in marathon.PLANNERS]
    for r in out["rows"]:
        assert r["plans"] > 0, r
        assert r["segments"] == 1 and r["ms_segment"] > 0.0
        assert r["launches"] == {}          # no kernel on the CPU
        assert out["states"][r["mode"], r["planner"]].buffer.shape[0] == 2
    lines = printed.splitlines()
    assert [json.loads(x) for x in lines[:10]] == out["rows"]
    assert "\n".join(lines[11:]) == marathon.table(out["rows"])


@pytest.mark.parametrize("mode", marathon.MODES)
def test_cells_of_a_mode_start_alike(small_run, mode):
    out, _ = small_run
    first = out["starts"][mode, marathon.PLANNERS[0]]
    for planner in marathon.PLANNERS[1:]:
        start = out["starts"][mode, planner]
        for k in ("goal", "pos", "generator"):
            assert torch.equal(start[k], first[k]), (planner, k)
    # the vetted goals sit clear of the ground truth (the ring search)
    _, mp, _, _ = marathon.params()
    st = out["states"][mode, "expert"]
    dis = query.distance(st.scene, first["goal"][:, None])
    assert bool((dis > mp.goal_clear_dis).all()), dis
