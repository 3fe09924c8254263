"""Benchmark record keeping and aggregation.

The port of neoplanner_tpu/utils/metrics.py. It replicates the reference's
metric pipeline: the 14-field per-mission line of data/planning_metrics.txt
(traj_planner_node.py:288-308) and the per planner x world aggregation of
bash/analyze_data.py:11-71 (success rate, average weighted metric, average
planning duration, average L-BFGS iterations, average target-find time,
average planning count). Records come from batched env rollouts instead of
sequential Gazebo runs, so one call aggregates thousands of missions.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from neoplanner_tpu_torch.config import PlannerParams


@dataclass
class MissionRecord:
    world: str
    num_models: int
    planner: str
    replan_mode: str
    reached: bool
    goal_x: float
    goal_y: float
    find_time: float
    max_find_time: float
    weighted_metric: float
    avg_iter_num: float
    avg_planning_duration: float
    planning_times: int


def from_env_states(states, world_name: str, num_models: int, planner: str,
                    wall_time_per_plan: float, pp: PlannerParams,
                    replan_mode: str = "periodic",
                    max_find_time: float = 45.0) -> List[MissionRecord]:
    """Records of a batch of terminal EnvStates (leading env axis). A
    mission counts as reached when it reached its goal with a weighted
    metric within 10 pp.collision_cost_tol (traj_planner_node.py:359-362;
    the JAX package writes the default tolerance, 5.0, as a constant)."""
    from neoplanner_tpu_torch.sim import env as env_mod

    def host(t):
        return t.detach().cpu().numpy()

    reached = host(states.reached)
    steps = host(states.steps)
    metrics = host(states.metrics)
    plan_count = host(states.plan_count)
    iter_sum = host(states.iter_sum)
    goals = host(states.goal)
    weights = np.asarray(env_mod.METRIC_WEIGHTS)

    records = []
    for i in range(len(reached)):
        wm = float(metrics[i] @ weights)
        ok = bool(reached[i]) and wm <= 10 * pp.collision_cost_tol
        pc = max(int(plan_count[i]), 1)
        records.append(MissionRecord(
            world=world_name, num_models=num_models, planner=planner,
            replan_mode=replan_mode, reached=ok,
            goal_x=float(goals[i][0]), goal_y=float(goals[i][1]),
            find_time=float(steps[i]) / 60.0, max_find_time=max_find_time,
            weighted_metric=wm,
            avg_iter_num=float(iter_sum[i]) / pc,
            avg_planning_duration=wall_time_per_plan,
            planning_times=int(plan_count[i])))
    return records


def write_metrics_file(path: str, records: List[MissionRecord]) -> None:
    """Append reference-format planning_metrics.txt lines
    (traj_planner_node.py:292-308)."""
    import os

    stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        for r in records:
            f.write(" ".join([
                stamp, r.world, str(r.num_models), r.planner, r.replan_mode,
                str(r.reached), str(r.goal_x), str(r.goal_y),
                str(r.find_time), str(r.max_find_time),
                str(r.weighted_metric), str(r.avg_iter_num),
                str(r.avg_planning_duration), str(r.planning_times)]) + "\n")


def read_metrics_file(path: str) -> List[MissionRecord]:
    records = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) != 15:
                continue
            records.append(MissionRecord(
                world=p[2], num_models=int(p[3]), planner=p[4],
                replan_mode=p[5], reached=p[6] == "True", goal_x=float(p[7]),
                goal_y=float(p[8]), find_time=float(p[9]),
                max_find_time=float(p[10]), weighted_metric=float(p[11]),
                avg_iter_num=float(p[12]), avg_planning_duration=float(p[13]),
                planning_times=int(p[14])))
    return records


def save_tracking_csv(path: str, traces: np.ndarray, cmd_hz: int = 60) -> str:
    """Write the reference's tracking-error CSV (save_tracking_err,
    traj_planner_node.py:310-331: time, drone pos/vel xy, desired pos/vel xy).

    traces: (steps, 5, 3) stacked SegmentInfo.trace rows of one env
    ([pos, vel, des_pos, des_vel, des_acc] per substep), numpy or on the
    CPU.
    """
    tr = np.asarray(traces).reshape(-1, 5, 3)
    with open(path, "w") as f:
        f.write("time,global_pos_x,global_pos_y,global_vel_x,global_vel_y,"
                "des_global_pos_x,des_global_pos_y,des_global_vel_x,"
                "des_global_vel_y\n")
        for i, row in enumerate(tr):
            f.write(f"{i / cmd_hz:.4f},{row[0, 0]:.5f},{row[0, 1]:.5f},"
                    f"{row[1, 0]:.5f},{row[1, 1]:.5f},{row[2, 0]:.5f},"
                    f"{row[2, 1]:.5f},{row[3, 0]:.5f},{row[3, 1]:.5f}\n")
    return path


def analyze(records: List[MissionRecord]) -> Dict[str, Dict[str, dict]]:
    """Per planner × world aggregation (analyze_data.py:11-46 semantics:
    success rate over all runs; other averages over successful runs)."""
    out: Dict[str, Dict[str, dict]] = {}
    keys = sorted({(r.planner, r.world) for r in records})
    for planner, world in keys:
        rs = [r for r in records if r.planner == planner and r.world == world]
        good = [r for r in rs if r.reached]
        agg = {
            "runs": len(rs),
            "success_rate": len(good) / len(rs) if rs else 0.0,
            "avg_weighted_metric": float(np.mean(
                [r.weighted_metric for r in good])) if good else float("nan"),
            "avg_planning_duration": float(np.mean(
                [r.avg_planning_duration for r in good])) if good else
                float("nan"),
            "avg_iter_num": float(np.mean(
                [r.avg_iter_num for r in good])) if good else float("nan"),
            "avg_find_time": float(np.mean(
                [r.find_time for r in good])) if good else float("nan"),
            "avg_planning_times": float(np.mean(
                [r.planning_times for r in good])) if good else float("nan"),
        }
        out.setdefault(planner, {})[world] = agg
    return out
