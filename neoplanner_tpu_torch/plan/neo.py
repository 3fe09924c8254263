"""NEO planner: network-predicted initialization + expert refinement — the
port of neoplanner_tpu/plan/neo.py ``enhanced_plan`` (:22)."""

from __future__ import annotations

import torch

from neoplanner_tpu_torch.config import PlannerParams
from neoplanner_tpu_torch.core.types import DroneState, Trajectory
from neoplanner_tpu_torch.plan import expert, nn_init
from neoplanner_tpu_torch.utils.profiling import stage


def enhanced_plan(pmap, net, depth: torch.Tensor, drone: DroneState,
                  des_pos_z: float, plan_init_state: torch.Tensor,
                  target_state: torch.Tensor, noise: torch.Tensor,
                  pp: PlannerParams, timer=None,
                  solver: str = "fused") -> Trajectory:
    """NN warm start, then the lazy warm-start bank (neo_planner.py:42-51),
    solved by ``solver`` (plan/expert.py). States are (B, 2, 2) [pos; vel];
    noise (B, retry_num, D, M-1). A StageTimer records the 'net' and 'plan'
    stages."""
    with stage(timer, "net"):
        int_wpts0, ts0 = nn_init.predict(net, depth, drone, des_pos_z,
                                         plan_init_state, target_state, pp)
    with stage(timer, "plan"):
        head = expert.pad_boundary_state(plan_init_state, pp)
        tail = expert.pad_boundary_state(target_state, pp)
        return expert.warm_start_plan(pmap, head, tail, int_wpts0, ts0,
                                      noise, pp, solver=solver)
