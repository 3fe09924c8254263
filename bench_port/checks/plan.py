"""The bank's accepted trajectories (B1 or B6, B5's acceptance):
``plan_gap_p50`` (p75, p90), the quantiles over envs of the relative gap
of the weighted cost of each env's pick, both evaluated by the reference
(a few problems take another path through L-BFGS on roundoff, so the
upper quantiles swing), and ``plan_ok_off``, the share of envs whose
acceptance differs. Leaves the reader's inputs and the pick it judged in
``cap.plan_in`` for the setpoints' reader (``cmd``)."""

import dataclasses

import torch

from harness.check import Ref, lower
from reference import costs as rcosts, expert as rexpert, types as rtypes

HOOKS = (("neoplanner_tpu_torch.plan.expert", "plan"),
         ("neoplanner_tpu_torch.plan.expert", "warm_start_plan"))


def read(cap, exact, low, control, system) -> dict:
    readings = {}
    for name, args, kw, out in cap.of(*(h[1] for h in HOOKS)):
        fn = getattr(rexpert, name)

        def run(c):
            return fn(c(args[0]), *(c(a) for a in args[1:]))
        ref = run(exact)
        if control:
            got = run(low)
            got = dataclasses.replace(got, int_wpts=lower(got.int_wpts),
                                      ts=lower(got.ts))
        else:
            got = exact(out)
        readings = gaps(exact, args, ref, got)
        cap.plan_in = (exact(args[1]), exact(args[2]), got)
    return readings


def gaps(exact, args, ref, got) -> dict:
    """Quantiles over envs of the relative gap between the weighted costs
    of two banks' picks, both evaluated by the reference; the share of
    envs whose acceptance differs."""
    pmap, head, tail, pp = (exact(args[0]), exact(args[1]), exact(args[2]),
                            exact(args[-1]))
    grid = isinstance(pmap, rtypes.ESDFMap)
    cost_pp = (dataclasses.replace(pp, esdf_interp="nearest") if grid
               else pp)
    rows = pmap.index(torch.arange(head.shape[0], device=head.device))
    w = rcosts.weights(pp, head.device)

    def total(traj):
        with torch.no_grad():
            cvec, _ = rcosts.traj_costs(head, tail, traj.int_wpts, traj.ts,
                                        rows, cost_pp)
        return cvec @ w
    jr, jg = total(ref), total(got)
    rel = ((jg - jr).abs() / jr.abs().clamp(min=1.0)).float()
    rel = torch.nan_to_num(rel, nan=float("inf"))
    q = torch.quantile(rel, torch.tensor([0.5, 0.75, 0.9], device=rel.device))
    return {"plan_gap_p50": float(q[0]), "plan_gap_p75": float(q[1]),
            "plan_gap_p90": float(q[2]),
            "plan_ok_off": float((ref.ok.cpu() != got.ok.cpu())
                                 .float().mean())}


def witness(cap, system, idx: torch.Tensor) -> dict:
    """The bank's roundoff alone: the reference on the card against the
    same reference on the CPU, from the same inputs, as ``plan_gap_*``."""
    exact = Ref(system.envs, idx)
    cpu = Ref(system.envs, idx, device="cpu")
    out = {}
    for name, args, kw, _ in cap.of(*(h[1] for h in HOOKS)):
        fn = getattr(rexpert, name)
        ref = fn(exact(args[0]), *(exact(a) for a in args[1:]))
        host = fn(cpu(args[0]), *(cpu(a) for a in args[1:]))
        host = dataclasses.replace(
            host, int_wpts=host.int_wpts.to(ref.int_wpts.device),
            ts=host.ts.to(ref.ts.device))
        out = gaps(exact, args, ref, host)
    return {f"witness_{k}": v for k, v in out.items()}
