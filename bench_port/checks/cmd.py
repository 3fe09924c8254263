"""The new setpoints (B5's coefficients, sampled): ``cmd_gap``, the
largest gap. Judged on the pick that the ``plan`` reader judged, so it
follows that reader in a configuration's ``check.layers``."""

from harness.check import lower
from reference import minco as rminco

HOOKS = (("neoplanner_tpu_torch.ops.minco", "full_state_cmd"),)


def read(cap, exact, low, control, system) -> dict:
    calls = cap.of("full_state_cmd")
    plan_in = getattr(cap, "plan_in", None)
    if not calls or plan_in is None:
        return {}
    _, args, kw, out = calls[-1]
    head, tail, traj = plan_in
    hz, n = args[2], args[3]

    def run(q, ts):
        coeffs = rminco.solve_coeffs(head, tail, q, ts)
        return rminco.full_state_cmd(coeffs, ts, hz, n)[0]
    ref = run(traj.int_wpts, traj.ts)
    got = (lower(run(lower(traj.int_wpts), lower(traj.ts))) if control
           else exact.t(out[0]))
    return {"cmd_gap": float((got - ref).abs().max())}
