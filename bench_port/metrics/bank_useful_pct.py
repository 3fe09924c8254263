"""plan: the share of the envs that the bank solved whose plan the loop
used, the others not replanning this segment (the window's plan_count
delta over the port's counter bank.envs), in %."""

from harness.counters import window_counts


def read(ctx):
    counts = window_counts(ctx)
    if not counts or not counts.get("bank.envs"):
        return None
    return 100.0 * ctx["plans"] / counts["bank.envs"]
