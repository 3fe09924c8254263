"""plan: the share of the envs handed to the lazy bank whose remaining
lanes were solved after their first lanes (the port's counters
bank.retry_envs / bank.envs over the window), in %."""

from harness.counters import window_counts


def read(ctx):
    counts = window_counts(ctx)
    if not counts or not counts.get("bank.envs"):
        return None
    return 100.0 * counts.get("bank.retry_envs", 0) / counts["bank.envs"]
