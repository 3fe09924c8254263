"""plan: the L-BFGS iterations that the envs' replans spent (the bank's
lanes summed), per replan, over the window (the state's iter_sum and
plan_count)."""


def read(ctx):
    return ctx["iters"] / ctx["plans"] if ctx["plans"] else None
