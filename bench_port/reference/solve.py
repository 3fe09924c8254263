"""The L-BFGS trajectory solve, plain: ops/lbfgs.minimize on the plain
objective (costs.objective) with its gradient from autograd, over the
scene SDF or each env's ESDF window. A frozen copy of the plain branch of
the port's plan/solve.py (``_solve_plain``), the version that kernels B1
(scene) and B6 (windows) are held to."""

from __future__ import annotations

from functools import partial

from . import costs, lbfgs

# stopping and Armijo constants of the bank's solves
FTOL, GTOL, C1 = 1e-10, 1e-8, 1e-4


def solve_plain(x0, head, tail, pmap, env_of, pp, skip=None):
    """Solve P problems: x0 (P, nv), head/tail (P, 3, 2), problem p on the
    map (a SceneMap or a GridWindow) of env ``env_of[p]``; skip (P,) bool
    returns x0 unsolved with iters 0. Returns (x, f, iters)."""
    fun = partial(costs.objective, head_state=head, tail_state=tail,
                  pmap=pmap.index(env_of), pp=pp)
    res = lbfgs.minimize(fun, x0, max_iters=pp.max_iters, history=pp.history,
                         max_ls=pp.max_ls, ftol=FTOL, gtol=GTOL, c1=C1,
                         skip=skip)
    return res.x, res.f, res.iters
