"""How the solver kernels B1 and B6 (plan/solve.py) are held to their plain
version, solve._solve_plain, problem by problem on the same inputs: the
rules that tests/test_torch_kernels_cuda.py and chip_smoke.py share.

Two f32 solvers that do the same arithmetic in another order agree to
roundoff until a decision of the line search (an Armijo or curvature test
near its threshold) falls the other way on one of them; from there on they
walk apart. One iteration is held to 1e-3 on f (:func:`one_iteration`); a
few iterations past the L-BFGS history, so that its ring has wrapped, are
held to 1e-3 on f and x, problem by problem, with the plain solver run on
another device as the control of how many problems roundoff alone parts
(:func:`few_iterations`).
"""

from __future__ import annotations

import dataclasses

import torch

from neoplanner_tpu_torch.plan import objective, solve


def rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| / max(|b|, 1), elementwise, on the CPU."""
    a, b = a.cpu(), b.cpu()
    return (a - b).abs() / b.abs().clamp(min=1.0)


def _on_cpu(pmap, dtype=None):
    """A map dataclass with its tensors on the CPU, its floating ones in
    dtype (kept when None)."""
    def move(t):
        t = t.cpu()
        return t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t
    return type(pmap)(*(move(getattr(pmap, f.name))
                        for f in dataclasses.fields(pmap)))


def one_iteration(x0, head, tail, pmap, env_of, pp, got, want):
    """Hold one L-BFGS iteration of a solver kernel, got = (x, f, iters),
    to the plain solver's, want: f within 1e-3 relative. On at most 1
    problem in 16 it may miss that, for either of two reasons that roundoff
    gives: a window sample on a cell edge took the other cell, whose
    bilinear gradient differs (then f is within 1e-3 of the plain solver's
    in f64); or the two Armijo tests fell either side of their threshold
    and the line search stopped at another backtracking step (then the
    steps point the same way, cosine >= 1 - 1e-3, their lengths differ by
    a power of 2 within 1e-3 of its exponent, and the kernel's f is the
    plain objective's at the kernel's x within 1e-3). Raises
    AssertionError otherwise; returns (the largest relative f difference
    on the other problems, the count of problems that missed 1e-3)."""
    x0, head, tail, env_of = (t.cpu() for t in (x0, head, tail, env_of))
    x_k, f_k = got[0].cpu(), got[1].cpu()
    x_p, f_p = want[0].cpu(), want[1].cpu()
    r = rel(f_k, f_p)
    off = r > 1e-3
    n_off = int(off.sum())
    if n_off > max(1, off.numel() // 16):
        raise AssertionError(f"one iteration: f misses the plain solver's "
                             f"by > 1e-3 on {n_off} of {off.numel()} "
                             f"problems")
    if n_off:
        w64 = solve._solve_plain(x0[off].double(), head[off].double(),
                                 tail[off].double(), _on_cpu(pmap,
                                                             torch.float64),
                                 env_of[off], pp)
        near64 = rel(f_k[off].double(), w64[1]) <= 1e-3
        s_k, s_p = x_k[off] - x0[off], x_p[off] - x0[off]
        cos = (s_k * s_p).sum(1) / (s_k.norm(dim=1) * s_p.norm(dim=1))
        power = torch.log2(s_k.norm(dim=1) / s_p.norm(dim=1))
        f_at = objective.plain_fwd(x_k[off], head[off], tail[off],
                                   _on_cpu(pmap), env_of[off], pp)
        flip = (cos >= 1.0 - 1e-3) \
            & ((power - power.round()).abs() <= 1e-3) \
            & (power.round() != 0) & (rel(f_k[off], f_at) <= 1e-3)
        if not bool((near64 | flip).all()):
            raise AssertionError(
                f"one iteration: f {f_k[off].tolist()} against the plain "
                f"solver's {f_p[off].tolist()} (f64 {w64[1].tolist()}), "
                f"step length ratios 2^{power.tolist()}")
    return (float(r[~off].max()) if n_off < r.numel() else 0.0), n_off


def few_iterations(got, want, control):
    """Hold a few L-BFGS iterations of a solver kernel, got = (x, f, iters),
    to the plain solver's, want, problem by problem: f within 1e-3
    relative and every component of x within 1e-3 (relative, of at least
    1). control is the plain solver run on another device from the same
    inputs: where roundoff tips a line-search decision the paths part, so
    the kernel may miss on no more problems than twice the control misses
    want on, plus 1 in 64. A history ring that is read in the wrong order
    once it wraps turns the directions of every problem. Raises
    AssertionError otherwise; returns (the kernel's misses, the
    control's, the largest relative difference of f and x on the problems
    within 1e-3)."""
    def misses(res):
        r = torch.maximum(rel(res[1], want[1]),
                          rel(res[0], want[0]).amax(1))
        return r > 1e-3, r
    off_k, r_k = misses(got)
    off_c, _ = misses(control)
    n_k, n_c, n = int(off_k.sum()), int(off_c.sum()), off_k.numel()
    worst = float(r_k[~off_k].max()) if n_k < n else 0.0
    if n_k > 2 * n_c + n // 64:
        raise AssertionError(
            f"{int(want[2].max())} iterations: f or x misses the plain "
            f"solver's by > 1e-3 on {n_k} of {n} problems (the plain "
            f"solver on another device on {n_c}; tol 2 x {n_c} + {n // 64})")
    return n_k, n_c, worst
