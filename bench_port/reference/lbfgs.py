"""Batched L-BFGS with a backtracking line search, in plain PyTorch.

The port of neoplanner_tpu/ops/lbfgs.py ``minimize`` (:84): the masked
fixed-trip solver, here over a leading problem axis N instead of vmap. Each
problem keeps its own ring history, step and convergence flag; a finished
problem is frozen while the others iterate, so every problem's result is
what it would be alone. It is the plain version of the in-kernel solver
(plan/solve.py, ``csrc/lbfgs_scene.cu``), which follows the same rules.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class LBFGSResult(NamedTuple):
    x: torch.Tensor          # (N, n)
    f: torch.Tensor          # (N,)
    g: torch.Tensor          # (N, n)
    iters: torch.Tensor      # (N,) int32
    converged: torch.Tensor  # (N,) bool


def value_and_grad(fun: Callable, x: torch.Tensor):
    """(f (N,), g (N, n)) of a batched objective of independent problems."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        f = fun(xr)
        (g,) = torch.autograd.grad(f.sum(), xr)
    return f.detach(), g


def _two_loop(g, s_hist, y_hist, rho, head, count, m):
    """Search direction -H·g from each problem's masked ring history."""
    rows = torch.arange(g.shape[0], device=g.device)
    q = g
    alphas = torch.zeros_like(rho)
    for i in range(m):
        idx = torch.remainder(head - 1 - i, m)
        valid = (i < count).to(g.dtype)
        alpha = rho[rows, idx] * (s_hist[rows, idx] * q).sum(-1) * valid
        q = q - alpha[:, None] * y_hist[rows, idx]
        alphas[rows, idx] = alpha
    newest = torch.remainder(head - 1, m)
    s_n, y_n = s_hist[rows, newest], y_hist[rows, newest]
    sy = (s_n * y_n).sum(-1)
    yy = (y_n * y_n).sum(-1)
    gamma = torch.where(count > 0, sy / torch.clamp(yy, min=1e-20),
                        torch.ones_like(sy))
    r = gamma[:, None] * q
    for i in range(m):
        idx = torch.remainder(head - count + i, m)
        valid = (i < count).to(g.dtype)
        beta = rho[rows, idx] * (y_hist[rows, idx] * r).sum(-1) * valid
        r = r + s_hist[rows, idx] * ((alphas[rows, idx] - beta)
                                     * valid)[:, None]
    return -r


def minimize(fun: Callable, x0: torch.Tensor, *, max_iters: int = 256,
             history: int = 10, max_ls: int = 8, ftol: float = 1e-9,
             gtol: float = 1e-6, c1: float = 1e-4,
             skip: Optional[torch.Tensor] = None,
             ls_fun: Optional[Callable] = None) -> LBFGSResult:
    """Minimize the batched ``fun(x (N, n)) -> (N,)`` from x0 (N, n).

    skip (N,) bool freezes problems from the start: they return x0 with
    iters 0 (the lazy retry bank of plan/expert.py).

    ls_fun, when given, evaluates all line-search candidates in one call,
    (N, max_ls, n) -> (N, max_ls) (the JAX package's wide line search,
    lbfgs.py:84-112, :131-139): it must compute fun's value, needs no
    gradient, and suits a forward-only kernel. Without it each candidate
    step is one call of fun. The accepted point is evaluated with fun's
    value and gradient either way.
    """
    N, n = x0.shape
    m = history
    dev, dt = x0.device, x0.dtype
    x = x0.detach().clone()
    f, g = value_and_grad(fun, x)
    s_hist = torch.zeros((N, m, n), dtype=dt, device=dev)
    y_hist = torch.zeros((N, m, n), dtype=dt, device=dev)
    rho = torch.zeros((N, m), dtype=dt, device=dev)
    head = torch.zeros(N, dtype=torch.long, device=dev)
    count = torch.zeros(N, dtype=torch.long, device=dev)
    it = torch.zeros(N, dtype=torch.int32, device=dev)
    done = torch.isnan(f) | (g.abs().amax(-1) <= gtol)
    if skip is not None:
        done = done | skip
    halves = 0.5 ** torch.arange(max_ls, dtype=dt, device=dev)
    rows = torch.arange(N, device=dev)

    for _ in range(max_iters):
        if bool(done.all()):
            break
        d = _two_loop(g, s_hist, y_hist, rho, head, count, m)
        gtd = (g * d).sum(-1)
        bad = (gtd >= 0.0) | torch.isnan(gtd)
        d = torch.where(bad[:, None], -g, d)
        gtd = torch.where(bad, -(g * g).sum(-1), gtd)
        t0 = torch.where(it == 0, torch.clamp(
            1.0 / torch.clamp(g.abs().sum(-1), min=1e-12), max=1.0),
            torch.ones_like(gtd))
        steps = t0[:, None] * halves                            # (N, L)
        if ls_fun is None:
            f_cand = torch.stack([fun(x + steps[:, k:k + 1] * d)
                                  for k in range(max_ls)], dim=1)
        else:
            f_cand = ls_fun(x[:, None] + steps[..., None] * d[:, None])
        armijo = f_cand <= f[:, None] + c1 * steps * gtd[:, None]
        ls_ok = armijo.any(1)
        first_ok = torch.argmax(armijo.to(torch.int8), dim=1)
        best = torch.argmin(torch.where(torch.isnan(f_cand),
                                        torch.full_like(f_cand, float("inf")),
                                        f_cand), dim=1)
        pick = torch.where(ls_ok, first_ok, best)
        t = steps[rows, pick]
        f_try = f_cand[rows, pick]
        accept = ls_ok | (f_try < f)
        x_new = torch.where(accept[:, None], x + t[:, None] * d, x)
        f_new, g_new = value_and_grad(fun, x_new)

        s = x_new - x
        y = g_new - g
        ys = (y * s).sum(-1)
        store = accept & (ys > 1e-10) & ~done
        sel = rows[store]
        s_hist[sel, head[store]] = s[store]
        y_hist[sel, head[store]] = y[store]
        rho[sel, head[store]] = 1.0 / torch.clamp(ys[store], min=1e-20)
        head = torch.where(store, torch.remainder(head + 1, m), head)
        count = torch.where(store, torch.clamp(count + 1, max=m), count)

        f_drop = (f - f_new) / torch.clamp(
            torch.maximum(f.abs(), f_new.abs()), min=1.0)
        done_new = ((f_drop <= ftol) & accept) \
            | (g_new.abs().amax(-1) <= gtol) | ~accept | torch.isnan(f_new)
        live = ~done
        x = torch.where(live[:, None], x_new, x)
        f = torch.where(live, f_new, f)
        g = torch.where(live[:, None], g_new, g)
        it = it + live.to(torch.int32)
        done = done | (live & done_new)
    return LBFGSResult(x=x, f=f, g=g, iters=it, converged=done)


def minimize_batched(fun: Callable, x0_batch: torch.Tensor,
                     **kwargs) -> LBFGSResult:
    """The JAX package's vmap convenience wrapper (lbfgs.py:194): x0_batch
    (N, n) -> the batched LBFGSResult. :func:`minimize` is batched over
    its leading problem axis already, so this is minimize itself."""
    return minimize(fun, x0_batch, **kwargs)
