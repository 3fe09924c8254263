"""MINCO minimum-jerk piecewise-quintic trajectory math, batched in torch.

The port of neoplanner_tpu/ops/minco.py: M quintic pieces in D dims pinned by
head/tail states (pos, vel, acc), M-1 intermediate waypoints and durations T,
through a (6M, 6M) banded system A(T) · coeffs = b(q). Every function takes a
leading problem axis N.

The banded solve is the one kernel here (B5). It replaces the Pallas kernel
``ops/minco_pallas.py`` ``_make_kernel`` (the batched Givens-QR solve,
dispatched from minco.py:124-134): :func:`banded_solve` launches
``csrc/minco_solve.cu`` for CUDA tensors and runs :func:`_givens_solve`, its
plain PyTorch version, for CPU tensors. Its gradient is the implicit adjoint
(one transposed banded solve), as in the JAX package's custom_vjp.
"""

from __future__ import annotations

import numpy as np
import torch

from neoplanner_tpu_torch import _cuda

_J = np.arange(6)


def _falling(k: int) -> np.ndarray:
    """Static coefficients j!/(j-k)! for d^k/dt^k t^j, zero where j < k."""
    out = np.ones(6)
    for step in range(k):
        out = out * np.maximum(_J - step, 0)
    return out


_FALLING = np.stack([_falling(k) for k in range(6)])  # (6, 6)


def beta(t: torch.Tensor, k: int) -> torch.Tensor:
    """Basis row d^k/dt^k [1, t, ..., t^5] at t: (...,) -> (..., 6)."""
    exps = torch.as_tensor(np.maximum(_J - k, 0), device=t.device)
    powers = t[..., None] ** exps
    fall = torch.as_tensor(_FALLING[k], dtype=t.dtype, device=t.device)
    mask = torch.as_tensor(_J >= k, device=t.device)
    return fall * torch.where(mask, powers, torch.zeros_like(powers))


def _system_pattern(M: int):
    """Static (row, col) pattern of A and the value source of each entry:
    ('beta', piece, k, j) for basis entries, ('const', v) for constants."""
    rows, cols, src = [0, 1, 2], [0, 1, 2], [("const", 1.0), ("const", 1.0),
                                             ("const", 2.0)]
    n = 6 * M
    for i in range(M - 1):
        r, c = 6 * i + 3, 6 * i
        for k_row, k in [(r, 0), (r + 1, 0), (r + 2, 1), (r + 3, 2),
                         (r + 4, 3), (r + 5, 4)]:
            for j in range(6):
                rows.append(k_row)
                cols.append(c + j)
                src.append(("beta", i, k, j))
        for k in range(5):
            rows.append(r + 1 + k)
            cols.append(c + 6 + k)
            src.append(("const", -_FALLING[k][k]))
    for k in range(3):
        for j in range(6):
            rows.append(n - 3 + k)
            cols.append(n - 6 + j)
            src.append(("beta", M - 1, k, j))
    return rows, cols, src


def build_system(head_state: torch.Tensor, tail_state: torch.Tensor,
                 int_wpts: torch.Tensor, ts: torch.Tensor):
    """A (N, 6M, 6M) and b (N, 6M, D) of the min-jerk (s=3) system, in the
    row layout of neoplanner_tpu.ops.minco.build_system.

    head_state/tail_state (N, 3, D); int_wpts (N, D, M-1); ts (N, M)."""
    N, M = ts.shape
    D = head_state.shape[-1]
    n = 6 * M
    rows, cols, src = _system_pattern(M)
    betas = {}
    vals = []
    for s in src:
        if s[0] == "const":
            vals.append(ts.new_full((N,), float(s[1])))
        else:
            _, i, k, j = s
            if (i, k) not in betas:
                betas[(i, k)] = beta(ts[:, i], k)            # (N, 6)
            vals.append(betas[(i, k)][:, j])
    A = ts.new_zeros((N, n, n))
    A[:, rows, cols] = torch.stack(vals, dim=1)
    b = ts.new_zeros((N, n, D))
    b[:, 0:3] = head_state
    b[:, n - 3:n] = tail_state
    b[:, [6 * i + 3 for i in range(M - 1)]] = int_wpts.transpose(1, 2)
    return A, b


# lower bandwidth 4, upper 2; Givens QR fills the upper band to 4 + 2 = 6
_LOWER_BW = 4
_UPPER_BW = 6


def _givens_solve(A: torch.Tensor, b: torch.Tensor, lower_bw: int,
                  upper_bw: int) -> torch.Tensor:
    """Plain form of the banded Givens-QR solve of A x = b: A (N, n, n),
    b (N, n, d) -> x (N, n, d); the rotation sequence of minco._givens_solve."""
    n = A.shape[1]
    rows = [torch.cat([A[:, i], b[:, i]], dim=-1) for i in range(n)]
    for c in range(n):
        for r in range(c + 1, min(c + lower_bw + 1, n)):
            a_cc = rows[c][:, c:c + 1]
            a_rc = rows[r][:, c:c + 1]
            denom = torch.sqrt(a_cc * a_cc + a_rc * a_rc)
            safe = denom > 1e-20
            inv = torch.where(safe, 1.0 / torch.where(safe, denom,
                                                      torch.ones_like(denom)),
                              torch.zeros_like(denom))
            cs = torch.where(safe, a_cc * inv, torch.ones_like(denom))
            sn = a_rc * inv
            rc, rr = rows[c], rows[r]
            rows[c] = cs * rc + sn * rr
            rows[r] = cs * rr - sn * rc
    fill = lower_bw + upper_bw
    xs = [None] * n
    for c in range(n - 1, -1, -1):
        acc = rows[c][:, n:]
        for j in range(c + 1, min(c + fill + 1, n)):
            acc = acc - rows[c][:, j:j + 1] * xs[j]
        xs[c] = acc / rows[c][:, c:c + 1]
    return torch.stack(xs, dim=1)


def banded_solve(A: torch.Tensor, b: torch.Tensor, lower_bw: int,
                 upper_bw: int) -> torch.Tensor:
    """Batched banded solve: the CUDA kernel (B5) for CUDA tensors, the plain
    Givens form for CPU tensors. A (N, n, n), b (N, n, d) -> x (N, n, d)."""
    if not A.is_cuda:
        return _givens_solve(A, b, lower_bw, upper_bw)
    return _banded_solve_cuda(A, b, lower_bw, upper_bw)


# ---------------------------------------------------------------------------
# B5: csrc/minco_solve.cu
#
# Replaces: neoplanner_tpu/ops/minco_pallas.py _make_kernel (:37), launched
# from _solve_batch (:81) through solve_one (:123).
# Bound on the H100: device memory by the bytes. Per problem the kernel reads
# the n x (n + 2) augmented system (n = 6M: 1,440 B at M = 3) and writes
# n x 2 floats for ~3,000 flops at M = 3, about 2 flops per byte, far below
# the ~20 flop/byte f32 ridge; at small M the warp's chain of rotations is
# what the card reaches.
# Design: one warp per problem, two a block, on the objective kernels' warp
# solve (neo::warp_givens_solve): the band of each column and the right-hand
# sides in the warp's shared memory, column j on lane j % 32, each column's
# rotations in registers. One build per M in 2..16 (_cuda.load_pieces).
# ---------------------------------------------------------------------------

_KERNEL_D = 2


def _banded_solve_cuda(A, b, lower_bw, upper_bw):
    N, n, _ = A.shape
    d = b.shape[2]
    if n % 6 or n // 6 not in _cuda.PIECES or d != _KERNEL_D \
            or lower_bw + upper_bw != 6 or lower_bw not in (2, 4):
        raise ValueError(f"the CUDA banded solve is built for n = 6M with M "
                         f"in {_cuda.PIECES.start}..{_cuda.PIECES.stop - 1}, "
                         f"d=2, bands (4, 2) or (2, 4); got n={n}, d={d}, "
                         f"bands ({lower_bw}, {upper_bw})")
    aug = torch.cat([A, b], dim=2).to(torch.float32).contiguous()
    out = torch.empty((N, n, d), dtype=torch.float32, device=A.device)
    launch_banded_solve(aug, out, lower_bw)
    return out


def launch_banded_solve(aug: torch.Tensor, out: torch.Tensor,
                        lower_bw: int) -> None:
    """Launch B5 on the augmented systems aug (N, n, n + 2), n = 6M, into
    out (N, n, 2); lower_bw 4 (A) or 2 (A^T)."""
    N, n = aug.shape[:2]
    if n % 6:
        raise ValueError(f"aug: {n} rows, not 6M")
    _cuda.require(aug, "aug", (N, n, n + _KERNEL_D), torch.float32,
                  aug.device)
    _cuda.require(out, "out", (N, n, _KERNEL_D), torch.float32, aug.device)
    _cuda.check_pieces(n // 6, "the CUDA banded solve")
    if N == 0:
        return
    lib = _cuda.load_pieces(n // 6)
    err = lib.neo_minco_banded_solve(_cuda.ptr(aug), _cuda.ptr(out), N,
                                     lower_bw, _cuda.stream_ptr(aug.device))
    _cuda.check(err, "minco_banded_solve")
    _cuda.launches["minco_banded_solve"] += 1


class _SolveBanded(torch.autograd.Function):
    """Banded solve of A x = b with the implicit adjoint: A^T lam = x_bar,
    A_bar = -lam x^T, b_bar = lam (expert_planner.py:494-537)."""

    @staticmethod
    def forward(ctx, A, b):
        x = banded_solve(A, b, _LOWER_BW, _UPPER_BW - _LOWER_BW)
        ctx.save_for_backward(A, x)
        return x

    @staticmethod
    def backward(ctx, x_bar):
        A, x = ctx.saved_tensors
        lam = banded_solve(A.transpose(1, 2), x_bar.contiguous(),
                           _UPPER_BW - _LOWER_BW, _LOWER_BW)
        return -lam @ x.transpose(1, 2), lam


def solve_banded(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Differentiable banded solve of the MINCO system (minco.py:169-199)."""
    return _SolveBanded.apply(A, b)


def solve_coeffs(head_state, tail_state, int_wpts, ts) -> torch.Tensor:
    """coeffs (N, 6M, D) solving the boundary/continuity system."""
    A, b = build_system(head_state, tail_state, int_wpts, ts)
    return solve_banded(A, b)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def eval_at(coeffs: torch.Tensor, ts: torch.Tensor, t: torch.Tensor,
            order: int) -> torch.Tensor:
    """order-th derivative at times t (N, T) -> (N, T, D): clamp t to the
    total duration, evaluate every piece's polynomial at its local time and
    select the piece (the smallest idx with cumsum(ts[:idx+1]) >= t)."""
    N, M = ts.shape
    cum = torch.cumsum(ts, dim=1)
    tc = torch.minimum(torch.clamp(t, min=0.0), cum[:, -1:])
    starts = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1)
    piece = (cum[:, None, :-1] < tc[..., None]).sum(-1)
    c_blocks = coeffs.reshape(N, M, 6, -1)
    out = torch.zeros(tc.shape + (c_blocks.shape[-1],), dtype=coeffs.dtype,
                      device=coeffs.device)
    for m in range(M):
        bt = beta(tc - starts[:, m:m + 1], order)              # (N, T, 6)
        val = torch.einsum("ntj,njd->ntd", bt, c_blocks[:, m])
        out = out + torch.where((piece == m)[..., None], val,
                                torch.zeros_like(val))
    return out


def full_state_cmd(coeffs: torch.Tensor, ts: torch.Tensor, hz: int,
                   n_max: int):
    """(pos, vel, acc) setpoints at ``hz``: (state_cmd (N, n_max, 3, D),
    valid (N, n_max) bool, n_valid (N,)). Samples past the end hold the
    final state (traj_utils.py:181-195)."""
    N = ts.shape[0]
    t = (torch.arange(n_max, device=ts.device, dtype=ts.dtype) / hz)
    t = t.expand(N, n_max)
    valid = t < ts.sum(1, keepdim=True)
    state_cmd = torch.stack([eval_at(coeffs, ts, t, k) for k in range(3)],
                            dim=2)
    return state_cmd, valid, valid.sum(1, dtype=torch.int32)


def tau_to_T(tau: torch.Tensor, t_min: float, t_max: float) -> torch.Tensor:
    """T = T_min + (T_max - T_min) * sigmoid(tau) (expert_planner.py:477-483)."""
    return t_min + (t_max - t_min) * torch.sigmoid(tau)


def T_to_tau(ts: torch.Tensor, t_min: float, t_max: float) -> torch.Tensor:
    """Inverse sigmoid, clipped at the rails (expert_planner.py:468-475)."""
    frac = torch.clamp((ts - t_min) / (t_max - t_min), 1e-6, 1.0 - 1e-6)
    return torch.log(frac) - torch.log1p(-frac)


# 3-point Gauss-Legendre on [0, 1]: exact for the degree-4 |jerk|^2
_GL_NODES = np.array([0.5 - np.sqrt(3.0 / 5.0) / 2.0, 0.5,
                      0.5 + np.sqrt(3.0 / 5.0) / 2.0])
_GL_WEIGHTS = np.array([5.0 / 18.0, 8.0 / 18.0, 5.0 / 18.0])


def energy(coeffs: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """Total integral of |jerk|^2 over all pieces, (N,)."""
    N, M = ts.shape
    c = coeffs.reshape(N, M, 6, -1)
    nodes = torch.as_tensor(_GL_NODES, dtype=ts.dtype, device=ts.device)
    wts = torch.as_tensor(_GL_WEIGHTS, dtype=ts.dtype, device=ts.device)
    t = ts[..., None] * nodes                                  # (N, M, 3)
    jerk = torch.einsum("nmkj,nmjd->nmkd", beta(t, 3), c)
    sq = (jerk * jerk).sum(-1)
    return (sq * wts * ts[..., None]).sum((1, 2))
