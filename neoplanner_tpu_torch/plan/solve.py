"""The whole L-BFGS trajectory solve on the scene SDF: kernel B1 (+ B2).

:func:`solve_scene` is the port of neoplanner_tpu/plan/solve_pallas.py
``solve_scene`` (:349). For CUDA tensors it launches
``csrc/lbfgs_scene.cu``: one thread per problem runs the full solver, with
the objective and its hand adjoint (``csrc/scene_objective.cuh``, the port
of the plan/costs_pallas.py device functions) inlined. For CPU tensors it
runs the plain version: ops/lbfgs.minimize on plan/costs.objective, with the
gradient from autograd.

Replaces: plan/solve_pallas.py ``_make_solver_kernel`` (:223) with
``lbfgs_in_kernel`` (:49), and the costs_pallas.py device functions (B2).
Bound on the H100: operations and per-thread latency — a 24-iteration solve
is ~100 objective evaluations of ~72 samples x 24 primitives in sequence in
one thread, from a few hundred bytes of input. Design: one thread per
problem, per-thread early exit (the TPU kernel had to run a 512-lane tile
until its last lane finished), per-thread primitive slices in shared memory.
"""

from __future__ import annotations

from functools import partial

import torch

from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import PlannerParams
from neoplanner_tpu_torch.mapping import scene as scene_map
from neoplanner_tpu_torch.ops import lbfgs
from neoplanner_tpu_torch.plan import costs

_BLOCK = 64            # threads per block of the kernel (csrc/lbfgs_scene.cu)
_SMEM_LIMIT = 48 * 1024
# stopping and Armijo constants of plan/expert.solve_one's solves
FTOL, GTOL, C1 = 1e-10, 1e-8, 1e-4


def solve_scene(x0: torch.Tensor, head: torch.Tensor, tail: torch.Tensor,
                scene: scene_map.SceneMap, env_of: torch.Tensor,
                pp: PlannerParams, skip=None):
    """Solve P problems: x0 (P, nv), head/tail (P, 3, 2), problem p on the
    scene of env ``env_of[p]``. skip (P,) bool marks problems returned
    unsolved (x0, iters 0). Returns (x (P, nv), f (P,), iters (P,) int32);
    f of a skipped problem is not defined."""
    if not x0.is_cuda:
        return _solve_plain(x0, head, tail, scene, env_of, pp, skip)
    return _solve_cuda(x0, head, tail, scene, env_of, pp, skip)


def _solve_plain(x0, head, tail, scene, env_of, pp, skip=None):
    fun = partial(costs.objective, head_state=head, tail_state=tail,
                  scene=scene.index(env_of), pp=pp)
    res = lbfgs.minimize(fun, x0, max_iters=pp.max_iters, history=pp.history,
                         max_ls=pp.max_ls, ftol=FTOL, gtol=GTOL, c1=C1,
                         skip=skip)
    return res.x, res.f, res.iters


def _solve_cuda(x0, head, tail, scene, env_of, pp, skip):
    if (pp.num_pieces, pp.dims, pp.history) != (3, 2, 10) \
            or pp.sampling != "relative" or pp.samples_per_piece < 2:
        raise ValueError("the CUDA solver is built for M=3 pieces, D=2, "
                         "history 10 and relative sampling")
    dev = x0.device
    P = x0.shape[0]
    args = dict(
        x0=x0.to(torch.float32).contiguous(),
        head=head.to(torch.float32).contiguous(),
        tail=tail.to(torch.float32).contiguous(),
        prims=scene_map.pack_prims(scene),
        env_of=env_of.to(torch.int32).contiguous(),
        skip=(torch.zeros(P, dtype=torch.int32, device=dev) if skip is None
              else skip.to(torch.int32).contiguous()))
    out = (torch.empty_like(args["x0"]),
           torch.empty(P, dtype=torch.float32, device=dev),
           torch.empty(P, dtype=torch.int32, device=dev))
    launch_solver(**args, out=out, pp=pp)
    return out


def launch_solver(x0, head, tail, prims, env_of, skip, out, pp) -> None:
    """Launch B1 on prepared tensors: x0 (P, 7), head/tail (P, 3, 2), prims
    (E, K, 6) (mapping/scene.pack_prims), env_of and skip (P,) int32;
    writes out = (x (P, 7), f (P,), iters (P,) int32)."""
    dev = x0.device
    P = x0.shape[0]
    E, n_prims = prims.shape[:2]
    if n_prims * 6 * _BLOCK * 4 > _SMEM_LIMIT:
        raise ValueError(f"{n_prims} primitives exceed the solver's shared "
                         f"memory ({_SMEM_LIMIT} B per block)")
    for t, name, shape in ((x0, "x0", (P, 7)), (head, "head", (P, 3, 2)),
                           (tail, "tail", (P, 3, 2)),
                           (prims, "prims", (E, n_prims, 6)),
                           (out[0], "x", (P, 7)), (out[1], "f", (P,))):
        _cuda.require(t, name, shape, torch.float32, dev)
    for t, name in ((env_of, "env_of"), (skip, "skip"), (out[2], "iters")):
        _cuda.require(t, name, (P,), torch.int32, dev)
    if P == 0:
        return
    lib = _cuda.load()
    params = _cuda.host_floats([pp.t_min, pp.t_max, pp.v_max, pp.safe_dis,
                                pp.w_energy, pp.w_time, pp.w_feas,
                                pp.w_collision, FTOL, GTOL, C1])
    err = lib.neo_lbfgs_scene_solve(
        _cuda.ptr(x0), _cuda.ptr(head), _cuda.ptr(tail), _cuda.ptr(prims),
        _cuda.ptr(env_of), _cuda.ptr(skip), _cuda.ptr(out[0]),
        _cuda.ptr(out[1]), _cuda.ptr(out[2]), P, n_prims,
        pp.samples_per_piece, pp.max_iters, pp.max_ls, params,
        _cuda.stream_ptr(dev))
    _cuda.check(err, "lbfgs_scene_solve")
    _cuda.launches["lbfgs_scene_solve"] += 1
