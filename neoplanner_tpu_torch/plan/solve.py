"""The whole L-BFGS trajectory solve: kernels B1 (scene SDF) and B6 (ESDF
windows), each with B2 inlined.

:func:`solve_scene` is the port of neoplanner_tpu/plan/solve_pallas.py
``solve_scene`` (:349), :func:`solve_grid` that of
neoplanner_tpu/plan/solve_pallas_grid.py ``solve_grid`` (:315). For CUDA
tensors they launch ``csrc/lbfgs_scene.cu`` and ``csrc/lbfgs_grid.cu``: one
thread per problem runs the full solver (``csrc/lbfgs_device.cuh``), with
the objective and its hand adjoint (``csrc/objective.cuh``, the port of the
plan/costs_pallas.py device functions) inlined over the scene SDF or the
bilinear window taps. For CPU tensors they run the plain version:
ops/lbfgs.minimize on plan/costs.objective over the same map, with the
gradient from autograd.

Replaces: plan/solve_pallas.py ``_make_solver_kernel`` (:223) with
``lbfgs_in_kernel`` (:49) (B1), plan/solve_pallas_grid.py
``_make_grid_solver_kernel`` (:46) (B6), and the costs_pallas.py device
functions (B2). Bound on the H100: operations and per-thread latency — a
24-iteration solve is ~100 objective evaluations of ~72 samples (x 24
primitives, or 4 window taps) in sequence in one thread, from a few hundred
bytes of input (and a 36 KB window). Design: one thread per problem,
per-thread early exit (the TPU kernel had to run a 512-lane tile until its
last lane finished); B1 keeps per-thread primitive slices in shared memory,
B6 reads the env's window through the cache.
"""

from __future__ import annotations

from functools import partial

import torch

from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import PlannerParams
from neoplanner_tpu_torch.mapping import esdf as esdf_map
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


def _solve_plain(x0, head, tail, pmap, env_of, pp, skip=None):
    fun = partial(costs.objective, head_state=head, tail_state=tail,
                  pmap=pmap.index(env_of), pp=pp)
    res = lbfgs.minimize(fun, x0, max_iters=pp.max_iters, history=pp.history,
                         max_ls=pp.max_ls, ftol=FTOL, gtol=GTOL, c1=C1,
                         skip=skip)
    return res.x, res.f, res.iters


def _check_kernel_params(pp: PlannerParams) -> None:
    if (pp.num_pieces, pp.dims, pp.history) != (3, 2, 10) \
            or pp.sampling != "relative" or pp.samples_per_piece < 2:
        raise ValueError("the CUDA solver is built for M=3 pieces, D=2, "
                         "history 10 and relative sampling")


def _params(pp: PlannerParams):
    return _cuda.host_floats([pp.t_min, pp.t_max, pp.v_max, pp.safe_dis,
                              pp.w_energy, pp.w_time, pp.w_feas,
                              pp.w_collision, FTOL, GTOL, C1])


def _solve_cuda(x0, head, tail, scene, env_of, pp, skip):
    _check_kernel_params(pp)
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
    err = lib.neo_lbfgs_scene_solve(
        _cuda.ptr(x0), _cuda.ptr(head), _cuda.ptr(tail), _cuda.ptr(prims),
        _cuda.ptr(env_of), _cuda.ptr(skip), _cuda.ptr(out[0]),
        _cuda.ptr(out[1]), _cuda.ptr(out[2]), P, n_prims,
        pp.samples_per_piece, pp.max_iters, pp.max_ls, _params(pp),
        _cuda.stream_ptr(dev))
    _cuda.check(err, "lbfgs_scene_solve")
    _cuda.launches["lbfgs_scene_solve"] += 1


def solve_grid(x0: torch.Tensor, head: torch.Tensor, tail: torch.Tensor,
               window: esdf_map.GridWindow, env_of: torch.Tensor,
               pp: PlannerParams, skip=None):
    """Solve P problems on ESDF windows: as :func:`solve_scene`, problem p
    on window ``env_of[p]`` of ``window`` (mapping/esdf.make_window)."""
    if not x0.is_cuda:
        return _solve_plain(x0, head, tail, window, env_of, pp, skip)
    _check_kernel_params(pp)
    dev = x0.device
    P = x0.shape[0]
    env_of = env_of.to(torch.int32)
    skip = (torch.zeros(P, dtype=torch.int32, device=dev) if skip is None
            else skip.to(torch.int32))
    # the lazy bank: live problems first, so that skipped ones fill whole
    # warps that exit at once (all lanes of an env share its flag)
    order = torch.argsort(skip, stable=True)
    args = dict(x0=x0[order].to(torch.float32).contiguous(),
                head=head[order].to(torch.float32).contiguous(),
                tail=tail[order].to(torch.float32).contiguous(),
                win=window.win.to(torch.float32).contiguous(),
                worg=window.worg.to(torch.float32).contiguous(),
                env_of=env_of[order].contiguous(),
                skip=skip[order].contiguous())
    out = (torch.empty_like(args["x0"]),
           torch.empty(P, dtype=torch.float32, device=dev),
           torch.empty(P, dtype=torch.int32, device=dev))
    launch_grid_solver(**args, out=out, pp=pp)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(P, device=dev)
    return tuple(o[inv] for o in out)


def launch_grid_solver(x0, head, tail, win, worg, env_of, skip, out,
                       pp) -> None:
    """Launch B6 on prepared tensors: x0 (P, 7), head/tail (P, 3, 2), win
    (E, Hw, Ww), worg (E, 7), env_of and skip (P,) int32; writes out =
    (x (P, 7), f (P,), iters (P,) int32)."""
    dev = x0.device
    P = x0.shape[0]
    E, Hw, Ww = win.shape
    for t, name, shape in ((x0, "x0", (P, 7)), (head, "head", (P, 3, 2)),
                           (tail, "tail", (P, 3, 2)),
                           (win, "win", (E, Hw, Ww)), (worg, "worg", (E, 7)),
                           (out[0], "x", (P, 7)), (out[1], "f", (P,))):
        _cuda.require(t, name, shape, torch.float32, dev)
    for t, name in ((env_of, "env_of"), (skip, "skip"), (out[2], "iters")):
        _cuda.require(t, name, (P,), torch.int32, dev)
    if Hw < 2 or Ww < 2:
        raise ValueError("the window needs at least 2 x 2 cells")
    if P == 0:
        return
    lib = _cuda.load()
    err = lib.neo_lbfgs_grid_solve(
        _cuda.ptr(x0), _cuda.ptr(head), _cuda.ptr(tail), _cuda.ptr(win),
        _cuda.ptr(worg), _cuda.ptr(env_of), _cuda.ptr(skip),
        _cuda.ptr(out[0]), _cuda.ptr(out[1]), _cuda.ptr(out[2]), P, Hw, Ww,
        pp.samples_per_piece, pp.max_iters, pp.max_ls, _params(pp),
        _cuda.stream_ptr(dev))
    _cuda.check(err, "lbfgs_grid_solve")
    _cuda.launches["lbfgs_grid_solve"] += 1
