"""One evaluation of the trajectory objective per problem: kernels B2s (the
scene SDF) and B7 (ESDF windows).

The port of the public functions of neoplanner_tpu/plan/costs_pallas.py
(``objective_fwd`` :665, ``objective_valgrad`` :680, ``objective_vjp``
:726) and plan/costs_pallas_grid.py (``objective_fwd_grid`` :408,
``objective_valgrad_grid`` :424, ``objective_vjp_grid`` :464), batched over
P problems: problem p reads the map of env ``env_of[p]`` of ``pmap``, a
scene (mapping/scene.SceneMap, one row per env) or the grid solver's
windows (mapping/esdf.GridWindow, one window per env), as plan/solve.py's
solvers do.

For CUDA tensors :func:`objective_fwd` and :func:`objective_valgrad` launch
``csrc/objective_eval.cu`` (the value alone, or the value and its hand
adjoint), one warp per problem; for CPU tensors they take the plain
version, plan/costs.objective with the gradient from autograd.
:func:`objective_vjp` is the objective as the L-BFGS loop differentiates
it: its forward takes the value and the gradient together and its backward
scales that gradient, so ``ops/lbfgs.value_and_grad`` costs one
evaluation. It is differentiable in
x only (the JAX package's ``obj_x_only`` contract, costs_pallas.py:715-722):
the boundary states and the map get no gradient.
"""

from __future__ import annotations

import torch

from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import PlannerParams
from neoplanner_tpu_torch.mapping import esdf as esdf_map
from neoplanner_tpu_torch.mapping import scene as scene_map
from neoplanner_tpu_torch.ops import lbfgs
from neoplanner_tpu_torch.plan import costs

WARPS = 4              # problems (warps) per block, csrc/objective_eval.cu
SMEM_LIMIT = 232448    # an H100 block's shared memory, opted in past 48 KB


def scratch_floats(num_pieces: int) -> int:
    """A warp's scratch of warp_objective at M pieces (csrc/objective.cuh
    kScratchFloats): 32 sample records of 17 floats, the sums (2n + M + 2),
    the forward band layout (csrc/minco_device.cuh BandLayout: n columns
    12 floats apart and 2 right-hand sides of n), the diagonal (n), the
    coefficients and lam (2n each); n = 6M."""
    n = 6 * num_pieces
    return 32 * 17 + (2 * n + num_pieces + 2) + 14 * n + n + 4 * n


def max_prims(num_pieces: int) -> int:
    """The scene kernel's primitive cap per env at M pieces: each warp
    stages its env's table of 6 floats a primitive beside its scratch."""
    return (SMEM_LIMIT // (4 * WARPS) - scratch_floats(num_pieces)) // 6


def objective_fwd(x: torch.Tensor, head: torch.Tensor, tail: torch.Tensor,
                  pmap, env_of: torch.Tensor,
                  pp: PlannerParams) -> torch.Tensor:
    """Objective values f (P,) of decision vectors x (P, nv) with boundary
    states head/tail (P, 3, 2), problem p on map row env_of[p]."""
    if not x.is_cuda:
        return plain_fwd(x, head, tail, pmap, env_of, pp)
    return _launch(x, head, tail, pmap, env_of, pp, grad=False)[0]


def objective_valgrad(x: torch.Tensor, head: torch.Tensor,
                      tail: torch.Tensor, pmap, env_of: torch.Tensor,
                      pp: PlannerParams):
    """(f (P,), g (P, nv)): the values and their gradients in x."""
    if not x.is_cuda:
        return plain_valgrad(x, head, tail, pmap, env_of, pp)
    return _launch(x, head, tail, pmap, env_of, pp, grad=True)


def plain_fwd(x, head, tail, pmap, env_of, pp: PlannerParams):
    """The plain version of the forward kernel: plan/costs.objective."""
    with torch.no_grad():
        return costs.objective(x, head, tail, pmap.index(env_of), pp)


def plain_valgrad(x, head, tail, pmap, env_of, pp: PlannerParams):
    """The plain version of the value-and-gradient kernel: plan/costs
    .objective with the gradient from autograd."""
    def fun(xr):
        return costs.objective(xr, head, tail, pmap.index(env_of), pp)
    return lbfgs.value_and_grad(fun, x)


class _ObjectiveX(torch.autograd.Function):
    """f(x) with the gradient of :func:`objective_valgrad`, saved by the
    forward; the other arguments are constants."""

    @staticmethod
    def forward(ctx, x, head, tail, pmap, env_of, pp):
        f, g = objective_valgrad(x.detach(), head, tail, pmap, env_of, pp)
        ctx.save_for_backward(g)
        return f

    @staticmethod
    def backward(ctx, grad_out):
        (g,) = ctx.saved_tensors
        return grad_out[:, None] * g, None, None, None, None, None


def objective_vjp(x: torch.Tensor, head: torch.Tensor, tail: torch.Tensor,
                  pmap, env_of: torch.Tensor,
                  pp: PlannerParams) -> torch.Tensor:
    """Objective values f (P,), differentiable in x only: one value and
    gradient evaluation in the forward, the saved gradient in the
    backward."""
    return _ObjectiveX.apply(x, head.detach(), tail.detach(), pmap, env_of,
                             pp)


def _check_params(pp: PlannerParams) -> None:
    _cuda.check_pieces(pp.num_pieces, "the CUDA objective")
    if pp.dims != 2 or pp.sampling != "relative" \
            or pp.samples_per_piece < 2:
        raise ValueError("the CUDA objective is built for D=2 and relative "
                         "sampling")


def _params(pp: PlannerParams):
    # the layout of neo::SolveParams; the solver's stopping constants are
    # not read by an evaluation
    return _cuda.host_floats([pp.t_min, pp.t_max, pp.v_max, pp.safe_dis,
                              pp.w_energy, pp.w_time, pp.w_feas,
                              pp.w_collision, 0.0, 0.0, 0.0])


def _launch(x, head, tail, pmap, env_of, pp, grad: bool):
    _check_params(pp)
    dev = x.device
    P = x.shape[0]
    x = x.detach().to(torch.float32).contiguous()
    head = head.detach().to(torch.float32).contiguous()
    tail = tail.detach().to(torch.float32).contiguous()
    env_of = env_of.to(torch.int32).contiguous()
    f = torch.empty(P, dtype=torch.float32, device=dev)
    g = torch.empty((P, x.shape[1]), dtype=torch.float32,
                    device=dev) if grad else None
    if isinstance(pmap, scene_map.SceneMap):
        launch_scene(x, head, tail, scene_map.pack_prims(pmap), env_of, f, g,
                     pp)
    elif isinstance(pmap, esdf_map.GridWindow):
        launch_grid(x, head, tail, pmap.win.to(torch.float32).contiguous(),
                    pmap.worg.to(torch.float32).contiguous(), env_of, f, g,
                    pp)
    else:
        raise TypeError(f"the CUDA objective takes a SceneMap or a "
                        f"GridWindow, not {type(pmap).__name__}")
    return f, g


def _require_io(x, head, tail, env_of, f, g, pp, dev):
    _check_params(pp)
    P, nv = x.shape[0], pp.num_vars
    for t, name, shape in ((x, "x", (P, nv)), (head, "head", (P, 3, 2)),
                           (tail, "tail", (P, 3, 2)), (f, "f", (P,))):
        _cuda.require(t, name, shape, torch.float32, dev)
    if g is not None:
        _cuda.require(g, "g", (P, nv), torch.float32, dev)
    _cuda.require(env_of, "env_of", (P,), torch.int32, dev)


def launch_scene(x, head, tail, prims, env_of, f, g, pp) -> None:
    """Launch B2s on prepared tensors: x (P, nv), head/tail (P, 3, 2), prims
    (E, K, 6) (mapping/scene.pack_prims), env_of (P,) int32; writes f (P,)
    and, unless g is None, g (P, nv); nv = 3M - 2 for M = pp.num_pieces."""
    dev = x.device
    E, n_prims = prims.shape[:2]
    _require_io(x, head, tail, env_of, f, g, pp, dev)
    _cuda.require(prims, "prims", (E, n_prims, 6), torch.float32, dev)
    cap = max_prims(pp.num_pieces)
    if n_prims > cap:
        raise ValueError(f"{n_prims} primitives exceed the objective's "
                         f"shared memory ({cap} per env at M="
                         f"{pp.num_pieces})")
    if x.shape[0] == 0:
        return
    lib = _cuda.load_pieces(pp.num_pieces)
    err = lib.neo_objective_scene(
        _cuda.ptr(x), _cuda.ptr(head), _cuda.ptr(tail), _cuda.ptr(prims),
        _cuda.ptr(env_of), _cuda.ptr(f), None if g is None else _cuda.ptr(g),
        x.shape[0], n_prims, pp.samples_per_piece, _params(pp),
        _cuda.stream_ptr(dev))
    name = "objective_scene_fwd" if g is None else "objective_scene_valgrad"
    _cuda.check(err, name)
    _cuda.launches[name] += 1


def launch_grid(x, head, tail, win, worg, env_of, f, g, pp) -> None:
    """Launch B7 on prepared tensors: x (P, nv), head/tail (P, 3, 2), win
    (E, Hw, Ww), worg (E, 7) (mapping/esdf.make_window), env_of (P,) int32;
    writes f (P,) and, unless g is None, g (P, nv)."""
    dev = x.device
    E, Hw, Ww = win.shape
    _require_io(x, head, tail, env_of, f, g, pp, dev)
    _cuda.require(win, "win", (E, Hw, Ww), torch.float32, dev)
    _cuda.require(worg, "worg", (E, 7), torch.float32, dev)
    if Hw < 2 or Ww < 2:
        raise ValueError("the window needs at least 2 x 2 cells")
    if x.shape[0] == 0:
        return
    lib = _cuda.load_pieces(pp.num_pieces)
    err = lib.neo_objective_grid(
        _cuda.ptr(x), _cuda.ptr(head), _cuda.ptr(tail), _cuda.ptr(win),
        _cuda.ptr(worg), _cuda.ptr(env_of), _cuda.ptr(f),
        None if g is None else _cuda.ptr(g), x.shape[0], Hw, Ww,
        pp.samples_per_piece, _params(pp), _cuda.stream_ptr(dev))
    name = "objective_grid_fwd" if g is None else "objective_grid_valgrad"
    _cuda.check(err, name)
    _cuda.launches[name] += 1
