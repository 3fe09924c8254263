"""The port's warp device code run on the CPU: csrc/objective.cuh
(B2's warp_objective, inlined in B1, B6, B2s and B7), minco_device.cuh
(warp_givens_solve, B5's solve) and lbfgs_device.cuh (B1's and B6's
L-BFGS loop) compiled with g++ through tests/warp_host/ (a std::thread a
lane, __syncwarp a barrier of the 32), at M = 3 (the main path's, one
column a lane) and M = 12 pieces (74 columns: three a lane in the band
layout), history 20, against the plain PyTorch
versions that the kernels are held to on the card. The device code runs
here with the host's expf and sqrtf and without nvcc's contraction of
plain products, so it agrees with the plain version to roundoff, not
bits. Tolerances: the objective as the golden tests hold the Pallas
kernels (values 5e-4, gradients 2e-3 of each problem's largest
component, against the plain version in f64); the solve 1e-5 of each
system's largest component; one L-BFGS iteration 1e-4 on x (as
tests/test_torch_costs_solver.py) with the iteration counts equal; six
iterations of a history of 2 or 3 (the ring wrapped) 1e-3 on f and x of
each problem (plan/parity.few_iterations, the plain solver in f64 the
control).
"""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import MapParams, PlannerParams, WorldParams
from neoplanner_tpu_torch.mapping import scene
from neoplanner_tpu_torch.ops import minco
from neoplanner_tpu_torch.plan import costs, expert, objective, parity, solve
from neoplanner_tpu_torch.world import scenegen
from tests.test_torch_imports import one_torch_thread  # noqa: F401

H, N_PROBLEMS = 20, 4
HERE = Path(__file__).resolve().parent
MAPP = MapParams(width=256, height=192, origin_x=-4.0, origin_y=-9.6)
_F, _I = ctypes.POINTER(ctypes.c_float), ctypes.c_int


@pytest.fixture(scope="module", params=[3, 12])
def M(request):
    return request.param


@pytest.fixture(scope="module")
def lib(tmp_path_factory, M):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is needed to build the host harness")
    so = tmp_path_factory.mktemp("warp_host") / f"warp_host_m{M}.so"
    cmd = [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
           "-shared", f"-DNEO_M={M}", f"-I{HERE / 'warp_host' / 'shim'}",
           f"-I{Path(_cuda._SRC)}", "-o", str(so),
           str(HERE / "warp_host" / "warp_host.cpp"), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    out = ctypes.CDLL(str(so))
    assert out.host_num_vars() == 3 * M - 2
    return out


def _p(a):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.fixture(scope="module")
def problems(M):
    """N_PROBLEMS problems of M pieces ~2M m long through the obstacles of
    two scenegen worlds, from perturbed straight-line seeds."""
    pp = PlannerParams(num_pieces=M, samples_per_piece=8, history=H,
                       max_ls=4)
    rng = np.random.default_rng(16)
    head = np.zeros((N_PROBLEMS, 3, 2), np.float32)
    tail = np.zeros((N_PROBLEMS, 3, 2), np.float32)
    head[:, 0] = rng.normal(size=(N_PROBLEMS, 2)) + [1.0, 0.0]
    head[:, 1] = rng.normal(scale=0.3, size=(N_PROBLEMS, 2))
    tail[:, 0] = head[:, 0] + [2.0 * M, 0.0] + rng.normal(
        size=(N_PROBLEMS, 2))
    h, t = torch.from_numpy(head), torch.from_numpy(tail)
    q = expert.straight_line_wpts(h[:, 0], t[:, 0], pp) + torch.from_numpy(
        rng.normal(scale=0.4, size=(N_PROBLEMS, 2, M - 1))).float()
    ts = expert.init_ts(pp).expand(N_PROBLEMS, -1) * torch.from_numpy(
        rng.uniform(0.7, 1.3, (N_PROBLEMS, M))).float()
    x0 = costs.pack(q, minco.T_to_tau(ts, pp.t_min, pp.t_max), pp)
    worlds = scenegen.generate_batch(_cuda.make_generator(16, "cpu"), 2,
                                     WorldParams(num_boxes=10))
    sc = scene.build(worlds, MAPP)
    env_of = torch.arange(N_PROBLEMS) % 2
    prims = scene.pack_prims(sc).numpy()[env_of.numpy()]
    return dict(pp=pp, M=M, x0=x0.float().contiguous(), head=h, tail=t,
                sc=sc, env_of=env_of, prims=np.ascontiguousarray(prims))


def _host_params(pp):
    return np.array([pp.t_min, pp.t_max, pp.v_max, pp.safe_dis, pp.w_energy,
                     pp.w_time, pp.w_feas, pp.w_collision, solve.FTOL,
                     solve.GTOL, solve.C1], np.float32)


def _args(p):
    return (np.ascontiguousarray(p["x0"].numpy()),
            np.ascontiguousarray(p["head"].numpy()),
            np.ascontiguousarray(p["tail"].numpy()), p["prims"])


def test_objective_matches_plain(lib, problems):
    p = problems
    x, head, tail, prims = _args(p)
    pp = p["pp"]
    f = np.zeros(N_PROBLEMS, np.float32)
    g = np.zeros((N_PROBLEMS, pp.num_vars), np.float32)
    fv = np.zeros(N_PROBLEMS, np.float32)
    hp = _host_params(pp)
    for g_out, f_out in ((g, f), (None, fv)):
        lib.host_objective_scene(
            _p(x), _p(head), _p(tail), _p(prims), prims.shape[1],
            pp.samples_per_piece, _p(hp), N_PROBLEMS, _p(f_out),
            None if g_out is None else _p(g_out))
    sc64 = scene.SceneMap(p["sc"].centers.double(), p["sc"].half.double(),
                          p["sc"].is_cyl, p["sc"].active)
    wf, wg = objective.objective_valgrad(
        p["x0"].double(), p["head"].double(), p["tail"].double(), sc64,
        p["env_of"], pp)
    np.testing.assert_allclose(f, wf.numpy(), rtol=5e-4, atol=5e-4)
    assert np.array_equal(f.view(np.int32), fv.view(np.int32))
    assert float(wf.max()) > 100.0          # a collision term is live
    scale = wg.abs().amax(1, keepdim=True).clamp(min=1.0).numpy()
    np.testing.assert_allclose(g / scale, wg.numpy() / scale, atol=2e-3)


@pytest.mark.parametrize("lower_bw", [4, 2])
def test_banded_solve_matches_plain(lib, problems, lower_bw):
    p = problems
    pp = p["pp"]
    q, tau = costs.unpack(p["x0"], pp)
    A, b = minco.build_system(p["head"], p["tail"], q,
                              minco.tau_to_T(tau, pp.t_min, pp.t_max))
    if lower_bw == 2:
        A = A.transpose(1, 2)
    aug = np.ascontiguousarray(torch.cat([A, b], 2).numpy())
    out = np.zeros((N_PROBLEMS, 6 * p["M"], 2), np.float32)
    lib.host_banded_solve(_p(aug), _p(out), N_PROBLEMS, lower_bw)
    want = minco._givens_solve(A.double(), b.double(), lower_bw,
                               6 - lower_bw).numpy()
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(out / scale, want / scale, atol=1e-5)


def test_one_lbfgs_iteration_matches_plain(lib, problems):
    p = problems
    x, head, tail, prims = _args(p)
    pp = p["pp"]
    x_out = np.zeros_like(x)
    f_out = np.zeros(N_PROBLEMS, np.float32)
    it_out = np.zeros(N_PROBLEMS, np.int32)
    lib.host_lbfgs_scene(_p(x), _p(head), _p(tail), _p(prims),
                         prims.shape[1], pp.samples_per_piece, 1, pp.max_ls,
                         H, _p(_host_params(pp)), N_PROBLEMS, _p(x_out),
                         _p(f_out), _p(it_out))
    pp1 = PlannerParams(num_pieces=p["M"], samples_per_piece=8, history=H,
                        max_ls=4, max_iters=1)
    wx, wf, wit = solve.solve_scene(p["x0"], p["head"], p["tail"], p["sc"],
                                    p["env_of"], pp1)
    np.testing.assert_allclose(x_out, wx.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f_out, wf.numpy(), rtol=1e-4)
    assert it_out.tolist() == wit.tolist()


@pytest.mark.parametrize("hist", [2, 3])
def test_lbfgs_history_wraps_matches_plain(lib, problems, hist):
    p = problems
    x, head, tail, prims = _args(p)
    pp = dataclasses.replace(p["pp"], history=hist, max_iters=6)
    out = (np.zeros_like(x), np.zeros(N_PROBLEMS, np.float32),
           np.zeros(N_PROBLEMS, np.int32))
    lib.host_lbfgs_scene(_p(x), _p(head), _p(tail), _p(prims),
                         prims.shape[1], pp.samples_per_piece, pp.max_iters,
                         pp.max_ls, hist, _p(_host_params(pp)), N_PROBLEMS,
                         *map(_p, out))
    want = solve.solve_scene(p["x0"], p["head"], p["tail"], p["sc"],
                             p["env_of"], pp)
    sc64 = scene.SceneMap(p["sc"].centers.double(), p["sc"].half.double(),
                          p["sc"].is_cyl, p["sc"].active)
    control = solve.solve_scene(p["x0"].double(), p["head"].double(),
                                p["tail"].double(), sc64, p["env_of"], pp)
    assert bool((want[2] > hist).all())
    got = tuple(torch.from_numpy(a) for a in out)
    parity.few_iterations(got, want, control)
