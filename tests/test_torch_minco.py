"""ops/minco of the PyTorch port against neoplanner_tpu.ops.minco.

The same inputs, made with numpy from a seed, go through the JAX function
(on the CPU it takes its XLA form, minco._givens_solve) and the port's plain
version. Both are f32; the Givens sequence is the same, so results agree to
a few ulps of the 18x18 system's conditioning: 1e-5 relative on
coefficients, 1e-4 on gradients (which pass through a second, transposed
solve). The kernel is held against this plain version on the card in
test_torch_kernels_cuda.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.ops import minco as jminco
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.ops import minco
from tests.test_torch_imports import one_torch_thread  # noqa: F401

M, D = 3, 2


def _problems(n, seed=0):
    rng = np.random.default_rng(seed)
    head = np.zeros((n, 3, D), np.float32)
    tail = np.zeros((n, 3, D), np.float32)
    head[:, 0] = rng.normal(size=(n, D))
    head[:, 1] = rng.normal(scale=0.5, size=(n, D))
    tail[:, 0] = head[:, 0] + [5.0, 0.0] + rng.normal(size=(n, D))
    tail[:, 1] = rng.normal(scale=0.5, size=(n, D))
    wpts = (head[:, 0, :, None] + (tail[:, 0] - head[:, 0])[:, :, None]
            * np.array([1 / 3, 2 / 3])) + rng.normal(scale=0.3,
                                                     size=(n, D, M - 1))
    ts = rng.uniform(0.8, 4.0, size=(n, M)).astype(np.float32)
    return head, tail, wpts.astype(np.float32), ts


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("k", [0, 1, 2, 3, 4])
def test_beta(k):
    t = np.linspace(0.0, 3.0, 7, dtype=np.float32)
    np.testing.assert_allclose(minco.beta(_t(t), k).numpy(),
                               np.asarray(jminco.beta(jnp.asarray(t), k)),
                               rtol=1e-6, atol=1e-6)


def test_build_system_matches():
    head, tail, wpts, ts = _problems(5)
    A, b = minco.build_system(_t(head), _t(tail), _t(wpts), _t(ts))
    for i in range(5):
        jA, jb = jminco.build_system(head[i], tail[i], wpts[i], ts[i])
        np.testing.assert_allclose(A[i].numpy(), np.asarray(jA), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(b[i].numpy(), np.asarray(jb))


@pytest.mark.parametrize("transposed", [False, True])
def test_givens_solve_matches(transposed):
    head, tail, wpts, ts = _problems(6, seed=1)
    A, b = minco.build_system(_t(head), _t(tail), _t(wpts), _t(ts))
    lo, up = (2, 4) if transposed else (4, 2)
    if transposed:
        A = A.transpose(1, 2).contiguous()
    x = minco._givens_solve(A, b, lo, up).numpy()
    want = jax.vmap(lambda a, r: jminco._givens_solve(a, r, lo, up))(
        jnp.asarray(A.numpy()), jnp.asarray(b.numpy()))
    np.testing.assert_allclose(x, np.asarray(want), rtol=1e-5, atol=1e-5)
    # and it is a solve: A x = b to f32 roundoff of the system
    res = torch.einsum("nij,njd->nid", A, torch.from_numpy(x)) - b
    assert float(res.abs().max()) < 1e-3


def test_solve_coeffs_and_gradient_match():
    head, tail, wpts, ts = _problems(4, seed=2)

    def jloss(w, t, h, tl):
        c = jminco.solve_coeffs(h, tl, w, t)
        return jnp.sum(c * c) + jminco.energy(c, t)

    wq = _t(wpts).requires_grad_(True)
    tq = _t(ts).requires_grad_(True)
    c = minco.solve_coeffs(_t(head), _t(tail), wq, tq)
    loss = (c * c).sum((1, 2)) + minco.energy(c, tq)
    loss.sum().backward()
    for i in range(4):
        jc = jminco.solve_coeffs(head[i], tail[i], wpts[i], ts[i])
        np.testing.assert_allclose(c[i].detach().numpy(), np.asarray(jc),
                                   rtol=1e-5, atol=1e-5)
        gw, gt = jax.grad(jloss, argnums=(0, 1))(wpts[i], ts[i], head[i],
                                                tail[i])
        scale = max(float(np.abs(gw).max()), float(np.abs(gt).max()), 1.0)
        np.testing.assert_allclose(wq.grad[i].numpy() / scale,
                                   np.asarray(gw) / scale, atol=1e-4)
        np.testing.assert_allclose(tq.grad[i].numpy() / scale,
                                   np.asarray(gt) / scale, atol=1e-4)


def test_eval_full_state_energy_tau_match():
    head, tail, wpts, ts = _problems(3, seed=3)
    c = minco.solve_coeffs(_t(head), _t(tail), _t(wpts), _t(ts))
    cmd, valid, n_valid = minco.full_state_cmd(c, _t(ts), 60, 900)
    e = minco.energy(c, _t(ts))
    for i in range(3):
        jc = jminco.solve_coeffs(head[i], tail[i], wpts[i], ts[i])
        jcmd, jvalid, jn = jminco.full_state_cmd(jc, ts[i], 60, 900)
        np.testing.assert_allclose(cmd[i].numpy(), np.asarray(jcmd),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(jvalid))
        assert int(n_valid[i]) == int(jn)
        np.testing.assert_allclose(float(e[i]),
                                   float(jminco.energy(jc, ts[i])),
                                   rtol=1e-4)
    tau = minco.T_to_tau(_t(ts), 0.5, 5.0)
    np.testing.assert_allclose(tau.numpy(),
                               np.asarray(jminco.T_to_tau(ts, 0.5, 5.0)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(minco.tau_to_T(tau, 0.5, 5.0).numpy(), ts,
                               rtol=1e-5)


def test_cpu_tensor_takes_plain_version():
    """A CPU tensor never reaches the kernel: no launch is counted."""
    head, tail, wpts, ts = _problems(2, seed=4)
    before = _cuda.launches["minco_banded_solve"]
    minco.solve_coeffs(_t(head), _t(tail), _t(wpts), _t(ts))
    assert _cuda.launches["minco_banded_solve"] == before
