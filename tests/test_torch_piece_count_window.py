"""The window objective (plan/costs.objective on mapping/esdf.GridWindow,
the plain version of kernel B7 and of B6's objective) at M = 5 and 12
against JAX costs.objective on the map: a window that spans the map (the
port's window is clamped to it) reads the field as JAX's bilinear sample
does, FAR beyond the map's edge. Tolerances of the golden tests
(tests/test_costs_pallas.py): values 5e-4, gradients 2e-3 of max(|g|, 1).
Apart from test_torch_piece_count.py so that the two files' JAX traces
run on two workers."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import PlannerParams as JPlannerParams
from neoplanner_tpu.mapping import esdf as jesdf
from neoplanner_tpu_torch.core.types import ESDFMap
from neoplanner_tpu_torch.mapping import esdf
from tests.test_torch_costs_solver import _t
from tests.test_torch_imports import one_torch_thread  # noqa: F401
from tests.test_torch_piece_count import (KW, _check, _jax_valgrad,
                                          _port_valgrad, _problems)


@pytest.mark.parametrize("M", [5, 12])
def test_window_objective_matches(M):
    """Over a window that spans the whole map (the port's window is
    clamped to the map) the window objective equals JAX's objective on
    the map with bilinear samples, FAR beyond the map's edge."""
    rng = np.random.default_rng(30 + M)
    occ = np.zeros((2, 120, 160), np.float32)
    for e in range(2):
        for _ in range(6):
            r, c = rng.integers(30, 90), rng.integers(40, 150)
            occ[e, r:r + rng.integers(3, 10), c:c + rng.integers(3, 10)] = 1
    origin = (-2.0, -6.0)
    env_of = np.array([0, 1, 0, 1])
    jmaps = jax.vmap(lambda o: jesdf.build(o, jnp.asarray(origin), 0.1))(
        jnp.asarray(occ[env_of]))
    emap = ESDFMap(esdf=_t(jmaps.esdf.astype(jnp.float32)),
                   origin=torch.tensor(origin), resolution=0.1)
    window = esdf.make_window(emap, torch.zeros((4, 2)), 160)
    assert window.win.shape[1:] == (120, 160)
    x0, head, tail = _problems(M, 4, seed=40 + M, length=1.2 * M)
    env_of = np.arange(4)
    jf, jg = _jax_valgrad(x0, head, tail, jmaps,
                          JPlannerParams(num_pieces=M, **KW))
    f, g = _port_valgrad(M, x0, head, tail, window, env_of)
    _check(f, g, jf, jg)
