"""The 'warmstart' bank of the PyTorch port, expert.plan_with_carry,
against the JAX package's plan_with_carry on the maps of
test_torch_expert_planners.py (its golden map, with the nearest-cell
acceptance, and scenegen scenes), and against the port's own expert.plan.

Tolerances as test_torch_expert_planners.py: acceptance flags exactly and
the selected plan's JAX objective within 5e-3 (the cost basin); without a
carry the bank is plan's, bit for bit, and a carried lane that is accepted
spends exactly its own solve's iterations (the other lanes are skipped).
"""

from functools import partial

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.plan import expert as jexpert
from neoplanner_tpu_torch.plan import expert
from tests.test_torch_costs_solver import _t
from tests.test_torch_expert_planners import (B, MAPS, _case, _check_plans,
                                              _jax_call)
from tests.test_torch_imports import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", params=sorted(MAPS))
def planned(request):
    """The port's expert.plan."""
    c = _case(request.param)
    got = expert.plan(c["tmap"], c["head"], c["tail"], c["noise"], c["pp"])
    return request.param, c, got


def test_plan_with_carry_without_carry_is_plan(planned):
    """has_carry False: lane 0 holds the straight seed and the plan is
    plan's, bit for bit; the whole bank runs (plan skips the retries of
    envs with an accepted primary), so it spends at least plan's
    iterations."""
    which, c, got = planned
    none = torch.zeros(B, dtype=torch.bool)
    carried = expert.plan_with_carry(
        c["tmap"], c["head"], c["tail"], got.int_wpts * 0.0,
        got.ts * 0.0 + 1.0, none, c["noise"], c["pp"])
    for f in ("int_wpts", "ts", "coeffs", "costs", "ok"):
        assert torch.equal(getattr(carried, f), getattr(got, f)), f
    assert bool((carried.iters >= got.iters).all())


def test_plan_with_carry_matches(planned):
    """has_carry on envs 0 and 2: their carry (the expert plan, shifted)
    is solved first and, when accepted, wins with every other lane
    skipped; envs 1 and 3 run the whole bank."""
    which, c, got = planned
    has = np.array([True, False, True, False])
    q0 = got.int_wpts.numpy() + 0.05
    ts0 = got.ts.numpy()
    port = expert.plan_with_carry(c["tmap"], c["head"], c["tail"], _t(q0),
                                  _t(ts0), torch.from_numpy(has),
                                  c["noise"], c["pp"])
    jax_ = _jax_call(partial(jexpert.plan_with_carry, pp=c["jpp"]), which,
                     c["jmaps"], c["jhead"], c["jtail"], jnp.asarray(q0),
                     jnp.asarray(ts0), jnp.asarray(has), c["keys"])
    _check_plans(c, port, jax_)
    lane0 = expert.solve_one(c["tmap"], c["head"], c["tail"], _t(q0),
                             _t(ts0), torch.arange(B), c["pp"],
                             window=(expert.make_plan_window(
                                 c["tmap"], c["head"], c["tail"], c["pp"])
                                 if which == "golden" else None))
    skipped = torch.from_numpy(has) & lane0.ok
    assert bool(skipped.any())
    assert torch.equal(port.iters[skipped], lane0.iters[skipped])
    assert torch.equal(port.int_wpts[skipped], lane0.int_wpts[skipped])
