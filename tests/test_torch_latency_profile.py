"""The B = 1 replan latency's full profile (plan/latency.py, latency.py:53-56:
the reference's deployed 12-lane bank, 32 samples a piece, max_ls 8)
against the JAX package: one L-BFGS iteration on the scene SDF. Each JAX
plan at this profile takes ~14 s to trace and compile on the CPU, so each
file holds one: test_torch_latency_profile_basin.py the 32-iteration plan
on the scene, test_torch_latency_profile_grid.py and
test_torch_latency_profile_grid_basin.py both on the exact ESDF of the
ground-truth grid (latency.py:77-80), where the port plans on a window
covering the whole 256 x 192 map and the JAX side accepts by the
nearest-cell rule, as test_torch_planner_env_grid.py holds them.

latency.py's problem on both sides: its world (scenegen.generate at key
0, 10 boxes), its reset at (0, 0) with the goal (12, 0) and its retry
noise (key 2, passed to the port as standard normals); the port's
latency.problem builds the reset, the maps, head and tail. One L-BFGS
iteration is held by the one-iteration rule (plan/parity.py: f within 1e-3
relative) and the selected plan elementwise (1e-4,
test_torch_planner_env.py's tolerance); the 32-iteration plans by
acceptance exactly and the JAX objective of the selected plan within 5e-3
(the cost basin of test_torch_expert_planners.py).

The JAX side solves its bank whole (NEO_BANK=full): its lazy bank, which
the port runs, skips the retry lanes only where the selection cannot pick
them (neoplanner_tpu/plan/expert.py:84-98), so both pick the same lane;
the bank's summed iterations differ by the skipped lanes' and are not
compared. It traces in half the time of the lazy bank's two solves.
"""

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import MapParams as JMapParams
from neoplanner_tpu.config import PlannerParams as JPlannerParams
from neoplanner_tpu.config import WorldParams as JWorldParams
from neoplanner_tpu.mapping import esdf as jesdf
from neoplanner_tpu.mapping import scene as jscene
from neoplanner_tpu.ops import minco as jminco
from neoplanner_tpu.plan import costs as jcosts
from neoplanner_tpu.plan import expert as jexpert
from neoplanner_tpu.world import scenegen as jscenegen
from neoplanner_tpu.world import voxelize as jvoxelize
from neoplanner_tpu_torch.core.types import BoxWorld
from neoplanner_tpu_torch.plan import expert, latency, parity
from tests.test_torch_imports import one_torch_thread  # noqa: F401
from tests.test_torch_vision_env import _nearest_acceptance

# latency.py:63-64
LAT_MAPP = dict(width=256, height=192, origin_x=-4.0, origin_y=-9.6)


def port_world(w) -> BoxWorld:
    """A JAX world as the port's (fields without the env axis)."""
    return BoxWorld(*(torch.from_numpy(np.array(getattr(w, f)))
                      for f in ("centers", "half_sizes", "active", "shape")))


def _jax_objective(pmap, head, tail, q, ts, jpp):
    x = jcosts.pack(q, jminco.T_to_tau(ts, jpp.t_min, jpp.t_max), jpp)
    return float(jcosts.objective(x, head, tail, pmap, jpp))


def full_profile(which):
    """latency.py's problem on both sides, planned on map ``which``."""
    jw = jscenegen.generate(jax.random.PRNGKey(0), JWorldParams(num_boxes=10))
    jpp = JPlannerParams(**latency.PROFILES["full"])
    jmapp = JMapParams(**LAT_MAPP)
    key = jax.random.PRNGKey(2)
    noise = jax.random.normal(key, (jpp.retry_num, jpp.dims, jpp.num_wpts))
    pp, _, _, scene, emap, head, tail, t_noise = latency.problem(
        "full", "cpu", world=port_world(jw),
        noise=torch.from_numpy(np.array(noise))[None])
    # latency.py:66-68: the reset hovers at (0, 0) at rest
    jhead = jnp.zeros((3, 2))
    jtail = jnp.zeros((3, 2)).at[0].set(jnp.array([12.0, 0.0]))
    np.testing.assert_array_equal(head[0].numpy(), np.asarray(jhead))
    np.testing.assert_array_equal(tail[0].numpy(), np.asarray(jtail))
    if which == "scene":
        jmap, tmap = jscene.build(jw, jmapp), scene
    else:
        jmap = jesdf.build(jvoxelize.occupancy_2d(jw, jmapp),
                           (jmapp.origin_x, jmapp.origin_y),
                           jmapp.resolution)
        np.testing.assert_array_equal(emap.esdf[0].numpy(),
                                      np.asarray(jmap.esdf))
        tmap = emap
        pp = dataclasses.replace(pp, kernel_window_cells=256)  # whole map
    return dict(which=which, jpp=jpp, jmap=jmap, jhead=jhead, jtail=jtail,
                key=key, pp=pp, tmap=tmap, head=head, tail=tail,
                noise=t_noise)


def plans(c, max_iters):
    """(the port's plan, JAX's plan, JAX's objective of each) at
    max_iters."""
    jpp = dataclasses.replace(c["jpp"], max_iters=max_iters)
    got = expert.plan(c["tmap"], c["head"], c["tail"], c["noise"],
                      dataclasses.replace(c["pp"], max_iters=max_iters))
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("NEO_BANK", "full")
        if c["which"] == "grid":
            patch.setattr(jexpert, "costs_mod", _nearest_acceptance())
        want = jax.jit(partial(jexpert.plan, pp=jpp))(
            c["jmap"], c["jhead"], c["jtail"], c["key"])
    f = [_jax_objective(c["jmap"], c["jhead"], c["jtail"], jnp.asarray(q),
                        jnp.asarray(t), c["jpp"])
         for q, t in ((got.int_wpts[0].numpy(), got.ts[0].numpy()),
                      (want.int_wpts, want.ts))]
    return got, want, f


def check_one_iteration(c):
    got, want, (f_port, f_jax) = plans(c, 1)
    assert bool(got.ok[0]) == bool(want.ok)
    assert float(parity.rel(torch.tensor(f_port), torch.tensor(f_jax))) \
        <= 1e-3
    for f in ("int_wpts", "ts"):
        np.testing.assert_allclose(getattr(got, f)[0].numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-4,
                                   err_msg=f)


def check_basin(c):
    got, want, (f_port, f_jax) = plans(c, latency.PROFILES["full"]
                                       ["max_iters"])
    assert bool(got.ok[0]) == bool(want.ok)
    assert bool(want.ok)            # the 12 m plan is accepted
    np.testing.assert_allclose(f_port, f_jax, rtol=5e-3, atol=5e-3)


def test_full_profile_one_iteration_matches_jax():
    check_one_iteration(full_profile("scene"))
