"""The trained ResNet-18 (artifacts/planner_net_resnet640) flying the
paper's NEO loop at 640 x 480 on the CPU: JAX's step_segment against the
port's, B = 16, 3 segments, with chip_smoke.py's planner (the flagship's:
24 L-BFGS iterations) and phase (v)'s world recipe (scenegen, 10 boxes,
worlds seeded 0, the reset's goals seeded 21; drawn by the port on the
CPU, where the card's generator draws others).

Both sides start from one JAX reset and take JAX's draws (as
tests/test_torch_env.py). Each segment's replan and mission flags
(planned, ok, reached, failed, missions_done, missions_ok) must agree env
by env; at one solver iteration (the twin rule of that file) the drone
state and the plans also agree within 1e-4. Marked slow (minutes: JAX
compiles the ResNet-18 inside the loop): it settles whether a loop of the
trained net that ends no mission is the net's behaviour or the port's
(run with ``-m slow -s`` to print the counts)."""

import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neoplanner_tpu.config import CameraParams as JCameraParams
from neoplanner_tpu.config import MapParams as JMapParams
from neoplanner_tpu.config import MissionParams as JMissionParams
from neoplanner_tpu.config import PlannerParams as JPlannerParams
from neoplanner_tpu.config import SimParams as JSimParams
from neoplanner_tpu.core.types import BoxWorld as JBoxWorld
from neoplanner_tpu.learn import train as jtrain
from neoplanner_tpu.sim import env as jenv
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, PlannerParams,
                                         SimParams, WorldParams)
from neoplanner_tpu_torch.learn import train
from neoplanner_tpu_torch.models import planner_net
from neoplanner_tpu_torch.sim import env
from neoplanner_tpu_torch.world import scenegen
from tests.test_torch_env import _jax_draws
from tests.test_torch_imports import one_torch_thread  # noqa: F401
from tests.test_torch_track import to_port_state

pytestmark = pytest.mark.slow

B = 16
SEGMENTS = 3
RESNET = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                      "planner_net_resnet640")
PP = dict(max_iters=24, samples_per_piece=24, retry_num=2,
          extra_lateral_scales=(), max_ls=4)
MAPP = dict(width=256, height=192, origin_x=-4.0, origin_y=-9.6)
FLAGS = ("planned", "ok", "reached", "failed", "missions_done",
         "missions_ok")


def _run(max_iters):
    """SEGMENTS segments of JAX's loop and of the port's, from one reset:
    [(jax state, jax info, port state, port info)]."""
    pp_kw = dict(PP, max_iters=max_iters)
    jpp, pp = JPlannerParams(**pp_kw), PlannerParams(**pp_kw)
    mapp = MapParams(**MAPP)
    worlds = scenegen.generate_batch(_cuda.make_generator(0, "cpu"), B,
                                     WorldParams(num_boxes=10))
    goals = env.reset(worlds, pp, MissionParams(), mapp,
                      _cuda.make_generator(21, "cpu")).goal.numpy()
    jw = JBoxWorld(*(jnp.asarray(getattr(worlds, f).numpy()) for f in
                     ("centers", "half_sizes", "active", "shape")))
    js = jax.vmap(lambda k, w, g: jenv.reset(
        k, w, g, jpp, JMissionParams(), JMapParams(**MAPP),
        plan_map="scene"))(jax.random.split(jax.random.PRNGKey(21), B), jw,
                           jnp.asarray(goals))
    jvars, jcfg = jtrain.load_checkpoint(RESNET)
    step = jax.jit(jax.vmap(partial(
        jenv.step_segment, pp=jpp, mp=JMissionParams(), sp=JSimParams(),
        mission_mode="random", sensing="gt", mapp=None,
        cam=JCameraParams(width=640, height=480), planner="neo",
        net_vars=jvars, np_cfg=jcfg, plan_map="scene")))
    sd, cfg = train.load_checkpoint(RESNET)
    net = planner_net.PlannerNet(cfg)
    net.load_state_dict(sd)
    net.eval()
    st = to_port_state(js, pp, mapp)
    cam = CameraParams(width=640, height=480)
    out = []
    for _ in range(SEGMENTS):
        draws = _jax_draws(js.key, jpp)
        js, jinfo = step(js)
        st, info = env.step_segment(st, pp, MissionParams(), SimParams(),
                                    cam, net, draws=draws)
        out.append((js, jinfo, st, info))
    return out


def _flags(js, jinfo, st, info):
    """{flag: (JAX's sum, the port's sum, envs that differ)}."""
    got = {}
    for f in FLAGS:
        a = np.asarray(getattr(jinfo if f in ("planned", "ok") else js, f))
        b = getattr(info if f in ("planned", "ok") else st, f).numpy()
        got[f] = (int(a.sum()), int(b.sum()), int((a != b).sum()))
    return got


@pytest.mark.parametrize("max_iters", [1, 24])
def test_trained_net_missions_match_jax(max_iters):
    runs = _run(max_iters)
    for seg, (js, jinfo, st, info) in enumerate(runs):
        flags = _flags(js, jinfo, st, info)
        print(json.dumps(dict(max_iters=max_iters, segment=seg, **flags)))
        for f, (_, _, n_diff) in flags.items():
            assert n_diff == 0, (seg, f)
        if max_iters == 1:
            for f in ("pos", "vel"):
                np.testing.assert_allclose(
                    getattr(st.drone, f).numpy(),
                    np.asarray(getattr(js.drone, f)), atol=1e-4)
            np.testing.assert_allclose(st.buffer.numpy(),
                                       np.asarray(js.buffer), atol=1e-4)
            ok = np.asarray(jinfo.ok)
            np.testing.assert_allclose(info.int_wpts.numpy()[ok],
                                       np.asarray(jinfo.int_wpts)[ok],
                                       atol=1e-4)
