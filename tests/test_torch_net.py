"""The PlannerNet of the PyTorch port against the JAX package's flax net.

- flax-initialized parameters through learn/weights.from_flax give the same
  9 outputs as the flax apply (f32, TF32 off): 1e-4 of the output scale,
  the reassociation of f32 convolution and matmul sums.
- learn/weights.from_onnx on the committed artifacts/planner_net_smallconv.onnx
  gives the outputs of learn/onnx_interop.run_onnx (the numpy executor) on
  the same input: 1e-4 of the output scale.
- nn_init.predict on the same depth and state gives the same waypoints and
  durations as the JAX predict.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import NetParams as JNetParams
from neoplanner_tpu.config import PlannerParams as JPlannerParams
from neoplanner_tpu.core.types import DroneState as JDroneState
from neoplanner_tpu.learn import onnx_interop
from neoplanner_tpu.models import planner_net as jplanner_net
from neoplanner_tpu.plan import nn_init as jnn_init
from neoplanner_tpu_torch.config import NetParams, PlannerParams
from neoplanner_tpu_torch.core.types import DroneState
from neoplanner_tpu_torch.learn import weights
from neoplanner_tpu_torch.models import planner_net
from neoplanner_tpu_torch.plan import nn_init
from tests.test_torch_imports import one_torch_thread  # noqa: F401

ONNX = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                    "planner_net_smallconv.onnx")
SMALL = dict(img_width=40, img_height=30, backbone="smallconv")


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = prev


def _flax_vars(cfg):
    model = jplanner_net.create(cfg)
    return model, model.init(jax.random.PRNGKey(0),
                             jnp.zeros((1, cfg.img_height, cfg.img_width, 1)),
                             jnp.zeros((1, 24)))


def _inputs(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 255.0, (n, h, w, 1)).astype(np.float32)
    motion = rng.normal(size=(n, 24)).astype(np.float32)
    return img, motion


def test_from_flax_outputs_match():
    model, variables = _flax_vars(JNetParams(**SMALL))
    net = planner_net.PlannerNet(NetParams(**SMALL))
    net.load_state_dict(weights.from_flax(
        jax.tree_util.tree_map(np.asarray, variables)))
    img, motion = _inputs(4, 30, 40)
    want = np.asarray(model.apply(variables, img, motion))
    with torch.no_grad():
        got = net(torch.from_numpy(img), torch.from_numpy(motion)).numpy()
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-4)


def test_from_onnx_matches_numpy_executor():
    cfg = NetParams(img_width=160, img_height=120, backbone="smallconv")
    net = planner_net.PlannerNet(cfg)
    net.load_state_dict(weights.from_onnx(ONNX))
    img, motion = _inputs(1, 120, 160, seed=1)
    flat = np.concatenate([img.reshape(1, -1), motion], axis=1)
    want = onnx_interop.run_onnx(ONNX, {"input": flat})["output"]
    with torch.no_grad():
        got = net(torch.from_numpy(img), torch.from_numpy(motion)).numpy()
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-4)


def test_predict_matches():
    jcfg, cfg = JNetParams(**SMALL), NetParams(**SMALL)
    _, variables = _flax_vars(jcfg)
    net = planner_net.PlannerNet(cfg)
    net.load_state_dict(weights.from_flax(
        jax.tree_util.tree_map(np.asarray, variables)))
    rng = np.random.default_rng(2)
    n = 3
    depth = rng.uniform(0.3, 6.0, (n, 30, 40)).astype(np.float32)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    yaw = rng.normal(size=n).astype(np.float32)
    init = rng.normal(size=(n, 2, 2)).astype(np.float32)
    target = rng.normal(size=(n, 2, 2)).astype(np.float32)
    drone = DroneState(*(torch.from_numpy(a) for a in (pos, vel, q, yaw)))
    wpts, ts = nn_init.predict(net, torch.from_numpy(depth), drone, 2.0,
                               torch.from_numpy(init),
                               torch.from_numpy(target), PlannerParams())
    for i in range(n):
        jd = JDroneState(pos=pos[i], vel=vel[i], quat=q[i], yaw=yaw[i])
        jw, jt = jnn_init.predict(variables, jcfg, depth[i], jd, 2.0,
                                  init[i], target[i], JPlannerParams())
        np.testing.assert_allclose(wpts[i].numpy(), np.asarray(jw),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(ts[i].numpy(), np.asarray(jt), rtol=1e-4,
                                   atol=1e-4)
