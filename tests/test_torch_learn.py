"""The port's learning stack against the JAX package on the CPU: the label
and input functions, the CSV export, Adam training, checkpoints, the ONNX
writer and executor and the torch.export program, plus the record rollout
and the pipeline on the port alone.

Adam. Its first steps move a parameter by about lr * sign(g). A gradient
component at roundoff's scale can take either sign in XLA and in ATen, and
such a parameter may then part from JAX's by up to 2 lr a step. So the
parameters are held within 1e-4 except where a gradient component was
below 1e-6 at some step, and there within 2 lr a step; the losses are held
within 1e-4 relative at every step.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import CameraParams as JCameraParams
from neoplanner_tpu.config import NetParams as JNetParams
from neoplanner_tpu.core import frames as jframes
from neoplanner_tpu.core.types import DroneState as JDroneState
from neoplanner_tpu.io import onnx_proto as jop
from neoplanner_tpu.learn import data as jdata
from neoplanner_tpu.learn import datagen as jdatagen
from neoplanner_tpu.learn import onnx_interop as jonnx
from neoplanner_tpu.learn import train as jtrain
from neoplanner_tpu.models import planner_net as jplanner_net
from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, NetParams,
                                         PlannerParams, SimParams,
                                         WorldParams)
from neoplanner_tpu_torch.core import frames
from neoplanner_tpu_torch.core.types import DroneState
from neoplanner_tpu_torch.io import onnx_proto
from neoplanner_tpu_torch.learn import (data, datagen, export, onnx_interop,
                                        pipeline, train, weights)
from neoplanner_tpu_torch.models.planner_net import PlannerNet
from neoplanner_tpu_torch.sim import env
from neoplanner_tpu_torch.world import scenegen
from tests.test_torch_imports import one_torch_thread  # noqa: F401

NET = dict(img_width=64, img_height=48, backbone="smallconv")
LR = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _drones(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    vel = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    yaw = rng.uniform(-3, 3, n).astype(np.float32)
    jq = jax.vmap(jframes.quat_from_yaw)(jnp.asarray(yaw))
    jd = JDroneState(pos=jnp.asarray(pos), vel=jnp.asarray(vel), quat=jq,
                     yaw=jnp.asarray(yaw))
    td = DroneState(pos=_t(pos), vel=_t(vel),
                    quat=frames.quat_from_yaw(_t(yaw)), yaw=_t(yaw))
    return jd, td


def _variables(np_cfg, seed=0):
    return jtrain.init_params(jax.random.PRNGKey(seed), JNetParams(**np_cfg))


def _port_net(variables, np_cfg):
    net = PlannerNet(NetParams(**np_cfg))
    net.load_state_dict(weights.from_flax(jax.tree_util.tree_map(
        np.asarray, variables)))
    return net.eval()


def _dataset(n, np_cfg, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (n, np_cfg["img_height"],
                                 np_cfg["img_width"])).astype(np.float32),
            rng.normal(size=(n, 24)).astype(np.float32),
            rng.normal(size=(n, 9)).astype(np.float32))


def test_data_functions_match():
    """wpts_to_body, make_label and flat_input against JAX's: 1e-5."""
    n = 16
    jd, td = _drones(n, 0)
    rng = np.random.default_rng(1)
    wpts = rng.uniform(-5, 5, (n, 2, 2)).astype(np.float32)
    ts = rng.uniform(0.5, 2, (n, 3)).astype(np.float32)
    np.testing.assert_allclose(
        data.wpts_to_body(td, 2.0, _t(wpts)).numpy(),
        np.asarray(jdata.wpts_to_body(jd, 2.0, jnp.asarray(wpts))),
        atol=1e-5)
    label = data.make_label(td, 2.0, _t(wpts), _t(ts))
    np.testing.assert_allclose(
        label.numpy(), np.asarray(jdata.make_label(jd, 2.0, wpts, ts)),
        atol=1e-5)
    back = data.wpts_from_body(td, label[:, :6], 2)
    np.testing.assert_allclose(back.numpy(), wpts, atol=1e-4)
    depth = rng.uniform(0, 255, (n, 12, 16)).astype(np.float32)
    motion = rng.normal(size=(n, 24)).astype(np.float32)
    np.testing.assert_allclose(
        data.flat_input(_t(depth), _t(motion)).numpy(),
        np.asarray(jdata.flat_input(depth, motion)), atol=1e-5)


def test_csv_matches_jax(tmp_path):
    """export_csv writes JAX's train.csv byte for byte and PNGs with the
    same pixels; load_csv returns JAX's arrays exactly (also appending)."""
    rng = np.random.default_rng(2)
    depths = rng.uniform(0, 255, (6, 12, 16)).astype(np.float32)
    motions = rng.normal(size=(6, 24)).astype(np.float32)
    labels = rng.normal(size=(6, 9)).astype(np.float32)
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    for mod, out in ((jdatagen, a), (datagen, b)):
        mod.export_csv(out, depths[:4], motions[:4], labels[:4])
        mod.export_csv(out, depths[4:], motions[4:], labels[4:], start_id=4)
    with open(os.path.join(a, "train.csv"), "rb") as fa, \
            open(os.path.join(b, "train.csv"), "rb") as fb:
        assert fa.read() == fb.read()
    from PIL import Image
    for i in range(6):
        pa, pb = (np.asarray(Image.open(os.path.join(d, "depth_img",
                                                     f"{i}.png")))
                  for d in (a, b))
        np.testing.assert_array_equal(pa, pb)
    want = jdatagen.load_csv(a, JCameraParams(width=16, height=12))
    got = datagen.load_csv(b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert datagen.CSV_HEADER == jdatagen.CSV_HEADER


def _mse_grads(net, img, mot, lab):
    net.zero_grad()
    ((net(img, mot) - lab) ** 2).mean().backward()
    return {k: p.grad.abs().clone() for k, p in net.named_parameters()}


def test_adam_steps_match_jax():
    """Five Adam steps (five epochs of one batch of 16 of 24 training
    samples) from JAX's initial weights, on JAX's split and batches."""
    n, cfg_kw = 30, dict(epochs=5, batch_size=16, train_split=0.8, seed=0)
    depths, motions, labels = _dataset(n, NET, 3)
    jvars, jhist = jtrain.train(jax.random.PRNGKey(0), depths, motions,
                                labels, JNetParams(**NET),
                                jtrain.TrainConfig(**cfg_kw))
    k_init, k_perm = jax.random.split(jax.random.PRNGKey(cfg_kw["seed"]))
    init = weights.from_flax(jax.tree_util.tree_map(
        np.asarray, jtrain.init_params(k_init, JNetParams(**NET))))
    perm = np.asarray(jax.random.permutation(k_perm, n))
    cfg = train.TrainConfig(**cfg_kw)
    net, hist = train.train(depths, motions, labels, NetParams(**NET), cfg,
                            init=init, perm=perm, device="cpu")
    np.testing.assert_allclose(hist["train_loss"], jhist["train_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(hist["test_loss"], jhist["test_loss"],
                               rtol=1e-4)
    # replay the same steps to find each parameter's smallest gradient
    replay = PlannerNet(NetParams(**NET))
    replay.load_state_dict(init)
    opt = train.make_optimizer(replay, cfg)
    tr = perm[:int(cfg.train_split * n)]
    rng = np.random.default_rng(cfg.seed)
    small = {k: torch.zeros_like(p, dtype=torch.bool)
             for k, p in replay.named_parameters()}
    for _ in range(cfg.epochs):
        idx = torch.as_tensor(tr[rng.permutation(len(tr))[:16]])
        batch = (_t(depths)[idx][..., None], _t(motions)[idx],
                 _t(labels)[idx])
        g = _mse_grads(replay, *batch)
        for k in small:
            small[k] |= g[k] < 1e-6
        train.train_step(replay, opt, *batch)
    got, want = net.state_dict(), weights.from_flax(
        jax.tree_util.tree_map(np.asarray, jvars))
    n_small, worst = 0, 0.0
    for k, w in want.items():
        torch.testing.assert_close(replay.state_dict()[k], got[k], rtol=0,
                                   atol=0)
        gap = (got[k] - w).abs()
        n_small += int(small[k].sum())
        worst = max(worst, float(gap.max()))
        big = torch.where(small[k], 0.0, gap)
        assert float(big.max()) <= 1e-4, k
        assert float(gap.max()) <= 2 * LR * cfg.epochs, k
    print(f"Adam parity: {n_small} components saw a gradient below 1e-6; "
          f"largest gap {worst:.3g}")


def _flax_leaf_names(params):
    """flax PlannerNet parameter paths -> the port's state_dict names."""
    out = {}
    for path, _ in jax.tree_util.tree_leaves_with_path(params):
        keys = [p.key for p in path]
        kind = "weight" if keys[-1] == "kernel" else "bias"
        if keys[0] == "img_backbone":
            layer = ("head" if keys[1] == "Dense_0"
                     else f"convs.{keys[1].split('_')[1]}")
            out["/".join(keys)] = f"img_backbone.{layer}.{kind}"
        else:
            name, i = keys[0].rsplit("_", 1)
            out["/".join(keys)] = f"{name}.{i}.{kind}"
    return out


def test_freeze_backbone_matches_jax_mask():
    """The frozen leaves are JAX's _freeze_mask's, and training leaves them
    bit for bit as they were while the others move."""
    params = _variables(NET)["params"]
    names = _flax_leaf_names(params)
    jmask = {names["/".join(p.key for p in path)]: bool(m)
             for path, m in jax.tree_util.tree_leaves_with_path(
                 jtrain._freeze_mask(params))}
    init = weights.from_flax(jax.tree_util.tree_map(np.asarray, params))
    assert train.freeze_mask(init) == jmask
    depths, motions, labels = _dataset(20, NET, 4)
    net, _ = train.train(depths, motions, labels, NetParams(**NET),
                         train.TrainConfig(epochs=2, batch_size=8,
                                           freeze_backbone=True),
                         init=init, device="cpu")
    for k, p in net.state_dict().items():
        if jmask[k]:
            assert not torch.equal(p, init[k]), k
        else:
            assert torch.equal(p, init[k]), k


def test_checkpoints(tmp_path):
    """A JAX orbax checkpoint, restored and converted, gives the port's net
    JAX's outputs (1e-5); the port's own checkpoint round trip is exact and
    its .netcfg.json is JAX's text."""
    jcfg = JNetParams(**NET)
    jvars = _variables(NET, 5)
    jpath = str(tmp_path / "jax_ckpt")
    jtrain.save_checkpoint(jpath, jvars, jcfg)
    restored, jcfg2 = jtrain.load_checkpoint(jpath)
    net = _port_net(restored, NET)
    img, mot, _ = _dataset(3, NET, 6)
    want = jplanner_net.create(jcfg).apply(jvars, img[..., None], mot)
    with torch.no_grad():
        got = net(_t(img)[..., None], _t(mot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    path = str(tmp_path / "port.pt")
    train.save_checkpoint(path, net.state_dict(), NetParams(**NET))
    sd, cfg = train.load_checkpoint(path)
    assert cfg == NetParams(**NET)
    for k, v in net.state_dict().items():
        assert torch.equal(sd[k], v), k
    with open(jpath + ".netcfg.json") as fa, \
            open(path + ".netcfg.json") as fb:
        assert fa.read() == fb.read()


def test_init_params_lecun_normal():
    """flax's lecun_normal: kernels within 2 standard deviations of a
    truncated normal of variance 1 / fan_in, biases zero."""
    sd = train.init_params(torch.Generator().manual_seed(0),
                           NetParams(**NET))
    assert set(sd) == set(PlannerNet(NetParams(**NET)).state_dict())
    for k, v in sd.items():
        if k.endswith("bias"):
            assert not v.any()
            continue
        fan_in = v[0].numel()
        lim = 2 * np.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert float(v.abs().max()) <= lim * (1 + 1e-6)
        if v.numel() >= 1000:
            assert abs(float(v.var()) * fan_in - 1.0) < 0.15, k


ONNX_NET = dict(img_width=32, img_height=24, backbone="smallconv")


def test_onnx_export_matches_jax(tmp_path):
    """export_planner_net writes JAX's file byte for byte (node for node,
    bit-equal initializers); both run_onnx executors and the net agree
    within 1e-5; weights.from_onnx reads the weights back exactly."""
    jvars = _variables(ONNX_NET, 7)
    a, b = str(tmp_path / "jax.onnx"), str(tmp_path / "port.onnx")
    jonnx.export_planner_net(jvars, JNetParams(**ONNX_NET), a)
    net = _port_net(jvars, ONNX_NET)
    onnx_interop.export_planner_net(net.state_dict(), NetParams(**ONNX_NET),
                                    b)
    ma, mb = (jop.parse_model(open(p, "rb").read()) for p in (a, b))
    assert [(n["op"], n["inputs"], n["outputs"], n["attrs"])
            for n in ma["nodes"]] == [(n["op"], n["inputs"], n["outputs"],
                                       n["attrs"]) for n in mb["nodes"]]
    assert ma["initializers"].keys() == mb["initializers"].keys()
    for k, v in ma["initializers"].items():
        assert v.dtype == mb["initializers"][k].dtype
        assert v.tobytes() == mb["initializers"][k].tobytes(), k
    assert open(a, "rb").read() == open(b, "rb").read()
    x = np.random.default_rng(8).uniform(0, 1, (1, 32 * 24 + 24)).astype(
        np.float32)
    want = jonnx.run_onnx(a, {"input": x})["output"]
    got = onnx_interop.run_onnx(b, {"input": x})["output"]
    np.testing.assert_allclose(got, want, atol=1e-5)
    with torch.no_grad():
        np.testing.assert_allclose(net.forward_flat(_t(x)).numpy(), want,
                                   atol=1e-5)
    for k, v in weights.from_onnx(b).items():
        assert torch.equal(v, net.state_dict()[k]), k


def test_proto_parse_inverts_build():
    """The port's wire-level reader inverts its writer on a nontrivial
    graph (tests/test_onnx_interop.py's case), and its bytes are JAX's."""
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    blobs = []
    for op in (onnx_proto, jop):
        n1 = op.node("Gemm", ["x", "W", "b"], ["y"],
                     attrs=[op.attr_f("alpha", 1.0)])
        n2 = op.node("Relu", ["y"], ["out"])
        g = op.graph([n1, n2], "g", [op.tensor("W", w)],
                     [op.value_info("x", (1, 3))],
                     [op.value_info("out", (1, 4))])
        blobs.append(op.model(g, opset=13))
    assert blobs[0] == blobs[1]
    m = onnx_proto.parse_model(blobs[0])
    assert m["opset"] == 13
    assert [n["op"] for n in m["nodes"]] == ["Gemm", "Relu"]
    assert m["nodes"][0]["attrs"]["alpha"] == 1.0
    assert m["inputs"] == ["x"] and m["outputs"] == ["out"]
    np.testing.assert_array_equal(m["initializers"]["W"], w)


def test_torch_export_matches_apply_flat(tmp_path):
    """The saved torch.export program and forward_flat against JAX's
    apply_flat at batch 1 and 3 on the golden's inputs (uniform in [0, 1),
    tests/test_export_viz.py::test_export_roundtrip): 1e-5, its tolerance."""
    jvars = _variables(NET, 9)
    net = _port_net(jvars, NET)
    model = jplanner_net.create(JNetParams(**NET))
    n_in = 64 * 48 + 24
    for batch in (1, 3):
        x = np.random.default_rng(batch).uniform(0, 1, (batch, n_in)) \
            .astype(np.float32)
        want = np.asarray(model.apply(
            jvars, x, method=jplanner_net.PlannerNet.apply_flat))
        path = str(tmp_path / f"net{batch}.pt2")
        export.save(path, net, batch)
        engine = export.load(path, "cpu")
        with torch.no_grad():
            np.testing.assert_allclose(engine(_t(x)).numpy(), want,
                                       atol=1e-5)
            np.testing.assert_allclose(net.forward_flat(_t(x)).numpy(),
                                       want, atol=1e-5)
    mean_ms, p50_ms = export.latency_test(engine, _t(x), warmup=2, iters=5)
    assert p50_ms > 0 and mean_ms > 0


def _lean():
    return PlannerParams(max_iters=2, samples_per_piece=6, retry_num=2,
                         extra_lateral_scales=(), max_ls=2)


def test_record_rollout_env_major():
    """record_rollout on the CPU: (B, S, ...) samples, frames normalized to
    a peak of 255, labels ending in the plan's durations; flatten_valid and
    collect keep JAX's env-major order of the valid samples."""
    pp, mp, sp = _lean(), MissionParams(), SimParams()
    cam = CameraParams(width=32, height=24)
    mapp = MapParams(width=256, height=192, origin_x=-4.0, origin_y=-9.6)
    wp = WorldParams(num_boxes=8)
    gen = _cuda.make_generator(3, "cpu")
    state = env.reset(scenegen.generate_batch(gen, 3, wp), pp, mp, mapp, gen)
    _, depths, motions, labels, valid = datagen.record_rollout(
        state, 3, pp, mp, sp, cam, mp.des_pos_z)
    assert depths.shape == (3, 3, 24, 32) and motions.shape == (3, 3, 24)
    assert labels.shape == (3, 3, 9) and valid.shape == (3, 3)
    assert valid.any()
    np.testing.assert_allclose(depths.amax((-2, -1)).numpy(), 255.0,
                               rtol=1e-6)
    assert bool((labels[..., 6:] >= pp.t_min).all())
    d, m, l = datagen.flatten_valid(depths, motions, labels, valid)
    rows = [(b, s) for b in range(3) for s in range(3) if valid[b, s]]
    assert len(d) == len(rows)
    for i, (b, s) in enumerate(rows):
        np.testing.assert_array_equal(d[i], depths[b, s].numpy())
        np.testing.assert_array_equal(m[i], motions[b, s].numpy())
        np.testing.assert_array_equal(l[i], labels[b, s].numpy())
    got = datagen.collect(_cuda.make_generator(3, "cpu"), 3, 3, pp, mp, sp,
                          mapp, cam, wp, device="cpu")
    for g, w in zip(got, (d, m, l)):
        np.testing.assert_array_equal(g, w)


def test_pipeline_on_cpu(tmp_path):
    """pipeline.main at a tiny size on the CPU: data, training, the
    checkpoint, the program and the ONNX file, each holding the net."""
    out = str(tmp_path / "net")
    res = pipeline.main(["--device", "cpu", "--envs", "3", "--pulls", "1",
                         "--segments-per-pull", "2", "--epochs", "1",
                         "--max-iters", "2", "--out", out])
    assert res["samples"] > 0 and res["steps_per_epoch"] == 1
    assert res["step_ms"] > 0 and len(res["history"]["epoch_s"]) == 1
    net = res["net"]
    sd, cfg = train.load_checkpoint(res["paths"]["checkpoint"])
    assert cfg == net.np_cfg
    for k, v in weights.from_onnx(res["paths"]["onnx"]).items():
        assert torch.equal(v, net.state_dict()[k])
        assert torch.equal(sd[k], v)
    x = torch.rand((1, 160 * 120 + 24)) * 255
    with torch.no_grad():
        torch.testing.assert_close(
            export.load(res["paths"]["program"], "cpu")(x),
            net.forward_flat(x), rtol=0, atol=1e-5)
    assert res["latency_ms"][1] > 0


def test_entry_points_need_a_card_by_default():
    """collect, train, export.load and pipeline.main default to CUDA and
    raise without a GPU (there is no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the defaults run there")
    d, m, l = _dataset(4, NET, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train(d, m, l, NetParams(**NET))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        datagen.collect(torch.Generator(), 2, 1, _lean(), MissionParams(),
                        SimParams(), MapParams(), CameraParams(),
                        WorldParams())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.load("unused.pt2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.main(["--envs", "2"])
