"""The port's ResNet-18 PlannerNet and the conv1d fusion against the JAX
package on the CPU: the forward pass at 64 x 48 and, with the committed
trained checkpoint (artifacts/planner_net_resnet640, restored by JAX's
train.load_checkpoint and converted by weights.from_flax), at 640 x 480;
the ONNX file byte for byte and its executors; training with BatchNorm.

Tolerances. The forward passes run the same f32 arithmetic in another
order (MKL-DNN against XLA): outputs within 1e-5 of the largest output
component, plus 1e-5 relative (measured: 4e-5 of outputs up to 70, about
1e-6 of the scale). Training: the losses within 1e-4 relative at every
step, the running stats within 1e-4 relative, and the parameters as
tests/test_torch_learn.py holds Adam's: within 1e-4, except where a
gradient component was below 1e-6 at some step (its sign is roundoff),
there within 2 lr a step.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neoplanner_tpu.config import NetParams as JNetParams
from neoplanner_tpu.learn import onnx_interop as jonnx
from neoplanner_tpu.learn import train as jtrain
from neoplanner_tpu.models import planner_net as jplanner_net
from neoplanner_tpu_torch.config import NetParams
from neoplanner_tpu_torch.learn import onnx_interop, train, weights
from neoplanner_tpu_torch.models import resnet
from neoplanner_tpu_torch.models.planner_net import PlannerNet
from tests.test_torch_imports import one_torch_thread  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
NET = dict(img_width=64, img_height=48, backbone="resnet18")
LR = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _variables(np_cfg, seed=0, stats_seed=None):
    """JAX's initial variables as numpy; with stats_seed, running stats
    drawn from it (means N(0, 1), variances U(0.5, 1.5)), so that eval()
    mode reads stats that differ from the initial ones."""
    v = jax.tree_util.tree_map(np.asarray, jtrain.init_params(
        jax.random.PRNGKey(seed), JNetParams(**np_cfg)))
    if stats_seed is not None:
        rng = np.random.default_rng(stats_seed)

        def draw(path, a):
            if path[-1].key == "mean":
                return rng.normal(size=a.shape).astype(np.float32)
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            draw, v["batch_stats"])
    return v


def _port_net(variables, np_cfg):
    net = PlannerNet(NetParams(**np_cfg))
    net.load_state_dict(weights.from_flax(variables))
    return net.eval()


def _inputs(n, np_cfg, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (n, np_cfg["img_height"], np_cfg["img_width"],
                                 1)).astype(np.float32),
            rng.normal(size=(n, 24)).astype(np.float32))


def _close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("fusion", ["mlp", "conv1d"])
def test_resnet18_forward_matches_jax(fusion):
    """tests/test_learn.py::test_resnet18_forward on the port (the output's
    shape, a resnet18-class parameter count) and the outputs against
    JAX's apply(train=False) with nonzero running stats; conv1d also holds
    the channel-last flatten of the conv1d stacks."""
    cfg = dict(NET, fusion_arch=fusion)
    jvars = _variables(cfg, 0, stats_seed=1)
    net = _port_net(jvars, cfg)
    img, mot = _inputs(2, cfg, 2)
    want = np.asarray(jplanner_net.create(JNetParams(**cfg)).apply(
        jvars, img, mot, train=False))
    with torch.no_grad():
        got = net(_t(img), _t(mot)).numpy()
    assert got.shape == (2, 9)
    _close(got, want)
    n_params = sum(p.numel() for p in net.parameters())
    assert n_params == sum(a.size for a in jax.tree_util.tree_leaves(
        jvars["params"]))
    assert 10_000_000 < n_params < 13_000_000


def test_conv1d_variant():
    """tests/test_export_viz.py::test_conv1d_variant on the port (smallconv
    with conv1d fusion, images in [0, 255]) against JAX's outputs."""
    cfg = dict(NET, backbone="smallconv", fusion_arch="conv1d")
    jvars = _variables(cfg, 3)
    img, mot = _inputs(2, cfg, 4)
    want = np.asarray(jplanner_net.create(JNetParams(**cfg)).apply(
        jvars, img, mot, train=False))
    with torch.no_grad():
        got = _port_net(jvars, cfg)(_t(img), _t(mot)).numpy()
    assert got.shape == (2, 9)
    _close(got, want)


@pytest.mark.parametrize("shape", [(48, 64), (480, 640)])
def test_flax_pads_equal_torch_pads(shape):
    """flax's explicit pads (padding=1, 3) and 'SAME' pad of the 1x1/2
    downsample equal PyTorch's padding=1, 3 and 0: the spatial sizes of
    every stage agree with flax's at 64 x 48 and 640 x 480."""
    h, w = shape
    for n in (h, w):
        sizes = [n]
        for k, s, p in ((7, 2, 3), (3, 2, 1)):      # stem conv, max-pool
            sizes.append((sizes[-1] + 2 * p - k) // s + 1)
        for _ in range(3):                           # stages 1-3 stride 2
            main = (sizes[-1] + 2 - 3) // 2 + 1
            assert resnet.same_pads(sizes[-1], 1, 2) == (0, 0)
            assert main == (sizes[-1] - 1) // 2 + 1 == -(-sizes[-1] // 2)
            sizes.append(main)
    net = resnet.ResNet18().eval()
    x = torch.zeros((1, 1, h, w))
    with torch.no_grad():
        y = torch.nn.functional.max_pool2d(
            net.bn_0(net.conv_0(x)), 3, 2, 1)
        for block in net.blocks:
            y = block(y)
    jy = jax.eval_shape(
        lambda a: jplanner_net.create(JNetParams(
            img_width=w, img_height=h)).init_with_output(
                jax.random.PRNGKey(0), a, jnp.zeros((1, 24)))[0],
        jax.ShapeDtypeStruct((1, h, w, 1), jnp.float32))
    assert jy.shape == (1, 9)
    assert tuple(y.shape[2:]) == (-(-h // 32), -(-w // 32))


def test_trained_resnet640_checkpoint():
    """The committed 640 x 480 checkpoint, restored with orbax by JAX's
    train.load_checkpoint and converted by weights.from_flax, gives JAX's
    outputs at batch 1; its netcfg is NetParams()'s."""
    path = os.path.join(ROOT, "artifacts", "planner_net_resnet640")
    jvars, jcfg = jtrain.load_checkpoint(path)
    assert jcfg == JNetParams()
    cfg = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    net = _port_net(jvars, cfg)
    img, mot = _inputs(1, cfg, 5)
    want = np.asarray(jplanner_net.create(jcfg).apply(jvars, img, mot,
                                                      train=False))
    with torch.no_grad():
        got = net(_t(img), _t(mot)).numpy()
    _close(got, want)


def test_onnx_resnet18_matches_jax(tmp_path):
    """tests/test_onnx_interop.py::test_roundtrip_resnet18 on the port:
    export_planner_net writes JAX's file byte for byte; both run_onnx
    executors agree (1e-5) and with the net (the golden's 1e-3 and 1e-4
    relative; measured 3e-5); weights.from_onnx reads every weight and
    running stat back exactly."""
    jvars = _variables(NET, 6, stats_seed=7)
    a, b = str(tmp_path / "jax.onnx"), str(tmp_path / "port.onnx")
    jonnx.export_planner_net(jvars, JNetParams(**NET), a)
    net = _port_net(jvars, NET)
    onnx_interop.export_planner_net(net.state_dict(), NetParams(**NET), b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 255, (1, 64 * 48 + 24)).astype(np.float32)
    x[0, 64 * 48:] = rng.normal(size=24)
    want = jonnx.run_onnx(a, {"input": x})["output"]
    got = onnx_interop.run_onnx(b, {"input": x})["output"]
    np.testing.assert_allclose(got, want, atol=1e-5)
    with torch.no_grad():
        np.testing.assert_allclose(net.forward_flat(_t(x)).numpy(), want,
                                   atol=1e-3, rtol=1e-4)
    sd = weights.from_onnx(b)
    assert sd.keys() == net.state_dict().keys()
    for k, v in sd.items():
        assert torch.equal(v, net.state_dict()[k]), k


def _dataset(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (n, 48, 64)).astype(np.float32),
            rng.normal(size=(n, 24)).astype(np.float32),
            rng.normal(size=(n, 9)).astype(np.float32))


def _flax_names(params):
    """flax leaf paths of the ResNet PlannerNet -> the port's names."""
    out = {}
    for path, _ in jax.tree_util.tree_leaves_with_path(params):
        keys = [p.key for p in path]
        kind = {"kernel": "weight", "scale": "weight"}.get(keys[-1],
                                                           keys[-1])
        if keys[0] != "img_backbone":
            name, i = keys[0].rsplit("_", 1)
            out["/".join(keys)] = f"{name}.{i}.{kind}"
            continue
        parts = ["img_backbone"]
        for k in keys[1:-1]:
            if k.startswith("BasicBlock_"):
                parts += ["blocks", k.split("_")[1]]
            elif k == "Dense_0":
                parts.append("head")
            else:
                kind_, i = k.split("_")
                parts.append(("conv_" if kind_ == "Conv" else "bn_") + i)
        out["/".join(keys)] = ".".join(parts + [kind])
    return out


def _to_port(tree, names):
    """A tree shaped as flax's params (Adam's moments, gradients) -> {port
    name: tensor in the port's layout}, optax's masked-out leaves left
    out."""
    import optax
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        if isinstance(leaf, optax.MaskedNode):
            continue
        a = np.asarray(leaf)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2:
            a = a.T
        out[names["/".join(p.key for p in path)]] = _t(a)
    return out


def _adam_moments(opt_state, params):
    """(count, {port name: mu}, {port name: nu}) of optax's Adam state."""
    import optax
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    names = _flax_names(params)
    return int(adam.count), _to_port(adam.mu, names), _to_port(adam.nu,
                                                               names)


def _jax_step(cfg):
    """JAX's jitted training step (train.py:93-104), computing in f64."""
    model = jplanner_net.create(JNetParams(**NET), dtype=jnp.float64)

    def step(tx, params, stats, opt_state, img, mot, lab):
        def loss_fn(p):
            out, upd = model.apply({"params": p, "batch_stats": stats}, img,
                                   mot, train=True, mutable=["batch_stats"])
            return jnp.mean((out - lab) ** 2), upd["batch_stats"]
        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        import optax
        return (optax.apply_updates(params, updates), new_stats, opt_state,
                loss, grads)
    return jax.jit(step, static_argnums=0)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _port_step(before, mu, nu, count, batch, cfg, dtype):
    """One train_step of the port in dtype from a state_dict and Adam's
    moments; returns (loss, {name: gradient}, state_dict after)."""
    net = PlannerNet(NetParams(**NET)).to(dtype)
    net.load_state_dict({k: v.to(dtype) for k, v in before.items()})
    net.train()
    opt = train.make_optimizer(net, cfg)
    for name, p in net.named_parameters():
        if count and name in mu:
            opt.state[p] = {"step": torch.tensor(float(count)),
                            "exp_avg": mu[name].to(dtype),
                            "exp_avg_sq": nu[name].to(dtype)}
    loss = train.train_step(net, opt, *(_t(a).to(dtype) for a in batch))
    grads = {n: p.grad for n, p in net.named_parameters()
             if p.grad is not None}
    return float(loss), grads, net.state_dict()


@pytest.mark.parametrize("frozen", [False, True])
def test_three_bn_training_steps_match_jax(frozen):
    """Three Adam steps with BatchNorm on batches of 16 from JAX's initial
    weights, each step of the port taken from JAX's state before it (the
    parameters, the running stats and Adam's moments), both sides in f64
    (jax.enable_x64 and the flax net's dtype; the port's net .double()):
    the loss within 1e-9 relative, every gradient within 1e-7 of its
    tensor's largest component, the running stats within 1e-9 relative of
    their scale (so the biased batch variance and momentum 0.9), the
    parameters within 1e-9, or within 2 lr where the two gradients part
    by more than 1e-3 of the component (Adam moves a parameter by about lr
    whatever its gradient's size). The first step is also held in f32:
    the port's f32 step against JAX's f64 one, the loss within 1e-5
    relative and the gradients within 1e-4 of their scale.

    f64, because this net is ill-conditioned in f32 on [0, 255] images:
    BatchNorm's inputs have large means, and against f64 the port's f32
    gradients part by 3e-6 of their scale at the first step but by 1e-2
    at the third, and flax's (whose variance is E[x^2] - E[x]^2) by 5e-2
    at the first. A free f32 run of three steps therefore parts by a few
    1e-4 in the loss and is not held elementwise.

    With freeze_backbone the port's mask is JAX's _freeze_mask (the
    stem's and every block's Conv_0 train, every BatchNorm's scale and
    shift and the other convolutions do not), and the frozen parameters
    stay bit for bit while their running stats move."""
    cfg = train.TrainConfig(batch_size=16, seed=0, freeze_backbone=frozen)
    jcfg = jtrain.TrainConfig(batch_size=16, seed=0, freeze_backbone=frozen)
    depths, motions, labels = _dataset(48, 9)
    jv = jax.tree_util.tree_map(np.asarray, jtrain.init_params(
        jax.random.PRNGKey(0), JNetParams(**NET)))
    names = _flax_names(jv["params"])
    jmask = {names["/".join(p.key for p in path)]: bool(m)
             for path, m in jax.tree_util.tree_leaves_with_path(
                 jtrain._freeze_mask(jv["params"]))}
    assert train.freeze_mask(dict(PlannerNet(NetParams(**NET))
                                  .named_parameters())) == jmask
    init = weights.from_flax(jv)
    step = _jax_step(cfg)
    with jax.enable_x64(True):
        params, stats = _f64(jv["params"]), _f64(jv["batch_stats"])
        tx = jtrain.make_optimizer(jcfg, params)
        opt_state = tx.init(params)
    for k in range(3):
        batch = tuple(a[16 * k:16 * (k + 1)] for a in
                      (depths[..., None], motions, labels))
        with jax.enable_x64(True):
            before = weights.from_flax(_f64({"params": params,
                                             "batch_stats": stats}))
            count, mu, nu = _adam_moments(opt_state, params)
            params, stats, opt_state, jloss, jgrads = step(
                tx, params, stats, opt_state, *_f64(batch))
            jgrads = _to_port(jgrads, names)
            want = weights.from_flax(_f64({"params": params,
                                           "batch_stats": stats}))
        before = {n: t.double() for n, t in before.items()}
        if k == 0:
            loss32, g32, _ = _port_step(before, mu, nu, count, batch, cfg,
                                        torch.float32)
            assert abs(loss32 - float(jloss)) <= 1e-5 * float(jloss)
            for n, g in g32.items():
                assert float((g.double() - jgrads[n]).abs().max()) \
                    <= 1e-4 * float(jgrads[n].abs().max()), n
        loss, grads, got = _port_step(before, mu, nu, count, batch, cfg,
                                      torch.float64)
        assert abs(loss - float(jloss)) <= 1e-9 * float(jloss), k
        parted = {}
        for n, g in grads.items():
            jg = jgrads[n]
            assert float((g - jg).abs().max()) \
                <= 1e-7 * float(jg.abs().max()), (k, n)
            parted[n] = (g - jg).abs() > 1e-3 * jg.abs()
        for name, w in want.items():
            if name.endswith(("running_mean", "running_var")):
                assert not torch.equal(w, before[name]), name
                scale = float(w.abs().max())
                assert float((got[name] - w).abs().max()) <= 1e-9 * scale, \
                    (k, name)
            elif frozen and not jmask[name]:
                assert torch.equal(got[name].float(), init[name]), name
                assert torch.equal(w.float(), init[name]), name
            else:
                gap = (got[name] - w).abs()
                assert float(torch.where(parted[name], 0.0, gap).max()) \
                    <= 1e-9, (k, name)
                assert float(gap.max()) <= 2 * LR, (k, name)


def test_train_evaluates_on_running_stats():
    """train() evaluates the test split in eval() mode (JAX's eval_step,
    train=False): its last test loss is the returned net's on the running
    stats, which the training steps moved."""
    depths, motions, labels = _dataset(20, 10)
    cfg = train.TrainConfig(epochs=1, batch_size=8, train_split=0.5)
    init = train.init_params(torch.Generator().manual_seed(1),
                             NetParams(**NET))
    perm = np.arange(20)
    net, hist = train.train(depths, motions, labels, NetParams(**NET), cfg,
                            init=init, perm=perm, device="cpu")
    assert not net.training
    te = perm[10:]
    with torch.no_grad():
        out = net(_t(depths[te])[..., None], _t(motions[te]))
    loss = float(((out - _t(labels[te])) ** 2).mean())
    assert abs(loss - hist["test_loss"][-1]) <= 1e-6 * loss
    assert not torch.equal(net.state_dict()["img_backbone.bn_0.running_var"],
                           init["img_backbone.bn_0.running_var"])


def test_init_params_resnet():
    """init_params of the ResNet net: every state_dict entry, kernels
    lecun_normal, BatchNorm scale and running variance 1, shifts and
    running means 0, as flax initializes."""
    sd = train.init_params(torch.Generator().manual_seed(0),
                           NetParams(**NET))
    assert set(sd) == set(PlannerNet(NetParams(**NET)).state_dict())
    for k, v in sd.items():
        if ".bn_" in k:
            fill = 1.0 if k.endswith(("weight", "running_var")) else 0.0
            assert bool((v == fill).all()), k
        elif k.endswith("weight"):
            lim = 2 * np.sqrt(1.0 / v[0].numel()) / 0.87962566103423978
            assert float(v.abs().max()) <= lim * (1 + 1e-6), k
            assert float(v.abs().max()) > 0, k
        else:
            assert not v.any(), k


def test_record_and_csv_at_640x480(tmp_path):
    """The data path of pipeline --resnet640 at the paper's frame size on
    the CPU: record_rollout renders 640 x 480 frames, the CSV export and
    load_csv keep them whole, and the ResNet-18 net of NetParams() reads
    them (one training step, eval() forward)."""
    from neoplanner_tpu_torch import _cuda
    from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                             MissionParams, PlannerParams,
                                             SimParams, WorldParams)
    from neoplanner_tpu_torch.learn import datagen
    from neoplanner_tpu_torch.sim import env
    from neoplanner_tpu_torch.world import scenegen
    pp = PlannerParams(max_iters=2, samples_per_piece=6, retry_num=2,
                       extra_lateral_scales=(), max_ls=2)
    mp, sp = MissionParams(), SimParams()
    mapp = MapParams(width=256, height=192, origin_x=-4.0, origin_y=-9.6)
    cam = CameraParams(width=640, height=480)
    gen = _cuda.make_generator(5, "cpu")
    state = env.reset(scenegen.generate_batch(gen, 2, WorldParams(
        num_boxes=8)), pp, mp, mapp, gen)
    _, depths, motions, labels, valid = datagen.record_rollout(
        state, 1, pp, mp, sp, cam, mp.des_pos_z)
    assert depths.shape == (2, 1, 480, 640) and bool(valid.any())
    d, m, l = datagen.flatten_valid(depths, motions, labels, valid)
    datagen.export_csv(str(tmp_path), d, m, l)
    d2, m2, l2 = datagen.load_csv(str(tmp_path))
    assert d2.shape == (len(d), 480, 640)
    np.testing.assert_array_equal(d2, np.floor(d).astype(np.float32))
    net = PlannerNet(NetParams())
    net.load_state_dict(train.init_params(torch.Generator().manual_seed(0),
                                          NetParams()))
    opt = train.make_optimizer(net.train(), train.TrainConfig())
    loss = train.train_step(net, opt, _t(d2)[..., None], _t(m2), _t(l2))
    assert bool(torch.isfinite(loss))
    with torch.no_grad():
        assert net.eval()(_t(d2)[..., None], _t(m2)).shape == (len(d), 9)
