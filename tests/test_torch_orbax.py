"""The port's orbax restore (neoplanner_tpu_torch/io/orbax.py, under
learn/train.load_checkpoint) against the JAX package's: both committed
checkpoints bit for bit against JAX's train.load_checkpoint converted by
weights.from_flax, the smallconv also against weights.from_onnx of its
.onnx; nets that JAX's train.save_checkpoint writes here (smallconv and
ResNet-18 with running stats); a general pytree (scalars, integer and
bool dtypes, an empty dict) against orbax's own restore, and the refusal
of what the JAX package never writes (sequence keys); zarr arrays
of several chunks in C and F order with missing chunks (fill values),
written by tensorstore; the SHA-256 that chip_smoke.py phase (v) holds on
the card; and the trained ResNet-18's forward pass on one 640 x 480 frame
against JAX's at tests/test_torch_resnet.py's tolerance."""

import dataclasses
import importlib.util
import os

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

from neoplanner_tpu.config import NetParams as JNetParams
from neoplanner_tpu.learn import train as jtrain
from neoplanner_tpu.models import planner_net as jplanner_net
from neoplanner_tpu_torch.config import NetParams
from neoplanner_tpu_torch.io import orbax
from neoplanner_tpu_torch.learn import train, weights
from neoplanner_tpu_torch.models import planner_net
from tests.test_torch_imports import one_torch_thread  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SMALL = os.path.join(ROOT, "artifacts", "planner_net_smallconv")
RESNET = os.path.join(ROOT, "artifacts", "planner_net_resnet640")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def _jax_state_dict(path):
    jvars, jcfg = jtrain.load_checkpoint(path)
    return weights.from_flax(jvars), jcfg


@pytest.mark.parametrize("path", [SMALL, RESNET],
                         ids=["smallconv", "resnet640"])
def test_load_checkpoint_matches_jax(path):
    sd, cfg = train.load_checkpoint(path)
    want, jcfg = _jax_state_dict(path)
    _assert_same(sd, want)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_smallconv_checkpoint_equals_onnx():
    sd, _ = train.load_checkpoint(SMALL)
    _assert_same(sd, weights.from_onnx(SMALL + ".onnx"))


def test_resnet640_digest():
    """The constant that chip_smoke.py phase (v) holds the card host's
    restore to is the digest of JAX's restore, and of the port's."""
    const = _chip_smoke().RESNET640_SHA256
    want, _ = _jax_state_dict(RESNET)
    assert weights.digest(want) == const
    stats = {}
    assert weights.digest(weights.from_flax(orbax.restore(
        RESNET, stats))) == const
    assert stats["arrays"] == 118
    assert stats["bytes_decoded"] == 11_212_969 * 4


def test_restore_matches_jax_tree():
    """io/orbax.restore gives JAX's variables: the same nested keys,
    dtypes and bits (the smallconv's batch_stats an empty dict)."""
    got = orbax.restore(SMALL)
    want, _ = jtrain.load_checkpoint(SMALL)
    assert got["batch_stats"] == {} == dict(want["batch_stats"])
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves_with_path(dict(want))
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (_, g), (_, w) in zip(flat_g, flat_w):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("backbone", ["smallconv", "resnet18"])
def test_roundtrip_net_saved_by_jax(tmp_path, backbone):
    """A net that JAX's train.save_checkpoint writes (ResNet-18 with drawn
    running stats) loads through the port bit for bit, as does
    planner_net.load of the directory."""
    cfg = dict(img_width=32, img_height=24, backbone=backbone)
    jcfg = JNetParams(**cfg)
    variables = jax.tree_util.tree_map(np.asarray, jtrain.init_params(
        jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(4)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        variables.get("batch_stats", {}))
    path = str(tmp_path / "net")
    jtrain.save_checkpoint(path, variables, jcfg)
    sd, np_cfg = train.load_checkpoint(path)
    _assert_same(sd, weights.from_flax(variables))
    assert np_cfg == NetParams(**cfg)
    net = planner_net.load(path, np_cfg, "cpu")
    _assert_same({k: v for k, v in net.state_dict().items()
                  if k in sd}, sd)


def test_restore_tree_general_pytree(tmp_path):
    """orbax's StandardCheckpointer on a pytree with scalars, int32, uint8,
    int64, float64, bool and an empty dict: restore_tree equals orbax's own
    numpy restore."""
    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
            "b": {"x": np.full(3, 1.5), "y": np.array(True)}, "c": {},
            "d": np.full((2, 2), 7, np.uint8), "e": np.float32(3.0),
            "f": {"g": np.arange(5, dtype=np.int64)}}
    path = str(tmp_path / "tree")
    with ocp.StandardCheckpointer() as ck:
        ck.save(path, tree)
    with ocp.PyTreeCheckpointer() as ck:
        meta = ck.metadata(path).item_metadata
        want = ck.restore(path, restore_args=jax.tree_util.tree_map(
            lambda _: ocp.RestoreArgs(restore_type=np.ndarray), meta))
    got = orbax.restore_tree(path)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_sequence_keys_raise(tmp_path):
    path = str(tmp_path / "tree")
    with ocp.StandardCheckpointer() as ck:
        ck.save(path, {"a": [np.zeros(2), np.ones(2)]})
    with pytest.raises(ValueError, match="key type 1"):
        orbax.restore_tree(path)


class _Dict(dict):
    read = dict.__getitem__


class _Files:
    """A store whose keys are files under a directory."""

    def __init__(self, root):
        self.root = root

    def read(self, key):
        path = os.path.join(self.root, key)
        if not os.path.isfile(path):
            raise KeyError(key)
        with open(path, "rb") as f:
            return f.read()


@pytest.mark.parametrize("order", ["C", "F"])
@pytest.mark.parametrize("compressor", [None, {"id": "zstd", "level": 5}],
                         ids=["raw", "zstd"])
def test_read_array_chunks(tmp_path, order, compressor):
    """A 5 x 7 x 3 zarr v2 array in 2 x 3 x 2 chunks (edge chunks cut),
    only part of it written (the missing chunks hold the fill value),
    written and read back by tensorstore; read_array over its files."""
    spec = {"driver": "zarr",
            "kvstore": {"driver": "file", "path": str(tmp_path / "arr")},
            "metadata": {"shape": [5, 7, 3], "chunks": [2, 3, 2],
                         "dtype": "<i4", "order": order, "fill_value": -9,
                         "compressor": compressor}}
    arr = ts.open(spec, create=True).result()
    rng = np.random.default_rng(0)
    arr[1:4, 2:7, :].write(rng.integers(-1000, 1000, (3, 5, 3)).astype(
        np.int32)).result()
    want = arr.read().result()
    got = orbax.read_array(_Files(tmp_path), "arr")
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert (got == -9).sum() > 0


@pytest.mark.parametrize("dtype", ["bfloat16", "<c8", "|S4", "<M8[s]"])
def test_unsupported_dtype_raises(dtype):
    store = _Dict({"x/.zarray": (
        b'{"chunks":[2],"compressor":null,"dtype":"%s","fill_value":null,'
        b'"filters":null,"order":"C","shape":[2],"zarr_format":2}'
        % dtype.encode())})
    with pytest.raises(ValueError, match="dtype"):
        orbax.read_array(store, "x")


def test_trained_resnet640_forward_matches_jax():
    """The port's trained ResNet-18 (weights from its own restore) on one
    640 x 480 frame against JAX's apply(train=False) on JAX's restore, at
    tests/test_torch_resnet.py's tolerance: 1e-5 relative plus 1e-5 of the
    largest output."""
    sd, cfg = train.load_checkpoint(RESNET)
    net = planner_net.PlannerNet(cfg)
    net.load_state_dict(sd)
    net.eval()
    jvars, jcfg = jtrain.load_checkpoint(RESNET)
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, (1, 480, 640, 1)).astype(np.float32)
    mot = rng.normal(size=(1, 24)).astype(np.float32)
    want = np.asarray(jplanner_net.create(jcfg).apply(jvars, img, mot,
                                                      train=False))
    with torch.no_grad():
        got = net(torch.from_numpy(img), torch.from_numpy(mot)).numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
