"""The port's orbax writer (io/orbax.save under learn/train.save_checkpoint,
io/ocdbt.write_store, learn/weights.to_flax) against the JAX package,
orbax and tensorstore, which only these tests import.

Three nets: the committed smallconv checkpoint, a conv1d-fusion net that
JAX's train.save_checkpoint writes here, and the committed trained
ResNet-18 at NetParams()'s full width (640 x 480, 44.8 MB of arrays). Each
is restored by the port, written by its save_checkpoint, and then:
JAX's train.load_checkpoint gives the tree and the bits of JAX's restore
of the source (an empty batch_stats included); _METADATA equals what JAX's
save_checkpoint writes for the same numpy variables; the .netcfg.json text
is JAX's; orbax's StandardCheckpointer restores it; tensorstore's ocdbt
driver lists the same keys and reads the same bytes, and its zarr driver
the arrays; the port's restore round-trips it."""

import dataclasses
import json
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
from neoplanner_tpu_torch.io import ocdbt, orbax
from neoplanner_tpu_torch.learn import train, weights
from neoplanner_tpu_torch.models.planner_net import PlannerNet
from tests.test_torch_imports import one_torch_thread  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
NETS = ("smallconv", "conv1d", "resnet640")
CONV1D = dict(img_width=32, img_height=24, backbone="smallconv",
              fusion_arch="conv1d")
SMALL_CFGS = (dict(img_width=32, img_height=24, backbone="smallconv"),
              CONV1D, dict(img_width=64, img_height=48, backbone="resnet18"),
              dict(img_width=64, img_height=48, backbone="resnet18",
                   fusion_arch="conv1d"))


def _init_variables(cfg, seed):
    """Variables of the tree that JAX's planner_net.create(cfg).init gives
    (traced, not run), as float32 numpy arrays drawn from seed;
    batch_stats empty where the net has no BatchNorm (as JAX's train()
    returns it)."""
    jcfg = JNetParams(**cfg)
    shapes = jax.eval_shape(
        jplanner_net.create(jcfg).init, jax.random.PRNGKey(seed),
        np.zeros((1, jcfg.img_height, jcfg.img_width, 1), np.float32),
        np.zeros((1, jcfg.motion_input_size), np.float32))
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(s.dtype), dict(shapes))
    v.setdefault("batch_stats", {})
    return v


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Per net: the source checkpoint, JAX's restore of it, the port's
    state_dict, and the directories that the port's save_checkpoint and
    JAX's save_checkpoint (of JAX's restore) wrote."""
    base = tmp_path_factory.mktemp("orbax_write")
    conv1d = str(base / "conv1d_src")
    jtrain.save_checkpoint(conv1d, _init_variables(CONV1D, 1),
                           JNetParams(**CONV1D))
    sources = dict(
        smallconv=os.path.join(ROOT, "artifacts", "planner_net_smallconv"),
        conv1d=conv1d,
        resnet640=os.path.join(ROOT, "artifacts", "planner_net_resnet640"))
    out = {}
    for name, src in sources.items():
        want, jcfg = jtrain.load_checkpoint(src)
        sd, cfg = train.load_checkpoint(src)
        port, jax_dir = str(base / f"{name}_port"), str(base / f"{name}_jax")
        train.save_checkpoint(port, sd, cfg)
        jtrain.save_checkpoint(jax_dir, want, jcfg)
        out[name] = dict(src=src, want=dict(want), jcfg=jcfg, sd=sd,
                         cfg=cfg, port=port, jax=jax_dir)
    return out


def _assert_same_tree(got, want):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert type(g) is np.ndarray
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


@pytest.mark.parametrize("name", NETS)
def test_jax_loads_port_checkpoint(written, name):
    """JAX's train.load_checkpoint of the port's checkpoint: JAX's restore
    of the source, leaf for leaf and bit for bit, and its NetParams."""
    w = written[name]
    got, jcfg = jtrain.load_checkpoint(w["port"])
    _assert_same_tree(dict(got), w["want"])
    assert jcfg == w["jcfg"]
    if name != "resnet640":
        assert got["batch_stats"] == {} == w["want"]["batch_stats"]
    else:
        assert len(jax.tree_util.tree_leaves(got)) == 118
    assert w["cfg"] == NetParams(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("name", NETS)
def test_metadata_and_netcfg_equal_jax(written, name):
    """_METADATA (key paths, value types, the top-level fields) and the
    .netcfg.json text equal what JAX's save_checkpoint writes for the same
    numpy variables; the directory holds what orbax needs and no more."""
    w = written[name]
    with open(os.path.join(w["port"], "_METADATA")) as f:
        got = json.load(f)
    with open(os.path.join(w["jax"], "_METADATA")) as f:
        want = json.load(f)
    assert list(got["tree_metadata"]) == list(want["tree_metadata"])
    assert got == want
    with open(w["port"] + ".netcfg.json") as fa, \
            open(w["jax"] + ".netcfg.json") as fb:
        assert fa.read() == fb.read()
    assert sorted(os.listdir(w["port"])) == [
        "_CHECKPOINT_METADATA", "_METADATA", "d", "manifest.ocdbt"]
    with open(os.path.join(w["port"], "_CHECKPOINT_METADATA")) as fa, \
            open(os.path.join(w["jax"], "_CHECKPOINT_METADATA")) as fb:
        a, b = json.load(fa), json.load(fb)
    assert a.keys() == b.keys()
    assert a["item_handlers"] == b["item_handlers"]
    assert a["init_timestamp_nsecs"] <= a["commit_timestamp_nsecs"]


@pytest.mark.parametrize("name", NETS)
def test_standard_checkpointer_restores(written, name):
    w = written[name]
    with ocp.StandardCheckpointer() as ck:
        got = ck.restore(w["port"])
    _assert_same_tree(dict(got["variables"]), w["want"])


@pytest.mark.parametrize("name", NETS)
def test_tensorstore_reads_the_store(written, name):
    """tensorstore's ocdbt driver lists the keys of the port's store and
    reads their bytes as the port's reader does, and its zarr driver reads
    the first and the last array as JAX restores them."""
    w = written[name]
    base = f"file://{w['port']}"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": base}).result()
    keys = kv.list().result()
    store = ocdbt.OcdbtStore(w["port"])
    assert sorted(keys) == store.list()
    for k in keys:
        assert kv.read(k).result().value == store.read(k), k
    leaves = jax.tree_util.tree_leaves_with_path(w["want"])
    for path, want in (leaves[0], leaves[-1]):
        name_ = ".".join(["variables"] + [p.key for p in path])
        arr = ts.open({"driver": "zarr", "kvstore": {
            "driver": "ocdbt", "base": base, "path": name_ + "/"}}).result()
        got = arr.read().result()
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("name", NETS)
def test_port_restore_roundtrips(written, name):
    """The port reads back what it wrote: io/orbax.restore gives
    weights.to_flax of the state_dict, and train.load_checkpoint the
    state_dict, bit for bit."""
    w = written[name]
    _assert_same_tree(orbax.restore(w["port"]),
                      weights.to_flax(w["sd"], w["cfg"]))
    sd, cfg = train.load_checkpoint(w["port"])
    assert cfg == w["cfg"] and sorted(sd) == sorted(w["sd"])
    for k, v in w["sd"].items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k


@pytest.mark.parametrize("cfg", SMALL_CFGS,
                         ids=["smallconv", "conv1d", "resnet18",
                              "resnet18-conv1d"])
def test_to_flax_inverts_from_flax(cfg):
    """to_flax(from_flax(v)) is JAX's init tree v (the key set of
    planner_net.create(cfg).init, batch_stats empty without BatchNorm),
    and from_flax(to_flax(sd)) the port's state_dict, bit for bit; a
    num_batches_tracked entry is dropped and an unknown key refused."""
    v = _init_variables(cfg, 2)
    np_cfg = NetParams(**cfg)
    _assert_same_tree(weights.to_flax(weights.from_flax(v), np_cfg), v)
    sd = {k: torch.randn(t.shape, generator=torch.Generator().manual_seed(i))
          for i, (k, t) in enumerate(PlannerNet(np_cfg).state_dict()
                                     .items())}
    extra = dict(sd)
    if cfg["backbone"] == "resnet18":
        extra["img_backbone.bn_0.num_batches_tracked"] = torch.tensor(3)
    back = weights.from_flax(weights.to_flax(extra, np_cfg))
    assert sorted(back) == sorted(sd)
    for k, t in sd.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k
    with pytest.raises(ValueError, match="does not hold"):
        weights.to_flax(dict(sd, **{"extra.weight": torch.zeros(1)}),
                        np_cfg)


def test_general_tree_against_orbax(tmp_path):
    """save_tree of a pytree with every dtype the reader takes, a scalar,
    a zero-size array, big-endian data and an empty dict: orbax's numpy
    restore and the port's restore_tree both give it back."""
    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
            "b": {"x": np.full(3, 1.5), "y": np.array(True)}, "c": {},
            "d": np.full((2, 2), 7, np.uint8), "e": np.float32(3.0),
            "f": {"g": np.arange(5, dtype=">i8"),
                  "h": np.linspace(-1, 1, 4).astype(np.float16)},
            "i": np.array([-3, 4], np.int8), "j": np.arange(3, dtype=np.uint64),
            "k": np.zeros((0, 3), np.float32),
            "l": np.array([1, 2], np.int16), "m": np.array([9], np.uint16),
            "n": np.array([7], np.uint32)}
    path = str(tmp_path / "tree")
    orbax.save_tree(path, tree)
    want = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype=np.asarray(
        a).dtype.newbyteorder("<")), tree)
    with ocp.PyTreeCheckpointer() as ck:
        meta = ck.metadata(path).item_metadata
        got = ck.restore(path, restore_args=jax.tree_util.tree_map(
            lambda _: ocp.RestoreArgs(restore_type=np.ndarray), meta))
    for restored in (got, orbax.restore_tree(path)):
        assert restored["c"] == {}
        _assert_same_tree(restored, want)


@pytest.mark.parametrize("dtype", ["<c8", "<U3", "<M8[s]", "O",
                                   "bfloat16"])
def test_unsupported_dtype_raises(tmp_path, dtype):
    """A dtype that the reader does not take is refused before anything
    is written."""
    if dtype == "bfloat16":
        import ml_dtypes
        a = np.zeros(2, ml_dtypes.bfloat16)
    else:
        a = np.zeros(2, np.dtype(dtype))
    path = tmp_path / "bad"
    with pytest.raises(ValueError, match="dtype"):
        orbax.save_tree(path, {"ok": np.zeros(2, np.float32), "x": a})
    assert os.listdir(tmp_path) == []


def test_save_replaces_what_is_there(tmp_path):
    """An existing checkpoint directory, or a file, at the path is
    replaced (JAX's force=True), and no temporary directory is left."""
    path = tmp_path / "ckpt"
    orbax.save_tree(path, {"a": np.zeros(3, np.float32), "old": {}})
    orbax.save_tree(path, {"a": np.ones(2, np.int32)})
    got = orbax.restore_tree(path)
    assert list(got) == ["a"] and np.array_equal(got["a"], [1, 1])
    (tmp_path / "file").write_bytes(b"a torch.save file")
    orbax.save_tree(tmp_path / "file", {"b": np.zeros(1, np.uint8)})
    assert list(orbax.restore_tree(tmp_path / "file")) == ["b"]
    assert sorted(os.listdir(tmp_path)) == ["ckpt", "file"]


def test_leaves_other_than_arrays_raise(tmp_path):
    for tree, err in (({"a": [np.zeros(2)]}, TypeError),
                      ({1: np.zeros(2)}, TypeError),
                      (np.zeros(2), ValueError)):
        with pytest.raises(err):
            orbax.save_tree(tmp_path / "x", tree)


def test_written_store_layout(tmp_path):
    """write_store's layout: one generation, one leaf node at height 0, one
    data file, tensorstore's default limits; tensorstore lists and reads
    it, the empty store included; a node past the limit raises."""
    rng = np.random.default_rng(3)
    items = {b"variables.params.layer_%03d/0.0" % i:
             rng.bytes(int(rng.integers(0, 400))) for i in range(130)}
    items[b"a"] = b""
    ocdbt.write_store(tmp_path / "s", items)
    store = ocdbt.OcdbtStore(tmp_path / "s")
    assert store.generation == 1 and store._root[1] == 0
    assert os.listdir(tmp_path / "s" / "d") == [
        os.path.basename(store._root[0][0])]
    c = store.config
    assert (c.max_inline_value_bytes, c.max_decoded_node_bytes,
            c.version_tree_arity_log2, c.compression) == \
        ocdbt.WRITE_LIMITS + ("none",)
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{tmp_path / 's'}"}).result()
    assert {k: kv.read(k).result().value for k in kv.list().result()} \
        == items
    ocdbt.write_store(tmp_path / "e", {})
    assert ocdbt.OcdbtStore(tmp_path / "e").list() == []
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{tmp_path / 'e'}"}).result()
    assert kv.list().result() == []
    with pytest.raises(ValueError, match="above the store's"):
        ocdbt.write_store(tmp_path / "big",
                          {b"k" * (ocdbt.WRITE_LIMITS[1] + 1): b"v"})
