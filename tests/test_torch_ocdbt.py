"""The port's OCDBT reader (neoplanner_tpu_torch/io/ocdbt.py) against
tensorstore's own OCDBT store: the key lists and values of both committed
orbax checkpoints (copies under tmp_path) and of stores that tensorstore
writes here: hundreds of keys under small node limits (interior nodes,
keys prefix compressed under long common prefixes), inline and indirect
values, uncompressed and zstd nodes, several commits (the latest read,
deleted keys gone), and a version tree past the manifest's inline
versions. A corrupt CRC, body, magic or length of the manifest or of the
newest version's root node raises ValueError, a missing key KeyError."""

import os
import shutil

import numpy as np
import pytest
import tensorstore as ts

from neoplanner_tpu_torch.io import ocdbt
from tests.test_torch_imports import one_torch_thread  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARTIFACTS = ("planner_net_smallconv", "planner_net_resnet640")


def _ts_store(path):
    return ts.KvStore.open({"driver": "ocdbt",
                            "base": f"file://{path}"}).result()


def _ts_contents(path):
    kv = _ts_store(path)
    return {k: kv.read(k).result().value for k in kv.list().result()}


def _check(path):
    want = _ts_contents(path)
    store = ocdbt.OcdbtStore(path)
    assert store.list() == sorted(want)
    for k, v in want.items():
        assert store.read(k) == v, k
    return store


@pytest.mark.parametrize("name", ARTIFACTS)
def test_checkpoint_store_matches_tensorstore(tmp_path, name):
    path = tmp_path / name
    shutil.copytree(os.path.join(ROOT, "artifacts", name), path)
    store = _check(path)
    keys = store.list()
    assert len(keys) == {"planner_net_smallconv": 52,
                         "planner_net_resnet640": 236}[name]
    assert store.config.compression == "zstd"
    assert store.read(keys[0].decode()) == store.read(keys[0])
    with pytest.raises(KeyError):
        store.read(b"no/such/key")


def _write(path, config, commits):
    """A store at path with config, written by tensorstore in one
    transaction per commit: commits is a list of {key: value or None}."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}",
                          "config": config}).result()
    for commit in commits:
        txn = ts.Transaction()
        for k, v in commit.items():            # None deletes k
            kv.with_transaction(txn).write(k, v).result()
        txn.commit_async().result()


def _keys(n, rng, prefix=b"variables/params/img_backbone/"):
    return {prefix + b"layer_%04d/kernel" % i:
            rng.bytes(int(rng.integers(0, 300))) for i in range(n)}


@pytest.mark.parametrize("compression", [None, {"id": "zstd", "level": 3}],
                         ids=["uncompressed", "zstd"])
@pytest.mark.parametrize("node_bytes", [256, 4096])
def test_written_store_matches_tensorstore(tmp_path, compression,
                                           node_bytes):
    """400 keys under one long prefix, values of 0-299 bytes, inline up to
    64 bytes; 256-byte nodes give a tree three or more levels deep."""
    rng = np.random.default_rng(node_bytes)
    _write(tmp_path, {"compression": compression,
                      "max_decoded_node_bytes": node_bytes,
                      "max_inline_value_bytes": 64},
           [_keys(400, rng)])
    store = _check(tmp_path)
    assert len(store.list()) == 400
    assert store.config.max_decoded_node_bytes == node_bytes
    assert store.config.compression == ("none" if compression is None
                                        else "zstd")
    height = store._root[1]
    assert height >= (2 if node_bytes == 256 else 0)


def test_two_commits_read_the_latest(tmp_path):
    rng = np.random.default_rng(1)
    first = _keys(200, rng)
    second = {k: (None if i % 3 == 0 else rng.bytes(100))
              for i, k in enumerate(sorted(first)[:120])}
    second[b"z/added"] = b"new value"
    _write(tmp_path, {"max_decoded_node_bytes": 512,
                      "max_inline_value_bytes": 32}, [first, second])
    store = _check(tmp_path)
    want = dict(first)
    for k, v in second.items():
        if v is None:
            want.pop(k)
        else:
            want[k] = v
    assert store.list() == sorted(want)
    assert store.read(b"z/added") == b"new value"
    gone = sorted(first)[0]
    with pytest.raises(KeyError):
        store.read(gone)


def test_many_commits_past_the_inline_versions(tmp_path):
    """Nine commits at version tree arity 2: the manifest refers to version
    tree nodes for the older versions; the newest is read."""
    commits = [{b"k%d" % i: b"v%d" % i} for i in range(9)]
    _write(tmp_path, {"version_tree_arity_log2": 1}, commits)
    store = _check(tmp_path)
    assert store.list() == [b"k%d" % i for i in range(9)]
    assert store.generation >= 9


def test_emptied_store(tmp_path):
    """A key written, then deleted: the newest version's tree is empty."""
    _write(tmp_path, {}, [{b"a": b"x"}, {b"a": None}])
    store = _check(tmp_path)
    assert store.list() == [] and store._root is None


@pytest.mark.parametrize("where", ["manifest", "node"])
@pytest.mark.parametrize("part", ["crc", "body", "magic", "length"])
def test_corruption_raises(tmp_path, where, part):
    """A flipped bit in the manifest, or in the root node of the newest
    version (which every read walks; tensorstore may commit one
    transaction in several generations, so a node found in the data files
    may belong to an older one that is never read), raises ValueError."""
    _write(tmp_path, {"compression": None, "max_decoded_node_bytes": 256},
           [_keys(60, np.random.default_rng(2))])
    if where == "manifest":
        path, off, n = str(tmp_path / "manifest.ocdbt"), 0, os.path.getsize(
            tmp_path / "manifest.ocdbt")
    else:
        (rel, off, n), _ = ocdbt.OcdbtStore(tmp_path)._root
        path = str(tmp_path / rel)
    data = bytearray(open(path, "rb").read())
    pos = {"crc": off + n - 2, "body": off + n // 2, "magic": off + 1,
           "length": off + 5}[part]
    data[pos] ^= 0x04
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError):
        ocdbt.OcdbtStore(tmp_path).list()


def test_crc32c_known_values():
    """CRC-32C check values (RFC 3720 B.4): 32 zero bytes, 32 bytes of
    0xff, and the ASCII digits."""
    assert ocdbt.crc32c(bytes(32)) == 0x8A9136AA
    assert ocdbt.crc32c(b"\xff" * 32) == 0x62A8AB43
    assert ocdbt.crc32c(b"123456789") == 0xE3069283
