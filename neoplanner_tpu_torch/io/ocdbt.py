"""The OCDBT key-value store: the format in which orbax writes the JAX
package's checkpoints (tensorstore's B-tree database, "ocdbt"), read in
any layout that tensorstore writes and written in one.

A store is a directory. Its ``manifest.ocdbt`` holds the configuration and
the versions of the tree; each version names the root of a B-tree whose
nodes and out-of-line values live in data files (``d/<name>``, possibly
under another store's directory: orbax's top-level store points into
``ocdbt.process_0/d/``). Every manifest and node is

    magic (u32, big-endian: 0x0cdb3a2a manifest, 0x0cdb20de node)
    length (u64 little-endian: the whole record, these fields included)
    format version (varint, 0) and compression (varint: 0 none, 1 zstd)
    body (zstd-compressed when compression is 1)
    CRC-32C of everything before it (u32 little-endian)

and the integers in a body are LEB128 varints unless stated. Lists are
stored column by column. The pieces, as this reader takes them:

    config        uuid (16 bytes), manifest kind (0: the single
                  manifest.ocdbt), max inline value bytes, max decoded node
                  bytes, version tree arity log2 (u8), compression (0 none;
                  1 zstd, then its level as an i32)
    file table    count; the shared prefix with the previous path (count - 1
                  of them); the suffix lengths; the base path lengths; the
                  suffixes. A path is base path + relative path under the
                  store's directory
    manifest      config, file table, versions (count; generation, root
                  height (u8), file, offset, length, keys, tree bytes,
                  indirect value bytes, commit time (u64)), then the
                  references to version tree nodes (count; generation, file,
                  offset, length, generations, commit time (u64), height
                  (u8)). The newest version is the latest inline one. An
                  empty tree has the length 2^64 - 1
    node          height (u8), file table, entry count, keys prefix
                  compressed (the shared prefix with the previous key, count
                  - 1 of them; the suffix lengths; in an interior node the
                  length of each child's common key prefix; the suffixes).
                  A leaf then gives value lengths, kinds (u8: 0 inline, 1 in
                  a data file), the file and offset of each out-of-line
                  value, and the inline values. An interior node gives each
                  child's file, offset, length, keys, tree bytes and
                  indirect value bytes. A child's keys omit the common
                  prefix its parent names.

Corrupt input raises ValueError: a bad magic, length, version, checksum or
compression, a body that is not consumed exactly, or a tree whose key count
differs from its version's.

``write_store`` writes a new store in the simplest layout of these pieces:
one generation (1) with one version, in a kind-0 ``manifest.ocdbt`` with
no version tree nodes; every value out of line in one data file
``d/<32 hex>``, followed there by one leaf node (root height 0) that holds
every key, sorted and prefix compressed. The records are uncompressed, and
the config is a random uuid and tensorstore's default limits
(``WRITE_LIMITS``) with compression none. A node past
max_decoded_node_bytes raises ValueError.
"""

from __future__ import annotations

import os
import struct
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

from neoplanner_tpu_torch.io import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_EMPTY = (1 << 64) - 1
# what tensorstore writes when a store is opened with default settings:
# max inline value bytes, max decoded node bytes, version tree arity log2
WRITE_LIMITS = (100, 8 << 20, 4)


def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of data, table-driven."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    """A cursor over a body: varints, bytes, columns."""

    def __init__(self, data: bytes, what: str):
        self.d, self.i, self.what = data, 0, what

    def fail(self, msg: str):
        raise ValueError(f"ocdbt {self.what}: {msg}")

    def byte(self) -> int:
        if self.i >= len(self.d):
            self.fail("truncated")
        self.i += 1
        return self.d[self.i - 1]

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            b = self.byte()
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 63:
                self.fail("a varint longer than 64 bits")

    def take(self, n: int) -> bytes:
        if self.i + n > len(self.d):
            self.fail("truncated")
        self.i += n
        return self.d[self.i - n:self.i]

    def col(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u64s(self, n: int) -> List[int]:
        return [struct.unpack("<Q", self.take(8))[0] for _ in range(n)]

    def end(self):
        if self.i != len(self.d):
            self.fail(f"{len(self.d) - self.i} bytes after the body")

    def prefixed(self, n: int, extra_column: bool = False):
        """n byte strings prefix compressed against the previous one (and a
        column between the lengths and the bytes when extra_column: a
        node's common prefix lengths, a file table's base path lengths)."""
        shared = [0] + self.col(max(n - 1, 0))
        suffix = self.col(n)
        extra = self.col(n) if extra_column else None
        out, prev = [], b""
        for k in range(n):
            if shared[k] > len(prev):
                self.fail("a prefix longer than the previous entry")
            prev = prev[:shared[k]] + self.take(suffix[k])
            out.append(prev)
        return out, extra


class _Writer:
    """A body being built, in the layout that _Reader takes apart."""

    def __init__(self):
        self.d = bytearray()

    def byte(self, v: int):
        self.d.append(v)

    def varint(self, v: int):
        while v >= 0x80:
            self.d.append(v & 0x7F | 0x80)
            v >>= 7
        self.d.append(v)

    def col(self, values):
        for v in values:
            self.varint(v)

    def u64s(self, values):
        for v in values:
            self.d += struct.pack("<Q", v)

    def prefixed(self, items: List[bytes], extra=None):
        """_Reader.prefixed's layout of items, each prefix compressed
        against the previous one."""
        shared = [len(os.path.commonprefix([a, b]))
                  for a, b in zip(items, items[1:])]
        self.col(shared)
        self.col(len(k) - n for k, n in zip(items, [0] + shared))
        if extra is not None:
            self.col(extra)
        for k, n in zip(items, [0] + shared):
            self.d += k[n:]


def _write_file_table(w: _Writer, paths: List[str]):
    w.varint(len(paths))
    w.prefixed([p.encode() for p in paths], extra=[0] * len(paths))


def _wrap(body: bytes, magic: int) -> bytes:
    """The record of an uncompressed body: the inverse of _unwrap."""
    n = 4 + 8 + 2 + len(body) + 4
    raw = struct.pack(">I", magic) + struct.pack("<Q", n) + b"\0\0" + body
    return raw + struct.pack("<I", crc32c(raw))


def _file_table(r: _Reader) -> List[str]:
    paths, base = r.prefixed(r.varint(), extra_column=True)
    out = []
    for p, b in zip(paths, base):
        if b > len(p):
            r.fail("a base path longer than its path")
        path = p.decode()
        if path.startswith("/") or ".." in path.split("/"):
            r.fail(f"a data file outside the store: {path!r}")
        out.append(path)
    return out


def _unwrap(raw: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node record, its header and CRC checked."""
    if len(raw) < 4 + 8 + 2 + 4:
        raise ValueError(f"ocdbt {what}: {len(raw)} bytes is too short")
    got_magic, length = struct.unpack(">I", raw[:4])[0], \
        struct.unpack("<Q", raw[4:12])[0]
    if got_magic != magic:
        raise ValueError(f"ocdbt {what}: magic {got_magic:#010x}, expected "
                         f"{magic:#010x}")
    if length != len(raw):
        raise ValueError(f"ocdbt {what}: length field {length} for "
                         f"{len(raw)} bytes")
    want = struct.unpack("<I", raw[-4:])[0]
    if crc32c(raw[:-4]) != want:
        raise ValueError(f"ocdbt {what}: CRC-32C mismatch")
    r = _Reader(raw[:-4], what)
    r.i = 12
    version = r.varint()
    if version != 0:
        raise ValueError(f"ocdbt {what}: format version {version}")
    comp = r.varint()
    body = raw[r.i:-4]
    if comp == 0:
        return body
    if comp == 1:
        return zstd.decompress(body)
    raise ValueError(f"ocdbt {what}: compression format {comp}")


class Config:
    """A store's configuration, as its manifest gives it."""

    def __init__(self, r: _Reader):
        self.uuid = r.take(16)
        self.manifest_kind = r.varint()
        self.max_inline_value_bytes = r.varint()
        self.max_decoded_node_bytes = r.varint()
        self.version_tree_arity_log2 = r.byte()
        method = r.varint()
        if method == 0:
            self.compression, self.zstd_level = "none", None
        elif method == 1:
            self.compression = "zstd"
            self.zstd_level = struct.unpack("<i", r.take(4))[0]
        else:
            r.fail(f"compression method {method}")


_Ref = Tuple[str, int, int]           # (data file, offset, length)
_Value = Union[bytes, _Ref]           # inline bytes or where they lie


class OcdbtStore:
    """The newest version of the OCDBT store at path (a directory),
    read-only. list() gives its keys in order, read(key) a value."""

    def __init__(self, path):
        self.root = Path(path)
        body = _unwrap((self.root / "manifest.ocdbt").read_bytes(),
                       MANIFEST_MAGIC, "manifest")
        r = _Reader(body, "manifest")
        self.config = Config(r)
        if self.config.manifest_kind != 0:
            r.fail(f"manifest kind {self.config.manifest_kind} (only the "
                   f"single manifest.ocdbt is read)")
        files = _file_table(r)
        n = r.varint()
        gen = r.col(n)
        height = list(r.take(n))
        fid, off, length = r.col(n), r.col(n), r.col(n)
        keys, _tree, _ind = r.col(n), r.col(n), r.col(n)
        r.u64s(n)                                    # commit times
        m = r.varint()                               # version tree nodes
        for _ in range(5):
            r.col(m)
        r.u64s(m)
        r.take(m)
        r.end()
        if n == 0:
            r.fail("no inline version")
        k = max(range(n), key=lambda j: gen[j])
        self.generation = gen[k]
        self.num_keys = keys[k]
        if length[k] == _EMPTY or keys[k] == 0:
            self._root = None
        else:
            if fid[k] >= len(files):
                r.fail(f"data file {fid[k]} of {len(files)}")
            self._root = ((files[fid[k]], off[k], length[k]), height[k])
        self._index: Optional[Dict[bytes, _Value]] = None

    def _read_file(self, ref: _Ref) -> bytes:
        path, off, n = ref
        with open(self.root / path, "rb") as f:
            f.seek(off)
            data = f.read(n)
        if len(data) != n:
            raise ValueError(f"ocdbt: {path} ends before {off} + {n}")
        return data

    def _walk(self, ref: _Ref, height: int, prefix: bytes,
              out: Dict[bytes, _Value]) -> None:
        what = f"node {ref[0]}@{ref[1]}"
        body = _unwrap(self._read_file(ref), NODE_MAGIC, what)
        if len(body) > self.config.max_decoded_node_bytes:
            raise ValueError(f"ocdbt {what}: {len(body)} decoded bytes, "
                             f"above the store's "
                             f"{self.config.max_decoded_node_bytes}")
        r = _Reader(body, what)
        if r.byte() != height:
            r.fail(f"height other than the {height} its parent gives")
        files = _file_table(r)
        n = r.varint()
        keys, common = r.prefixed(n, extra_column=height > 0)

        def where(j: int) -> str:
            if j >= len(files):
                r.fail(f"data file {j} of {len(files)}")
            return files[j]

        if height == 0:
            lens = r.col(n)
            kinds = list(r.take(n))
            if any(k > 1 for k in kinds):
                r.fail(f"value kind {max(kinds)}")
            ind = [j for j in range(n) if kinds[j] == 1]
            fid, off = r.col(len(ind)), r.col(len(ind))
            for j in range(n):
                if kinds[j] == 0:
                    out[prefix + keys[j]] = r.take(lens[j])
            for j, f, o in zip(ind, fid, off):
                out[prefix + keys[j]] = (where(f), o, lens[j])
            r.end()
            return
        fid, off, length = r.col(n), r.col(n), r.col(n)
        for _ in range(3):                 # keys, tree and value bytes
            r.col(n)
        r.end()
        for j in range(n):
            if common[j] > len(keys[j]):
                r.fail("a common prefix longer than its key")
            self._walk((where(fid[j]), off[j], length[j]), height - 1,
                       prefix + keys[j][:common[j]], out)

    def _entries(self) -> Dict[bytes, _Value]:
        if self._index is None:
            index: Dict[bytes, _Value] = {}
            if self._root is not None:
                self._walk(*self._root, b"", index)
            if len(index) != self.num_keys:
                raise ValueError(f"ocdbt: {len(index)} keys in the tree, "
                                 f"its version counts {self.num_keys}")
            self._index = index
        return self._index

    def list(self) -> List[bytes]:
        """Every key of the newest version, sorted."""
        return sorted(self._entries())

    def read(self, key) -> bytes:
        """The value of key (bytes or str); KeyError when it is absent."""
        if isinstance(key, str):
            key = key.encode()
        v = self._entries()[key]
        return v if isinstance(v, bytes) else self._read_file(v)


def write_store(path, items: Dict[bytes, bytes]) -> None:
    """A new OCDBT store at path (a directory, made if missing) that holds
    items, in the layout the module docstring gives; the files it would
    write must not exist yet."""
    root = Path(path)
    keys = sorted(items)
    inline, node_bytes, arity = WRITE_LIMITS
    w = _Writer()                                    # the manifest's body
    w.d += os.urandom(16)
    w.col((0, inline, node_bytes))
    w.byte(arity)
    w.varint(0)                                      # compression: none
    if not keys:
        _write_file_table(w, [""])
        w.varint(1)
        w.col((1,))
        w.byte(0)
        w.col((0, _EMPTY, _EMPTY, 0, 0, 0))
    else:
        data = f"d/{os.urandom(16).hex()}"
        node = _Writer()
        node.byte(0)                                 # height: a leaf
        _write_file_table(node, [data])
        node.varint(len(keys))
        node.prefixed(keys)
        node.col(len(items[k]) for k in keys)
        node.d += bytes([1]) * len(keys)             # every value indirect
        node.col([0] * len(keys))
        offsets, off = [], 0
        for k in keys:
            offsets.append(off)
            off += len(items[k])
        node.col(offsets)
        if len(node.d) > node_bytes:
            raise ValueError(f"ocdbt: a node of {len(node.d)} bytes for "
                             f"{len(keys)} keys, above the store's "
                             f"{node_bytes}")
        record = _wrap(bytes(node.d), NODE_MAGIC)
        (root / "d").mkdir(parents=True, exist_ok=True)
        with open(root / data, "xb") as f:
            for k in keys:
                f.write(items[k])
            f.write(record)
        _write_file_table(w, [data])
        w.varint(1)
        w.col((1,))                                  # generation
        w.byte(0)                                    # root height
        w.col((0, off, len(record), len(keys), len(record), off))
    w.u64s((time.time_ns(),))                        # commit time
    w.varint(0)                                      # no version tree nodes
    root.mkdir(parents=True, exist_ok=True)
    with open(root / "manifest.ocdbt", "xb") as f:
        f.write(_wrap(bytes(w.d), MANIFEST_MAGIC))
