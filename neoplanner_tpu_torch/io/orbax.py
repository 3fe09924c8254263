"""Orbax checkpoints without orbax: the JAX package's saved nets as numpy.

The JAX package saves a PlannerNet with orbax's StandardCheckpointer
(neoplanner_tpu/learn/train.py:137 ``save_checkpoint``) and restores it as
numpy (``load_checkpoint`` :152). Such a checkpoint is a directory:

- ``_METADATA`` (JSON): ``tree_metadata`` maps each leaf of the saved
  pytree to its key path (``key_metadata``: dict keys, key_type 2) and its
  value type (an array, or an empty dict / list / None, which holds no
  data); ``use_ocdbt`` and ``use_zarr3`` say how the arrays are stored;
- the arrays: one zarr v2 array per leaf, named by its key path joined
  with '.', whose ``<name>/.zarray`` (JSON) gives shape, chunks, dtype,
  order, fill value and compressor, and whose chunks lie at
  ``<name>/<i>.<j>...`` (``0`` for a scalar): keys of the OCDBT store at
  the checkpoint's root (io/ocdbt.py).

``restore_tree`` rebuilds the whole pytree from the key paths, never by
splitting names on '.'; ``restore`` gives its ``variables`` entry, the
``{'params', 'batch_stats'}`` dict that the JAX package's
``load_checkpoint(path)[0]`` returns. Chunks are decoded with io/zstd.py
(zarr's "zstd" compressor) or taken as they are (no compressor); a missing
chunk holds the fill value (0 when it is null). The dtypes are those the
JAX package's nets and orbax write: IEEE floats, signed and unsigned
integers and bool; any other raises ValueError naming it, as does a
checkpoint without OCDBT, with zarr v3 arrays or with sequence keys (the
JAX package writes none of them).
"""

from __future__ import annotations

import ast
import itertools
import json
import math
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from neoplanner_tpu_torch.io import ocdbt, zstd

_KEY_DICT = 2
_EMPTY_NODES = {"Dict": dict, "List": list, "Tuple": tuple,
                "None": lambda: None}
_KINDS = {"f": (2, 4, 8), "i": (1, 2, 4, 8), "u": (1, 2, 4, 8), "b": (1,)}


def _dtype(code: str) -> np.dtype:
    try:
        dt = np.dtype(code)
    except TypeError:
        dt = None
    if dt is None or dt.kind not in _KINDS or dt.itemsize not in _KINDS[
            dt.kind]:
        raise ValueError(f"orbax: zarr dtype {code!r} is not one the "
                         f"checkpoints hold (floats, integers, bool)")
    return dt


def _fill(value, dt: np.dtype):
    if value is None:
        return 0
    if isinstance(value, str):
        named = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if value not in named or dt.kind != "f":
            raise ValueError(f"orbax: fill value {value!r} for {dt}")
        return named[value]
    return value


def read_array(store, name: str, stats: Optional[dict] = None
               ) -> np.ndarray:
    """The zarr v2 array stored under name in store (read(key) -> bytes)."""
    meta = json.loads(store.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"orbax: {name} is zarr format "
                         f"{meta.get('zarr_format')}, not 2")
    if meta.get("filters"):
        raise ValueError(f"orbax: {name} has zarr filters {meta['filters']}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"orbax: {name} has compressor {comp.get('id')!r}")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise ValueError(f"orbax: {name} has order {order!r}")
    dt = _dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise ValueError(f"orbax: {name} chunks {chunks} for shape {shape}")
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill(meta.get("fill_value"), dt), dtype=dt)
    chunk_bytes = math.prod(chunks) * dt.itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        try:
            raw = store.read(key)
        except KeyError:
            continue                      # the fill value
        data = raw if comp is None else zstd.decompress(raw, chunk_bytes)
        if len(data) != chunk_bytes:
            raise ValueError(f"orbax: chunk {key} holds {len(data)} bytes, "
                             f"its shape {chunks} {chunk_bytes}")
        if stats is not None:
            stats["bytes_read"] = stats.get("bytes_read", 0) + len(raw)
            stats["bytes_decoded"] = stats.get("bytes_decoded", 0) + (
                len(data) if comp is not None else 0)
        chunk = np.frombuffer(data, dtype=dt).reshape(chunks, order=order)
        lo = [i * c for i, c in zip(idx, chunks)]
        sel = tuple(slice(a, min(a + c, s))
                    for a, c, s in zip(lo, chunks, shape))
        out[sel] = chunk[tuple(slice(0, s.stop - s.start) for s in sel)]
    return out


def _insert(tree: Dict, keys, value) -> None:
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def restore_tree(path, stats: Optional[dict] = None) -> Dict[str, Any]:
    """The whole pytree of the orbax checkpoint at path: nested dicts of
    numpy arrays. stats, when given, receives bytes_read (the
    chunks as stored), bytes_decoded (their zstd output) and arrays."""
    root = Path(path)
    meta = json.loads((root / "_METADATA").read_text())
    if meta.get("use_zarr3") or not meta.get("use_ocdbt"):
        raise ValueError(f"orbax: {path} is not zarr v2 in OCDBT "
                         f"(use_zarr3 {meta.get('use_zarr3')}, use_ocdbt "
                         f"{meta.get('use_ocdbt')})")
    store = ocdbt.OcdbtStore(root)
    tree: Dict = {}
    n = 0
    for label, leaf in meta["tree_metadata"].items():
        keys = []
        for km in leaf["key_metadata"]:
            if km["key_type"] != _KEY_DICT:
                raise ValueError(f"orbax: key type {km['key_type']} in "
                                 f"{label} (only dict keys are read)")
            keys.append(str(km["key"]))
        if not keys:
            raise ValueError(f"orbax: a leaf without a key path ({label})")
        if tuple(keys) != ast.literal_eval(label):
            raise ValueError(f"orbax: key path {keys} under {label}")
        vtype = leaf["value_metadata"]["value_type"]
        if vtype in _EMPTY_NODES:
            _insert(tree, keys, _EMPTY_NODES[vtype]())
            continue
        if leaf["value_metadata"].get("skip_deserialize"):
            raise ValueError(f"orbax: {label} ({vtype}) holds no array")
        _insert(tree, keys, read_array(store, ".".join(keys), stats))
        n += 1
    if stats is not None:
        stats["arrays"] = n
    return tree


def restore(path, stats: Optional[dict] = None) -> Dict[str, Any]:
    """The ``variables`` of a PlannerNet checkpoint saved by the JAX
    package (``{'params': ..., 'batch_stats': ...}`` of numpy arrays), as
    its ``train.load_checkpoint(path)[0]`` gives them."""
    tree = restore_tree(path, stats)
    if "variables" not in tree:
        raise ValueError(f"orbax: {path} holds {sorted(tree)}, not "
                         f"'variables'")
    return tree["variables"]
