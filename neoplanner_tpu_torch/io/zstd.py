"""A Zstandard (RFC 8878) decoder, bound with ctypes.

The orbax checkpoints of the JAX package store each array as a zarr chunk
compressed with zstd, in an OCDBT key-value store whose nodes are zstd
compressed too (io/ocdbt.py, io/orbax.py). The port reads them with its
own decoder, ``zstd_cc/zstd_decode.cc`` (decode only): concatenated and
skippable frames, every block, literals and sequences mode, and the xxh64
content checksum, verified when the frame carries one. It is built by g++
at first use (io/native.py), as the octomap codec is.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

from neoplanner_tpu_torch.io import native

_SRC = Path(__file__).resolve().parent / "zstd_cc" / "zstd_decode.cc"
_lib = None


def build() -> Path:
    """Build the decoder's shared library unless it exists; returns its
    path."""
    return native.build(_SRC, native.BUILD, "zstd_decode",
                        "the zstd decoder")


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = native.load(build(), "the zstd decoder")
    lib.zstd_decompress.restype = ctypes.c_int
    lib.zstd_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_char_p, ctypes.c_size_t]
    lib.zstd_free.argtypes = [ctypes.c_void_p]
    lib.zstd_num_branches.restype = ctypes.c_int
    lib.zstd_branch_name.restype = ctypes.c_char_p
    lib.zstd_branch_name.argtypes = [ctypes.c_int]
    lib.zstd_branch_counts.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int]
    _lib = lib
    return lib


def decompress(data: bytes, size: Optional[int] = None) -> bytes:
    """The content of every zstd frame in data, in order (skippable frames
    give nothing). With size, the content must be exactly size bytes.
    Raises ValueError on a frame that names a dictionary, a reserved bit,
    a checksum or content size that does not match, any stream that does
    not decode exactly, or content of another size than size."""
    lib = _load()
    data = bytes(data)
    out = ctypes.c_void_p()
    n = ctypes.c_size_t(0)
    err = ctypes.create_string_buffer(256)
    rc = lib.zstd_decompress(data, len(data), -1 if size is None else size,
                             ctypes.byref(out), ctypes.byref(n), err,
                             len(err))
    if rc != 0:
        raise ValueError(f"zstd: {err.value.decode()}")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.zstd_free(out)


def branch_counts(reset: bool = False) -> dict:
    """How often each part of the format was decoded since the last reset
    (block types, literals and table modes, Huffman weight headers, repeat
    offsets, frame flags...): {name: count}. A diagnostic for tests."""
    lib = _load()
    n = lib.zstd_num_branches()
    out = (ctypes.c_uint64 * n)()
    lib.zstd_branch_counts(out, n, int(reset))
    return {lib.zstd_branch_name(i).decode(): int(out[i]) for i in range(n)}
