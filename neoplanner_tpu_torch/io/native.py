"""The port's host C++ libraries (the octomap codec, the zstd decoder):
built at first use with ``g++ -O2 -std=c++17 -fPIC -shared`` into
``neoplanner_tpu_torch/_build/`` under a name keyed by a hash of the
source and the flags (as ``_cuda.py`` keys the CUDA libraries), and loaded
with ctypes. A failed build or load raises RuntimeError with the
compiler's or the loader's message; no prebuilt library is used."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

BUILD = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared"]


def library_path(src: Path, build_dir: Path, name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(src.read_bytes())
    return build_dir / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(src: Path, build_dir: Path, name: str, what: str) -> Path:
    """Build src's shared library unless it exists; returns its path.
    Concurrent builds each write a file of their own and rename it into
    place."""
    so = library_path(src, build_dir, name)
    if so.exists():
        return so
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, "-o", str(tmp), str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"cannot run g++ to build {what}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building {what}:"
                           f"\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def load(path: Path, what: str) -> ctypes.CDLL:
    try:
        return ctypes.CDLL(str(path))
    except OSError as exc:
        raise RuntimeError(f"cannot load {what} {path}: {exc}") from exc
