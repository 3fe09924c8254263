"""Build and load the port's CUDA kernels: one ``nvcc`` call, ``ctypes``.

Every ``csrc/*.cu`` file exposes a plain C entry point (pointers, ints and the
stream; no PyTorch headers), so all of them compile in one
``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` call in seconds. The
library lands in ``neoplanner_tpu_torch/_build/`` under a name keyed by a hash
of the sources and flags, is built at first use, and is loaded with
``ctypes``. Each C entry returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on anything but 0.

``launches`` counts kernel launches by name. Each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that the main path
went through every kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "--threads", "4"]

KERNELS = ("minco_banded_solve", "lbfgs_scene_solve", "track_segment",
           "render_depth", "lbfgs_grid_solve", "fuse_depth_dense",
           "edt_trunc_lite", "track_segment_grid")
launches = {name: 0 for name in KERNELS}
build_seconds = None   # wall time of the nvcc call (None: loaded from cache)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: argument types in order (all return cudaError_t as int)
_SIGNATURES = {
    # aug, out, n_problems, lower_bw, stream
    "neo_minco_banded_solve": [_P, _P, _I, _I, _P],
    # x0, head, tail, prims, env_of, skip, x_out, f_out, it_out,
    # n_problems, n_prims, K, max_iters, max_ls, host params (float*), stream
    "neo_lbfgs_scene_solve": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _P, _P],
    # cmds, state, prims, state_out, trace, n_envs, n_prims, spr,
    # host params (float*), stream
    "neo_track_segment": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    # pos, quat, prims, depth, n_envs, n_prims, width, height,
    # host params [fx, fy, min_range, max_range] (float*), stream
    "neo_render_depth": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # x0, head, tail, win, worg, env_of, skip, x_out, f_out, it_out,
    # n_problems, Hw, Ww, K, max_iters, max_ls, host params (float*), stream
    "neo_lbfgs_grid_solve": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _P, _P],
    # logodds, tabs, sc, hit, out, n_envs, H, W, Wcam,
    # host params (float*), stream
    "neo_fuse_depth_dense": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # logodds, out, n_envs, H, W, R, host params [thr, res, max_dist], stream
    "neo_edt_trunc_lite": [_P, _P, _I, _I, _I, _I, _P, _P],
    # cmds, state, state_out, trace, ticks, n_envs, spr,
    # host params (float*), stream
    "neo_track_segment_grid": [_P, _P, _P, _P, _P, _I, _I, _P, _P],
}

_lib = None


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; CUDA unless the caller asks for
    the CPU (where every kernel wrapper takes its plain version)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions")
    return dev


def make_generator(seed: int, device="cuda") -> torch.Generator:
    """A seeded torch.Generator on the entry point's device."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return gen


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _sources():
    return sorted(_SRC.glob("*.cu")), sorted(_SRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _BUILD / f"libneoplanner_kernels_{h.hexdigest()[:16]}.so"


def load():
    """Build (first use) and load the kernel library; returns the CDLL."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need an NVIDIA GPU")
    so = library_path()
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        cu, _ = _sources()
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), *map(str, cu)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        build_seconds = time.perf_counter() - t0
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def require(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    """Validate a tensor handed to a kernel: device, dtype, shape, layout."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def host_floats(values):
    """Scalar float parameters as a host float array: the C entry copies
    them into the kernel's by-value parameter struct before it returns."""
    return (ctypes.c_float * len(values))(*[float(v) for v in values])
