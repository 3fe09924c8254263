"""Build and load the port's CUDA kernels: ``nvcc`` by hand, ``ctypes``.

Every ``csrc/*.cu`` file exposes a plain C entry point (pointers, ints and the
stream; no PyTorch headers), so they compile with
``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` in seconds, into two
kinds of library: the kernels that do not depend on the trajectory's piece
count M in one (:func:`load`), and the five that do (B5, B1, B6, B2s, B7:
``_PIECE_SOURCES``) in one library per M in :data:`PIECES`, compiled with
``-DNEO_M=M`` (:func:`load_pieces`). Each library lands in
``neoplanner_tpu_torch/_build/`` under a name keyed by a hash of the sources
and flags (and M), is built at first use (:func:`prebuild` builds several
side by side, one ``nvcc`` process each), and is loaded with ``ctypes``.
Each C entry returns ``cudaGetLastError()`` after its launch; :func:`check`
raises on anything but 0.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "--threads", "4"]

KERNELS = ("minco_banded_solve", "lbfgs_scene_solve", "track_segment",
           "render_depth", "lbfgs_grid_solve", "fuse_depth_dense",
           "edt_trunc_lite", "track_segment_grid", "fuse_depth_multi",
           "edt_exact", "edt_banded", "fuse_depth_window",
           "objective_scene_fwd", "objective_scene_valgrad",
           "objective_grid_fwd", "objective_grid_valgrad")
launches = {name: 0 for name in KERNELS}
# nvcc wall seconds of each library this process built, by file name
build_seconds = {}

PIECES = range(2, 17)    # the piece counts M that have a kernel build
MAX_HISTORY = 32         # the solvers' L-BFGS history H, 1..32
# the sources built once per M (-DNEO_M): B5, B2s/B7, B1, B6
_PIECE_SOURCES = ("lbfgs_grid.cu", "lbfgs_scene.cu", "minco_solve.cu",
                  "objective_eval.cu")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: argument types in order (all return cudaError_t as int)
_SIGNATURES = {
    # cmds, state, prims, state_out, trace, n_envs, n_prims, spr, i0,
    # host params (float*), stream
    "neo_track_segment": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # pos, quat, prims, depth, n_poses, frames_per_env, n_prims, width,
    # out_rows, row_stride,
    # host params [fx, fy, min_range, max_range, height] (float*), stream
    "neo_render_depth": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    # logodds, tabs, sc, hit, out, n_envs, H, W, Wcam,
    # host params (float*), stream
    "neo_fuse_depth_dense": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # logodds, tabs, sc, hit, out, n_envs, n_frames, H, W, Wcam,
    # host params (float*), stream
    "neo_fuse_depth_multi": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    # logodds, out, n_envs, H, W, R, host params [thr, res, max_dist], stream
    "neo_edt_trunc_lite": [_P, _P, _I, _I, _I, _I, _P, _P],
    # grid, out, n_envs, H, W, R, host params [thr, res, max_dist], stream
    "neo_edt_banded": [_P, _P, _I, _I, _I, _I, _P, _P],
    # grid, out, n_envs, H, W, host params [thr, res, far], stream
    "neo_edt_exact": [_P, _P, _I, _I, _I, _P, _P],
    # logodds (in place), tabs, sc, org, hit, n_envs, H, W, ch, cw, Wcam,
    # host params (float*), stream
    "neo_fuse_depth_window": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _P, _P],
    # cmds, state, state_out, trace, ticks, n_envs, spr, i0,
    # host params (float*), stream
    "neo_track_segment_grid": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
}
# the entries of a piece count's library (n = 6M, nv = 3M - 2)
_PIECE_SIGNATURES = {
    # aug, out, n_problems, lower_bw, stream
    "neo_minco_banded_solve": [_P, _P, _I, _I, _P],
    # x0, head, tail, prims, env_of, skip, x_out, f_out, it_out,
    # n_problems, n_prims, K, max_iters, max_ls, history, host params
    # (float*), stream
    "neo_lbfgs_scene_solve": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _P, _P],
    # x0, head, tail, win, worg, env_of, skip, x_out, f_out, it_out,
    # n_problems, Hw, Ww, K, max_iters, max_ls, history, host params
    # (float*), stream
    "neo_lbfgs_grid_solve": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _P, _P],
    # x, head, tail, prims, env_of, f_out, g_out (null: value only),
    # n_problems, n_prims, K, host params (float*), stream
    "neo_objective_scene": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    # x, head, tail, win, worg, env_of, f_out, g_out (null: value only),
    # n_problems, Hw, Ww, K, host params (float*), stream
    "neo_objective_grid": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _P, _P],
}

_lib = None
_piece_libs = {}


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


def launches_since(before: dict) -> dict:
    """Each kernel's launches since before (a copy of launches), for the
    kernels launched only."""
    return {k: v - before[k] for k, v in launches.items() if v != before[k]}


def synchronize(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def check_pieces(num_pieces: int, what: str) -> None:
    """Raise unless M has a kernel build (:data:`PIECES`)."""
    if num_pieces not in PIECES:
        raise ValueError(f"{what} is built for M in {PIECES.start}.."
                         f"{PIECES.stop - 1} pieces; got M={num_pieces}")


def _sources(pieces=None):
    """The .cu files of a library (the piece count's when pieces is an
    int, else the others) and every header."""
    cu = [p for p in sorted(_SRC.glob("*.cu"))
          if (p.name in _PIECE_SOURCES) == (pieces is not None)]
    return cu, sorted(_SRC.glob("*.cuh"))


def _flags(pieces=None):
    return _FLAGS + ([] if pieces is None else [f"-DNEO_M={pieces}"])


def library_path(pieces=None) -> Path:
    cu, cuh = _sources(pieces)
    h = hashlib.sha256(" ".join(_flags(pieces)).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    stem = ("libneoplanner_kernels" if pieces is None
            else f"libneoplanner_m{pieces}")
    return _BUILD / f"{stem}_{h.hexdigest()[:16]}.so"


def build(pieces=None) -> Path:
    """Build the main library (or the piece count's, pieces = M) unless it
    exists; records the nvcc wall time in build_seconds."""
    so = library_path(pieces)
    if so.exists():
        return so
    _BUILD.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources(pieces)
    tmp = so.with_suffix(f".{os.getpid()}.{pieces}.tmp")
    cmd = [_nvcc(), *_flags(pieces), "-o", str(tmp), *map(str, cu)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    build_seconds[so.name] = time.perf_counter() - t0
    os.replace(tmp, so)
    return so


def prebuild(pieces=()) -> float:
    """Build the main library and those of the piece counts in pieces side
    by side, one nvcc process each; returns the wall seconds."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need an NVIDIA GPU")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1 + len(pieces)) as pool:
        for job in [pool.submit(build, m) for m in (None, *pieces)]:
            job.result()
    return time.perf_counter() - t0


def _load(pieces=None):
    """Build (first use) and load the main library (or the piece count's,
    pieces = M), its entries' argument types set; returns the CDLL."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need an NVIDIA GPU")
    lib = ctypes.CDLL(str(build(pieces)))
    table = _SIGNATURES if pieces is None else _PIECE_SIGNATURES
    for name, argtypes in table.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load():
    """Build (first use) and load the library of the kernels that do not
    depend on M; returns the CDLL."""
    global _lib
    if _lib is None:
        _lib = _load()
    return _lib


def load_pieces(num_pieces: int):
    """Build (first use) and load the library of B5, B1, B6, B2s and B7 for
    num_pieces = M pieces; returns the CDLL."""
    check_pieces(num_pieces, "the CUDA kernel library")
    if num_pieces not in _piece_libs:
        _piece_libs[num_pieces] = _load(num_pieces)
    return _piece_libs[num_pieces]


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
