"""The octomap ``.bt`` and PCL ``.pcd`` codec, bound with ctypes.

The port of neoplanner_tpu/io/octomap.py (``read_bt`` :55, ``bt_to_voxels``
:73, ``bt_to_grid`` :92, ``write_bt`` :111, ``read_pcd`` :124,
``write_pcd`` :137): it reads the reference's ground-truth map assets and
writes compatible files for generated worlds (the interchange that
plugin_build_octomap.cpp:104-146 produces). Host I/O: numpy in and out.

The codec is the package's own copy of the JAX package's C++ source,
``octomap_cc/octomap_codec.cc`` (byte for byte the same), built by g++ at
first use (io/native.py).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import numpy as np

from neoplanner_tpu_torch.io import native

_SRC = Path(__file__).resolve().parent / "octomap_cc" / "octomap_codec.cc"
_BUILD = native.BUILD
_lib = None


def library_path() -> Path:
    return native.library_path(_SRC, _BUILD, "octomap_codec")


def build() -> Path:
    """Build the codec's shared library unless it exists; returns its
    path."""
    return native.build(_SRC, _BUILD, "octomap_codec", "the octomap codec")


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = native.load(build(), "the octomap codec")
    lib.bt_read.restype = ctypes.c_void_p
    lib.bt_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_double)]
    lib.bt_get_leaves.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p]
    lib.bt_free.argtypes = [ctypes.c_void_p]
    lib.bt_write.restype = ctypes.c_int
    lib.bt_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int, ctypes.c_double,
                             ctypes.c_double, ctypes.c_double, ctypes.c_double]
    lib.pcd_read.restype = ctypes.c_void_p
    lib.pcd_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.pcd_get_points.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.pcd_free.argtypes = [ctypes.c_void_p]
    lib.pcd_write.restype = ctypes.c_int
    lib.pcd_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_int]
    _lib = lib
    return lib


def read_bt(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Read a .bt octree: (centers (N, 3) float32, half sizes (N,) float32,
    occupied (N,) bool, resolution). Leaves of every size are returned; an
    occupied leaf above the finest resolution covers several voxels."""
    lib = _load()
    n = ctypes.c_int(0)
    res = ctypes.c_double(0.0)
    h = lib.bt_read(path.encode(), ctypes.byref(n), ctypes.byref(res))
    if not h:
        raise IOError(f"failed to read octomap .bt file: {path}")
    centers = np.zeros((n.value, 3), dtype=np.float32)
    half = np.zeros(n.value, dtype=np.float32)
    occ = np.zeros(n.value, dtype=np.uint8)
    lib.bt_get_leaves(h, centers.ctypes.data, half.ctypes.data,
                      occ.ctypes.data)
    lib.bt_free(h)
    return centers, half, occ.astype(bool), res.value


def bt_to_voxels(path: str) -> Tuple[np.ndarray, float]:
    """The occupied voxel centers at the finest resolution, (M, 3) float32,
    and the resolution; coarse occupied leaves expand into their voxels."""
    centers, half, occ, res = read_bt(path)
    out = []
    for c, h in zip(centers[occ], half[occ]):
        k = max(int(round(2 * h / res)), 1)
        if k == 1:
            out.append(c[None, :])
        else:
            offs = (np.arange(k) + 0.5) * res - h
            gx, gy, gz = np.meshgrid(offs, offs, offs, indexing="ij")
            grid = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
            out.append(c[None, :] + grid)
    if not out:
        return np.zeros((0, 3), np.float32), res
    return np.concatenate(out).astype(np.float32), res


def bt_to_grid(path: str, origin, shape, res_override=None
               ) -> Tuple[np.ndarray, float]:
    """Rasterize a .bt file into a dense (Z, H, W) float32 {0, 1} grid
    whose corner is the world point origin (x0, y0, z0) and whose shape is
    (nz, ny, nx), at the file's resolution or res_override."""
    voxels, res = bt_to_voxels(path)
    if res_override:
        res = res_override
    nz, ny, nx = shape
    grid = np.zeros(shape, dtype=np.float32)
    if len(voxels):
        idx = np.floor((voxels - np.asarray(origin)[None, ::-1][:, ::-1])
                       / res).astype(int)
        ix, iy, iz = idx[:, 0], idx[:, 1], idx[:, 2]
        ok = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
              & (iz >= 0) & (iz < nz))
        grid[iz[ok], iy[ok], ix[ok]] = 1.0
    return grid, res


def write_bt(path: str, grid: np.ndarray, resolution: float, origin) -> None:
    """Write a dense (Z, H, W) {0, 1} grid as a .bt octree; origin is the
    world point (x0, y0, z0) of the grid's corner."""
    lib = _load()
    g = np.ascontiguousarray(grid.astype(np.uint8))
    nz, ny, nx = g.shape
    rc = lib.bt_write(path.encode(), g.ctypes.data, nx, ny, nz,
                      float(resolution), float(origin[0]), float(origin[1]),
                      float(origin[2]))
    if rc != 0:
        raise IOError(f"failed to write octomap .bt file: {path}")


def read_pcd(path: str) -> np.ndarray:
    """(N, 3) float32 points of an ascii or binary PCD file (x, y, z)."""
    lib = _load()
    n = ctypes.c_int(0)
    h = lib.pcd_read(path.encode(), ctypes.byref(n))
    if not h:
        raise IOError(f"failed to read .pcd file: {path}")
    pts = np.zeros((n.value, 3), dtype=np.float32)
    lib.pcd_get_points(h, pts.ctypes.data)
    lib.pcd_free(h)
    return pts


def write_pcd(path: str, points: np.ndarray, ascii_mode: bool = True) -> None:
    """Write (N, 3) points as a PCD file, ascii or binary."""
    lib = _load()
    pts = np.ascontiguousarray(points.astype(np.float32))
    rc = lib.pcd_write(path.encode(), pts.ctypes.data, len(pts),
                       1 if ascii_mode else 0)
    if rc != 0:
        raise IOError(f"failed to write .pcd file: {path}")
