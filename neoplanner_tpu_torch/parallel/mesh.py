"""Data parallelism over the env axis, one process per device.

The port of neoplanner_tpu/parallel/mesh.py (``make_mesh`` :25,
``make_multislice_mesh`` :32, ``shard_batch_multislice`` :54,
``shard_batch`` :59, ``replicate`` :65, ``sharded_vmap_step`` :69,
``mean_over_envs`` :84). The JAX package shards env-batched pytrees over a
device mesh and lets XLA partition the jitted segment. Here every rank of
an initialized ``torch.distributed`` process group (one process per
device) holds its own contiguous block of the env axis as plain local
tensors, not DTensors, since the kernels take plain tensors through
ctypes; it steps that block with the ordinary batched step, and the only
cross-device traffic is the all-reduce of the metrics over the named
mesh dims (:func:`mean_over_envs`) and the broadcast of :func:`replicate`.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the whole
process group. ``device_type="cuda"`` needs a process group with NCCL and
binds each rank to the device rank % device_count; it raises without NCCL
and never falls back to gloo. ``device_type="cpu"`` needs gloo.

A state tree is a tensor, a dataclass, a tuple, list or dict of trees, or
any other value (passed through as it is: a ``torch.Generator``, None,
parameters). Every tensor leaf carries the env axis first, except the
fields a dataclass names in its ``unbatched`` class attribute
(``ESDFMap.origin``), which every rank receives whole.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _check_group(device_type: str) -> None:
    """Raise unless the process group suits device_type; for 'cuda' bind
    this process to its device."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("initialize the process group first "
                           "(torch.distributed.init_process_group, one "
                           "process per device)")
    backend = str(dist.get_backend())
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; build the "
                               "mesh with device_type='cpu' over gloo")
        if not dist.is_nccl_available() or "nccl" not in backend:
            raise RuntimeError(f"a CUDA mesh needs a process group with "
                               f"NCCL (the group's backend: {backend})")
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    elif device_type == "cpu":
        if "gloo" not in backend:
            raise RuntimeError(f"a CPU mesh needs a process group with gloo "
                               f"(the group's backend: {backend})")
    else:
        raise ValueError(f"unknown device_type {device_type!r}; the mesh "
                         f"runs on 'cuda' or 'cpu'")


def _world_size(n_devices: Optional[int]) -> int:
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices={n_devices}: the mesh spans the whole "
                         f"process group of {n} processes (None or {n})")
    return n


def make_mesh(n_devices: Optional[int] = None, axis: str = "env",
              device_type: str = "cuda") -> DeviceMesh:
    """A 1-D mesh named axis over the initialized process group, one device
    a process; n_devices must be None or the group's size."""
    _check_group(device_type)
    n = _world_size(n_devices)
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))


def make_multislice_mesh(n_devices: Optional[int] = None, dcn: int = 1,
                         mdl: int = 1,
                         axes: Sequence[str] = ("dcn", "dp", "mdl"),
                         device_type: str = "cuda") -> DeviceMesh:
    """A (dcn, dp, mdl) mesh over the process group, dp = n / (dcn * mdl):
    the env batch shards over (dcn, dp) jointly (dcn the outermost, slice
    axis; ranks are slice-major) and is replicated over mdl, the tensor
    axis. Raises ValueError when n does not factor so."""
    _check_group(device_type)
    n = _world_size(n_devices)
    if n % (dcn * mdl):
        raise ValueError(f"{n} devices do not factor into dcn={dcn} x dp x "
                         f"mdl={mdl}")
    dp = n // (dcn * mdl)
    return init_device_mesh(device_type, (dcn, dp, mdl),
                            mesh_dim_names=tuple(axes))


def _local_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _map(fn: Callable, tree: Any, path: str = "", batched: bool = True):
    """tree with every tensor leaf t replaced by fn(t, path, batched)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, path, batched)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        shared = getattr(type(tree), "unbatched", ())
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name), f"{path}.{f.name}",
                         batched and f.name not in shared)
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v, f"{path}[{i}]", batched)
                          for i, v in enumerate(tree))
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{path}[{k!r}]", batched)
                for k, v in tree.items()}
    return tree


def _block(tree: Any, n_blocks: int, index: int, dev: torch.device):
    """Block index of n_blocks contiguous blocks of every batched tensor
    leaf's leading axis, and the unbatched leaves whole, copied to dev."""
    sizes = []
    _map(lambda t, p, b: sizes.append((p, tuple(t.shape))) if b else None,
         tree)
    if not sizes:
        return _map(lambda t, p, b: t.to(dev, copy=True), tree)
    if not sizes[0][1]:
        raise ValueError(f"leaf {sizes[0][0] or 'tree'} is a scalar, not a "
                         f"batch")
    batch = sizes[0][1][0]
    for p, s in sizes:
        if not s or s[0] != batch:
            raise ValueError(f"leaf {p or 'tree'} has shape {s}: its leading "
                             f"axis is not the batch of {batch}")
    if batch % n_blocks:
        raise ValueError(f"a batch of {batch} does not split into "
                         f"{n_blocks} equal shards")
    size = batch // n_blocks
    sl = slice(index * size, (index + 1) * size)
    return _map(lambda t, p, b: (t[sl] if b else t).to(dev, copy=True), tree)


def _size_rank(mesh: DeviceMesh, axis: str):
    """(size, this rank's index) along the mesh axis named axis."""
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.size(dim), mesh.get_local_rank(dim)


def shard_batch(tree: Any, mesh: DeviceMesh, axis: str = "env") -> Any:
    """This rank's contiguous block of every batched tensor leaf's leading
    axis (the blocks in rank order along axis), on this rank's device."""
    return _block(tree, *_size_rank(mesh, axis), _local_device(mesh))


def shard_batch_multislice(tree: Any, mesh: DeviceMesh) -> Any:
    """Shard a batched tree over a multislice mesh's (dcn, dp) axes
    jointly: the block of this rank's (dcn, dp) coordinate, the same on
    every rank along mdl."""
    n_dcn, i_dcn = _size_rank(mesh, mesh.mesh_dim_names[0])
    n_dp, i_dp = _size_rank(mesh, mesh.mesh_dim_names[1])
    return _block(tree, n_dcn * n_dp, i_dcn * n_dp + i_dp,
                  _local_device(mesh))


def replicate(tree: Any, mesh: DeviceMesh) -> Any:
    """Every tensor leaf of the mesh's first rank, broadcast to every rank
    (each rank passes a tree of the same shapes and dtypes) and placed on
    its device."""
    dev = _local_device(mesh)
    src = int(mesh.mesh.flatten()[0])

    def bcast(t, path, batched):
        t = t.to(dev, copy=True).contiguous()
        dist.broadcast(t, src)
        return t
    return _map(bcast, tree)


def sharded_vmap_step(step_fn: Callable, mesh: DeviceMesh) -> Callable:
    """The step that runs step_fn on this rank's shard (from shard_batch)
    on this rank's device. There is no vmap: the port's step is already
    batched over the env axis, so each rank steps its block as one batch,
    and nothing crosses devices during the step. It takes no axis (the
    JAX package's names its sharding): shard_batch chose the block."""
    dev = _local_device(mesh)

    def step(tree, *args, **kwargs):
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                return step_fn(tree, *args, **kwargs)
        return step_fn(tree, *args, **kwargs)
    return step


def mean_over_envs(x: torch.Tensor, mesh: DeviceMesh,
                   axis: Union[str, Sequence[str]] = "env") -> torch.Tensor:
    """The mean over the env axis of the per-rank shards x (b, ...) held
    along the mesh dims named axis: the local sum (in float64) and count,
    all-reduced over each of those dims' groups in turn, the same value on
    every rank of them, in x's dtype. A 1-D mesh reduces over "env"; a
    multislice mesh over ("dcn", "dp"), the dims the batch is sharded
    over, so that the mdl replicas of a block count it once."""
    dev = _local_device(mesh)
    x = x.to(dev)
    local = x.to(torch.float64).sum(0)
    buf = torch.cat([local.reshape(-1), torch.tensor(
        [float(x.shape[0])], dtype=torch.float64, device=dev)])
    for name in ((axis,) if isinstance(axis, str) else tuple(axis)):
        if name not in mesh.mesh_dim_names:
            raise ValueError(f"the mesh has no dim {name!r} (its dims: "
                             f"{mesh.mesh_dim_names})")
        dist.all_reduce(buf, group=mesh.get_group(name))
    return (buf[:-1] / buf[-1]).reshape(local.shape).to(x.dtype)
