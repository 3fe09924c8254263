"""The inputs of a run, made on the device from ``--seed``: the worlds
(a copy of the port's procedural box worlds, world/scenegen.py, which
follows the reference's generate_worlds.py) and the net's weights and
BatchNorm statistics. Both sides get the same tensors."""

from __future__ import annotations

import math

import torch

_MASK = (1 << 63) - 1


def sub_seed(seed: int, k: int) -> int:
    """The k-th stream of a run's seed (any whole number)."""
    return (int(seed) * 1_000_003 + 7919 * k) & _MASK


def generator(seed: int, k: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, k))
    return g


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _sample_xy(gen, B, wp, device):
    K = wp["max_boxes"]
    x = _uniform(gen, (B, K), wp["pose_x_min"], wp["pose_x_max"], device)
    y = _uniform(gen, (B, K), wp["pose_y_min"], wp["pose_y_max"], device)
    return torch.stack([x, y], dim=-1)


def _conflicts(xy, sizes, active, wp):
    """Box i conflicts with an earlier active box j < i when both clearance
    inequalities hold (generate_worlds.py:129-134)."""
    K = xy.shape[1]
    dx = (xy[:, :, None, 0] - xy[:, None, :, 0]).abs()
    dy = (xy[:, :, None, 1] - xy[:, None, :, 1]).abs()
    lim_x = (sizes[:, :, None, 0] + sizes[:, None, :, 0]) / 2 \
        + wp["x_clearance"]
    lim_y = (sizes[:, :, None, 1] + sizes[:, None, :, 1]) / 2 \
        + wp["y_clearance"]
    earlier = torch.ones((K, K), dtype=torch.bool, device=xy.device).tril(-1)
    pair = (dx < lim_x) & (dy < lim_y) & earlier & active[:, None, :]
    return pair.any(-1)


def worlds(gen: torch.Generator, batch: int, wp: dict) -> dict:
    """(batch,) independent box worlds of the mix's world parameters ``wp``
    (WorldParams' fields): K boxes of uniform sizes and positions; a box in
    conflict with an earlier active box is redrawn for rejection_rounds
    rounds and dropped if still in conflict. Returns the fields of a
    BoxWorld: centers, half_sizes (B, K, 3), active (B, K) bool, shape
    (B, K) int32 (all boxes)."""
    device = gen.device
    K = wp["max_boxes"]
    sizes = torch.stack([
        _uniform(gen, (batch, K), wp["size_x_min"], wp["size_x_max"], device),
        _uniform(gen, (batch, K), wp["size_y_min"], wp["size_y_max"], device),
        _uniform(gen, (batch, K), wp["size_z_min"], wp["size_z_max"],
                 device)], dim=-1)
    xy = _sample_xy(gen, batch, wp, device)
    active = (torch.arange(K, device=device) < min(wp["num_boxes"], K)
              ).expand(batch, K)
    for _ in range(wp["rejection_rounds"]):
        bad = _conflicts(xy, sizes, active, wp)
        xy = torch.where(bad[..., None], _sample_xy(gen, batch, wp, device),
                         xy)
    active = active & ~_conflicts(xy, sizes, active, wp)
    centers = torch.cat([xy, sizes[..., 2:3] / 2], dim=-1)
    return dict(centers=centers, half_sizes=sizes / 2,
                active=active.contiguous(),
                shape=torch.zeros((batch, K), dtype=torch.int32,
                                  device=device))


def net_weights(shapes: dict, gen: torch.Generator) -> dict:
    """Seeded weights of a net given {name: shape} in its state-dict order,
    drawn in one call on the generator's device: each convolution and
    dense kernel from N(0, 1 / fan_in) (flax's lecun_normal, the JAX
    package's initializer), biases from N(0, 0.01^2), each BatchNorm's
    scale 1 + N(0, 0.1^2), bias N(0, 0.1^2), running mean N(0, 0.1^2) and
    running variance 1 + 0.2 U[0, 1)."""
    total = sum(math.prod(s) for s in shapes.values())
    normal = torch.randn(total, generator=gen, device=gen.device)
    uniform = torch.rand(total, generator=gen, device=gen.device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        z, u = normal[at:at + n].reshape(shape), uniform[at:at + n]
        at += n
        leaf = name.rsplit(".", 1)[-1]
        bn = ".bn_" in "." + name
        if leaf == "weight" and len(shape) > 1:
            out[name] = z * (1.0 / math.sqrt(math.prod(shape[1:])))
        elif bn and leaf == "weight":
            out[name] = 1.0 + 0.1 * z
        elif bn and leaf == "running_var":
            out[name] = 1.0 + 0.2 * u.reshape(shape)
        elif bn:                     # bias, running_mean
            out[name] = 0.1 * z
        else:                        # a dense or convolution bias
            out[name] = 0.01 * z
    return out
