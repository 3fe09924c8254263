"""Env-state snapshots: save a simulation state and resume it exactly.

The port of neoplanner_tpu/utils/snapshot.py (an orbax checkpoint of the
state pytree there). The port's snapshot is a ``torch.save`` of every
tensor of the EnvState as a CPU tensor, by its path, and of the state's
``torch.Generator`` state, so that a resumed run draws the numbers the
uninterrupted one would. It holds tensors only and is read back with
``weights_only=True``.
"""

from __future__ import annotations

import dataclasses

import torch

from neoplanner_tpu_torch.sim.env import EnvState
from neoplanner_tpu_torch.utils.profiling import tensor_leaves


def save(path: str, state: EnvState) -> str:
    torch.save({"tensors": {p: t.detach().cpu()
                            for p, t in tensor_leaves(state)},
                "generator": state.generator.get_state()}, path)
    return path


def _fill(tmpl, path: str, tensors: dict):
    if isinstance(tmpl, torch.Tensor):
        t = tensors[path]
        if t.shape != tmpl.shape or t.dtype != tmpl.dtype:
            raise ValueError(f"snapshot {path}: {tuple(t.shape)} {t.dtype}, "
                             f"the template {tuple(tmpl.shape)} {tmpl.dtype}")
        return t.to(tmpl.device)
    if dataclasses.is_dataclass(tmpl) and not isinstance(tmpl, type):
        return dataclasses.replace(tmpl, **{
            f.name: _fill(getattr(tmpl, f.name), f"{path}.{f.name}", tensors)
            for f in dataclasses.fields(tmpl)})
    return tmpl


def load(path: str, template: EnvState) -> EnvState:
    """The saved state on the devices of ``template`` (an EnvState from
    reset with the same configuration: its shapes, dtypes, maps and
    parameters), with its generator's state restored."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    state = _fill(template, "", blob["tensors"])
    gen = torch.Generator(device=template.generator.device)
    gen.set_state(blob["generator"])
    return state.replace(generator=gen)
