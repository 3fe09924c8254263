"""The comparison that decides ``correct``.

One segment of the window is captured (:mod:`harness.capture`); for a
sample of its envs drawn from the seed, the plain reference under
``reference/`` recomputes every layer that the segment ran from the same
inputs that layer received, and each layer's output is compared with the
program's. A configuration names the layers its check covers, in order,
under ``check.layers``; each is a reader of its own, ``checks/<layer>.py``,
with the program entries it hooks (``HOOKS``) and ``read``, which returns
its numbers (see each file), or nothing where the segment made no call of
its entries. A layer that returns nothing is reported by name, and its
limited numbers are missing, so ``correct`` is false.

The reference follows the program layer by layer, from the program's own
state at each layer's entry (the L-BFGS bank and tracking are chaotic over
a segment, so a whole-segment replay would compare roundoff). Each layer
is judged alone, on the program's inputs to it.

The control puts the reference in the program's place in the precision
below the configuration's: every layer's inputs and outputs held in
bfloat16, the net's convolutions and products in TF32, the ESDF stored in
float8 (e4m3) where the program stores bfloat16.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch

from harness.cells import check_reader
from reference import (config as rconfig, esdf as resdf, scene as rscene,
                       types as rtypes)

_REF_CLASSES = {c.__name__: c for c in (
    rtypes.BoxWorld, rtypes.DroneState, rtypes.ESDFMap, rtypes.Trajectory,
    rscene.SceneMap, resdf.GridWindow)}
_PARAMS = ("PlannerParams", "MissionParams", "SimParams", "CameraParams",
           "MapParams", "NetParams")


class Ref:
    """Converts the program's objects to the reference's, on a sample of
    envs: tensors with a leading env axis of B are indexed by ``idx``;
    with ``low`` every floating tensor goes through bfloat16."""

    def __init__(self, B: int, idx: torch.Tensor, low: bool = False,
                 device=None):
        self.B, self.idx, self.low, self.device = B, idx, low, device

    def t(self, x: torch.Tensor, batched: bool = True) -> torch.Tensor:
        if batched and x.dim() > 0 and x.shape[0] == self.B:
            x = x[self.idx.to(x.device)]
        if self.low and x.is_floating_point():
            x = x.to(torch.bfloat16).to(x.dtype)
        return x if self.device is None else x.to(self.device)

    def __call__(self, obj):
        if isinstance(obj, torch.Tensor):
            return self.t(obj)
        name = type(obj).__name__
        if name in _PARAMS:
            return getattr(rconfig, name)(**dataclasses.asdict(obj))
        if dataclasses.is_dataclass(obj):
            unbatched = getattr(obj, "unbatched", ())
            vals = {}
            for f in dataclasses.fields(obj):
                v = getattr(obj, f.name)
                if isinstance(v, torch.Tensor):
                    v = self.t(v, batched=f.name not in unbatched)
                elif v is not None and not isinstance(
                        v, (int, float, str, bool, torch.Generator)):
                    v = self(v)
                vals[f.name] = v
            cls = _REF_CLASSES.get(name)
            return cls(**vals) if cls else SimpleNamespace(**vals)
        if isinstance(obj, (tuple, list)):
            return type(obj)(self(v) for v in obj)
        return obj


def lower(x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """x held in ``dtype`` (the control's precision), back in its own."""
    return x.to(dtype).to(x.dtype)


def blocks(n: int, size: int):
    for a in range(0, n, size):
        yield slice(a, min(a + size, n))


def arg(args, kwargs, i, name, default=None):
    if name in kwargs:
        return kwargs[name]
    return args[i] if len(args) > i else default


def hooks(layers) -> list:
    """(module, function, layer) of every program entry that the named
    layers' readers hook, in order."""
    return [(m, f, layer) for layer in layers
            for m, f in check_reader(layer).HOOKS]


def readings(cap, system, idx: torch.Tensor, layers,
             control: bool = False):
    """(values, missing): every reading of the captured segment on the
    envs ``idx`` by the readers of ``layers``, the program against the
    reference, or with ``control`` the reference in the precision below
    against the reference; and the layers whose reader found nothing."""
    exact = Ref(system.envs, idx)
    low = Ref(system.envs, idx, low=True)
    out, missing = {}, []
    for layer in layers:
        got = check_reader(layer).read(cap, exact, low, control, system)
        if not got:
            missing.append(layer)
        out.update(got)
    return out, missing


def witness(cap, system, idx: torch.Tensor) -> dict:
    """The bank's roundoff alone (``checks/plan.py``'s witness)."""
    return check_reader("plan").witness(cap, system, idx)


def sample(B: int, n: int, seed: int) -> torch.Tensor:
    """n of B envs, drawn from the seed, in order."""
    from harness.inputs import sub_seed
    g = torch.Generator()
    g.manual_seed(sub_seed(seed, 4))
    return torch.randperm(B, generator=g)[:min(n, B)].sort().values


def judge(values: dict, limits: dict):
    """(correct, [(name, value, limit)]): every limited number present and
    at or under its limit."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = values.get(name)
        good = v is not None and v == v and v <= limit
        ok = ok and good
        rows.append((name, v, limit))
    return ok, rows
