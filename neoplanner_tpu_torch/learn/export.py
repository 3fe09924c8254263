"""Deployment export: PlannerNet as a serialized ``torch.export`` program.

The port of neoplanner_tpu/learn/export.py (a ``jax.export`` program
there). The artifact is PlannerNet's inference at the reference's flat I/O
contract, (batch, W*H + 24) float32 -> (batch, 9) (nn_planner.py:14-17),
with its weights inside: loadable without the model code, as an ONNX file
or the reference's TensorRT engine (onnx2trt.py:17-50) is. ``latency_test``
is the reference's standalone smoke test (trt_test.py:31-65). The program
is bound to the device it was exported on.
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch
from torch import nn

from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.models.planner_net import PlannerNet


class _Flat(nn.Module):
    def __init__(self, net: PlannerNet):
        super().__init__()
        self.net = net

    def forward(self, flat: torch.Tensor) -> torch.Tensor:
        return self.net.forward_flat(flat)


def export_flat(net: PlannerNet, batch: int = 1):
    """The ``torch.export.ExportedProgram`` of net.forward_flat at
    (batch, W*H + 24) on the net's device."""
    cfg = net.np_cfg
    n_in = cfg.img_width * cfg.img_height + cfg.motion_input_size
    example = torch.zeros((batch, n_in),
                          device=next(net.parameters()).device)
    return torch.export.export(_Flat(net).eval(), (example,))


def save(path: str, net: PlannerNet, batch: int = 1) -> str:
    torch.export.save(export_flat(net, batch), path)
    return path


def load(path: str, device="cuda"):
    """The engine of a saved program: a module (batch, n_in) -> (batch, 9)
    with the weights inside. The program runs on the device it was
    exported on, which must be ``device``."""
    dev = _cuda.resolve_device(device)
    engine = torch.export.load(path).module()
    on = {p.device.type for p in engine.parameters()}
    if on != {dev.type}:
        raise ValueError(f"{path} was exported on {sorted(on)}; load it "
                         f"there, not on {dev.type}")
    return engine


def latency_test(fn, example_input: torch.Tensor, warmup: int = 5,
                 iters: int = 50) -> Tuple[float, float]:
    """Warm up, then time iters calls of fn on example_input, each to its
    end (a synchronize on the card): (mean_ms, p50_ms)."""
    sync = (torch.cuda.synchronize if example_input.is_cuda
            else (lambda: None))
    times = []
    with torch.no_grad():
        for i in range(warmup + iters):
            t0 = time.perf_counter()
            fn(example_input)
            sync()
            if i >= warmup:
                times.append((time.perf_counter() - t0) * 1000.0)
    return float(np.mean(times)), float(np.median(times))
