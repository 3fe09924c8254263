"""What the timed path produced, read at the program's own layer
boundaries.

The harness wraps the port's entries of each layer in thin functions: the
entries that the check's layer readers name (``checks/<layer>.py``'s
``HOOKS``: rendering, fusion, the ESDF rebuild, the net's prediction, the
bank, the setpoint sampling, tracking) and those the traced run reads
(:data:`TRACED`: rendering and the L-BFGS launches, whose work the counts
need, and the missions' host code). While the capture is armed (one
segment of the window) each call's arguments and result are kept for the
check. In a traced run every call also opens a
``torch.profiler.record_function`` span named after its layer, which
labels the device's idle gaps by what the host was doing, and the calls
whose work depends on the data (B4's poses, the solvers' iterations) are
kept for the counts. Unarmed and untraced, a wrapper costs one Python
call. An entry that the program no longer has stops the run at
:meth:`Capture.install`, before the window.
"""

from __future__ import annotations

import importlib
from contextlib import nullcontext

import torch

# (module, function, span name): the entries the traced run reads
TRACED = (
    ("neoplanner_tpu_torch.sense.raycast", "render_depth_auto", "render"),
    ("neoplanner_tpu_torch.plan.solve", "solve_scene", "solve"),
    ("neoplanner_tpu_torch.plan.solve", "solve_grid", "solve"),
    ("neoplanner_tpu_torch.sim.env", "_end_missions", "missions"),
    ("neoplanner_tpu_torch.sim.missions", "set_local_target", "missions"),
)
# the calls whose work the traced run counts in every segment
COUNTED = ("render_depth_auto", "solve_scene", "solve_grid")


def _counted(name, args, kwargs, out):
    """What the counts need of a call, and no more (a traced window holds
    one record per call): B4's world, poses, camera and row stride; a
    solver's iterations, problem-to-env map, skip flags, parameters and
    its env's primitives (B1) or window size (B6)."""
    if name == "render_depth_auto":
        rs = kwargs.get("row_stride", args[4] if len(args) > 4 else 1)
        return name, dict(world=args[0], pos=args[1], quat=args[2],
                          cam=args[3], row_stride=rs)
    skip = kwargs.get("skip", args[6] if len(args) > 6 else None)
    rec = dict(iters=out[2], env_of=args[4], pp=args[5], skip=skip,
               n_vars=args[0].shape[1])
    if name == "solve_scene":
        rec["scene"] = args[3]
    else:
        rec["window_cells"] = args[3].win.numel()
    return name, rec


class Capture:
    def __init__(self):
        self.trace = False       # set for a traced window
        self.armed = False
        self.calls = []          # (name, args, kwargs, result) while armed
        self.counted = []        # (name, record) of COUNTED, traced
        self.net_out = []        # the net's raw outputs while armed
        self._undo = []

    def arm(self) -> None:
        self.calls, self.net_out, self.armed = [], [], True

    def disarm(self) -> None:
        self.armed = False

    def _wrap(self, mod, name: str, span: str):
        orig = getattr(mod, name)

        def wrapper(*args, **kwargs):
            ctx = (torch.profiler.record_function(f"bench.{span}")
                   if self.trace else nullcontext())
            with ctx:
                out = orig(*args, **kwargs)
            if self.armed:
                self.calls.append((name, args, kwargs, out))
            if self.trace and name in COUNTED:
                self.counted.append(_counted(name, args, kwargs, out))
            return out

        wrapper.__wrapped__ = orig
        setattr(mod, name, wrapper)
        self._undo.append((mod, name, orig))

    def install(self, net=None, hooks=()) -> None:
        """Wrap the entries of :data:`TRACED` and ``hooks`` ((module,
        function, span name), the check's), each once; with ``net``, keep
        its raw outputs while armed."""
        done = set()
        for module, name, span in tuple(hooks) + TRACED:
            if (module, name) not in done:
                done.add((module, name))
                self._wrap(importlib.import_module(module), name, span)
        if net is not None:
            def hook(_module, _args, out):
                if self.armed:
                    self.net_out.append(out)
            self._undo.append(net.register_forward_hook(hook))

    def close(self) -> None:
        for item in reversed(self._undo):
            if isinstance(item, tuple):
                mod, name, orig = item
                setattr(mod, name, orig)
            else:
                item.remove()
        self._undo = []

    def of(self, *names):
        """The captured calls of the given function names, in call order."""
        return [c for c in self.calls if c[0] in names]
