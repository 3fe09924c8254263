"""The PyTorch port imports no JAX: not jax, flax or orbax, and nothing of
the JAX package neoplanner_tpu — checked over the source text of every
module and of chip_smoke.py, and by importing every module in a fresh
interpreter in which those packages cannot be imported."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(ROOT, "neoplanner_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "neoplanner_tpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread per test process, for the module's tests
    (every test_torch_* module imports this fixture). The suite runs several
    worker processes on a few cores; PyTorch's default of one thread per
    core in every worker oversubscribes the machine, and the port's tests
    then run about three times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
for name in {forbidden!r}:
    sys.modules[name] = None          # any import of it now raises
import neoplanner_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(neoplanner_tpu_torch.__path__,
                                              "neoplanner_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
print(len(mods))
"""


def test_package_imports_with_jax_blocked():
    code = _BLOCKED_IMPORT.format(forbidden=FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20
