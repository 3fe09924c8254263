"""The port does all that the JAX package does: for every module of
neoplanner_tpu except the Pallas kernel modules, the port has the module of
the same path, and every public top-level ``def`` and ``class`` of the JAX
module has a namesake there (a def, a class, an assignment or an import).
Both packages are read as ASTs; nothing of JAX is imported.

The kernel modules (``*_pallas*.py``, each with ``pl.pallas_call`` sites)
are ported kernel by kernel, not name by name: their sites are the rows of
the kernel table in PERF.md section 6, and the last test holds that every
one of them is named there.
"""

import ast
import os

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
JAX_PKG = os.path.join(ROOT, "neoplanner_tpu")
PORT_PKG = os.path.join(ROOT, "neoplanner_tpu_torch")


def _modules():
    out = []
    for dirpath, _, files in os.walk(JAX_PKG):
        out += [os.path.relpath(os.path.join(dirpath, f), JAX_PKG)
                for f in files if f.endswith(".py")]
    return sorted(out)


def _is_kernel_module(rel: str) -> bool:
    return "_pallas" in os.path.basename(rel)


MODULES = [m for m in _modules() if not _is_kernel_module(m)]
KERNEL_MODULES = [m for m in _modules() if _is_kernel_module(m)]


def _tree(path):
    with open(path) as fh:
        return ast.parse(fh.read(), path)


def _public_defs(tree) -> set:
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}


def _names(tree) -> set:
    out = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out |= {t.id for t in n.targets if isinstance(t, ast.Name)}
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out |= {a.asname or a.name.split(".")[0] for a in n.names}
    return out


def test_the_split_is_the_kernel_table():
    assert len(MODULES) >= 40
    assert len(KERNEL_MODULES) == 9
    for rel in KERNEL_MODULES:
        with open(os.path.join(JAX_PKG, rel)) as fh:
            assert "pallas_call" in fh.read(), rel


@pytest.mark.parametrize("rel", MODULES)
def test_module_has_its_namesakes(rel):
    port = os.path.join(PORT_PKG, rel)
    assert os.path.isfile(port), f"the port has no {rel}"
    missing = _public_defs(_tree(os.path.join(JAX_PKG, rel))) \
        - _names(_tree(port))
    assert not missing, f"{rel}: no namesake in the port for {sorted(missing)}"


@pytest.mark.parametrize("rel", KERNEL_MODULES)
def test_kernel_module_is_in_the_kernel_table(rel):
    with open(os.path.join(ROOT, "PERF.md")) as fh:
        perf = fh.read()
    assert f"`{rel}:" in perf, f"PERF.md's kernel table does not name {rel}"
