"""Registers, spills, stack and shared memory of the port's kernels, as
``ptxas -v`` reports them, and each kernel's SASS instruction count.

    python3 -m neoplanner_tpu_torch.ptxas_report [--match TEXT] [CSRC ...]

For each CSRC directory (by default this package's ``csrc/``) one ``nvcc``
call compiles its ``*.cu`` with the flags of ``_cuda.py`` plus ``-Xptxas
-v`` into ``_build/ptxas/``, and one line per kernel entry (those whose
name holds TEXT, if given) prints its registers, stack frame, spill stores
and loads, static shared memory, and its instructions as ``cuobjdump
-sass`` lists them (code that a warp streams through the instruction cache
once per pass). Needs ``nvcc`` and ``cuobjdump``; no GPU.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

from neoplanner_tpu_torch import _cuda

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_FUNCTION = re.compile(r"Function : (\S+)")
_INSTRUCTION = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/")


def _demangle(names):
    for tool in ("cu++filt", "c++filt"):
        path = shutil.which(tool) or str(Path(_cuda._nvcc()).parent / tool)
        if Path(path).exists():
            out = subprocess.run([path], input="\n".join(names),
                                 capture_output=True, text=True).stdout
            got = out.splitlines()
            if len(got) == len(names):
                return got
    return list(names)


def _without_parameters(name: str) -> str:
    """A demangled kernel name without its parameter list, its template
    arguments kept (objective_scene_kernel<(bool)1>, not ..._kernel<)."""
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0 and name[i - 1] != " ":
            return name[:i]
    return name


def _instructions(lib: Path):
    """{mangled kernel name: SASS instruction count} of a built library."""
    tool = shutil.which("cuobjdump") or str(Path(_cuda._nvcc()).parent
                                            / "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if m := _FUNCTION.search(line):
            name = m.group(1)
            counts[name] = 0
        elif name is not None and _INSTRUCTION.match(line):
            counts[name] += 1
    return counts


def report(csrc: Path):
    """[(kernel, registers, stack, spill stores, spill loads, smem,
    instructions)]."""
    out_dir = _cuda._BUILD / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmd = [_cuda._nvcc(), *_cuda._FLAGS, "-Xptxas", "-v", "-o",
           str(out_dir / "lib.so"), *map(str, sorted(csrc.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    rows, cur = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        if m := _ENTRY.search(line):
            cur = [m.group(1), 0, 0, 0, 0, 0]
            rows.append(cur)
        elif cur is not None and (m := _FRAME.search(line)):
            cur[2:5] = map(int, m.groups())
        elif cur is not None and (m := _USED.search(line)):
            cur[1] = int(m.group(1))
            if s := _SMEM.search(line):
                cur[5] = int(s.group(1))
    counts = _instructions(out_dir / "lib.so")
    for row, name in zip(rows, _demangle([r[0] for r in rows])):
        row.append(counts.get(row[0], 0))
        row[0] = _without_parameters(name)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("csrc", nargs="*", type=Path,
                    default=[Path(_cuda._SRC)])
    ap.add_argument("--match", default="")
    args = ap.parse_args(argv)
    for csrc in args.csrc:
        print(f"{csrc}:")
        for name, regs, stack, st, ld, smem, n_ins in report(csrc):
            if args.match in name:
                print(f"  {name}: {regs} registers, {stack} B stack, "
                      f"{st} B spill stores, {ld} B spill loads, {smem} B "
                      f"static smem, {n_ins} instructions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
