#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is a workload of ``BENCHMARK.json``; its configuration and its
traffic mix are files under ``bench_port/configs/`` and
``bench_port/traffic/``, its per-layer metrics readers under
``bench_port/metrics/``. With ``--trace 0`` the line holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a run
under ``torch.profiler``. Each run checks what its window produced against
the plain reference (``bench_port/reference/``) and prints each number
compared beside its limit, on standard error and under the line's last
key, ``check``. The last line of standard output is the result's JSON.

The run needs as many CUDA devices as the cell asks for; without them it
exits with 2 and prints no result. It exits with 3 and prints no result if
JAX or the JAX package was loaded, and with 1 on any other failure.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _env() -> None:
    """Every build and kernel cache in fixed directories of the checkout;
    no library may pull JAX in."""
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    args = parse_args(argv)
    _env()
    sys.path[:0] = [str(HERE), str(ROOT)]
    marks = [("start", T_START)]
    import torch
    marks.append(("torch", time.perf_counter()))
    from harness.cells import resolve
    from harness.runner import (ForbiddenImport, check_lines,
                                forbidden_modules, run_cell)
    marks.append(("harness", time.perf_counter()))

    cell = resolve(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), marks)
    except ForbiddenImport as e:
        print(f"forbidden import: {e}", file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for line in check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
