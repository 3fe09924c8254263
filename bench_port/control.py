#!/usr/bin/env python3
"""Readings of the check on many seeds in one process: the program
against the reference (the lower readings that set a limit) and the
control, the reference in the precision below in the program's place (the
upper readings), of the same captured segment. Not run by the benchmark's
own runs.

    python3 bench_port/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 5 [--control 1] [--witness 0] [--out control.jsonl]

Each seed is one run of :func:`harness.runner.run_cell`, the path that
run.py times and judges, with a window of ``--seconds``; one JSON line per
seed holds ``program`` (every reading of the program), ``control`` and,
with ``--witness 1``, ``witness`` (the bank's reference on the CPU
against the same on the device).
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def rows(cell, seeds, seconds: float, device, control: bool = True,
         witness: bool = False):
    """One row of readings for each seed, as run_cell gives them."""
    import torch
    from harness.runner import run_cell

    for seed in seeds:
        t0 = time.perf_counter()
        r = run_cell(cell, seed, seconds, False, device,
                     [("start", t0)], control=control, witness=witness)
        row = {"workload": cell.name, "seed": seed,
               "segments": r["segments"], "correct": r["correct"],
               "layers_missing": r["layers_missing"],
               "program": dict(r["readings"],
                               **{k: c["value"]
                                  for k, c in r["check"].items()})}
        for k in ("control", "witness"):
            if k in r:
                row[k] = r[k]
        row["seconds"] = time.perf_counter() - t0
        if device.type == "cuda":
            torch.cuda.empty_cache()
        yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--witness", type=int, default=0,
                    help="also the bank's reference on the CPU against the "
                         "same on the device (the roundoff alone)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]
    import torch
    from harness.cells import resolve

    cell = resolve(args.workload, ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    for row in rows(cell, seeds, args.seconds, torch.device("cuda"),
                    bool(args.control), bool(args.witness)):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
