#!/usr/bin/env python3
"""The readings that set a cell's limits: the program's and the
control's numbers on many seeds, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 \
        --control bfloat16,tf32 --control-seeds 3 [--seconds 3] \
        [--first-seed N]

For each seed a short run of the cell (set-up, a window of `--seconds`,
the check against the reference) prints one JSON line of its readings;
then each control (the reference in the program's place, computed in a
narrower format) on its own seeds, and last the largest reading of the
program and the smallest of each control for each number.  The limits
in `benchmark/workloads/<cell>.json` are set between the two.  The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import run  # noqa: E402


def readings(cell: str, seed: int, seconds: float, control=None) -> dict:
    return run.run_cell(cell, seed, seconds, False,
                        control=control)["readings"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", default=None)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=2_147_483_700)
    args = ap.parse_args(argv)
    run.fixed_caches(run.ROOT)
    controls = args.control.split(",") if args.control else []
    rows = {side: [] for side in ["program", *controls]}
    plan = [("program", args.first_seed + k) for k in range(args.seeds)]
    plan += [(c, args.first_seed + 1000 + k) for c in controls
             for k in range(args.control_seeds)]
    for side, seed in plan:
        r = readings(args.workload, seed, args.seconds,
                     None if side == "program" else side)
        rows[side].append(r)
        print(json.dumps({"side": side, "seed": seed, **r}), flush=True)
    keys = sorted({k for r in rows["program"] for k in r} - {"check_s"})
    summary = {k: {"program_max": max((r[k] for r in rows["program"]),
                                      default=None),
                   **{f"{c}_min": min((r[k] for r in rows[c]), default=None)
                      for c in controls}} for k in keys}
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
