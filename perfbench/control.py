"""Readings for a cell's correctness limits, on the chip at the cell's own
size: for each seed, the program's numbers (its answers outside a window,
judged as a run judges them) and the control's (the plain reference at the
next lower precision put in the program's place, judged the same way).

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 [--pages 3]

Prints one JSON line per seed and one with each number's largest program
reading and smallest control reading over the seeds. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import run  # noqa: E402,F401  (sets the cache directories)


def readings(cell, seed: int, pages: int, device: str = "cuda") -> dict:
    session = cell.driver().Session(cell, seed, device)
    session.setup()
    return {"seed": seed, **session.control_readings(pages)}


def main(argv=None) -> int:
    from benchlib.cells import load_cell

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--pages", type=int, default=3)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        rows.append(readings(cell, seed, args.pages))
        print(json.dumps(rows[-1]), flush=True)
    summary = {"lower": {k: max(r["program"][k] for r in rows) for k in rows[0]["program"]},
               "upper": {k: min(r["control"][k] for r in rows) for k in rows[0]["control"]}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
