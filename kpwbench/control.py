"""The control and the planted faults, at a cell's own size and load:

    python3 -m kpwbench.control --workload <cell> --seeds 1,2,3 --seconds 5 \\
        [--faults alter,drop_half,stale,drop_file,flip_file]

Each fault of ``faults.py`` is planted under a short run of the cell on
each seed, and every reading of the read-back is printed; every run must
come out not correct.  The benchmark's own runs never plant a fault.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--faults", default=",".join(("alter", "drop_half", "stale",
                                                  "drop_file", "flip_file")))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from kpwbench import faults, harness, spec

    cell = spec.load(args.workload)
    caught = True
    for name in args.faults.split(","):
        for seed in [int(s) for s in args.seeds.split(",")]:
            r = harness.run_cell(cell, seed, args.seconds, False, device=args.device,
                                 fault=faults.plant(name), log=lambda m: None)
            readings = {k: v["value"] for k, v in r["checks"].items()}
            caught &= not r["correct"]
            print(json.dumps({"workload": cell.name, "fault": name, "seed": seed,
                              "correct": r["correct"], "checks": readings}), flush=True)
    print(f"[control] every fault caught: {caught}", flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    os._exit(code)
