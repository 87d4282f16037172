"""The live rate sweep, made once to fix an open-loop traffic file's rate:

    python3 -m kpwbench.sweep --config replay12 --live live --seed <n> \\
        --seconds 20 --fractions 0.6,0.7,0.8,0.9,1.0

A catch-up run of the configuration (traffic ``catchup``) gives the rate
it drains a backlog at (``ack.records_per_s``); open-loop runs at each fraction of that rate (the
``--live`` traffic file with its rate replaced, rounded to whole batches)
then give, per rate, the consumer's lag at the window's start and end and
``ack_p95_ms``.  A rate is sustained where the lag at the end is no more
than at the start plus one rotation's worth of records.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

RATE = "ack.records_per_s"  # a per-layer metric of BENCHMARK.json; the sweep reads it untraced


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--live", default="live")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--fractions", default="0.6,0.7,0.8,0.9,1.0")
    args = ap.parse_args(argv)

    from kpwbench import harness, spec

    with open(spec.benchmark_path()) as f:
        bench = json.load(f)
    catchup, live = f"{args.config}.sweep_catchup", f"{args.config}.sweep_live"
    bench["workloads"] += [
        {"name": catchup, "config": args.config, "traffic": "catchup", "chips": 1},
        {"name": live, "config": args.config, "traffic": args.live, "chips": 1}]
    bench["end_to_end"] = [m for m in bench["end_to_end"]
                           if m["name"] not in (RATE, "ack_p95_ms")] + [
        {"name": RATE, "unit": "records/s", "source": "host_clock", "workloads": [catchup]},
        {"name": "ack_p95_ms", "unit": "ms", "source": "host_clock", "workloads": [live]}]
    cell = spec.Cell(catchup, bench)
    st: dict = {}
    r = harness.run_cell(cell, args.seed, args.seconds, False, stats=st)
    rate = r["metrics"][RATE]["value"]
    print(json.dumps({"traffic": "catchup", RATE: rate, "correct": r["correct"],
                      **st}), flush=True)
    cell = spec.Cell(live, bench)
    interval = cell.traffic["interval_ms"] / 1000.0
    rotation = cell.config["max_file_open_duration_seconds"]
    for frac in [float(x) for x in args.fractions.split(",")]:
        per_batch = max(1, round(frac * rate * interval))
        cell.traffic["rate_per_s"] = per_batch / interval
        st = {}
        r = harness.run_cell(cell, args.seed + 1, args.seconds, False, stats=st)
        ack = r["metrics"].get("ack_p95_ms", {}).get("value")
        sustained = st["lag_end"] <= st["lag_start"] + cell.traffic["rate_per_s"] * rotation
        print(json.dumps({"fraction": frac, "rate_per_s": cell.traffic["rate_per_s"],
                          "ack_p95_ms": ack, "sustained": sustained,
                          "failed": r["failed"], "correct": r["correct"], **st}), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    os._exit(code)
