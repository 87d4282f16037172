"""Sets of runs of one cell, each a process of the benchmark's command, and
the spread of each end-to-end metric over each set:

    python3 -m kpwbench.sets --workload taxi64.catchup --seeds 11,12,13,14,15,16 \\
        --sets 2 --seconds 45 --out chiprun_out/sets.json [--roots a,b] [--trace 0]

Each set runs every seed once, in order; the sets repeat the same seeds.
With several ``--roots`` (checkouts of the benchmark), each seed runs in
each root in turn, the order alternating from seed to seed, so that the
host's drift falls on each alike.  A run's result line, and its
``[setup]``, ``[run]``, ``[host]`` and ``[bursts]`` lines, each tag's in a
list, are kept.  A spread is the
distance between the first and the third quartile, as
``statistics.quantiles(values, n=4)`` gives them, over the median; the
trimmed spread leaves out the set's run farthest from its median.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

TAGS = ("[setup]", "[run]", "[host]", "[bursts]")


def spread(values: list) -> float | None:
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def trimmed(values: list) -> list:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def one(root: str, workload: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "kpwbench.run", "--workload", workload,
                        "--seed", str(seed), "--seconds", str(seconds),
                        "--trace", str(trace)],
                       cwd=root, capture_output=True, text=True)
    row = {"root": root, "seed": seed, "trace": trace, "rc": p.returncode,
           "wall_s": time.perf_counter() - t0}
    lines = p.stdout.strip().splitlines()
    for line in lines:
        for tag in TAGS:
            if line.startswith(tag):
                body = line[len(tag):].strip()
                row.setdefault(tag.strip("[]"), []).append(
                    json.loads(body) if body.startswith(("[", "{")) else body)
    try:
        row["result"] = json.loads(lines[-1])
    except (IndexError, ValueError):
        row["result"] = None
        row["stderr"] = p.stderr[-4000:]
    return row


def summary(rows: list) -> dict:
    out: dict = {}
    for r in rows:
        if not r["result"]:
            continue
        for name, m in r["result"]["metrics"].items():
            out.setdefault(r["root"], {}).setdefault(r["set"], {}).setdefault(
                name, []).append(m["value"])
    for root, sets in out.items():
        for k, metrics in sets.items():
            sets[k] = {name: {"median": statistics.median(v), "spread": spread(v),
                              "trimmed_spread": spread(trimmed(v)) if len(v) > 2 else None,
                              "values": v}
                       for name, v in metrics.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=45)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--roots", default=".")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    roots = args.roots.split(",")
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    for k in range(args.sets):
        for i, seed in enumerate(seeds):
            order = roots if (k * len(seeds) + i) % 2 == 0 else roots[::-1]
            for root in order:
                row = one(root, args.workload, seed, args.seconds, args.trace)
                row["set"] = k
                rows.append(row)
                res = row["result"] or {}
                print(json.dumps({"root": root, "set": k, "seed": seed, "rc": row["rc"],
                                  "correct": res.get("correct"),
                                  "metrics": {n: m["value"] for n, m in
                                              res.get("metrics", {}).items()}}),
                      flush=True)
                with open(args.out, "w") as f:
                    json.dump({"rows": rows, "summary": summary(rows)}, f, indent=1)
    print(json.dumps(summary(rows)), flush=True)
    return 0 if all(r["result"] and r["result"]["correct"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
