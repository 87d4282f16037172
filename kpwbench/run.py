"""The benchmark's command:

    python3 -m kpwbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the cards the cell asks
for.  It prints progress lines, then as the last line of standard output
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number the read-back compared, beside its limit), and as the last lines
of standard error the same numbers.  It exits non-zero, printing no
result, where there is no card, too few cards, or where JAX or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "kpw_tpu")


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the run must not load,
    compared whole (``kpw_tpu_torch`` is not ``kpw_tpu``)."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _card_lines() -> list:
    lines = []
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        lines.append(f"[card] nvidia-smi: {out.stdout.strip()}")
    except (OSError, subprocess.SubprocessError) as exc:
        lines.append(f"[card] nvidia-smi: not read ({exc!r})")
    try:
        with open("/proc/meminfo") as f:
            lines.append("[machine] " + " ".join(f.readline().split()[:2]))
    except OSError:
        pass
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from kpwbench import harness, spec

    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"kpwbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              t_start=T_START, log=lambda m: print(m, flush=True))
    for line in _card_lines():  # after the run: nvidia-smi is no part of set-up
        print(line, flush=True)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    found = forbidden_modules()
    if found:
        print(f"kpwbench: the run loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        import traceback

        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    # the writer's threads are stopped; skip interpreter teardown, whose
    # order of native library unloads is not the run's to judge
    os._exit(code)
