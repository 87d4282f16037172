"""Finds a cell's pieces by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix, and its
metrics.  Each piece lives in a file of its own under this package, found by
that name alone, so that a new configuration, mix or metric is new files
and new entries, never an edit:

- ``configs/<config>.json``: the deployment (schema, partitions, writer
  settings, its source and cuts);
- ``traffic/<traffic>.json``: the parameters the load generator
  (``load.py``) reads;
- ``generators/<generator>.py``, named by the configuration: draws the
  records (``make_pool(config, seed)``);
- ``metrics/<metric>.py``: ``read(run)`` returns the metric's value, or
  None where the run has nothing for it to read.
"""

from __future__ import annotations

import importlib.util
import json
import os

PACKAGE = os.path.dirname(os.path.abspath(__file__))


def benchmark_path(root: str | None = None) -> str:
    return os.path.join(root or os.path.dirname(PACKAGE), "BENCHMARK.json")


def _module(kind: str, name: str, package: str):
    path = os.path.join(package, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    spec = importlib.util.spec_from_file_location(f"kpwbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(kind: str, name: str, package: str) -> dict:
    path = os.path.join(package, kind, name + ".json")
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with its pieces loaded."""

    def __init__(self, name: str, bench: dict, package: str = PACKAGE) -> None:
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; there are {sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        self.chips = self.workload["chips"]
        self.config = _json("configs", self.workload["config"], package)
        self.traffic = _json("traffic", self.workload["traffic"], package)
        self.generator = _module("generators", self.config["generator"], package)

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if m["moves"] in moved and mine(m)]
        self.readers = {m["name"]: _module("metrics", m["name"], package)
                        for m in self.end_to_end + self.per_layer}


def load(name: str, root: str | None = None, package: str = PACKAGE) -> Cell:
    with open(benchmark_path(root)) as f:
        return Cell(name, json.load(f), package)
