"""The harness on the CPU: each cell at a tiny size through
``encoder_backend("cuda", device="cpu")`` (a path the measuring runs never
take), the planted faults, pieces found by name, and the import rules."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from kpwbench import faults, harness, run, spec

ROOT = os.path.dirname(spec.PACKAGE)
CELLS = ("taxi64.catchup", "replay12.live")
# The live cell's entries, kept out of BENCHMARK.json until its runs spread
# less (PERF.md, Open questions); its files are in place and tested here.
LIVE = {
    "workloads": [{"name": "replay12.live", "config": "replay12", "traffic": "live",
                   "chips": 1, "why": "open loop at a fixed rate, 4 threads, 0.5 s rotation"}],
    "end_to_end": [{"name": "ack_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
                    "source": "host_clock", "workloads": ["replay12.live"]}],
    "per_layer": [{"name": f"{m}.live", "unit": u, "better": "lower", "source": "program_span",
                   "layer": layer, "moves": "ack_p95_ms", "workloads": ["replay12.live"]}
                  for m, u, layer in (("encode.ms_per_rowgroup", "ms/rowgroup", "encoder"),
                                      ("publish.ms_per_file", "ms/file", "runtime and sink"))],
}


def bench_with_live():
    bench = json.loads(open(spec.benchmark_path()).read())
    for key, entries in LIVE.items():
        bench[key] += entries
    return bench


def tiny(name, bench=None, package=spec.PACKAGE):
    """The cell with files of 2 MiB, row groups of 1 MiB, a small pool and a
    load the CPU keeps up with."""
    cell = spec.Cell(name, bench or bench_with_live(), package)
    cell.config.update(block_size=1 << 20, max_file_size=2 << 20, pool_records=8192)
    cell.config.get("check", {}).update(sample_rows=5000)
    if cell.traffic["mode"] == "backlog":
        cell.traffic.update(lead_records=64_000, chunk_records=2_000)
    else:
        cell.traffic.update(rate_per_s=20_000, warmup_s=1.0)
    return cell


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_is_correct_and_reports_its_metrics(name, trace):
    cell = tiny(name)
    r = harness.run_cell(cell, 2**33 + 17, 2.0, bool(trace), device="cpu",
                         log=lambda m: None)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert all(c["value"] == 0 for c in r["checks"].values())
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    if trace:  # no device trace on the CPU: the device readers find nothing
        want -= {"device.idle_share", "bitpack.roofline"}
        assert r["device"]["busy_s"] == 0 and r["breakdown"]["device_ops"] == []
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())


@pytest.mark.parametrize("fault", faults.NAMES)
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_reads_not_correct(name, fault):
    r = harness.run_cell(tiny(name), 2**32 + 3, 1.5, False, device="cpu",
                         fault=faults.plant(fault), log=lambda m: None)
    assert not r["correct"], (fault, r["checks"])


def test_a_new_configuration_mix_and_metric_are_found_by_name(tmp_path):
    pkg = tmp_path / "kpwbench"
    shutil.copytree(spec.PACKAGE, pkg, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((pkg / "configs" / "replay12.json").read_text())
    cfg.update(name="replay6", schema=cfg["schema"][:4] + cfg["schema"][8:10])
    cfg["check"]["key_columns"] = ["s0", "s1"]
    (pkg / "configs" / "replay6.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "slow.json").write_text(json.dumps(
        {"mode": "open_loop", "rate_per_s": 5000, "interval_ms": 2}))
    (pkg / "metrics" / "files_per_s.py").write_text(
        "def read(run):\n    return len(run.files) / (run.w1 - run.w0)\n")
    bench = bench_with_live()
    bench["workloads"].append({"name": "replay6.slow", "config": "replay6",
                               "traffic": "slow", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "files_per_s", "unit": "files/s", "better": "higher",
                               "source": "host_clock", "layer": "runtime and sink",
                               "moves": "ack_p95_ms", "workloads": ["replay6.slow"]})
    for m in bench["end_to_end"]:
        if m["name"] == "ack_p95_ms":
            m["workloads"].append("replay6.slow")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = tiny("replay6.slow", json.loads((tmp_path / "BENCHMARK.json").read_text()), str(pkg))
    assert [f["name"] for f in cell.config["schema"]] == ["i0", "i1", "i2", "i3", "s0", "s1"]
    assert [m["name"] for m in cell.per_layer] == ["files_per_s"]
    r = harness.run_cell(cell, 7, 1.5, True, device="cpu", log=lambda m: None)
    assert r["correct"], r["checks"]
    assert r["metrics"]["files_per_s"]["value"] > 0


def test_the_broker_serves_each_partition_the_pool_records_in_order():
    from kpwbench import broker

    cell = tiny("taxi64.catchup")
    pool = cell.generator.make_pool(cell.config, 5)
    b = broker.make(pool, "t")
    b.create_topic("t", cell.config["partitions"])
    assert b.append(3, 9000) == 0 and b.append(3, 100) == 9000  # past the pool's end
    got, off = [], 0
    while (rb := b.fetch_batch("t", 3, off, 2000)) is not None:
        assert rb.start_offset == off and len(rb) <= 2000
        got += [rb.payload_at(i) for i in range(len(rb))]
        off += len(rb)
    assert off == b.end_offset("t", 3) == 9100 and got == pool.records(3, 0, 9100)
    assert [r.value for r in b.fetch("t", 3, 6560, 200)] == pool.records(3, 6560, 96)
    assert b.fetch_batch("t", 4, 0) is None


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    base = os.path.join(spec.PACKAGE, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imports(path)) & {"jax", "jaxlib", "flax", "kpw_tpu"}
        assert not bad, (path, bad)


@pytest.mark.parametrize("sub", ["reference", "generators"])
def test_the_reference_and_the_generators_import_nothing_of_the_program(sub):
    for path in _sources(sub):
        assert "kpw_tpu_torch" not in set(_imports(path)), path


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "kpw_tpu_torch_x", sys)
    assert "kpw_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "kpw_tpu.ops", sys)
    assert run.forbidden_modules() == ["kpw_tpu"]


def test_the_command_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "-m", "kpwbench.run", "--workload", "taxi64.catchup",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and "{" not in p.stdout


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    p = subprocess.run([sys.executable, "-m", "kpwbench.run", "--workload", "taxi64.catchup",
                        "--seed", str(2**31 + 11), "--seconds", "3", "--trace", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0


def test_every_piece_benchmark_json_names_is_a_file():
    bench = json.load(open(spec.benchmark_path()))
    assert bench["paths"] == ["kpwbench"]
    for c in bench["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and set(c["reduced"]) == set(cfg["reduced_from"])
        assert os.path.isfile(os.path.join(spec.PACKAGE, "generators", cfg["generator"] + ".py"))
    for w in bench["workloads"]:
        cell = spec.load(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(os.path.join(spec.PACKAGE, "metrics", m["name"] + ".py"))
