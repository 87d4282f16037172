"""The smoke run's native phase, writer paths, string probe and stream
phase (``chip_smoke.py``), rehearsed here on the CPU at their small sizes
with ``device="cpu"``: every check the card run makes on a path holds here
too (all four files byte-identical, every ``CudaChunkEncoder`` and
``NativeChunkEncoder`` column chunk through the native assembler, no
level page replayed in Python, the path's device routes called, its pack
and delta jobs equal to their plain versions on its own inputs; every
stream arm drained with ack-lag 0 and its files verified, the
deterministic arm's files byte-identical across encoders)."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

SETUPS = chip_smoke.SETUPS


def test_native_phase():
    chip_smoke.phase_native(*chip_smoke.start_native_build())


@pytest.mark.parametrize("path", sorted(SETUPS))
def test_writer_path(path):
    groups, schema, props = SETUPS[path](small=True)
    calls, recorded, rates = chip_smoke.writer_path(path, groups, schema, props,
                                                    device="cpu")
    assert set(rates) == {key for key, _, _, _ in chip_smoke.WRITERS}
    if path == "strings":  # two card files, four string columns a row group
        assert calls["string_columns"] == 2 * 4 * len(groups)
        assert calls["string_pack_jobs"] >= 2 * len(groups)
    if path in ("levels", "nested"):
        assert calls["level_runs_multi"] > 0 and calls["level_blob_replays"] == 0
    if path in chip_smoke.DELTA_RINGS:  # one delta launch per ring a row group
        assert calls["delta_page_streams"] == \
            chip_smoke.DELTA_RINGS[path] * 2 * len(groups)
    errors = chip_smoke.check_path_inputs(torch, path, recorded)
    assert errors == {"bitpack": 0, "delta": 0}
    assert any(recorded[f] for f in chip_smoke.RECORDED)


def test_string_probe():
    inputs = {name: SETUPS[name](small=True) for name in ("strings", "encodings")}
    chip_smoke.string_probe(torch, inputs, device="cpu")


def test_stream_phase():
    """The stream phase at its rehearsal size (20,000 records) on the CPU:
    every arm drains with ack-lag 0 and verified files, and the
    deterministic arm's files are byte-identical across encoders; CPU
    tensors launch no kernel."""
    from kpw_tpu_torch.ops.bitpack import pack_pages
    from kpw_tpu_torch.ops.delta import delta_page_streams
    from kpw_tpu_torch.ops.rank import hist_dict, rank_pages

    counters = {"bitpack": pack_pages, "hist": hist_dict, "rank": rank_pages,
                "delta": delta_page_streams}
    launches = chip_smoke.phase_stream(torch, counters, small=True, device="cpu")
    assert launches == dict.fromkeys(counters, 0)


def test_mesh_phase():
    """The mesh phase at its rehearsal size on 8 CPU shards: config 4's
    step on both routes equal to the numpy oracle and to itself, the
    writer route's file equal to ``CpuChunkEncoder``'s with the expected
    routes, and the recorded hist / rank inputs replayed against the plain
    versions; CPU tensors launch no kernel."""
    from kpw_tpu_torch.ops.bitpack import pack_pages
    from kpw_tpu_torch.ops.delta import delta_page_streams
    from kpw_tpu_torch.ops.rank import hist_dict, rank_pages

    counters = {"bitpack": pack_pages, "hist": hist_dict, "rank": rank_pages,
                "delta": delta_page_streams}
    before = {k: f.launches for k, f in counters.items()}
    out = chip_smoke.mesh_path(torch, counters, small=True, device="cpu")
    # one hist and one rank call a shard of each bounded step
    assert len(out["recorded"]["hist_pages"]) == len(out["recorded"]["rank_pages"]) == \
        chip_smoke.CFG4_SHARDS + 1 + 2 * chip_smoke.CFG4_GROUPS * chip_smoke.CFG4_SHARDS
    assert chip_smoke.check_mesh_inputs(torch, out["recorded"]) == {"hist": 0, "rank": 0}
    assert {k: f.launches for k, f in counters.items()} == before
