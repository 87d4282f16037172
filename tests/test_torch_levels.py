"""Port level encoding (kpw_tpu_torch.ops.levels, the run helpers of
ops.packing and the pack kernel's run count), run here on the CPU with the
plain versions: every output equal to the JAX package's function on the
same numpy inputs, exactly.  Also pins the Order shredding of
``chip_smoke.py`` (the port's ProtoColumnarizer over its wire bytes) to
the JAX package's ProtoColumnarizer."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kpw_tpu.core import encodings as enc
from kpw_tpu.ops import levels as JL
from kpw_tpu.ops import packing as JP
from kpw_tpu_torch.ops import levels as TL
from kpw_tpu_torch.ops import packing as TP
from kpw_tpu_torch.ops.bitpack import pack_pages, run_stats

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pattern(rng, name: str, n: int) -> np.ndarray:
    if name == "runny":
        return np.repeat(rng.integers(0, 3, n // 20 + 1), 20)[:n]
    if name == "random":
        return rng.integers(0, 4, n)
    if name == "alternating":
        return np.tile([0, 1], n // 2 + 1)[:n]
    # mostly max level with rare nulls: the common def-level stream
    return (rng.random(n) > 0.02).astype(np.int64)


def _pages():
    """(stream, start, count) windows: whole, ragged, unaligned, empty,
    single, and one running past the stream's end."""
    return [(0, 0, 1000), (1, 0, 999), (2, 3, 700), (3, 17, 0), (0, 5, 1),
            (1, 250, 750), (2, 900, 600), (3, 1, 998)]


@pytest.mark.parametrize("pattern", ["runny", "random", "alternating", "nullable"])
def test_level_stats_and_runs_equal_jax(pattern):
    rng = np.random.default_rng(len(pattern))
    stacked = np.stack([_pattern(rng, pattern, 1000) for _ in range(4)]).astype(np.uint32)
    sid, st, ct = (np.array(x, np.int32) for x in zip(*_pages()))
    bucket = 1024
    j_long, j_runs = JL.level_stats_multi(
        jnp.asarray(stacked), jnp.asarray(sid), jnp.asarray(st), jnp.asarray(ct),
        bucket)
    lv = torch.from_numpy(stacked.astype(np.int32))
    t_long, t_runs, packed = TL.level_stats_multi(lv, sid, st, ct, bucket, 2)
    np.testing.assert_array_equal(t_long.numpy(), np.asarray(j_long))
    np.testing.assert_array_equal(t_runs.numpy(), np.asarray(j_runs))
    # the packed bytes of phase A are the JAX package's phase-B pack
    j_packed = JP.pack_pages_only(jnp.asarray(stacked), jnp.asarray(sid),
                                  jnp.asarray(st), jnp.asarray(ct), bucket, 2)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(j_packed))
    run_bucket = TP.pad_bucket(int(t_runs.max()))
    j_vals, j_lens = JL.level_runs_multi(
        jnp.asarray(stacked), jnp.asarray(sid), jnp.asarray(st), jnp.asarray(ct),
        bucket, run_bucket, 2)
    t_vals, t_lens = TL.level_runs_multi(lv, sid, st, ct, bucket, run_bucket)
    np.testing.assert_array_equal(t_vals.numpy(), np.asarray(j_vals).astype(np.int32))
    np.testing.assert_array_equal(t_lens.numpy(), np.asarray(j_lens))
    # and the runs replay to the oracle's stream
    for p, (s, a, c) in enumerate(_pages()):
        window = np.zeros(c, np.uint32)  # reads past the stream give 0
        part = stacked[s, a:a + c]
        window[:len(part)] = part
        k = int(t_runs[p])
        if c:
            assert enc.rle_hybrid_from_runs(
                t_vals[p, :k].numpy().astype(np.uint64), t_lens[p, :k].numpy(),
                2) == enc.rle_hybrid_from_runs(*enc._runs(window.astype(np.uint64)), 2)


def _fuzz_windows():
    """The windowed-shift fuzz of the JAX package's level tests: run
    lengths straddling the >= 8 threshold, empty and full windows, ragged
    valid prefixes."""
    rng = np.random.default_rng(17)
    cases = []
    for lens_pool in ([1], [7], [8], [9], [7, 8], [1, 8, 20], [3, 30]):
        lens, total = [], 0
        while total < 600:
            ln = int(rng.choice(lens_pool))
            lens.append(ln)
            total += ln
        vals = rng.integers(0, 3, len(lens))
        vals[1::2] = vals[1::2] + 4  # adjacent runs differ
        cases.append(np.repeat(vals, lens)[:600])
    cases.append(np.zeros(0, np.int64))
    out = []
    for lv in cases:
        for count in sorted({len(lv), min(len(lv), 123), min(len(lv), 599)}):
            out.append((lv, count))
    return out


def test_run_stats_and_pack_n_runs_equal_jax_windowed_fuzz():
    bucket = 1024
    windows = _fuzz_windows()
    v = np.zeros((len(windows), bucket), np.uint32)
    valid = np.zeros((len(windows), bucket), bool)
    for r, (lv, count) in enumerate(windows):
        v[r, :count] = lv[:count]
        valid[r, :count] = True
    tv, tvalid = torch.from_numpy(v.astype(np.int32)), torch.from_numpy(valid)
    t_long, t_runs = run_stats(tv, tvalid)
    counts = [count for _, count in windows]
    _, p_long, p_runs = pack_pages(tv, TP.page_table(range(len(windows)), [0] * len(windows),
                                                     counts, "cpu"),
                                   bucket, 3, n_runs=True)
    for r, (lv, count) in enumerate(windows):
        j_long, j_runs, j_any = JP._run_long_stats(jnp.asarray(v[r]), jnp.asarray(valid[r]))
        assert int(t_long[r]) == int(p_long[r]) == int(j_long), (lv[:20], count)
        assert int(t_runs[r]) == int(p_runs[r]) == int(j_runs)
        assert bool(t_long[r] > 0) == bool(j_any)


def test_run_scan_and_window_run_scan_equal_jax():
    rng = np.random.default_rng(3)
    stacked = np.stack([_pattern(rng, p, 1000) for p in
                        ("runny", "random", "alternating", "nullable")]).astype(np.uint32)
    padded = jnp.pad(jnp.asarray(stacked), ((0, 0), (0, 1024)))
    table = TP.page_table(*zip(*_pages()), "cpu")
    got = TP.window_run_scan(torch.from_numpy(stacked.astype(np.int32)), table, 1024)
    scan = jax.jit(JP.window_run_scan, static_argnums=4)
    valid = torch.zeros((len(_pages()), 1024), dtype=torch.bool)
    for p, (s, a, c) in enumerate(_pages()):
        v, j_valid, run_id, _, is_end = scan(padded, s, a, c, 1024)
        valid[p] = torch.from_numpy(np.array(j_valid))
        # the port returns what the level path reads: v, run_id, is_end
        for g, w in zip(got, (v, run_id, is_end)):
            np.testing.assert_array_equal(g[p].numpy(), np.asarray(w).astype(g.numpy().dtype))
    v = got[0]
    newrun, run_id, _, _, is_end = JP._run_scan(
        jnp.asarray(v[2].numpy().astype(np.uint32)), jnp.asarray(valid[2].numpy()))
    for g, w in zip(TP.run_scan(v, valid), (newrun, run_id, is_end)):
        np.testing.assert_array_equal(g[2].numpy(), np.asarray(w).astype(g.numpy().dtype))


def test_compact_by_rank_equals_jax_scatter_branch():
    rng = np.random.default_rng(33)
    n, out = 512, 128
    for _ in range(5):
        m = int(rng.integers(0, out + 1))
        rank = np.full(n, out, np.int32)
        rank[np.sort(rng.choice(n, size=m, replace=False))] = np.arange(m)
        vals = rng.integers(0, 1 << 30, n).astype(np.int32)
        lens = rng.integers(1, 100, n).astype(np.int32)
        want = JP.compact_by_rank(jnp.asarray(rank), (jnp.asarray(vals), jnp.asarray(lens)),
                                  out, scatters=True)
        got = TP.compact_by_rank(torch.from_numpy(rank)[None],
                                 (torch.from_numpy(vals)[None], torch.from_numpy(lens)[None]),
                                 out)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
        (single,) = TP.compact_by_rank(torch.from_numpy(rank), (torch.from_numpy(vals),),
                                       out)
        np.testing.assert_array_equal(single.numpy(), np.asarray(want[0]))


def test_pack_pages_only_equals_jax():
    rng = np.random.default_rng(8)
    idx = rng.integers(0, 1 << 7, (3, 3000)).astype(np.uint32)
    rows, starts, counts = [0, 1, 2, 1], [0, 5, 1001, 2999], [3000, 2048, 1000, 1]
    want = JP.pack_pages_only(jnp.asarray(idx), *(jnp.asarray(np.array(x, np.int32))
                                                   for x in (rows, starts, counts)),
                              4096, 7)
    got = TP.pack_pages_only(torch.from_numpy(idx.astype(np.int32)), rows, starts,
                             counts, 4096, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chip_smoke_order_shredder_equals_proto_columnarizer():
    """The smoke run's ``nested`` path shreds config 5's orders with the
    port's ``ProtoColumnarizer`` (its fused nested route) from the wire
    bytes ``chip_smoke.order_payloads`` writes, through the descriptor
    stand-in ``chip_smoke.order_class``; on the same orders the JAX
    ProtoColumnarizer gives the same schema, values and rep/def levels."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import chip_smoke
    from kpw_tpu.models import ProtoColumnarizer, proto_to_schema
    from kpw_tpu_torch.models import ProtoColumnarizer as PortColumnarizer
    from kpw_tpu_torch.models import proto_to_schema as port_proto_to_schema
    from proto_helpers import nested_message_classes

    Order = nested_message_classes()
    rng = np.random.default_rng(2)
    order_id, n_items, sku, qty = chip_smoke.order_rows(rng, 600)
    msgs, at = [], 0
    for oid, k in zip(order_id, n_items):
        o = Order()
        o.order_id = int(oid)
        for _ in range(int(k)):
            it = o.items.add()
            it.sku = sku[at].decode()
            it.qty = int(qty[at])
            at += 1
        msgs.append(o)
    jschema = proto_to_schema(Order)
    want = ProtoColumnarizer(Order, jschema).columnarize(msgs)
    stand_in = chip_smoke.order_class()
    pschema = port_proto_to_schema(stand_in)
    got = PortColumnarizer(stand_in, pschema).columnarize_payloads(
        chip_smoke.order_payloads(order_id, n_items, sku, qty))

    def fields(f):
        return (f.name, f.repetition, f.physical_type, f.converted_type,
                f.type_length, f.field_id, [fields(c) for c in f.children])

    assert fields(pschema.root) == fields(jschema.root)
    assert got.num_rows == want.num_rows == 600
    for g, w in zip(got.chunks, want.chunks):
        assert g.column.path == w.column.path
        assert (g.column.max_def, g.column.max_rep) == (w.column.max_def, w.column.max_rep)
        assert g.num_rows == w.num_rows
        for a, b in ((g.def_levels, w.def_levels), (g.rep_levels, w.rep_levels)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        if isinstance(w.values, np.ndarray):
            np.testing.assert_array_equal(g.values, w.values)
        else:
            assert list(g.values) == list(w.values)
