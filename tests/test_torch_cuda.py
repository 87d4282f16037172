"""The port's CUDA kernels and device paths on the card, each held against
its plain PyTorch version (or the CPU encoder) exactly.

Marked ``cuda``: every test skips, with the reason, where no card is
available.  On a machine with a card and the CUDA toolkit (no JAX needed),
from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import io

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _t(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32)).to(dev)


@pytest.mark.parametrize("bucket", [256, 12288])
@pytest.mark.parametrize("width", [1, 3, 8, 13, 16, 31, 32])
def test_bitpack_kernel_equals_plain(card, width, bucket):
    from kpw_tpu_torch.ops.bitpack import bitpack_pages, bitpack_pages_plain, pack_pages

    rng = np.random.default_rng(width * bucket)
    vals = rng.integers(0, 1 << width, (3, bucket), dtype=np.uint64)
    vals[:, ::5] |= np.uint64(1 << (width - 1))
    pages = _t(vals.astype(np.uint32), card)
    before = pack_pages.launches
    got = bitpack_pages(pages, width)
    assert pack_pages.launches == before + 1
    assert torch.equal(got, bitpack_pages_plain(pages, width))


@pytest.mark.parametrize("width", [1, 2, 3, 7, 8, 9, 12, 13, 16, 20, 31, 32])
def test_fused_pack_kernel_equals_plain(card, width):
    """Windows of 16,384 values (four spans of the kernel's blocks) that
    start unaligned, run past ``ld``, hold counts of 0 / 1 / 7 / 9 /
    ragged, and runs of 8..40 equal values across the span edges."""
    from kpw_tpu_torch.ops.bitpack import pack_pages, pack_pages_plain

    rng = np.random.default_rng(100 + width)
    C, ld, bucket = 4, 40_003, 16_384
    vals = rng.integers(0, 1 << width, (C, ld), dtype=np.uint64).astype(np.uint32)
    vals[0, ::7] |= np.uint32(0x8000_0000)  # bits above the width are ignored
    pos = 0
    while pos < ld:  # column 1: runs of 1..40 equal values everywhere
        n = int(rng.integers(1, 41))
        vals[1, pos:pos + n] = rng.integers(0, 1 << width, dtype=np.uint64)
        pos += n
    for edge in range(4096 - 20, ld, 4096):  # column 2: runs across span edges
        vals[2, edge:edge + 8 + edge % 33] = 3
    table = np.array([
        [0, 0, 16_384], [1, 1, 16_383], [2, 3, 0], [2, 5, 1], [1, 4090, 7],
        [2, 9, 9], [3, 37, 12_345], [1, 30_001, 16_384],  # past ld
        [0, 40_003, 100], [2, 4093, 16_000], [1, 17, 4096 + 8]], np.int32)
    idx = _t(vals, card)
    tab = torch.from_numpy(table).to(card)
    before = pack_pages.launches
    got_p, got_l, _ = pack_pages(idx, tab, bucket, width)
    assert pack_pages.launches == before + 1
    want_p, want_l, _ = pack_pages_plain(idx, tab, bucket, width)
    assert torch.equal(got_p, want_p)
    assert torch.equal(got_l, want_l)
    # no table: rows 0..3 from start 0, one count for all, by value and
    # as a device tensor
    want = pack_pages_plain(idx, None, bucket, width, True, 9_999)
    for count in (9_999, torch.tensor(9_999, device=card)):
        got = pack_pages(idx, None, bucket, width, True, count)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # an empty page table launches nothing and counts nothing
    before = pack_pages.launches
    empty = pack_pages(idx, tab[:0], bucket, width)
    assert empty[0].shape == (0, bucket * width // 8) and empty[1].shape == (0,)
    assert pack_pages.launches == before


@pytest.mark.parametrize("width", [1, 2, 3, 13, 32])
def test_pack_kernel_n_runs_equals_plain(card, width):
    """The optional run count beside long_sum, on unaligned, ragged and
    past-ld windows; with n_runs off the outputs are the same as before."""
    from kpw_tpu_torch.ops.bitpack import pack_pages, pack_pages_plain

    rng = np.random.default_rng(200 + width)
    C, ld, bucket = 3, 20_011, 8_192
    vals = np.zeros((C, ld), np.uint32)
    for c in range(C):
        pos = 0
        while pos < ld:
            n = int(rng.integers(1, 3 + 20 * c))
            vals[c, pos:pos + n] = rng.integers(0, 1 << width, dtype=np.uint64)
            pos += n
    table = torch.tensor([
        [0, 0, 8_192], [1, 3, 8_000], [2, 5, 0], [0, 7, 1], [1, 4090, 9],
        [2, 17, 4104], [0, 15_000, 8_192], [1, 20_011, 50], [2, 4093, 8_191]],
        dtype=torch.int32, device=card)
    idx = _t(vals, card)
    got = pack_pages(idx, table, bucket, width, n_runs=True)
    want = pack_pages_plain(idx, table, bucket, width, n_runs=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got = pack_pages(idx, table, bucket, width, stats=False, n_runs=True)
    assert got[1] is None and torch.equal(got[2], want[2])
    packed, long_sum, runs = pack_pages(idx, table, bucket, width)
    assert torch.equal(packed, want[0]) and torch.equal(long_sum, want[1])
    assert runs is None


def _delta_streams(rng, bit_size):
    """Rows for the delta kernel: wraparound edges, one per width bucket,
    zero deltas, a random walk."""
    itype = np.int64 if bit_size == 64 else np.int32
    info = np.iinfo(itype)
    ld = 1_500
    rows = [np.resize(np.array([0, info.max, info.min, 17, -1, info.max,
                                info.min + 1], itype), ld),
            np.full(ld, -5, itype),
            np.cumsum(rng.integers(0, 9, ld)).astype(itype)]
    for bits in (5, 12, 20, 28, 40, 60):
        if bits < bit_size:
            rows.append((rng.integers(0, 1 << bits, ld) - (1 << (bits - 1))).astype(itype))
    rows.append(rng.integers(info.min, info.max, ld, dtype=itype, endpoint=True))
    return np.stack(rows)


def _same_streams(got, want):
    """Two ``delta_page_streams`` results agree: offsets, width flag, and
    the bytes written (those below the capacity)."""
    from kpw_tpu_torch.ops.delta import stream_bytes

    assert torch.equal(got[1].cpu(), want[1].cpu())
    assert torch.equal(got[2].cpu(), want[2].cpu())
    assert torch.equal(stream_bytes(*got[:2]).cpu(), stream_bytes(*want[:2]).cpu())


@pytest.mark.parametrize("bit_size", [32, 64])
@pytest.mark.parametrize("max_bits", [8, 16, 24, 32, 48, 64])
def test_delta_kernel_equals_plain(card, bit_size, max_bits):
    """Both rings, every width bucket (widths above the budget flagged and
    the streams cut at the capacity the same way), counts 0/1/2/127/128/
    129 and ragged, starts past the row's end."""
    from kpw_tpu_torch.ops.delta import delta_page_streams, delta_page_streams_plain

    if max_bits > bit_size:
        pytest.skip("the 32-bit ring has no budget above 32")
    rng = np.random.default_rng(bit_size + max_bits)
    streams = torch.from_numpy(_delta_streams(rng, bit_size)).to(card)
    rows, ld = streams.shape
    table = np.array(
        [[r, s, c] for r in range(rows)
         for s, c in ((0, 1024), (1, 2), (3, 127), (5, 128), (7, 129), (11, 0),
                      (13, 1), (700, 1000), (1490, 300), (ld, 5))], np.int32)
    before = delta_page_streams.launches
    got = delta_page_streams(streams, table, bit_size, max_bits)
    assert delta_page_streams.launches == before + 1
    _same_streams(got, delta_page_streams_plain(streams, table, bit_size, max_bits))


@pytest.mark.parametrize("bit_size", [32, 64])
def test_delta_lookback_more_blocks_than_resident(card, bit_size):
    """64 pages of 1,024 blocks (65,536 blocks, far more than the card
    keeps resident) and pages of 1 to 1,024 blocks: the single-pass
    look-back equals the plain version, and a staged launch runs once."""
    from kpw_tpu_torch.ops.delta import (DeltaLaunch, delta_page_streams,
                                         delta_page_streams_plain)

    rng = np.random.default_rng(70 + bit_size)
    itype = np.int64 if bit_size == 64 else np.int32
    n = 1024 * 128 + 1
    streams = torch.from_numpy(np.stack([
        np.cumsum(rng.integers(-2, 60, n + 5_000)).astype(itype),
        (rng.integers(0, 1 << 20, n + 5_000) - (1 << 19)).astype(itype)])).to(card)
    for table in (np.array([[p % 2, (37 * p) % 5_000, n] for p in range(64)]),
                  np.array([[p % 2, p, 1 + 128 * b] for p, b in
                            enumerate((1, 2, 3, 7, 64, 100, 513, 1000, 1024))])):
        want = delta_page_streams_plain(streams, table, bit_size, 24)
        _same_streams(delta_page_streams(streams, table, bit_size, 24), want)
        staged = DeltaLaunch(streams, table, bit_size, 24)
        _same_streams(staged.run(), want)
        with pytest.raises(RuntimeError, match="runs once"):
            staged.run()


@pytest.mark.parametrize("C", [5, 64])
@pytest.mark.parametrize("nhi", [8, 128])
def test_hist_dict_kernel_equals_plain(card, nhi, C):
    """hist + dictionary across both ranks of each column's cluster:
    columns with 1..8 distinct values, a ragged count (int and device
    tensor), values at or above the bound, ulo narrower and wider than
    nhi*64 (the pad written to its end)."""
    from kpw_tpu_torch.ops import rank

    rng = np.random.default_rng(nhi + C)
    vb = nhi * 64
    N, count = 8192 + 128, 8192 - 77
    vals = rng.integers(0, vb, (C, N)).astype(np.uint32)
    for c in range(1, C):
        vals[c] = rng.choice(rng.choice(vb, size=c % 8 + 1, replace=False), N)
    vals[:, 5] = vb + 12345
    vals[:, 6] = 0xFFFF_FFFF
    lo = _t(vals, card)
    before = rank.hist_dict.launches
    for cnt, cols in ((count, None), (torch.tensor(count, device=card), N),
                      (N, 100)):
        got = rank.hist_dict(lo, cnt, nhi, ulo_cols=cols)
        want = rank.hist_dict_plain(lo, cnt, nhi, ulo_cols=cols)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert rank.hist_dict.launches == before + 3


@pytest.mark.parametrize("nhi", [8, 32, 128])
def test_hist_and_rank_kernels_equal_plain(card, nhi):
    from kpw_tpu_torch.ops import rank

    rng = np.random.default_rng(nhi)
    vb = nhi * 64
    vals = rng.integers(0, vb, (4, 2048)).astype(np.uint32)
    vals[:, 2000:] = vb
    vals[:, 7] = 0xFFFF_FFFF
    lo = _t(vals, card)
    counts = rank.hist_pages(lo, nhi)
    assert torch.equal(counts, rank.hist_pages_plain(lo, nhi))
    rt, _, _ = rank.presence_to_dict(counts, nhi)
    assert torch.equal(rank.rank_pages(lo, rt), rank.rank_pages_plain(lo, rt))


@pytest.mark.parametrize("bound", [None, 300, 1 << 13])
def test_flagship_step_card_equals_cpu(card, bound):
    from kpw_tpu_torch.parallel.sharded import encode_step_single

    rng = np.random.default_rng(3)
    lo = torch.from_numpy(rng.integers(0, bound or 5000, (8, 4096)).astype(np.int32))
    got = encode_step_single(lo.to(card), 4000, value_bound=bound)
    want = encode_step_single(lo, 4000, value_bound=bound)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("pipeline", [False, True])
def test_writer_card_equals_cpu_encoder(card, pipeline):
    import dataclasses

    from kpw_tpu_torch.core import (ParquetFileWriter, Schema, WriterProperties,
                                    columns_from_arrays, leaf)
    from kpw_tpu_torch.core.pages import CpuChunkEncoder
    from kpw_tpu_torch.ops.backend import CudaChunkEncoder

    rng = np.random.default_rng(5)
    n = 20000
    arrays = {"a": rng.integers(0, 100, n).astype(np.int64),
              "b": rng.integers(1, 266, n).astype(np.int32),
              "c": (rng.integers(0, 3000, n) * 420).astype(np.int64),
              "d": rng.choice(rng.normal(size=40), n),
              "r": np.repeat(np.arange(n // 400, dtype=np.int64), 400)}
    schema = Schema([leaf(k, {"int64": "int64", "int32": "int32",
                              "float64": "double"}[str(v.dtype)])
                     for k, v in arrays.items()])
    props = WriterProperties(data_page_size=32 * 1024)

    def write(encoder, pipeline=False):
        # pipelined: row_group_size=1 makes every batch its own row group,
        # as the sequential writer's flush_row_group does
        p = dataclasses.replace(props, row_group_size=1) if pipeline else props
        buf = io.BytesIO()
        w = ParquetFileWriter(buf, schema, p, encoder=encoder, pipeline=pipeline)
        for half in (slice(0, n // 2), slice(n // 2, n)):
            w.write_batch(columns_from_arrays(
                schema, {k: v[half] for k, v in arrays.items()}))
            if pipeline:
                w.maybe_flush_row_group()
            else:
                w.flush_row_group()
        w.close()
        return buf.getvalue()

    assert write(CudaChunkEncoder(props.encoder_options()), pipeline) == \
        write(CpuChunkEncoder(props.encoder_options()))


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("cardinality", ["low", "high"])
def test_traced_row_group_carries_its_transfers_and_device_time(card, pipeline,
                                                                 cardinality):
    """With a span recorder installed, each row group's launch (pipelined)
    or whole-encode span carries the bytes it moved each way and the
    stream's time between its CUDA events; the file is unchanged.  With
    high cardinality every dictionary is rejected, so sync 2 reads nothing
    back from the card."""
    from kpw_tpu_torch.core import (ParquetFileWriter, Schema, WriterProperties,
                                    columns_from_arrays, leaf)
    from kpw_tpu_torch.ops.backend import CudaChunkEncoder
    from kpw_tpu_torch.utils import tracing

    rng = np.random.default_rng(9)
    n = 40000
    if cardinality == "low":
        arrays = {"a": rng.integers(0, 100, n).astype(np.int64),
                  "b": rng.integers(1, 266, n).astype(np.int32)}
        schema = Schema([leaf("a", "int64"), leaf("b", "int32")])
        least_h2d = 3 * 4 * (n // 2)  # a's two 32-bit key halves, b's one
    else:  # unique ids and timestamps: far over the dictionary ratio
        arrays = {"id": rng.permutation(n).astype(np.int64) << 20,
                  "ts": 1_700_000_000_000 + np.cumsum(rng.integers(1, 9, n))}
        schema = Schema([leaf("id", "int64"), leaf("ts", "int64")])
        least_h2d = 2 * 4 * (n // 2)  # a 32-bit key a row, each column
    props = WriterProperties(row_group_size=1)  # a row group a batch

    def write():
        buf = io.BytesIO()
        w = ParquetFileWriter(buf, schema, props, pipeline=pipeline,
                              encoder=CudaChunkEncoder(props.encoder_options()))
        for half in (slice(0, n // 2), slice(n // 2, n)):
            w.write_batch(columns_from_arrays(schema, {k: v[half] for k, v in arrays.items()}))
        w.close()
        dictionary = [c.meta_data.dictionary_page_offset is not None
                      for rg in w._row_groups for c in rg.columns]
        return buf.getvalue(), dictionary

    plain, dictionary = write()
    assert all(dictionary) if cardinality == "low" else not any(dictionary)
    rec = tracing.SpanRecorder()
    tracing.set_span_recorder(rec)
    try:
        traced, _ = write()
    finally:
        tracing.set_span_recorder(None)
    assert traced == plain
    name = "rowgroup.launch" if pipeline else "rowgroup.encode"
    spans = [s for s in rec.snapshot() if s[0] == name]
    assert len(spans) == 2
    for s in spans:
        attrs = s[5]
        assert attrs["h2d_bytes"] >= least_h2d, attrs
        assert attrs["d2h_bytes"] > 0 and attrs["device_ms"] > 0, attrs
        assert 0 <= attrs.get("h2d_pinned_bytes", 0) <= attrs["h2d_bytes"]
        assert 0 <= attrs.get("d2h_pinned_bytes", 0) <= attrs["d2h_bytes"]


@pytest.mark.parametrize("path", ["writer", "levels", "nested", "encodings", "strings",
                                  "cfg3"])
def test_writer_paths_card_equal_cpu_encoder(card, path):
    """The smoke run's writer paths at a reduced depth: the card's files
    (row group by row group and through the pipeline) and the port's
    NativeChunkEncoder file equal the port's CpuChunkEncoder file, every
    card column chunk went through the native assembler with no level page
    replayed in Python, and the path launched its kernels."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from kpw_tpu_torch.ops.bitpack import pack_pages
    from kpw_tpu_torch.ops.delta import delta_page_streams

    groups, schema, props = chip_smoke.SETUPS[path](small=True)
    before = (pack_pages.launches, delta_page_streams.launches)
    calls, recorded, _ = chip_smoke.writer_path(path, groups, schema, props)
    assert calls["level_blob_replays"] == 0
    if path in ("encodings", "cfg3"):  # one launch per ring, two card files
        assert delta_page_streams.launches - before[1] == 2 * 2 * len(groups)
    else:
        assert pack_pages.launches > before[0]
    if path == "strings":
        assert calls["string_pack_jobs"] > 0
    assert chip_smoke.check_path_inputs(torch, path, recorded) == {"bitpack": 0, "delta": 0}


def test_string_planner_card_equals_cpu(card):
    """String dictionary columns (one nullable, one over the page budget,
    one of a single value) on the card: the planner's pack jobs launch the
    pack kernel and the file equals the port's CpuChunkEncoder file."""
    from kpw_tpu_torch.core import (ParquetFileWriter, Repetition, Schema,
                                    WriterProperties, columns_from_arrays, leaf)
    from kpw_tpu_torch.core.pages import CpuChunkEncoder
    from kpw_tpu_torch.ops import backend
    from kpw_tpu_torch.ops.backend import CudaChunkEncoder
    from kpw_tpu_torch.ops.bitpack import pack_pages

    rng = np.random.default_rng(6)
    n = 30_000
    pool = [b"cat_%03d" % j for j in range(150)]
    wide = [b"%0118x" % v for v in rng.integers(0, 1 << 62, n // 2)]
    schema = Schema([leaf("s", "string"), leaf("o", "string", Repetition.OPTIONAL),
                     leaf("w", "string"), leaf("c", "string")])
    arrays = {"s": [pool[k] for k in rng.integers(0, 150, n)],
              "o": ([pool[k] for k in rng.integers(0, 40, n)], rng.random(n) > 0.3),
              "w": [wide[k] for k in rng.integers(0, len(wide), n)],
              "c": [b"same"] * n}
    props = WriterProperties(data_page_size=16 * 1024)
    planners = []

    class Recording(backend._StringDictPlanner):
        def __init__(self, *args, **kwargs):
            before = pack_pages.launches
            super().__init__(*args, **kwargs)
            self.launches = pack_pages.launches - before  # its pack jobs
            planners.append(self)

    def write(encoder):
        buf = io.BytesIO()
        w = ParquetFileWriter(buf, schema, props, encoder=encoder)
        w.write_batch(columns_from_arrays(schema, arrays))
        w.close()
        return buf.getvalue()

    saved, backend._StringDictPlanner = backend._StringDictPlanner, Recording
    try:
        got = write(CudaChunkEncoder(props.encoder_options()))
    finally:
        backend._StringDictPlanner = saved
    assert got == write(CpuChunkEncoder(props.encoder_options()))
    (planner,) = planners
    assert {c.column.name for _, c, *_ in planner._items} == {"s", "o", "c"}
    assert [i for i, *_ in planner._rejected] == [2]
    assert planner.launches == len(planner._groups) > 0


@pytest.mark.parametrize("threads", [1, 3])
def test_streaming_builder_on_the_card(card, threads):
    """The streaming writer with the ``"cuda"`` encoder on the card: a
    4-partition topic of config 1's records drains to every offset
    committed with ack-lag 0 through ``threads`` workers, each encoder on
    a stream of its own; the pack kernel launches, and every published
    file verifies with the footers' rows summing to the records.  The
    deterministic arm's card files equal the ``"cpu"`` encoder's, file for
    file."""
    import os
    import sys
    import tempfile

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from kpw_tpu_torch import FakeBroker
    from kpw_tpu_torch.core import WriterProperties
    from kpw_tpu_torch.ops.backend import CudaChunkEncoder
    from kpw_tpu_torch.ops.bitpack import pack_pages

    opts = WriterProperties().encoder_options()
    a, b = CudaChunkEncoder(opts), CudaChunkEncoder(opts)
    assert a.stream != b.stream and a.stream != torch.cuda.current_stream()
    rows = 60_000
    payloads = chip_smoke.replay_payloads(rows)
    broker = FakeBroker()
    broker.create_topic("e2e", 4)
    broker.produce_many("e2e", payloads)
    before = pack_pages.launches
    with tempfile.TemporaryDirectory() as root:
        target = os.path.join(root, "card")
        w = chip_smoke.stream_builder(broker, "e2e", target, "cuda", threads,
                                      "cuda", "card").build()
        try:
            chip_smoke.drain(w, broker, "e2e", "card", 4, rows, deadline_s=120)
        finally:
            w.close(deadline=60)
        chip_smoke.published(target, rows, "card")
        files = {be: chip_smoke.deterministic_files(payloads, be, "cuda", root,
                                                    256 * 1024)
                 for be in ("cuda", "cpu")}
    assert pack_pages.launches > before
    n = min(len(files["cuda"]), len(files["cpu"]))
    assert n >= 2 and files["cuda"][:n] == files["cpu"][:n]


@pytest.mark.parametrize("n_shards", [1, 8])
@pytest.mark.parametrize("bound", [None, 300, 1 << 13])
def test_mesh_steps_card_equal_cpu(card, n_shards, bound):
    """Both mesh steps over shards on one card equal the same calls over
    CPU shards, ragged counts included; the bounded step launches the hist
    and rank kernels once a shard."""
    from kpw_tpu_torch.ops.rank import hist_dict, rank_pages
    from kpw_tpu_torch.parallel.mesh import make_mesh
    from kpw_tpu_torch.parallel.sharded import (sharded_encode_step,
                                                sharded_encode_step_bounded)

    rng = np.random.default_rng(n_shards + (bound or 0))
    per = 1024
    vals = rng.integers(0, bound or 100_000, (3, n_shards * per)).astype(np.int32)
    counts = rng.integers(0, per + 1, n_shards)
    counts[0] = per
    lo = torch.from_numpy(vals)
    outs = []
    for dev in (card, "cpu"):
        mesh = make_mesh(n_shards, device=dev)
        if bound is None:
            outs.append(sharded_encode_step(torch.zeros_like(lo), lo, counts, mesh=mesh,
                                            cap=per, width=20, has_hi=False))
        else:
            before = (hist_dict.launches, rank_pages.launches)
            outs.append(sharded_encode_step_bounded(lo, counts, mesh=mesh, width=16,
                                                    value_bound=bound))
            if dev is card:
                assert (hist_dict.launches - before[0],
                        rank_pages.launches - before[1]) == (n_shards, n_shards)
    for g, w in zip(*outs):
        assert torch.equal(g.cpu(), w)


def test_mesh_encoder_card_equals_cpu_encoder(card):
    """MeshChunkEncoder over 8 shards on one card writes the CpuChunkEncoder
    file, with the bounded, gather and string routes all taken."""
    from kpw_tpu_torch.core import (ParquetFileWriter, Schema, WriterProperties,
                                    columns_from_arrays, leaf)
    from kpw_tpu_torch.core.pages import CpuChunkEncoder
    from kpw_tpu_torch.parallel.mesh import make_mesh
    from kpw_tpu_torch.parallel.mesh_encoder import MeshChunkEncoder

    rng = np.random.default_rng(11)
    n = 40_000
    schema = Schema([leaf("a", "int64"), leaf("b", "int32"), leaf("f", "double"),
                     leaf("s", "string")])
    arrays = {"a": rng.integers(0, 5000, n).astype(np.int64),
              "b": rng.integers(-7, 7, n).astype(np.int32),
              "f": rng.integers(0, 30, n) / 4.0,
              "s": [b"tag_%d" % (i % 9) for i in range(n)]}
    props = WriterProperties()
    files = []
    menc = MeshChunkEncoder(props.encoder_options(), mesh=make_mesh(8))
    for enc in (menc, CpuChunkEncoder(props.encoder_options())):
        buf = io.BytesIO()
        w = ParquetFileWriter(buf, schema, props, encoder=enc)
        w.write_batch(columns_from_arrays(schema, arrays))
        w.close()
        files.append(buf.getvalue())
    assert files[0] == files[1]
    assert {e["route"] for e in menc.route_log} == {"bounded-psum", "two-phase-gather"}
    assert menc.string_stats["columns"] == 1
