"""Port DELTA_BINARY_PACKED (kpw_tpu_torch.ops.delta), run here on the CPU
with the kernel's plain version: every page's bytes (the host header plus
the block stream ``delta_page_streams`` writes) equal to the
``core.encodings`` oracle and to the JAX package's device functions run on
the CPU, byte for byte, on the cases of the JAX package's delta tests and
more; and the encoder's delta pages built with no Python work per block."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kpw_tpu.core import encodings as enc
from kpw_tpu.core.bytecol import ByteColumn
from kpw_tpu.ops import delta as JD
from kpw_tpu_torch import core as T
from kpw_tpu_torch.core.bytecol import ByteColumn as PortBytes
from kpw_tpu_torch.native.encoder import NativeChunkEncoder
from kpw_tpu_torch.ops import backend
from kpw_tpu_torch.ops import delta as TD

torch.set_num_threads(1)


def _pages(streams: np.ndarray, table, bit_size: int, max_bits: int | None = None):
    """Every page of one ``delta_page_streams`` launch (plain version) with
    its header, and each page's window of values."""
    out, offsets, over = TD.delta_page_streams(torch.from_numpy(streams), table,
                                               bit_size, max_bits or bit_size)
    assert int(over[0]) == 0
    out, offsets = out.numpy(), offsets.numpy()
    itype = streams.dtype
    got, windows = [], []
    for p, (r, s, c) in enumerate(np.asarray(table).reshape(-1, 3)):
        window = np.zeros(c, itype)  # reads past the stream give 0
        part = streams[r, s:s + c]
        window[: len(part)] = part
        header, body = TD.page_parts(int(window[0]) if c else 0, int(c), out,
                                     int(offsets[p]), int(offsets[p + 1]))
        got.append(header + body.tobytes())
        windows.append(window)
    return got, windows


EDGES = [
    np.array([], np.int64),
    np.array([7], np.int64),
    np.array([0, (1 << 63) - 1, -(1 << 63), 17], np.int64),  # ring wraparound
    np.full(300, -5, np.int64),  # zero deltas
    np.arange(129, dtype=np.int64),  # one block + 1
]


@pytest.mark.parametrize("case", range(len(EDGES)))
def test_delta64_edges_equal_jax_and_oracle(case):
    v = EDGES[case]
    want = enc.delta_binary_packed_encode(v, 64)
    assert TD.delta_binary_packed_device(v, 64, "cpu") == want
    assert JD.delta_binary_packed_device(v, 64) == want


def test_delta64_random_counts():
    rng = np.random.default_rng(0)
    for n in (2, 127, 128, 129, 1000):
        v = rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64)
        want = enc.delta_binary_packed_encode(v, 64)
        assert TD.delta_binary_packed_device(v, 64, "cpu") == want
        assert JD.delta_binary_packed_device(v, 64) == want


@pytest.mark.parametrize("range_bits,bit_size", [
    (5, 64), (12, 64), (20, 64), (28, 64), (40, 64), (60, 64),
    (5, 32), (12, 32), (20, 32), (28, 32)])
def test_every_width_bucket_equals_jax(range_bits, bit_size):
    """One case per width bucket, the launch sized by its own bucket: each
    page of a ragged table equals the JAX package's device stream and the
    oracle's."""
    rng = np.random.default_rng(range_bits * 64 + bit_size)
    itype = np.int64 if bit_size == 64 else np.int32
    v = (rng.integers(0, 1 << range_bits, 700) - (1 << (range_bits - 1))).astype(itype)
    span = int(v.max()) - int(v.min())
    max_bits = TD.delta_bits_bucket(span, bit_size)
    assert max_bits == JD.delta_bits_bucket(span, bit_size)
    assert max_bits == next(b for b in (8, 16, 24, 32, 48, 64)
                            if range_bits + 1 <= b <= bit_size)
    table = [[0, 0, 700], [0, 3, 129], [0, 200, 2], [0, 650, 50]]
    got, windows = _pages(v[None, :], table, bit_size, max_bits)
    for g, w in zip(got, windows):
        assert g == enc.delta_binary_packed_encode(w, bit_size)
        assert g == JD.delta_binary_packed_device(w, bit_size)


def test_delta32_wraps_at_32_bits():
    rng = np.random.default_rng(1)
    for v in (rng.integers(-(1 << 30), 1 << 30, 777).astype(np.int32),
              np.array([0, (1 << 31) - 1, -(1 << 31)], np.int32),
              np.cumsum(rng.integers(0, 9, 400)).astype(np.int32)):
        assert TD.delta_binary_packed_device(v, 32, "cpu") == \
            enc.delta_binary_packed_encode(v, 32) == JD.delta_binary_packed_device(v, 32)


def test_delta_length_byte_array_equals_jax():
    rng = np.random.default_rng(2)
    vals = [f"{v:024x}".encode()[: 3 + v % 20] for v in rng.integers(0, 1 << 60, 600)]
    want = enc.delta_length_byte_array_encode(vals)
    assert TD.delta_length_byte_array_device(vals, "cpu") == want
    assert TD.delta_length_byte_array_device(PortBytes.from_list(vals), "cpu") == want
    assert JD.delta_length_byte_array_device(ByteColumn.from_list(vals)) == want


def _jax_multi(streams, rows, starts, counts, bucket, bit_size, max_bits):
    """The JAX package's batched device phase and its per-page assembly."""
    if bit_size == 64:
        u = streams.view(np.uint64)
        hi, lo = (u >> np.uint64(32)).astype(np.uint32), u.astype(np.uint32)
    else:
        hi, lo = np.zeros(streams.shape, np.uint32), streams.view(np.uint32)
    ids = [jnp.asarray(np.array(x, np.int32)) for x in (rows, starts, counts)]
    mh, ml, jw, jp = (np.asarray(x) for x in JD.delta_pages_multi(
        jnp.asarray(hi), jnp.asarray(lo), *ids, bucket, bit_size, max_bits))
    return mh, ml, jw, jp


@pytest.mark.parametrize("bit_size", [32, 64])
def test_delta_pages_multi_equals_jax(bit_size):
    """Stacked streams, one launch for every page of the ring: ragged
    counts (0, 1, 2, 127, 128, 129 and more), unaligned starts, a window
    past its stream's end; each page equals the JAX package's batched
    device phase assembled, and the oracle's stream of its window."""
    rng = np.random.default_rng(bit_size)
    itype = np.int64 if bit_size == 64 else np.int32
    info = np.iinfo(itype)
    streams = np.stack([
        np.resize(np.array([0, info.max, info.min, 17, -1], itype), 900),
        np.cumsum(rng.integers(0, 9, 900)).astype(itype),
        rng.integers(info.min, info.max, 900, dtype=itype, endpoint=True)])
    rows = [0, 1, 2, 1, 0, 2, 1, 0, 2, 1]
    starts = [0, 3, 100, 0, 850, 7, 11, 5, 40, 300]
    counts = [2, 127, 129, 900, 50, 512, 128, 0, 1, 600]
    table = np.array([rows, starts, counts]).T
    got, windows = _pages(streams, table, bit_size)
    mh, ml, jw, jp = _jax_multi(streams, rows, starts, counts, 1024, bit_size, bit_size)
    for p, (c, g, w) in enumerate(zip(counts, got, windows)):
        assert g == enc.delta_binary_packed_encode(w, bit_size)
        assert g == JD.assemble_delta_page(int(w[0]) if c else 0, c, mh[p], ml[p],
                                           jw[p], jp[p], bit_size, bit_size)


@pytest.mark.parametrize("bit_size", [32, 64])
def test_ragged_multi_page_table_from_different_rows(bit_size):
    """Pages of several rows, ragged counts from 0 to several blocks and
    one page per width bucket of the ring, in one launch: offsets rise
    page by page, the stream ends at the last offset, and every page
    equals the oracle and the JAX package's per-page device stream."""
    rng = np.random.default_rng(10 + bit_size)
    itype = np.int64 if bit_size == 64 else np.int32
    rows = [np.cumsum(rng.integers(-3, 9, 3000)).astype(itype)]
    for bits in (7, 15, 23, 31, 47, 63):
        if bits < bit_size:
            rows.append((rng.integers(0, 1 << bits, 3000) - (1 << (bits - 1))).astype(itype))
    streams = np.stack(rows)
    table = np.array([(r, int(rng.integers(0, 2500)), int(c))
                      for r in range(len(rows))
                      for c in rng.integers(0, 700, 4).tolist() + [0, 1, 129]])
    out, offsets, over = TD.delta_page_streams(torch.from_numpy(streams), table,
                                               bit_size, bit_size)
    offs = offsets.numpy()
    assert offs[0] == 0 and np.all(np.diff(offs) >= 0)
    assert TD.stream_bytes(out, offsets).numel() == offs[-1]
    got, windows = _pages(streams, table, bit_size)
    for g, w in zip(got, windows):
        assert g == enc.delta_binary_packed_encode(w, bit_size)
        assert g == JD.delta_binary_packed_device(w, bit_size)


@pytest.mark.parametrize("bit_size", [32, 64])
def test_min_zigzag_varint_takes_ten_bytes(bit_size):
    """A block minimum of INT64_MIN zigzags to 2^64 - 1, a 10-byte varint
    on the 64-bit ring; the 32-bit ring's widest minimum takes 5."""
    itype = np.int64 if bit_size == 64 else np.int32
    info = np.iinfo(itype)
    v = np.array([info.max, info.min, 0, 5, info.min], itype)
    want = enc.delta_binary_packed_encode(v, bit_size)
    assert TD.delta_binary_packed_device(v, bit_size, "cpu") == want
    assert JD.delta_binary_packed_device(v, bit_size) == want
    out, offsets, _ = TD.delta_page_streams(torch.from_numpy(v)[None], [[0, 0, 5]],
                                            bit_size, bit_size)
    varint = 10 if bit_size == 64 else 5
    assert out.numpy()[varint - 1] < 0x80 and out.numpy()[varint - 2] >= 0x80


def test_width_budget_violation_is_loud():
    """A miniblock wider than the budget: the launch flags the widest such
    width, and the host refuses the stream instead of writing it short;
    through the encoder's planner, the write raises."""
    v = np.array([0, 1 << 40, 0, 5], np.int64)
    out, offsets, over = TD.delta_page_streams(torch.from_numpy(v)[None], [[0, 0, 4]],
                                               64, 16)
    assert int(over[0]) > 16
    with pytest.raises(ValueError, match="exceeds the device pack's budget"):
        TD.check_budget(over.numpy(), 16)
    TD.check_budget(TD.delta_page_streams(torch.from_numpy(v)[None], [[0, 0, 4]],
                                          64, 48)[2].numpy(), 48)


def test_planner_refuses_a_wrong_width_bound(monkeypatch):
    monkeypatch.setattr(backend, "delta_bits_bucket", lambda span, ring: 8)
    schema = T.Schema([T.leaf("t", "int64")])
    props = T.WriterProperties(enable_dictionary=False, delta_fallback=True)
    w = T.ParquetFileWriter(io.BytesIO(), schema, props, encoder=backend.CudaChunkEncoder(
        props.encoder_options(), min_device_rows=1, device="cpu"))
    w.write_batch(T.columns_from_arrays(schema, {
        "t": np.random.default_rng(3).integers(0, 1 << 40, 5000)}))
    with pytest.raises(ValueError, match="exceeds the device pack's budget"):
        w.flush_row_group()


def test_wrapper_refuses_bad_inputs():
    s = torch.zeros((1, 300), dtype=torch.int64)
    table = np.zeros((1, 3), np.int32)
    with pytest.raises(TypeError, match="64-bit ring"):
        TD.delta_page_streams(s.to(torch.int32), table, 64, 8)
    with pytest.raises(ValueError, match="max_bits"):
        TD.delta_page_streams(s.to(torch.int32), table, 32, 48)
    with pytest.raises(ValueError, match="int32 and >= 0"):
        TD.delta_page_streams(s, np.array([[0, -1, 5]]), 64, 8)
    for bad in (np.zeros((1, 6), np.int32), np.zeros(3, np.int32),
                np.zeros((2, 3, 1), np.int32)):
        with pytest.raises(ValueError, match=r"must be \(P, 3\)"):
            TD.delta_page_streams(s, bad, 64, 8)
    with pytest.raises(ValueError, match="on the host"):
        TD.delta_page_streams(s, torch.zeros((1, 3), dtype=torch.int32,
                                             device="meta"), 64, 8)


def test_encoder_delta_pages_take_no_python_work_per_block(monkeypatch):
    """CudaChunkEncoder's planned delta pages (int64, int32, an optional
    column and string lengths, several pages of many blocks) are served
    whole from the launch: the host route of the native superclass is never
    asked for a delta page, and the Python work per page is its header (four
    varints), not a loop over its blocks.  The file equals the port's
    NativeChunkEncoder file."""
    rng = np.random.default_rng(7)
    rows = 40_000
    schema = T.Schema([T.leaf("ts", "int64"), T.leaf("i", "int32"),
                       T.leaf("u", "string"),
                       T.leaf("o", "int64", T.Repetition.OPTIONAL)])
    batch = T.columns_from_arrays(schema, {
        "ts": (1_700_000_000 + np.cumsum(rng.integers(0, 50, rows))).astype(np.int64),
        "i": rng.integers(-(1 << 29), 1 << 29, rows).astype(np.int32),
        "u": [b"%032x" % v for v in rng.integers(0, 1 << 62, rows)],
        "o": (rng.integers(0, 1 << 40, rows).astype(np.int64), rng.random(rows) > 0.1)})
    props = T.WriterProperties(enable_dictionary=False, delta_fallback=True,
                               data_page_size=64 * 1024)

    def write(encoder):
        buf = io.BytesIO()
        w = T.ParquetFileWriter(buf, schema, props, encoder=encoder)
        w.write_batch(batch)
        w.close()
        return buf.getvalue()

    want = write(NativeChunkEncoder(props.encoder_options()))
    planners, headers = [], []

    class Recording(backend._DeltaPlanner):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            planners.append(self)

    def refuse(*args, **kwargs):
        raise AssertionError("a delta page left the plan for the host route")

    varint = TD.varint_bytes

    def counted(n):
        headers.append(n)
        return varint(n)

    monkeypatch.setattr(backend, "_DeltaPlanner", Recording)
    monkeypatch.setattr(NativeChunkEncoder, "_values_page_parts", refuse)
    monkeypatch.setattr(NativeChunkEncoder, "_values_body", refuse)
    monkeypatch.setattr(TD, "varint_bytes", counted)
    got = write(backend.CudaChunkEncoder(props.encoder_options(), min_device_rows=1,
                                         device="cpu"))
    assert got == want
    (planner,) = planners
    pages = sum(len(items) for _, items, _, _ in planner._launches)
    blocks = sum((vb - va - 1 + 127) // 128
                 for _, items, _, _ in planner._launches for _, _, va, vb in items)
    assert len(planner._launches) == 2  # one per ring
    assert pages >= 4 * 2 and blocks > 20 * pages
    assert len(headers) == 4 * pages
    # string pages: [header, length stream view, payload view], no copy
    for chunk, by_range in planner.plans.values():
        for parts in by_range.values():
            if chunk.column.name == "u":
                assert len(parts) == 3 and parts[2].obj is chunk.values.data
            else:
                assert len(parts) == 2
            assert isinstance(parts[1], np.ndarray) and parts[1].base is not None
