"""Port row-group writer backend (kpw_tpu_torch.ops.backend.CudaChunkEncoder,
run here on the CPU with the plain kernel versions): whole files must be
byte-identical to the JAX package's CpuChunkEncoder, NativeChunkEncoder and
TpuChunkEncoder on the same data, and read back with pyarrow.

Both sides are built from one spec list and one property dict: the JAX
objects are made first and the port's are converted from their fields, so
the two writers see the same schema and options.  Codecs: UNCOMPRESSED,
GZIP, SNAPPY (both packages' own C++ Snappy, which dispatches to the same
system libsnappy when this host has one) and ZSTD where both native
libraries were built with zstd.
"""

import dataclasses
import io

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

import kpw_tpu.core as J
import kpw_tpu_torch.core as T
from kpw_tpu import native as jax_native
from kpw_tpu.core.pages import CpuChunkEncoder as JaxCpuEncoder
from kpw_tpu.native.encoder import NativeChunkEncoder as JaxNativeEncoder
from kpw_tpu.ops import TpuChunkEncoder
from kpw_tpu_torch import native
from kpw_tpu_torch.core.pages import CpuChunkEncoder as PortCpuEncoder
from kpw_tpu_torch.native.encoder import NativeChunkEncoder as PortNativeEncoder
from kpw_tpu_torch.ops import backend
from kpw_tpu_torch.ops.backend import CudaChunkEncoder

# Small inputs: more intra-op threads would only contend for the CPU
# with the suite's other test workers.
torch.set_num_threads(1)


def _port_field(f):
    return T.Field(name=f.name, repetition=f.repetition,
                   physical_type=f.physical_type,
                   converted_type=f.converted_type, type_length=f.type_length,
                   field_id=f.field_id,
                   children=[_port_field(c) for c in f.children])


def _port_schema(schema):
    return T.Schema([_port_field(c) for c in schema.root.children],
                    name=schema.root.name)


def _port_props(props):
    return T.WriterProperties(**{f.name: getattr(props, f.name)
                                 for f in dataclasses.fields(props)})


def _write(core, schema, props, encoder, batches):
    buf = io.BytesIO()
    w = core.ParquetFileWriter(buf, schema, props, encoder=encoder)
    for arrays in batches:
        w.write_batch(core.columns_from_arrays(schema, arrays))
        w.flush_row_group()
    w.close()
    return buf.getvalue()


def _identity(specs, arrays, batches=None, **props):
    """Write ``arrays`` (or several row groups, ``batches``) with the JAX
    CPU, native and TPU encoders and the port's device and native encoders;
    assert equal bytes; return them for read-back."""
    batches = batches or [arrays]
    jschema = J.Schema([J.leaf(*a, **kw) for a, kw in specs])
    jprops = J.WriterProperties(**props)
    pschema, pprops = _port_schema(jschema), _port_props(jprops)
    want = _write(J, jschema, jprops, JaxCpuEncoder(jprops.encoder_options()),
                  batches)
    jnative = _write(J, jschema, jprops, JaxNativeEncoder(jprops.encoder_options()),
                     batches)
    tpu = _write(J, jschema, jprops,
                 TpuChunkEncoder(jprops.encoder_options(), min_device_rows=1),
                 batches)
    got = _write(T, pschema, pprops,
                 CudaChunkEncoder(pprops.encoder_options(), min_device_rows=1,
                                  device="cpu"), batches)
    pnative = _write(T, pschema, pprops, PortNativeEncoder(pprops.encoder_options()),
                     batches)
    assert got == want
    assert got == jnative
    assert got == tpu
    assert pnative == want
    return io.BytesIO(got)


def _codec(name: str):
    """The codec of a parametrised case; ZSTD skips, with the reason, where
    either package's native library was built without zstd."""
    if name == "zstd":
        port, ref = native.lib(), jax_native.lib()
        if not (port is not None and port.has_zstd and ref is not None
                and ref.has_zstd):
            pytest.skip("zstd is missing from one of the two native builds here")
    return getattr(J.Codec, name.upper())


CODECS = ["uncompressed", "gzip", "snappy", "zstd"]


def _leaf(name, type_name, **kw):
    return (name, type_name), kw


def _low_cardinality(rng):
    n = 20000
    return [_leaf("a", "int64"), _leaf("b", "int32")], {
        "a": rng.integers(0, 100, n).astype(np.int64),
        "b": rng.integers(-5, 5, n).astype(np.int32)}, {}


def _gcd_strided(rng):
    n = 20000
    return [_leaf("cents", "int64"), _leaf("ts", "int64"), _leaf("plain", "int64")], {
        "cents": (rng.integers(0, 3000, n) * 420).astype(np.int64),
        "ts": (1_700_000_000_000 + rng.integers(0, 3000, n) * 1_000_000).astype(np.int64),
        "plain": rng.integers(0, 200, n).astype(np.int64)}, {}


def _floats(rng):
    pool = rng.normal(size=64)
    return [_leaf("f", "float"), _leaf("d", "double")], {
        "f": rng.choice(pool, size=10000).astype(np.float32),
        "d": rng.choice(pool, size=10000).astype(np.float64)}, {}


def _multi_page(rng):
    return [_leaf("x", "int64")], {
        "x": rng.integers(0, 1000, 50000).astype(np.int64)}, {"data_page_size": 16 * 1024}


def _long_runs(rng):
    return [_leaf("x", "int64")], {
        "x": np.repeat(np.arange(50, dtype=np.int64), 400)}, {}


def _width_zero(rng):
    return [_leaf("x", "int64")], {"x": np.full(5000, 42, np.int64)}, {}


def _high_cardinality(rng):
    return [_leaf("x", "int64")], {
        "x": rng.integers(0, 2 ** 62, 8000).astype(np.int64)}, {}


def _nullable_and_strings(rng):
    n = 12000
    words = [b"alpha", b"beta", b"gamma", b"delta"]
    return [_leaf("x", "int64", repetition=J.Repetition.OPTIONAL),
            _leaf("s", "string")], {
        "x": (rng.integers(0, 30, n).astype(np.int64), rng.random(n) > 0.25),
        "s": [words[i] for i in rng.integers(0, 4, n)]}, {}


def _nullable_differing_counts(rng):
    n = 6000
    opt = J.Repetition.OPTIONAL
    return [_leaf("a", "int64", repetition=opt), _leaf("b", "int64", repetition=opt),
            _leaf("f", "double", repetition=opt)], {
        "a": (rng.integers(0, 40, n).astype(np.int64), rng.random(n) > 0.5),
        "b": (rng.integers(0, 40, n).astype(np.int64), rng.random(n) > 0.1),
        "f": (rng.choice(rng.normal(size=16), n), rng.random(n) > 0.3)}, {}


def _string_dictionary(rng):
    n = 30000
    return [_leaf("s", "string"), _leaf("t", "string"), _leaf("hi", "string"),
            _leaf("a", "int64")], {
        "s": [f"cat_{k:03d}".encode() for k in rng.integers(0, 150, n)],
        "t": [b"x", b"y"] * (n // 2),
        "hi": [f"{v:026x}".encode() for v in rng.integers(0, 1 << 60, n)],
        "a": rng.integers(0, 500, n).astype(np.int64)}, {"data_page_size": 16 * 1024}


def _string_budget_rejection(rng):
    n = 24000
    pool = [f"{v:0118x}".encode() for v in rng.integers(0, 1 << 62, n // 2)]
    return [_leaf("s", "string")], {
        "s": [pool[k] for k in rng.integers(0, len(pool), n)]}, {"data_page_size": 64 * 1024}


def _string_nullable(rng):
    n = 20000
    return [_leaf("s", "string", repetition=J.Repetition.OPTIONAL)], {
        "s": ([f"cat_{k:02d}".encode() for k in rng.integers(0, 40, n)],
              rng.integers(0, 4, n) > 0)}, {"data_page_size": 8 * 1024}


def _optional_runny_levels(rng):
    """Mostly-present optional columns: run-dominated def levels, the
    device run extraction + host replay route."""
    n = 12000
    valid = rng.random(n) > 0.02
    valid[3000:3003] = False
    return [_leaf("x", "int64", repetition=J.Repetition.OPTIONAL),
            _leaf("y", "double", repetition=J.Repetition.OPTIONAL)], {
        "x": (rng.integers(0, 50, n).astype(np.int64), valid),
        "y": (rng.normal(size=n), np.ones(n, bool))}, {"data_page_size": 16 * 1024}


def _optional_random_levels(rng):
    """High-entropy def levels: the bit-packed level route."""
    n = 12000
    return [_leaf("x", "int64", repetition=J.Repetition.OPTIONAL),
            _leaf("s", "string", repetition=J.Repetition.OPTIONAL)], {
        "x": (rng.integers(0, 50, n).astype(np.int64), rng.random(n) > 0.5),
        "s": ([f"w{k}".encode() for k in rng.integers(0, 9, n)],
              rng.random(n) > 0.5)}, {}


def _delta_fallback(rng):
    """delta_fallback with the dictionary off: the delta planner on int64,
    int32 and string-length pages, several pages a chunk."""
    rows = 8192
    return [_leaf("ts", "int64"), _leaf("i32", "int32"), _leaf("u", "string"),
            _leaf("opt", "int64", repetition=J.Repetition.OPTIONAL)], {
        "ts": (1_700_000_000 + np.cumsum(rng.integers(0, 9, rows))).astype(np.int64),
        "i32": rng.integers(-(1 << 29), 1 << 29, rows).astype(np.int32),
        "u": [f"{v:020x}".encode()[: 4 + v % 16] for v in rng.integers(0, 1 << 60, rows)],
        "opt": (rng.integers(-(1 << 62), 1 << 62, rows).astype(np.int64),
                rng.random(rows) > 0.1)}, {
        "enable_dictionary": False, "delta_fallback": True,
        "data_page_size": 16 * 1024}


def _int64_holding_int32(rng):
    """An int32 array in an INT64 column sign-extends into the 64-bit ring."""
    return [_leaf("ts", "int64")], {
        "ts": rng.integers(-(1 << 20), 1 << 20, 6000).astype(np.int32)}, {
        "enable_dictionary": False, "delta_fallback": True,
        "data_page_size": 8 * 1024}


def _bss_overrides(rng):
    """BYTE_STREAM_SPLIT forced on float, double, int32 and int64 columns
    (one of them optional), DELTA_LENGTH_BYTE_ARRAY on a string column."""
    n = 9000
    return [_leaf("f", "float"), _leaf("d", "double", repetition=J.Repetition.OPTIONAL),
            _leaf("i", "int32"), _leaf("l", "int64"), _leaf("s", "string")], {
        "f": rng.normal(size=n).astype(np.float32),
        "d": (100.0 + np.cumsum(rng.normal(size=n)), rng.random(n) > 0.3),
        "i": rng.integers(-5000, 5000, n).astype(np.int32),
        "l": rng.integers(0, 1 << 40, n).astype(np.int64),
        "s": [b"u%08d" % v for v in rng.integers(0, 10 ** 6, n)]}, {
        "encodings": {"f": "BYTE_STREAM_SPLIT", "d": "BYTE_STREAM_SPLIT",
                      "i": "BYTE_STREAM_SPLIT", "l": "BYTE_STREAM_SPLIT",
                      "s": "DELTA_LENGTH_BYTE_ARRAY"},
        "data_page_size": 32 * 1024}


def _baseline_config1(rng):
    """BASELINE config 1's shape at a small size (bench.py:300-323): 8
    int64 columns i{k} drawn from [0, 10^(k+1)) and 4 string columns from a
    pool of 100 values."""
    n = 6000
    pool = [b"cat_%03d" % j for j in range(100)]
    arrays = {f"i{k}": rng.integers(0, 10 ** (k + 1), n).astype(np.int64)
              for k in range(8)}
    arrays |= {f"s{k}": [pool[j] for j in rng.integers(0, 100, n)] for k in range(4)}
    return ([_leaf(f"i{k}", "int64") for k in range(8)]
            + [_leaf(f"s{k}", "string") for k in range(4)]), arrays, {}


def _baseline_config3(rng):
    """BASELINE config 3's shape at a small size (bench.py:1233-1249, its
    encode-side properties :1297-1299): 4 near-sorted int64 timestamps and
    4 columns of 32-char hex strings, the dictionary off and delta
    fallback on, with 16 KiB pages so that every column splits into pages
    of unequal counts."""
    n = 4096
    arrays = {f"ts{i}": (1_700_000_000_000 + np.cumsum(rng.integers(0, 50, n))
                         + rng.integers(0, 5, n)).astype(np.int64) for i in range(4)}
    arrays |= {f"u{i}": [f"{v:032x}".encode() for v in rng.integers(0, 1 << 62, n)]
               for i in range(4)}
    return ([_leaf(f"ts{i}", "int64") for i in range(4)]
            + [_leaf(f"u{i}", "string") for i in range(4)]), arrays, {
        "enable_dictionary": False, "delta_fallback": True,
        "data_page_size": 16 * 1024}


CASES = {f.__name__[1:]: f for f in (
    _low_cardinality, _gcd_strided, _floats, _multi_page, _long_runs,
    _width_zero, _high_cardinality, _nullable_and_strings,
    _nullable_differing_counts, _string_dictionary, _string_budget_rejection,
    _string_nullable, _optional_runny_levels, _optional_random_levels,
    _delta_fallback, _int64_holding_int32, _bss_overrides, _baseline_config1,
    _baseline_config3)}


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_file_identity(case, codec):
    specs, arrays, props = CASES[case](np.random.default_rng(len(case)))
    buf = _identity(specs, arrays, codec=_codec(codec), **props)
    table = pq.read_table(buf)
    for (name, type_name), _ in specs:
        v = arrays[name]
        got = table[name].to_pylist()
        if isinstance(v, tuple):  # (values, validity)
            values, valid = v
            want = [(x.decode() if type_name == "string" else x) if ok else None
                    for x, ok in zip(values.tolist() if hasattr(values, "tolist")
                                     else values, valid)]
        elif type_name == "string":
            want = [x.decode() for x in v]
        else:
            want = v.tolist()
        assert got == want, name


def make_taxi_like(rows: int, seed: int = 0) -> dict:
    """The repo's 64-column NYC-taxi-shaped table (bench.py make_taxi_like)."""
    rng = np.random.default_rng(seed)
    cols = {}
    for i in range(64):
        kind = i % 4
        if kind == 0:
            cols[f"c{i:02d}"] = rng.integers(0, 8, rows).astype(np.int64)
        elif kind == 1:
            cols[f"c{i:02d}"] = rng.integers(1, 266, rows).astype(np.int32)
        elif kind == 2:
            cols[f"c{i:02d}"] = (rng.integers(0, 5000, rows) * 25).astype(np.int64)
        else:
            cols[f"c{i:02d}"] = (rng.integers(0, 3000, rows) / 100.0).astype(np.float64)
    return cols


def test_taxi_64_columns_two_row_groups():
    types = {"int64": "int64", "int32": "int32", "float64": "double"}
    batches = [make_taxi_like(8192, seed=s) for s in (0, 1)]
    specs = [_leaf(n, types[str(v.dtype)]) for n, v in batches[0].items()]
    buf = _identity(specs, None, batches=batches)
    md = pq.read_metadata(buf)
    assert md.num_row_groups == 2 and md.num_columns == 64
    assert "PLAIN_DICTIONARY" in str(md.row_group(0).column(3).encodings)
    table = pq.read_table(buf)
    for name in batches[0]:
        np.testing.assert_array_equal(
            table[name].to_numpy(),
            np.concatenate([b[name] for b in batches]))


def test_pipelined_writer_matches_jax_cpu_encoder():
    """The writer's pipeline runs launch_many and assemble_many of
    consecutive row groups on different threads; the file is the one the
    JAX package's CPU encoder writes row group by row group."""
    types = {"int64": "int64", "int32": "int32", "float64": "double"}
    batches = [make_taxi_like(4096, seed=s) for s in (2, 3, 4)]
    jschema = J.Schema([J.leaf(n, types[str(v.dtype)]) for n, v in batches[0].items()])
    jprops = J.WriterProperties()
    want = _write(J, jschema, jprops, JaxCpuEncoder(jprops.encoder_options()), batches)
    pschema = _port_schema(jschema)
    pprops = _port_props(dataclasses.replace(jprops, row_group_size=1))
    buf = io.BytesIO()
    w = T.ParquetFileWriter(buf, pschema, pprops, pipeline=True,
                            encoder=CudaChunkEncoder(pprops.encoder_options(),
                                                     min_device_rows=1, device="cpu"))
    for arrays in batches:
        w.write_batch(T.columns_from_arrays(pschema, arrays))
        w.maybe_flush_row_group()  # row_group_size=1: one row group a batch
    w.close()
    assert buf.getvalue() == want


def test_encode_many_matches_per_chunk_encode():
    """The two-sync row-group plan equals per-chunk encode() (which builds
    each dictionary through _dictionary_build and packs per page)."""
    rng = np.random.default_rng(8)
    schema = T.Schema([T.leaf(f"c{i}", "int64") for i in range(6)])
    arrays = {f"c{i}": rng.integers(0, 64, 6000).astype(np.int64) for i in range(6)}
    arrays["c5"] = np.repeat(np.arange(60, dtype=np.int64), 100)  # long runs
    opts = T.WriterProperties(data_page_size=8 * 1024).encoder_options()
    batch = T.columns_from_arrays(schema, arrays)
    many = CudaChunkEncoder(opts, min_device_rows=1, device="cpu").encode_many(
        batch.chunks, base_offset=4)
    off = 4
    for chunk, m in zip(batch.chunks, many):
        single = CudaChunkEncoder(opts, min_device_rows=1, device="cpu").encode(chunk, off)
        assert single.blob == m.blob
        assert single.blob == PortCpuEncoder(opts).encode(chunk, off).blob
        off += len(single.blob)


def test_small_chunks_take_the_superclass():
    """Chunks below min_device_rows never reach the device plan."""
    rng = np.random.default_rng(4)
    schema = T.Schema([T.leaf("a", "int64")])
    batch = T.columns_from_arrays(schema, {"a": rng.integers(0, 9, 100).astype(np.int64)})
    encoder = CudaChunkEncoder(T.WriterProperties().encoder_options(), device="cpu")
    assert encoder.launch_many(batch.chunks).state is None


def _write_batches(core, schema, props, encoder, batches):
    buf = io.BytesIO()
    w = core.ParquetFileWriter(buf, schema, props, encoder=encoder)
    for batch in batches:
        w.write_batch(batch)
        w.flush_row_group()
    w.close()
    return buf.getvalue()


@pytest.mark.parametrize("codec", CODECS)
def test_nested_list_struct_identity(codec):
    """BASELINE config 5's shape: list<struct> rows shredded by each
    package's own ProtoColumnarizer (the port's from the wire bytes); rep
    and def levels through the device level planner, two row groups."""
    from kpw_tpu.models import ProtoColumnarizer, proto_to_schema
    from proto_helpers import nested_message_classes

    Order = nested_message_classes()
    rng = np.random.default_rng(4)
    groups = []
    for _ in range(2):
        msgs = []
        for _ in range(1500):
            o = Order()
            o.order_id = int(rng.integers(0, 1 << 40))
            for _ in range(int(rng.integers(0, 4))):
                it = o.items.add()
                it.sku = f"sku{int(rng.integers(0, 30))}"
                it.qty = int(rng.integers(1, 99))
                for _ in range(int(rng.integers(0, 3))):
                    it.tags.append(f"t{int(rng.integers(0, 5))}")
            if rng.random() < 0.3:
                o.note = f"n{int(rng.integers(0, 7))}"
            msgs.append(o)
        groups.append(msgs)
    jschema = proto_to_schema(Order)
    jbatches = [ProtoColumnarizer(Order, jschema).columnarize(m) for m in groups]
    jprops = J.WriterProperties(codec=_codec(codec), data_page_size=4 * 1024)
    pschema, pprops = _port_schema(jschema), _port_props(jprops)
    want = _write_batches(J, jschema, jprops,
                          JaxCpuEncoder(jprops.encoder_options()), jbatches)
    jnative = _write_batches(J, jschema, jprops,
                             JaxNativeEncoder(jprops.encoder_options()), jbatches)
    tpu = _write_batches(J, jschema, jprops,
                         TpuChunkEncoder(jprops.encoder_options(), min_device_rows=1),
                         jbatches)
    # the port's batches from its own columnarizer, off the wire bytes
    from kpw_tpu_torch.models import ProtoColumnarizer as PortColumnarizer

    shred = PortColumnarizer(Order, pschema)
    pbatches = [shred.columnarize_payloads([m.SerializeToString() for m in msgs])
                for msgs in groups]
    got = _write_batches(T, pschema, pprops,
                         CudaChunkEncoder(pprops.encoder_options(), min_device_rows=1,
                                          device="cpu"), pbatches)
    assert got == want
    assert got == jnative
    assert got == tpu
    table = pq.read_table(io.BytesIO(got))
    assert [[it["qty"] for it in (row or [])] for row in table["items"].to_pylist()] \
        == [[it.qty for it in o.items] for msgs in groups for o in msgs]


def test_level_plan_cleared_between_row_groups():
    """Level and delta plans are keyed by id(chunk): none may outlive its
    row group."""
    rng = np.random.default_rng(5)
    schema = T.Schema([T.leaf("x", "int64", T.Repetition.OPTIONAL),
                       T.leaf("t", "int64")])
    props = T.WriterProperties(enable_dictionary=False, delta_fallback=True)
    encoder = CudaChunkEncoder(props.encoder_options(), min_device_rows=1,
                               device="cpu")
    cpu = PortCpuEncoder(props.encoder_options())

    def batch():
        n = 6000
        valid = np.ones(n, bool)
        valid[::7] = False
        return T.columns_from_arrays(schema, {
            "x": (rng.integers(0, 20, n).astype(np.int64), valid),
            "t": np.cumsum(rng.integers(0, 5, n)).astype(np.int64)})

    batches = [batch(), batch()]
    bufs = [io.BytesIO(), io.BytesIO()]
    writers = [T.ParquetFileWriter(buf, schema, props, encoder=e)
               for buf, e in zip(bufs, (encoder, cpu))]
    for b in batches:
        for w in writers:
            w.write_batch(b)
            w.flush_row_group()
        assert not encoder._level_plans and not encoder._delta_plans
    for w in writers:
        w.close()
    assert bufs[0].getvalue() == bufs[1].getvalue()
    assert pq.read_table(io.BytesIO(bufs[0].getvalue())).num_rows == 12000


@pytest.mark.parametrize("codec", CODECS)
def test_adaptive_encodings_two_row_groups(codec):
    """Adaptive encodings: row group 1 is decided inside encode() (the
    per-page device route), row group 2 is planned (delta planner)."""
    rng = np.random.default_rng(12)
    rows = 6000
    batches = [{
        "ts": (1_700_000_000_000 + np.cumsum(rng.integers(0, 8, rows))).astype(np.int64),
        "rid": rng.integers(0, 2 ** 32, rows, dtype=np.int64),
        "uid": [b"u%012d" % v for v in rng.integers(0, 10 ** 6, rows)],
        "price": 100.0 + np.cumsum(rng.standard_normal(rows) * 0.25)}
        for _ in range(2)]
    specs = [_leaf("ts", "int64"), _leaf("rid", "int64"), _leaf("uid", "string"),
             _leaf("price", "double")]
    buf = _identity(specs, None, batches=batches, codec=_codec(codec),
                    adaptive_encodings=True)
    md = pq.read_metadata(buf)
    assert "DELTA_BINARY_PACKED" in str(md.row_group(1).column(0).encodings)


@pytest.mark.parametrize("case", ["string_dictionary", "string_nullable",
                                  "baseline_config1", "string_budget_rejection"])
def test_string_planner_serves_the_string_pages(monkeypatch, case):
    """The string dictionary planner ran: its pack jobs were launched and
    every page of every planned string column was served from its
    _PageBodies (nullable columns keyed by their present-value ranges); a
    dictionary over the page budget was handed through its slot as built,
    and encode() re-derived the rejection."""
    planners, served = [], set()

    class Recording(backend._StringDictPlanner):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            planners.append(self)

        def fill_slots(self, fetched, slots):
            super().fill_slots(fetched, slots)
            self.filled = {i: slots[i] for i, *_ in self._items}
            self.handed = {i: slots[i] for i, *_ in self._rejected}

    indices_body = CudaChunkEncoder._indices_body

    def spy(self, indices, va, vb, dict_size):
        if isinstance(indices, backend._PageBodies):
            served.add((id(indices), va, vb))
        return indices_body(self, indices, va, vb, dict_size)

    monkeypatch.setattr(backend, "_StringDictPlanner", Recording)
    monkeypatch.setattr(CudaChunkEncoder, "_indices_body", spy)
    specs, arrays, props = CASES[case](np.random.default_rng(len(case)))
    buf = _identity(specs, arrays, **props)
    assert planners
    if case == "string_budget_rejection":
        assert all(not p._items and p._rejected for p in planners)
        for p in planners:
            for dict_values, idx in p.handed.values():
                assert isinstance(idx, np.ndarray) and len(idx) == len(arrays["s"])
        assert not pq.read_metadata(buf).row_group(0).column(0).has_dictionary_page
        return
    assert sum(len(p._groups) for p in planners) > 0
    planned = {"string_dictionary": {"s", "t"},  # "hi" aborts at the ratio
               "string_nullable": {"s"},
               "baseline_config1": {"s0", "s1", "s2", "s3"}}[case]
    for p in planners:
        assert {chunk.column.name for _, chunk, *_ in p._items} == planned
        for i, chunk, _, _, width, pages in p._items:
            dict_values, pb = p.filled[i]
            assert isinstance(pb, backend._PageBodies)
            assert pages
            assert all((id(pb), va, vb) in served for va, vb in pages)
