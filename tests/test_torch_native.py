"""The port's native host library (kpw_tpu_torch.native) against the JAX
package's (kpw_tpu.native), entry by entry, on the same seeded inputs: both
are loaded in this one process, each from its own build, and every output
must be equal byte for byte (and equal to the ``core.encodings`` oracle
where there is one)."""

import os
import threading

import numpy as np
import pytest

from kpw_tpu import native as jax_native
from kpw_tpu.core import encodings as enc
from kpw_tpu.core.schema import PhysicalType
from kpw_tpu_torch import native
from kpw_tpu_torch.native import build


@pytest.fixture(scope="module")
def libs():
    port, ref = native.lib(), jax_native.lib()
    assert port is not None, f"the port's native library must build here: {native.errors}"
    assert ref is not None, "the JAX package's native library must build here"
    return port, ref


def test_port_loads_its_own_build(libs):
    """The port's ctypes library and extension are the ones built from
    kpw_tpu_torch/native/src into kpw_tpu_torch/_build, not the JAX
    package's (both live in this process)."""
    port, ref = libs
    assert port._c._name == build.LIB_SO
    assert os.path.dirname(port._c._name) == build.BUILD_DIR
    assert ref._c._name != port._c._name
    asm = native.assemble()
    assert asm is not None, native.errors
    assert asm.__name__ == "_kpw_torch_assemble"
    assert asm.__file__ == build.ASSEMBLE_SO
    assert asm.OP_KINDS == 5
    assert asm.HAS_ZSTD == int(port.has_zstd)
    shred = native.pyshred()
    assert shred is not None, native.errors
    assert shred.__name__ == "_kpw_torch_pyshred"
    assert shred.__file__ == build.PYSHRED_SO
    assert jax_native.pyshred().__name__ == "_kpw_pyshred"


def _corpus():
    rng = np.random.default_rng(0)
    return [
        b"",
        b"a",
        b"abcabcabcabcabcabcabcabc" * 100,
        bytes(rng.integers(0, 256, 100_000, dtype=np.uint8)),  # incompressible
        bytes(rng.integers(0, 4, 100_000, dtype=np.uint8)),  # low entropy
        b"\x00" * 300_000,
        bytes(rng.integers(0, 256, 70_000, dtype=np.uint8)) * 3,  # repeats past 64 KiB
        ("the quick brown fox " * 5_000).encode(),
    ]


@pytest.mark.parametrize("case", range(len(_corpus())))
def test_snappy_equal_and_round_trip(libs, case):
    port, ref = libs
    data = _corpus()[case]
    c = port.snappy_compress(data)
    assert c == ref.snappy_compress(data)
    assert port.snappy_decompress(c) == data
    assert ref.snappy_decompress(c) == data
    parts = [data[: len(data) // 3], memoryview(data)[len(data) // 3:],
             np.frombuffer(b"tail", np.uint8)]
    out_p, n_p = port.snappy_compress_parts(parts)
    out_r, n_r = ref.snappy_compress_parts(parts)
    assert bytes(out_p[:n_p]) == bytes(out_r[:n_r])
    assert port.snappy_decompress(bytes(out_p[:n_p])) == data + b"tail"


@pytest.mark.parametrize("case", range(len(_corpus())))
def test_zstd_equal_and_round_trip(libs, case):
    port, ref = libs
    if not (port.has_zstd and ref.has_zstd):
        pytest.skip("zstd is missing from one of the two native builds here")
    data = _corpus()[case]
    for level in (1, 3):
        c = port.zstd_compress(data, level)
        assert c == ref.zstd_compress(data, level)
        assert port.zstd_decompress(c) == data
    out_p, n_p = port.zstd_compress_parts([data, b"x"], 3)
    out_r, n_r = ref.zstd_compress_parts([data, b"x"], 3)
    assert bytes(out_p[:n_p]) == bytes(out_r[:n_r])


def test_crc32c(libs):
    port, ref = libs
    assert port.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    for data in _corpus():
        assert port.crc32c(data) == ref.crc32c(data)
        assert port.crc32c(data, 12345) == ref.crc32c(data, 12345)


def _keys(kind: str, n: int, rng):
    if kind == "u32":
        return rng.integers(0, 300, n).astype(np.uint32)
    if kind == "u32_wide":
        return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    if kind == "u64":
        return (rng.integers(0, 500, n).astype(np.uint64) << np.uint64(40)) | np.uint64(7)
    return rng.integers(0, 1 << 63, n, dtype=np.uint64)  # u64_wide


@pytest.mark.parametrize("max_k", [None, 200, 100_000])
@pytest.mark.parametrize("kind", ["u32", "u32_wide", "u64", "u64_wide"])
def test_dict_build(libs, kind, max_k):
    port, ref = libs
    keys = _keys(kind, 20_000, np.random.default_rng(len(kind)))
    got, want = port.dict_build(keys, max_k=max_k), ref.dict_build(keys, max_k=max_k)
    if want is None:
        assert got is None
        assert max_k is not None and len(np.unique(keys)) > max_k
        return
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    oracle_d, oracle_i = enc.dictionary_build(
        keys, PhysicalType.INT32 if keys.dtype.itemsize == 4 else PhysicalType.INT64)
    np.testing.assert_array_equal(got[0], oracle_d)
    np.testing.assert_array_equal(got[1], oracle_i)


def _strings(case: str, rng) -> list:
    if case == "pool":
        pool = [b"cat_%03d" % j for j in range(100)]
        return [pool[k] for k in rng.integers(0, 100, 5000)]
    if case == "random_lengths":
        return [bytes(rng.integers(97, 123, rng.integers(0, 14)).astype(np.uint8))
                for _ in range(3000)]
    if case == "empties":
        return [b""] * 50 + [b"a", b"", b"a\x00"]
    return [b"%026x" % v for v in rng.integers(0, 1 << 60, 4000)]  # high cardinality


@pytest.mark.parametrize("max_k", [None, 150])
@pytest.mark.parametrize("case", ["pool", "random_lengths", "empties", "hex"])
def test_dict_build_bytes(libs, case, max_k):
    from kpw_tpu.core.bytecol import ByteColumn

    port, ref = libs
    vals = _strings(case, np.random.default_rng(len(case)))
    col = ByteColumn.from_list(vals)
    got = port.dict_build_bytes(col.data, col.offsets, max_k)
    want = ref.dict_build_bytes(col.data, col.offsets, max_k)
    if want is None:
        assert got is None and len(set(vals)) > max_k
        return
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    oracle_d, oracle_i = enc.dictionary_build(vals, PhysicalType.BYTE_ARRAY)
    assert [vals[p] for p in got[0]] == list(oracle_d)
    np.testing.assert_array_equal(got[1], oracle_i)


def _rle_inputs(width: int, rng) -> list:
    top = 1 << width
    runs = np.repeat(rng.integers(0, top, 200, dtype=np.uint64), rng.integers(1, 30, 200))
    return [np.zeros(0, np.uint32), np.full(1, top - 1, np.uint32),
            rng.integers(0, top, 1001, dtype=np.uint64).astype(np.uint32),
            runs.astype(np.uint32), np.full(5000, top // 2, np.uint32)]


@pytest.mark.parametrize("width", [0, 1, 2, 3, 7, 8, 13, 16, 24, 32])
def test_rle_hybrid(libs, width):
    port, ref = libs
    for v in _rle_inputs(width, np.random.default_rng(width)):
        got = port.rle_hybrid(v, width)
        assert got == ref.rle_hybrid(v, width)
        assert got == enc.rle_hybrid_encode(v, width)


@pytest.mark.parametrize("bit_size", [32, 64])
def test_delta_binary_packed(libs, bit_size):
    port, ref = libs
    rng = np.random.default_rng(bit_size)
    itype = np.int64 if bit_size == 64 else np.int32
    info = np.iinfo(itype)
    for v in (np.zeros(0, itype), np.array([5], itype),
              np.resize(np.array([0, info.max, info.min, 17, -1], itype), 1000),
              np.cumsum(rng.integers(0, 9, 4099)).astype(itype),
              rng.integers(info.min, info.max, 3000, dtype=itype, endpoint=True)):
        got = port.delta_binary_packed(v, bit_size)
        assert got == ref.delta_binary_packed(v, bit_size)
        assert got == enc.delta_binary_packed_encode(v, bit_size)


@pytest.mark.parametrize("dtype,pt", [(np.float32, PhysicalType.FLOAT),
                                      (np.float64, PhysicalType.DOUBLE),
                                      (np.int32, PhysicalType.INT32),
                                      (np.int64, PhysicalType.INT64)])
def test_byte_stream_split(libs, dtype, pt):
    port, ref = libs
    rng = np.random.default_rng(3)
    for n in (0, 1, 7, 4099):
        v = (rng.standard_normal(n) * 1e3).astype(dtype)
        got = port.byte_stream_split(v)
        assert got == ref.byte_stream_split(v)
        assert got == enc.byte_stream_split_encode(v, pt)


@pytest.mark.parametrize("case", ["pool", "random_lengths", "empties", "hex"])
def test_byte_array_plain_gather_and_min_max(libs, case):
    from kpw_tpu.core.bytecol import ByteColumn

    port, ref = libs
    rng = np.random.default_rng(11)
    vals = _strings(case, rng)
    col = ByteColumn.from_list(vals)
    got = port.byte_array_plain(col.data, col.offsets)
    assert got == ref.byte_array_plain(col.data, col.offsets)
    assert got == enc.plain_encode(vals, PhysicalType.BYTE_ARRAY)
    idx = rng.integers(0, len(vals), 777).astype(np.int32)
    assert port.byte_array_gather(col.data, col.offsets, idx) == \
        ref.byte_array_gather(col.data, col.offsets, idx)
    mn, mx = port.bytes_min_max(col.data, col.offsets)
    assert (mn, mx) == ref.bytes_min_max(col.data, col.offsets)
    assert (vals[mn], vals[mx]) == (min(vals), max(vals))


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.uint64, np.uint32])
def test_int_stats(libs, dtype):
    port, ref = libs
    rng = np.random.default_rng(4)
    v = (rng.integers(0, 3000, 5000) * 25 + 100).astype(dtype)
    assert port.int_stats(v) == ref.int_stats(v)
    assert port.int_stats(v)[:2] == (int(v.min()), int(v.max()))
    assert port.int_stats(v[:0]) is None


def test_parallel_builds_compile_once(monkeypatch, tmp_path):
    """Callers racing on one cold build directory (test workers, threads)
    compile an artifact once, under the directory's lock, and all get the
    finished file."""
    src = tmp_path / "a.cc"
    src.write_text("// source\n")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_LOCK", str(tmp_path / "_build" / "native.lock"))
    compiles = []
    inside = threading.Lock()

    def fake_compile(args, check, capture_output):
        assert inside.acquire(blocking=False), "two compiles ran at once"
        try:
            compiles.append(args)
            out = args[args.index("-o") + 1]
            with open(out, "wb") as f:
                f.write(b"built")
        finally:
            inside.release()

    monkeypatch.setattr(build.subprocess, "run", fake_compile)
    so = str(tmp_path / "_build" / "x.so")
    paths = []
    threads = [threading.Thread(target=lambda: paths.append(
        build._locked_build(so, [str(src)], "tag", []))) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert paths == [so] * 6 and len(compiles) == 1
    with open(so, "rb") as f:
        assert f.read() == b"built"
    assert sorted(os.listdir(tmp_path / "_build")) == ["native.lock", "x.so", "x.so.hosttag"]


def test_failed_build_falls_through_to_python(monkeypatch):
    """A build that fails at every flag level warns and leaves lib() None
    (the port's CpuChunkEncoder keeps working); the error is kept."""
    def no_compiler(*args, **kwargs):
        raise RuntimeError("g++ failed at every flag level")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_tried", False)
    monkeypatch.setattr(native, "errors", {})
    monkeypatch.setattr(build, "build_lib", no_compiler)
    with pytest.warns(UserWarning, match="native library unavailable"):
        assert native.lib() is None
    assert "every flag level" in native.errors["lib"]


_NO_LIBSNAPPY_PROBE = """
import numpy as np
from kpw_tpu import native as jax_native
from kpw_tpu.core import compression as jax_comp
from kpw_tpu_torch import native
from kpw_tpu_torch.core import compression
rng = np.random.default_rng(1)
for data in (b"a", b"abcabcabc" * 999, bytes(rng.integers(0, 8, 200_000, dtype=np.uint8))):
    got = compression.snappy_compress(data)
    assert got == jax_comp.snappy_compress(data) == jax_native.lib().snappy_compress(data)
    assert compression.snappy_decompress(got) == data
print("ok")
"""


def test_snappy_without_libsnappy_equals_jax():
    """A host without libsnappy (KPW_SNAPPY_LIB="" opts the library's
    runtime dispatch out) compresses SNAPPY with the library's own
    compressor, and the port's core.compression writes the JAX package's
    bytes there too: before the port had its native library it raised
    there, for want of a system libsnappy."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _NO_LIBSNAPPY_PROBE], cwd=root,
                         env=dict(os.environ, KPW_SNAPPY_LIB=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _orders(n):
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from proto_helpers import nested_message_classes

    Order = nested_message_classes()
    rng = np.random.default_rng(21)
    payloads = []
    for i in range(n):
        o = Order(order_id=int(rng.integers(0, 1 << 40)))
        for _ in range(int(rng.integers(0, 4))):
            it = o.items.add()
            it.sku = f"sku{int(rng.integers(0, 9))}"
            if rng.random() < 0.6:
                it.qty = int(rng.integers(0, 99))
            it.tags.extend(f"t{k}" for k in range(int(rng.integers(0, 3))))
        if i % 3:
            o.note = "n"
        payloads.append(o.SerializeToString())
    return Order, payloads


def test_wire_shred_entries(libs):
    """The ctypes wire-shred entries (flat ``proto_shred``, nested
    ``proto_shred_nested`` with its ``NestedShredResult``, and
    ``gather_spans``) of both libraries, on the plans each package's
    columnarizer builds for the same messages."""
    from kpw_tpu.models.proto_bridge import ProtoColumnarizer as JaxColumnarizer
    from kpw_tpu_torch.models.proto_bridge import _K_SPAN, _K_SPAN_UTF8, ProtoColumnarizer

    port, ref = libs
    Order, payloads = _orders(400)
    offs = np.concatenate([[0], np.cumsum([len(p) for p in payloads])]).astype(np.int64)
    buf = b"".join(payloads)
    got = []
    for lib, cls in ((port, ProtoColumnarizer), (ref, JaxColumnarizer)):
        col = cls(Order)
        assert col.wire_capable
        res = lib.proto_shred_nested(buf, offs, col._nested)
        assert not isinstance(res, int)
        try:
            out = []
            for li in range(len(col.schema.columns)):
                defs, reps = res.levels(li)
                if col._nested.leaf_kinds[li] in (_K_SPAN, _K_SPAN_UTF8):
                    pos, ln = res.spans(li)
                    out.append((defs.tolist(), reps.tolist(),
                                lib.gather_spans(buf, pos, ln), ln.tolist()))
                else:
                    out.append((defs.tolist(), reps.tolist(),
                                res.values(li, col._nested.leaf_dtypes[li]).tolist()))
        finally:
            res.close()
        got.append(out)
        # a truncated record: both report the same failing index
        bad = list(payloads)
        bad[123] = bad[123][:-1]
        boffs = np.concatenate([[0], np.cumsum([len(p) for p in bad])]).astype(np.int64)
        got[-1].append(lib.proto_shred_nested(b"".join(bad), boffs, col._nested))
    assert got[0] == got[1]
    assert got[0][-1] == 123
    # flat: a fixed-width column and a span column through proto_shred
    from proto_helpers import sample_message_class

    cls = sample_message_class()
    msgs = [cls(query=f"q{i}", timestamp=i * 7, page_number=i).SerializeToString()
            for i in range(300)]
    offs = np.concatenate([[0], np.cumsum([len(p) for p in msgs])]).astype(np.int64)
    buf = b"".join(msgs)
    flat = []
    for lib, colcls in ((port, ProtoColumnarizer), (ref, JaxColumnarizer)):
        plan = colcls(cls)._wire_plan()
        outs = colcls(cls)._alloc_flat_outputs(plan, len(msgs))
        rc = lib.proto_shred(buf, offs, len(plan.fnum), plan.fnum, plan.kinds,
                             plan.flags, *outs)
        flat.append((rc, [[None if a is None else a.tolist() for a in arrs]
                          for arrs in outs]))
    assert flat[0] == flat[1] and flat[0][0] == -1
