"""The port's encoder selection (``kpw_tpu_torch.runtime.select``): its
backend names, the device rule (``"cuda"`` and ``"auto"`` raise without a
card unless ``device="cpu"``), ``"auto"``'s rule on set measurements, and
``make_encoder("native" | "cpu")`` files equal to the JAX package's
``make_encoder``'s on the same data."""

import io

import numpy as np
import pytest
import torch

import kpw_tpu.core as J
import kpw_tpu.runtime.select as JS
import kpw_tpu_torch.core as T
from kpw_tpu_torch.core.pages import CpuChunkEncoder
from kpw_tpu_torch.native.encoder import NativeChunkEncoder
from kpw_tpu_torch.ops.backend import CudaChunkEncoder
from kpw_tpu_torch.parallel.mesh_encoder import MeshChunkEncoder
from kpw_tpu_torch.runtime import select as S

torch.set_num_threads(1)


@pytest.fixture
def fresh_caches(monkeypatch):
    monkeypatch.setattr(S, "_probe_cached", {})


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_backend_names():
    assert S.BACKENDS == ("auto", "cuda", "native", "cpu")
    opts = T.WriterProperties().encoder_options()
    assert type(S.make_encoder(opts, "native")) is NativeChunkEncoder
    assert type(S.make_encoder(opts, "cpu")) is CpuChunkEncoder
    # "mesh" is no member of "auto"'s choice, but a backend of its own
    assert type(S.make_encoder(opts, "mesh", device="cpu")) is MeshChunkEncoder
    assert S.check_backend("mesh", device="cpu") == "mesh"
    for bad in ("tpu", "gpu", ""):
        with pytest.raises(ValueError, match="unknown encoder backend"):
            S.check_backend(bad)
        with pytest.raises(ValueError, match="unknown encoder backend"):
            S.make_encoder(opts, bad)


def test_card_backends_raise_without_a_card(monkeypatch, fresh_caches):
    _no_cuda(monkeypatch)
    opts = T.WriterProperties().encoder_options()
    for backend in ("cuda", "auto", "mesh"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            S.check_backend(backend)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            S.make_encoder(opts, backend)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.probe_link()
    # the host encoders need no card
    assert S.check_backend("native") == "native"
    assert S.check_backend("cpu") == "cpu"


def test_cpu_device_gives_a_cpu_card_encoder(monkeypatch):
    _no_cuda(monkeypatch)
    opts = T.WriterProperties().encoder_options()
    enc = S.make_encoder(opts, "cuda", device="cpu")
    assert type(enc) is CudaChunkEncoder and enc.device.type == "cpu"
    assert enc.stream is None
    assert S.check_backend("cuda", "cpu") == "cuda"
    assert S.check_backend("auto", "cpu") == "auto"
    link = S.probe_link("cpu")
    assert link == {"device": "cpu", "h2d_mbps": float("inf"), "launch_ms": 0.0}


def _batches(rng, n_groups=3, rows=6000):
    """Config 1's streaming shape as row groups."""
    schema = T.Schema([T.leaf(f"i{k}", "int64") for k in range(8)]
                      + [T.leaf(f"s{k}", "string") for k in range(4)])
    pool = [b"cat_%03d" % j for j in range(100)]
    out = []
    for _ in range(n_groups):
        arrays = {f"i{k}": rng.integers(0, 1_000_000, rows).astype(np.int64)
                  for k in range(8)}
        arrays |= {f"s{k}": [pool[j] for j in rng.integers(0, 100, rows)]
                   for k in range(4)}
        out.append(T.columns_from_arrays(schema, arrays))
    return schema, out


def _write(schema, props, encoder, batches):
    buf = io.BytesIO()
    w = T.ParquetFileWriter(buf, schema, props, encoder=encoder)
    for b in batches:
        w.write_batch(b)
        w.flush_row_group()
    w.close()
    return buf.getvalue()


@pytest.mark.parametrize("cuda, native, want", [
    (1.0, 2.0, "cuda"), (2.0, 1.0, "native"), (1.0, 1.0, "native")])
def test_auto_rule_on_set_measurements(monkeypatch, fresh_caches, cuda, native, want):
    """``"auto"`` times the writer's first row group through both encoders
    (a warm-up encode each, then the better of two) and keeps the faster,
    whatever the link (an H100's passes the JAX package's limits); a tie
    keeps the host C++.  The choice, made once, holds for every later
    encoder of the writer; the file is the same bytes either way."""
    seconds = {CudaChunkEncoder: cuda, NativeChunkEncoder: native}
    calls = []
    clock = [0.0]
    real_encode = {cls: cls.encode_many for cls in seconds}

    def timed(cls):
        def encode_many(self, chunks, base_offset):
            calls.append(cls)
            clock[0] += seconds[cls]
            return real_encode[cls](self, chunks, base_offset)
        return encode_many

    for cls in seconds:
        monkeypatch.setattr(cls, "encode_many", timed(cls))
    monkeypatch.setattr(S.time, "perf_counter", lambda: clock[0])
    monkeypatch.setattr(S, "probe_link", lambda device: {
        "device": "cuda:0", "h2d_mbps": 25_000.0, "launch_ms": 0.02})
    assert S.rule({"cuda": 1 / cuda, "native": 1 / native}) == want
    schema, batches = _batches(np.random.default_rng(3))
    props = T.WriterProperties(codec=T.Codec.SNAPPY)
    opts = props.encoder_options()
    choice = S.AutoChoice("cpu")
    enc = S.make_encoder(opts, "auto", "cpu", choice)
    assert type(enc) is S.CalibratingEncoder and choice.backend is None
    got = _write(schema, props, enc, batches)
    assert calls[:6] == [CudaChunkEncoder, NativeChunkEncoder] * 3
    assert choice.backend == want
    assert choice.rows_per_s == {"cuda": 6000 / cuda, "native": 6000 / native}
    assert choice.link["h2d_mbps"] == 25_000.0
    later = S.make_encoder(opts, "auto", "cpu", choice)
    assert type(later) is {"cuda": CudaChunkEncoder, "native": NativeChunkEncoder}[want]
    assert got == _write(schema, props, S.make_encoder(opts, "cpu"), batches)


def test_auto_through_the_builder():
    """A Builder with ``"auto"`` on the CPU: the writer's choice is made on
    its first row group and recorded on ``encoder_choice``, and its files
    are the ``"cpu"`` encoder's bytes (the deterministic arm's settings)."""
    import time

    from kpw_tpu_torch import Builder, FakeBroker, MemoryFileSystem
    from proto_helpers import sample_message_class

    cls = sample_message_class()
    payloads = [cls(query=f"q{i % 17}", timestamp=i).SerializeToString()
                for i in range(40_000)]
    files, choices = {}, {}
    for backend in ("auto", "cpu"):
        broker = FakeBroker()
        broker.create_topic("t", 1)
        broker.produce_many("t", payloads)
        fs = MemoryFileSystem()
        w = (Builder().broker(broker).topic("t").proto_class(cls)
             .target_dir("/o").filesystem(fs).group_id("g").autotune(False)
             .encoder_backend(backend, device="cpu").pipeline(False)
             .batch_size(64).fetch_max_records(2048)
             .max_file_size(128 * 1024).block_size(64 * 1024)
             .max_file_open_duration_seconds(3600.0).build())
        w.start()
        try:
            deadline = time.monotonic() + 30
            while w.total_written_records < len(payloads):
                assert time.monotonic() < deadline, "not all written"
                time.sleep(0.002)
        finally:
            w.close(deadline=30)
        files[backend] = [fs.open_read(f).read()
                          for f in sorted(fs.list_files("/o", extension=".parquet"))]
        choices[backend] = w.encoder_choice
    assert choices["cpu"] is None
    assert choices["auto"].backend in ("cuda", "native")
    assert set(choices["auto"].rows_per_s) == {"cuda", "native"}
    n = min(len(files["auto"]), len(files["cpu"]))
    assert n >= 2 and files["auto"][:n] == files["cpu"][:n]


def _file(core, encoder, schema, arrays, props):
    buf = io.BytesIO()
    w = core.ParquetFileWriter(buf, schema, props, encoder=encoder)
    w.write_batch(core.columns_from_arrays(schema, arrays))
    w.close()
    return buf.getvalue()


@pytest.mark.parametrize("codec", ["UNCOMPRESSED", "SNAPPY", "GZIP"])
@pytest.mark.parametrize("backend", ["native", "cpu"])
def test_make_encoder_files_equal_jax(backend, codec):
    rng = np.random.default_rng(12)
    n = 20_000
    ints = rng.integers(0, 1_000, n).astype(np.int64)
    wide = rng.integers(-1 << 40, 1 << 40, n).astype(np.int64)
    words = [b"w%d" % k for k in rng.integers(0, 50, n)]
    vals = rng.normal(size=n)
    mask = rng.random(n) > 0.1
    files = []
    for core, sel in ((T, S), (J, JS)):
        schema = core.Schema([core.leaf("a", "int64"), core.leaf("b", "int64"),
                              core.leaf("s", "string"),
                              core.leaf("o", "double", core.Repetition.OPTIONAL)])
        props = core.WriterProperties(codec=getattr(core.Codec, codec))
        files.append(_file(core, sel.make_encoder(props.encoder_options(), backend),
                           schema, {"a": ints, "b": wide, "s": words,
                                    "o": (vals, mask)}, props))
    assert files[0] == files[1]
