"""The port stands alone and keeps its device rule.

- ``kpw_tpu_torch`` and every submodule import in a fresh interpreter in
  which importing ``jax`` or ``kpw_tpu`` raises;
- without CUDA, the entry points asked for the card raise instead of
  running on the CPU; a kernel wrapper handed a CUDA tensor goes for its
  kernel and raises where the kernel cannot be built, never running its
  plain version; and the wrappers refuse tensors on any device other than
  the CPU (plain version) or CUDA (kernel);
- work on CPU tensors launches no kernel: every launch counter stays 0;
- the port's native host library builds only from its own sources
  (``kpw_tpu_torch/native/src``) into ``kpw_tpu_torch/_build``, its wire
  shred extension under the port's own module name, and
  ``CudaChunkEncoder`` refuses to run without it;
- the smoke run's stream phase, rehearsed at 20,000 records on the CPU,
  runs in an interpreter that refuses ``jax``, ``kpw_tpu`` and
  ``google.protobuf`` alike (and so do the worker processes it spawns):
  the streaming writer's wire path needs no protobuf;
- a spawned process-worker child rebuilds a descriptor stand-in class from
  its spec and shreds with it, with none of ``jax``, ``kpw_tpu`` or
  ``google`` in its ``sys.modules``.
"""

import io
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import kpw_tpu_torch.core as T
from kpw_tpu_torch.entry import entry
from kpw_tpu_torch import native
from kpw_tpu_torch.native import build as native_build
from kpw_tpu_torch.ops import _build, backend, bitpack, delta, dictionary, rank, strings
from kpw_tpu_torch.parallel import mesh
from kpw_tpu_torch.parallel.mesh_encoder import MeshChunkEncoder
from kpw_tpu_torch.parallel.sharded import (encode_step_single, sharded_encode_step,
                                            sharded_encode_step_bounded)

# Small inputs: more intra-op threads would only contend for the CPU
# with the suite's other test workers.
torch.set_num_threads(1)

_REFUSE = textwrap.dedent("""
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "kpw_tpu") + EXTRA
    REFUSED = []  # every refused import, also one a caller swallowed

    def blocked(name):
        return any(name == b or name.startswith(b + ".") for b in BLOCKED)

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                REFUSED.append(name)
                raise ImportError(f"the port must not import {name}")
            return None

    for name in [m for m in sys.modules if blocked(m)]:
        del sys.modules[name]
    sys.meta_path.insert(0, Refuse())
""")

_IMPORT_PROBE = "EXTRA = ()\n" + _REFUSE + textwrap.dedent("""
    import kpw_tpu_torch
    names = ["kpw_tpu_torch"]
    for info in pkgutil.walk_packages(kpw_tpu_torch.__path__, "kpw_tpu_torch."):
        importlib.import_module(info.name)
        names.append(info.name)
    leaked = sorted(m for m in sys.modules if blocked(m))
    assert not leaked, leaked
    print(len(names), " ".join(names))
""")


def test_port_imports_without_jax_or_kpw_tpu():
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _IMPORT_PROBE], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, names = out.stdout.split(None, 1)
    for mod in ("kpw_tpu_torch.ops.backend", "kpw_tpu_torch.ops.bitpack",
                "kpw_tpu_torch.ops.rank", "kpw_tpu_torch.ops.dictionary",
                "kpw_tpu_torch.ops.levels", "kpw_tpu_torch.ops.delta",
                "kpw_tpu_torch.ops.bss", "kpw_tpu_torch.ops.packing",
                "kpw_tpu_torch.parallel.sharded", "kpw_tpu_torch.entry",
                "kpw_tpu_torch.core.writer", "kpw_tpu_torch.utils.tracing",
                "kpw_tpu_torch.ops.strings", "kpw_tpu_torch.native",
                "kpw_tpu_torch.native.build", "kpw_tpu_torch.native.encoder",
                "kpw_tpu_torch.utils.lockcheck", "kpw_tpu_torch.utils.schedcheck",
                "kpw_tpu_torch.models.proto_bridge", "kpw_tpu_torch.models.record_bridge",
                "kpw_tpu_torch.ingest.broker", "kpw_tpu_torch.ingest.offsets",
                "kpw_tpu_torch.ingest.autotune", "kpw_tpu_torch.ingest.consumer",
                "kpw_tpu_torch.io.fs", "kpw_tpu_torch.io.verify",
                "kpw_tpu_torch.runtime.retry", "kpw_tpu_torch.runtime.metrics",
                "kpw_tpu_torch.runtime.export", "kpw_tpu_torch.runtime.telemetry",
                "kpw_tpu_torch.runtime.watchdog", "kpw_tpu_torch.runtime.partition",
                "kpw_tpu_torch.runtime.parquet_file", "kpw_tpu_torch.runtime.select",
                "kpw_tpu_torch.runtime.writer", "kpw_tpu_torch.runtime.builder",
                "kpw_tpu_torch.runtime.procworkers", "kpw_tpu_torch.runtime.multiwriter",
                "kpw_tpu_torch.io.compact", "kpw_tpu_torch.parallel.mesh",
                "kpw_tpu_torch.parallel.dict_merge", "kpw_tpu_torch.parallel.mesh_encoder",
                "kpw_tpu_torch.io.objectstore", "kpw_tpu_torch.io.failover",
                "kpw_tpu_torch.io.faults", "kpw_tpu_torch.io.hdfs",
                "kpw_tpu_torch.ingest.faults", "kpw_tpu_torch.ingest.kafka_client"):
        assert mod in names.split()


# Probes that spawn worker processes run from a file: a spawned child
# runs the file's top level again (as ``__mp_main__``), so the refusal hook
# is live in the children too.
_STREAM_PROBE = "EXTRA = ('google',)\n" + _REFUSE + textwrap.dedent("""
    if __name__ == "__main__":
        import torch
        torch.set_num_threads(1)
        sys.path.insert(0, ".")
        import chip_smoke
        from kpw_tpu_torch.ops.bitpack import pack_pages
        from kpw_tpu_torch.ops.delta import delta_page_streams
        from kpw_tpu_torch.ops.rank import hist_dict, rank_pages

        counters = {"bitpack": pack_pages, "hist": hist_dict, "rank": rank_pages,
                    "delta": delta_page_streams}
        launches = chip_smoke.phase_stream(torch, counters, small=True, device="cpu")
        assert launches == dict.fromkeys(counters, 0), launches
        leaked = sorted(m for m in sys.modules if blocked(m))
        assert not leaked and not REFUSED, (leaked, REFUSED)
        print("stream ok")
""")


def _run_probe(tmp_path, probe: str, timeout: float):
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "probe.py"
    script.write_text(probe)
    out = subprocess.run([sys.executable, str(script)], cwd=root,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def test_stream_phase_runs_without_protobuf(tmp_path):
    """The stream phase at its rehearsal size (20,000 records, every arm —
    worker threads and worker processes — the deterministic arms and the
    routes arm, ``device="cpu"``) with ``jax``, ``kpw_tpu`` and ``google``
    refused, in the parent and in every child it spawns: records come
    from the smoke run's descriptor stand-ins and wire encoder, and the
    writer shreds them from the wire."""
    out = _run_probe(tmp_path, _STREAM_PROBE, 900)
    assert "stream ok" in out
    assert out.count("[stream deterministic]") == 2
    assert "[stream routes]" in out and "[stream cuda p4]" in out


_CHILD_PROBE = "EXTRA = ('google',)\n" + _REFUSE + textwrap.dedent("""
    import numpy as np

    def child(spec, payloads, q):
        from kpw_tpu_torch.models.proto_bridge import ProtoColumnarizer
        from kpw_tpu_torch.runtime.procworkers import _proto_class_from_spec

        cls = _proto_class_from_spec(spec)
        batch = ProtoColumnarizer(cls).columnarize_payloads(payloads)
        digest = [(np.asarray(c.values.offsets).tobytes() + bytes(c.values.data)
                   if hasattr(c.values, "offsets") else np.asarray(c.values).tobytes(),
                   None if c.def_levels is None else c.def_levels.tobytes(),
                   None if c.rep_levels is None else c.rep_levels.tobytes())
                  for c in batch.chunks]
        q.put((sorted(m for m in sys.modules if blocked(m)), REFUSED,
               type(cls.DESCRIPTOR).__module__, batch.num_rows, digest))

    if __name__ == "__main__":
        sys.path.insert(0, ".")
        import chip_smoke
        from kpw_tpu_torch.runtime import procworkers as pw

        order = chip_smoke.order_class()
        payloads = chip_smoke.order_payloads(
            *chip_smoke.order_rows(np.random.default_rng(5), 300))
        spec = pw._proto_spec(order)
        assert spec[0] == "snapshot", spec[0]
        q = pw._MP_CTX.Queue()
        p = pw._MP_CTX.Process(target=child, args=(spec, payloads, q))
        p.start()
        leaked, refused, module, rows, digest = q.get(timeout=300)
        p.join(60)
        assert p.exitcode == 0, p.exitcode
        assert not leaked and not refused, (leaked, refused)
        assert module == "kpw_tpu_torch.runtime.procworkers", module
        import queue

        local = queue.SimpleQueue()  # the same shred, in the parent
        child(spec, payloads, local)
        assert local.get()[3:] == (rows, digest) and rows == 300
        print("child ok")
""")


def test_spawned_child_rebuilds_standin_without_protobuf(tmp_path):
    """The descriptor spec of a stand-in class (the smoke run's ``Order``)
    crosses the spawn boundary as plain data: a child spawned by the
    process pool's own context rebuilds the class from it and shreds the
    config-5 records to the same columns as the parent, with none of
    ``jax``, ``kpw_tpu`` or ``google`` in its ``sys.modules`` and no
    import of them refused along the way."""
    assert "child ok" in _run_probe(tmp_path, _CHILD_PROBE, 300)


def _no_cuda(monkeypatch):
    """Pin 'no card' even on a machine that has one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(monkeypatch):
    _no_cuda(monkeypatch)
    opts = T.WriterProperties().encoder_options()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        backend.CudaChunkEncoder(opts)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        strings.device_string_dictionary(T.bytecol.ByteColumn.from_list([b"a"]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.make_mesh(8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MeshChunkEncoder(opts)
    # explicit CPU is the only way onto the CPU
    backend.CudaChunkEncoder(opts, device="cpu")
    MeshChunkEncoder(opts, device="cpu")
    entry(device="cpu")
    strings.device_string_dictionary(T.bytecol.ByteColumn.from_list([b"a"]),
                                     device="cpu")


@pytest.mark.parametrize("missing", ["lib", "assemble"])
def test_encoder_refuses_a_missing_native_build(monkeypatch, missing):
    """CudaChunkEncoder never runs the Python page loops its native
    superclass replaces: without the port's native library or assembler
    it raises, naming the build error."""
    monkeypatch.setattr(native, missing, lambda: None)
    monkeypatch.setattr(native, "errors", {missing: "RuntimeError('g++ failed')"})
    opts = T.WriterProperties().encoder_options()
    with pytest.raises(RuntimeError, match="native library and assembler.*g\\+\\+ failed"):
        backend.CudaChunkEncoder(opts, device="cpu")


def test_native_build_reads_only_the_ports_sources(monkeypatch, tmp_path):
    """Every g++ call of the port's native build compiles sources under
    kpw_tpu_torch/native/src only (none of the JAX package's) and writes
    under the build directory it was given; the wire shred extension is
    built and loaded under the port's own module name and ``PyInit``."""
    import os

    src_dir = os.path.join(os.path.dirname(T.__file__), os.pardir, "native", "src")
    src_dir = os.path.realpath(src_dir)
    assert native_build.SRC_DIR == src_dir
    assert native_build.BUILD_DIR == os.path.realpath(
        os.path.join(src_dir, os.pardir, os.pardir, "_build"))
    assert sorted(os.listdir(src_dir)) == [
        "assemble.cc", "codecs.cc", "encode.cc", "pyshred.cc", "shred.cc",
        "shred_nested.cc", "wire_common.h"]
    assert native_build.PYSHRED_NAME == "_kpw_torch_pyshred"
    with open(os.path.join(src_dir, "pyshred.cc")) as f:
        src = f.read()
    assert 'PyModuleDef_HEAD_INIT, "_kpw_torch_pyshred"' in src
    assert "PyInit__kpw_torch_pyshred" in src and "PyInit__kpw_pyshred" not in src
    shred = native.pyshred()  # the real build, before the g++ stand-in below
    assert shred.__name__ == "_kpw_torch_pyshred"
    assert shred.__file__ == native_build.PYSHRED_SO
    calls = []

    def fake_gcc(args, check, capture_output):
        calls.append(args)
        with open(args[args.index("-o") + 1], "wb") as f:
            f.write(b"so")

    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native_build, "_LOCK", str(tmp_path / "native.lock"))
    monkeypatch.setattr(native_build, "LIB_SO", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native_build, "ASSEMBLE_SO", str(tmp_path / "asm.so"))
    monkeypatch.setattr(native_build, "PYSHRED_SO", str(tmp_path / "shred.so"))
    monkeypatch.setattr(native_build.subprocess, "run", fake_gcc)
    native_build.build_lib()
    native_build.build_assemble()
    native_build.build_pyshred()
    assert len(calls) == 3
    for args in calls:
        sources = [a for a in args if a.endswith((".cc", ".c", ".cpp", ".h"))]
        assert sources and all(os.path.dirname(a) == src_dir for a in sources)
        assert os.path.dirname(args[args.index("-o") + 1]) == str(tmp_path)
    assert [os.path.basename(a) for a in calls[2] if a.endswith(".cc")] == [
        "pyshred.cc", "shred.cc", "shred_nested.cc"]


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card reaches neither
    the plain version nor a kernel."""
    pages = torch.empty((2, 256), dtype=torch.int32, device="meta")
    rt = torch.empty((2, 8, 64), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bitpack.bitpack_pages(pages, 5)
    with pytest.raises(ValueError, match="unsupported device"):
        bitpack.pack_pages(pages, None, 256, 5)
    with pytest.raises(ValueError, match="unsupported device"):
        rank.hist_pages(pages, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        rank.hist_dict(pages, 200, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        rank.rank_pages(pages, rt)
    with pytest.raises(ValueError, match="unsupported device"):
        delta.delta_page_streams(pages.to(torch.int64), np.zeros((1, 3), np.int32),
                                 64, 8)


def _wrapper_cases():
    """(module, wrapper, the function that counts its kernel's launches,
    plain versions it must not reach, inputs maker)."""
    def pages():
        return (torch.empty((2, 256), dtype=torch.int32, device="cuda"), 5)

    def windows():
        return (torch.empty((2, 256), dtype=torch.int32, device="cuda"),
                torch.empty((3, 3), dtype=torch.int32, device="cuda"), 256, 5)

    def values():
        return (torch.empty((2, 256), dtype=torch.int32, device="cuda"), 8)

    def counted():
        return (torch.empty((2, 256), dtype=torch.int32, device="cuda"), 200, 8)

    def counted_runs():
        return windows() + (True, None, True)  # stats, count, n_runs

    def streams():  # the page table stays on the host
        return (torch.empty((2, 300), dtype=torch.int64, device="cuda"),
                np.array([[0, 0, 300], [1, 5, 200], [0, 7, 1]], np.int32), 64, 8)

    def ranked():
        return (torch.empty((2, 256), dtype=torch.int32, device="cuda"),
                torch.empty((2, 8, 64), dtype=torch.int32, device="cuda"))

    pack_plain = ("pack_pages_plain", "bitpack_pages_plain")
    hist_plain = ("hist_dict_plain", "hist_pages_plain", "presence_to_dict")
    return {
        "bitpack": (bitpack, "bitpack_pages", "pack_pages", pack_plain, pages),
        "pack": (bitpack, "pack_pages", "pack_pages", pack_plain, windows),
        "pack_n_runs": (bitpack, "pack_pages", "pack_pages", pack_plain,
                        counted_runs),
        "delta": (delta, "delta_page_streams", "delta_page_streams",
                  ("delta_page_streams_plain",), streams),
        "hist": (rank, "hist_pages", "hist_dict", hist_plain, values),
        "hist_dict": (rank, "hist_dict", "hist_dict", hist_plain, counted),
        "rank": (rank, "rank_pages", "rank_pages", ("rank_pages_plain",), ranked),
    }


@pytest.mark.parametrize("case", ["bitpack", "pack", "pack_n_runs", "hist",
                                  "hist_dict", "rank", "delta"])
def test_wrappers_raise_on_cuda_tensors_without_the_toolkit(monkeypatch, case):
    """A CUDA tensor (a fake one: this PyTorch build cannot make real ones)
    sends each wrapper to its kernel, whose build raises for want of
    ``nvcc``; no plain version is called and nothing is counted."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CUDA build path is live")
    module, name, counter, plains, inputs = _wrapper_cases()[case]
    wrapper = getattr(module, name)
    counting = getattr(module, counter)

    def fell_back(*args, **kwargs):
        raise AssertionError(f"{name} fell back to a plain version")

    def no_nvcc():
        raise RuntimeError("nvcc not found: no CUDA toolkit here")

    for plain in plains:
        monkeypatch.setattr(module, plain, fell_back)
    monkeypatch.setattr(counting, "launches", 0)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(bitpack, "_fn", None)
    monkeypatch.setattr(rank, "_fns", {})
    monkeypatch.setattr(delta, "_fn", None)
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    with FakeTensorMode():
        args = inputs()
        assert args[0].device.type == "cuda"
        with pytest.raises(RuntimeError, match="nvcc not found"):
            wrapper(*args)
    assert counting.launches == 0


def test_device_paths_refuse_a_missing_card():
    """Without a card the device dictionary build raises, and without the
    CUDA toolkit the kernel build raises: neither runs anything elsewhere."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CUDA build path is live")
    values = np.arange(5000, dtype=np.int64) % 7
    # a CPU-only PyTorch build asserts, a CUDA build without a card raises
    with pytest.raises((RuntimeError, AssertionError), match="CUDA|NVIDIA"):
        dictionary.build_dictionaries([values], device="cuda")
    try:
        _build.nvcc_path()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build()
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.function("bitpack", "kpw_pack_pages", [])


_COUNTING = (bitpack.pack_pages, rank.hist_dict, rank.rank_pages,
             delta.delta_page_streams)


def test_cpu_tensors_launch_no_kernel(monkeypatch):
    # string dictionaries (the planner's pack jobs, the device probe) too
    for f in _COUNTING:
        monkeypatch.setattr(f, "launches", 0)
    rng = np.random.default_rng(0)
    lo = torch.from_numpy(rng.integers(0, 300, (4, 1024)).astype(np.int32))
    encode_step_single(lo, 1000, value_bound=300)  # bounded route
    encode_step_single(lo, torch.tensor(1000), value_bound=300)
    encode_step_single(lo, 1000)  # sort route
    cpu8 = mesh.make_mesh(8, device="cpu")  # the mesh steps over CPU shards
    counts = np.full(8, 128)
    sharded_encode_step(torch.zeros_like(lo), lo, counts, mesh=cpu8, cap=128)
    sharded_encode_step_bounded(lo, counts, mesh=cpu8, value_bound=300)
    rank.hist_pages(lo, 8)
    bitpack.bitpack_pages(lo, 9)
    schema = T.Schema([T.leaf("a", "int64"), T.leaf("b", "double")])
    props = T.WriterProperties()
    w = T.ParquetFileWriter(io.BytesIO(), schema, props,
                            encoder=backend.CudaChunkEncoder(
                                props.encoder_options(), min_device_rows=1,
                                device="cpu"))
    w.write_batch(T.columns_from_arrays(schema, {
        "a": rng.integers(0, 50, 5000).astype(np.int64),
        "b": rng.choice(rng.normal(size=9), 5000)}))
    w.close()
    # levels, delta and BYTE_STREAM_SPLIT pages on the CPU too
    schema = T.Schema([T.leaf("o", "int64", T.Repetition.OPTIONAL),
                       T.leaf("t", "int64"), T.leaf("f", "double")])
    props = T.WriterProperties(encodings={"t": "DELTA_BINARY_PACKED",
                                          "f": "BYTE_STREAM_SPLIT"})
    w = T.ParquetFileWriter(io.BytesIO(), schema, props,
                            encoder=backend.CudaChunkEncoder(
                                props.encoder_options(), min_device_rows=1,
                                device="cpu"))
    w.write_batch(T.columns_from_arrays(schema, {
        "o": (rng.integers(0, 50, 5000).astype(np.int64), rng.random(5000) > 0.5),
        "t": np.cumsum(rng.integers(0, 9, 5000)).astype(np.int64),
        "f": rng.normal(size=5000)}))
    w.close()
    schema = T.Schema([T.leaf("s", "string")])
    w = T.ParquetFileWriter(io.BytesIO(), schema, props,
                            encoder=backend.CudaChunkEncoder(
                                props.encoder_options(), min_device_rows=1,
                                device="cpu"))
    words = [b"w%d" % k for k in rng.integers(0, 30, 5000)]
    w.write_batch(T.columns_from_arrays(schema, {"s": words}))
    w.close()
    strings.device_string_dictionary(T.bytecol.ByteColumn.from_list(words),
                                     device="cpu")
    assert tuple(f.launches for f in _COUNTING) == (0, 0, 0, 0)
