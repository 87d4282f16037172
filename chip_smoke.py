#!/usr/bin/env python3
"""Smoke run of kpw_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero before the result lines:

1. card  — the card's name and power limit (nvidia-smi) and PyTorch's name;
2. build — compile the port's CUDA kernels from ``kpw_tpu_torch/csrc`` and,
   beside them, its native host library and page assembler from
   ``kpw_tpu_torch/native/src`` (g++); then the native phase: ``has_zstd``,
   the assembler's ``OP_KINDS`` (must be 5), whether libsnappy was found,
   the library's Snappy round trip, ``dict_build_bytes`` against
   ``core.encodings.dictionary_build`` and ``rle_hybrid`` against
   ``core.encodings.rle_hybrid_encode``;
3. kernels — every kernel against its plain PyTorch version on the card,
   element for element (the fused pack on unaligned, ragged, past-the-end
   windows at every width, with and without its run count; the hist +
   dictionary kernel on columns with few distinct values, ragged counts
   and dictionaries narrower and wider than its table; the delta kernel
   byte for byte on both rings, wraparound edges, every width bucket, a
   violated width budget, ragged counts, pages of 1 to 1,024 blocks and a
   launch of 65,536 blocks, more than the card keeps resident, through the
   look-back, each page with its header also against ``core.encodings``),
   then each timed with CUDA events (median
   of 25 runs, L2 flushed before each) beside its plain version, the
   PyTorch library call that computes the same function, and its memory
   bound — the pack, hist and rank at the flagship shape (the pack without
   its run count); the unfused routes (tensor ops around a kernel) against
   the fused kernels, in turns;
4. flagship — ``entry()`` and ``encode_step_single`` at 64 x 65,536 on the
   sort route and both bounded routes, each run once and equal to the same
   step run on the CPU (plain versions);
5. writers — six tables through ``ParquetFileWriter`` + ``CudaChunkEncoder``,
   each row group by row group and through the writer's pipeline, and
   through the port's ``NativeChunkEncoder`` (host C++), each of the four
   files equal byte for byte to the one the port's ``CpuChunkEncoder``
   writes: ``writer``, a taxi-shaped 64-column table, 1,048,576 rows in
   four row groups; ``levels``, the same table with optional columns
   (rep/def level pages); ``nested``, BASELINE config 5's 32,768 orders
   serialized and shredded from the wire by the port's
   ``ProtoColumnarizer`` (rep levels); ``encodings``, the adaptive-encodings
   corpus, 400,000 rows, with delta and BYTE_STREAM_SPLIT overrides;
   ``strings``, BASELINE config 1 (8 int64 and 4 string columns, SNAPPY),
   1,048,576 rows in four row groups, whose string dictionaries are built
   by the host hash and their pages packed on the card; ``cfg3``, BASELINE
   config 3's encode-side arm (4 timestamp and 4 hex-string columns,
   UNCOMPRESSED, delta fallback), 524,288 rows in four row groups.  Every
   ``CudaChunkEncoder`` column chunk must go through the native assembler,
   and no level page through the Python run-list replay; the delta paths
   make one delta launch per ring a row group; after each path its kernels
   are replayed on the inputs it gave them (every pack job, every level
   batch and page table through the pack with its run count, every delta
   launch of either ring) against their plain versions, exactly, and the
   delta paths print the bytes their first row group's delta launches read
   back; beside each path, what ``"auto"`` (``runtime/select.py``) picks
   and which of the card and the host C++ wrote it faster;
6. stream — the streaming writer through its public API, ``Builder`` →
   ``start()`` → poll → wire shred → append → row groups encoded → size and
   time rotation → durable publish on a local filesystem → offset ack →
   ``close()``, on BASELINE config 1's records in the shape of the JAX
   package's e2e probe: 400,000 records, serialized by this script (its
   descriptor stand-ins need no protobuf), on a 4-partition ``FakeBroker``
   topic.  Arms ``"cuda"`` with 1 and 4 worker threads, ``"native"`` with
   1 and 4, and ``"auto"`` with 1, then ``"cuda"`` and ``"native"`` with 1
   and 4 worker processes (spawned children, each with its own encoder;
   at the reference's in-flight bound of 8 units and at 64): each must
   drain to every offset committed with ack-lag 0, every published file
   must pass the port's ``verify_file`` and the footers' rows sum to
   400,000; a card arm with threads must launch the pack kernel, and every
   child of a card arm with processes must ship the ``encode.launch``
   spans of its ``CudaChunkEncoder`` (the parent's counters see no
   child's launch); each prints records/s to all written, the start-up
   to the first record written and records/s after it, the drain time,
   rows per row group and files, beside ``os.cpu_count()`` and the CPU
   affinity; one card arm prints its stage spans and, run again under the
   profiler, the card's busy share.  Then the deterministic arm (one
   partition, one thread, autotune, time rotation and the row-group
   pipeline off) and its process twin (one process): each one's
   ``"cuda"``, ``"native"`` and ``"cpu"`` files byte-identical, file for
   file; then the routes arm: config 1's records and config 5's orders
   through one ``MultiWriter`` (``Builder.route``), ``"cuda"`` on every
   route, both drained with ack-lag 0, files verified, the pack kernel
   launched; then the sink arms, each with the thread arms' settings and
   one worker thread: ``"mesh"`` (one shard per visible card),
   ``"cuda"`` through ``Builder.object_store`` onto an
   ``EmulatedObjectStore`` (every object read back from the store, no
   multipart upload left pending), and ``"cuda"`` on a
   ``FailoverFileSystem`` whose primary, a ``FaultInjectingFileSystem``
   over a local directory, fails every open with ENOSPC until it is
   healed after the first spill to the fallback, a second local
   directory (every spill reconciled onto the primary before the check,
   none left on the fallback), each beside the ``"cuda"`` x1 arm's
   records/s;
7. mesh — BASELINE config 4 (bench.py:1350-1357): 16 columns of 8 x
   131,072 values from [0, 1000), seed 4, through ``sharded_encode_step``
   (the gather route, cap 2,048) and ``sharded_encode_step_bounded`` (the
   histogram-psum route) over 8 shards on ``cuda:0``, then over 1 shard:
   dictionaries, k and packed bytes equal to a numpy oracle (``np.unique``,
   ``searchsorted``, ``core.encodings.bitpack``) and to the same call on
   CPU shards; each bounded step launches the hist and rank kernels once
   a shard, every step the pack kernel once a shard, and every hist and
   rank launch is replayed on the inputs the mesh gave it against its
   plain version.  Then config 4's writer route (bench.py:1499-1512
   column classes ``zone``, ``cents``, ``wide``): 4 row groups of 262,144
   rows through ``MeshChunkEncoder`` over 8 shards on ``cuda:0``, the file
   byte-identical to ``CpuChunkEncoder``'s, ``zone`` and ``cents`` on the
   bounded route and ``wide`` (negative values) on the gather route;
8. timing — the delta kernel at the shapes the ``encodings`` and ``cfg3``
   paths gave it, launched alone (CUDA events and the profiler's kernel
   time) and with its staging, beside its plain version and the time of a
   one-element PyTorch op on the same stream; each flagship route's step time and device profile (device ops
   per step), the dictionary build's two routes on one row group's
   columns, one row group's pack jobs through the fused kernel and the
   unfused route in turns, and one row group of each writer path: median
   stage spans of five runs and device profile (device ops, busy time,
   copy time); the device string dictionary probe
   (``ops.strings``) on config 1's four string columns and on the
   encodings corpus's 13-byte ``uid`` column, each equal to
   ``core.encodings.dictionary_build``, its phases beside the native
   hash's time; each config-4 route's step time over 8 shards and over 1
   (CUDA events, median of 25) with the merge's payload bytes, one shard's
   hist and rank kernel times, and the gather merge's two rank methods.

Phases 4, 5, 6 and 7 are the main paths: every launch count is set to 0 just
before each of them (each arm of phase 6) and read just after, and a kernel
of the path that never launched fails the run; the ``launches`` reported
are their sum (a process arm's launches happen in its children and show
as their spans, not in these counts).
The taxi writer must make exactly one pack launch a job and no padded
index copy; each other writer path must call its device routes (level
statistics and run extraction, delta pages, the BYTE_STREAM_SPLIT
transpose, the string planner's pack jobs).  The line before the last is
one JSON object with a record per kernel (the delta kernel's at the
``encodings`` shape); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
C_FLAG, N_FLAG = 64, 65536  # flagship shape: the bench probe's 64 x 65,536
TAXI_COLS, TAXI_ROWS, TAXI_GROUPS = 64, 262_144, 4
NESTED_ROWS, NESTED_GROUPS = 32_768, 4  # BASELINE config 5: bench.py:1588
ENC_ROWS, ENC_BATCHES = 400_000, 8  # the encodings corpus: bench.py:4928
CFG1_ROWS, CFG1_GROUPS = 262_144, 4  # BASELINE config 1: bench.py:131, 300-323
CFG3_ROWS, CFG3_GROUPS = 131_072, 4  # BASELINE config 3: bench.py:1233-1249
STREAM_RECORDS, STREAM_SMALL = 400_000, 20_000  # the e2e probe: bench.py:3908
# BASELINE config 4 (bench.py:1350-1357): 16 columns, 8 shards x 131,072
# rows of values from [0, 1000), seed 4; the gather route's cap 2,048
CFG4_COLS, CFG4_SHARDS, CFG4_PER, CFG4_VMAX, CFG4_CAP = 16, 8, 1 << 17, 1000, 2048
CFG4_SMALL_PER = 1024
# config 4's writer route (bench.py:1499-1512 column classes): 4 row groups
CFG4_ROWS, CFG4_GROUPS, CFG4_SMALL_ROWS = 262_144, 4, 16_384


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Median CUDA-event time of a callable, with the L2 cache (50 MB on an
    H100) flushed before every timed run by overwriting a larger buffer."""

    def __init__(self, torch, reps: int = 25, warmup: int = 3) -> None:
        self.torch = torch
        self.reps = reps
        self.warmup = warmup
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, setup=None) -> float:
        """``setup``, when given, runs before each run of ``fn``, outside the
        timed interval and before the flush, so that, as for a call with no
        setup, the card is still flushing while the host launches ``fn``."""
        torch = self.torch
        for _ in range(self.warmup):
            if setup is not None:
                setup()
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
            if setup is not None:
                setup()
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def max_abs_err(torch, a, b) -> int:
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device 0: {torch.cuda.get_device_name(0)}; "
        f"{torch.cuda.device_count()} device(s)")
    return card


def phase_build() -> None:
    from kpw_tpu_torch.ops import _build

    t0 = time.perf_counter()
    seconds = _build.build()
    total = time.perf_counter() - t0
    say(f"[build] {len(seconds)} kernel(s) built in {total:.2f} s "
        f"(parallel nvcc; each: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()) + ")")
    for name in _build.SOURCES:
        with open(os.path.join(_build.BUILD_DIR, f"{name}.log")) as f:
            usage = [ln.split("info    :")[-1].strip() for ln in f
                     if "Used" in ln]
        say(f"[build] {name}: " + "; ".join(usage))


def start_native_build():
    """Build the port's native host library, page assembler and wire shred
    extension (g++) on a thread, so that they compile while ``nvcc`` builds
    the kernels; returns the thread and the seconds each build took, filled
    in when it ends."""
    import threading

    seconds: dict = {}

    def run():
        from kpw_tpu_torch import native

        t0 = time.perf_counter()
        native.lib()
        seconds["library"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        native.assemble()
        seconds["assembler"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        native.pyshred()
        seconds["shred extension"] = time.perf_counter() - t0

    thread = threading.Thread(target=run, name="native-build")
    thread.start()
    return thread, seconds


def phase_native(thread, seconds: dict) -> None:
    """The port's native host layer, built from ``kpw_tpu_torch/native/src``
    into ``kpw_tpu_torch/_build``: both artifacts load from there, the
    assembler carries every op kind (``OP_KINDS`` 5), and the library's
    Snappy round trip, bytes dictionary and RLE/bit-pack hybrid agree with
    the Python codecs and ``core.encodings``, exactly."""
    import ctypes

    from kpw_tpu_torch import native
    from kpw_tpu_torch.core import encodings as enc
    from kpw_tpu_torch.core.bytecol import ByteColumn
    from kpw_tpu_torch.core.schema import PhysicalType
    from kpw_tpu_torch.native import build

    thread.join()
    L, asm, pys = native.lib(), native.assemble(), native.pyshred()
    check(L is not None and asm is not None and pys is not None,
          f"the port's native library, assembler or shred extension did not "
          f"build: {native.errors}")
    check(L._c._name == build.LIB_SO and asm.__file__ == build.ASSEMBLE_SO
          and pys.__file__ == build.PYSHRED_SO and pys.__name__ == build.PYSHRED_NAME,
          f"native artifacts loaded from {L._c._name}, {asm.__file__}, "
          f"{pys.__file__} ({pys.__name__})")
    check(asm.OP_KINDS == 5, f"assembler OP_KINDS {asm.OP_KINDS}, not 5")
    try:
        ctypes.CDLL("libsnappy.so.1")
        snappy = "found (the library dispatches SNAPPY to it)"
    except OSError:
        snappy = "not found (the library's own Snappy compressor serves)"
    say(f"[native] built in "
        + " + ".join(f"{v:.2f} s ({k})" for k, v in seconds.items())
        + ", beside nvcc; has_zstd "
        f"{L.has_zstd}, assembler HAS_ZSTD {asm.HAS_ZSTD}, OP_KINDS "
        f"{asm.OP_KINDS}; libsnappy.so.1 {snappy}")
    rng = np.random.default_rng(2)
    corpus = [b"", b"a", b"abcabc" * 5_000,
              bytes(rng.integers(0, 256, 100_000, dtype=np.uint8)),
              bytes(rng.integers(0, 4, 300_000, dtype=np.uint8)),
              bytes(rng.integers(0, 256, 70_000, dtype=np.uint8)) * 3]
    for data in corpus:
        packed = L.snappy_compress(data)
        check(L.snappy_decompress(packed) == data,
              f"snappy round trip of {len(data)} bytes differs")
        parts, n = L.snappy_compress_parts([data[:len(data) // 2],
                                            memoryview(data)[len(data) // 2:]])
        check(L.snappy_decompress(bytes(parts[:n])) == data,
              f"snappy parts round trip of {len(data)} bytes differs")
    pool = [b"cat_%03d" % j for j in range(100)]
    for vals in ([pool[k] for k in rng.integers(0, 100, 20_000)],
                 [b"u%012d" % v for v in rng.integers(0, 10 ** 6, 5_000)],
                 [b""] * 10 + [b"a\x00", b"a", b"", b"ab"]):
        col = ByteColumn.from_list(vals)
        uniq_pos, idx = L.dict_build_bytes(col.data, col.offsets)
        want_d, want_i = enc.dictionary_build(vals, PhysicalType.BYTE_ARRAY)
        check([vals[p] for p in uniq_pos] == list(want_d)
              and np.array_equal(idx, want_i),
              f"dict_build_bytes differs from core.encodings on {len(vals)} values")
    cases = 0
    for width in (0, 1, 3, 8, 13, 32):
        top = 1 << width
        for v in (rng.integers(0, top, 5_001, dtype=np.uint64).astype(np.uint32),
                  runs_of(rng, 5_000, 1, 40, top), np.full(3_000, top - 1, np.uint32),
                  np.zeros(0, np.uint32)):
            check(L.rle_hybrid(v, width) == enc.rle_hybrid_encode(v, width),
                  f"rle_hybrid width {width} differs from core.encodings")
            cases += 1
    say(f"[native] snappy round trip (whole and in parts) on {len(corpus)} inputs; "
        "dict_build_bytes == core.encodings.dictionary_build on 3 string "
        f"columns; rle_hybrid == core.encodings.rle_hybrid_encode on {cases} "
        "(width, input) cases")


def runs_of(rng, n: int, shortest: int, longest: int, vmax: int) -> np.ndarray:
    """n uint32 values below vmax made of runs of shortest..longest equal
    values."""
    out = np.empty(n, np.uint32)
    pos = 0
    while pos < n:
        k = int(rng.integers(shortest, longest + 1))
        out[pos:pos + k] = rng.integers(0, vmax, dtype=np.uint64)
        pos += k
    return out


def check_pack(torch, rng) -> int:
    """The fused pack kernel against its plain version, exactly: windows of
    16,384 values (four of the kernel's spans) that start unaligned, run
    past ld, hold counts of 0, 1, 7, 9 and other ragged ones; runs of 1..40
    and of 8..40 equal values across the span edges; widths 1..32 with bits
    above the width set; then the identity table (``bitpack_pages``) at
    buckets 256, 65,536 and 12,288.  Returns the largest error (0)."""
    from kpw_tpu_torch.ops import bitpack

    C, ld, bucket = 4, 70_003, 16_384
    table = torch.tensor([
        [0, 0, 16_384], [1, 1, 16_383], [2, 3, 0], [3, 5, 1], [1, 4090, 7],
        [2, 9, 9], [3, 37, 12_345], [1, 60_001, 16_384], [0, 70_003, 100],
        [2, 4093, 16_000], [1, 17, 4104], [3, 65_535, 4100], [2, 8191, 8193]],
        dtype=torch.int32, device="cuda")
    worst = 0
    for width in range(1, 33):
        top = np.uint64(1 << 32) if width == 32 else np.uint64(1 << width)
        vals = np.stack([
            rng.integers(0, 1 << 32, ld, dtype=np.uint64).astype(np.uint32),
            runs_of(rng, ld, 1, 40, int(top)),
            runs_of(rng, ld, 8, 40, int(top)),
            rng.integers(0, top, ld, dtype=np.uint64).astype(np.uint32)])
        idx = torch.from_numpy(vals.view(np.int32)).to("cuda")
        for tab, cnt in ((table, None), (None, 12_345)):
            want = bitpack.pack_pages_plain(idx, tab, bucket, width, True, cnt,
                                            n_runs=True)
            for runs in (False, True):
                got = bitpack.pack_pages(idx, tab, bucket, width, True, cnt,
                                         n_runs=runs)
                check((got[2] is None) != runs,
                      f"fused pack n_runs {runs}: run count returned {got[2]}")
                e = max(max_abs_err(torch, g, w) for g, w in zip(got, want)
                        if g is not None)
                check(e == 0, f"fused pack width {width} count {cnt} n_runs "
                      f"{runs}: max err {e}")
                worst = max(worst, e)
    cases = 0
    for bucket in (256, 65536, 12288):
        for width in range(1, 33):
            vals = rng.integers(0, 1 << width, (3, bucket), dtype=np.uint64)
            if width == 32:
                vals[:, ::3] |= np.uint64(0x8000_0000)
            pages = torch.from_numpy(vals.astype(np.uint32).view(np.int32)).to("cuda")
            e = max_abs_err(torch, bitpack.bitpack_pages(pages, width),
                            bitpack.bitpack_pages_plain(pages, width))
            check(e == 0, f"bitpack width {width} bucket {bucket}: max err {e}")
            cases += 1
    torch.cuda.synchronize()
    say(f"[kernels] fused pack == plain (packed bytes, long_sum and n_runs) on 32 "
        f"widths x {table.shape[0]} windows (unaligned starts, counts 0/1/7/9/"
        f"ragged, past ld, runs across span edges) plus the table-less rows "
        f"with one count, and the identity table on {cases} (width, bucket) "
        "cases")
    return worst


def hist_inputs(rng, C: int, N: int, nhi: int) -> np.ndarray:
    """(C, N) uint32 below nhi*64: column 0 uniform, column c >= 1 with
    (c % 8) + 1 distinct values; two rows at or above the bound."""
    vb = nhi * 64
    vals = rng.integers(0, vb, (C, N)).astype(np.uint32)
    for c in range(1, C):
        few = rng.choice(vb, size=c % 8 + 1, replace=False)
        vals[c] = rng.choice(few, N)
    vals[:, 5] = vb + 12345
    vals[:, 6] = 0xFFFFFFFF
    return vals


def check_hist(torch, rng) -> int:
    """The hist + dictionary kernel against its plain version, exactly:
    C = 5 and 64, nhi 8 / 32 / 128, columns with 1..8 distinct values, a
    count below N (an int, and a device tensor), values at or above the
    bound, ulo as wide as the table, wider (padded to its end) and
    narrower.  Returns the largest error (0)."""
    from kpw_tpu_torch.ops import rank

    worst = 0
    N = 32768 + 384
    for C in (5, 64):
        for nhi in (8, 32, 128):
            lo = torch.from_numpy(hist_inputs(rng, C, N, nhi).view(np.int32)).to("cuda")
            count = N - 77
            for cnt, cols in ((count, None), (torch.tensor(count, device="cuda"), N),
                              (N, 200)):
                got = rank.hist_dict(lo, cnt, nhi, ulo_cols=cols)
                want = rank.hist_dict_plain(lo, cnt, nhi, ulo_cols=cols)
                e = max(max_abs_err(torch, g, w) for g, w in zip(got, want))
                check(e == 0, f"hist_dict C {C} nhi {nhi} ulo_cols {cols}: max err {e}")
                worst = max(worst, e)
            e = max_abs_err(torch, rank.hist_pages(lo, nhi),
                            rank.hist_pages_plain(lo, nhi))
            check(e == 0, f"hist_pages C {C} nhi {nhi}: max err {e}")
    torch.cuda.synchronize()
    say("[kernels] hist_dict == plain (counts, rt, ulo, k) for C 5/64, nhi "
        "8/32/128, 1..8 distinct values, ragged int and device counts, "
        "out-of-bound values, ulo 200 / nhi*64 / N wide")
    return worst


def check_rank(torch, rng) -> int:
    from kpw_tpu_torch.ops import rank

    worst = 0
    for nhi in (8, 32, 128):
        vals = hist_inputs(rng, 5, 32768 + 384, nhi)
        lo = torch.from_numpy(vals.view(np.int32)).to("cuda")
        _, rt, _, _ = rank.hist_dict_plain(lo, 32768 + 77, nhi)
        e = max_abs_err(torch, rank.rank_pages(lo, rt), rank.rank_pages_plain(lo, rt))
        check(e == 0, f"rank nhi {nhi}: max err {e}")
        worst = max(worst, e)
    torch.cuda.synchronize()
    say("[kernels] rank == plain for nhi 8/32/128 (rows past the count, "
        "out-of-bound values)")
    return worst


def delta_rows(rng, bit_size: int) -> list:
    """(label, values) rows for the delta kernel: the wraparound edges of
    the JAX package's delta tests (INT64_MIN/MAX with them), zero deltas, a
    near-sorted walk, one row per width bucket 8/16/24/32/48/64 the ring
    has, and uniform values over the whole ring."""
    itype = np.int64 if bit_size == 64 else np.int32
    info = np.iinfo(itype)
    n = 3_000
    rows = [("edges", np.resize(np.array([0, info.max, info.min, 17, 7, -1],
                                         itype), n)),
            ("zero deltas", np.full(n, -5, itype)),
            ("walk", np.cumsum(rng.integers(0, 9, n)).astype(itype))]
    for bits in (5, 12, 20, 28, 40, 60):
        if bits < bit_size:
            rows.append((f"range 2^{bits}",
                         (rng.integers(0, 1 << bits, n) - (1 << (bits - 1))).astype(itype)))
    rows.append(("uniform", rng.integers(info.min, info.max, n, dtype=itype,
                                         endpoint=True)))
    return rows


def same_streams(torch, got, want) -> int:
    """The largest difference between two ``delta_page_streams`` results:
    offsets, width flag and the bytes written (those below the capacity)."""
    from kpw_tpu_torch.ops.delta import stream_bytes

    return max(max_abs_err(torch, got[1], want[1]), max_abs_err(torch, got[2], want[2]),
               max_abs_err(torch, stream_bytes(*got[:2]), stream_bytes(*want[:2])))


def delta_pages_equal_oracle(streams_h: np.ndarray, table, out, offsets,
                             bit_size: int, what: str) -> int:
    """Every page of one launch, its header added, against
    ``core.encodings.delta_binary_packed_encode`` of its window; returns
    the number of pages compared."""
    from kpw_tpu_torch.core import encodings as enc
    from kpw_tpu_torch.ops import delta

    out_h, off_h = out.cpu().numpy(), offsets.cpu().numpy()
    for p, (r, s, c) in enumerate(np.asarray(table).reshape(-1, 3)):
        window = np.zeros(c, streams_h.dtype)  # past the row's end: 0
        part = streams_h[r, s:s + c]
        window[:len(part)] = part
        header, body = delta.page_parts(int(window[0]) if c else 0, int(c), out_h,
                                        int(off_h[p]), int(off_h[p + 1]))
        check(header + body.tobytes() == enc.delta_binary_packed_encode(window, bit_size),
              f"delta {what} page {(r, s, c)}: stream differs from the oracle")
    return len(table)


def check_delta(torch, rng) -> int:
    """The delta kernel against its plain version, byte for byte, on both
    rings: for each row of :func:`delta_rows`, pages of counts 0, 1, 2,
    127, 128, 129 and ragged ones at unaligned starts and past the row's
    end, at the row's own width bucket (one launch each), and the uniform
    row under an 8-bit budget (flagged, cut at the capacity alike); pages
    of 1 to 1,024 blocks; and 64 pages of 1,024 blocks in one launch, far
    more blocks than the card keeps resident, through the look-back.
    Every page with its header also equals
    ``core.encodings.delta_binary_packed_encode``.  Returns the largest
    error (0)."""
    from kpw_tpu_torch.ops import delta

    worst, launches, buckets, pages_checked = 0, 0, set(), 0

    def compare(streams_h, table, bit_size, max_bits, what, oracle=True):
        nonlocal worst, launches, pages_checked
        streams = torch.from_numpy(streams_h).to("cuda")
        want = delta.delta_page_streams_plain(streams, table, bit_size, max_bits)
        got = delta.delta_page_streams(streams, table, bit_size, max_bits)
        launches += 1
        e = same_streams(torch, got, want)
        check(e == 0, f"delta ring {bit_size} {what}: max err {e}")
        worst = max(worst, e)
        if oracle and not int(got[2][0]):
            pages_checked += delta_pages_equal_oracle(streams_h, table, *got[:2],
                                                      bit_size, what)
        return got

    pages = ((0, 2), (3, 127), (1, 128), (5, 129), (0, 0), (9, 1), (17, 1_000),
             (1_234, 1_766), (2_990, 10), (3_000, 4), (7, 2_048))
    for bit_size in (32, 64):
        itype = np.int64 if bit_size == 64 else np.int32
        for label, vals in delta_rows(rng, bit_size):
            max_bits = delta.delta_bits_bucket(int(vals.max()) - int(vals.min()),
                                               bit_size)
            buckets.add((bit_size, max_bits))
            table = np.array([[0, s, c] for s, c in pages])
            compare(vals[None, :], table, bit_size, max_bits, label)
            if label == "uniform":  # a wrong width bound: flagged, cut alike
                got = compare(vals[None, :], table, bit_size, 8, "uniform under 8 bits")
                check(int(got[2][0]) > 8, "delta: a width over the budget was not flagged")
        n = 1_024 * 128 + 1
        long = np.stack([np.cumsum(rng.integers(-2, 60, n + 5_000)).astype(itype),
                         (rng.integers(0, 1 << 20, n + 5_000) - (1 << 19)).astype(itype)])
        ragged = np.array([[b % 2, 3 * b, 1 + 128 * b] for b in
                           (1, 2, 3, 7, 64, 100, 513, 1_000, 1_024)])
        compare(long, ragged, bit_size, 24, "pages of 1..1,024 blocks")
        resident = np.array([[p % 2, (37 * p) % 5_000, n] for p in range(64)])
        got = compare(long, resident, bit_size, 24, "64 pages x 1,024 blocks",
                      oracle=False)
        pages_checked += delta_pages_equal_oracle(long, resident[:4], got[0], got[1],
                                                  bit_size, "64 x 1,024 (first 4)")
    torch.cuda.synchronize()
    say(f"[kernels] delta == plain on both rings ({launches} launches, width "
        f"buckets {sorted(buckets)}; wraparound edges, counts 0/1/2/127/128/129/"
        "ragged, starts past the row's end, an 8-bit budget violated; pages of "
        "1..1,024 blocks; 64 pages x 1,024 blocks = 65,536 blocks in one launch "
        f"through the look-back) and {pages_checked} pages with their "
        "headers == core.encodings.delta_binary_packed_encode")
    return worst


def abba(timer: Timer, a, b) -> tuple[float, float, list]:
    """Time a and b in turns (a b b a); returns their means and all four."""
    t = [timer.ms(a), timer.ms(b), timer.ms(b), timer.ms(a)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def summarize(name: str, r: dict) -> None:
    """A kernel record's bound, from the bytes it must move, printed with
    its times."""
    r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
    r["bound_by"] = "bytes"
    lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    say(f"[kernels] {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, library {lib}, bound "
        f"{r['bound_ms']:.6f} ms ({r['bytes']} bytes), "
        f"{r['ms'] / r['bound_ms']:.2f}x the bound")


def phase_kernels(torch, timer: Timer) -> dict:
    """Exact agreement of every kernel with its plain version, then timing
    at the flagship shape as the main path hands each kernel its inputs,
    beside the unfused route around it, timed in turns.  Returns the
    per-kernel records (launches are filled in after the main path ran)."""
    from kpw_tpu_torch.ops import bitpack, rank
    from kpw_tpu_torch.parallel import sharded

    rng = np.random.default_rng(1234)
    dev = "cuda"
    err = {"bitpack": check_pack(torch, rng), "hist": check_hist(torch, rng),
           "rank": check_rank(torch, rng), "delta": check_delta(torch, rng)}

    # the flagship shape and count of the main path (flagship_path)
    C, N, W = C_FLAG, N_FLAG, 16
    count = N - 37
    valid = torch.arange(N, device=dev) < count
    ranks = torch.from_numpy(rng.integers(0, 1 << W, (C, N)).astype(np.int32)).to(dev)
    los = {}
    for label, nhi, vmax in (("bounded-270", 8, 270), ("bounded-8192", 128, 1 << 13)):
        los[label] = (torch.from_numpy(
            rng.integers(0, vmax, (C, N)).astype(np.int32)).to(dev), nhi)
    lo, NHI = los["bounded-8192"]
    vb = NHI * 64
    _, rt, _, _ = rank.hist_dict_plain(lo, count, NHI)
    lo_m = torch.where(valid, lo, vb)
    flat = (lo_m.to(torch.int64)
            + torch.arange(C, device=dev)[:, None] * (vb + 1)).reshape(-1)
    rt_pad = torch.cat([rt.reshape(C, vb), rt.new_zeros((C, 1))], 1).reshape(-1)

    for name, got, want in (
            ("bitpack", bitpack.pack_pages(ranks, None, N, W, False, count)[0],
             bitpack.pack_pages_plain(ranks, None, N, W, False, count)[0]),
            ("rank", rank.rank_pages(lo, rt), rank.rank_pages_plain(lo, rt))):
        e = max_abs_err(torch, got, want)
        check(e == 0, f"{name} at the flagship shape: max err {e}")
        err[name] = max(err[name], e)
    got = rank.hist_dict(lo, count, NHI, ulo_cols=N)
    want = rank.hist_dict_plain(lo, count, NHI, ulo_cols=N)
    e = max(max_abs_err(torch, g, w) for g, w in zip(got, want))
    check(e == 0, f"hist_dict at the flagship shape: max err {e}")
    err["hist"] = max(err["hist"], e)

    # the hist kernel on both bounded distributions of the main path
    for label, (lo_d, nhi) in los.items():
        check(all(torch.equal(a, b) for a, b in zip(
            rank.hist_dict(lo_d, count, nhi, ulo_cols=N),
            rank.hist_dict_plain(lo_d, count, nhi, ulo_cols=N))),
            f"hist_dict {label} differs from its plain version")
        say(f"[kernels] hist_dict {label} ({C}, {N}) nhi {nhi}, ulo ({C}, {N}): "
            + format(timer.ms(lambda: rank.hist_dict(lo_d, count, nhi, ulo_cols=N)),
                     ".4f") + " ms")

    recs = {
        "bitpack": dict(
            name="bitpack", route="cuda", source="kpw_tpu_torch/csrc/bitpack.cu",
            replaces="kpw_tpu/ops/pallas_bitpack.py:52",
            ms=timer.ms(lambda: bitpack.pack_pages(ranks, None, N, W, False, count)),
            plain_ms=timer.ms(lambda: bitpack.pack_pages_plain(
                ranks, None, N, W, False, count)),
            library_ms=None,
            bytes=C * count * 4 + C * N * W // 8,
            shape=f"({C}, {N}) int32 windows, count {count} -> "
                  f"({C}, {N * W // 8}) uint8, width {W}"),
        "hist": dict(
            name="hist", route="cuda", source="kpw_tpu_torch/csrc/hist.cu",
            replaces="kpw_tpu/ops/pallas_rank.py:105",
            ms=timer.ms(lambda: rank.hist_dict(lo, count, NHI, ulo_cols=N)),
            plain_ms=timer.ms(lambda: rank.hist_dict_plain(lo, count, NHI,
                                                           ulo_cols=N)),
            library_ms=timer.ms(
                lambda: torch.bincount(flat, minlength=C * (vb + 1))),
            bytes=C * count * 4 + 2 * C * vb * 4 + C * N * 8 + C * 4,
            shape=f"({C}, {N}) int32, count {count} -> counts, rt ({C}, {NHI}, 64) "
                  f"int32, ulo ({C}, {N}) int64, k ({C},)"),
        "rank": dict(
            name="rank", route="cuda", source="kpw_tpu_torch/csrc/rank.cu",
            replaces="kpw_tpu/ops/pallas_rank.py:61",
            ms=timer.ms(lambda: rank.rank_pages(lo, rt)),
            plain_ms=timer.ms(lambda: rank.rank_pages_plain(lo, rt)),
            library_ms=timer.ms(lambda: torch.take(rt_pad, flat)),
            bytes=C * N * 4 + C * vb * 4 + C * N * 4,
            shape=f"({C}, {N}) int32 + ({C}, {NHI}, 64) int32 -> ({C}, {N}) int32"),
    }
    for name, r in recs.items():
        r["max_abs_err"] = err[name]
        summarize(name, r)
    recs["delta"] = dict(max_abs_err=err["delta"])  # timed after the main path

    # yardstick: one PyTorch copy of the (C, N) int32 ranks, to read the
    # kernels' distance from the bound against what a plain memory-bound
    # launch of this size reaches here
    dst = torch.empty_like(ranks)
    copy_ms = timer.ms(lambda: dst.copy_(ranks))
    copy_bound = 2 * C * N * 4 / HBM_BYTES_PER_S * 1e3
    say(f"[kernels] yardstick: torch copy_ of ({C}, {N}) int32 {copy_ms:.4f} ms, "
        f"bound {copy_bound:.4f} ms, {copy_ms / copy_bound:.2f}x the bound")

    # the unfused routes around the two redesigned kernels, in turns
    def unfused_pack():
        return bitpack.bitpack_pages(torch.where(valid, ranks, 0), W)

    def new_pack():
        return sharded._pack_rows(ranks, count, W)

    check(torch.equal(unfused_pack(), new_pack()), "flagship pack routes differ")
    old, new, t = abba(timer, unfused_pack, new_pack)
    say(f"[routes] flagship pack ({C}, {N}) width {W}: unfused route (where mask + "
        f"bit-pack) {old:.4f} ms, fused {new:.4f} ms; "
        f"turns {', '.join(f'{x:.4f}' for x in t)}")

    def unfused_hist():
        counts = rank.hist_pages(torch.where(valid, lo, vb), NHI)
        rt_o, ulo_v, k_o = rank.presence_to_dict(counts, NHI)
        pad = ulo_v.new_full((C, N - vb), rank.U32_PAD)
        return counts, rt_o, torch.cat([ulo_v, pad], dim=1), k_o

    def new_hist():
        return rank.hist_dict(lo, count, NHI, ulo_cols=N)

    check(all(torch.equal(a, b) for a, b in zip(unfused_hist(), new_hist())),
          "flagship hist routes differ")
    old, new, t = abba(timer, unfused_hist, new_hist)
    say(f"[routes] flagship hist + dictionary ({C}, {N}) nhi {NHI}: unfused route "
        f"(where mask + hist + presence_to_dict + pad) {old:.4f} ms, fused "
        f"{new:.4f} ms; turns {', '.join(f'{x:.4f}' for x in t)}")
    return recs


def delta_bytes(table, bit_size: int, offsets) -> int:
    """What one delta launch must move at least: each page's values read
    once, its page table row and block prefix entry, and the body bytes
    and offsets written once."""
    tab = np.asarray(table).reshape(-1, 3)
    P = len(tab)
    return (int(tab[:, 2].sum()) * bit_size // 8 + P * 12 + (P + 1) * 4
            + int(offsets[-1]) + (P + 1) * 8)


def kernel_device_ms(torch, timer: Timer, stage, run, name: str):
    """The profiler's device time of the kernel ``name``: the median over
    ``timer.reps`` launches under the profiler, each staged (``stage``),
    then the L2 flushed, then launched (``run``); None where the profiler
    saw no such kernel."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(timer.reps):
            stage()
            timer.flush.zero_()
            run()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and name in e.name]
    return statistics.median(us) / 1e3 if us else None


def delta_record(torch, timer: Timer, err: int, shapes: dict) -> dict:
    """The delta kernel timed at the shapes the main path hands it: one
    row group's 64-bit ring launch of the ``encodings`` path (ts, seq, rid)
    and of the ``cfg3`` path (ts0..ts3), each checked against its plain
    version on the same inputs first.  CUDA events: the kernel launched
    alone (``ops.delta.DeltaLaunch``: its one upload and the output's
    allocation are made before the timed interval), the call with that
    staging, and the plain version; beside them the profiler's device time
    of the kernel (no launch overhead in it) and the event time of a
    one-element PyTorch op, the least that CUDA events read for one
    launch.  The record carries the encodings shape."""
    from kpw_tpu_torch.ops import delta

    rec = dict(name="delta", route="cuda", source="kpw_tpu_torch/csrc/delta.cu",
               replaces="kpw_tpu/ops/delta.py:119 (_delta_window, XLA code; "
                        "no pallas_call)",
               max_abs_err=err, library_ms=None)
    one = torch.zeros(1, device="cuda")
    floor_ms = timer.ms(lambda: one.add_(1))
    for label in ("cfg3", "encodings"):
        streams, table, bit_size, max_bits = shapes[label]
        staged = []

        def stage():
            staged[:] = [delta.DeltaLaunch(streams, table, bit_size, max_bits)]

        def run():
            return staged[0].run()

        stage()
        got = run()
        e = same_streams(torch, got, delta.delta_page_streams_plain(
            streams, table, bit_size, max_bits))
        check(e == 0, f"delta at the {label} shape: max err {e}")
        rec["max_abs_err"] = max(rec["max_abs_err"], e)
        nbytes = delta_bytes(table, bit_size, got[1].cpu().numpy())
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        ms = timer.ms(run, setup=stage)
        call_ms = timer.ms(lambda: delta.delta_page_streams(streams, table, bit_size,
                                                            max_bits))
        plain_ms = timer.ms(lambda: delta.delta_page_streams_plain(
            streams, table, bit_size, max_bits))
        dev_ms = kernel_device_ms(torch, timer, stage, run, "delta_streams_kernel")
        dev = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        tab = np.asarray(table).reshape(-1, 3)
        blocks = int(((np.maximum(tab[:, 2] - 1, 0) + 127) // 128).sum())
        say(f"[kernels] delta at the {label} shape ({tuple(streams.shape)} ring "
            f"{bit_size}, {len(tab)} pages, counts {tab[:, 2].tolist()}, {blocks} "
            f"blocks, max_bits {max_bits}, {int(got[1][-1])} body bytes): kernel "
            f"{ms:.4f} ms alone (profiler device time {dev}), call with its staging "
            f"{call_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.6f} ms "
            f"({nbytes} bytes), {ms / bound:.2f}x the bound; a one-element "
            f"PyTorch op {floor_ms:.4f} ms")
        if label == "encodings":
            rec.update(ms=ms, plain_ms=plain_ms, bytes=nbytes,
                       shape=f"{tuple(streams.shape)} int64 streams, {len(tab)} "
                             f"pages of {tab[:, 2].tolist()} values, max_bits "
                             f"{max_bits} -> {int(got[1][-1])} body bytes")
    return rec


def flagship_path(torch) -> list:
    """The flagship step, driven once per route: ``entry()`` and
    ``encode_step_single`` at 64 x 65,536 on the sort route and both bounded
    routes, each equal to the same step run on the CPU (plain versions).
    Returns the card inputs of the three routes, for timing afterwards."""
    from kpw_tpu_torch.entry import entry
    from kpw_tpu_torch.parallel.sharded import encode_step_single

    def same(got, want, what):
        for name, g, w in zip(("packed", "ulo", "k"), got, want):
            check(torch.equal(g.cpu(), w.cpu()), f"{what}: {name} differs")

    fn, (lo, count) = entry()
    check(lo.is_cuda, "entry() did not place its input on the card")
    same(fn(lo, count), fn(lo.cpu(), count.cpu()), "entry()")
    say(f"[flagship] entry(): {tuple(lo.shape)} on the card == CPU")

    rng = np.random.default_rng(7)
    cases = []
    # sort route (no bound), bounded nhi 8 (zone-id range), bounded nhi 128
    for label, vmax, bound in (("sort", 1024, None), ("bounded-270", 270, 270),
                               ("bounded-8192", 1 << 13, 1 << 13)):
        vals = rng.integers(0, vmax, (C_FLAG, N_FLAG)).astype(np.int32)
        count = N_FLAG - 37
        lo_h = torch.from_numpy(vals)
        lo_d = lo_h.cuda()
        got = encode_step_single(lo_d, count, width=16, value_bound=bound)
        torch.cuda.synchronize()
        want = encode_step_single(lo_h, count, width=16, value_bound=bound)
        same(got, want, f"flagship {label}")
        say(f"[flagship] {label}: ({C_FLAG}, {N_FLAG}) value_bound={bound} "
            f"k[0]={int(want[2][0])}: card == CPU")
        cases.append((label, lo_d, count, bound))
    return cases


def flagship_timing(torch, timer: Timer, cases) -> None:
    """Step time (CUDA events) and device profile of each flagship route."""
    from kpw_tpu_torch.parallel.sharded import encode_step_single

    for label, lo_d, count, bound in cases:
        def step():
            encode_step_single(lo_d, count, width=16, value_bound=bound)
        say(f"[flagship] {label}: step {timer.ms(step):.4f} ms; profiled: "
            + device_profile(torch, step))


def make_taxi_like(rows: int, seed: int = 0) -> dict:
    """64 columns shaped like the NYC-taxi schema (the repo's headline
    configuration): low-cardinality ids/flags, medium-cardinality zones,
    quantized fares, quantized distances — all dictionary-viable."""
    rng = np.random.default_rng(seed)
    cols = {}
    for i in range(TAXI_COLS):
        kind = i % 4
        if kind == 0:  # vendor/ratecode/payment-type style: tiny cardinality
            cols[f"c{i:02d}"] = rng.integers(0, 8, rows).astype(np.int64)
        elif kind == 1:  # pickup/dropoff zone ids
            cols[f"c{i:02d}"] = rng.integers(1, 266, rows).astype(np.int32)
        elif kind == 2:  # quantized fare/tip amounts (cents, heavy repeats)
            cols[f"c{i:02d}"] = (rng.integers(0, 5000, rows) * 25).astype(np.int64)
        else:  # trip distance quantized to 0.01 miles
            cols[f"c{i:02d}"] = (rng.integers(0, 3000, rows) / 100.0).astype(np.float64)
    return cols


def writer_setup(small: bool = False):
    """The taxi table in prebuilt batches, four row groups of 262,144 rows
    (small: two of 8,192), its schema and the writer's default properties
    (UNCOMPRESSED, 1 MiB pages, 128 MiB row groups)."""
    from kpw_tpu_torch.core import Schema, WriterProperties, columns_from_arrays, leaf

    rows, n_groups = (8_192, 2) if small else (TAXI_ROWS, TAXI_GROUPS)
    groups = [make_taxi_like(rows, seed=g) for g in range(n_groups)]
    types = {"int64": "int64", "int32": "int32", "float64": "double"}
    schema = Schema([leaf(n, types[str(v.dtype)]) for n, v in groups[0].items()])
    return ([columns_from_arrays(schema, arrays) for arrays in groups], schema,
            WriterProperties())


def device_profile(torch, fn) -> str:
    """Run ``fn`` once under the PyTorch profiler and describe where the
    card's time went: the device's busy time (the union of the CUDA kernel,
    copy and memset intervals the profiler recorded, annotations excluded),
    its share of the call's wall time (host clock, ending in a
    synchronize), the number of those device ops, the summed time of the
    host<->device copies among them, and the top device ops by summed
    time."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    if not evs:
        return (f"wall {wall * 1e3:.3f} ms; device time not measured (the "
                "profiler saw no CUDA events)")
    busy_us, end = 0.0, float("-inf")
    for e in sorted(evs, key=lambda e: e.time_range.start):
        start, stop = e.time_range.start, e.time_range.end
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    by_name: dict = {}
    for e in evs:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    copy_us = sum(t for name, (t, _) in by_name.items() if name.startswith("Memcpy"))
    return (f"wall {wall * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
            f"({100 * busy_us / (wall * 1e6):.1f}%), device ops {len(evs)}, "
            f"host<->device copies {copy_us / 1e3:.3f} ms; top device ops: "
            + "; ".join(f"{name[:44]} {t / 1e3:.3f} ms x{n}"
                        for name, (t, n) in top))


def dictionary_routes(torch, timer: Timer, batch) -> None:
    """The dictionary build's two routes on the card, on the same inputs:
    one taxi row group's 16 quantized-fare columns as the affine offsets the
    writer builds them from, through the bins build (the writer's route for
    them) and the sort build.  Both must agree; device time only (CUDA
    events), the offsets uploaded once."""
    from kpw_tpu_torch.ops import dictionary as D

    cols = [c.values for c in batch.chunks if int(c.column.name[1:]) % 4 == 2]
    n, bucket = len(cols[0]), D.pad_bucket(len(cols[0]))
    ids = np.zeros((len(cols), bucket), np.uint32)
    R = 1
    for c, arr in enumerate(cols):
        vmin, vmax = int(arr.min()), int(arr.max())
        g = D.affine_stride(arr, vmin, vmax - vmin, None, D.RANGE_MAX)
        ids[c, :n] = D._affine_offsets(arr, vmin, g)
        R = max(R, D.pad_bucket((vmax - vmin) // g + 1))
    ids_d = D._upload(ids, "cuda")
    counts = torch.full((len(cols),), n, dtype=torch.int32, device="cuda")
    routes = {
        "bins": lambda: D._dict_build_bins_batch(ids_d, counts, R),
        "sort": lambda: D._dict_build_batch(ids_d, ids_d, counts, False),
    }
    ref_key, ref_idx, ref_k = routes["bins"]()
    for name, fn in routes.items():
        key, idx, k = fn()
        check(torch.equal(k, ref_k) and torch.equal(idx[:, :n], ref_idx[:, :n]),
              f"dictionary route {name} disagrees with the bins build")
        for c in range(len(cols)):
            kc = int(ref_k[c])
            check(torch.equal(key[c, :kc], ref_key[c, :kc]),
                  f"dictionary route {name}: keys differ in column {c}")
    times = {name: timer.ms(fn) for name, fn in routes.items()}
    say(f"[dictionary] ({len(cols)}, {bucket}) affine offsets, R={R}: "
        + ", ".join(f"{name} {ms:.4f} ms" for name, ms in times.items()))


def unfused_pack_multi(torch, idx_all, col_ids, starts, counts, bucket: int,
                   width: int):
    """The unfused route of one pack job, kept here only to time it
    against the fused kernel: a padded copy of the whole index batch, three index
    uploads, the window gather and mask, the run statistics as a dozen
    tensor ops, then the bit-pack of the sliced pages."""
    from kpw_tpu_torch.ops import bitpack, packing

    dev = idx_all.device
    padded = packing._pad_rows(idx_all, bucket)
    rows, first, cnt = (torch.as_tensor(np.asarray(x, np.int64), device=dev)
                        for x in (col_ids, starts, counts))
    pos = torch.arange(bucket, device=dev)
    valid = pos < cnt[:, None]
    v = torch.where(valid, padded[rows[:, None], first[:, None] + pos], 0)
    return bitpack.bitpack_pages(v, width), bitpack.run_long_stats(v, valid)


def taxi_pack_jobs(torch, timer: Timer, schema, props, batch) -> None:
    """One taxi row group's pack jobs, recorded as the encoder makes them,
    then replayed on the card: the fused kernel (one launch a job) against
    the unfused route, in turns, both equal; CUDA-event time of the four jobs
    together and one profiled pass of each (device busy, device ops)."""
    from kpw_tpu_torch.core import ParquetFileWriter
    from kpw_tpu_torch.ops import backend
    from kpw_tpu_torch.ops.backend import CudaChunkEncoder

    jobs = []
    multi = backend.pack_pages_multi

    def record(*args):
        jobs.append(args)
        return multi(*args)

    backend.pack_pages_multi = record
    try:
        w = ParquetFileWriter(io.BytesIO(), schema, props,
                              encoder=CudaChunkEncoder(props.encoder_options()))
        w.write_batch(batch)
        w.flush_row_group()
    finally:
        backend.pack_pages_multi = multi
    check(len(jobs) > 0, "taxi row group: no pack job recorded")

    def fused():
        return [multi(*job) for job in jobs]

    def unfused():
        return [unfused_pack_multi(torch, *job) for job in jobs]

    for (fp, fl), (op, ol) in zip(fused(), unfused()):
        check(torch.equal(fp, op) and torch.equal(fl, ol),
              "taxi pack job: fused and unfused routes differ")
    geometry = "; ".join(
        f"{tuple(job[0].shape)} P {len(job[1])} bucket {job[4]} width {job[5]}"
        for job in jobs)
    # each page's valid values read once, its packed bytes and long_sum
    # written once, its page-table row read once
    nbytes = sum(int(np.sum(counts)) * 4 + len(cols) * (bucket * width // 8 + 4 + 12)
                 for _, cols, _, counts, bucket, width in jobs)
    old, new, t = abba(timer, unfused, fused)
    say(f"[routes] taxi row group, {len(jobs)} pack jobs ({geometry}): unfused "
        f"route {old:.4f} ms, fused {new:.4f} ms; turns "
        f"{', '.join(f'{x:.4f}' for x in t)}; bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
        f"({nbytes} bytes)")
    say(f"[routes] taxi pack jobs profiled: unfused route {device_profile(torch, unfused)}")
    say(f"[routes] taxi pack jobs profiled: fused {device_profile(torch, fused)}")


# ---------------------------------------------------------------------------
# the level, nested and encodings paths
# ---------------------------------------------------------------------------

def levels_setup(small: bool = False):
    """BASELINE config 2's taxi schema made OPTIONAL (bench.py:407-423), in
    prebuilt batches: kinds 0-2 about 2% nulls (run-dominated def levels,
    the common case), kind 3 50% random nulls (high-entropy def levels, the
    bit-pack route); four row groups of 262,144 rows (small: two of
    8,192), default properties."""
    from kpw_tpu_torch.core import (Repetition, Schema, WriterProperties,
                                    columns_from_arrays, leaf)

    rows, n_groups = (8_192, 2) if small else (TAXI_ROWS, TAXI_GROUPS)
    types = {"int64": "int64", "int32": "int32", "float64": "double"}
    schema = None
    groups = []
    for g in range(n_groups):
        arrays = make_taxi_like(rows, seed=10 + g)
        rng = np.random.default_rng(100 + g)
        if schema is None:
            schema = Schema([leaf(k, types[str(v.dtype)], Repetition.OPTIONAL)
                             for k, v in arrays.items()])
        groups.append(columns_from_arrays(schema, {
            k: (v, rng.random(rows) > (0.5 if int(k[1:]) % 4 == 3 else 0.02))
            for k, v in arrays.items()}))
    return groups, schema, WriterProperties()


# ---------------------------------------------------------------------------
# protobuf records without protobuf: descriptor stand-ins and a wire encoder
# ---------------------------------------------------------------------------

class WireField:
    """A protobuf field descriptor stand-in with the attributes the port's
    proto bridge reads (``descriptor.proto``'s type and label numbers)."""

    def __init__(self, name: str, number: int, ftype: int, label: int,
                 message_type=None) -> None:
        self.name, self.number, self.type, self.label = name, number, ftype, label
        self.message_type = message_type
        self.enum_type = None


class WireFile:
    syntax = "proto2"


class WireDescriptor:
    """A message descriptor stand-in: its name, fields and file."""

    def __init__(self, name: str, fields: list) -> None:
        self.name, self.fields, self.file = name, fields, WireFile()


def wire_message(name: str, fields: list):
    """A message class stand-in for the writer: its ``DESCRIPTOR``, and a
    ``FromString`` that refuses to parse, since the wire path shreds the
    serialized records and never builds a message."""

    class Message:
        DESCRIPTOR = WireDescriptor(name, fields)

        @classmethod
        def FromString(cls, data):
            raise NotImplementedError(
                f"{name} is a descriptor stand-in: records take the wire path")

    Message.__name__ = Message.__qualname__ = name
    return Message


def replay_class():
    """BASELINE config 1's streaming record (bench.py:3775-3779): required
    int64 ``i0..i7`` (fields 1-8) and required strings ``s0..s3`` (9-12)."""
    from kpw_tpu_torch.models.proto_bridge import FD

    return wire_message("Replay", [
        WireField(f"i{k}", k + 1, FD.TYPE_INT64, FD.LABEL_REQUIRED) for k in range(8)]
        + [WireField(f"s{k}", k + 9, FD.TYPE_STRING, FD.LABEL_REQUIRED)
           for k in range(4)])


def order_class():
    """The repo's nested test message (tests/proto_helpers.py:63-78):
    Order {order_id required int64; items repeated Item; note optional
    string}, Item {sku required string; qty optional int32; tags repeated
    string}."""
    from kpw_tpu_torch.models.proto_bridge import FD

    item = WireDescriptor("Item", [
        WireField("sku", 1, FD.TYPE_STRING, FD.LABEL_REQUIRED),
        WireField("qty", 2, FD.TYPE_INT32, FD.LABEL_OPTIONAL),
        WireField("tags", 3, FD.TYPE_STRING, FD.LABEL_REPEATED)])
    return wire_message("Order", [
        WireField("order_id", 1, FD.TYPE_INT64, FD.LABEL_REQUIRED),
        WireField("items", 2, FD.TYPE_MESSAGE, FD.LABEL_REPEATED, item),
        WireField("note", 3, FD.TYPE_STRING, FD.LABEL_OPTIONAL)])


def varints(v: np.ndarray) -> tuple:
    """Base-128 varints of int64 values (two's complement, as protobuf
    writes int64): a (n, 10) byte matrix and each value's length."""
    u = np.asarray(v, np.int64).astype(np.uint64)
    shifts = np.arange(10, dtype=np.uint64) * np.uint64(7)
    rest = u[:, None] >> shifts  # the value above each byte
    lens = np.maximum((rest != 0).sum(1), 1)
    more = np.arange(10) < (lens - 1)[:, None]
    body = (rest & np.uint64(0x7F)).astype(np.uint8)
    return body | (more * 0x80).astype(np.uint8), lens


def encode_flat(columns: list) -> list:
    """Serialize flat messages of required fields, in field-number order as
    protobuf does: ``columns`` is a list of (field number, int64 values)
    for varint fields and (field number, list of bytes) for string fields.
    Returns one ``bytes`` per record."""
    blocks, masks = [], []
    n = len(columns[0][1])
    for number, values in columns:
        if isinstance(values, np.ndarray):
            body, lens = varints(values)
            blocks += [np.full((n, 1), number << 3, np.uint8), body]
            masks += [np.ones((n, 1), bool), np.arange(10) < lens[:, None]]
        else:
            sizes = np.fromiter(map(len, values), np.int64, n)
            head, head_lens = varints(sizes)
            width = int(sizes.max())
            data = np.zeros((n, width), np.uint8)
            data_mask = np.arange(width) < sizes[:, None]
            data[data_mask] = np.frombuffer(b"".join(values), np.uint8)
            blocks += [np.full((n, 1), number << 3 | 2, np.uint8), head, data]
            masks += [np.ones((n, 1), bool), np.arange(10) < head_lens[:, None],
                      data_mask]
    mask = np.concatenate(masks, 1)
    buf = np.concatenate(blocks, 1)[mask].tobytes()
    offsets = np.concatenate([[0], np.cumsum(mask.sum(1))])
    return [buf[a:b] for a, b in zip(offsets[:-1].tolist(), offsets[1:].tolist())]


def replay_payloads(rows: int, seed: int = 6) -> list:
    """The e2e probe's records (bench.py:3769-3792), serialized: i0..i7
    from [0, 1,000,000) and s0..s3 from the 100 values ``cat_%03d``, drawn
    in bench.py's order from ``seed``."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(0, 1_000_000, (rows, 8))
    sidx = rng.integers(0, 100, (rows, 4))
    pool = [b"cat_%03d" % j for j in range(100)]
    return encode_flat([(k + 1, ints[:, k].astype(np.int64)) for k in range(8)]
                       + [(k + 9, [pool[j] for j in sidx[:, k]]) for k in range(4)])


def varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        if v < 0x80:
            out.append(v)
            return bytes(out)
        out.append(v & 0x7F | 0x80)
        v >>= 7


def order_payloads(order_id, n_items, sku, qty) -> list:
    """Serialize Order rows as protobuf does: every item has a sku and a
    qty and no tags, no order has a note."""
    out, at = [], 0
    for oid, k in zip(order_id.tolist(), n_items.tolist()):
        rec = [b"\x08", varint(oid)]
        for _ in range(k):
            item = (b"\x0a" + varint(len(sku[at])) + sku[at]
                    + b"\x10" + varint(int(qty[at])))
            rec += [b"\x12", varint(len(item)), item]
            at += 1
        out.append(b"".join(rec))
    return out


def order_rows(rng, n: int):
    """The config-5 rows as arrays (bench.py:1597-1606): order ids below
    2^40, 0-3 items an order, skus from 64 values, qty 1-99."""
    order_id = rng.integers(0, 1 << 40, n).astype(np.int64)
    n_items = rng.integers(0, 4, n)
    total = int(n_items.sum())
    sku = [b"sku%d" % k for k in rng.integers(0, 64, total)]
    qty = rng.integers(1, 100, total).astype(np.int32)
    return order_id, n_items, sku, qty


def nested_setup(small: bool = False):
    """BASELINE config 5: 32,768 Order rows in four row groups of 8,192
    (small: two of 4,096), serialized and shredded from the wire by the
    port's ``ProtoColumnarizer`` (its fused nested route); default
    properties."""
    from kpw_tpu_torch.core import WriterProperties
    from kpw_tpu_torch.models.proto_bridge import ProtoColumnarizer, proto_to_schema

    order = order_class()
    schema = proto_to_schema(order)
    shredder = ProtoColumnarizer(order, schema)
    check(shredder.wire_capable, "the port's shredder cannot take Order's wire path")
    rows, n_groups = ((4_096, 2) if small
                      else (NESTED_ROWS // NESTED_GROUPS, NESTED_GROUPS))
    rng = np.random.default_rng(5)
    groups = [shredder.columnarize_payloads(order_payloads(*order_rows(rng, rows)))
              for _ in range(n_groups)]
    return groups, schema, WriterProperties()


def make_encodings_corpus(rows: int, seed: int = 0) -> dict:
    """The adaptive-encodings corpus (bench.py:4928-4950): near-sorted event
    times, per-producer sequence numbers, uniform 32-bit ids in an int64
    leaf, a 4-value level string, 13-byte user ids and a random-walk
    price."""
    rng = np.random.default_rng(seed)
    levels = [b"DEBUG", b"INFO", b"WARN", b"ERROR"]
    return {
        "ts": (np.int64(1_700_000_000_000)
               + np.cumsum(rng.integers(0, 8, rows))).astype(np.int64),
        "seq": np.cumsum(rng.integers(1, 4, rows)).astype(np.int64),
        "rid": rng.integers(0, 2**32, rows, dtype=np.int64),
        "level": [levels[v] for v in rng.integers(0, len(levels), rows)],
        "uid": [b"u%012d" % v for v in rng.integers(0, 10**6, rows)],
        "price": 100.0 + np.cumsum(rng.standard_normal(rows) * 0.25),
    }


def encodings_setup(small: bool = False):
    """The encodings corpus, 400,000 rows in 8 row groups (small: 2 of
    8,192), with the adaptive chooser's choices there as overrides (so
    row group 1 is planned too): ts, seq, rid DELTA_BINARY_PACKED, uid
    DELTA_LENGTH_BYTE_ARRAY, price BYTE_STREAM_SPLIT; UNCOMPRESSED."""
    from kpw_tpu_torch.core import Schema, WriterProperties, columns_from_arrays, leaf

    rows, n_groups = (2 * 8_192, 2) if small else (ENC_ROWS, ENC_BATCHES)
    schema = Schema([leaf("ts", "int64"), leaf("seq", "int64"), leaf("rid", "int64"),
                     leaf("level", "string"), leaf("uid", "string"),
                     leaf("price", "double")])
    arrays = make_encodings_corpus(rows)
    step = rows // n_groups
    groups = [columns_from_arrays(schema, {k: v[at:at + step] for k, v in arrays.items()})
              for at in range(0, rows, step)]
    props = WriterProperties(encodings={
        "ts": "DELTA_BINARY_PACKED", "seq": "DELTA_BINARY_PACKED",
        "rid": "DELTA_BINARY_PACKED", "uid": "DELTA_LENGTH_BYTE_ARRAY",
        "price": "BYTE_STREAM_SPLIT"})
    return groups, schema, props


def strings_setup(small: bool = False):
    """BASELINE config 1 (bench.py:300-323): 8 int64 columns i{k} drawn from
    [0, 10^(k+1)) and 4 string columns s0..s3 from a pool of 100
    ``cat_%03d`` values, as ByteColumns, drawn in bench.py's order from seed
    1; SNAPPY.  bench.py writes one batch of 262,144 rows; here 1,048,576
    rows are cut into four row groups of 262,144 (small: two of 8,192), so
    that the pipeline has work to overlap."""
    from kpw_tpu_torch.core import (Codec, Schema, WriterProperties,
                                    columns_from_arrays, leaf)
    from kpw_tpu_torch.core.bytecol import ByteColumn

    rows, n_groups = (8_192, 2) if small else (CFG1_ROWS, CFG1_GROUPS)
    total = rows * n_groups
    rng = np.random.default_rng(1)
    ints = {f"i{i}": rng.integers(0, 10 ** (i + 1), total).astype(np.int64)
            for i in range(8)}
    pool = [b"cat_%03d" % j for j in range(100)]
    strs = {f"s{i}": [pool[k] for k in rng.integers(0, 100, total)] for i in range(4)}
    schema = Schema([leaf(f"i{i}", "int64") for i in range(8)]
                    + [leaf(f"s{i}", "string") for i in range(4)])
    groups = []
    for at in range(0, total, rows):
        batch = {k: v[at:at + rows] for k, v in ints.items()}
        batch |= {k: ByteColumn.from_list(v[at:at + rows]) for k, v in strs.items()}
        groups.append(columns_from_arrays(schema, batch))
    return groups, schema, WriterProperties(codec=Codec.SNAPPY)


def cfg3_setup(small: bool = False):
    """BASELINE config 3's encode-side arm (bench.py:1233-1249, 1297-1299):
    4 near-sorted int64 timestamps ts{i} (1.7e12 + cumsum(U[0, 50)) +
    U[0, 5)) and 4 columns u{i} of 32-char hex strings of U[0, 2^62), as
    ByteColumns, drawn in bench.py's order from seed 3; UNCOMPRESSED, the
    dictionary off, delta fallback on, 640 KiB pages.  bench.py writes one
    batch of 131,072 rows; here 524,288 rows are drawn (the same
    distribution and row widths) and cut into four row groups of 131,072
    (small: two of 8,192), so that the pipeline has work to overlap."""
    from kpw_tpu_torch.core import (Codec, Schema, WriterProperties,
                                    columns_from_arrays, leaf)
    from kpw_tpu_torch.core.bytecol import ByteColumn

    rows, n_groups = (8_192, 2) if small else (CFG3_ROWS, CFG3_GROUPS)
    total = rows * n_groups
    rng = np.random.default_rng(3)
    base = 1_700_000_000_000
    arrays = {f"ts{i}": (base + np.cumsum(rng.integers(0, 50, total))
                         + rng.integers(0, 5, total)).astype(np.int64)
              for i in range(4)}
    hexes = {f"u{i}": [f"{v:032x}".encode() for v in rng.integers(0, 1 << 62, total)]
             for i in range(4)}
    schema = Schema([leaf(f"ts{i}", "int64") for i in range(4)]
                    + [leaf(f"u{i}", "string") for i in range(4)])
    groups = []
    for at in range(0, total, rows):
        batch = {k: v[at:at + rows] for k, v in arrays.items()}
        batch |= {k: ByteColumn.from_list(v[at:at + rows]) for k, v in hexes.items()}
        groups.append(columns_from_arrays(schema, batch))
    return groups, schema, WriterProperties(
        codec=Codec.UNCOMPRESSED, enable_dictionary=False, delta_fallback=True,
        data_page_size=640 * 1024)


SETUPS = {"writer": writer_setup, "levels": levels_setup, "nested": nested_setup,
          "encodings": encodings_setup, "strings": strings_setup, "cfg3": cfg3_setup}
# the paths whose delta pages are planned: one launch per ring with pages
# (both rings: int64 values and string lengths) a row group
DELTA_RINGS = {"encodings": 2, "cfg3": 2}


def write_batches(encoder, groups, schema, props, pipeline: bool = False):
    """Write prebuilt batches one row group each; (file bytes, seconds,
    stage busy seconds).  The pipelined writer gets row_group_size=1, so
    each batch is handed to its pipeline as its own row group."""
    import torch

    from kpw_tpu_torch.core import ParquetFileWriter
    from kpw_tpu_torch.ops.backend import CudaChunkEncoder

    buf = io.BytesIO()
    p = dataclasses.replace(props, row_group_size=1) if pipeline else props
    t0 = time.perf_counter()
    w = ParquetFileWriter(buf, schema, p, encoder=encoder, pipeline=pipeline)
    for batch in groups:
        w.write_batch(batch)
        if pipeline:
            w.maybe_flush_row_group()
        else:
            w.flush_row_group()
    w.close()
    if isinstance(encoder, CudaChunkEncoder) and encoder.device.type == "cuda":
        torch.cuda.synchronize()
    return buf.getvalue(), time.perf_counter() - t0, w.stage_busy_s


CODEC_NAMES = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 6: "ZSTD"}
# the four files of a writer path: (key, label, encoder kind, pipelined)
WRITERS = (("card", "CudaChunkEncoder", "cuda", False),
           ("pipelined", "pipelined", "cuda", True),
           ("native", "NativeChunkEncoder", "native", False),
           ("cpu", "CpuChunkEncoder", "cpu", False))


def write_four(groups, schema, props, device="cuda") -> dict:
    """The batches through ``CudaChunkEncoder`` row group by row group and
    pipelined, and through the port's ``NativeChunkEncoder`` and
    ``CpuChunkEncoder``.  Returns, by key of :data:`WRITERS`, each file,
    its seconds and the column chunks its encoder put through the native
    assembler, and the pipeline's stage busy seconds."""
    from kpw_tpu_torch.core.pages import CpuChunkEncoder
    from kpw_tpu_torch.native.encoder import NativeChunkEncoder
    from kpw_tpu_torch.ops.backend import CudaChunkEncoder

    opts = props.encoder_options()
    make = {"cuda": lambda: CudaChunkEncoder(opts, device=device),
            "native": lambda: NativeChunkEncoder(opts),
            "cpu": lambda: CpuChunkEncoder(opts)}
    out = {"files": {}, "seconds": {}, "asm_chunks": {}, "busy": None}
    for key, _, kind, pipeline in WRITERS:
        encoder = make[kind]()
        data, seconds, busy = write_batches(encoder, groups, schema, props, pipeline)
        out["files"][key], out["seconds"][key] = data, seconds
        out["asm_chunks"][key] = encoder.native_asm_chunks
        if pipeline:
            out["busy"] = busy
    return out


# the device routes each writer path must call, each at least once
PATH_CALLS = {
    "writer": ("pack_pages_multi",),
    "levels": ("level_stats_multi", "level_runs_multi"),
    "nested": ("level_stats_multi",),
    # its BYTE_STREAM_SPLIT pages are transposed inside the native
    # assembler's call (OP_KINDS 5), as in the JAX package's encoder
    "encodings": ("delta_page_streams", "string_pack_jobs"),
    "strings": ("pack_pages_multi", "string_pack_jobs"),
    "cfg3": ("delta_page_streams",),
}
COUNTED = (("backend", "pack_pages_multi"), ("backend", "level_stats_multi"),
           ("backend", "level_runs_multi"), ("backend", "delta_page_streams"),
           ("backend", "byte_stream_split_device"), ("packing", "_pad_rows"))
# the device routes whose arguments are kept, to replay their kernels
# against the plain versions on the main path's own inputs afterwards
RECORDED = ("pack_pages_multi", "level_stats_multi", "delta_page_streams")


def auto_choice(groups, schema, props, device="cuda"):
    """What ``"auto"`` picks for a writer of these batches: its first row
    group through the ``CalibratingEncoder`` (``runtime/select.py``).
    Returns the writer's ``AutoChoice``."""
    from kpw_tpu_torch.core import ParquetFileWriter
    from kpw_tpu_torch.runtime.select import AutoChoice, make_encoder

    choice = AutoChoice(device)
    w = ParquetFileWriter(io.BytesIO(), schema, props, encoder=make_encoder(
        props.encoder_options(), "auto", device, choice))
    w.write_batch(groups[0])
    w.close()
    return choice


def writer_path(name: str, groups, schema, props, device="cuda") -> dict:
    """One writer main path: the batches through ``ParquetFileWriter`` +
    ``CudaChunkEncoder`` row group by row group and through the writer's
    pipeline (whose dispatch thread runs ``launch_many`` while its
    assembly thread runs ``assemble_many`` of the row group before), and
    through the port's ``NativeChunkEncoder``; all three files equal byte
    for byte to the port's ``CpuChunkEncoder`` file.  Every column chunk of
    the ``CudaChunkEncoder`` and ``NativeChunkEncoder`` files must go
    through the native assembler (``_encode_native_chunk``) and no level
    page through the Python replay of its run list (``_LevelPages.blob``).
    The encoder's device routes and the string planner's pack jobs are
    counted.  Returns the counts, the arguments of every call of the
    ``RECORDED`` routes and the rows/s of each file by key of
    :data:`WRITERS`."""
    from kpw_tpu_torch.ops import backend, packing

    modules = {"backend": backend, "packing": packing}
    calls = dict.fromkeys((f for _, f in COUNTED), 0)
    calls |= {"string_pack_jobs": 0, "string_columns": 0, "level_blob_replays": 0}
    recorded = {f: [] for f in RECORDED}
    saved = {f: getattr(modules[m], f) for m, f in COUNTED}
    planner, blob = backend._StringDictPlanner, backend._LevelPages.blob

    def counted(f):
        def call(*args, **kwargs):
            calls[f] += 1
            if f in recorded:
                recorded[f].append((args, kwargs))
            return saved[f](*args, **kwargs)
        return call

    class CountedPlanner(planner):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            calls["string_pack_jobs"] += len(self._groups)
            calls["string_columns"] += len(self._items)

    def counted_blob(pages):
        calls["level_blob_replays"] += 1
        return blob(pages)

    for m, f in COUNTED:
        setattr(modules[m], f, counted(f))
    backend._StringDictPlanner = CountedPlanner
    backend._LevelPages.blob = counted_blob
    try:
        out = write_four(groups, schema, props, device)
    finally:
        for m, f in COUNTED:
            setattr(modules[m], f, saved[f])
        backend._StringDictPlanner = planner
        backend._LevelPages.blob = blob
    files, seconds = out["files"], out["seconds"]
    for key, label, _, _ in WRITERS[:-1]:
        check(files[key] == files["cpu"], f"{name}: {label} file ({len(files[key])} "
              f"bytes) != CpuChunkEncoder file ({len(files['cpu'])} bytes)")
    check(out["busy"]["assemble"] > 0, f"{name}: the pipeline ran no assembly thread")
    check(all(calls[f] > 0 for f in PATH_CALLS[name]),
          f"{name}: a device route of the path did not run: {calls}")
    chunks = len(schema.columns) * len(groups)
    asm = out["asm_chunks"]
    check(all(asm[key] == chunks for key in ("card", "pipelined", "native")),
          f"{name}: native assembler column chunks {asm}, not {chunks} each")
    check(calls["level_blob_replays"] == 0, f"{name}: "
          f"{calls['level_blob_replays']} level pages replayed in Python")
    rows = sum(b.num_rows for b in groups)
    say(f"[{name}] {len(schema.columns)} cols x {rows} rows in {len(groups)} row "
        f"groups, {CODEC_NAMES[props.codec]}, {len(files['card'])} bytes, all four "
        "files byte-identical; rows/s "
        + ", ".join(f"{label} {rows / seconds[key]:.0f} ({seconds[key]:.3f} s)"
                    for key, label, _, _ in WRITERS)
        + "; pipeline stage busy s "
        + ", ".join(f"{k} {v:.3f}" for k, v in out["busy"].items())
        + f"; native assembler column chunks {asm}; device routes called: {calls}")
    return calls, recorded, {key: rows / seconds[key] for key, _, _, _ in WRITERS}


def check_path_inputs(torch, name: str, recorded) -> dict:
    """Replay the kernels of one writer path on the inputs the path gave
    them, against their plain versions, exactly: every pack job (dictionary
    and string index pages: the index batch and its page table) and every
    level planner phase-A group (the stacked level batch and its page
    table, with the run count on) through the fused pack, and every delta
    planner launch (the ring's stacked streams and page table) through the
    delta kernel, byte for byte.  Returns the largest error per kernel
    (0)."""
    from kpw_tpu_torch.ops import bitpack, delta, packing

    err = {"bitpack": 0, "delta": 0}
    seen = {"pack jobs": [], "level pack": [], "delta": []}
    for route, label, n_runs in (("pack_pages_multi", "pack jobs", False),
                                 ("level_stats_multi", "level pack", True)):
        for (batch, ids, starts, counts, bucket, width), _ in recorded[route]:
            idx = packing.bits32(batch)
            table = packing.page_table(ids, starts, counts, idx.device)
            got = bitpack.pack_pages(idx, table, bucket, width, n_runs=n_runs)
            want = bitpack.pack_pages_plain(idx, table, bucket, width, n_runs=n_runs)
            e = max(max_abs_err(torch, g, w) for g, w in zip(got, want)
                    if g is not None)
            check(e == 0, f"{name}: fused pack (n_runs {n_runs}) on the path's "
                  f"{label} batch {tuple(batch.shape)} bucket {bucket} width "
                  f"{width}: max err {e}")
            err["bitpack"] = max(err["bitpack"], e)
            seen[label].append(f"{tuple(batch.shape)} P {len(ids)} bucket {bucket} "
                               f"width {width}")
    # ring -> readback bytes of the first row group's launches: those
    # before a ring repeats; sync 1 reads the offsets and the width flag,
    # sync 2 the bytes written
    first_group: dict = {}
    in_first = True
    for (streams, table, bit_size, max_bits), _ in recorded["delta_page_streams"]:
        got = delta.delta_page_streams(streams, table, bit_size, max_bits)
        in_first = in_first and bit_size not in first_group
        if in_first:
            first_group[bit_size] = int(got[1][-1]) + got[1].nbytes + got[2].nbytes
        want = delta.delta_page_streams_plain(streams, table, bit_size, max_bits)
        e = same_streams(torch, got, want)
        check(e == 0, f"{name}: delta on the path's {bit_size}-bit ring streams "
              f"{tuple(streams.shape)}, {len(table)} pages: max err {e}")
        err["delta"] = max(err["delta"], e)
        seen["delta"].append(f"{tuple(streams.shape)} ring {bit_size} P {len(table)} "
                             f"max_bits {max_bits}")
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if first_group:
        say(f"[{name}] delta readback of the first row group's "
            f"{len(first_group)} launch(es): {sum(first_group.values())} bytes "
            f"(offsets, width flag and the bytes written; by ring {first_group})")
    for label, groups in seen.items():
        if groups:
            distinct = sorted(set(groups))
            say(f"[{name}] {label} == plain on the path's own inputs, "
                f"{len(groups)} launch(es), {len(distinct)} distinct: "
                + "; ".join(distinct[:8]) + ("; ..." if len(distinct) > 8 else ""))
    return err


def string_probe(torch, inputs, device="cuda") -> None:
    """The device string dictionary probe (``ops.strings``, the JAX
    package's ``bench.py:354-399``): on config 1's four string columns of
    one row group (bench.py's 262,144 rows) and on one row group of the
    encodings corpus's 13-byte ``uid`` column (every row takes the host
    tie-break), each dictionary equal to ``core.encodings.dictionary_build``;
    then the best of three runs over the columns, with the phases of the
    last column, beside the best of three of the native hash
    (``dict_build_bytes``) over the same columns.  Host clock; the probe
    reads its indices back, so each call ends in a synchronize."""
    from kpw_tpu_torch import native
    from kpw_tpu_torch.core import encodings as enc
    from kpw_tpu_torch.core.schema import PhysicalType
    from kpw_tpu_torch.ops.strings import device_string_dictionary

    L = native.lib()
    cfg1 = [c.values for c in inputs["strings"][0][0].chunks
            if c.column.name.startswith("s")]
    uid = [c.values for c in inputs["encodings"][0][0].chunks
           if c.column.name == "uid"]
    for label, cols in (("config 1 s0..s3", cfg1), ("encodings uid", uid)):
        for col in cols:
            got = device_string_dictionary(col, device=device)
            want_d, want_i = enc.dictionary_build(col, PhysicalType.BYTE_ARRAY)
            check(got is not None and got[0] == list(want_d)
                  and np.array_equal(got[1], want_i),
                  f"device string dictionary differs from core.encodings on {label}")
        best, phases = float("inf"), {}
        for _ in range(3):
            t: dict = {}
            t0 = time.perf_counter()
            for col in cols:
                device_string_dictionary(col, timings=t, device=device)
            dt = time.perf_counter() - t0
            if dt < best:
                best, phases = dt, t
        host = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for col in cols:
                L.dict_build_bytes(col.data, col.offsets, None)
            host = min(host, time.perf_counter() - t0)
        say(f"[strings probe] {label}, {len(cols)} x {len(cols[0])} values: "
            f"== core.encodings.dictionary_build; device probe {best * 1e3:.3f} ms "
            f"(last column's phases {phases}), native hash {host * 1e3:.3f} ms")


def one_group_stages(batch, schema, props, runs: int = 5) -> dict:
    """One row group through a fresh ``CudaChunkEncoder`` ``runs`` times:
    the median of each encoder stage span, in ms (host clock; the write
    ends in the assembly, which waits on the readbacks)."""
    from kpw_tpu_torch.core import ParquetFileWriter
    from kpw_tpu_torch.ops.backend import CudaChunkEncoder
    from kpw_tpu_torch.utils.tracing import StageTimer, set_tracer

    spans: dict = {}
    for _ in range(runs):
        timer = StageTimer()
        set_tracer(timer)
        try:
            w = ParquetFileWriter(io.BytesIO(), schema, props,
                                  encoder=CudaChunkEncoder(props.encoder_options()))
            w.write_batch(batch)
            w.flush_row_group()
        finally:
            set_tracer(None)
        for k, v in timer.summary().items():
            spans.setdefault(k, []).append(v["seconds"] * 1e3)
    return {k: round(statistics.median(v), 3) for k, v in spans.items()}


def group_breakdown(torch, name: str, batch, schema, props) -> None:
    """Where one CudaChunkEncoder row group's time goes: the median stage
    spans of five runs (host clock), then one run's device profile."""
    from kpw_tpu_torch.core import ParquetFileWriter
    from kpw_tpu_torch.ops.backend import CudaChunkEncoder

    stages = one_group_stages(batch, schema, props)

    def one_group():
        w = ParquetFileWriter(io.BytesIO(), schema, props,
                              encoder=CudaChunkEncoder(props.encoder_options()))
        w.write_batch(batch)
        w.flush_row_group()

    say(f"[{name}] one row group: median stage ms of 5 runs {stages}; profiled: "
        + device_profile(torch, one_group))


# ---------------------------------------------------------------------------
# the mesh phase: BASELINE config 4 over a shard mesh
# ---------------------------------------------------------------------------

def cfg4_values(small: bool = False) -> np.ndarray:
    """Config 4's (16, 8 x 131,072) uint32 batch (bench.py:1350-1357)."""
    per = CFG4_SMALL_PER if small else CFG4_PER
    rng = np.random.default_rng(4)
    return rng.integers(0, CFG4_VMAX, (CFG4_COLS, CFG4_SHARDS * per)).astype(np.uint32)


def cfg4_oracle(vals: np.ndarray, width: int = 16):
    """Each column's dictionary (``np.unique``) and its rows' indices
    (``searchsorted``) bit-packed by ``core.encodings.bitpack``."""
    from kpw_tpu_torch.core import encodings as enc

    dicts = [np.unique(row) for row in vals]
    packed = np.stack([np.frombuffer(enc.bitpack(
        np.searchsorted(d, row).astype(np.uint64), width), np.uint8)
        for d, row in zip(dicts, vals)])
    return dicts, packed


def cfg4_steps(torch, vals: np.ndarray, n_shards: int, device: str) -> dict:
    """Config 4's step on both routes over ``n_shards`` shards on
    ``device`` (8 shards on one card are 8 shards on ``cuda:0``): route ->
    a call returning (packed, dictionary, k, rows, overflow)."""
    from kpw_tpu_torch.parallel.mesh import make_mesh
    from kpw_tpu_torch.parallel.sharded import (sharded_encode_step,
                                                sharded_encode_step_bounded)

    mesh = make_mesh(n_shards, device=device)
    N = vals.shape[1]
    counts = np.full(n_shards, N // n_shards, np.int32)
    lo = torch.from_numpy(vals.view(np.int32)).to(mesh.first)
    hi = torch.zeros_like(lo)

    def gather():
        packed, _, mlo, gk, rows, ovf = sharded_encode_step(
            hi, lo, counts, mesh=mesh, cap=CFG4_CAP, width=16, has_hi=False)
        return packed, mlo, gk, rows, ovf

    def bounded():
        return sharded_encode_step_bounded(lo, counts, mesh=mesh, width=16,
                                           value_bound=CFG4_VMAX)

    return {"gather": gather, "bounded": bounded}


def cfg4_writer_setup(small: bool = False):
    """Config 4's writer route: the bench's column classes (bench.py:1499-1512)
    at 4 row groups of 262,144 rows: ``zone`` int32 in [1, 266), ``cents``
    int64 multiples of 25 below 125,000, ``wide`` int64 in [-500, 500)
    (negative, so it takes the gather route)."""
    from kpw_tpu_torch.core import Schema, WriterProperties, columns_from_arrays, leaf

    rows = CFG4_SMALL_ROWS if small else CFG4_ROWS
    rng = np.random.default_rng(46)
    schema = Schema([leaf("zone", "int32"), leaf("cents", "int64"),
                     leaf("wide", "int64")])
    groups = [columns_from_arrays(schema, {
        "zone": rng.integers(1, 266, rows).astype(np.int32),
        "cents": (rng.integers(0, 5000, rows) * 25).astype(np.int64),
        "wide": rng.integers(-500, 500, rows).astype(np.int64)})
        for _ in range(CFG4_GROUPS)]
    return groups, schema, WriterProperties()


@contextlib.contextmanager
def recording(module, store: dict):
    """Inside the block, each call of ``module.<name>`` for each name in
    ``store`` appends its arguments to ``store[name]``."""
    origs = {name: getattr(module, name) for name in store}

    def wrap(name):
        def wrapper(*args, **kwargs):
            store[name].append(args)
            return origs[name](*args, **kwargs)
        return wrapper

    for name in store:
        setattr(module, name, wrap(name))
    try:
        yield
    finally:
        for name, f in origs.items():
            setattr(module, name, f)


def mesh_path(torch, counters: dict, small: bool = False, device: str = "cuda") -> dict:
    """Config 4 over a shard mesh.  The step (``sharded_encode_step``, the
    gather route, and ``sharded_encode_step_bounded``, the histogram-psum
    route) over 8 shards on ``device``, then over 1: dictionaries, k and
    packed bytes equal to the numpy oracle and to the same call on CPU
    shards; each bounded step launches the hist and rank kernels once a
    shard, and every step the pack kernel once a shard.  Then config 4's
    writer route: 4 row groups through ``MeshChunkEncoder`` over 8 shards,
    the file byte-identical to ``CpuChunkEncoder``'s, ``zone`` and
    ``cents`` on the bounded route, ``wide`` on the gather route.  Returns
    what the timing needs and the hist / rank inputs the mesh gave the
    kernels."""
    from kpw_tpu_torch.core.pages import CpuChunkEncoder
    from kpw_tpu_torch.parallel import sharded
    from kpw_tpu_torch.parallel.mesh import make_mesh
    from kpw_tpu_torch.parallel.mesh_encoder import MeshChunkEncoder

    vals = cfg4_values(small)
    dicts, want_packed = cfg4_oracle(vals)
    recorded = {"hist_pages": [], "rank_pages": []}
    steps = {}
    for n_shards in (CFG4_SHARDS, 1):
        steps[n_shards] = cfg4_steps(torch, vals, n_shards, device)
        cpu = cfg4_steps(torch, vals, n_shards, "cpu")
        for route, step in steps[n_shards].items():
            before = {k: f.launches for k, f in counters.items()}
            with recording(sharded, recorded):
                got = step()
            grew = {k: f.launches - before[k] for k, f in counters.items()}
            want_grew = {"bitpack": n_shards, "hist": 0, "rank": 0, "delta": 0}
            if route == "bounded":
                want_grew.update(hist=n_shards, rank=n_shards)
            if device == "cuda":
                check(grew == want_grew, f"mesh {route} x{n_shards}: launches "
                      f"{grew}, not {want_grew} (one a shard)")
            host = [t.cpu() for t in got]
            packed, dic, k, rows, ovf = host
            check(int(rows) == vals.shape[1] and int(ovf) == 0,
                  f"mesh {route} x{n_shards}: rows {int(rows)}, overflow {int(ovf)}")
            check(np.array_equal(packed.numpy(), want_packed),
                  f"mesh {route} x{n_shards}: packed bytes differ from the oracle")
            for c, d in enumerate(dicts):
                check(int(k[c]) == len(d) and np.array_equal(
                    dic[c, :len(d)].numpy(), d.astype(np.int64)),
                    f"mesh {route} x{n_shards}: column {c}'s dictionary differs "
                    "from the oracle")
            t0 = time.perf_counter()
            want_cpu = cpu[route]()
            cpu_s = time.perf_counter() - t0
            for name, g, w in zip(("packed", "dictionary", "k", "rows", "overflow"),
                                  host, want_cpu):
                check(torch.equal(g, w), f"mesh {route} x{n_shards}: {name} "
                      "differs from the CPU shards'")
            say(f"[mesh] config 4 {route} route, {n_shards} shard(s) on "
                f"{device}: ({vals.shape[0]}, {vals.shape[1]}) uint32 from "
                f"[0, {CFG4_VMAX}): == numpy oracle == CPU shards (their call "
                f"{cpu_s:.2f} s); launches {grew}")

    groups, schema, props = cfg4_writer_setup(small)
    opts = props.encoder_options()
    menc = MeshChunkEncoder(opts, mesh=make_mesh(CFG4_SHARDS, device=device))
    before = {k: f.launches for k, f in counters.items()}
    with recording(sharded, recorded):
        data, seconds, _ = write_batches(menc, groups, schema, props)
    grew = {k: f.launches - before[k] for k, f in counters.items()}
    want, cpu_seconds, _ = write_batches(CpuChunkEncoder(opts), groups, schema, props)
    check(data == want, "mesh writer: the MeshChunkEncoder file differs from "
          "CpuChunkEncoder's")
    routes = {}
    for e in menc.route_log:
        check(e["accepted"], f"mesh writer: {e} not accepted")
        routes.setdefault(e["column"], set()).add(e["route"])
    check(routes == {"zone": {"bounded-psum"}, "cents": {"bounded-psum"},
                     "wide": {"two-phase-gather"}},
          f"mesh writer: routes {routes}")
    bounded_launches = 2 * len(groups) * CFG4_SHARDS
    if device == "cuda":
        check(grew["hist"] == grew["rank"] == bounded_launches,
              f"mesh writer: launches {grew}, not {bounded_launches} hist and rank "
              "(2 bounded columns x row groups x shards)")
    rows = CFG4_GROUPS * (CFG4_SMALL_ROWS if small else CFG4_ROWS)
    say(f"[mesh] config 4 writer route: {CFG4_GROUPS} row groups of {rows // CFG4_GROUPS} "
        f"rows through MeshChunkEncoder over {CFG4_SHARDS} shards on {device}: "
        f"byte-identical to CpuChunkEncoder ({len(data)} bytes); routes "
        f"{ {c: sorted(r) for c, r in routes.items()} }; ici_stats {menc.ici_stats}; "
        f"launches {grew}; {rows / seconds:.0f} rows/s (CpuChunkEncoder "
        f"{rows / cpu_seconds:.0f})")
    return {"steps": steps, "recorded": recorded, "vals": vals}


def check_mesh_inputs(torch, recorded: dict) -> dict:
    """Every hist and rank launch of the mesh path replayed on the inputs
    the mesh gave it, against the plain version: max error by kernel."""
    from kpw_tpu_torch.ops import rank

    err = {"hist": 0, "rank": 0}
    for m, nhi in recorded["hist_pages"]:
        got = rank.hist_dict(m, m.shape[1], nhi)
        want = rank.hist_dict_plain(m, m.shape[1], nhi)
        err["hist"] = max(err["hist"], *(max_abs_err(torch, g, w)
                                          for g, w in zip(got, want)))
    for m, rt in recorded["rank_pages"]:
        err["rank"] = max(err["rank"], max_abs_err(
            torch, rank.rank_pages(m, rt), rank.rank_pages_plain(m, rt)))
    check(err == {"hist": 0, "rank": 0}, f"mesh: a kernel differs from its plain "
          f"version on the mesh's inputs: {err}")
    say(f"[mesh] replayed {len(recorded['hist_pages'])} hist and "
        f"{len(recorded['rank_pages'])} rank launches on the mesh's inputs (the "
        "steps' and the writer route's): == plain versions")
    return err


def mesh_timing(torch, timer: Timer, out: dict) -> None:
    """Each config-4 route's step time over 8 shards and over 1 on the card
    (CUDA events, median of 25), the merge's payload, one shard's hist and
    rank kernel times, and the gather merge's rank."""
    from kpw_tpu_torch.ops import rank
    from kpw_tpu_torch.parallel import dict_merge
    from kpw_tpu_torch.parallel.sharded import bounded_psum_payload_bytes

    vals = out["vals"]
    C, N = vals.shape
    for n_shards, steps in out["steps"].items():
        times = {route: timer.ms(step) for route, step in steps.items()}
        say(f"[mesh] config 4 step, {n_shards} shard(s): "
            + ", ".join(f"{r} {t:.4f} ms ({N / t / 1e3:.0f} M rows/s)"
                        for r, t in times.items())
            + f"; merge payload a step: gather {n_shards * CFG4_CAP * 5 * C} B "
            f"(keys 4 B + valid 1 B, cap {CFG4_CAP}, a shard), psum "
            f"{n_shards * bounded_psum_payload_bytes(CFG4_VMAX) * C} B "
            f"({bounded_psum_payload_bytes(CFG4_VMAX)} B a column a shard)")
    m, nhi = out["recorded"]["hist_pages"][0]
    _, rt = out["recorded"]["rank_pages"][0]
    say(f"[mesh] one shard's kernels at ({m.shape[0]}, {m.shape[1]}) nhi {nhi}: hist "
        f"(the whole hist_dict launch) {timer.ms(lambda: rank.hist_pages(m, nhi)):.4f} ms, "
        f"rank {timer.ms(lambda: rank.rank_pages(m, rt)):.4f} ms")
    d = torch.arange(CFG4_VMAX, device="cuda").expand(C, CFG4_VMAX).contiguous()
    k = torch.full((C,), CFG4_VMAX, device="cuda")
    v = dict_merge._u32(m)
    search = timer.ms(lambda: dict_merge._rank_keys(d, k, v, has_hi=False))
    say(f"[mesh] gather merge's rank of one shard ({C}, {v.shape[1]}) against "
        f"{CFG4_VMAX} keys (torch.searchsorted): {search:.4f} ms")


# ---------------------------------------------------------------------------
# the stream phase: the streaming writer end to end
# ---------------------------------------------------------------------------

# the arms of the stream phase: (label, encoder backend, worker threads,
# worker processes, the processes' in-flight bound in units); an arm with
# processes runs no worker thread.  The "i64" arms raise the bound from
# the reference's 8 units: a child settles units only when their file
# publishes, and with 4 partitions a unit is a quarter of a poll, so 8
# units hold less than a 4 MiB file and files end by time rotation.
STREAM_ARMS = (("cuda x1", "cuda", 1, 0, 8), ("cuda x4", "cuda", 4, 0, 8),
               ("native x1", "native", 1, 0, 8), ("native x4", "native", 4, 0, 8),
               ("auto x1", "auto", 1, 0, 8),
               ("cuda p1", "cuda", 1, 1, 8), ("cuda p4", "cuda", 1, 4, 8),
               ("native p1", "native", 1, 1, 8), ("native p4", "native", 1, 4, 8),
               ("cuda p1 i64", "cuda", 1, 1, 64), ("cuda p4 i64", "cuda", 1, 4, 64),
               ("native p1 i64", "native", 1, 1, 64),
               ("native p4 i64", "native", 1, 4, 64))
DET_SLOT_BYTES = 8192  # the deterministic process arm's ring slots
# the sink arms, each with the thread arms' settings: (label, encoder
# backend, sink); "mesh" takes one shard per visible card
SINK_ARMS = (("mesh x1", "mesh", "local"), ("objectstore x1", "cuda", "objectstore"),
             ("failover x1", "cuda", "failover"))
OBJECT_PART = 1 << 20  # the object store's part size: a 4 MiB file in 4 parts


def rooted_fs(root: str):
    """A LocalFileSystem that keeps the logical path p at ``root + p``: the
    failover arm's fallback, which must see the primary's paths."""
    from kpw_tpu_torch import LocalFileSystem

    class Rooted(LocalFileSystem):
        def _p(self, path: str) -> str:
            return root + path

        def mkdirs(self, path):
            super().mkdirs(self._p(path))

        def open_write(self, path):
            return super().open_write(self._p(path))

        def open_append(self, path):
            return super().open_append(self._p(path))

        def open_read(self, path):
            return super().open_read(self._p(path))

        def rename(self, src, dst):
            super().rename(self._p(src), self._p(dst))

        def sync(self, path):
            super().sync(self._p(path))

        def sync_dir(self, path):
            super().sync_dir(self._p(path))

        def exists(self, path):
            return super().exists(self._p(path))

        def delete(self, path):
            super().delete(self._p(path))

        def size(self, path):
            return super().size(self._p(path))

        def list_files(self, path, extension=None, recursive=True):
            return [f[len(root):] for f in
                    super().list_files(self._p(path), extension, recursive)]

    return Rooted()


def failover_sink(root: str, name: str):
    """A FailoverFileSystem whose primary is a FaultInjectingFileSystem over
    the local directory, every open failing with ENOSPC from the first
    until healed, and whose fallback is a second local directory.  Returns
    (the filesystem, a tick that heals the primary once a file spilled, a
    predicate true once every spill was reconciled onto the primary)."""
    import errno

    from kpw_tpu_torch import (FailoverFileSystem, FaultInjectingFileSystem,
                               FaultSchedule, LocalFileSystem)

    sched = FaultSchedule(seed=0).recover_after("open", nth=1, err=errno.ENOSPC)
    ffs = FailoverFileSystem(FaultInjectingFileSystem(LocalFileSystem(), sched),
                             rooted_fs(os.path.join(root, name + "-fallback")),
                             probe_interval_s=0.05)
    healed = []

    def tick():
        if not healed and ffs.failover_stats()["spilled"] >= 1:
            sched.heal()
            healed.append(True)

    def reconciled():
        st = ffs.failover_stats()
        return (healed and not ffs.degraded() and not st["spilled_pending"]
                and st["reconciled"] == st["spilled"] >= 1)

    return ffs, tick, reconciled


def stream_builder(broker, topic: str, target: str, backend: str, threads: int,
                   device: str, name: str, deterministic: bool = False,
                   file_size: int = 4 * 1024 * 1024, procs: int = 0, rows: int = 0,
                   inflight: int = 8):
    """The e2e probe's Builder (bench.py:3952-3960) over a LocalFileSystem:
    SNAPPY, autotune, batch ingest, 4 MiB files (``file_size``) of row
    groups half that size, files time-rotated after 0.5 s; ``procs``
    worker processes in place of the threads when set, each with at most
    ``inflight`` units dispatched and not yet acked.
    ``deterministic``: autotune, time rotation and the row-group pipeline
    off, and polls of 64 records from fetches of 2,048, so that the run's
    files depend on its records alone: each append then holds 64 records
    (while the fetcher stays ahead), and the size checks that rotate files
    and cut row groups see every flushed row group's final size.  With
    processes the unit a child appends is cut by the dispatcher from polls
    of 256 records: ring slots of 8 KiB and a consumer queue that holds
    all ``rows`` (so no fetch of 2,048 is admitted in slices, and no poll
    straddles two fetches) make every unit depend on the records alone;
    a child settles its units only when the file that holds them
    publishes, so with time rotation off the in-flight bound must cover a
    whole file of units."""
    from kpw_tpu_torch import Builder, LocalFileSystem

    b = (Builder().broker(broker).topic(topic).proto_class(replay_class())
         .target_dir(target).filesystem(LocalFileSystem())
         .instance_name(name).group_id(name).thread_count(threads)
         .encoder_backend(backend, device=device)
         .compression("snappy").autotune(not deterministic).batch_ingest(True)
         .max_file_size(file_size).block_size(file_size // 2)
         .max_file_open_duration_seconds(3600.0 if deterministic else 0.5))
    if deterministic:
        b.pipeline(False).batch_size(64).fetch_max_records(2048)
    if procs and deterministic:
        b.process_workers(procs, slot_bytes=DET_SLOT_BYTES, max_inflight_units=1 << 20)
        b.max_queued_records_in_consumer(max(rows, 100_000))
    elif procs:
        b.process_workers(procs, max_inflight_units=inflight)
    return b


def drain(w, broker, topic: str, group: str, parts: int, rows: int,
          deadline_s: float = 300.0, tick=None, ready=None) -> tuple:
    """Start ``w`` and wait until every record is written and then until
    every offset is committed with ack-lag 0 (bench.py:3965-3990) and
    ``ready()``, when given, holds; ``tick()`` runs at every poll: (seconds
    to the first record written, to all written, to drained).  The first
    is the start-up a worker process pays (interpreter, imports, a CUDA
    context) before it writes.  Fails at the deadline."""
    t0 = time.perf_counter()
    w.start()
    deadline = t0 + deadline_s
    t_first = t_written = None
    while time.perf_counter() < deadline:
        if tick is not None:
            tick()
        if t_first is None and w.total_written_records > 0:
            t_first = time.perf_counter() - t0
        if t_written is None and w.total_written_records >= rows:
            t_written = time.perf_counter() - t0
        if (t_written is not None
                and sum(broker.committed(group, topic, p) for p in range(parts)) >= rows
                and w.ack_lag()["unacked_records"] == 0
                and (ready is None or ready())):
            return t_first, t_written, time.perf_counter() - t0
        time.sleep(0.002)
    fail(f"stream {group}: not drained within {deadline_s:.0f} s: written "
         f"{w.total_written_records} of {rows}, committed "
         f"{sum(broker.committed(group, topic, p) for p in range(parts))}, "
         f"ack lag {w.ack_lag()}")


def published(target: str, rows: int, label: str, fs=None) -> list:
    """Every published file under ``target`` on ``fs`` (default: the local
    filesystem), read back and verified by the port's ``verify_file``;
    their footers' row counts must sum to ``rows``.  Returns the reports in
    publish order (the file names start with the publish time)."""
    from kpw_tpu_torch import LocalFileSystem
    from kpw_tpu_torch.io.verify import verify_dir

    reports = sorted(verify_dir(fs or LocalFileSystem(), target),
                     key=lambda r: r.path)
    bad = [(r.path, r.errors) for r in reports if not r.ok]
    check(not bad, f"stream {label}: files failed verification: {bad[:3]}")
    total = sum(r.num_rows for r in reports)
    check(total == rows, f"stream {label}: footers hold {total} rows, not {rows}")
    return reports


def span_sums(recorder) -> dict:
    """A SpanRecorder's spans summed by stage, in ``STAGE_NAMES`` order:
    name -> (seconds, count)."""
    from kpw_tpu_torch.utils.tracing import STAGE_NAMES

    sums: dict = {}
    for name, _, _, _, seconds, _ in recorder.snapshot():
        t, n = sums.get(name, (0.0, 0))
        sums[name] = (t + seconds, n + 1)
    return {k: sums[k] for k in STAGE_NAMES if k in sums}


def child_spans(w, name: str) -> dict:
    """Spans named ``name`` that a process-worker writer's children
    shipped to it (the process pool's telemetry channel: each child drains
    its span ring over the ack queue at file boundaries and at exit),
    counted by child pid; none of the parent's own."""
    out: dict = {}
    for e in w.trace_merger.to_chrome_trace()["traceEvents"]:
        if e.get("ph") == "X" and e["name"] == name and e["pid"] != os.getpid():
            out[e["pid"]] = out.get(e["pid"], 0) + 1
    return out


def stream_arm(broker, topic: str, parts: int, rows: int, backend: str,
               threads: int, device: str, root: str, name: str,
               tracing: bool = False, procs: int = 0, inflight: int = 8,
               sink: str = "local") -> dict:
    """One arm: drain the primed topic through a fresh writer and consumer
    group, close it, verify its files.  ``sink``: ``"local"``, a local
    directory; ``"objectstore"``, an ``EmulatedObjectStore`` through
    ``Builder.object_store`` (every object read back from the store, no
    multipart upload left pending); ``"failover"``, :func:`failover_sink`
    (at least one spill, every spill reconciled onto the primary before
    the check, none left on the fallback).  Returns records/s (to all
    written), the drain time, the files, the rows per row group and, with
    ``tracing``, the SpanRecorder's spans summed by stage; with ``procs``
    and ``tracing``, the ``encode.launch`` spans (recorded only by
    ``CudaChunkEncoder`` around its launches) that each child shipped."""
    target = os.path.join(root, name)
    b = stream_builder(broker, topic, target, backend, threads, device, name,
                       procs=procs, inflight=inflight)
    if tracing:
        b.tracing(True)
    fs = tick = ready = ffs = None
    if sink == "objectstore":
        from kpw_tpu_torch import EmulatedObjectStore, ObjectStoreFileSystem

        store = EmulatedObjectStore()
        b.object_store(store, "kpw", part_size=OBJECT_PART)
        fs = ObjectStoreFileSystem(store, "kpw")
    elif sink == "failover":
        ffs, tick, ready = failover_sink(root, name)
        b.filesystem(ffs)
    w = b.build()
    try:
        t_first, t_written, t_drained = drain(w, broker, topic, name, parts, rows,
                                              tick=tick, ready=ready)
        spans = span_sums(w.span_recorder) if tracing and not procs else {}
    finally:
        w.close()
        if ffs is not None:
            ffs.close()
    launch_spans = child_spans(w, "encode.launch") if tracing and procs else {}
    sink_note = ""
    if sink == "objectstore":
        st = store.stats()
        check(st["multipart_pending"] == 0, f"stream {name}: multipart uploads "
              f"left pending: {st}")
        sink_note = (f"; store: {st['objects']} objects ({st['multipart_completed']} "
                     f"multipart, {st['parts_uploaded']} parts), multipart pending 0, "
                     f"{st['requests_total']} requests")
    elif sink == "failover":
        from kpw_tpu_torch.io.verify import verify_dir

        st = ffs.failover_stats()
        left = [r.path for r in verify_dir(ffs.fallback, target)]
        check(not left, f"stream {name}: finals left on the fallback: {left}")
        sink_note = (f"; failover: {st['spilled']} spilled, {st['reconciled']} "
                     f"reconciled onto the primary, failovers {st['failovers']}, "
                     f"recoveries {st['recoveries']}, none left on the fallback")
    reports = published(target, rows, name, fs)
    groups = sum(r.row_groups for r in reports)
    # steady: after the first record was written, once the workers are up
    return {"rows_s": rows / t_written, "written_s": t_written,
            "first_s": t_first, "steady_rows_s": rows / max(t_written - t_first, 1e-9),
            "drained_s": t_drained, "files": len(reports),
            "rows_per_group": rows / groups, "spans": spans,
            "choice": w.encoder_choice, "child_launch_spans": launch_spans,
            "sink": sink_note}


def deterministic_files(payloads: list, backend: str, device: str, root: str,
                        file_size: int, procs: int = 0) -> list:
    """The deterministic arm: one partition, one worker thread (or with
    ``procs``, one worker process), autotune and time rotation off,
    ``close()`` after every record is written.  The files rotated by size
    are published and acked; ``close()`` abandons the open one, unacked,
    as the reference does (KPW.java:381-398).  The rotation that the last
    append may trigger races ``close()``, so the last file may or may not
    be published.  Returns the published files' bytes in publish order."""
    from kpw_tpu_torch import FakeBroker

    rows = len(payloads)
    broker = FakeBroker()
    broker.create_topic("det", 1)
    broker.produce_many("det", payloads)
    name = f"det-{'p' if procs else ''}{backend}"
    target = os.path.join(root, name)
    w = stream_builder(broker, "det", target, backend, 1, device, name,
                       deterministic=True, file_size=file_size, procs=procs,
                       rows=rows).build()
    try:
        w.start()
        deadline = time.perf_counter() + 300.0
        while w.total_written_records < rows and time.perf_counter() < deadline:
            time.sleep(0.002)
        check(w.total_written_records >= rows, f"stream {name}: wrote "
              f"{w.total_written_records} of {rows} records")
    finally:
        w.close()
    acked = broker.committed(name, "det", 0)
    reports = published(target, acked, name)
    check(len(reports) >= 2, f"stream {name}: {len(reports)} files published")
    out = []
    for r in reports:
        with open(r.path, "rb") as f:
            out.append(f.read())
    return out


def routes_arm(counters: dict, payloads: list, device: str, root: str,
               small: bool) -> dict:
    """Two tenants through one ``MultiWriter`` (``Builder.route``) on one
    FakeBroker session, every route's writer on the ``"cuda"`` encoder:
    config 1's ``Replay`` records (the stream's) and config 5's ``Order``
    records (32,768; small: 4,096), each topic of 4 partitions, each route
    into its own tree.  Both must drain to every offset committed with
    ack-lag 0, their files verify and the footers sum to the records; the
    routes' workers are threads, so the parent's counters see the pack
    kernel launch.  Returns the launches by kernel and what each route
    did."""
    from kpw_tpu_torch import Builder, FakeBroker, LocalFileSystem

    orders = order_payloads(*order_rows(np.random.default_rng(5),
                                        4_096 if small else NESTED_ROWS))
    topics = {"replay": (replay_class(), payloads), "orders": (order_class(), orders)}
    broker = FakeBroker()
    b = (Builder().broker(broker).filesystem(LocalFileSystem())
         .instance_name("routes").group_id("routes")
         .encoder_backend("cuda", device=device)
         .compression("snappy").batch_ingest(True)
         .max_file_size(4 * 1024 * 1024).block_size(2 * 1024 * 1024)
         .max_file_open_duration_seconds(0.5))
    for topic, (cls, records) in topics.items():
        broker.create_topic(topic, 4)
        broker.produce_many(topic, records)
        b.route(topic, cls, os.path.join(root, "routes", topic))
    for f in counters.values():
        f.launches = 0
    mw = b.build()
    check(type(mw).__name__ == "MultiWriter", "routes: build() made no MultiWriter")
    t0 = time.perf_counter()
    mw.start()
    try:
        deadline = t0 + 300.0
        while time.perf_counter() < deadline and not (
                all(sum(broker.committed("routes", t, p) for p in range(4))
                    >= len(r) for t, (_, r) in topics.items())
                and mw.ack_lag()["unacked_records"] == 0):
            time.sleep(0.002)
        t_drained = time.perf_counter() - t0
        tenants = mw.stats()["tenants"]
    finally:
        mw.close()
    got = {k: f.launches for k, f in counters.items()}
    out = {}
    for topic, (_, records) in topics.items():
        committed = sum(broker.committed("routes", topic, p) for p in range(4))
        check(committed == len(records) and tenants[topic]["ack"]["unacked_records"] == 0,
              f"routes {topic}: committed {committed} of {len(records)}, "
              f"tenant {tenants[topic]}")
        reports = published(os.path.join(root, "routes", topic), len(records),
                            f"routes {topic}")
        out[topic] = (len(records), len(reports), tenants[topic]["state"])
    if device == "cuda":
        check(got["bitpack"] > 0, f"routes: the pack kernel never launched: {got}")
    say(f"[stream routes] 2 routes, one session, cuda on every route: drained in "
        f"{t_drained:.3f} s, ack lag 0; (records, files verified, state) "
        + ", ".join(f"{t} {v}" for t, v in out.items()) + f"; launches {got}")
    return got


def phase_stream(torch, counters: dict, small: bool = False, device: str = "cuda") -> dict:
    """The streaming writer through the port's public API: ``Builder`` →
    ``start()`` → poll → wire shred → append → row groups encoded →
    size/time rotation → durable tmp→final publish → offset ack →
    ``close()``, on BASELINE config 1's records in the shape of the e2e
    probe (bench.py:3769-3990): 400,000 records (small: 20,000, without
    the in-flight-64 arms) on a FakeBroker topic of 4 partitions primed
    before ``start()``.  Each arm of :data:`STREAM_ARMS` and
    :data:`SINK_ARMS` must drain to every offset committed with ack-lag 0,
    every published file must verify and their footers' rows sum to the
    records; a card arm with threads must launch the pack kernel, and each child of a card arm with processes must ship the
    ``encode.launch`` spans of its CudaChunkEncoder (the parent's counters
    see no child's launch).  Then the deterministic arm's files from the
    ``"cuda"``, ``"native"`` and ``"cpu"`` encoders must be
    byte-identical, file for file, with one thread and with one process;
    and the routes arm (:func:`routes_arm`) must drain.  Returns the
    launches of the arms by kernel."""
    import tempfile

    from kpw_tpu_torch import FakeBroker

    rows = STREAM_SMALL if small else STREAM_RECORDS
    parts = 4
    t0 = time.perf_counter()
    payloads = replay_payloads(rows)
    broker = FakeBroker()
    broker.create_topic("e2e", parts)
    broker.produce_many("e2e", payloads)
    say(f"[stream] {rows} records, {sum(map(len, payloads))} bytes on the wire, "
        f"{parts} partitions, primed in {time.perf_counter() - t0:.2f} s; host "
        f"os.cpu_count() {os.cpu_count()}, this process's CPU affinity "
        f"{len(os.sched_getaffinity(0))} CPUs {sorted(os.sched_getaffinity(0))}")
    launches = dict.fromkeys(counters, 0)
    results = {}
    with tempfile.TemporaryDirectory(prefix="kpw_stream_") as root:
        for label, backend, threads, procs, inflight in STREAM_ARMS:
            if small and inflight != 8:
                continue  # the rehearsal: the same path as the bound-8 arm
            for f in counters.values():
                f.launches = 0
            name = label.replace(" ", "")
            r = stream_arm(broker, "e2e", parts, rows, backend, threads, device, root,
                           name, tracing=(label == "cuda x1"
                                          or (procs > 0 and backend == "cuda")),
                           procs=procs, inflight=inflight)
            got = {k: f.launches for k, f in counters.items()}
            if backend == "cuda" and device == "cuda" and not procs:
                check(got["bitpack"] > 0, f"stream {label}: the pack kernel never "
                      f"launched: {got}")
            if backend == "cuda" and procs:
                spans = r["child_launch_spans"]
                check(len(spans) == procs and all(n > 0 for n in spans.values()),
                      f"stream {label}: not every child shipped encode.launch "
                      f"spans: {spans}")
            launches = {k: launches[k] + got[k] for k in counters}
            results[label] = r
            extra = (f"; children's encode.launch spans by pid {r['child_launch_spans']}"
                     if r["child_launch_spans"] else "")
            say(f"[stream {label}] {r['rows_s']:.0f} records/s to all written "
                f"({r['written_s']:.3f} s; first written at {r['first_s']:.3f} s, "
                f"{r['steady_rows_s']:.0f} records/s after it; drained, committed "
                f"{rows} with ack lag 0, "
                f"in {r['drained_s']:.3f} s); {r['files']} files verified, footers "
                f"{rows} rows, {r['rows_per_group']:.0f} rows per row group; "
                f"parent's launches {got}{extra}")
        for label, backend, sink in SINK_ARMS:
            for f in counters.values():
                f.launches = 0
            r = stream_arm(broker, "e2e", parts, rows, backend, 1, device, root,
                           label.replace(" ", ""), sink=sink)
            got = {k: f.launches for k, f in counters.items()}
            if backend == "cuda" and device == "cuda":
                check(got["bitpack"] > 0, f"stream {label}: the pack kernel never "
                      f"launched: {got}")
            launches = {k: launches[k] + got[k] for k in counters}
            results[label] = r
            say(f"[stream {label}] {r['rows_s']:.0f} records/s to all written "
                f"({r['written_s']:.3f} s), cuda x1 {results['cuda x1']['rows_s']:.0f}; "
                f"drained, committed {rows} with ack lag 0, in {r['drained_s']:.3f} s; "
                f"{r['files']} files verified, footers {rows} rows{r['sink']}; "
                f"launches {got}")
        spans = results["cuda x1"]["spans"]
        check(all(k in spans for k in ("consumer.fetch", "worker.shred",
                                       "rowgroup.io_write")),
              f"stream cuda x1: stages missing from the spans: {sorted(spans)}")
        say("[stream cuda x1] spans (SpanRecorder, summed over threads): "
            + ", ".join(f"{k} {t * 1e3:.1f} ms x{n}" for k, (t, n) in spans.items()))
        choice = results["auto x1"]["choice"]
        check(choice is not None and choice.backend in ("cuda", "native"),
              "stream auto x1: the writer made no encoder choice")
        for threads in (1, 4):
            card = results[f"cuda x{threads}"]["rows_s"]
            host = results[f"native x{threads}"]["rows_s"]
            say(f"[stream x{threads}] auto picked {choice.backend} on its first row "
                f"group (cuda {choice.rows_per_s['cuda']:.0f} / native "
                f"{choice.rows_per_s['native']:.0f} rows/s); arms cuda {card:.0f} / "
                f"native {host:.0f} records/s: "
                f"{'cuda' if card > host else 'native'} faster here")
        for backend in ("cuda", "native"):
            for key, what in (("rows_s", "records/s to all written"),
                              ("steady_rows_s", "records/s after the first written"),
                              ("drained_s", "seconds to drained")):
                r = {k[len(backend) + 1:]: v[key] for k, v in results.items()
                     if k.startswith(backend + " ")}
                ratios = [f"{a}/{b} {r[a] / r[b]:.2f}"
                          for tag in ("", " i64") if f"p1{tag}" in r
                          for a, b in ((f"p4{tag}", f"p1{tag}"), (f"p1{tag}", "x1"),
                                       (f"p4{tag}", "x4"))]
                say(f"[stream {backend}] {what}: "
                    + ", ".join(f"{k} {v:.3f}" for k, v in r.items())
                    + "; " + ", ".join(ratios) + f" (os.cpu_count() {os.cpu_count()}, "
                    f"affinity {len(os.sched_getaffinity(0))})")
        if device == "cuda":
            def profiled():
                stream_arm(broker, "e2e", parts, rows, "cuda", 1, device, root,
                           "profiled")
            say("[stream cuda x1] profiled run: " + device_profile(torch, profiled))
        # small: files of 256 KiB, so that the rehearsal publishes several
        size = (256 if small else 4 * 1024) * 1024
        for procs in (0, 1):
            files = {backend: deterministic_files(payloads, backend, device, root,
                                                  size, procs=procs)
                     for backend in ("cuda", "native", "cpu")}
            # file for file over the files every encoder published: only the
            # last size rotation, which races close(), may be missing
            common = min(map(len, files.values()))
            sizes = {k: [len(b) for b in v] for k, v in files.items()}
            how = "1 process" if procs else "1 thread"
            check(common >= 2 and max(map(len, files.values())) - common <= 1
                  and files["cuda"][:common] == files["native"][:common]
                  == files["cpu"][:common],
                  f"stream: the deterministic arm's files ({how}) differ between "
                  f"encoders: {sizes}")
            say(f"[stream deterministic] 1 partition, {how}, autotune and time "
                f"rotation off, no row-group pipeline, polls of 64"
                + (f", ring slots of {DET_SLOT_BYTES} B" if procs else "")
                + ", closed after all written: cuda, native and cpu files "
                f"byte-identical, file for file ({common} files published by size "
                f"by all three; bytes {sizes})")
        got = routes_arm(counters, payloads, device, root, small)
        launches = {k: launches[k] + got[k] for k in counters}
    return launches


# ---------------------------------------------------------------------------

def main() -> None:
    import torch

    check(torch.cuda.is_available(), "CUDA is not available: this smoke run "
          "needs an NVIDIA card")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import kpw_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"cannot import kpw_tpu_torch from {root}: {e}")
    from kpw_tpu_torch.ops.backend import CudaChunkEncoder
    from kpw_tpu_torch.ops.bitpack import pack_pages
    from kpw_tpu_torch.ops.delta import delta_page_streams
    from kpw_tpu_torch.ops.rank import hist_dict, rank_pages
    from kpw_tpu_torch.runtime.select import probe_link

    counters = {"bitpack": pack_pages, "hist": hist_dict, "rank": rank_pages,
                "delta": delta_page_streams}

    def drive(path: str, needs: tuple, fn, *args):
        """Run one main path with every launch count set to 0 just before it
        and read just after; fail if a kernel of the path never launched."""
        for f in counters.values():
            f.launches = 0
        out = fn(*args)
        got = {k: f.launches for k, f in counters.items()}
        say(f"[{path}] launches: {got}")
        check(all(got[k] > 0 for k in needs),
              f"{path}: a kernel of the path never launched: {got}")
        return out, got

    t_start = time.perf_counter()

    def elapsed(what: str) -> None:
        say(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s")

    card = phase_card(torch)
    native_build = start_native_build()
    phase_build()
    phase_native(*native_build)
    timer = Timer(torch)
    recs = phase_kernels(torch, timer)
    elapsed("build, native, kernels")
    cases, launches = drive("flagship", ("bitpack", "hist", "rank"),
                            flagship_path, torch)
    link = probe_link()
    say(f"[select] link: pinned host-to-device {link['h2d_mbps']:.0f} MB/s, launch "
        f"round trip {link['launch_ms']:.3f} ms; \"auto\" times each writer's first "
        "row group through both encoders (beside each path: its first row group, "
        "outside the counted runs)")
    needs = {"writer": ("bitpack",), "levels": ("bitpack",), "nested": ("bitpack",),
             "encodings": ("delta",), "strings": ("bitpack",), "cfg3": ("delta",)}
    inputs, delta_shapes = {}, {}
    for name, setup in SETUPS.items():
        inputs[name] = setup()
        # one small run first, so that the measured one pays no one-time
        # set-up (allocator growth, library loads); it counts no launch
        write_batches(CudaChunkEncoder(inputs[name][2].encoder_options()),
                      *setup(small=True))
        (calls, recorded, rates), got = drive(name, needs[name], writer_path, name,
                                              *inputs[name])
        choice = auto_choice(*inputs[name])  # after the path's counts
        faster = "cuda" if rates["card"] > rates["native"] else "native"
        say(f"[{name}] auto picks {choice.backend} (first row group cuda "
            f"{choice.rows_per_s['cuda']:.0f} / native "
            f"{choice.rows_per_s['native']:.0f} rows/s); CudaChunkEncoder "
            f"{rates['card']:.0f} / NativeChunkEncoder {rates['native']:.0f} rows/s: "
            f"{faster} faster here")
        # the path's kernels replayed on its own inputs, after its launches
        # were read
        for kernel, e in check_path_inputs(torch, name, recorded).items():
            recs[kernel]["max_abs_err"] = max(recs[kernel]["max_abs_err"], e)
        if name in DELTA_RINGS:
            # one launch per ring with pages a row group, for both card files
            want = DELTA_RINGS[name] * 2 * len(inputs[name][0])
            check(got["delta"] == want, f"{name}: {got['delta']} delta launches, "
                  f"not {want} (one per ring a row group, two card files)")
            # its first row group's 64-bit ring launch, to time the kernel at
            delta_shapes[name] = next(args for args, _ in recorded["delta_page_streams"]
                                      if args[2] == 64)
        del recorded
        if name == "writer":  # the fused pack: one launch a job, no padded copy
            check(got["bitpack"] == calls["pack_pages_multi"]
                  and calls["_pad_rows"] == 0,
                  f"writer: {got['bitpack']} pack launches for "
                  f"{calls['pack_pages_multi']} jobs, {calls['_pad_rows']} "
                  "padded index copies")
        launches = {k: launches[k] + got[k] for k in counters}
    elapsed("flagship, writers")
    got = phase_stream(torch, counters)
    launches = {k: launches[k] + got[k] for k in counters}
    elapsed("stream")
    mesh, got = drive("mesh", ("bitpack", "hist", "rank"), mesh_path, torch, counters)
    launches = {k: launches[k] + got[k] for k in counters}
    elapsed("mesh")
    say(f"[main path] launches: {launches}")
    for kernel, e in check_mesh_inputs(torch, mesh["recorded"]).items():
        recs[kernel]["max_abs_err"] = max(recs[kernel]["max_abs_err"], e)

    # timing and profiles after the counted runs, so they count no launch
    recs["delta"] = delta_record(torch, timer, recs["delta"]["max_abs_err"],
                                 delta_shapes)
    summarize("delta", recs["delta"])
    del delta_shapes
    flagship_timing(torch, timer, cases)
    taxi, schema, props = inputs["writer"]
    dictionary_routes(torch, timer, taxi[0])
    taxi_pack_jobs(torch, timer, schema, props, taxi[0])
    for name, (groups, schema, props) in inputs.items():
        group_breakdown(torch, name, groups[0], schema, props)
    string_probe(torch, inputs)
    mesh_timing(torch, timer, mesh)
    del mesh
    elapsed("timing")

    out = []
    for name, r in recs.items():
        out.append({k: r[k] for k in ("name", "route", "source", "replaces")}
                   | {"launches": launches[name],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    say(json.dumps({"kernels": out}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
