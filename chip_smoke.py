#!/usr/bin/env python3
"""Smoke run of kpw_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero before the result lines:

1. card  — the card's name and power limit (nvidia-smi) and PyTorch's name;
2. build — compile the port's CUDA kernels from ``kpw_tpu_torch/csrc``;
3. kernels — every kernel against its plain PyTorch version on the card,
   element for element (the fused pack on unaligned, ragged, past-the-end
   windows at every width; the hist + dictionary kernel on columns with
   few distinct values, ragged counts and dictionaries narrower and wider
   than its table), then each timed at the flagship shape with CUDA events
   (median of 25 runs, L2 flushed before each) beside its plain version,
   the PyTorch library call that computes the same function, and its
   memory bound, the hist kernel on both bounded distributions; the
   unfused routes (tensor ops around a kernel) against the fused kernels,
   in turns;
4. flagship — ``entry()`` and ``encode_step_single`` at 64 x 65,536 on the
   sort route and both bounded routes, each run once and equal to the same
   step run on the CPU (plain versions);
5. writer — a taxi-shaped 64-column table, 1,048,576 rows in four row
   groups, through ``ParquetFileWriter`` + ``CudaChunkEncoder``, row group
   by row group and through the writer's pipeline; both files must equal,
   byte for byte, the one the port's ``CpuChunkEncoder`` writes;
6. timing — each flagship route's step time and device profile (device
   ops per step), the dictionary build's two routes on one row group's
   columns, one row group's pack jobs through the fused kernel and the
   unfused route in turns, and one writer row group's stage spans and device
   profile.

Phases 4 and 5 are the main paths: every launch count is set to 0 just
before each and read just after, and a kernel of the path that never
launched fails the run; the ``launches`` reported are their sum.  The
writer must make exactly one pack launch a job and no padded index copy.  The line
before the last is one JSON object with a record per kernel; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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

    def ms(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
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
            got_p, got_l = bitpack.pack_pages(idx, tab, bucket, width, True, cnt)
            want_p, want_l = bitpack.pack_pages_plain(idx, tab, bucket, width, True, cnt)
            e = max(max_abs_err(torch, got_p, want_p),
                    max_abs_err(torch, got_l, want_l))
            check(e == 0, f"fused pack width {width} count {cnt}: max err {e}")
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
    say(f"[kernels] fused pack == plain (packed bytes and long_sum) on 32 "
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


def abba(timer: Timer, a, b) -> tuple[float, float, list]:
    """Time a and b in turns (a b b a); returns their means and all four."""
    t = [timer.ms(a), timer.ms(b), timer.ms(b), timer.ms(a)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


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
           "rank": check_rank(torch, rng)}

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
        r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        r["bound_by"] = "bytes"
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        say(f"[kernels] {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bytes']} bytes), "
            f"{r['ms'] / r['bound_ms']:.2f}x the bound")

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


def taxi_setup():
    """The taxi table (four 262,144-row groups), its schema and the writer's
    default properties (UNCOMPRESSED, 1 MiB pages, 128 MiB row groups)."""
    from kpw_tpu_torch.core import Schema, WriterProperties, leaf

    groups = [make_taxi_like(TAXI_ROWS, seed=g) for g in range(TAXI_GROUPS)]
    types = {"int64": "int64", "int32": "int32", "float64": "double"}
    schema = Schema([leaf(n, types[str(v.dtype)]) for n, v in groups[0].items()])
    return groups, schema, WriterProperties()


def writer_warmup(groups, schema, props) -> None:
    """One small row group through the card encoder, so that the measured
    run pays no one-time set-up (allocator growth, library loads)."""
    from kpw_tpu_torch.core import ParquetFileWriter, columns_from_arrays
    from kpw_tpu_torch.ops.backend import CudaChunkEncoder

    w = ParquetFileWriter(io.BytesIO(), schema, props,
                          encoder=CudaChunkEncoder(props.encoder_options()))
    w.write_batch(columns_from_arrays(
        schema, {k: v[:8192] for k, v in groups[0].items()}))
    w.close()


def writer_path(torch, groups, schema, props) -> None:
    """The taxi table through ``ParquetFileWriter`` + ``CudaChunkEncoder``,
    one row group per batch, written twice: row group by row group, and
    through the writer's pipeline, whose dispatch thread runs
    ``launch_many`` while its assembly thread runs ``assemble_many`` of the
    row group before.  Both files must equal, byte for byte, the one the
    port's ``CpuChunkEncoder`` writes."""
    from kpw_tpu_torch.core import ParquetFileWriter, columns_from_arrays
    from kpw_tpu_torch.core.pages import CpuChunkEncoder
    from kpw_tpu_torch.ops import backend, packing
    from kpw_tpu_torch.ops.backend import CudaChunkEncoder

    calls = {"jobs": 0, "pad_rows": 0}
    multi, pad_rows = backend.pack_pages_multi, packing._pad_rows

    def counted_multi(*args):
        calls["jobs"] += 1
        return multi(*args)

    def counted_pad_rows(*args):
        calls["pad_rows"] += 1
        return pad_rows(*args)

    def write(encoder, pipeline: bool = False):
        buf = io.BytesIO()
        # pipelined: every batch crosses row_group_size, so each is handed
        # to the pipeline as its own row group, as the sequential run cuts
        p = dataclasses.replace(props, row_group_size=1) if pipeline else props
        t0 = time.perf_counter()
        w = ParquetFileWriter(buf, schema, p, encoder=encoder, pipeline=pipeline)
        for arrays in groups:
            w.write_batch(columns_from_arrays(schema, arrays))
            if pipeline:
                w.maybe_flush_row_group()
            else:
                w.flush_row_group()
        w.close()
        if isinstance(encoder, CudaChunkEncoder):
            torch.cuda.synchronize()
        return buf.getvalue(), time.perf_counter() - t0, w.stage_busy_s

    rows = TAXI_ROWS * TAXI_GROUPS
    backend.pack_pages_multi, packing._pad_rows = counted_multi, counted_pad_rows
    try:
        got, t_cuda, _ = write(CudaChunkEncoder(props.encoder_options()))
        piped, t_pipe, busy = write(CudaChunkEncoder(props.encoder_options()),
                                    pipeline=True)
    finally:
        backend.pack_pages_multi, packing._pad_rows = multi, pad_rows
    want, t_cpu, _ = write(CpuChunkEncoder(props.encoder_options()))
    check(got == want, f"writer: CudaChunkEncoder file ({len(got)} bytes) != "
          f"CpuChunkEncoder file ({len(want)} bytes)")
    check(piped == want, f"writer: pipelined CudaChunkEncoder file "
          f"({len(piped)} bytes) != CpuChunkEncoder file ({len(want)} bytes)")
    check(busy["assemble"] > 0, "writer: the pipeline ran no assembly thread")
    say(f"[writer] {TAXI_COLS} cols x {rows} rows in {TAXI_GROUPS} row groups, "
        f"{len(got)} bytes, byte-identical; CudaChunkEncoder {t_cuda:.3f} s "
        f"({rows / t_cuda:.0f} rows/s), pipelined {t_pipe:.3f} s "
        f"({rows / t_pipe:.0f} rows/s; stage busy s "
        + ", ".join(f"{k} {v:.3f}" for k, v in busy.items())
        + f"), CpuChunkEncoder {t_cpu:.3f} s ({rows / t_cpu:.0f} rows/s)")
    say(f"[writer] pack jobs {calls['jobs']}, padded index copies "
        f"{calls['pad_rows']}")
    return calls


def device_profile(torch, fn) -> str:
    """Run ``fn`` once under the PyTorch profiler and describe where the
    card's time went: the device's busy time (the union of the CUDA kernel,
    copy and memset intervals the profiler recorded, annotations excluded),
    its share of the call's wall time (host clock, ending in a
    synchronize), the number of those device ops, and the top device ops by
    summed time."""
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
    return (f"wall {wall * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
            f"({100 * busy_us / (wall * 1e6):.1f}%), device ops {len(evs)}; "
            "top device ops: "
            + "; ".join(f"{name[:44]} {t / 1e3:.3f} ms x{n}"
                        for name, (t, n) in top))


def dictionary_routes(torch, timer: Timer, arrays: dict) -> None:
    """The dictionary build's two routes on the card, on the same inputs:
    one taxi row group's 16 quantized-fare columns as the affine offsets the
    writer builds them from, through the bins build (the writer's route for
    them) and the sort build.  Both must agree; device time only (CUDA
    events), the offsets uploaded once."""
    from kpw_tpu_torch.ops import dictionary as D

    cols = [v for k, v in arrays.items() if int(k[1:]) % 4 == 2]
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


def taxi_pack_jobs(torch, timer: Timer, schema, props, arrays) -> None:
    """One taxi row group's pack jobs, recorded as the encoder makes them,
    then replayed on the card: the fused kernel (one launch a job) against
    the unfused route, in turns, both equal; CUDA-event time of the four jobs
    together and one profiled pass of each (device busy, device ops)."""
    from kpw_tpu_torch.core import ParquetFileWriter, columns_from_arrays
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
        w.write_batch(columns_from_arrays(schema, arrays))
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


def writer_breakdown(torch, schema, props, arrays) -> None:
    """Where one CudaChunkEncoder row group's time goes: the encoder's stage
    spans (host clock) and the device profile."""
    from kpw_tpu_torch.core import ParquetFileWriter, columns_from_arrays
    from kpw_tpu_torch.ops.backend import CudaChunkEncoder
    from kpw_tpu_torch.utils.tracing import StageTimer, set_tracer

    batch = columns_from_arrays(schema, arrays)
    timer = StageTimer()

    def one_group():
        w = ParquetFileWriter(io.BytesIO(), schema, props,
                              encoder=CudaChunkEncoder(props.encoder_options()))
        w.write_batch(batch)
        w.flush_row_group()

    set_tracer(timer)
    try:
        prof = device_profile(torch, one_group)
    finally:
        set_tracer(None)
    stages = {k: round(v["seconds"] * 1e3, 3) for k, v in timer.summary().items()}
    say(f"[writer] one row group, profiled: stage ms {stages}; {prof}")


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
    from kpw_tpu_torch.ops.bitpack import pack_pages
    from kpw_tpu_torch.ops.rank import hist_dict, rank_pages

    counters = {"bitpack": pack_pages, "hist": hist_dict, "rank": rank_pages}

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

    card = phase_card(torch)
    phase_build()
    timer = Timer(torch)
    recs = phase_kernels(torch, timer)
    groups, schema, props = taxi_setup()
    writer_warmup(groups, schema, props)

    cases, flag = drive("flagship", ("bitpack", "hist", "rank"),
                        flagship_path, torch)
    calls, writ = drive("writer", ("bitpack",), writer_path,
                        torch, groups, schema, props)
    check(writ["bitpack"] == calls["jobs"] and calls["pad_rows"] == 0,
          f"writer: {writ['bitpack']} pack launches for {calls['jobs']} jobs, "
          f"{calls['pad_rows']} padded index copies")
    launches = {k: flag[k] + writ[k] for k in counters}
    say(f"[main path] launches: {launches}")

    # timing and profiles after the counted runs, so they count no launch
    flagship_timing(torch, timer, cases)
    dictionary_routes(torch, timer, groups[0])
    taxi_pack_jobs(torch, timer, schema, props, groups[0])
    writer_breakdown(torch, schema, props, groups[0])

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
