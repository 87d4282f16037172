"""Dictionary build on device, in ascending bit-pattern order.

The port of ``kpw_tpu/ops/dictionary.py``.  A row group's same-width
columns stack into one (C, N) batch and build together:

- the sort route: one stable sort per column of its 64-bit-ordered key
  (invalid rows lifted past every valid key) makes equal values adjacent;
  new-value flags and their running count give each row its dictionary
  index, because ascending order is the canonical dictionary order
  (``core.encodings.dictionary_build`` is the byte-identical oracle);
  scatters put the indices back in row order and the uniques at the front;
- the bins route, for non-negative integer columns whose (value - min) /
  stride offsets span less than ``RANGE_MAX``: a presence table and its
  prefix sum replace the sort.

Keys are the values' bit patterns: 32-bit ones as unsigned values in int64,
64-bit ones with the sign bit flipped so that signed int64 order is their
unsigned order.  Float uniqueness is therefore bitwise.  The build runs on
the device passed in; on a card everything here is plain PyTorch (the
dictionary build had no TPU kernel of its own), and the bit-pack of the
indices that follows is the CUDA kernel (``ops.packing``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import to_device, to_host
from .packing import pad_bucket

_SIGN = -(1 << 63)  # XOR with the sign bit: unsigned 64-bit order -> signed
_PAD64 = (1 << 63) - 1  # sorts after every flipped 64-bit key (ties: stability)
_PAD32 = 1 << 32  # sorts after every 32-bit key


def _u32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & 0xFFFFFFFF


def _dict_build_batch(hi: torch.Tensor, lo: torch.Tensor, counts: torch.Tensor,
                      wide: bool):
    """Batched build over columns: ``hi``/``lo`` (C, N) int32 halves of each
    value's bit pattern (``hi`` read only when ``wide``), ``counts`` (C,)
    valid prefix lengths.  Returns (dkey (C, N) int64, indices (C, N)
    int32, k (C,) int32): ``dkey[c, :k[c]]`` are column c's ascending
    unique keys (32-bit values, or flipped 64-bit patterns when ``wide``,
    see :func:`unflip`), ``indices[c, :counts[c]]`` its rows' dictionary
    indices.  Entries past ``k`` / ``counts`` are unspecified."""
    C, n = lo.shape
    dev = lo.device
    valid = torch.arange(n, device=dev)[None, :] < counts.to(dev)[:, None]
    if wide:
        key = ((_u32(hi) << 32) | _u32(lo)) ^ _SIGN
        pad = _PAD64
    else:
        key = _u32(lo)
        pad = _PAD32
    # stable: a valid all-ones 64-bit key ties with the pads, and only
    # stability keeps it (an earlier position) ahead of them, so that the
    # first counts[c] sorted slots are exactly the valid rows
    skey, spos = torch.sort(torch.where(valid, key, pad), dim=1, stable=True)
    same = torch.cat([torch.zeros((C, 1), dtype=torch.bool, device=dev),
                      skey[:, 1:] == skey[:, :-1]], dim=1)
    is_new = valid & ~same
    uid = torch.cumsum(is_new, 1, dtype=torch.int32) - 1
    k = is_new.sum(1, dtype=torch.int32)
    indices = torch.zeros_like(uid).scatter_(1, spos, uid)
    slot = torch.where(is_new, uid, n).to(torch.int64)
    dkey = skey.new_zeros((C, n + 1)).scatter_(1, slot, skey)[:, :n]
    return dkey, indices, k


def _dict_build_bins_batch(ids: torch.Tensor, counts: torch.Tensor, R: int):
    """Sort-free build for bounded offsets: ``ids`` (C, N) int32 offsets
    ``< R`` (value - base) / stride, ``counts`` (C,).  A presence scatter and
    its prefix sum replace the sort; ascending order falls out of the bin
    layout.  Returns (dkey (C, R) int64 offsets, indices (C, N) int32,
    k (C,) int32)."""
    C, n = ids.shape
    dev = ids.device
    valid = torch.arange(n, device=dev)[None, :] < counts.to(dev)[:, None]
    safe = torch.where(valid, _u32(ids), R)
    present = torch.zeros((C, R + 1), dtype=torch.int32, device=dev)
    present = present.scatter_(1, safe, 1)[:, :R]
    kpre = torch.cumsum(present, 1, dtype=torch.int32)
    indices = kpre.gather(1, safe.clamp(0, R - 1)) - 1
    k = kpre[:, R - 1].contiguous()
    slot = torch.where(present > 0, kpre - 1, R).to(torch.int64)
    offsets = torch.arange(R, device=dev).expand(C, R)
    dkey = offsets.new_zeros((C, R + 1)).scatter_(1, slot, offsets)[:, :R]
    return dkey, indices, k


def unflip(keys: np.ndarray) -> np.ndarray:
    """Flipped 64-bit keys (int64) back to their uint64 bit patterns."""
    return keys.view(np.uint64) ^ np.uint64(1 << 63)


def split_keys(arr: np.ndarray) -> tuple[np.ndarray | None, np.ndarray]:
    """Bit-pattern (hi, lo) uint32 keys for a fixed-width column; hi is None
    for 32-bit types."""
    if arr.dtype.itemsize == 4:
        return None, arr.view(np.uint32)
    u = arr.view(np.uint64)
    return (u >> np.uint64(32)).astype(np.uint32), (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A uint32 host array to ``device`` as int32 bit patterns."""
    return to_device(a.view(np.int32), device)


def _affine_offsets(arr: np.ndarray, base: int, stride: int) -> np.ndarray:
    off = np.ascontiguousarray(arr).astype(np.uint64) - np.uint64(base)
    if stride != 1:
        off //= np.uint64(stride)
    return off.astype(np.uint32)


class BatchDictBuild:
    """One launched dictionary build covering several same-width columns.

    ``columns`` is a list of np arrays of identical length, packed into one
    (C, bucket) batch on ``device`` and built together.  ``result(i)``
    syncs (once for the whole batch) and returns column i's (dict_values,
    device_indices_row) in CPU-oracle (ascending) order."""

    def __init__(self, columns: list[np.ndarray], wide: bool, device="cuda"):
        self.dtypes = [c.dtype for c in columns]
        self.wide = wide
        C = len(columns)
        n = len(columns[0])
        self.n = n
        bucket = pad_bucket(n)
        self.bucket = bucket
        lo_p = np.zeros((C, bucket), np.uint32)
        hi_p = np.zeros((C, bucket), np.uint32) if self.wide else lo_p
        for c, arr in enumerate(columns):
            hi, lo = split_keys(np.ascontiguousarray(arr))
            lo_p[c, :n] = lo
            if self.wide:
                hi_p[c, :n] = hi
        lo_d = _upload(lo_p, device)
        hi_d = _upload(hi_p, device) if self.wide else lo_d
        counts = torch.full((C,), n, dtype=torch.int32, device=lo_d.device)
        self.dkey, self.indices, self._k = _dict_build_batch(
            hi_d, lo_d, counts, self.wide)
        self._k_host: np.ndarray | None = None
        self._keys_host: np.ndarray | None = None

    def unique_counts(self) -> np.ndarray:
        """Per-column unique counts; the first call syncs the batch."""
        if self._k_host is None:
            (self._k_host,) = to_host([self._k])
        return self._k_host

    def _key_table(self) -> np.ndarray:
        if self._keys_host is None:
            kmax = int(self.unique_counts().max()) if len(self.dtypes) else 0
            (self._keys_host,) = to_host([self.key_tables_device(
                pad_bucket(max(kmax, 1)))])
        return self._keys_host

    def result(self, i: int) -> tuple[np.ndarray, torch.Tensor]:
        k = int(self.unique_counts()[i])
        return self.values_from_tables(i, k, self._key_table()), self.indices[i]

    # -- sync-free accessors for the row-group planner ---------------------
    def counts_device(self) -> torch.Tensor:
        return self._k

    def key_tables_device(self, cap: int) -> torch.Tensor:
        """The first ``cap`` compacted keys of every column, still on the
        device, for the planner's one bulk readback."""
        return self.dkey[:, :min(cap, self.bucket)]

    def values_from_tables(self, i: int, k: int, tables: np.ndarray) -> np.ndarray:
        keys = tables[i, :k]
        if self.wide:
            return unflip(keys).view(self.dtypes[i])
        return keys.astype(np.uint32).view(self.dtypes[i])


class BinDictBuild:
    """Bounded-range batch: the sort-free bins build (see
    :func:`_dict_build_bins_batch`).  ``bases`` holds per-column (base,
    stride) affine transforms, valid only for non-negative integer columns
    whose ``(max - base) / stride < R`` with stride dividing every
    ``value - base`` — then ascending offset order equals ascending
    bit-pattern order and the output matches the CPU oracle exactly.
    Uploads 4 bytes a row whatever the column's width (offsets, not
    values)."""

    def __init__(self, columns: list[np.ndarray],
                 bases: list[tuple[int, int]], R: int, device="cuda"):
        self.dtypes = [c.dtype for c in columns]
        self.bases = bases
        self.R = R
        C = len(columns)
        n = len(columns[0])
        self.n = n
        bucket = pad_bucket(n)
        self.bucket = bucket
        ids = np.zeros((C, bucket), np.uint32)
        for c, arr in enumerate(columns):
            ids[c, :n] = _affine_offsets(arr, *bases[c])
        ids_d = _upload(ids, device)
        counts = torch.full((C,), n, dtype=torch.int32, device=ids_d.device)
        self.dkey, self.indices, self._k = _dict_build_bins_batch(ids_d, counts, R)
        self._k_host: np.ndarray | None = None
        self._dkey_host: np.ndarray | None = None

    def unique_counts(self) -> np.ndarray:
        if self._k_host is None:
            (self._k_host,) = to_host([self._k])
        return self._k_host

    def _key_table(self) -> np.ndarray:
        if self._dkey_host is None:
            kmax = int(self.unique_counts().max()) if len(self.dtypes) else 0
            (self._dkey_host,) = to_host([self.key_tables_device(
                pad_bucket(max(kmax, 1)))])
        return self._dkey_host

    def result(self, i: int) -> tuple[np.ndarray, torch.Tensor]:
        k = int(self.unique_counts()[i])
        return self.values_from_tables(i, k, self._key_table()), self.indices[i]

    # -- sync-free accessors for the row-group planner ---------------------
    def counts_device(self) -> torch.Tensor:
        return self._k

    def key_tables_device(self, cap: int) -> torch.Tensor:
        return self.dkey[:, :min(cap, self.R)]

    def values_from_tables(self, i: int, k: int, tables: np.ndarray) -> np.ndarray:
        base, stride = self.bases[i]
        offsets = tables[i, :k].astype(np.uint64)
        return (offsets * np.uint64(stride)
                + np.uint64(base)).astype(self.dtypes[i])


RANGE_MAX = 1 << 20  # largest bin table the sort-free path will allocate


def _int_stats(arr: np.ndarray):
    """(vmin, vmax, None): numpy min/max, the gcd left to the lazy
    sample-rejecting :func:`_gcd_stride` pass (None marks it
    not-yet-computed)."""
    return int(arr.min()), int(arr.max()), None


def _gcd_stride(arr: np.ndarray, vmin: int, span: int, limit: int):
    """Quantization stride for the bins build: g = gcd of
    (arr - vmin), engaged when the raw span misses ``limit`` but span // g
    fits — quantized columns (currency cents on a fixed tick, timestamps
    at a coarser granularity than their unit) are common and their offsets
    compress to span/g dictionary slots.  A cheap sound rejector runs
    first: the gcd over ALL offsets divides the gcd over any subset, so a
    sample gcd of 1 (or one too small to close the gap) disproves
    eligibility without the full pass.  Returns g > 1, or None."""
    if span <= 0:
        return None
    t = arr.dtype.type
    g = int(np.gcd.reduce(arr[:1024] - t(vmin)))
    # an all-constant prefix gives sample gcd 0 (everything divides 0):
    # that is inconclusive, not a rejection — only a nonzero sample gcd
    # that is 1 or too small to close the gap disproves eligibility
    if g != 0 and (g <= 1 or span // g >= limit):
        return None
    g = int(np.gcd.reduce(arr - t(vmin)))
    return g if g > 1 and span // g < limit else None


def affine_stride(arr: np.ndarray, vmin: int, span: int, g_all, limit: int):
    """Eligibility of the bins build: 1 when the raw span fits
    ``limit``; the gcd stride g > 1 when ``span // g`` fits (``g_all`` when
    the caller already knows the full gcd, else the lazy
    :func:`_gcd_stride`); None when ineligible."""
    if span < limit:
        return 1
    if g_all is not None:
        return g_all if g_all > 1 and span // g_all < limit else None
    return _gcd_stride(arr, vmin, span, limit)


def build_dictionaries(columns: list[np.ndarray], device="cuda"):
    """Launch dictionary builds for a row group's columns on ``device``,
    batching columns that can share one build.  Returns one handle per
    column, a (batch, j) pair with ``batch.unique_counts()[j]`` /
    ``batch.result(j)`` semantics.

    Mode selection per column (the output is the same on every route):
    non-negative ints whose (max - min) offsets — or, failing that,
    (max - min) / gcd — span less than ``RANGE_MAX`` take the bins build,
    grouped by bin-table bucket; everything else sorts its raw keys,
    grouped by key width.
    Every batch stacks columns of the same exact length (nullable columns
    with different null counts land in different batches)."""
    groups: dict = {}
    metas: list = [None] * len(columns)
    for i, arr in enumerate(columns):
        mode = None
        if arr.dtype.kind in "iu" and len(arr):
            vmin, vmax, g_all = _int_stats(arr)
            span = vmax - vmin
            g = affine_stride(arr, vmin, span, g_all, RANGE_MAX) if vmin >= 0 else None
            if g:
                mode = ("bins", len(arr), pad_bucket(span // g + 1))
                metas[i] = (vmin, g)
        if mode is None:
            mode = ("sort", len(arr), arr.dtype.itemsize == 8)
        groups.setdefault(mode, []).append(i)
    handles: list = [None] * len(columns)
    for mode, idxs in groups.items():
        cols = [columns[i] for i in idxs]
        if mode[0] == "bins":
            batch = BinDictBuild(cols, [metas[i] for i in idxs], mode[2], device)
        else:
            batch = BatchDictBuild(cols, wide=mode[2], device=device)
        for j, i in enumerate(idxs):
            handles[i] = (batch, j)
    return handles


class DictBuildHandle:
    """Single-column convenience wrapper over :func:`build_dictionaries`."""

    def __init__(self, values: np.ndarray, device="cuda"):
        self.values = values
        self.n = len(values)
        self._batch, self._j = build_dictionaries([values], device)[0]

    def result(self) -> tuple[np.ndarray, torch.Tensor]:
        """Sync on the unique count and return (dict_values, device
        indices); dict_values is in ascending bit-pattern order, matching
        the CPU oracle."""
        return self._batch.result(self._j)
