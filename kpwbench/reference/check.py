"""The comparison that decides ``correct``.

The published files are read back by the plain reader (``parquet.py``), and
the committed records are recomputed from the seed, each partition's
committed offset and the generator's pool: offsets ``[0, committed[p])`` of
partition ``p`` must all be in the files, and every row in the files must
be a record that was produced (at-least-once allows a record twice, never a
record that was not produced).  Rows and records are compared as
multisets: each is reduced to a 64-bit key that sums a mixed hash of each
of its values, column by column (two different records share a key with a
chance of about 2**-64).

A configuration may name ``key_columns``: then every file is read in those
columns only and the multisets are compared on them, and the files of a
sample drawn from the seed, ``sample_rows`` rows or more and the largest
file among them, are read in every column, each of their rows compared
with the pool.  This keeps read-back to seconds where a codec makes every
column slow to read in plain Python.
"""

from __future__ import annotations

import hashlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import parquet as pq

LIMITS = {"unreadable_files": 0, "missing_records": 0, "foreign_rows": 0,
          "foreign_sampled_rows": 0}
_M1, _M2 = np.uint64(0xBF58476D1CE4E5B9), np.uint64(0x94D049BB133111EB)


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer on uint64 values."""
    x = x ^ (x >> np.uint64(30))
    x = x * _M1
    x = x ^ (x >> np.uint64(27))
    x = x * _M2
    return x ^ (x >> np.uint64(31))


def _salt(column: int) -> np.uint64:
    return np.uint64((0x9E3779B97F4A7C15 * (column + 1)) & (2**64 - 1))


def _bits(values) -> np.ndarray:
    """Each value's identity as a uint64: integers as int64, doubles by
    their bit pattern, strings by an 8-byte BLAKE2b digest."""
    if isinstance(values, list):
        return np.array([int.from_bytes(hashlib.blake2b(v, digest_size=8).digest(),
                                        "little") for v in values], np.uint64)
    if values.dtype == np.float64:
        return values.view(np.uint64)
    return values.astype(np.int64).view(np.uint64)


def value_hash(column: int, values) -> np.ndarray:
    return _mix(_bits(values) + _salt(column))


def pool_keys(pool, names: list) -> np.ndarray:
    """The key of every pool record over the columns ``names``."""
    order = [f["name"] for f in pool.schema]
    key = np.zeros(pool.n, np.uint64)
    for name in names:
        c = order.index(name)
        v = pool.cols[name]
        if name + ".dict" in pool.cols:
            key += value_hash(c, pool.cols[name + ".dict"])[v]
        else:
            key += value_hash(c, v)
    return key


def file_keys(pf: pq.ParquetFile, names: list, order: list) -> np.ndarray:
    """The key of every row of a file over the columns ``names``."""
    out = []
    for rows, cols in pf.row_groups:
        key = np.zeros(rows, np.uint64)
        by_name = {c.name: c for c in cols}
        for name in names:
            if name not in by_name:
                raise pq.ParquetError(f"{pf.path}: no column {name}")
            dictionary, v = pf.column(by_name[name], rows, indices=True)
            c = order.index(name)
            key += (value_hash(c, dictionary)[v] if dictionary is not None
                    else value_hash(c, v))
        out.append(key)
    return np.concatenate(out) if out else np.zeros(0, np.uint64)


def _observe(uniq: np.ndarray, keys: np.ndarray) -> tuple:
    """Rows per class, and the rows whose key is no class."""
    at = np.searchsorted(uniq, keys)
    at = np.minimum(at, len(uniq) - 1)
    hit = uniq[at] == keys
    counts = np.bincount(at[hit], minlength=len(uniq))
    return counts, int((~hit).sum())


def compare(paths: list, pool, committed: list, produced: list, config: dict,
            seed: int, threads: int = 8) -> dict:
    """Read the published files ``paths`` back and compare them with the
    records committed (``committed[p]``, the next offset of partition
    ``p``) and produced (``produced[p]``).  Returns each number compared;
    every one must be at most its limit in ``LIMITS``."""
    order = [f["name"] for f in pool.schema]
    check = config.get("check", {})
    key_names = check.get("key_columns") or order
    sampled = key_names != order

    def read(path):
        try:
            pf = pq.read_footer(path)
            if pf.names != order:
                raise pq.ParquetError(f"{path}: columns {pf.names}")
            return pf.num_rows, file_keys(pf, key_names, order)
        except (pq.ParquetError, IndexError, KeyError, ValueError, OSError):
            return None

    with ThreadPoolExecutor(threads) as ex:
        results = list(ex.map(read, paths))
    unreadable = sum(r is None for r in results)
    good = [(p, r) for p, r in zip(paths, results) if r is not None]
    rows = np.concatenate([r[1] for _, r in good]) if good else np.zeros(0, np.uint64)

    # distinct keys of the pool, sorted, and each pool record's class
    uniq, cls = np.unique(pool_keys(pool, key_names), return_inverse=True)

    def per_class(counts):
        return np.rint(np.bincount(cls, weights=counts, minlength=len(uniq))).astype(np.int64)

    expected, allowed = per_class(pool.counts(committed)), per_class(pool.counts(produced))
    observed, unknown = _observe(uniq, rows)
    out = {
        "unreadable_files": unreadable,
        "missing_records": int(np.maximum(expected - observed, 0).sum()),
        "foreign_rows": unknown + int(np.maximum(observed - allowed, 0).sum()),
        "foreign_sampled_rows": 0,
    }
    if sampled and good:
        out["foreign_sampled_rows"] = _sample(good, pool, order, seed,
                                              check.get("sample_rows", 0), threads)
    out["rows_read"] = int(len(rows))
    return out


def _sample(good: list, pool, order: list, seed: int, want: int, threads: int) -> int:
    """Rows of a seed-drawn sample of files, the largest file among them,
    that are no pool record in all their columns."""
    rng = np.random.default_rng(seed)
    sizes = [r[0] for _, r in good]
    picks, total = [int(np.argmax(sizes))], max(sizes)
    for i in rng.permutation(len(good)).tolist():
        if total >= want:
            break
        if i != picks[0]:
            picks.append(i)
            total += sizes[i]
    full = np.unique(pool_keys(pool, order))

    def foreign(i):
        try:
            keys = file_keys(pq.read_footer(good[i][0]), order, order)
        except (pq.ParquetError, IndexError, KeyError, ValueError, OSError):
            return sizes[i]
        return _observe(full, keys)[1]

    with ThreadPoolExecutor(threads) as ex:
        return int(sum(ex.map(foreign, picks)))
