"""Device-side BYTE_ARRAY dictionary build (the string probe).

The port of ``kpw_tpu/ops/strings.py``.  Strings are the one dictionary
family the encoder builds on the host (the native C++ hash,
``native/src/encode.cc`` ``kpw_dict_build_bytes``); this module is the
device formulation, measured against that hash by ``chip_smoke.py`` and
kept off the encoder's path.

One u64 sort key per string is bijective and order-preserving for short
strings:

    key = (first 7 bytes, zero-padded, big-endian) << 8 | min(len, 8)

- big-endian packing makes u64 ascending order the lexicographic order of
  the 7-byte prefix;
- the length byte tells zero padding apart (b"a" vs b"a\\x00") and orders a
  string before its proper extensions ("ab" < "abc"), as bytes compare;
- two distinct strings share a key only when both have len >= 8 and the
  same first 7 bytes: exactly the key groups holding a row with len >= 8,
  which the host tie-breaks by sorting their full values.  Every other key
  gives its string back with no per-row host work.

The keys ride the device dictionary build (``ops.dictionary``: the sort
route with the sign-bit flip, or the bins route when the keys span little),
and the host splices the tie-broken groups into the ascending order.  The
result equals ``core.encodings.dictionary_build`` and the native hash.
"""

from __future__ import annotations

import time

import numpy as np

from ..core.bytecol import ByteColumn


def prefix_keys(col: ByteColumn) -> np.ndarray:
    """(n,) uint64 sort keys: 7 zero-padded prefix bytes big-endian, then
    min(len, 8) in the low byte (see the module docstring for why this is
    order-preserving and near-bijective)."""
    n = len(col)
    if n == 0:
        return np.zeros(0, np.uint64)
    data = np.frombuffer(col.data, np.uint8) if not isinstance(
        col.data, np.ndarray) else col.data.view(np.uint8)
    offs = col.offsets
    starts = offs[:-1]
    lens = np.diff(offs)
    take = np.minimum(lens, 7)
    if len(data) == 0:
        # all rows are empty strings: no bytes to gather, the keys are pure
        # length bytes (all zero)
        return np.zeros(n, np.uint64)
    # gather an (n, 7) byte block; rows shorter than 7 read clamped
    # positions, masked to the zero pad
    j = np.arange(7)
    idx = np.minimum(starts[:, None] + j, len(data) - 1)
    block = np.where(j[None, :] < take[:, None], data[idx], 0)
    key = np.zeros(n, np.uint64)
    for b in range(7):  # 7 shifts over vectors, not a per-row loop
        key |= block[:, b].astype(np.uint64) << np.uint64(8 * (7 - b))
    key |= np.minimum(lens, 8).astype(np.uint64)
    return key


def _key_to_bytes(key: int) -> bytes:
    """Inverse of :func:`prefix_keys` for unambiguous keys (len <= 7, or the
    canonical prefix of a len-8 marker)."""
    ln = key & 0xFF
    pre = int(key >> 8).to_bytes(7, "big")
    return pre[: min(ln, 7)]


def device_string_dictionary(col: ByteColumn, max_k: int | None = None,
                             timings: dict | None = None, device="cuda"):
    """Byte-array dictionary via the device key build + host tie-break.

    Returns (dict_values list[bytes] in ascending lexicographic order,
    indices uint32), equal to ``core.encodings.dictionary_build``, or None
    when the unique count exceeds ``max_k`` (the host paths' abort
    contract).  ``timings`` (optional dict) receives the phases in ms:
    ``prefix_ms`` (host key extraction), ``device_ms`` (the key dictionary
    build on ``device``, readback included), ``tiebreak_ms`` (host suffix
    resolution), and ``tiebreak_row_fraction``, the share of rows (len >= 8)
    that pay per-row host work in the tie-break.
    """
    from ..device import resolve_device, to_host
    from .dictionary import DictBuildHandle

    dev = resolve_device(device)
    n = len(col)
    t0 = time.perf_counter()
    keys = prefix_keys(col)
    t1 = time.perf_counter()
    if n == 0:
        return [], np.zeros(0, np.uint32)
    handle = DictBuildHandle(keys, dev)
    kdict, kidx_dev = handle.result()
    # device batches pad rows to their bucket: trim to the real n
    (kidx,) = to_host([kidx_dev[:n]])
    kidx = kidx.view(np.uint32)
    t2 = time.perf_counter()
    k_keys = len(kdict)
    lens = np.diff(col.offsets)
    # ambiguous key groups hold a row with len >= 8 (the key is bijective
    # otherwise); distinct suffixes expand such a group into several
    # dictionary slots, in suffix order (the 7-byte prefix is shared)
    ambiguous = np.zeros(k_keys, bool)
    long_rows = np.nonzero(lens >= 8)[0]
    ambiguous[kidx[long_rows]] = True
    t_tie0 = time.perf_counter()
    if not ambiguous.any():
        dict_values = [_key_to_bytes(int(k)) for k in kdict]
        out_idx = kidx
        if max_k is not None and len(dict_values) > max_k:
            return None
    else:
        # per ambiguous group: sort the distinct full strings; splice
        group_members: dict[int, dict[bytes, int]] = {}
        for r in long_rows:
            g = int(kidx[r])
            group_members.setdefault(g, {}).setdefault(col[int(r)], 0)
        extra = np.zeros(k_keys, np.int64)  # additional slots per group
        group_rank: dict[int, dict[bytes, int]] = {}
        group_order: dict[int, list[bytes]] = {}
        for g, members in group_members.items():
            ordered = sorted(members)
            group_order[g] = ordered
            group_rank[g] = {v: i for i, v in enumerate(ordered)}
            extra[g] = len(ordered) - 1
        base = np.concatenate([[0], np.cumsum(extra)[:-1]])  # slot shift
        dict_values: list[bytes] = []
        for g in range(k_keys):
            if ambiguous[g]:
                dict_values.extend(group_order[g])
            else:
                dict_values.append(_key_to_bytes(int(kdict[g])))
        if max_k is not None and len(dict_values) > max_k:
            return None
        out_idx = (kidx.astype(np.int64) + base[kidx]).astype(np.uint32)
        # rows in ambiguous groups add their rank within the group
        sub = np.fromiter(
            (group_rank[int(kidx[r])][col[int(r)]] for r in long_rows),
            np.uint32, long_rows.size)
        out_idx[long_rows] += sub
    t3 = time.perf_counter()
    if timings is not None:
        timings["prefix_ms"] = round((t1 - t0) * 1e3, 3)
        timings["device_ms"] = round((t2 - t1) * 1e3, 3)
        timings["tiebreak_ms"] = round((t3 - t_tie0) * 1e3, 3)
        timings["tiebreak_row_fraction"] = round(long_rows.size / n, 4)
    return dict_values, out_idx
