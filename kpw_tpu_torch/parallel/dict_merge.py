"""Global dictionary merge across mesh shards (the north-star collective).

Scenario (BASELINE.md config 4): 16 Kafka partitions land on 8 shards, all
writing one shared row group.  Each shard dictionary-encodes its rows
locally, then the shards agree on ONE global dictionary so the row group has
a single dictionary page.  The reference has no analog — parquet-mr builds
one hash map per file on one thread (SURVEY.md §2.4 "Collective ops: No").

Algorithm (every shard's part runs on its own device, see ``mesh.py``):

  1. per-shard sorted-unique of the local values (capped at ``cap``), and a
     ``pmax`` of the local cardinalities (``global_dictionary_encode``);
  2. ``all_gather`` the per-shard unique sets (re-sliced to
     ``pad_bucket(k_max)`` by ``global_dictionary_encode``);
  3. merge: sort-unique the gathered sets -> the global dictionary in
     ascending key order (deterministic regardless of shard count);
  4. per-shard index lookup of each value in the ascending dictionary
     (``torch.searchsorted``);
  5. the mesh's row count for the footer (the per-shard counts are known
     on the host, so they are summed there), and a ``psum`` of overflow
     flags: did any shard exceed ``cap``.

Order: keys are compared as unsigned 64-bit bit patterns, as every
single-device builder orders its dictionary (a negative int64 sorts ABOVE
the positives).  A 32-bit column's key is its uint32 bit pattern held in an
int64; a 64-bit column's is its bit pattern with the top bit flipped, held
in an int64, whose signed order is the unsigned order of the pattern — one
portable single-key sort on every device, no unsigned sort needed.

This is the JAX package's XLA code (sort-unique plus searchsorted), not a
Pallas kernel, so the library's sort and search serve here.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..device import to_host
from ..ops.dictionary import split_keys
from ..ops.packing import pad_bucket
from . import mesh as M

KEY_MAX = (1 << 63) - 1  # the largest flipped 64-bit key
U32_MAX = 0xFFFFFFFF  # the largest 32-bit key
_FLIP = np.uint64(1 << 63)


class DictionaryOverflow(ValueError):
    """A shard's local cardinality exceeded the requested cap.  Distinct
    from other ValueErrors so callers falling back to plain encoding don't
    swallow real bugs (shape/sharding mismatches) as 'overflow'."""


def _u32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & U32_MAX


def _keys(hi, lo, has_hi: bool) -> torch.Tensor:
    """Ordered int64 keys of (hi, lo) uint32 halves (int32 bit patterns or
    int64 holding 32-bit values)."""
    if not has_hi:
        return _u32(lo)
    return (_u32(hi) << 32 | _u32(lo)) ^ torch.iinfo(torch.int64).min


def _halves(key: torch.Tensor, has_hi: bool) -> tuple:
    """Ordered keys back to their (hi, lo) halves, int64 holding 32-bit
    values."""
    if not has_hi:
        return torch.zeros_like(key), key
    raw = key ^ torch.iinfo(torch.int64).min
    return (raw >> 32) & U32_MAX, raw & U32_MAX


def _key_max(has_hi: bool) -> int:
    return KEY_MAX if has_hi else U32_MAX


def _local_unique_keys(key: torch.Tensor, valid: torch.Tensor, cap: int,
                       has_hi: bool = True):
    """Sorted-unique of the valid keys along the last axis, padded to
    ``cap`` with the max key.  Returns (ukey (..., cap), k (...,) int64):
    the first min(k, cap) slots are the uniques in ascending order.

    Invalid slots are lifted to the MAX key: they land at the tail (or
    merge into a real max-key run, where dedupe counts the key once —
    correct either way), and the valid region after the sort is exactly the
    first sum(valid) slots, so one single-key sort serves."""
    big = _key_max(has_hi)
    n = key.shape[-1]
    valid = valid.expand_as(key)
    s = torch.sort(torch.where(valid, key, big), dim=-1).values
    iota = torch.arange(n, device=key.device)
    sval = iota < valid.sum(-1, keepdim=True)
    same = torch.zeros_like(sval)
    same[..., 1:] = s[..., 1:] == s[..., :-1]
    is_new = sval & ~same
    k = is_new.sum(-1)
    rank = torch.cumsum(is_new, -1) - 1
    # compaction by scatter; the non-unique slots go to a dropped slot
    slot = torch.where(is_new & (rank < cap), rank, cap)
    u = s.new_full(s.shape[:-1] + (cap + 1,), big).scatter_(-1, slot, s)[..., :cap]
    u = torch.where(torch.arange(cap, device=key.device) < k.unsqueeze(-1), u, big)
    return u, k


def _local_unique(hi, lo, valid, cap: int, has_hi: bool = True):
    """Sorted-unique of the valid (hi, lo) keys, padded to ``cap``.
    Returns (uhi, ulo, uvalid, k) with uniques in ascending bit-pattern
    order, as int64 holding 32-bit halves; past k the pad is the max key."""
    u, k = _local_unique_keys(_keys(hi, lo, has_hi), valid, cap, has_hi=has_hi)
    uhi, ulo = _halves(u, has_hi)
    uvalid = torch.arange(cap, device=u.device) < k.unsqueeze(-1)
    return uhi, ulo, uvalid, k


def _rank_keys(dkey: torch.Tensor, k: torch.Tensor, vkey: torch.Tensor,
               has_hi: bool = True) -> torch.Tensor:
    """Index of each value key in the ascending dictionary ``dkey`` whose
    first ``k`` slots are valid (along the last axis; the rest is ignored).
    Values not present map to arbitrary indices (callers guarantee
    coverage).  A binary search of each value: the JAX package's
    ``'search'`` method (its sort-based ``'sortrank'`` serves the TPU, whose
    vector units gather slowly; a GPU and a CPU gather from cache)."""
    G = dkey.shape[-1]
    # pads live past the valid prefix; lift them to the max key so the
    # whole array is ascending
    dk = torch.where(torch.arange(G, device=dkey.device) < k.unsqueeze(-1), dkey,
                     _key_max(has_hi))
    # leftmost slot with dict >= value == the match slot
    return torch.searchsorted(dk.contiguous(), vkey.contiguous())


def _rank_against_dict(dhi, dlo, dvalid, vhi, vlo, k=None, has_hi: bool = True):
    """Index of each (vhi, vlo) key in the ascending dict (dhi, dlo) whose
    valid slots ``dvalid`` form a prefix (of ``k`` slots when given).
    Values not in the dictionary (invalid rows) map to arbitrary indices
    and must be masked by the caller."""
    if k is None:
        k = dvalid.sum(-1)
    return _rank_keys(_keys(dhi, dlo, has_hi), k, _keys(vhi, vlo, has_hi),
                      has_hi=has_hi)


def _plane_dtype(has_hi: bool):
    """The gathered payload's type: 4 bytes a 32-bit key, 8 a 64-bit one."""
    return torch.int64 if has_hi else torch.int32


def _shard_uniques(keys: list, counts: list, cap: int, has_hi: bool) -> list:
    """Every shard's (sorted uniques padded to ``cap``, k) on its device."""
    return [_local_unique_keys(key, torch.arange(key.shape[-1], device=key.device) < c,
                               cap, has_hi=has_hi)
            for key, c in zip(keys, counts)]


def _merge_kernel(mesh: M.ShardMesh, keys: list, counts: list, cap: int,
                  has_hi: bool = True):
    """The one-phase merge (the JAX package's shard_map body and its
    ``_merge_sharded`` around it).  ``keys[s]`` (C, n) ordered keys on
    shard s's device, ``counts[s]`` its valid rows.  Returns (indices per
    shard (C, n) int64, merged dict (C, G) keys, gk (C,), rows, overflow
    (C,)) with the mesh-wide results on the mesh's first device."""
    locs = _shard_uniques(keys, counts, cap, has_hi)
    overflow = M.psum(mesh, [(k > cap).to(torch.int32) for _, k in locs])
    plane = _plane_dtype(has_hi)
    gkey = M.all_gather(mesh, [u.to(plane) for u, _ in locs])
    gvalid = M.all_gather(mesh, [torch.arange(cap, device=u.device) < k.unsqueeze(-1)
                                 for u, k in locs])
    return _merge_and_rank(mesh, gkey, gvalid, keys, counts, has_hi) + (overflow,)


def _merge_and_rank(mesh: M.ShardMesh, gkey: torch.Tensor, gvalid, keys: list,
                    counts: list, has_hi: bool):
    """The gathered unique sets -> the merged dictionary (once, on the
    first device), each shard's rows ranked against it on the shard's
    device, and the mesh's row count."""
    if not has_hi:
        gkey = _u32(gkey)
    mkey, gk = _local_unique_keys(gkey, gvalid, gkey.shape[-1], has_hi=has_hi)
    rep_key, rep_k = M.replicate(mesh, mkey), M.replicate(mesh, gk)
    indices = [_rank_keys(rep_key[key.device], rep_k[key.device], key, has_hi=has_hi)
               for key in keys]
    return indices, mkey, gk, M.psum_counts(mesh, counts)


def _phase_a(mesh: M.ShardMesh, keys: list, counts: list, cap: int,
             has_hi: bool = True):
    """Two-phase merge, phase A: per-shard local uniques (kept on their
    devices) + the pmax of the local cardinalities and the overflow psum.
    No row-block gather happens here — the host reads back only (overflow,
    k_max) and picks the phase-B gather capacity ``pad_bucket(k_max)``, so
    the payload is bounded by the actual cardinality instead of the padded
    per-shard row block."""
    locs = _shard_uniques(keys, counts, cap, has_hi)
    overflow = M.psum(mesh, [(k > cap).to(torch.int64) for _, k in locs])
    k_max = M.pmax(mesh, [k for _, k in locs])
    return locs, overflow, k_max


def _phase_b(mesh: M.ShardMesh, locs: list, keys: list, counts: list,
             cap2: int, has_hi: bool = True):
    """Two-phase merge, phase B: each shard's unique block re-sliced to the
    host-chosen ``cap2 = pad_bucket(k_max)``, gathered, merged, and the
    original rows ranked.  Shard validity travels as one int32 per shard
    (the gathered ``k``) instead of a gathered bool plane."""
    plane = _plane_dtype(has_hi)
    gkey = M.all_gather(mesh, [u[..., :cap2].to(plane) for u, _ in locs])
    gk = M.all_gather(mesh, [k.to(torch.int32).unsqueeze(-1) for _, k in locs])
    slots = torch.arange(cap2, device=gkey.device)
    gvalid = (slots < torch.clamp(gk, max=cap2).unsqueeze(-1)).flatten(-2)
    return _merge_and_rank(mesh, gkey, gvalid, keys, counts, has_hi)


def _host_keys(hi, lo) -> np.ndarray:
    """A column's ordered keys on the host: the uint32 pattern of a 32-bit
    column as int32 (widened on the device), the flipped 64-bit pattern of
    a wide one as int64."""
    if hi is None:
        return lo.view(np.int32)
    key = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return (key ^ _FLIP).view(np.int64)


def _device_keys(block: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(block).to(device)
    return _u32(t) if t.dtype == torch.int32 else t


def global_dictionary_encode(values: np.ndarray, mesh: M.ShardMesh,
                             cap: int | None = 65536, dispatch_lock=None,
                             stats_out: dict | None = None):
    """Encode ``values`` against a mesh-global dictionary.

    Rows are split evenly over the mesh's shards (the partitions->shards
    assignment); returns (dict_values ascending by bit pattern, indices)
    as host arrays.  Raises :class:`DictionaryOverflow` when a shard's
    local cardinality exceeds ``cap`` (caller should fall back to plain
    encoding, the same escape hatch parquet-mr uses for oversized
    dictionaries).  ``cap=None`` sizes the cap to the padded per-shard row
    block — a shard can never hold more uniques than rows, so overflow
    becomes impossible (the MeshChunkEncoder byte-identity guarantee).  In
    a mesh over several processes each process passes its own rows and
    gets their indices; the dictionary is the mesh's.

    The merge is the JAX package's two-phase one (its ``two_phase=True``,
    the only form the port has): the gathered payload is bounded by the
    data instead of the row block.  Phase A computes per-shard uniques on
    device and pmaxes the local cardinalities; the host then re-gathers at
    ``pad_bucket(k_max)`` — so an 8-shard 128Ki-rows/shard row group with
    5k-cardinality columns gathers ~8k keys per column, not ~1M.  The
    one-phase merge (:func:`_merge_kernel`) serves ``sharded_encode_step``.
    ``stats_out`` (a dict) accumulates ``ici_gathered_bytes``
    (the gathered payload; on this port a device-to-device copy, or a
    gloo / NCCL transfer between processes) / ``k_max`` / ``gather_cap``.

    ``dispatch_lock`` (any context manager, e.g. a ``threading.Lock``) is
    held only around the DEVICE section — uploads, the shards' launches and
    the collectives, and the readback.  Host-side key splitting, shard
    padding, and index reassembly run outside it, so concurrent writer
    workers overlap their host prep."""
    n_local = mesh.n_local
    n_shards = mesh.size
    n = len(values)
    rows_per = max((n + n_local - 1) // n_local, 1)  # even split over shards
    per = pad_bucket(rows_per)  # static per-shard block, padded
    if cap is None:
        cap = per
    hi, lo = split_keys(np.ascontiguousarray(values))
    has_hi = hi is not None
    hk = _host_keys(hi, lo)
    blocks = np.zeros((n_local, per), hk.dtype)
    counts = []
    for s in range(n_local):
        a = s * rows_per
        take = max(0, min(rows_per, n - a))
        blocks[s, :take] = hk[a:a + take]
        counts.append(take)
    planes = 2 if has_hi else 1
    with dispatch_lock if dispatch_lock is not None else contextlib.nullcontext():
        keys = [_device_keys(blocks[s:s + 1], d) for s, d in enumerate(mesh.devices)]
        locs, overflow, k_max = _phase_a(mesh, keys, counts, cap, has_hi)
        # ONE combined readback picks the gather capacity and checks overflow
        ovf_i, k_max = map(int, to_host([torch.cat([overflow, k_max])])[0])
        if ovf_i:
            raise DictionaryOverflow(
                f"per-shard dictionary cardinality exceeded cap={cap}")
        cap2 = min(pad_bucket(max(k_max, 1)), cap)
        indices, mkey, gk, rows = _phase_b(mesh, locs, keys, counts, cap2, has_hi)
        if stats_out is not None:
            stats_out["ici_gathered_bytes"] = (
                stats_out.get("ici_gathered_bytes", 0)
                + n_shards * (cap2 * 4 * planes + 4))
            stats_out["k_max"] = max(stats_out.get("k_max", 0), k_max)
            stats_out["gather_cap"] = max(stats_out.get("gather_cap", 0), cap2)
            stats_out["columns"] = stats_out.get("columns", 0) + 1
        first = mesh.first
        mkey_h, gk_h, idx_h = to_host(
            [mkey[0], gk, torch.cat([i[0].to(first) for i in indices])])
    gk = int(gk_h[0])
    assert mesh.size != n_local or int(rows) == n
    arr = np.ascontiguousarray(values)
    mk = mkey_h[:gk]
    if arr.dtype.itemsize == 4:
        dict_values = mk.astype(np.uint32).view(arr.dtype)
    else:
        dict_values = (mk.view(np.uint64) ^ _FLIP).view(arr.dtype)
    # shards are contiguous row ranges; reassemble by stripping per-shard pad
    out_idx = np.concatenate(
        [idx_h[s * per:s * per + counts[s]] for s in range(n_local)]
    ).astype(np.uint32)
    return dict_values, out_idx
