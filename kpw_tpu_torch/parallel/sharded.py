"""The encode step: a dictionary build plus an index bit-pack over a (C, N)
batch of 32-bit column keys, on one card and over a shard mesh.

Every step runs on the device of its input (or, on a mesh, each shard on
its own device): on a CUDA tensor every kernel it reaches is a CUDA
kernel, on a CPU tensor their plain versions run.

The mesh half (the JAX package's ``sharded_encode_step``,
``sharded_encode_step_bounded`` and ``bounded_global_dictionary_encode``)
splits the rows over the shards of a :class:`~.mesh.ShardMesh` and builds
every column's dictionary mesh-globally: the gather route through
``dict_merge``'s sort-unique merge, the bounded route (values below 2^13)
as per-shard histograms (the hist kernel, once per shard), ONE psum of
them, the dictionary from the merged counts and each shard's ranks
against it (the rank kernel, once per shard).  The packed steps end in
the fused pack kernel, once per shard.

Single-card routes, chosen as the JAX package chooses them (without its
TPU dispatch switch):

- bounded (``value_bound <= 2^13`` and ``N % 128 == 0``): the histogram +
  dictionary kernel, the rank kernel on the unmasked values, then the
  fused pack kernel, which zeroes every row past ``count`` — no sort over
  N and no masking op between the kernels;
- otherwise the sort route: one stable sort per column builds the
  dictionary, scatters put the ranks back in row order, then the fused
  pack kernel.

Outputs are identical on both routes and on either device, and equal to
the JAX function's: ``packed`` (C, N*width/8) uint8, ``ulo`` (C, N) int64
holding the 32-bit dictionary values in ``[:k]`` and the pad 0xFFFFFFFF
after them, and ``k`` (C,) int32.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..device import to_host
from ..ops.bitpack import pack_pages
from ..ops.packing import bits32, pad_bucket
from ..ops.rank import (ROW_LANES, S_LO, U32_PAD, hist_dict, hist_pages,
                        presence_to_dict, rank_pages)
from . import mesh as M
from .dict_merge import _halves, _keys, _merge_kernel

# Static pack widths, as in the JAX package: the width is picked from a
# host-known bound on the number of uniques (the row count N).
_WIDTH_BUCKETS = (16, 20, 24, 28, 32)

# The sort-free route serves values bounded by 2^13; nhi = padded bound/64
# buckets to a fixed set.
_BOUNDED_MAX = 1 << 13
_BOUNDED_NHI_BUCKETS = (8, 32, 128)


def index_width_bucket(k_bound: int) -> int:
    """Smallest static width bucket whose bit budget covers dictionary
    indices 0..k_bound-1.  Pass the ROW COUNT N: :func:`encode_step_single`
    requires N <= 2**width (k <= N always holds)."""
    need = max((max(k_bound, 1) - 1).bit_length(), 1)
    for w in _WIDTH_BUCKETS:
        if need <= w:
            return w
    raise ValueError(f"dictionary indices need {need} bits; max is 32")


def _valid(n: int, count, device) -> torch.Tensor:
    if isinstance(count, torch.Tensor):
        count = count.to(device)
    return torch.arange(n, device=device) < count


def _pack_rows(ranks: torch.Tensor, count, width: int) -> torch.Tensor:
    """Bit-pack every column's first ``count`` rows of ``ranks`` (C, n),
    zero past ``count``, in one fused launch with no page table."""
    return pack_pages(ranks, None, ranks.shape[1], width, stats=False,
                      count=count)[0]


def encode_step_single(lo: torch.Tensor, count, width: int = 16,
                       value_bound: int | None = None):
    """Dictionary-encode and bit-pack a (C, N) batch of 32-bit keys on the
    device of ``lo`` (int32 bit patterns, or int64 holding unsigned 32-bit
    values).  The first ``count`` rows of every column are valid (an int or
    a 0-d tensor).  ``width`` is the static pack width (see
    :func:`index_width_bucket`); N must not exceed ``2**width``.

    ``value_bound`` is an optional host-known exclusive upper bound on the
    valid values; bounds up to 2^13 take the sort-free histogram + rank
    route.  A wrong bound (a valid value at or above it) corrupts the
    output, so callers derive it from a real scan.

    Returns (packed (C, N*width//8) uint8, ulo (C, N) int64, k (C,) int32):
    ``ulo[c, :k[c]]`` is column c's ascending dictionary, padded with
    0xFFFFFFFF after it, and ``packed[c]`` its rows' dictionary indices
    bit-packed, zero past ``count``."""
    if lo.dim() != 2:
        raise ValueError(f"lo must be (C, N), got {tuple(lo.shape)}")
    n = lo.shape[1]
    if n > (1 << width):
        raise ValueError(
            f"N={n} rows could hold up to {n} uniques, which do not fit "
            f"{width}-bit indices; pick width with index_width_bucket(N)")
    if (value_bound is not None and int(value_bound) <= _BOUNDED_MAX
            and n % 128 == 0):
        for nhi in _BOUNDED_NHI_BUCKETS:
            if nhi * S_LO >= int(value_bound):
                return _encode_step_single_bounded(lo, count, width, nhi)
    return _encode_step_single_impl(lo, count, width)


def _encode_step_single_bounded(lo: torch.Tensor, count, width: int, nhi: int):
    """Sort-free route for values below ``nhi*64`` (the JAX package's
    ``_encode_step_single_matmul``): histogram + dictionary and rank table
    in one launch, per-row ranks, then the fused pack.  Rows past ``count``
    count nowhere in the histogram; their ranks are harmless and the pack
    zeroes them."""
    n = lo.shape[1]
    v = bits32(lo)
    # contract shape (C, n), padded in the same launch: k <= min(count,
    # nhi*64) uniques always fit
    _, rt, ulo, k = hist_dict(v, count, nhi, ulo_cols=n)
    return _pack_rows(rank_pages(v, rt), count, width), ulo, k


def _encode_step_single_impl(lo: torch.Tensor, count, width: int):
    """Sort route: a stable sort per column makes equal values adjacent
    (invalid rows lifted past every 32-bit value), new-value flags and their
    running count give each row its dictionary index, and two scatters put
    the indices back in row order and the uniques at the front."""
    C, n = lo.shape
    dev = lo.device
    valid = _valid(n, count, dev)
    key = torch.where(valid, bits32(lo).to(torch.int64) & 0xFFFFFFFF, 1 << 32)
    slo, spos = torch.sort(key, dim=1, stable=True)
    same = torch.cat([torch.zeros((C, 1), dtype=torch.bool, device=dev),
                      slo[:, 1:] == slo[:, :-1]], dim=1)
    # valid is a prefix predicate, so post-sort validity is the same mask
    is_new = valid & ~same
    k = is_new.sum(1, dtype=torch.int32)
    uid = torch.cumsum(is_new, 1, dtype=torch.int32) - 1
    indices = torch.empty_like(uid).scatter_(1, spos, uid)
    slot = torch.where(is_new, uid, n).to(torch.int64)
    ulo = key.new_full((C, n + 1), U32_PAD).scatter_(1, slot, slo)[:, :n]
    return _pack_rows(indices, count, width), ulo, k


# ---------------------------------------------------------------------------
# the mesh half
# ---------------------------------------------------------------------------

def _shard_blocks(mesh: M.ShardMesh, x: torch.Tensor) -> list:
    """(C, N) rows of this process -> one (C, N / n_local) block per local
    shard, each on its shard's device."""
    C, N = x.shape
    if N % mesh.n_local:
        raise ValueError(f"N={N} rows do not split over {mesh.n_local} shards")
    per = N // mesh.n_local
    if per % 8:
        raise ValueError(f"{per} rows a shard: the pack needs a multiple of 8")
    return [x[:, s * per:(s + 1) * per].to(d) for s, d in enumerate(mesh.devices)]


def _host_counts(counts, n_local: int) -> list:
    if isinstance(counts, torch.Tensor):
        counts = counts.cpu()
    c = np.asarray(counts).reshape(-1).tolist()
    if len(c) != n_local:
        raise ValueError(f"{len(c)} counts for {n_local} local shards")
    return [int(v) for v in c]


def _concat(mesh: M.ShardMesh, parts: list) -> torch.Tensor:
    """This process's shards' blocks side by side on the first device."""
    return torch.cat([p.to(mesh.first) for p in parts], dim=-1)


def sharded_encode_step(hi, lo, counts, *, mesh: M.ShardMesh, cap: int = 4096,
                        width: int = 16, has_hi: bool = True):
    """One mesh encode step over the gather route.

    hi, lo: (C, N) key halves of this process's rows (int32 bit patterns,
    or int64 holding unsigned 32-bit values), split evenly over the mesh's
    local shards; counts: (n_local,) valid rows per shard.  Returns
    (packed (C, N*width//8) uint8, every shard's index bytes side by side;
    mhi, mlo (C, G) int64, the global dictionaries' key halves, valid in
    the first gk[c]; gk (C,); rows, the mesh's row count, a 0-d CPU
    tensor summed on the host; overflow, 1 when
    a shard held more than ``cap`` uniques or an index needs more than
    ``width`` bits), the mesh-wide results on the mesh's first device.
    Pass ``has_hi=False`` when the hi plane is statically zero (32-bit
    column dtypes): the gathered payload is then 4 bytes a key."""
    counts = _host_counts(counts, mesh.n_local)
    keys = [_keys(h, l, has_hi) for h, l in
            zip(_shard_blocks(mesh, hi) if has_hi else [None] * mesh.n_local,
                _shard_blocks(mesh, lo))]
    indices, mkey, gk, rows, ovf = _merge_kernel(mesh, keys, counts, cap,
                                                 has_hi=has_hi)
    # indices wider than `width` bits would silently wrap in the pack
    ovf = ((ovf > 0) | (gk > (1 << width))).any().to(torch.int32)
    packed = [_pack_rows(i.to(torch.int32), c, width)
              for i, c in zip(indices, counts)]
    mhi, mlo = _halves(mkey, has_hi)
    return _concat(mesh, packed), mhi, mlo, gk.to(torch.int32), rows, ovf


def _bounded_merge_core(mesh: M.ShardMesh, blocks: list, counts: list, nhi: int):
    """The bounded merge shared by the packed step and the production
    index route: per shard, its valid values (rows past its count lifted to
    the sentinel ``nhi*64``) counted by the hist kernel; ONE psum of the
    (C, nhi, 64) counts (the merge: a constant nhi*64*4 bytes a column,
    whatever the rows or the cardinality); the dictionary and rank table
    from the merged counts; each shard's ranks by the rank kernel against
    its device's copy of the table.  Returns (ranks per shard (C, n) int32,
    zero past its count; ulo (C, nhi*64) int64; gk (C,) int32; rows)."""
    vb = nhi * S_LO
    masked = []
    for l, c in zip(blocks, counts):
        n = l.shape[-1]
        m = torch.where(torch.arange(n, device=l.device) < c, bits32(l), vb)
        lane = -n % ROW_LANES  # the kernels take whole 128-lane rows
        masked.append(torch.nn.functional.pad(m, (0, lane), value=vb) if lane else m)
    gcounts = M.psum(mesh, [hist_pages(m, nhi) for m in masked])
    rt, ulo, gk = presence_to_dict(gcounts, nhi)
    rts = M.replicate(mesh, rt)
    ranks = [rank_pages(m, rts[m.device])[:, :l.shape[-1]].contiguous()
             for m, l in zip(masked, blocks)]
    return ranks, ulo, gk, M.psum_counts(mesh, counts)


def _nhi_bucket(value_bound: int) -> int:
    if int(value_bound) > _BOUNDED_MAX:
        raise ValueError(f"value_bound={value_bound} exceeds the "
                         f"histogram-psum design bound {_BOUNDED_MAX}")
    return next(b for b in _BOUNDED_NHI_BUCKETS if b * S_LO >= int(value_bound))


def bounded_psum_payload_bytes(value_bound: int) -> int:
    """The histogram-psum merge's per-column payload: the BUCKETED
    bin-count matrix, nhi*64*4 bytes with nhi the smallest bucket covering
    the bound — constant in rows/shard and cardinality."""
    return _nhi_bucket(value_bound) * S_LO * 4


def sharded_encode_step_bounded(lo, counts, *, mesh: M.ShardMesh,
                                width: int = 16, value_bound: int):
    """The mesh encode step for bounded 32-bit values (``value_bound`` <=
    2^13, globally valid across every shard — derive it from a real scan,
    never a guess): the global dictionary merge is ONE psum of per-shard
    bin-count histograms (the BASELINE config-4 north star, "psum-based
    global dictionary merge"), so the payload is a CONSTANT
    :func:`bounded_psum_payload_bytes` per column, independent of rows per
    shard AND of the cardinality k.  The hist, rank and pack kernels each
    launch once per shard.

    Returns (packed (C, N*width//8), gdict (C, nhi*64) int64 ascending,
    padded with 0xFFFFFFFF, gk (C,), rows, overflow) — dictionary and
    indices identical to :func:`sharded_encode_step` with ``has_hi=False``
    on the same data."""
    nhi = _nhi_bucket(value_bound)
    counts = _host_counts(counts, mesh.n_local)
    ranks, ulo, gk, rows = _bounded_merge_core(mesh, _shard_blocks(mesh, lo),
                                               counts, nhi)
    packed = [_pack_rows(r, c, width) for r, c in zip(ranks, counts)]
    ovf = (gk > (1 << width)).any().to(torch.int32)
    return _concat(mesh, packed), ulo, gk, rows, ovf


def bounded_global_dictionary_encode(values, mesh: M.ShardMesh, *, vmin: int,
                                     stride: int, value_bound: int,
                                     dispatch_lock=None,
                                     stats_out: dict | None = None,
                                     trusted: bool = False):
    """Writer-reachable histogram-psum dictionary merge: the production
    counterpart of ``dict_merge.global_dictionary_encode`` for bounded
    integer columns — ``(values - vmin) / stride`` lies in
    ``[0, value_bound)`` with ``value_bound <= 2^13`` (derive
    vmin/stride/bound from the column's min/max/gcd, never a guess: a
    violated bound silently corrupts the histogram).

    The global merge is ONE psum of per-shard bin-count histograms — a
    CONSTANT :func:`bounded_psum_payload_bytes` per column, independent
    of rows/shard and cardinality, vs the gather route's
    ``pad_bucket(k_max)``-proportional payload.  Returns (dict_values
    ascending, indices) as host arrays, identical to the gather merge and
    the host backends: offsets are non-negative, so ascending offset
    order IS ascending bit-pattern order of the reconstructed
    ``vmin + stride * offset`` values (callers guard ``vmin >= 0`` for
    exactly this reason).

    ``stats_out`` accumulates ``bounded_columns`` /
    ``bounded_psum_bytes`` / ``bounded_nhi_max`` next to the gather
    route's keys.  ``dispatch_lock`` covers the device section only, as
    in ``global_dictionary_encode``."""
    nhi = _nhi_bucket(value_bound)
    if int(vmin) < 0:
        # byte-identity depends on it: ascending offsets reconstruct to
        # ascending BIT-PATTERN order only for non-negative values (a
        # negative int64 sorts above the positives by bit pattern)
        raise ValueError(f"vmin={vmin} < 0: bounded route requires "
                         "non-negative values for bit-pattern dict order")
    arr = np.ascontiguousarray(values)
    n = len(arr)
    t = arr.dtype.type
    # ``trusted=True`` (the mesh encoder, whose vmin/stride/bound come
    # from an exact min/max/gcd pass) skips the two O(n) defensive
    # rescans; direct callers keep them, because a non-dividing stride or
    # violated bound silently corrupts the dictionary.
    if not trusted and stride > 1 and n and ((arr - t(vmin)) % t(stride)).any():
        raise ValueError(f"stride={stride} does not divide every "
                         f"(value - vmin): offsets would collide")
    offsets = (arr - t(vmin)) // t(stride)
    if not trusted and n and int(offsets.max()) >= int(value_bound):
        raise ValueError(
            f"max offset {int(offsets.max())} >= value_bound={value_bound}: "
            "a violated bound silently corrupts the histogram")
    n_local = mesh.n_local
    rows_per = max((n + n_local - 1) // n_local, 1)
    per = pad_bucket(rows_per)  # power of two >= 256: whole 128-lane rows
    lo_p = np.zeros((n_local, per), np.int32)
    counts = []
    for s in range(n_local):
        a = s * rows_per
        take = max(0, min(rows_per, n - a))
        lo_p[s, :take] = offsets[a:a + take]
        counts.append(take)
    with dispatch_lock if dispatch_lock is not None else contextlib.nullcontext():
        blocks = [torch.from_numpy(lo_p[s:s + 1]).to(d)
                  for s, d in enumerate(mesh.devices)]
        ranks, ulo, gk, rows = _bounded_merge_core(mesh, blocks, counts, nhi)
        gk_h, ulo_h, idx_h = to_host([gk, ulo[0], _concat(mesh, ranks)[0]])
        if stats_out is not None:
            stats_out["bounded_columns"] = stats_out.get("bounded_columns", 0) + 1
            stats_out["bounded_psum_bytes"] = (
                stats_out.get("bounded_psum_bytes", 0) + nhi * S_LO * 4)
            stats_out["bounded_nhi_max"] = max(
                stats_out.get("bounded_nhi_max", 0), nhi)
    assert mesh.size != n_local or int(rows) == n
    k = int(gk_h[0])
    dict_values = (ulo_h[:k].astype(np.uint64) * np.uint64(stride)
                   + np.uint64(vmin)).astype(arr.dtype)
    out_idx = np.concatenate(
        [idx_h[s * per:s * per + counts[s]] for s in range(n_local)]
    ).astype(np.uint32)
    return dict_values, out_idx
