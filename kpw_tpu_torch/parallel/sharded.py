"""The flagship encode step on one card: a dictionary build plus an index
bit-pack over a (C, N) batch of 32-bit column keys.

This is the single-device half of ``kpw_tpu/parallel/sharded.py``
(``encode_step_single`` and the two routes under it); the mesh half is not
ported yet.  The step runs on the device of its input: on a CUDA tensor
every kernel it reaches is a CUDA kernel, on a CPU tensor their plain
versions run.

Routes, chosen as the JAX package chooses them (without its TPU dispatch
switch):

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

import torch

from ..ops.bitpack import pack_pages
from ..ops.packing import bits32
from ..ops.rank import S_LO, U32_PAD, hist_dict, rank_pages

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
