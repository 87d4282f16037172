"""Device bit-packing of parquet RLE/bit-pack hybrid page bodies.

The CPU oracle is ``core.encodings.bitpack`` (parquet LSB-first bit order):
value bit j of value i lands at overall bit position ``i*width + j``.  The
work itself — cutting each page out of a (C, N) index batch, zeroing it
past its count, measuring the long-run mass that decides RLE against
bit-packing (``core.encodings.rle_hybrid_encode``) and the bit-pack — is
one launch of the fused kernel behind :func:`ops.bitpack.pack_pages`; this
module builds its page table and serves the encoder's callers.  It also
holds the run helpers of the level path (``ops.levels``): run labelling of
masked windows and the scatter compaction of the run ends.

Conventions of the port: 32-bit values travel as int32 bit patterns (the
kernels read them as ``uint32_t``); where unsigned order or arithmetic
matters they widen to int64 first.  Page sizes are bucketed to powers of
two, as in the JAX package, so pages of similar size share one launch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .bitpack import newrun, pack_pages, window_slice


def bits32(t: torch.Tensor) -> torch.Tensor:
    """``t``'s 32-bit values as int32 bit patterns: int32 passes through,
    int64 holding unsigned 32-bit values wraps to the same pattern."""
    if t.dtype == torch.int32:
        return t
    if t.dtype in (torch.int64, torch.uint32):
        return t.to(torch.int32)
    raise TypeError(f"expected 32-bit values as int32 or int64, got {t.dtype}")


def pad_bucket(n: int, minimum: int = 256) -> int:
    """Power-of-two padding bucket (multiple of 8) so pages of similar size
    share one launch."""
    return 1 << max(int(math.ceil(math.log2(max(n, 1)))), int(math.log2(minimum)))


def page_table(rows, starts, counts, device) -> torch.Tensor:
    """The (P, 3) int32 page table (row, start, count) of host lists or
    arrays, uploaded to ``device`` in one copy."""
    table = np.stack([np.asarray(rows, np.int64), np.asarray(starts, np.int64),
                      np.asarray(counts, np.int64)], axis=1).reshape(-1, 3)
    if table.size and (table.min() < 0 or table.max() > np.iinfo(np.int32).max):
        raise ValueError("page rows, starts and counts must be int32 and >= 0")
    return torch.from_numpy(table.astype(np.int32)).to(device)


def pack_pages_multi(idx_all: torch.Tensor, col_ids, starts, counts,
                     bucket: int, width: int):
    """Pack many pages — possibly from different columns of one (C, N)
    index batch — in one fused launch.  Page p is row ``col_ids[p]``,
    values ``[starts[p], starts[p] + counts[p])``.

    Returns (packed (P, bucket*width//8) uint8, long_sum (P,) int32), where
    long_sum is the total length of runs >= 8 in each page (a page has a
    long run iff long_sum > 0)."""
    table = page_table(col_ids, starts, counts, idx_all.device)
    return pack_pages(bits32(idx_all), table, bucket, width)[:2]


def pack_pages_only(idx_all: torch.Tensor, col_ids, starts, counts,
                    bucket: int, width: int) -> torch.Tensor:
    """:func:`pack_pages_multi` without the run statistics, for pages whose
    RLE-vs-bitpack decision is already known: the same fused launch with
    ``long_sum`` off.  Returns packed (P, bucket*width//8) uint8.  Kept for
    parity with the JAX package's phase-B pack; the encoder does not call
    it, because the level planner's phase-A launch already packed those
    pages."""
    table = page_table(col_ids, starts, counts, idx_all.device)
    return pack_pages(bits32(idx_all), table, bucket, width, stats=False)[0]


def pack_page(idx_full: torch.Tensor, start: int, count: int, bucket: int,
              width: int):
    """Encode one data page's dictionary indices.  ``idx_full`` is the whole
    chunk's 1-D index array; the window ``[start, start+bucket)`` may run
    past its end (those values read as 0).  Returns (packed
    (bucket*width//8,) uint8, long_sum, any_long) as tensors on
    ``idx_full``'s device."""
    table = page_table([0], [start], [count], idx_full.device)
    packed, long_sum, _ = pack_pages(bits32(idx_full).reshape(1, -1), table,
                                     bucket, width)
    return packed[0], long_sum[0], long_sum[0] > 0


def pack_page_host(idx_full: torch.Tensor, start: int, count: int, width: int,
                   bucket: int) -> tuple[np.ndarray, int, bool]:
    """:func:`pack_page` brought to the host: (packed bytes ndarray,
    long_sum, any_long)."""
    packed, long_sum, any_long = pack_page(idx_full, start, count, bucket, width)
    return packed.cpu().numpy(), int(long_sum), bool(any_long)


def _pad_rows(idx_all: torch.Tensor, bucket: int) -> torch.Tensor:
    """``idx_all`` (C, N) as int32 with ``bucket`` zero columns appended, so
    every window starting inside a row stays in bounds."""
    idx = bits32(idx_all)
    return torch.cat([idx, idx.new_zeros((idx.shape[0], bucket))], dim=1)


def gather_index_slices(idx_all: torch.Tensor, col_ids, starts,
                        bucket: int) -> torch.Tensor:
    """Index windows ``[start, start+bucket)`` for several (column, start)
    pairs in one gather — how the rare long-run pages reach the host for
    the exact mixed RLE stream.  Returns (P, bucket) int32."""
    dev = idx_all.device
    pos = torch.arange(bucket, device=dev)
    rows = torch.as_tensor(np.asarray(col_ids, np.int64), device=dev)
    first = torch.as_tensor(np.asarray(starts, np.int64), device=dev)
    return _pad_rows(idx_all, bucket)[rows[:, None], first[:, None] + pos]


# ---------------------------------------------------------------------------
# run helpers: plain tensor functions along the last axis, on any device
# ---------------------------------------------------------------------------

def run_scan(v: torch.Tensor, valid: torch.Tensor):
    """Run labelling of masked windows: (newrun, run_id, is_end).
    ``run_id`` numbers each position's run from 0; ``is_end`` marks the
    last valid position of each run."""
    starts = newrun(v, valid)
    run_id = starts.to(torch.int32).cumsum(-1, dtype=torch.int32) - 1
    nxt_break = torch.cat([starts[..., 1:] | ~valid[..., 1:],
                           torch.ones_like(valid[..., :1])], dim=-1)
    return starts, run_id, valid & nxt_break


def window_run_scan(levels: torch.Tensor, table: torch.Tensor, bucket: int):
    """Cut the windows of a (P, 3) page table out of ``levels`` (rows, ld)
    int32 as :func:`ops.bitpack.window_slice` does and label their runs.
    Returns (v (P, bucket) int32, run_id, is_end)."""
    v, valid = window_slice(levels, table, bucket)
    _, run_id, is_end = run_scan(v, valid)
    return v, run_id, is_end


def compact_by_rank(rank: torch.Tensor, values: tuple, out_size: int) -> tuple:
    """Place each tensor of ``values`` at slot ``rank[..., i]`` along the
    last axis for ranks < ``out_size``; other ranks are dropped and
    unfilled slots are zero.  One scatter per value: the sort routes and
    static value-bit packing of the JAX package's version are choices for
    the TPU, whose vector units take scatters badly, and are not carried
    over."""
    safe = torch.clamp(rank, max=out_size).to(torch.int64)
    return tuple(v.new_zeros(v.shape[:-1] + (out_size + 1,)).scatter_(-1, safe, v)
                 [..., :out_size] for v in values)
