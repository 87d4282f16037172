"""Device encoding of repetition/definition level streams (BASELINE config
5: nested list<struct> rep/def-level RLE).

Level streams are tiny-width integers (bit_width(max_level), usually 1-3
bits) with two regimes:

- high-entropy streams take the oracle's pure bit-pack route
  (``core.encodings.rle_hybrid_encode``).  The fused pack kernel that
  measures every page's run statistics (:func:`level_stats_multi`) packs
  it in the same launch, so these pages need no second pass;
- run-dominated streams (the common case: def levels are mostly max_def)
  take the mixed RLE route.  Their run lists are extracted on the device
  (:func:`level_runs_multi`: window gather, run starts, a cumsum for the
  run ids, one scatter of each run's value and end position; lengths are
  differences of the end positions) and only the compact list is read
  back; the host replays it through ``core.encodings.rle_hybrid_from_runs``
  for a byte-identical stream.

Both window into one stacked (K, maxN) int32 batch of every level stream
of the row group through a (P, 3) page table, as the value path does
(``ops.backend``).
"""

from __future__ import annotations

import torch

from .bitpack import pack_pages
from .packing import bits32, compact_by_rank, page_table, window_run_scan


def level_stats_multi(levels_all: torch.Tensor, stream_ids, starts, counts,
                      bucket: int, width: int):
    """Per page window, in one launch of the fused pack: (long_sum, n_runs,
    packed) — ``long_sum`` the total length of runs >= 8 (the oracle's
    bit-pack-vs-mixed decision), ``n_runs`` the run count (sizes the run
    extraction) and ``packed`` (P, bucket*width//8) uint8, the page's
    values bit-packed at ``width``: the body of a page the decision sends
    to bit-packing."""
    table = page_table(stream_ids, starts, counts, levels_all.device)
    packed, long_sum, n_runs = pack_pages(bits32(levels_all), table, bucket,
                                          width, n_runs=True)
    return long_sum, n_runs, packed


def level_runs_multi(levels_all: torch.Tensor, stream_ids, starts, counts,
                     bucket: int, run_bucket: int):
    """Each page window's run list: (run_vals (P, run_bucket) int32,
    run_lens (P, run_bucket) int32).  ``run_bucket`` must be at least the
    page's n_runs from :func:`level_stats_multi`; excess slots are zero."""
    table = page_table(stream_ids, starts, counts, levels_all.device)
    v, run_id, is_end = window_run_scan(bits32(levels_all), table, bucket)
    # one compaction keyed on run ENDS gives both outputs: a run's value is
    # its value at the end, and runs partition the valid prefix, so length
    # j = end_j - end_{j-1} (end_{-1} = -1)
    pos = torch.arange(bucket, dtype=torch.int32, device=v.device).expand(v.shape)
    end_rank = torch.where(is_end, run_id, run_bucket)
    run_vals, end_pos = compact_by_rank(end_rank, (v, pos), run_bucket)
    keep = (torch.arange(run_bucket, device=v.device)
            < is_end.sum(-1, keepdim=True))
    prev = torch.cat([end_pos.new_full((end_pos.shape[0], 1), -1),
                      end_pos[:, :-1]], dim=1)
    return run_vals, torch.where(keep, end_pos - prev, 0)
