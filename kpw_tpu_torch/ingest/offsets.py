"""Paged per-partition offset tracking for at-least-once commit.

Semantics rebuilt from the reference's smart-commit consumer configuration
surface (KafkaProtoParquetWriter.java:584-622): delivered offsets are grouped
into fixed-size consecutive *pages*; the committed frontier advances only past
pages whose every delivered offset has been acked; the number of open
(delivered-but-not-fully-acked) pages per partition is bounded and exposed for
backpressure.  Memory is O(open pages), not O(outstanding offsets) — pages
hold numpy bitmaps.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class PartitionOffset:
    """(partition, offset) ack handle — reference PartitionOffset
    (KPW.java:10,233,278)."""

    partition: int
    offset: int


class _Page:
    __slots__ = ("start", "acked", "acked_count", "delivered_end")

    def __init__(self, start: int, size: int) -> None:
        self.start = start
        self.acked = np.zeros(size, bool)
        self.acked_count = 0
        self.delivered_end = start  # exclusive frontier of delivery in page


class _PartitionTracker:
    def __init__(self, page_size: int, base: int) -> None:
        self.page_size = page_size
        self.committed = base  # next offset to commit (all below acked)
        self.delivered = base  # next expected delivery
        self.pages: dict[int, _Page] = {}  # page index -> page

    def _page_for(self, offset: int) -> _Page:
        idx = offset // self.page_size
        page = self.pages.get(idx)
        if page is None:
            page = _Page(idx * self.page_size, self.page_size)
            self.pages[idx] = page
        return page

    def track(self, offset: int) -> None:
        page = self._page_for(offset)
        if offset >= page.delivered_end:
            page.delivered_end = offset + 1
        if offset >= self.delivered:
            self.delivered = offset + 1

    def track_run(self, start: int, count: int) -> None:
        """Track a contiguous run [start, start+count) in O(pages touched)
        instead of O(count) — fetch batches arrive as runs, and per-offset
        tracking was the streaming fetcher's hottest line."""
        end = start + count
        off = start
        while off < end:
            page = self._page_for(off)
            page_end = min(end, page.start + self.page_size)
            if page_end > page.delivered_end:
                page.delivered_end = page_end
            off = page_end
        if end > self.delivered:
            self.delivered = end

    def ack(self, offset: int) -> None:
        if offset < self.committed:
            return  # duplicate delivery from a previous generation
        page = self._page_for(offset)
        slot = offset - page.start
        if not page.acked[slot]:
            page.acked[slot] = True
            page.acked_count += 1

    def ack_run(self, start: int, count: int) -> None:
        """Ack a contiguous run [start, start+count): numpy slice per page
        touched (the worker publishes whole poll batches at once)."""
        end = start + count
        off = max(start, self.committed)  # skip pre-commit duplicates
        while off < end:
            page = self._page_for(off)
            page_end = min(end, page.start + self.page_size)
            a, b = off - page.start, page_end - page.start
            seg = page.acked[a:b]
            newly = (b - a) - int(seg.sum())
            if newly:
                seg[:] = True
                page.acked_count += newly
            off = page_end

    def advance(self) -> int | None:
        """Advance the committed frontier across fully-acked pages (and a
        final partially-delivered page that is fully acked).  Returns the new
        commit offset if it moved."""
        moved = False
        while True:
            idx = self.committed // self.page_size
            page = self.pages.get(idx)
            if page is None:
                break
            delivered_in_page = page.delivered_end - page.start
            if delivered_in_page <= 0:
                break
            # consecutive acked run from the committed position (vectorized:
            # argmin finds the first un-acked flag)
            pos = self.committed - page.start
            sub = page.acked[pos:delivered_in_page]
            pos += len(sub) if sub.all() else int(np.argmin(sub))
            new_commit = page.start + pos
            if new_commit == self.committed:
                break
            self.committed = new_commit
            moved = True
            if pos == self.page_size:
                del self.pages[idx]  # page fully consumed
                continue
            break
        return self.committed if moved else None

    def open_pages(self) -> int:
        return len(self.pages)


class PagedOffsetTracker:
    """All-partition tracker; thread-safe."""

    def __init__(self, page_size: int = 300_000,
                 max_open_pages_per_partition: int = 1) -> None:
        if page_size <= 0:
            raise ValueError("page_size must be positive")
        self.page_size = page_size
        self.max_open_pages = max_open_pages_per_partition
        self._parts: dict[int, _PartitionTracker] = {}
        self._lock = threading.Lock()

    def _part(self, partition: int, base: int = 0) -> _PartitionTracker:
        t = self._parts.get(partition)
        if t is None:
            t = _PartitionTracker(self.page_size, base)
            self._parts[partition] = t
        return t

    def reset_partition(self, partition: int, base: int) -> None:
        with self._lock:
            self._parts[partition] = _PartitionTracker(self.page_size, base)

    def track(self, partition: int, offset: int) -> None:
        with self._lock:
            self._part(partition).track(offset)

    def track_run(self, partition: int, start: int, count: int) -> None:
        with self._lock:
            self._part(partition).track_run(start, count)

    def ack(self, po: PartitionOffset) -> int | None:
        """Record an ack; returns a new commit offset for the partition if
        the frontier advanced."""
        with self._lock:
            t = self._part(po.partition)
            t.ack(po.offset)
            return t.advance()

    def ack_run(self, partition: int, start: int, count: int) -> int | None:
        """Batch ack of a contiguous offset run; returns a new commit offset
        for the partition if the frontier advanced."""
        with self._lock:
            t = self._part(partition)
            t.ack_run(start, count)
            return t.advance()

    def skip_run(self, partition: int, start: int, count: int) -> None:
        """Mark [start, start+count) as never-deliverable (offsets
        compacted away at the source): delivered AND acked in one pass,
        so the commit frontier can cross the hole — an ack alone leaves
        ``delivered_end`` behind on every page the gap covers and
        ``advance()`` would park at the gap page forever (and the stuck
        open pages would trip backpressure permanently).  Any frontier
        advance is committed by the next real ack."""
        if count <= 0:
            return
        with self._lock:
            t = self._part(partition)
            t.track_run(start, count)
            t.ack_run(start, count)

    def committed(self, partition: int) -> int:
        with self._lock:
            return self._part(partition).committed

    def is_backpressured(self, partition: int) -> bool:
        """True when the partition has too many open pages: delivery must
        pause until acks catch up (reference `offsetTrackerMaxOpenPagesPerPartition`)."""
        with self._lock:
            t = self._parts.get(partition)
            if t is None:
                return False
            return t.open_pages() > self.max_open_pages

    def pending(self, partition: int) -> int:
        """Delivered-but-uncommitted count (diagnostics)."""
        with self._lock:
            t = self._parts.get(partition)
            return 0 if t is None else t.delivered - t.committed

    def snapshot(self) -> dict:
        """All-partition ack-frontier snapshot, one lock round: per
        partition the committed / delivered frontiers, the pending
        (delivered-but-uncommitted) gap, and the open-page count that
        drives backpressure — plus pre-summed totals.  ``pending`` is the
        tracker-level ack lag: records the consumer delivered whose
        offsets have not all been acked past the commit frontier yet."""
        with self._lock:
            parts = {
                p: {
                    "committed": t.committed,
                    "delivered": t.delivered,
                    "pending": t.delivered - t.committed,
                    "open_pages": t.open_pages(),
                }
                for p, t in sorted(self._parts.items())
            }
        return {
            "partitions": parts,
            "pending_total": sum(v["pending"] for v in parts.values()),
            "open_pages_total": sum(v["open_pages"] for v in parts.values()),
            "max_open_pages_per_partition": self.max_open_pages,
            "page_size": self.page_size,
        }
