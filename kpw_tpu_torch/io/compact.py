"""Small-file compaction service: merge published under-size files into
~target-size files, without ever putting the at-least-once contract at risk.

Rotation × partitions × workers is the classic small-file explosion: a
partitioned streaming writer (``Builder.partition_by``) multiplies every
rotation across its live partitions, and scan cost downstream is dominated
by file/page layout, not bytes.  :class:`Compactor` is the tier behind the
writer that pays that debt back — a background service (modeled on the
``io/failover.py`` reconciler loop) that repeatedly:

1. **Scans** closed published ``.parquet`` files per directory (per
   partition in a partitioned layout; the flat root works too), excluding
   the writer's working subtrees (``tmp/``, ``quarantine/``,
   ``compacted/``, ``deadletter/``).
2. **Plans** merges: files under ``small_file_ratio * target_size`` are
   binned, in name order (time order under the writer's naming scheme),
   into groups of ``>= min_files`` whose sum approaches ``target_size``.
3. **Rewrites** each group through the existing encode machinery
   (pyarrow read-back -> protobuf messages -> ``runtime.ParquetFile``
   encode) into one merged tmp under ``{target_dir}/tmp/``.
4. **Verifies** the merged tmp with the independent structural verifier
   (``io/verify.py``) — including an exact row-count match against the
   inputs — BEFORE any publish.  A tmp that fails is quarantined (moved,
   never deleted) and the inputs are left untouched.
5. **Publishes** via ``durable_rename`` and only THEN **retires** the
   inputs — moved into the ``{target_dir}/compacted/`` tombstone tree
   (never deleted in place), so a ``kill -9`` at any instant leaves every
   row in at least one verified published file.

Crash consistency rides a tiny write-ahead plan: before the publish, the
group's manifest (inputs, output, rows) is durably written under
``{target_dir}/compacted/.plans/``; :meth:`recover` (run at service start
and before every round) rolls a surviving plan forward (output verified ->
finish retiring the inputs, so a duplicate-published final never outlives
the next startup) or back (output missing/torn -> quarantine the torn
output, restore any already-retired inputs from their tombstones, drop the
plan).  The merged-tmp sweep only touches THIS instance's
``{instance}_compact_*.tmp`` names, mirroring the writer's scoped tmp GC.

Meters (canonical, ``runtime/metrics.py``): ``parquet.compactor.merged``
(merge outputs published), ``parquet.compactor.retired`` (inputs
tombstoned), ``parquet.compactor.failed`` (verify failures + aborted merge
attempts).  :meth:`compactor_stats` is surfaced as
``writer.stats()["compactor"]`` when ``Builder.compaction`` is configured.
"""

from __future__ import annotations

import json
import logging
import random
import re
import threading
import time

from .fs import FileSystem, publish_file
from .verify import verify_file

logger = logging.getLogger(__name__)

# subtrees never scanned for merge inputs: the writer's working dirs plus
# this service's own tombstone tree
EXCLUDE_DIRS = ("tmp", "quarantine", "compacted", "deadletter")
_PLANS_SUBDIR = "compacted/.plans"


def _parent(path: str) -> str:
    return path.rsplit("/", 1)[0] if "/" in path else "."


def _basename(path: str) -> str:
    return path.rsplit("/", 1)[-1]


class MergeGroup:
    """One planned merge: ``inputs`` (>= min_files published small files,
    name order) in directory ``dir``, ``rows``/``bytes`` summed from their
    verified footers."""

    __slots__ = ("dir", "inputs", "rows", "bytes")

    def __init__(self, dir: str, inputs: list[str], rows: int,
                 nbytes: int) -> None:
        self.dir = dir
        self.inputs = inputs
        self.rows = rows
        self.bytes = nbytes


class Compactor:
    """Background small-file compaction over one writer target directory.

    Parameters
    ----------
    fs, target_dir:
        The writer's sink filesystem and target directory.
    proto_class, properties:
        The writer's message class and ``WriterProperties`` — the rewrite
        runs through the exact same encode machinery as the writer (CPU
        encoder; compaction is a background tier, not the hot path).
    target_size:
        Merged files aim at this many bytes (default 128 MiB).
    small_file_ratio:
        A published file below ``small_file_ratio * target_size`` is a
        merge candidate (default 0.5 — an already-compacted output near
        the target never re-enters the plan).
    min_files:
        Never merge fewer than this many inputs (default 2; a lone small
        file stays as is — merging it would rewrite bytes for nothing).
    scan_interval_s:
        Background loop cadence (``start()``); ``compact_once()`` is the
        synchronous single-round entry tests and benches drive.
    registry:
        Optional ``MetricRegistry`` for the canonical compactor meters.
    instance_name:
        Scopes this service's tmp names and the stale-tmp sweep.
    sort_by:
        Sort-on-compact: ``None`` preserves input row order (name-order
        concatenation); a field name — or ``(field_name, descending)`` —
        physically re-sorts every merged output by that proto field and
        declares it as ``sorting_columns`` row-group metadata
        (core/metadata.py), so compaction is where streaming output
        acquires the sort order selective readers exploit.  Null field
        values sort last.  The merged tmp must then pass the structural
        verifier's sort-vs-page-index consistency check AND declare every
        row group sorted before it publishes — a buggy sort can never
        reach readers.
    bandwidth_bytes_per_s / request_budget_per_round / partition_quota:
        The REMOTE tier (object-store targets, where compaction traffic
        shares the fleet's network and every request is billed):
        ``bandwidth_bytes_per_s`` throttles merge READS and merge-output
        WRITES through one shared token bucket
        (``io/objectstore.py`` :class:`BandwidthBudget` — observed
        throughput stays <= budget); ``request_budget_per_round`` defers
        further merge groups once a round has issued that many
        filesystem requests; ``partition_quota`` caps merge groups
        executed per partition directory per round so one hot partition
        cannot monopolize the round.  All None by default (local tier:
        no throttling, no accounting wrapper on the hot path).
    """

    def __init__(self, fs: FileSystem, target_dir: str, proto_class,
                 properties, *, target_size: int = 128 * 1024 * 1024,
                 small_file_ratio: float = 0.5, min_files: int = 2,
                 scan_interval_s: float = 5.0, registry=None,
                 instance_name: str = "compactor",
                 batch_size: int = 4096,
                 sort_by=None,
                 bandwidth_bytes_per_s: float | None = None,
                 request_budget_per_round: int | None = None,
                 partition_quota: int | None = None,
                 bandwidth_budget=None) -> None:
        # runtime imports are deferred: io.compact can be imported while
        # the runtime package is still mid-initialization
        from ..models.proto_bridge import ProtoColumnarizer
        from ..runtime import metrics as M

        if min_files < 2:
            raise ValueError("min_files must be >= 2")
        if not 0.0 < small_file_ratio <= 1.0:
            raise ValueError("small_file_ratio must be in (0, 1]")
        if target_size <= 0:
            raise ValueError("target_size must be positive")
        # sort-on-compact: the merge rewrites through writer properties
        # that DECLARE the order (core/metadata.py SortingColumn), so the
        # merged footer carries sorting_columns and the verifier's
        # boundary-order cross-check guards the publish
        self._columnarizer = ProtoColumnarizer(proto_class)
        self.sort_by: str | None = None
        self.sort_descending = False
        if sort_by is not None:
            if isinstance(sort_by, (tuple, list)):
                if not 1 <= len(sort_by) <= 2:
                    raise ValueError(
                        "sort_by tuple must be (field,) or "
                        f"(field, descending), got {sort_by!r}")
                self.sort_by = sort_by[0]
                self.sort_descending = (bool(sort_by[1])
                                        if len(sort_by) == 2 else False)
            else:
                self.sort_by = sort_by
            # fail at construction, not inside every background merge
            # round: an unknown name would otherwise raise from the
            # rewrite's ParquetFile after the tmp sink is already open,
            # and _run would log-and-retry it forever
            leaf = next((c for c in self._columnarizer.schema.columns
                         if c.name == self.sort_by
                         or ".".join(c.path) == self.sort_by), None)
            if leaf is None:
                raise ValueError(
                    f"sort_by column {self.sort_by!r} is not a schema "
                    "leaf (have "
                    f"{[c.name for c in self._columnarizer.schema.columns]})")
            if leaf.max_rep > 0:
                raise ValueError(
                    f"sort_by column {self.sort_by!r} is repeated — a "
                    "row has no single value to order by")
            # the rewrite sorts pyarrow row dicts: a nested leaf lives at
            # row[seg0][seg1]..., keyed by the declared dotted path
            self._sort_path = tuple(leaf.path)
            import dataclasses

            # write_page_index is forced ON with the declaration: the
            # verifier's declared-order-vs-page-stats cross-check only
            # exists against a ColumnIndex, and without it the
            # verify-before-publish sort gate would be vacuous
            properties = dataclasses.replace(
                properties,
                write_page_index=True,
                sorting_columns=((self.sort_by, self.sort_descending,
                                  False),))
        if bandwidth_bytes_per_s is not None and bandwidth_bytes_per_s <= 0:
            raise ValueError("bandwidth_bytes_per_s must be positive")
        if (request_budget_per_round is not None
                and request_budget_per_round < 1):
            raise ValueError("request_budget_per_round must be >= 1")
        if partition_quota is not None and partition_quota < 1:
            raise ValueError("partition_quota must be >= 1")
        self.bandwidth_bytes_per_s = bandwidth_bytes_per_s
        self.request_budget_per_round = request_budget_per_round
        self.partition_quota = partition_quota
        self._budget = None
        if (bandwidth_budget is not None
                or bandwidth_bytes_per_s is not None
                or request_budget_per_round):
            # remote tier: wrap the sink in the byte-throttling +
            # request-counting composite (reads and writes draw from ONE
            # token bucket, so total traffic stays under the budget).
            # ``bandwidth_budget`` is a caller-owned BandwidthBudget —
            # the multi-tenant compaction service passes ONE bucket to
            # every route's compactor so the merged background traffic
            # shares a single cap instead of multiplying per tenant.
            from .objectstore import (BandwidthBudget,
                                      BandwidthBudgetedFileSystem)

            if bandwidth_budget is not None:
                self._budget = bandwidth_budget
                # surface the SHARED bucket's rate in compactor_stats'
                # remote block (this compactor draws from it even though
                # no per-compactor rate was configured)
                self.bandwidth_bytes_per_s = bandwidth_budget.rate
            elif bandwidth_bytes_per_s is not None:
                self._budget = BandwidthBudget(bandwidth_bytes_per_s)
            fs = BandwidthBudgetedFileSystem(fs, self._budget)
        self.fs = fs
        self.target_dir = target_dir.rstrip("/")
        self.proto_class = proto_class
        self.properties = properties
        self.target_size = target_size
        self.small_file_ratio = small_file_ratio
        self.min_files = min_files
        self.scan_interval_s = scan_interval_s
        self.instance_name = instance_name
        self.batch_size = batch_size
        self._merged_meter = (registry.meter(M.COMPACTOR_MERGED_METER)
                              if registry else M.Meter())
        self._retired_meter = (registry.meter(M.COMPACTOR_RETIRED_METER)
                               if registry else M.Meter())
        self._failed_meter = (registry.meter(M.COMPACTOR_FAILED_METER)
                              if registry else M.Meter())
        # counters guarded by _mu; NO filesystem op ever runs under it
        # (lock-discipline: fs calls block, and the lint/lockcheck gates
        # reject blocking ops under a held package lock)
        self._mu = threading.Lock()
        self._rounds = 0
        self._bytes_rewritten = 0
        self._rows_rewritten = 0
        self._recovered_forward = 0
        self._recovered_rollback = 0
        self._last_round: dict = {}
        self._closed = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Start the background scan loop (recover() first, then one
        round per ``scan_interval_s``)."""
        if self._thread is not None:
            raise ValueError("compactor already started")
        self._thread = threading.Thread(
            target=self._loop, name=f"KPW-compactor-{self.instance_name}",
            daemon=True)
        self._thread.start()

    def close(self, timeout: float = 5.0) -> None:
        """Stop the loop.  A round in flight finishes its current group
        (the plan protocol makes any interruption recoverable anyway)."""
        self._closed.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=timeout)

    def _loop(self) -> None:
        while not self._closed.is_set():
            try:
                self.recover()
                self.compact_once()
            except Exception:
                logger.exception("compactor round failed (will retry)")
            if self._closed.wait(self.scan_interval_s):
                return

    # -- scan + plan ---------------------------------------------------------
    def _excluded(self) -> tuple:
        return tuple(f"{self.target_dir}/{d}/" for d in EXCLUDE_DIRS)

    def scan(self) -> dict[str, list[tuple[str, int]]]:
        """Published small files grouped by directory: ``{dir: [(path,
        size), ...]}``, name-sorted, working subtrees excluded."""
        threshold = int(self.target_size * self.small_file_ratio)
        skips = self._excluded()
        groups: dict[str, list[tuple[str, int]]] = {}
        for p in self.fs.list_files(self.target_dir, extension=".parquet",
                                    recursive=True):
            if any(p.startswith(s) for s in skips):
                continue
            try:
                size = self.fs.size(p)
            except OSError:
                continue  # racing a concurrent rename/quarantine
            if size >= threshold:
                continue
            groups.setdefault(_parent(p), []).append((p, size))
        for files in groups.values():
            files.sort()
        return groups

    def plan(self) -> list[MergeGroup]:
        """Greedy name-order bin pack of each directory's small files into
        merge groups: a group closes when adding the next file would cross
        ``1.25 * target_size``; groups under ``min_files`` are dropped —
        BEFORE any verification, so the steady-state leftovers (a lone
        small file per partition) cost zero re-read per round.  Members of
        viable groups are then structurally verified; an unverifiable
        input is skipped (left for the writer's quarantine machinery,
        which owns condemnation), never merged, and a group that shrinks
        below ``min_files`` is dropped."""
        out: list[MergeGroup] = []
        for d, files in sorted(self.scan().items()):
            raw: list[list[tuple[str, int]]] = [[]]
            cur_bytes = 0
            for path, size in files:
                if raw[-1] and cur_bytes + size > self.target_size * 1.25:
                    raw.append([])
                    cur_bytes = 0
                raw[-1].append((path, size))
                cur_bytes += size
            for grp in raw:
                if len(grp) < self.min_files:
                    continue
                inputs: list[str] = []
                rows = nbytes = 0
                for path, size in grp:
                    rep = verify_file(self.fs, path)
                    if not rep.ok or rep.num_rows is None:
                        logger.warning(
                            "compactor: input %s failed structural "
                            "verification (%s); skipping it (never merged,"
                            " never touched)", path, rep.errors[:2])
                        continue
                    inputs.append(path)
                    rows += rep.num_rows
                    nbytes += size
                if len(inputs) >= self.min_files:
                    out.append(MergeGroup(d, inputs, rows, nbytes))
        return out

    # -- execute -------------------------------------------------------------
    def compact_once(self) -> dict:
        """One synchronous planning + merge round.  Returns a summary dict
        (also kept as ``compactor_stats()['last_round']``).  An OSError
        mid-round aborts the remaining groups — the sink is sick, and the
        next round (after ``recover()``) resumes where the plans left
        off."""
        groups = self.plan()
        summary = {"planned_groups": len(groups), "merged": 0, "retired": 0,
                   "failed": 0, "rows": 0, "bytes_in": 0,
                   "deferred_quota": 0, "deferred_requests": 0}
        req0 = (self.fs.requests_total()
                if hasattr(self.fs, "requests_total") else 0)
        per_dir: dict[str, int] = {}
        for g in groups:
            if self._closed.is_set():
                break
            # remote-tier gates: per-partition quota (one hot partition
            # must not monopolize the round) and the per-round request
            # budget (deferred groups re-plan next round — the inputs
            # are untouched, so deferral is always safe)
            if (self.partition_quota is not None
                    and per_dir.get(g.dir, 0) >= self.partition_quota):
                summary["deferred_quota"] += 1
                continue
            if (self.request_budget_per_round is not None
                    and (self.fs.requests_total() - req0
                         >= self.request_budget_per_round)):
                summary["deferred_requests"] += 1
                continue
            per_dir[g.dir] = per_dir.get(g.dir, 0) + 1
            try:
                retired = self._execute(g)
                if retired is None:
                    summary["failed"] += 1
                else:
                    summary["merged"] += 1
                    summary["retired"] += retired
                    summary["rows"] += g.rows
                    summary["bytes_in"] += g.bytes
            except OSError as e:
                self._failed_meter.mark()
                summary["failed"] += 1
                logger.warning("compactor: merge round aborted on %r; "
                               "plans recover next round", e)
                break
        if hasattr(self.fs, "requests_total"):
            summary["requests_used"] = self.fs.requests_total() - req0
        with self._mu:
            self._rounds += 1
            self._last_round = dict(summary)
        return summary

    def _execute(self, g: MergeGroup):
        """Merge one group.  Order is the correctness protocol: rewrite ->
        verify tmp -> durable plan -> durable publish -> retire inputs ->
        drop plan.  Returns the number of inputs retired (the merge
        PUBLISHED; a shortfall keeps the plan for recover()), or None when
        the merged tmp failed verification (tmp quarantined, inputs
        untouched, nothing published)."""
        from ..utils.tracing import stage

        tmp = (f"{self.target_dir}/tmp/"
               f"{self.instance_name}_compact_{random.getrandbits(63)}.tmp")
        self.fs.mkdirs(f"{self.target_dir}/tmp")
        with stage("compactor.merge"):
            rows = self._rewrite(g.inputs, tmp)
        rep = verify_file(self.fs, tmp)
        # sort-on-compact publishes only outputs whose EVERY row group
        # both declares the order and survives the verifier's
        # boundary-order cross-check (a silent sort bug must quarantine,
        # not publish)
        unsorted = (self.sort_by is not None
                    and rep.sorted_row_groups != rep.row_groups)
        if not rep.ok or rep.num_rows != g.rows or rows != g.rows \
                or unsorted:
            self._failed_meter.mark()
            qpath = self._quarantine(tmp)
            logger.error(
                "compactor: merged tmp for %s failed verification "
                "(rows %s/%s vs %s expected, sorted_rgs %s/%s, errors %s);"
                " quarantined to %s, inputs untouched", g.dir,
                rep.num_rows, rows, g.rows, rep.sorted_row_groups,
                rep.row_groups, rep.errors[:3], qpath)
            return None
        dest = self._output_path(g)
        # tombstone destinations are fixed HERE and recorded in the plan:
        # retire and crash-rollback must agree on where each input went.
        # The plan also records the merged TMP: on an object-store target
        # that is the staging key of an uncompleted multipart upload, and
        # recovery must be able to abort it deterministically
        pairs = [(p, self._tombstone_path(p)) for p in g.inputs]
        self._write_plan(dest, g, pairs, tmp)
        # the one publish decision point (io/fs.py): durable_rename on
        # rename-capable sinks, multipart-complete on object stores
        publish_file(self.fs, tmp, dest)
        self._merged_meter.mark()
        retired = self._retire(pairs)
        if retired == len(pairs):
            self._drop_plan(dest)
        else:
            # a partially-retired group keeps its plan: recover() owns
            # finishing the retire, and dropping the plan here would make
            # the remaining duplicate-published inputs permanent
            logger.warning("compactor: plan for %s kept (retire "
                           "incomplete; recover() finishes it)", dest)
        with self._mu:
            self._bytes_rewritten += g.bytes
            self._rows_rewritten += g.rows
        logger.info("compactor: merged %d file(s) (%d rows) -> %s; %d/%d "
                    "inputs retired to compacted/", len(g.inputs), g.rows,
                    dest, retired, len(pairs))
        return retired

    def _rewrite(self, inputs: list[str], tmp_path: str) -> int:
        """Read every input row (pyarrow read-back — the reader dep lives
        here, off the writer hot path) and re-encode the union through the
        writer's own machinery into ``tmp_path``.  With ``sort_by`` the
        union is materialized and sorted by the field first (nulls last) —
        the group is bounded by ``target_size``, so the sort buffer is
        too.  Returns rows written."""
        import pyarrow.parquet as pq

        from ..runtime.parquet_file import ParquetFile

        pf = ParquetFile(self.fs, tmp_path, self._columnarizer,
                         self.properties, batch_size=self.batch_size)
        rows = 0
        try:
            if self.sort_by is not None:
                union: list[dict] = []
                for path in inputs:
                    with self.fs.open_read(path) as f:
                        union.extend(pq.read_table(f).to_pylist())

                # pyarrow rows are NESTED dicts: a dotted sort leaf lives
                # at row[seg0][seg1]... (r.get("a.b") is always None).
                # NaN keys bucket with the nulls: list.sort with NaN keys
                # leaves non-NaN elements arbitrarily ordered (every
                # comparison is False), which would publish-attempt an
                # unsorted-but-declared output the verify gate quarantines
                # on every re-planned round — and page-stat min/max mask
                # NaNs anyway, so "last, with the nulls" is the one
                # ordering the declaration can actually be checked against
                def sort_value(r):
                    for seg in self._sort_path:
                        if not isinstance(r, dict):
                            return None
                        r = r.get(seg)
                    if isinstance(r, float) and r != r:
                        return None
                    return r

                present = [r for r in union if sort_value(r) is not None]
                absent = [r for r in union if sort_value(r) is None]
                present.sort(key=sort_value,
                             reverse=self.sort_descending)
                for row in present + absent:  # nulls last
                    pf.append_record(row_to_message(self.proto_class, row))
                    pf.flush_if_full()
                    rows += 1
            else:
                for path in inputs:
                    with self.fs.open_read(path) as f:
                        table = pq.read_table(f)
                    msgs = [row_to_message(self.proto_class, row)
                            for row in table.to_pylist()]
                    pf.append_records(msgs)
                    pf.flush_if_full()
                    rows += len(msgs)
            pf.close()
        except Exception:
            # free the sink on any failure; the torn tmp is swept by
            # recover()'s scoped tmp GC (never published: no rename ran)
            pf.abandon()
            raise
        return rows

    def _output_path(self, g: MergeGroup) -> str:
        """Merged destination in the group's own directory, named from the
        FIRST input (time order preserved for readers sorting by name)
        with a ``compacted`` tag; collisions get a numeric suffix.  An
        input that is itself a previous merge output contributes its BARE
        stem — re-merging under ongoing ingest must not grow
        ``-compacted-compacted-…`` names without bound (a long-running
        service would eventually hit the filesystem name limit)."""
        stem = _basename(g.inputs[0])
        stem = stem[:-len(".parquet")] if stem.endswith(".parquet") else stem
        stem = re.sub(r"(?:-compacted(?:-\d+)?)+$", "", stem)
        dest = f"{g.dir}/{stem}-compacted.parquet"
        seq = 0
        while self.fs.exists(dest):
            seq += 1
            dest = f"{g.dir}/{stem}-compacted-{seq}.parquet"
        return dest

    def _retire(self, pairs: list[tuple[str, str]]) -> int:
        """Tombstone every input under ``{target_dir}/compacted/`` —
        renamed, NEVER deleted (retired bytes are evidence and the crash
        rollback's restore source).  The relative directory layout is
        preserved so a tombstone is traceable to its partition.  Returns
        how many inputs were retired."""
        retired = 0
        for path, dest in pairs:
            try:
                self.fs.mkdirs(_parent(dest))
                self.fs.rename(path, dest)
                self._retired_meter.mark()
                retired += 1
            except OSError as e:
                # the plan survives until every input is retired; the
                # next recover() finishes the job
                logger.warning("compactor: could not retire %s (%r); "
                               "recover() will finish it", path, e)
        return retired

    def _tombstone_path(self, path: str) -> str:
        rel = path[len(self.target_dir) + 1:] if path.startswith(
            self.target_dir + "/") else _basename(path)
        dest = f"{self.target_dir}/compacted/{rel}"
        seq = 0
        while self.fs.exists(dest):
            seq += 1
            dest = f"{self.target_dir}/compacted/{rel}.{seq}"
        return dest

    def _quarantine(self, path: str) -> str:
        qdir = f"{self.target_dir}/quarantine"
        self.fs.mkdirs(qdir)
        dest = f"{qdir}/{_basename(path)}"
        seq = 0
        while self.fs.exists(dest):
            seq += 1
            dest = f"{qdir}/{_basename(path)}.{seq}"
        self.fs.rename(path, dest)
        return dest

    # -- write-ahead plan ----------------------------------------------------
    def _plans_dir(self) -> str:
        return f"{self.target_dir}/{_PLANS_SUBDIR}"

    def _plan_path(self, dest: str) -> str:
        # one plan per output, keyed by the output's TARGET-RELATIVE path
        # (flattened): two partitions routinely produce outputs with the
        # same basename, and colliding plan names would let one group's
        # cleanup delete another group's still-needed plan
        rel = (dest[len(self.target_dir) + 1:]
               if dest.startswith(self.target_dir + "/")
               else _basename(dest))
        return f"{self._plans_dir()}/{rel.replace('/', '__')}.plan.json"

    def _write_plan(self, dest: str, g: MergeGroup,
                    pairs: list[tuple[str, str]],
                    merge_tmp: str | None = None) -> None:
        """Durably record the merge BEFORE its publish: a crash after the
        publish can then always finish retiring the inputs instead of
        leaving duplicate-published finals forever.  ``merge_tmp`` (the
        staged merge output) rides along so a crash BETWEEN parts and
        complete on an object-store target resolves deterministically:
        rollback aborts exactly the upload the plan names."""
        self.fs.mkdirs(self._plans_dir())
        path = self._plan_path(dest)
        tmp = f"{path}.tmp"
        with self.fs.open_write(tmp) as f:
            f.write(json.dumps({
                "output": dest,
                "inputs": [{"path": p, "tombstone": t} for p, t in pairs],
                "rows": g.rows,
                "tmp": merge_tmp,
                "instance": self.instance_name,
            }).encode())
        publish_file(self.fs, tmp, path)

    def _drop_plan(self, dest: str) -> None:
        try:
            self.fs.delete(self._plan_path(dest))
        except OSError:
            logger.warning("compactor: plan for %s not deletable; "
                           "recover() re-resolves it (idempotent)", dest)

    def recover(self) -> dict:
        """Resolve every surviving write-ahead plan, then sweep this
        instance's stale merged tmps.  Forward: the output exists and
        verifies -> finish retiring its inputs (a duplicate-published
        final must not outlive recovery).  Rollback: the output is
        missing or torn -> quarantine a torn output, restore any
        already-retired inputs from their tombstones, drop the plan —
        every row stays in at least one verified published file
        throughout."""
        out = {"plans": 0, "rolled_forward": 0, "rolled_back": 0,
               "tmp_swept": 0}
        try:
            plans = self.fs.list_files(self._plans_dir(),
                                       extension=".plan.json",
                                       recursive=False)
        except OSError:
            plans = []
        for ppath in plans:
            out["plans"] += 1
            try:
                with self.fs.open_read(ppath) as f:
                    plan = json.loads(f.read().decode())
            except (OSError, KeyError, ValueError) as e:
                logger.error("compactor: unreadable plan %s (%r); leaving "
                             "it for inspection", ppath, e)
                continue
            forward, resolved = self._resolve_plan(plan)
            if forward:
                out["rolled_forward"] += 1
            else:
                out["rolled_back"] += 1
            if not resolved:
                # a retire/restore rename failed: the plan must survive
                # — dropping it now would make the half-state permanent
                # (a duplicate-published final, or rows visible only
                # under compacted/); the next round retries
                logger.warning("compactor: plan %s only partially "
                               "resolved; kept for the next round", ppath)
                continue
            try:
                self.fs.delete(ppath)
            except OSError:
                logger.warning("compactor: resolved plan %s not deletable",
                               ppath)
        out["tmp_swept"] = self._sweep_tmps()
        if out["plans"] or out["tmp_swept"]:
            with self._mu:
                self._recovered_forward += out["rolled_forward"]
                self._recovered_rollback += out["rolled_back"]
            logger.info("compactor recover: %s", out)
        return out

    def _resolve_plan(self, plan: dict) -> tuple[bool, bool]:
        """(rolled_forward, fully_resolved).  ``fully_resolved`` False
        means a retire/restore rename failed and the plan must be KEPT so
        the next round retries — idempotent in both directions (the
        quarantine of a torn output happens at most once; remaining
        retires/restores are re-derived from what still exists).

        The multipart crash window (object-store targets): a crash
        BETWEEN parts and complete leaves the plan, no output, and an
        orphaned multipart upload at the plan's recorded ``tmp`` key —
        rolled BACK deterministically (the upload is aborted via the
        fs delete seam, the inputs were never retired); a crash AFTER
        complete rolls FORWARD exactly like the rename protocol (the
        output verifies, retiring finishes).  Aborted-or-completed, from
        the write-ahead plan alone."""
        output = plan["output"]
        if self.fs.exists(output) and verify_file(self.fs, output).ok:
            pending = [(inp["path"], inp["tombstone"])
                       for inp in plan["inputs"]
                       if self.fs.exists(inp["path"])]
            return True, self._retire(pending) == len(pending)
        merge_tmp = plan.get("tmp")
        if merge_tmp and self.fs.exists(merge_tmp):
            # the staged merge output the publish never completed: on an
            # object store this ABORTS the orphaned multipart upload (and
            # on a posix sink it sweeps the torn tmp) — the inputs are
            # still published, so dropping the stage loses nothing
            try:
                self.fs.delete(merge_tmp)
                logger.info("compactor: aborted orphaned merge stage %s "
                            "from its write-ahead plan", merge_tmp)
            except OSError as e:
                logger.warning("compactor: could not abort orphaned merge "
                               "stage %s (%r); the scoped tmp sweep "
                               "retries", merge_tmp, e)
        if self.fs.exists(output):
            # torn publish: condemned, never deleted
            self._failed_meter.mark()
            qpath = self._quarantine(output)
            logger.error("compactor: planned output %s failed verification"
                         " after a crash; quarantined to %s", output, qpath)
        resolved = True
        for inp in plan["inputs"]:
            # restore retired inputs: their rows are no longer covered by
            # a published output
            if not self.fs.exists(inp["path"]) and self.fs.exists(
                    inp["tombstone"]):
                try:
                    self.fs.rename(inp["tombstone"], inp["path"])
                except OSError as e:
                    resolved = False
                    logger.error("compactor: could not restore %s from its "
                                 "tombstone (%r); plan kept, retried next "
                                 "round", inp["path"], e)
        return False, resolved

    def _sweep_tmps(self) -> int:
        """Remove THIS instance's abandoned merged tmps (the scoped
        pattern the writer's own GC uses: other instances sharing the
        directory keep their live files)."""
        pat = re.compile(re.escape(self.instance_name) + r"_compact_\d+\.tmp$")
        try:
            stale = [p for p in self.fs.list_files(
                f"{self.target_dir}/tmp", extension=".tmp", recursive=True)
                if pat.fullmatch(_basename(p))]
        except OSError:
            return 0
        swept = 0
        for p in stale:
            try:
                self.fs.delete(p)
                swept += 1
            except OSError:
                logger.warning("compactor: could not sweep stale tmp %s", p)
        return swept

    # -- observability -------------------------------------------------------
    def compactor_stats(self) -> dict:
        remote = None
        if (self.bandwidth_bytes_per_s is not None
                or self.request_budget_per_round is not None
                or self.partition_quota is not None):
            remote = {
                "bandwidth_bytes_per_s": self.bandwidth_bytes_per_s,
                "request_budget_per_round": self.request_budget_per_round,
                "partition_quota": self.partition_quota,
                "requests_total": (self.fs.requests_total()
                                   if hasattr(self.fs, "requests_total")
                                   else None),
            }
            if self._budget is not None:
                remote["budget"] = self._budget.observed()
        with self._mu:
            return {
                "remote": remote,
                "running": (self._thread is not None
                            and self._thread.is_alive()),
                "target_size": self.target_size,
                "small_file_threshold": int(self.target_size
                                            * self.small_file_ratio),
                "min_files": self.min_files,
                "sort_by": self.sort_by,
                "sort_descending": self.sort_descending,
                "scan_interval_s": self.scan_interval_s,
                "rounds": self._rounds,
                "merged": self._merged_meter.count,
                "retired": self._retired_meter.count,
                "failed": self._failed_meter.count,
                "bytes_rewritten": self._bytes_rewritten,
                "rows_rewritten": self._rows_rewritten,
                "recovered_forward": self._recovered_forward,
                "recovered_rollback": self._recovered_rollback,
                "last_round": dict(self._last_round),
            }


def row_to_message(cls, row: dict):
    """Reconstruct one protobuf message from a pyarrow row dict (the
    read-back half of the rewrite): nested message fields recurse,
    repeated fields extend, absent/None fields stay unset."""
    msg = cls()
    _fill_message(msg, row)
    return msg


def _is_repeated(fd) -> bool:
    # protobuf >= 5.27 deprecates FieldDescriptor.label for is_repeated
    rep = getattr(fd, "is_repeated", None)
    if rep is None:
        return fd.label == fd.LABEL_REPEATED
    return bool(rep() if callable(rep) else rep)


def _fill_message(msg, row: dict) -> None:
    for fd in msg.DESCRIPTOR.fields:
        if fd.name not in row:
            continue
        v = row[fd.name]
        if v is None:
            continue
        if _is_repeated(fd):
            if fd.type == fd.TYPE_MESSAGE:
                for item in v:
                    _fill_message(getattr(msg, fd.name).add(), item or {})
            else:
                getattr(msg, fd.name).extend(v)
        elif fd.type == fd.TYPE_MESSAGE:
            if isinstance(v, dict):
                sub = getattr(msg, fd.name)
                # presence must survive the rewrite: a set-but-empty
                # submessage reads back as a dict of Nones, and recursing
                # without marking presence would re-encode it as ABSENT —
                # compaction silently changing data
                sub.SetInParent()
                _fill_message(sub, v)
        else:
            setattr(msg, fd.name, v)
