"""Partitioning seam: record -> relative partition path.

The reference writer emits one flat stream of rotated files per worker;
production ingest serving scan-heavy readers writes Hive-style partitioned
layouts (``dt=20260803/hour=14`` or keyed by a record field) so that
predicate pruning can skip whole directories.  A :class:`Partitioner` maps
one consumed record (the raw broker :class:`~kpw_tpu_torch.ingest.broker.Record`
plus its parsed protobuf message) to a RELATIVE directory path under the
writer's target dir; the worker runtime (``runtime/writer.py``) routes the
record into that partition's open file ahead of file assignment.

Three built-in shapes (``Builder.partition_by`` constructs them):

* :class:`FieldPartitioner` — Hive-style ``{field}={value}`` from one
  protobuf field of the parsed message (multi-field = pass a tuple).
* :class:`EventTimePartitioner` — an integer epoch field bucketed through
  a strftime pattern (``dt=%Y%m%d/hour=%H`` by default); ``unit`` scales
  ``s``/``ms``/``us`` epochs.  Buckets in UTC — partition layout must not
  depend on the writer host's timezone.
* :class:`CallablePartitioner` — any user callable ``(record, message) ->
  str`` for layouts the built-ins cannot express.

Every produced path is normalized through :func:`normalize_partition_path`
before it touches the filesystem: relative, no ``..``/empty segments, and
field values are sanitized to a conservative charset — a partitioner must
never be able to climb out of the target dir or smuggle a path separator
inside one value.  A partitioner that raises is handled by the worker
under the same policy as an unparseable record (``Builder.on_parse_error``):
a record whose partition cannot be derived is the same class of poison
pill as one whose bytes cannot be parsed.
"""

from __future__ import annotations

import re
from datetime import datetime, timezone

# conservative value charset: everything else becomes "_" so a field value
# can never introduce a separator, a relative segment, or shell-hostile
# bytes into the directory layout
_VALUE_BAD = re.compile(r"[^A-Za-z0-9._\-=]")
# one sanitized path SEGMENT: like a value but '=' allowed ("dt=20260803")
# and never "."/".." (normalize_partition_path rejects those explicitly)
_TIME_UNITS = {"s": 1.0, "ms": 1e3, "us": 1e6}
# the writer's working subtrees under the target dir: a partition routed
# here would publish acked data into a tree verify_dir, the compactor
# scan and every convention-following reader EXCLUDE — acked-but-
# invisible rows, rejected up front
RESERVED_SEGMENTS = frozenset(
    ("tmp", "quarantine", "compacted", "deadletter"))


def sanitize_value(value) -> str:
    """One partition VALUE as a safe path fragment (hostile characters
    collapse to ``_``; empty stays visible as ``_``)."""
    s = _VALUE_BAD.sub("_", str(value))
    return s if s else "_"


def normalize_partition_path(path: str) -> str:
    """Validate + normalize a partitioner-produced relative path.

    Accepts ``a/b/c`` shapes; rejects (``ValueError``) anything absolute,
    empty, or containing ``.``/``..``/empty segments — the partitioner is
    user code and must not be able to direct a publish outside the target
    directory.  Segments are NOT re-sanitized here (the built-ins already
    sanitize their values; a CallablePartitioner owns its own charset),
    only structurally validated."""
    if not isinstance(path, str):
        raise ValueError(
            f"partitioner must return a str path, got {type(path).__name__}")
    p = path.strip("/")
    if not p or path.startswith("/") or "\\" in path or "\x00" in path:
        raise ValueError(f"invalid partition path {path!r}: must be a "
                         f"relative, non-empty POSIX path")
    segs = p.split("/")
    for seg in segs:
        if seg in ("", ".", ".."):
            raise ValueError(f"invalid partition path {path!r}: "
                             f"segment {seg!r} not allowed")
    if segs[0] in RESERVED_SEGMENTS:
        raise ValueError(
            f"invalid partition path {path!r}: {segs[0]!r} is a reserved "
            f"working directory of the writer (records routed there would "
            f"be acked but excluded from the published set)")
    return "/".join(segs)


class Partitioner:
    """record -> relative partition path (e.g. ``dt=20260803/hour=14``)."""

    def partition_for(self, record, message) -> str:
        raise NotImplementedError


class FieldPartitioner(Partitioner):
    """Hive-style ``{field}={value}`` from the parsed message's field(s).

    ``fields`` is one field name or a tuple of them (one path segment per
    field, in order): ``("region", "tier")`` -> ``region=eu/tier=gold``."""

    def __init__(self, fields) -> None:
        self.fields = ((fields,) if isinstance(fields, str)
                       else tuple(fields))
        if not self.fields:
            raise ValueError("FieldPartitioner needs at least one field")

    def partition_for(self, record, message) -> str:
        return "/".join(f"{f}={sanitize_value(getattr(message, f))}"
                        for f in self.fields)


class EventTimePartitioner(Partitioner):
    """Epoch field -> strftime-bucketed path, UTC.

    ``field`` must hold an integer/float epoch in ``unit`` (``s``/``ms``/
    ``us``).  Default pattern ``dt=%Y%m%d/hour=%H`` is the classic
    Hive daily/hourly layout."""

    def __init__(self, field: str, pattern: str = "dt=%Y%m%d/hour=%H",
                 unit: str = "s") -> None:
        if unit not in _TIME_UNITS:
            raise ValueError(f"unit must be one of {sorted(_TIME_UNITS)}, "
                             f"got {unit!r}")
        self.field = field
        self.pattern = pattern
        self._div = _TIME_UNITS[unit]

    def partition_for(self, record, message) -> str:
        epoch = getattr(message, self.field) / self._div
        return datetime.fromtimestamp(epoch, tz=timezone.utc).strftime(
            self.pattern)


class CallablePartitioner(Partitioner):
    """Wrap a user callable ``(record, message) -> str``."""

    def __init__(self, fn) -> None:
        if not callable(fn):
            raise TypeError("CallablePartitioner needs a callable")
        self.fn = fn

    def partition_for(self, record, message) -> str:
        return self.fn(record, message)


def make_partitioner(spec) -> Partitioner:
    """Coerce a ``Builder.partition_by`` spec into a Partitioner: a
    Partitioner passes through, a str/tuple becomes a FieldPartitioner,
    any other callable becomes a CallablePartitioner."""
    if isinstance(spec, Partitioner):
        return spec
    if isinstance(spec, (str, tuple, list)):
        return FieldPartitioner(spec)
    if callable(spec):
        return CallablePartitioner(spec)
    raise TypeError(
        f"partition_by expects a field name, a (record, message) callable "
        f"or a Partitioner, got {type(spec).__name__}")
