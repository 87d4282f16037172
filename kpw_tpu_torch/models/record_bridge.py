"""Flat record-model bridge: avro-style field specs and plain dict/array
records -> parquet schema + ColumnBatch.

Covers the BASELINE.json benchmark record shapes ("flat Avro schema (8 int64 +
4 string cols)" etc.) without requiring protobuf classes.
"""

from __future__ import annotations

import numpy as np

from ..core.pages import ColumnChunkData
from ..core.schema import PhysicalType, Repetition, Schema, leaf
from ..core.writer import ColumnBatch

from ..core.schema import NUMPY_DTYPES as _NUMPY_DTYPES  # noqa: E402


def flat_schema(fields: list[tuple[str, str] | tuple[str, str, bool]],
                name: str = "record") -> Schema:
    """fields: (name, type_name[, nullable]) with type names from
    core.schema.leaf ('int64', 'string', 'double', ...)."""
    out = []
    for spec in fields:
        fname, tname = spec[0], spec[1]
        nullable = spec[2] if len(spec) > 2 else False
        out.append(leaf(fname, tname,
                        Repetition.OPTIONAL if nullable else Repetition.REQUIRED))
    return Schema(out, name=name)


def arrays_to_batch(schema: Schema, arrays: dict) -> ColumnBatch:
    """{name: ndarray | list[bytes] | (values, valid_mask)} -> ColumnBatch."""
    from ..core.writer import columns_from_arrays

    return columns_from_arrays(schema, arrays)


def dicts_to_batch(schema: Schema, records: list[dict]) -> ColumnBatch:
    """Row-major dict records -> ColumnBatch (None means null for OPTIONAL)."""
    n = len(records)
    chunks = []
    for col in schema.columns:
        key = col.name
        pt = col.leaf.physical_type
        dtype = _NUMPY_DTYPES.get(pt)
        if col.max_def > 0:
            raw = [r.get(key) for r in records]
            valid = np.array([v is not None for v in raw], bool)
            present = [v for v in raw if v is not None]
            def_levels = valid.astype(np.int32) * col.max_def
            values = (np.asarray(present, dtype) if dtype is not None
                      else [_to_bytes(v) for v in present])
            chunks.append(ColumnChunkData(col, values, def_levels, None, n))
        else:
            raw = [r[key] for r in records]
            values = (np.asarray(raw, dtype) if dtype is not None
                      else [_to_bytes(v) for v in raw])
            chunks.append(ColumnChunkData(col, values, None, None, n))
    return ColumnBatch(chunks, n)


def _to_bytes(v) -> bytes:
    if isinstance(v, bytes):
        return v
    return str(v).encode("utf-8")
