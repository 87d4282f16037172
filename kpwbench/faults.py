"""Faults planted under a run, for the control and the harness's own tests:
each breaks the delivery guarantee, or the records, in one way, and the
read-back must then find the run not correct.

- ``alter``: the shredder gets each poll's first record with one bit of its
  first value flipped (a value altered where it is produced);
- ``drop_half``: the shredder gets the first half of each poll's records,
  and the writer acks the whole poll (half of the batch left out);
- ``stale``: every poll shreds to the first poll's rows (a step that
  returns its state unchanged);
- ``drop_file``: after the writer closes, the largest published file is
  deleted (a committed file removed);
- ``flip_file``: after the writer closes, one byte of the largest
  published file's first data page is flipped (a published value altered).

``plant(name)`` returns the ``fault`` callable that ``harness.run_cell``
takes; it patches the shredder when it is given the writer and undoes that
when the writer has closed or the run ends.
"""

from __future__ import annotations

import os

import numpy as np

NAMES = ("alter", "drop_half", "stale", "drop_file", "flip_file")


def _patch_shredder(name: str):
    from kpw_tpu_torch.models.proto_bridge import ProtoColumnarizer

    orig = ProtoColumnarizer.columnarize_buffer
    first = []

    def shred(self, buf, offsets):
        offs = np.asarray(offsets, np.int64)
        if name == "alter" and len(offs) > 1:
            b = bytearray(buf)
            b[int(offs[0]) + 1] ^= 1  # the first field's first value byte
            return orig(self, bytes(b), offs)
        if name == "drop_half" and len(offs) > 2:
            return orig(self, buf, offs[: (len(offs) - 1) // 2 + 1])
        if name == "stale":
            if not first:
                first.append(orig(self, buf, offs))
            return first[0]
        return orig(self, buf, offs)

    ProtoColumnarizer.columnarize_buffer = shred
    return lambda: setattr(ProtoColumnarizer, "columnarize_buffer", orig)


def _largest(target: str) -> str:
    files = [os.path.join(target, f) for f in os.listdir(target) if f.endswith(".parquet")]
    return max(files, key=os.path.getsize)


def _flip(path: str) -> None:
    from .reference import parquet as pq

    pf = pq.read_footer(path)
    col = pf.row_groups[0][1][0]
    with open(path, "r+b") as f:
        f.seek((col.data_offset + col.start + col.compressed_size) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0x10]))


def plant(name: str):
    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r}; there are {NAMES}")
    undo = []

    def fault(when: str, obj) -> None:
        if when == "writer" and name in ("alter", "drop_half", "stale"):
            undo.append(_patch_shredder(name))
        elif when in ("closed", "end"):
            while undo:
                undo.pop()()
        if when == "closed":
            if name == "drop_file":
                os.remove(_largest(obj))
            elif name == "flip_file":
                _flip(_largest(obj))

    return fault
