"""Mean host time of a row group's encode in the window of the live cell, in milliseconds:
``core/writer.py``'s pipelined stages ``rowgroup.launch`` (the
``CudaChunkEncoder`` launches and the bulk readbacks, ``ops/backend.py``)
and ``rowgroup.assemble`` (page bodies and assembly), or ``rowgroup.encode``
where the writer encodes a row group whole.  Row groups are counted by
their launch (or whole-encode) spans."""


def read(run):
    spans = run.window_spans("rowgroup.launch", "rowgroup.assemble", "rowgroup.encode")
    groups = sum(s[0] != "rowgroup.assemble" for s in spans)
    if not groups:
        return None
    return sum(s[2] for s in spans) / groups * 1e3
