"""The bit-pack kernel's share of its roofline (``csrc/bitpack.cu`` through
``ops/bitpack.py``), in percent.

The work is counted from the published files, not from the program: each
dictionary-encoded data page of n values over a dictionary of k entries
reads n indices of 4 bytes and writes ceil(n * w / 8) packed bytes, with
w = ceil(log2 k).  Its least time is those bytes over the card's 3.35 TB/s.
The kernel's time is the summed device time of the kernels named in
``KERNELS`` that the profiler recorded inside the device phase of the same
row groups: the row groups whose ``rowgroup.launch`` span (``rowgroup.encode``
where the writer encodes a row group whole), which holds all of a row
group's launches and waits for their readbacks, lies in the window,
matched to the files' row groups in publish order (one worker thread
encodes them in that order; any row count that disagrees leaves the metric
unread).
"""

from kpwbench.reference import parquet as pq

KERNELS = ("pack_kernel",)
PEAK_BYTES_PER_S = 3.35e12


def group_work(pf, cols) -> int:
    """Bytes the bit-pack of one row group's dictionary pages moves."""
    work = 0
    for col in cols:
        k = None
        for head, _ in pf.pages(col):
            if head[1] == pq.DICTIONARY_PAGE:
                k = head[7][1]
                continue
            if head[1] == pq.DATA_PAGE:
                n, enc = head[5][1], head[5][2]
            elif head[1] == pq.DATA_PAGE_V2:
                n, enc = head[8][1], head[8][4]
            else:
                continue
            if enc in (pq.PLAIN_DICTIONARY, pq.RLE_DICTIONARY) and k:
                w = (k - 1).bit_length()
                work += 4 * n + (n * w + 7) // 8
    return work


def read(run):
    if not run.device_ops or run.config["thread_count"] != 1:
        return None
    groups = []
    for path, _ in run.files:
        pf = pq.read_footer(path)
        groups += [(rows, cols, pf) for rows, cols in pf.row_groups]
    spans = sorted((s for s in run.spans
                    if s[0] in ("rowgroup.launch", "rowgroup.encode")),
                   key=lambda s: s[1])
    if len(spans) < len(groups):
        return None
    work, inside = 0, []
    for (rows, cols, pf), (_, start, dur, attrs) in zip(groups, spans):
        if (attrs or {}).get("rows") != rows:
            return None
        if run.w0 <= start and start + dur <= run.w1:
            work += group_work(pf, cols)
            inside.append((start, start + dur))
    seconds = sum(d for name, t, d in run.device_ops
                  if any(k in name for k in KERNELS)
                  and any(a <= t < b for a, b in inside))
    if not work or seconds <= 0:
        return None
    return 100.0 * work / PEAK_BYTES_PER_S / seconds
