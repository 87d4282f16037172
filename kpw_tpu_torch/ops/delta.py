"""DELTA_BINARY_PACKED on the device: the hand-written CUDA kernel
``csrc/delta.cu`` and its plain PyTorch version, and the page header the
host adds (``core.encodings.delta_binary_packed_encode`` is the byte
oracle).

The format: a header (block size 128, 4 miniblocks, the value count, the
zigzag first value), then blocks of 128 deltas, 4 miniblocks of 32: a
signed (zigzag) minimum delta a block, a bit width a miniblock, and each
miniblock's ``delta - min`` values packed LSB-first at its own width.  One
launch (:func:`delta_page_streams`) writes the finished block stream of
every page of a ring, back to back, with each page's byte offset; the host
adds the header, which it knows already, and hands the page on as
[header, view of the readback] (:func:`page_parts`): no Python work per
block.

Values travel in their ring's own type: int64 for the 64-bit ring, int32
for the 32-bit ring, whose deltas wrap at 32 bits.  (The JAX package splits
64-bit values into (hi, lo) uint32 planes because the TPU has no int64.)
``max_bits``, a bound on every miniblock width that the host derives from
the stream's value range (:func:`delta_bits_bucket`), sizes the output; a
wider miniblock means the bound was wrong, and :func:`check_budget` raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.bytecol import lens_and_payload
from ..core.thrift import varint_bytes, zigzag
from ..device import cuda_launch_args, resolve_device, to_host
from . import _build

_BLOCK = 128
_MINI = 4
_MB = 32  # values per miniblock
_VARINT_MAX = 10  # bytes of a 64-bit ULEB128 varint

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        _fn = _build.function("delta", "kpw_delta_streams", [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    return _fn


# Width-budget buckets: the output capacity follows the bucket, so finer
# steps at the narrow end (near-sorted timestamps, string lengths) matter
# most.
_DELTA_BITS_BUCKETS = (8, 16, 24, 32, 48, 64)


def delta_bits_bucket(value_range: int, bit_size: int) -> int:
    """Smallest width-budget bucket covering every miniblock width of a
    stream whose values span ``value_range`` = vmax - vmin (Python ints, no
    ring overflow).  Any delta lies in [-range, range] and the packed
    relative deltas in [0, 2*range], so ``bit_length(2*range)`` bounds every
    width.  Ranges wide enough to wrap the signed ring take the full
    ``bit_size``."""
    if value_range < 0:
        raise ValueError("value_range must be >= 0")
    need = max((2 * value_range).bit_length(), 1)
    for b in _DELTA_BITS_BUCKETS:
        if need <= b <= bit_size:
            return b
    return bit_size


def _ring_dtype(bit_size: int) -> torch.dtype:
    if bit_size == 64:
        return torch.int64
    if bit_size == 32:
        return torch.int32
    raise ValueError(f"bit_size must be 32 or 64, got {bit_size}")


def block_bytes(max_bits: int) -> int:
    """The most bytes one block can take when no width exceeds
    ``max_bits``: the varint, four widths and four miniblocks."""
    return _VARINT_MAX + _MINI + _MINI * 4 * max_bits


def _plan(streams: torch.Tensor, table, bit_size: int, max_bits: int):
    """Check the arguments; returns the host page table (P, 3) int64, the
    block prefix bstart (P + 1) int64 and the output capacity in bytes."""
    if streams.dim() != 2 or streams.dtype != _ring_dtype(bit_size):
        raise TypeError(f"streams must be 2-D {_ring_dtype(bit_size)} for the "
                        f"{bit_size}-bit ring, got {tuple(streams.shape)} "
                        f"{streams.dtype}")
    if not 1 <= max_bits <= bit_size:
        raise ValueError(f"max_bits must be 1..{bit_size}, got {max_bits}")
    if isinstance(table, torch.Tensor):
        if table.device.type != "cpu":
            raise ValueError("the page table must be on the host: its counts "
                             "size the launch")
        table = table.numpy()
    tab = np.asarray(table, np.int64)
    if tab.ndim != 2 or tab.shape[1] != 3:
        raise ValueError(f"the page table must be (P, 3) (row, start, count), "
                         f"got shape {tab.shape}")
    if tab.size and (tab.min() < 0 or tab.max() > np.iinfo(np.int32).max):
        raise ValueError("the page table's rows, starts and counts must be "
                         "int32 and >= 0")
    blocks = (np.maximum(tab[:, 2] - 1, 0) + _BLOCK - 1) // _BLOCK
    bstart = np.concatenate([[0], np.cumsum(blocks)]).astype(np.int64)
    if bstart[-1] > np.iinfo(np.int32).max:
        raise ValueError("too many delta blocks for one launch")
    return tab, bstart, int(bstart[-1]) * block_bytes(max_bits)


def delta_page_streams(streams: torch.Tensor, table, bit_size: int,
                       max_bits: int):
    """The DELTA_BINARY_PACKED block streams of P page windows in one
    launch.

    ``streams`` is a (rows, ld) batch, int64 for the 64-bit ring or int32
    for the 32-bit ring; page p is ``table[p] = (row, start, count)``, a
    host (P, 3) array: window value i is ``streams[row, start + i]`` (0 past
    ld), and delta i, for i < count - 1, is value i+1 - value i in the ring.
    Returns ``(out, offsets, over)``: ``out`` (capacity,) uint8 holds every
    page's blocks back to back (for each block the varint of the zigzag
    signed minimum delta, the four miniblock widths, and each miniblock of
    width w > 0 packed LSB-first in 4 w bytes), page p at
    ``[offsets[p], offsets[p+1])`` of the (P + 1,) int64 ``offsets``;
    capacity is ``block_bytes(max_bits)`` a block, and bytes past it are
    not written.  ``over`` (1,) int64 is 0, or the widest miniblock width
    above ``max_bits``, in which case the streams are cut (see
    :func:`check_budget`).  Contents of ``out`` past ``offsets[P]`` are
    undefined.  A CUDA tensor launches ``csrc/delta.cu``; a CPU tensor runs
    :func:`delta_page_streams_plain`."""
    if streams.device.type == "cpu":
        return delta_page_streams_plain(streams, table, bit_size, max_bits)
    if streams.device.type != "cuda":
        raise ValueError(f"unsupported device {streams.device}")
    return DeltaLaunch(streams, table, bit_size, max_bits).run()


delta_page_streams.launches = 0


class DeltaLaunch:
    """One launch of ``csrc/delta.cu`` staged on the card: a single upload
    holds the offsets, the zeroed look-back state (its ticket and width
    flag last) and the page table with its block prefix, so the launch
    needs no memset; the output is allocated.  :meth:`run` launches once
    (the look-back state is spent by it), so a launch can be timed apart
    from its staging; :func:`delta_page_streams` is one staging and one
    run."""

    def __init__(self, streams: torch.Tensor, table, bit_size: int,
                 max_bits: int) -> None:
        tab, bstart, capacity = _plan(streams, table, bit_size, max_bits)
        self._kernel = _kernel()
        if not streams.is_contiguous():
            raise ValueError("streams must be contiguous")
        self.streams, self.bit_size, self.max_bits = streams, bit_size, max_bits
        self.P, self.nblocks, self.capacity = tab.shape[0], int(bstart[-1]), capacity
        meta = np.concatenate([tab.reshape(-1), bstart]).astype(np.int32)
        head = self.P + 1 + self.nblocks + 2  # offsets, states, ticket, flag
        host = np.zeros(head + (meta.size + 1) // 2, np.int64)
        host[head:].view(np.int32)[:meta.size] = meta
        # CUDA copies a pageable source out before the call returns
        self._buf = torch.from_numpy(host).to(streams.device, non_blocking=True)
        self.out = torch.empty(capacity, dtype=torch.uint8, device=streams.device)
        self._spent = False

    def run(self):
        """Launch; returns ``(out, offsets, over)`` as
        :func:`delta_page_streams` does."""
        if self._spent:
            raise RuntimeError("a staged delta launch runs once: its look-back "
                               "state is spent")
        self._spent = True
        P, nblocks, buf = self.P, self.nblocks, self._buf
        offsets, state = buf[:P + 1], buf[P + 1:P + 1 + nblocks + 2]
        over = state[-1:]
        if nblocks == 0:  # nothing to launch: every page has at most one value
            return self.out, offsets, over
        device, stream = cuda_launch_args(self.streams)
        rows, ld = self.streams.shape
        rc = self._kernel(self.streams.data_ptr(), rows, ld, int(self.bit_size == 64),
                          buf[P + 1 + nblocks + 2:].data_ptr(), P, nblocks,
                          self.max_bits, self.capacity, self.out.data_ptr(),
                          offsets.data_ptr(), state.data_ptr(), device, stream)
        if rc:
            raise RuntimeError(f"kpw_delta_streams launch failed: CUDA error {rc}")
        delta_page_streams.launches += 1
        return self.out, offsets, over


def _block_deltas(streams: torch.Tensor, tab: np.ndarray, bucket: int,
                  bit_size: int):
    """Each page's ring deltas as (P, bucket/128, 128) int64 (32-bit ring
    values sign-extended) and their validity mask."""
    dev = streams.device
    P, blocks = tab.shape[0], bucket // _BLOCK
    rows, ld = streams.shape
    t = torch.from_numpy(tab).to(dev)
    row, first, count = t[:, 0:1], t[:, 1:2], t[:, 2:3]
    col = first + torch.arange(bucket + 1, device=dev)
    if ld and rows:
        w = streams[row.clamp(0, rows - 1), col.clamp(max=ld - 1)].to(torch.int64)
        w = torch.where((col < ld) & (row < rows), w, 0)
    else:
        w = torch.zeros(col.shape, dtype=torch.int64, device=dev)
    d = w[:, 1:] - w[:, :-1]  # int64 arithmetic wraps: the 64-bit ring
    if bit_size == 32:  # back into the 32-bit ring, as signed values
        d = ((d + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    valid = (torch.arange(bucket, device=dev) < count - 1).reshape(P, blocks, _BLOCK)
    return d.reshape(P, blocks, _BLOCK), valid


def delta_page_streams_plain(streams: torch.Tensor, table, bit_size: int,
                             max_bits: int):
    """:func:`delta_page_streams` in plain PyTorch on any device: the
    windows' ring deltas, block minima and widths as tensor ops, each
    miniblock's packed words as shifted values summed (their bit ranges are
    disjoint), the zigzag varint bytes, and the compaction of every block's
    bytes with a byte mask, in page order, with the offsets from a
    ``cumsum`` of the block lengths."""
    tab, bstart, capacity = _plan(streams, table, bit_size, max_bits)
    dev = streams.device
    P = tab.shape[0]
    blocks = int(np.diff(bstart).max()) if P else 0
    out = torch.zeros(capacity, dtype=torch.uint8, device=dev)
    if blocks == 0:
        zeros = torch.zeros(P + 2, dtype=torch.int64, device=dev)
        return out, zeros[:P + 1], zeros[P + 1:]
    d, valid = _block_deltas(streams, tab, blocks * _BLOCK, bit_size)
    have = torch.from_numpy(np.diff(bstart)).to(dev)  # blocks a page holds
    held = torch.arange(blocks, device=dev) < have[:, None]  # (P, blocks)
    mins = torch.where(valid, d, torch.iinfo(torch.int64).max).min(-1).values
    mins = torch.where(held, mins, 0)
    rel = d - mins[..., None]
    if bit_size == 32:
        rel = rel & 0xFFFFFFFF
    rel = torch.where(valid, rel, 0).reshape(P, blocks, _MINI, _MB)
    # width = bit length of the miniblock's largest rel as an unsigned
    # value: flipping the sign bit makes signed order the unsigned one
    top = torch.iinfo(torch.int64).min
    mx = (rel ^ top).amax(-1) ^ top  # (P, B, 4)
    j = torch.arange(64, device=dev)
    widths = torch.where(mx < 0, 64, ((mx[..., None] >> j) != 0).sum(-1))
    over = widths[held].max()
    over = torch.where(over > max_bits, over, 0).reshape(1)
    # packed words k < W of each miniblock: value i lands at bit i*w - 32k
    W = max(int(widths.max()), 1)
    k = torch.arange(W, device=dev)
    i = torch.arange(_MB, device=dev)[:, None]
    wd = widths[..., None, None]  # (P, B, 4, 1, 1)
    s = i * wd - 32 * k  # (P, B, 4, 32, W)
    lo = s.clamp(0, 32)
    hi = (s + wd).clamp(0, 32)
    mask = (torch.ones_like(s) << hi) - (torch.ones_like(s) << lo)
    v = rel[..., None]
    c = torch.where(s >= 0, v << s.clamp(0, 63), v >> (-s).clamp(0, 63)) & mask
    words = c.sum(-2)  # (P, B, 4, W)
    packed = ((words[..., None] >> (8 * torch.arange(4, device=dev))) & 0xFF)
    packed = packed.reshape(P, blocks, _MINI, 4 * W).to(torch.uint8)
    pmask = torch.arange(4 * W, device=dev) < 4 * widths[..., None]
    # the varint of zigzag(min): 7-bit groups, low first
    z = (mins << 1) ^ (mins >> 63)
    g = torch.arange(_VARINT_MAX, device=dev)
    groups = torch.where(g < 9, (z[..., None] >> (7 * g).clamp(max=63)) & 0x7F,
                         (z[..., None] < 0).to(torch.int64))
    vlen = torch.where(groups != 0, g + 1, 1).amax(-1)  # (P, B)
    groups = torch.where(g < vlen[..., None] - 1, groups | 0x80, groups)
    vmask = g < vlen[..., None]
    # every block's bytes in order, masked, compacted in page order
    byts = torch.cat([groups.to(torch.uint8), widths.to(torch.uint8),
                      packed.reshape(P, blocks, -1)], dim=-1)
    keep = torch.cat([vmask, torch.ones_like(widths, dtype=torch.bool),
                      pmask.reshape(P, blocks, -1)], dim=-1) & held[..., None]
    stream = byts[keep]
    lengths = torch.where(held, vlen + _MINI + 4 * widths.sum(-1), 0)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(lengths.sum(-1), 0)])
    n = min(stream.numel(), capacity)
    out[:n] = stream[:n]
    return out, offsets, over


def stream_bytes(out: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """The defined part of :func:`delta_page_streams`' ``out``: its first
    ``offsets[P]`` bytes, cut at its capacity."""
    return out[:min(int(offsets[-1]), out.numel())]


def check_budget(over, max_bits: int) -> None:
    """Refuse streams whose width bound was wrong: ``over`` (host) is
    :func:`delta_page_streams`' third output."""
    w = int(np.asarray(over).reshape(-1)[0])
    if w:
        raise ValueError(
            f"delta miniblock width {w} exceeds the device pack's budget "
            f"max_bits={max_bits}: the packed stream is truncated")


def page_header(first_value: int, count: int) -> bytes:
    """The DELTA_BINARY_PACKED page header: block size, miniblock count,
    value count and the zigzag first value (0 for an empty page)."""
    return (varint_bytes(_BLOCK) + varint_bytes(_MINI) + varint_bytes(count)
            + varint_bytes(zigzag(int(first_value)) if count else 0))


def page_parts(first_value: int, count: int, out_host: np.ndarray, lo: int,
               hi: int) -> list:
    """One page as parts: its header and a view of its block stream,
    ``out_host[lo:hi]`` (no copy)."""
    return [page_header(first_value, count), out_host[lo:hi]]


def delta_binary_packed_device(values: np.ndarray, bit_size: int = 64,
                               device="cuda") -> bytes:
    """Full DELTA_BINARY_PACKED of ``values`` through one device launch and
    one readback.  Byte-identical to
    ``core.encodings.delta_binary_packed_encode``."""
    dev = resolve_device(device)
    itype = np.int64 if bit_size == 64 else np.int32
    v = np.ascontiguousarray(values, itype)
    n = len(v)
    if n <= 1:
        return page_header(int(v[0]) if n else 0, n)
    # the host min/max bounds every miniblock width, and so the output
    max_bits = delta_bits_bucket(int(v.max()) - int(v.min()), bit_size)
    out, offsets, over = delta_page_streams(
        torch.from_numpy(v).reshape(1, -1).to(dev), np.array([[0, 0, n]]),
        bit_size, max_bits)
    out_h, off_h, over_h = to_host([out, offsets, over])
    check_budget(over_h, max_bits)
    return page_header(int(v[0]), n) + out_h[:int(off_h[-1])].tobytes()


def delta_length_byte_array_device(values, device="cuda") -> bytes:
    """DELTA_LENGTH_BYTE_ARRAY with the length vector delta-packed on the
    device (32-bit ring, per the spec); the byte payload is a host concat."""
    lens, payload = lens_and_payload(values)
    return delta_binary_packed_device(lens, 32, device) + payload
