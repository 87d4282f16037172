"""DELTA_BINARY_PACKED on the device: the hand-written CUDA kernel
``csrc/delta.cu`` and its plain PyTorch version, and the host assembly of
the page stream (``core.encodings.delta_binary_packed_encode`` is the byte
oracle).

The format: blocks of 128 deltas, 4 miniblocks of 32, a signed (zigzag)
minimum delta a block, a bit width a miniblock, and each miniblock's
``delta - min`` values packed LSB-first at its own width.  The
data-parallel part — ring deltas, block minima, miniblock widths and the
pack — runs in one launch for every page of a (bucket, ring) group
(:func:`delta_pages`); the host writes the header and the per-block bytes in
O(blocks) (:func:`assemble_delta_page`).

Values travel in their ring's own type: int64 for the 64-bit ring, int32
for the 32-bit ring, whose deltas wrap at 32 bits.  (The JAX package splits
64-bit values into (hi, lo) uint32 planes because the TPU has no int64.)
Each miniblock's packed slot is ``4 * max_bits`` bytes, where ``max_bits``
is a bound on every width the host derives from the stream's value range
(:func:`delta_bits_bucket`), so the readback stays small.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.bytecol import lens_and_payload
from ..core.thrift import varint_bytes, zigzag
from ..device import cuda_launch_args, resolve_device, to_host
from . import _build
from .packing import page_table

_BLOCK = 128
_MINI = 4
_MB = 32  # values per miniblock

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        _fn = _build.function("delta", "kpw_delta_pages", [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p])
    return _fn


# Width-budget buckets: the slot size follows the bucket, so finer steps at
# the narrow end (near-sorted timestamps, string lengths) matter most.
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


def _check(streams: torch.Tensor, table: torch.Tensor, bucket: int,
           bit_size: int, max_bits: int) -> None:
    if streams.dim() != 2 or streams.dtype != _ring_dtype(bit_size):
        raise TypeError(f"streams must be 2-D {_ring_dtype(bit_size)} for the "
                        f"{bit_size}-bit ring, got {tuple(streams.shape)} "
                        f"{streams.dtype}")
    if bucket <= 0 or bucket % _BLOCK:
        raise ValueError(f"bucket must be a positive multiple of {_BLOCK}, got {bucket}")
    if not 1 <= max_bits <= bit_size:
        raise ValueError(f"max_bits must be 1..{bit_size}, got {max_bits}")
    if table.dim() != 2 or table.shape[1] != 3 or table.dtype != torch.int32:
        raise ValueError("the page table must be (P, 3) int32 (row, start, count), "
                         f"got {tuple(table.shape)} {table.dtype}")


def delta_pages(streams: torch.Tensor, table: torch.Tensor, bucket: int,
                bit_size: int, max_bits: int):
    """The delta device phase of P page windows in one launch.

    ``streams`` is a (rows, ld) batch, int64 for the 64-bit ring or int32
    for the 32-bit ring; page p is ``table[p] = (row, start, count)`` (int32,
    on the same device): window value i is ``streams[row, start + i]`` (0
    past ld), and delta i, valid for i < count - 1, is value i+1 - value i
    in the ring.  Returns, per block of 128 deltas: mins (P, bucket/128)
    int64, the signed minimum of the valid deltas (a block without one
    keeps its first delta); widths (P, bucket/128, 4) int32, each
    miniblock's bit width of ``delta - min`` (0 without a valid delta); and
    packed (P, bucket/128, 4, 4*max_bits) uint8, each miniblock's 32
    relative deltas packed LSB-first at its width, zero past it and cut at
    the slot's end.  A CUDA tensor launches ``csrc/delta.cu``; a CPU tensor
    runs :func:`delta_pages_plain`."""
    _check(streams, table, bucket, bit_size, max_bits)
    if streams.device.type == "cpu":
        return delta_pages_plain(streams, table, bucket, bit_size, max_bits)
    if streams.device.type != "cuda":
        raise ValueError(f"unsupported device {streams.device}")
    kernel = _kernel()
    if not streams.is_contiguous():
        raise ValueError("streams must be contiguous")
    if table.device != streams.device or not table.is_contiguous():
        raise ValueError("the page table must be contiguous on the streams' device")
    P, blocks = table.shape[0], bucket // _BLOCK
    dev = streams.device
    mins = torch.empty((P, blocks), dtype=torch.int64, device=dev)
    widths = torch.empty((P, blocks, _MINI), dtype=torch.int32, device=dev)
    packed = torch.empty((P, blocks, _MINI, 4 * max_bits), dtype=torch.uint8,
                         device=dev)
    if P == 0:  # nothing to launch
        return mins, widths, packed
    device, stream = cuda_launch_args(streams)
    rows, ld = streams.shape
    rc = kernel(streams.data_ptr(), rows, ld, int(bit_size == 64),
                table.data_ptr(), P, bucket, max_bits, mins.data_ptr(),
                widths.data_ptr(), packed.data_ptr(), device, stream)
    if rc:
        raise RuntimeError(f"kpw_delta_pages launch failed: CUDA error {rc}")
    delta_pages.launches += 1
    return mins, widths, packed


delta_pages.launches = 0


def delta_pages_plain(streams: torch.Tensor, table: torch.Tensor, bucket: int,
                      bit_size: int, max_bits: int):
    """:func:`delta_pages` in plain PyTorch on any device: the windows'
    ring deltas, block minima and widths as tensor ops, and the pack as a
    scatter of every relative delta's bits to its stream position
    (``bit_size`` bit cells a value)."""
    _check(streams, table, bucket, bit_size, max_bits)
    dev = streams.device
    P, blocks = table.shape[0], bucket // _BLOCK
    rows, ld = streams.shape
    t = table.to(torch.int64)
    row, first, count = t[:, 0:1], t[:, 1:2], t[:, 2:3]
    col = first + torch.arange(bucket + 1, device=dev)
    if ld and rows:
        w = streams[row.clamp(0, rows - 1), col.clamp(max=ld - 1)].to(torch.int64)
        w = torch.where((col < ld) & (row >= 0) & (row < rows), w, 0)
    else:
        w = torch.zeros(col.shape, dtype=torch.int64, device=dev)
    d = w[:, 1:] - w[:, :-1]  # int64 arithmetic wraps: the 64-bit ring
    if bit_size == 32:  # back into the 32-bit ring, as signed values
        d = ((d + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    valid = (torch.arange(bucket, device=dev) < count - 1).reshape(P, blocks, _BLOCK)
    d = d.reshape(P, blocks, _BLOCK)
    mins = torch.where(valid, d, torch.iinfo(torch.int64).max).min(-1).values
    mins = torch.where(valid[..., 0], mins, d[..., 0])
    rel = d - mins[..., None]
    if bit_size == 32:
        rel = rel & 0xFFFFFFFF
    rel = torch.where(valid, rel, 0).reshape(P, blocks, _MINI, _MB)
    j = torch.arange(bit_size, device=dev)
    bits = ((rel[..., None] >> j) & 1).to(torch.uint8)  # (..., 32, bit_size)
    widths = (bits.to(torch.int32) * (j + 1).to(torch.int32)).amax(dim=(-1, -2))
    # bit j of value i lands at stream bit i * width + j when j < width;
    # positions past the slot's 32 * max_bits bits go to a dropped cell
    slot_bits = 32 * max_bits
    i = torch.arange(_MB, device=dev)[:, None]
    wd = widths[..., None, None].to(torch.int64)
    pos = torch.where(j < wd, i * wd + j, slot_bits).clamp(max=slot_bits)
    stream = torch.zeros((P, blocks, _MINI, slot_bits + 1), dtype=torch.uint8,
                         device=dev)
    stream.scatter_(-1, pos.reshape(P, blocks, _MINI, -1),
                    bits.reshape(P, blocks, _MINI, -1))
    stream = stream[..., :slot_bits].reshape(P, blocks, _MINI, 4 * max_bits, 8)
    weights = torch.arange(8, dtype=torch.uint8, device=dev)
    packed = (stream << weights).sum(-1, dtype=torch.uint8)
    return mins, widths, packed


def delta_pages_multi(streams: torch.Tensor, stream_ids, starts, counts,
                      bucket: int, bit_size: int, max_bits: int | None = None):
    """The delta device phase of many pages of stacked value streams, one
    launch for the whole (bucket, ring) group: page p is row
    ``stream_ids[p]`` from ``starts[p]``, ``counts[p]`` values.
    ``max_bits`` (default ``bit_size``) must bound every miniblock width of
    every stream in the group (see :func:`delta_bits_bucket`).  Returns
    :func:`delta_pages`' (mins, widths, packed)."""
    table = page_table(stream_ids, starts, counts, streams.device)
    return delta_pages(streams, table, bucket, bit_size, max_bits or bit_size)


def delta_blocks_device(values: torch.Tensor, n, bit_size: int,
                        max_bits: int | None = None):
    """The delta device phase of one stream of ``n`` values: ``values`` is
    1-D in the ring's type, ``1 + blocks * 128`` entries long (values past
    ``n`` are ignored; a shorter tensor reads as zero-padded).  Returns
    (mins (blocks,), widths (blocks, 4), packed (blocks, 4, 4*max_bits))."""
    blocks = max(1, -(-(values.shape[0] - 1) // _BLOCK))
    out = delta_pages_multi(values.reshape(1, -1), [0], [0], [int(n)],
                            blocks * _BLOCK, bit_size, max_bits)
    return tuple(o[0] for o in out)


def assemble_delta_page(first_value: int, count: int, mins, widths, packed,
                        bit_size: int, max_bits: int | None = None) -> bytes:
    """Host assembly of one page's DELTA_BINARY_PACKED stream from the
    device outputs (O(blocks)); byte-identical to the oracle.  ``mins`` are
    the blocks' signed minimum deltas.

    ``max_bits`` is the width budget the device pack ran under: a miniblock
    width above it means its packed slot was cut, so the page is refused
    loudly instead of written short."""
    out = bytearray()
    out += varint_bytes(_BLOCK)
    out += varint_bytes(_MINI)
    out += varint_bytes(count)
    if count == 0:
        out += varint_bytes(0)
        return bytes(out)
    out += varint_bytes(zigzag(int(first_value)))
    if count == 1:
        return bytes(out)
    blocks = (count - 1 + _BLOCK - 1) // _BLOCK
    for b in range(blocks):
        out += varint_bytes(zigzag(int(mins[b])))
        ws = [int(w) for w in widths[b]]
        out += bytes(ws)
        for m, w in enumerate(ws):
            if max_bits is not None and w > max_bits:
                raise ValueError(
                    f"delta miniblock width {w} exceeds the device pack's "
                    f"budget max_bits={max_bits} (block {b}, miniblock {m}): "
                    "the packed stream is truncated")
            if w:
                out += packed[b, m, : 4 * w].tobytes()
    return bytes(out)


def delta_binary_packed_device(values: np.ndarray, bit_size: int = 64,
                               device="cuda") -> bytes:
    """Full DELTA_BINARY_PACKED of ``values`` through the device phase and
    the O(blocks) host assembly, one readback.  Byte-identical to
    ``core.encodings.delta_binary_packed_encode``."""
    dev = resolve_device(device)
    itype = np.int64 if bit_size == 64 else np.int32
    v = np.ascontiguousarray(values, itype)
    n = len(v)
    if n <= 1:
        return assemble_delta_page(int(v[0]) if n else 0, n,
                                   None, None, None, bit_size)
    # the host min/max bounds every miniblock width: the slots shrink to it
    max_bits = delta_bits_bucket(int(v.max()) - int(v.min()), bit_size)
    out = delta_blocks_device(torch.from_numpy(v).to(dev), n, bit_size, max_bits)
    mins, widths, packed = to_host(list(out))
    return assemble_delta_page(int(v[0]), n, mins, widths, packed, bit_size,
                               max_bits=max_bits)


def delta_length_byte_array_device(values, device="cuda") -> bytes:
    """DELTA_LENGTH_BYTE_ARRAY with the length vector delta-packed on the
    device (32-bit ring, per the spec); the byte payload is a host concat."""
    lens, payload = lens_and_payload(values)
    return delta_binary_packed_device(lens, 32, device) + payload
