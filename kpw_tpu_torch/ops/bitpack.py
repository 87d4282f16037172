"""Parquet LSB-first bit-packing of page windows: the fused CUDA kernel and
its plain PyTorch version.

A page of ``n`` values at bit width ``w`` packs value i's bit j at stream
bit ``i*w + j`` (bytes LSB-first); ``core.encodings.bitpack`` is the
byte-exact oracle.  Eight values fill exactly ``w`` bytes, so a page of
``bucket`` values (a multiple of 8) packs to ``bucket*w/8`` bytes with no
carries between groups.

:func:`pack_pages` cuts each page out of a (rows, ld) index batch through a
(P, 3) int32 page table of (row, start, count), zeroes it past its count,
bit-packs it and measures its long-run mass, in one launch of
``csrc/bitpack.cu`` on a CUDA tensor (see the source for its bound and
design) or through :func:`pack_pages_plain` on a CPU tensor.  It replaces
the TPU kernel ``kpw_tpu/ops/pallas_bitpack.py:_bitpack_kernel`` and the
slice, mask and run statistics the JAX package runs around it; on request
it also counts each page's runs (the level planner's sizing of its run
extraction).  :func:`bitpack_pages` is the case of an identity table
without statistics.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import count_args, cuda_launch_args, to_device
from . import _build

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        _fn = _build.function("bitpack", "kpw_pack_pages", [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p])
    return _fn


def _check(idx: torch.Tensor, table, bucket: int, width: int) -> None:
    if idx.dim() != 2:
        raise ValueError(f"indices must be 2-D (rows, ld), got {tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"indices must be int32 bit patterns, got {idx.dtype}")
    if bucket <= 0 or bucket % 8:
        raise ValueError(f"bucket must be a positive multiple of 8, got {bucket}")
    if not 1 <= width <= 32:
        raise ValueError(f"width must be 1..32, got {width}")
    if table is not None and (table.dim() != 2 or table.shape[1] != 3
                              or table.dtype != torch.int32):
        raise ValueError("the page table must be (P, 3) int32 (row, start, count), "
                         f"got {tuple(table.shape)} {table.dtype}")


def pack_pages(idx: torch.Tensor, table: torch.Tensor | None, bucket: int,
               width: int, stats: bool = True, count=None, n_runs: bool = False):
    """Pack P page windows of ``idx`` (rows, ld) int32 in one launch.

    Page p is described by ``table[p] = (row, start, count)`` (int32, on
    ``idx``'s device): its value i is ``idx[row, start + i]`` for
    ``i < count`` and 0 past ``count`` or past ``ld``.  ``table=None`` means
    page p is row p, start 0, with ``count`` values (an int or a 0-d
    tensor; default ``bucket``), and needs no table on the device.  Returns
    (packed (P, bucket*width//8) uint8, long_sum, n_runs): long_sum (P,)
    int32 is the total length of runs >= 8 among each page's first
    ``count`` values, n_runs (P,) int32 the number of runs among them; each
    statistic is None unless asked for (``stats``, ``n_runs``).  Bits at or
    above ``width`` are ignored."""
    _check(idx, table, bucket, width)
    count = bucket if count is None else count
    if idx.device.type == "cpu":
        return pack_pages_plain(idx, table, bucket, width, stats, count, n_runs)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    kernel = _kernel()
    if not idx.is_contiguous() or idx.data_ptr() % 16:
        raise ValueError("indices must be contiguous and 16-byte aligned")
    if table is not None and (table.device != idx.device or not table.is_contiguous()):
        raise ValueError("the page table must be contiguous on the indices' device")
    P = idx.shape[0] if table is None else table.shape[0]
    rows, ld = idx.shape
    packed = torch.empty((P, bucket * width // 8), dtype=torch.uint8,
                         device=idx.device)
    long_sum, runs = (torch.empty(P, dtype=torch.int32, device=idx.device)
                      if want else None for want in (stats, n_runs))
    out = (packed, long_sum, runs)
    if P == 0:  # nothing to launch
        return out
    _keep, count_ptr, count_val = count_args(count, bucket, idx.device)
    device, stream = cuda_launch_args(idx)
    rc = kernel(idx.data_ptr(), rows, ld,
                None if table is None else table.data_ptr(), count_ptr, count_val,
                P, bucket, width, packed.data_ptr(),
                None if long_sum is None else long_sum.data_ptr(),
                None if runs is None else runs.data_ptr(), device, stream)
    if rc:
        raise RuntimeError(f"kpw_pack_pages launch failed: CUDA error {rc}")
    pack_pages.launches += 1
    return out


pack_pages.launches = 0


def bitpack_pages(pages: torch.Tensor, width: int) -> torch.Tensor:
    """(P, bucket) int32 (each value's 32-bit pattern, entries past each
    page's count already zero) -> (P, bucket*width//8) uint8, row p equal to
    ``core.encodings.bitpack(pages[p], width)``: :func:`pack_pages` with the
    identity page table and no statistics."""
    if pages.dim() != 2:
        raise ValueError(f"pages must be (P, bucket), got {tuple(pages.shape)}")
    return pack_pages(pages, None, pages.shape[1], width, stats=False)[0]


def bitpack_pages_plain(pages: torch.Tensor, width: int) -> torch.Tensor:
    """The bit-pack alone in plain PyTorch on any device: expand every value
    into its ``width`` bits, then fold each run of 8 bits into a byte."""
    _check(pages, None, pages.shape[-1] if pages.dim() == 2 else 0, width)
    P, bucket = pages.shape
    v = pages.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(width, device=pages.device)
    bits = ((v.unsqueeze(-1) >> shifts) & 1).to(torch.uint8)
    bits = bits.reshape(P, bucket * width // 8, 8)
    weights = torch.arange(8, dtype=torch.uint8, device=pages.device)
    return (bits << weights).sum(-1, dtype=torch.uint8)


def window_slice(idx: torch.Tensor, table: torch.Tensor | None, bucket: int,
                 count=None):
    """THE window slice/mask convention, batched over pages: page p is
    ``idx[row, start : start + bucket]`` with reads past ``ld`` giving 0,
    zeroed past ``count`` (``table=None``: row p, start 0, ``count``
    values, an int or a 0-d tensor, default ``bucket``).  Returns (v (P,
    bucket) int32, valid (P, bucket) bool, valid meaning position <
    count)."""
    dev = idx.device
    rows, ld = idx.shape
    pos = torch.arange(bucket, device=dev)
    if table is None:
        row = torch.arange(rows, device=dev)[:, None]
        first = torch.zeros_like(row)
        lim = bucket if count is None else count
        if isinstance(lim, torch.Tensor):
            lim = to_device(lim, dev)
    else:
        t = table.to(torch.int64)
        row, first, lim = t[:, 0:1], t[:, 1:2], t[:, 2:3]
    col = first + pos
    if ld:
        page = idx[row, col.clamp(max=ld - 1)]
    else:
        page = idx.new_zeros((row.shape[0], bucket))
    valid = (pos < lim).expand(row.shape[0], bucket)
    return torch.where(valid & (col < ld), page, 0), valid


def newrun(v: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """THE run-start mask along the last axis — where runs begin, shared by
    every run statistic so run semantics match ``core.encodings._runs``."""
    first = torch.ones_like(valid[..., :1])
    return torch.cat([first, v[..., 1:] != v[..., :-1]], dim=-1) & valid


def run_long_stats(v: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The total length of runs >= 8 along the last axis (int32) — the
    RLE-vs-bitpack decision mass of ``core.encodings.rle_hybrid_encode``.

    A position is the >=8th element of its run iff no run starts at it or
    in the 6 positions before it, and a run is long iff it has an
    exactly-8th element (a >=8th element whose run starts exactly 7 back),
    so ``long_sum = #(>=8th) + 7 * #(exactly 8th)`` — shifts of the
    run-start mask, no scan."""
    starts = newrun(v, valid)

    def back(x, k):  # x[..., q - k], False at the window head
        return torch.cat([torch.zeros_like(x[..., :k]), x[..., :-k]], dim=-1)

    near_start = starts
    for k in range(1, 7):
        near_start = near_start | back(starts, k)
    ge8 = valid & ~near_start
    ex8 = ge8 & back(starts, 7)
    return ge8.sum(-1, dtype=torch.int32) + 7 * ex8.sum(-1, dtype=torch.int32)


def run_stats(v: torch.Tensor, valid: torch.Tensor):
    """Scan-free run statistics of masked windows along the last axis:
    (long_sum, n_runs) — :func:`run_long_stats` and the number of runs."""
    return run_long_stats(v, valid), newrun(v, valid).sum(-1, dtype=torch.int32)


def pack_pages_plain(idx: torch.Tensor, table: torch.Tensor | None, bucket: int,
                     width: int, stats: bool = True, count=None,
                     n_runs: bool = False):
    """:func:`pack_pages` in plain PyTorch on any device: the window slice,
    the bit-pack and the run statistics as separate tensor ops."""
    _check(idx, table, bucket, width)
    v, valid = window_slice(idx, table, bucket, count)
    packed = bitpack_pages_plain(v, width)
    return (packed, run_long_stats(v, valid) if stats else None,
            newrun(v, valid).sum(-1, dtype=torch.int32) if n_runs else None)
