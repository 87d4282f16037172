"""Sort-free dictionary build for bounded values: the histogram +
dictionary kernel and the rank kernel, each beside its plain PyTorch
version.

A value ``v < nhi*64`` splits as ``hi = v >> 6``, ``lo6 = v & 63``.  For a
(C, N) batch (N a multiple of 128) of which the first ``count`` rows of
every column are valid:

- :func:`hist_dict` counts each column's valid values into a (nhi, 64)
  table and, in the same launch, turns the counts into a rank table (value
  -> index among the column's ascending present values), the ascending
  dictionary and its size — replaces the TPU kernel
  ``kpw_tpu/ops/pallas_rank.py:_hist_kernel`` and the presence step after
  it; :func:`hist_pages` is its counts alone;
- :func:`rank_pages` looks each row's rank up in its column's table —
  replaces the TPU kernel ``kpw_tpu/ops/pallas_rank.py:_rank_kernel``.

On a CUDA tensor the two launch ``csrc/hist.cu`` and ``csrc/rank.cu`` (see
the sources for their bounds and designs); on a CPU tensor they run their
plain versions (:func:`hist_dict_plain` is :func:`hist_pages_plain`
followed by :func:`presence_to_dict`).  Counts are exact int32 (the TPU
version returned f32 counts, exact below 2^24).
"""

from __future__ import annotations

import ctypes

import torch

from ..device import count_args, cuda_launch_args
from . import _build

S_LO = 64  # lo radix; nhi = padded value bound / 64
NHI_MAX = 128  # value bound 2^13: a column's table is at most 8192 entries
ROW_LANES = 128  # N must be a multiple of this

U32_PAD = 0xFFFFFFFF  # dictionary pad past k

_fns: dict = {}


def _kernel(name: str, symbol: str, argtypes: list):
    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = _build.function(name, symbol, argtypes)
    return fn


def _check_values(lo_masked: torch.Tensor, nhi: int) -> None:
    if lo_masked.dim() != 2:
        raise ValueError(f"values must be (C, N), got {tuple(lo_masked.shape)}")
    if lo_masked.dtype != torch.int32:
        raise TypeError(f"values must be int32 bit patterns, got {lo_masked.dtype}")
    if lo_masked.shape[1] % ROW_LANES:
        raise ValueError(f"N={lo_masked.shape[1]} must be a multiple of {ROW_LANES}")
    if not 1 <= nhi <= NHI_MAX:
        raise ValueError(f"nhi={nhi} outside 1..{NHI_MAX} (value bound 2^13)")


def _check_cuda(kernel: tuple, *tensors: torch.Tensor):
    """Refuse what the kernel does not take, load (building if needed) the
    kernel ``(name, symbol, argtypes)`` and return its C function."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"unsupported device {t.device}")
        if t.device != tensors[0].device:
            raise ValueError("tensors lie on different devices")
    fn = _kernel(*kernel)
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("tensors must be contiguous and 16-byte aligned")
    return fn


def _u32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & 0xFFFFFFFF


def hist_dict(lo: torch.Tensor, count, nhi: int, ulo_cols: int | None = None):
    """lo (C, N) int32 and the valid row count ``count`` (an int or a 0-d
    tensor) -> (counts (C, nhi, 64) int32, rt (C, nhi, 64) int32, ulo (C,
    ulo_cols) int64, k (C,) int32), counting only rows below ``count`` and
    values below ``nhi*64``.

    ``rt`` is the inclusive prefix count of present values minus 1 (absent
    values included), ``ulo[c, :k[c]]`` the ascending present values and
    the rest of ``ulo`` (``ulo_cols`` entries a column, default
    ``nhi*64``) the pad 0xFFFFFFFF."""
    _check_values(lo, nhi)
    vb = nhi * S_LO
    ulo_cols = vb if ulo_cols is None else int(ulo_cols)
    if lo.device.type == "cpu":
        return hist_dict_plain(lo, count, nhi, ulo_cols)
    kernel = _check_cuda(("hist", "kpw_hist_dict", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p]), lo)
    C, N = lo.shape
    dev = lo.device
    counts = torch.empty((C, nhi, S_LO), dtype=torch.int32, device=dev)
    rt = torch.empty((C, nhi, S_LO), dtype=torch.int32, device=dev)
    ulo = torch.empty((C, ulo_cols), dtype=torch.int64, device=dev)
    k = torch.empty(C, dtype=torch.int32, device=dev)
    _keep, count_ptr, count_val = count_args(count, N, dev)
    device, stream = cuda_launch_args(lo)
    rc = kernel(lo.data_ptr(), C, N, count_ptr, count_val, nhi,
                counts.data_ptr(), rt.data_ptr(), ulo.data_ptr(), ulo_cols,
                k.data_ptr(), device, stream)
    if rc:
        raise RuntimeError(f"kpw_hist_dict launch failed: CUDA error {rc}")
    hist_dict.launches += 1
    return counts, rt, ulo, k


hist_dict.launches = 0


def hist_dict_plain(lo: torch.Tensor, count, nhi: int,
                    ulo_cols: int | None = None):
    """The same function in plain PyTorch: the rows past ``count`` masked
    to the bound, :func:`hist_pages_plain`, then :func:`presence_to_dict`
    (the dictionary padded to ``ulo_cols`` entries)."""
    _check_values(lo, nhi)
    C, N = lo.shape
    vb = nhi * S_LO
    ulo_cols = vb if ulo_cols is None else int(ulo_cols)
    if isinstance(count, torch.Tensor):
        count = count.to(lo.device)
    valid = torch.arange(N, device=lo.device) < count
    counts = hist_pages_plain(torch.where(valid, lo, vb), nhi)
    rt, ulo, k = presence_to_dict(counts, nhi)
    if ulo_cols > vb:
        ulo = torch.cat([ulo, ulo.new_full((C, ulo_cols - vb), U32_PAD)], dim=1)
    return counts, rt, ulo[:, :ulo_cols], k


def hist_pages(lo_masked: torch.Tensor, nhi: int) -> torch.Tensor:
    """lo_masked (C, N) int32 -> (C, nhi, 64) int32 exact counts of the
    values below ``nhi*64``; larger values (the sentinel) count nowhere:
    :func:`hist_dict` over every row, its counts alone."""
    _check_values(lo_masked, nhi)
    if lo_masked.device.type == "cpu":
        return hist_pages_plain(lo_masked, nhi)
    return hist_dict(lo_masked, lo_masked.shape[1], nhi)[0]


def hist_pages_plain(lo_masked: torch.Tensor, nhi: int) -> torch.Tensor:
    """The same function in plain PyTorch: one scatter-add per column, the
    out-of-range values parked in a dropped extra bin."""
    _check_values(lo_masked, nhi)
    C = lo_masked.shape[0]
    vb = nhi * S_LO
    v = _u32(lo_masked)
    idx = torch.where(v < vb, v, vb)
    counts = torch.zeros((C, vb + 1), dtype=torch.int32, device=lo_masked.device)
    counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    return counts[:, :vb].reshape(C, nhi, S_LO)


def rank_pages(lo_masked: torch.Tensor, rt: torch.Tensor) -> torch.Tensor:
    """lo_masked (C, N) int32, rt (C, nhi, 64) int32 rank tables -> (C, N)
    int32 ranks ``rt[c, v >> 6, v & 63]``; 0 for values at or above
    ``nhi*64`` (the sentinel)."""
    C, nhi = rt.shape[0], rt.shape[1]
    _check_values(lo_masked, nhi)
    if rt.shape != (lo_masked.shape[0], nhi, S_LO) or rt.dtype != torch.int32:
        raise ValueError(f"rt must be ({lo_masked.shape[0]}, nhi, {S_LO}) int32, "
                         f"got {tuple(rt.shape)} {rt.dtype}")
    if lo_masked.device.type == "cpu":
        return rank_pages_plain(lo_masked, rt)
    kernel = _check_cuda(("rank", "kpw_rank", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]), lo_masked, rt)
    N = lo_masked.shape[1]
    out = torch.empty((C, N), dtype=torch.int32, device=lo_masked.device)
    device, stream = cuda_launch_args(lo_masked)
    rc = kernel(lo_masked.data_ptr(), rt.data_ptr(), out.data_ptr(), C, N, nhi,
                device, stream)
    if rc:
        raise RuntimeError(f"kpw_rank launch failed: CUDA error {rc}")
    rank_pages.launches += 1
    return out


rank_pages.launches = 0


def rank_pages_plain(lo_masked: torch.Tensor, rt: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: a gather from the flattened
    tables, sentinel rows set to 0."""
    C, nhi = rt.shape[0], rt.shape[1]
    _check_values(lo_masked, nhi)
    vb = nhi * S_LO
    v = _u32(lo_masked)
    inb = v < vb
    r = torch.gather(rt.reshape(C, vb), 1, torch.where(inb, v, 0))
    return torch.where(inb, r, 0).to(torch.int32)


def presence_to_dict(counts: torch.Tensor, nhi: int):
    """Per column, (nhi, 64) counts -> (rank table (nhi, 64) int32,
    ascending dictionary ulo (nhi*64,) int64 holding 32-bit values, padded
    with 0xFFFFFFFF past k, unique count k int32), batched over the
    leading column axis.  Plain PyTorch: one cumulative sum and one small
    (nhi*64-entry) sort per column; the plain version of the dictionary
    half of :func:`hist_dict`."""
    C = counts.shape[0]
    vb = nhi * S_LO
    present = (counts > 0).reshape(C, vb)
    k = present.sum(1, dtype=torch.int32)
    rt = (torch.cumsum(present, 1, dtype=torch.int32) - 1).reshape(C, nhi, S_LO)
    bins = torch.arange(vb, dtype=torch.int64, device=counts.device)
    ulo = torch.sort(torch.where(present, bins, U32_PAD), dim=1).values
    return rt, ulo, k
