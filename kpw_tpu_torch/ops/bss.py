"""BYTE_STREAM_SPLIT on the device: the byte-plane transpose.

The encoding is pure data movement: the K byte planes of N K-byte values,
concatenated (plane j holds byte j of every value, in order).  On the card
that is the values' bytes viewed as (N, K) uint8, transposed and made
contiguous — one PyTorch copy, as the JAX package leaves it to one XLA
transpose; no kernel is written for it.

Byte-identity contract: the output equals
``core.encodings.byte_stream_split_encode(values, pt)`` for values already
in the column's PLAIN dtype (the caller coerces, as the host route does).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, to_host


def byte_stream_split_device(values: np.ndarray, device="cuda") -> bytes:
    """BYTE_STREAM_SPLIT body of ``values`` (already the column's PLAIN
    dtype), transposed on ``device``.  Byte-identical to the numpy oracle."""
    dev = resolve_device(device)
    v = np.ascontiguousarray(values)
    n, width = len(v), v.dtype.itemsize
    if n == 0:
        return b""
    flat = torch.from_numpy(v.view(np.uint8).reshape(n, width)).to(dev)
    (planes,) = to_host([flat.t().contiguous()])
    return planes.tobytes()
